"""Small utilities: parameter counting, captions drawn as images, and the
image / map predicates.

Counterpart of ``celebbasis_tpu/utils/misc.py`` (the reference's
``ldm/util.py`` ``count_params``, ``log_txt_as_img``, ``isimage``,
``ismap``).  ``count_params`` takes a module or any tree of tensors and
arrays.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "shape"):
        yield tree


def count_params(params: Any, verbose: bool = False) -> int:
    n = sum(int(np.prod(x.shape)) for x in _leaves(params))
    if verbose:
        print(f"{n * 1e-6:.2f} M params")
    return n


def log_txt_as_img(wh: Sequence[int], captions: Sequence[str],
                   size: int = 10) -> np.ndarray:
    """Render captions onto white canvases -> (B, H, W, 3) in [-1, 1]."""
    from PIL import Image, ImageDraw
    w, h = wh
    out = []
    for text in captions:
        img = Image.new("RGB", (w, h), color="white")
        draw = ImageDraw.Draw(img)
        n_chars = max(int(40 * (w / 256)), 1)
        lines = "\n".join(text[i: i + n_chars]
                          for i in range(0, len(text), n_chars))
        draw.text((0, 0), lines, fill="black")
        out.append(np.asarray(img, np.float32) / 127.5 - 1.0)
    return np.stack(out)


def isimage(x) -> bool:
    """A channels-last batch of 1- or 3-channel images."""
    return hasattr(x, "ndim") and x.ndim == 4 and x.shape[-1] in (1, 3)


def ismap(x) -> bool:
    return hasattr(x, "ndim") and x.ndim == 4 and x.shape[-1] > 3
