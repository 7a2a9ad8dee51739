"""Celeb-basis construction: name embeddings -> per-token-column PCA.

The port's own copy of ``celebbasis_tpu/core/basis.py`` (host-side numpy; the
port imports nothing of the JAX package).  Behaviour of the reference:

1. read the names file (e.g. ``wiki_names_v2.txt``, 690 lines), set-dedup,
   sort;
2. tokenize each name to (77,) and take **token-table embeddings only** (no
   encoder layers);
3. scan token *columns* j=0..76; keep embeddings of non-special
   (id < 49406) tokens; column 0 is always SOT, so kept column 0 is the
   first-name tokens, column 1 the second-name tokens.  The reference's
   ``rm_repeats`` *token* dedup is an effective **no-op** (its membership
   test hashes tensors by identity), so duplicate-token embeddings are all
   kept by default; ``true_dedup=True`` gives the behaviour the reference
   *intended*;
4. for the first ``num_embeds_per_token`` kept columns: PCA via SVD --
   ``x = col - mean; _, _, v = svd(x); basis = concat([mean, v[:n_components]])``
   giving (1+n_components, 768) per column;
5. stack -> (num_embeds_per_token, 1+n_components, 768).

By design the SVD sign convention is canonicalised (largest-|v| element
positive) so the basis is deterministic across linalg backends, and the
result is cached on disk keyed by a content hash.  ``.pt`` io goes through
``utils.pt_io``.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer
from celebbasis_tpu_torch.utils.pt_io import load_pt, save_pt


@dataclass(frozen=True)
class BasisConfig:
    n_components: int = 512
    num_embeds_per_token: int = 2
    rm_repeats: bool = True       # name-level dedup (strings — real in the ref)
    true_dedup: bool = False      # token-level dedup (a no-op in the ref)
    use_svd: bool = True
    use_flatten: bool = False
    use_sample_reduce: bool = False
    n_samples: int = 513
    special_id_threshold: int = 49406  # ids >= this are specials/padding


def read_names(path: str, rm_repeats: bool = True) -> List[str]:
    with open(path, encoding="utf-8") as f:
        names = f.read().splitlines()
    if rm_repeats:
        names = list(set(names))
    names.sort()
    return [n for n in names if n.strip()]


def _canonicalize_signs(v: np.ndarray) -> np.ndarray:
    """Flip each row so its largest-|.| element is positive (deterministic)."""
    idx = np.argmax(np.abs(v), axis=1)
    signs = np.sign(v[np.arange(v.shape[0]), idx])
    signs[signs == 0] = 1.0
    return v * signs[:, None]


def collect_column_embeddings(all_tokens: np.ndarray, all_embeds: np.ndarray,
                              cfg: BasisConfig) -> List[np.ndarray]:
    """Per-column (or flattened) non-special embedding lists.

    Token-level dedup only runs with ``cfg.true_dedup`` — the reference's
    rm_repeats membership test is an effective no-op (see module docstring),
    so parity means keeping duplicate-token embeddings.
    """
    M, L = all_tokens.shape
    dedup = cfg.rm_repeats and cfg.true_dedup
    cols: List[np.ndarray] = []
    if cfg.use_flatten:
        seen = set()
        flat = []
        for i in range(M):
            for j in range(L):
                tok = int(all_tokens[i, j])
                if tok >= cfg.special_id_threshold:
                    continue
                if dedup and tok in seen:
                    continue
                flat.append(all_embeds[i, j])
                seen.add(tok)
        return [np.stack(flat)]
    for j in range(L):
        col_seen = set()
        col = []
        for i in range(M):
            tok = int(all_tokens[i, j])
            if tok >= cfg.special_id_threshold:
                continue
            if dedup and tok in col_seen:
                continue
            col.append(all_embeds[i, j])
            col_seen.add(tok)
        if col:
            cols.append(np.stack(col))
    return cols


def pca_basis(col: np.ndarray, n_components: int) -> np.ndarray:
    """(k,768) embeddings -> (1+n_components, 768): row 0 mean, rest PCA dirs."""
    col = col.astype(np.float64)
    mean = col.mean(axis=0, keepdims=True)
    x = col - mean
    _, _, vt = np.linalg.svd(x, full_matrices=True)
    vt = _canonicalize_signs(vt[:n_components])
    return np.concatenate([mean, vt], axis=0).astype(np.float32)


def sample_reduce(col: np.ndarray, n_samples: int) -> np.ndarray:
    """Optional sample-count reduction via SVD projection."""
    ce = col.astype(np.float64).T  # (768, m)
    x = ce - ce.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=True)
    vr = vt.T[:, :n_samples]  # (m, r)
    return (ce @ vr).T.astype(np.float32)  # (r, 768)


def build_celeb_basis(names: Sequence[str], tokenizer: CLIPTokenizer,
                      token_table: np.ndarray,
                      cfg: BasisConfig = BasisConfig()) -> np.ndarray:
    """-> (num_embeds_per_token, 1+n_components, width) float32 basis tensor.

    ``token_table``: the CLIP token-embedding matrix (vocab, width).
    """
    all_tokens = tokenizer(list(names))  # (M, 77)
    all_embeds = token_table[all_tokens]  # (M, 77, width)
    cols = collect_column_embeddings(all_tokens, all_embeds, cfg)
    out = []
    n_cols = 1 if cfg.use_flatten else cfg.num_embeds_per_token
    for j in range(min(n_cols, len(cols))):
        col = cols[j]
        if cfg.use_sample_reduce:
            col = sample_reduce(col, cfg.n_samples)
        if cfg.use_svd:
            out.append(pca_basis(col, cfg.n_components))
        else:
            out.append(col.astype(np.float32))
    if cfg.use_flatten:
        out = out * cfg.num_embeds_per_token
    return np.stack(out)


# -- caching + .pt interop --------------------------------------------------

def _cache_key(names: Sequence[str], token_table: np.ndarray,
               cfg: BasisConfig) -> str:
    h = hashlib.sha256()
    h.update("\n".join(names).encode())
    h.update(np.ascontiguousarray(token_table[:64]).tobytes())
    h.update(repr(cfg).encode())
    return h.hexdigest()[:16]


def build_celeb_basis_cached(names_path: str, tokenizer: CLIPTokenizer,
                             token_table: np.ndarray,
                             cfg: BasisConfig = BasisConfig(),
                             cache_dir: str | None = ".cache/celeb_basis"
                             ) -> np.ndarray:
    names = read_names(names_path, cfg.rm_repeats)
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, _cache_key(names, token_table, cfg) + ".npz")
        if os.path.exists(path):
            return np.load(path)["basis"]
    basis = build_celeb_basis(names, tokenizer, token_table, cfg)
    if cache_dir:
        np.savez(path, basis=basis)
    return basis


def save_basis_pt(basis: np.ndarray, path: str) -> None:
    """Reference-compatible celeb_basis.pt (a bare float32 tensor)."""
    save_pt(np.asarray(basis, np.float32), path)


def load_basis_pt(path: str) -> np.ndarray:
    return load_pt(path).float().numpy()


def reconstruct(coefficients: np.ndarray, basis: np.ndarray) -> np.ndarray:
    """z = coeff · P + mean.

    coefficients: (es, h, inner) ; basis: (es, 1+inner, width) -> (es*h, width).
    """
    mean, pca = basis[:, :1], basis[:, 1:]
    z = np.einsum("ehk,ekc->ehc", coefficients, pca) + mean
    return z.reshape(-1, z.shape[-1])
