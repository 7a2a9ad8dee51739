"""PyTorch port, ``cli/evaluate_model.py`` against the JAX package's CLI on
``configs/tiny_legacy_bert.yaml`` (BERT text conditioning, KL first stage,
spatial-transformer UNet): both read one CompVis ``.ckpt`` of random
weights and a textual-inversion ``.pt`` for ``*``, sample with CFG 5 against
the empty prompt, the JAX CLI gets the port's start latents, and the saved
PNGs agree within one level (``_torch_legacy_cli``).  The port scores with
``cli/eval_imgs.build_scorers`` (tiny random CLIP; the JAX scorers are not
run: their random weights are another draw).
"""
import os
import types

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from celebbasis_tpu.cli import evaluate_model as jcli
from celebbasis_tpu_torch.cli import evaluate_model as tcli
from celebbasis_tpu_torch.text.bert_tokenizer import default_bert_tokenizer

from _torch_legacy_cli import (assert_pixels_close, jax_cli, port_fp32,
                               port_start_latents, write_reference_ckpt)
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "tiny_legacy_bert.yaml")
PROMPT = "a painting of a * monster playing guitar"


def _pngs(folder, n):
    return np.stack([np.asarray(Image.open(os.path.join(folder,
                                                        f"{i:03}.png")))
                     for i in range(n)])


def test_evaluate_model_with_ti_matches_the_jax_cli(tmp_path, monkeypatch):
    with open(CFG) as f:
        cfg = yaml.safe_load(f)
    ckpt = str(tmp_path / "model.ckpt")
    jl = write_reference_ckpt(cfg, ckpt, seed=2)
    r = np.random.default_rng(0)
    star = default_bert_tokenizer().tokenize("*")[0]
    emb = str(tmp_path / "embeddings.pt")
    torch.save({"string_to_token": {"*": torch.tensor(star)},
                "string_to_param": {"*": torch.from_numpy(
                    r.standard_normal((1, 48)).astype(np.float32) * 3)}},
               emb)
    data = tmp_path / "subject"
    data.mkdir()
    for i in range(2):
        Image.fromarray(r.integers(0, 256, (40, 40, 3), np.uint8)).save(
            data / f"img{i}.png")
    common = ["--ckpt-path", ckpt, "--config", CFG, "--embedding-path", emb,
              "--data-dir", str(data), "--n-samples", "3", "--batch-size",
              "2", "--steps", "2", "--seed", "9", "--prompt", PROMPT]
    port_fp32(monkeypatch)
    scores = tcli.main(common + ["--out-dir", str(tmp_path / "port"),
                                 "--device", "cpu",
                                 "--tiny-scorers"])
    assert scores["n_samples"] == 3 and scores["prompt"] == PROMPT
    assert all(-1 <= scores[k] <= 1 for k in ("sim_img", "sim_text"))
    folder = PROMPT.replace(" ", "-")
    got = _pngs(tmp_path / "port" / folder, 3)
    assert got.shape == (3, 32, 32, 3)

    stub = types.SimpleNamespace(img_to_img_similarity=lambda a, b: 0.0,
                                 txt_to_img_similarity=lambda a, b: 0.0)
    monkeypatch.setattr(jcli, "build_scorers", lambda **kw: (None, stub))
    x_Ts = port_start_latents(9, [2, 1], (jl.image_size, jl.image_size,
                                          jl.channels))
    _, chains = jax_cli(monkeypatch, jcli,
                        common + ["--out-dir", str(tmp_path / "jax")], x_Ts)
    assert chains == 2
    assert_pixels_close(got, _pngs(tmp_path / "jax" / folder, 3))

    # the embedding reaches the images: without it they differ
    plain = tcli.main([a for a in common if a != emb and a !=
                       "--embedding-path"] + [
        "--out-dir", str(tmp_path / "plain"), "--device", "cpu",
        "--tiny-scorers"])
    assert plain["n_samples"] == 3
    assert np.abs(_pngs(tmp_path / "plain" / folder, 3).astype(int)
                  - got.astype(int)).max() > 2


def test_evaluate_model_needs_a_card_or_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--data-dir", "unused", "--config", CFG])
