"""PyTorch port, the textual-inversion train step and its CLIs against the
JAX package, on the CPU at tiny size.

* ``make_ti_loss_fn`` against the loss of the JAX ``make_ti_train_step``
  (its gradient and one AdamW update captured through an optax wrapper),
  the draws passed in on both sides (``override_znoise`` / ``override_t`` /
  ``override_noise``), weights made on the JAX side and carried over, fp32.
  The loss agrees to 1e-5 (relative), the TI vectors' gradient to 1e-4 of
  its largest entry -- the gradient runs back through the UNet, CLIP's
  causal attention and the injection's gather -- and the vectors after one
  AdamW step (lr 1e-2, weight decay 1e-2) to 1e-5: where the gradient is
  held that well, ``g / (|g| + eps)`` moves by far less.  The frozen
  modules hold no gradient.
* ``cli/train_ti.py`` for two steps from a synthetic ``sd-v1-4.ckpt``
  (CompVis keys, ``--actual_resume``), ``cli/merge.py`` on its checkpoint
  and a renamed copy, and ``cli/txt2img.py --ti_embedding`` on the merged
  file.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from celebbasis_tpu.cli import train_ti as jtrain_ti
from celebbasis_tpu.core import textual_inversion as jti
from celebbasis_tpu.train.step import make_optimizer as jmake_optimizer
from celebbasis_tpu_torch.cli import merge, train_ti, txt2img
from celebbasis_tpu_torch.core import textual_inversion as tti
from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer
from celebbasis_tpu_torch.train.step import make_optimizer

from _torch_port_helpers import t, tiny_pipelines, tiny_sd_checkpoint
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "tiny.yaml")
NAMES = ["Anne Hathaway", "Barack Obama", "Elon Musk", "Robert Downey",
         "Taylor Swift", "Emma Watson", "Brad Pitt", "Scarlett Johansson"]
SIZE, B, LR = 32, 2, 1e-2


def _capturing(inner):
    """An optax transformation that applies ``inner`` and keeps the
    gradient it was handed in its state, so that one jitted JAX step
    returns both."""
    def init(params):
        return inner.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[0], params)
        return updates, (inner_state, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def d():
    return tiny_pipelines(SIZE, NAMES, seed=7)


def test_ti_loss_gradient_and_adamw_step_match_jax(d):
    cfg = tti.TIConfig(("*",), num_vectors_per_token=2, token_dim=64)
    jcfg = jti.TIConfig(("*",), num_vectors_per_token=2, token_dim=64)
    tok = d["tok"]
    ph = tti.placeholder_token_ids(cfg, tok)
    vecs = tti.init_ti_params(cfg, tok, d["tp"].token_table(), ["face"])
    r = np.random.default_rng(3)
    lat = SIZE // d["tp"].latent_factor
    batch = {
        "image": r.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        "tokens": np.asarray(tok(["a photo of * person", "* * at night"])),
        "override_znoise": r.standard_normal((B, lat, lat, 4)).astype(
            np.float32),
        "override_t": np.array([17, 803]),
        "override_noise": r.standard_normal((B, lat, lat, 4)).astype(
            np.float32),
    }

    opt = _capturing(jmake_optimizer(LR))
    step = jtrain_ti.make_ti_train_step(d["jp"], jcfg,
                                        jnp.asarray(ph, jnp.int32), opt)
    jparams = jnp.asarray(vecs.numpy())
    new, (_, jgrad), logs = step(jparams, opt.init(jparams), d["params"],
                                 jax.tree.map(jnp.asarray, batch),
                                 jax.random.key(0))
    jgrad, new = np.asarray(jgrad), np.asarray(new)

    pipe = d["tp"]
    param = torch.nn.Parameter(vecs.clone())
    loss_fn = train_ti.make_ti_loss_fn(pipe, cfg, ph)
    tbatch = {k: t(v) for k, v in batch.items()}
    tbatch["tokens"] = tbatch["tokens"].long()
    tbatch["override_t"] = tbatch["override_t"].long()
    loss, tlogs = loss_fn(param, tbatch, None)
    optimizer = make_optimizer({"ti": [param]}, lr=LR)
    optimizer.zero_grad()
    loss.backward()
    grad = param.grad.numpy().copy()
    np.testing.assert_allclose(loss.item(), float(logs["loss"]), rtol=1e-5)
    assert tlogs["loss_simple"].item() == pytest.approx(
        float(logs["loss_simple"]), rel=1e-5)
    scale = np.abs(jgrad).max()
    assert scale > 1e-6                      # the vectors get a gradient
    np.testing.assert_allclose(grad, jgrad, atol=1e-4 * scale, rtol=0)
    assert not any(p.grad is not None for p in pipe.parameters())
    optimizer.step()
    np.testing.assert_allclose(param.detach().numpy(), new, atol=1e-5)
    assert np.abs(new - vecs.numpy()).max() > 1e-3


def test_train_ti_then_merge_then_txt2img(tmp_path):
    ckpt = str(tmp_path / "sd-v1-4.ckpt")
    tiny_sd_checkpoint(ckpt, CFG, seed=3)
    data = tmp_path / "subject"
    data.mkdir()
    r = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(r.integers(0, 255, (40, 40, 3), dtype=np.uint8)
                        ).save(data / f"{i}.png")
    run = train_ti.main([
        "--base", CFG, "--data_root", str(data), "--actual_resume", ckpt,
        "--logdir", str(tmp_path / "logs"), "--max_steps", "2",
        "--image_size", str(SIZE), "--num_vectors", "2", "--device", "cpu"])
    assert os.path.basename(run).endswith("_ti")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1] and np.isfinite(recs[0]["loss"])
    assert os.listdir(os.path.join(run, "checkpoints")) == \
        ["embeddings_gs-2.pt"]
    out = os.path.join(run, "checkpoints", "embeddings_gs-2.pt")
    vecs = jti.load_ti_checkpoint(out)            # the JAX reader
    assert list(vecs) == ["*"] and vecs["*"].shape == (2, 64)
    table = torch.load(ckpt, weights_only=True)["state_dict"][
        "cond_stage_model.transformer.text_model.embeddings."
        "token_embedding.weight"].numpy()
    face = CLIPTokenizer.synthetic(1024).tokenize("face")[0]
    assert np.abs(vecs["*"] - table[face]).max() > 1e-4   # the vectors moved

    copy = str(tmp_path / "copy.pt")
    shutil.copy(out, copy)
    merged = str(tmp_path / "merged.pt")
    merge.main(["--manager_ckpts", out, copy, "--output_path", merged,
                "--rename", f"{copy}:*=@"])
    imgs = txt2img.main([
        "--config", CFG, "--ckpt", ckpt, "--ti_embedding", merged,
        "--prompt", "a photo of * and @", "--outdir",
        str(tmp_path / "samples"), "--ddim_steps", "2", "--n_samples", "2",
        "--H", str(SIZE), "--W", str(SIZE), "--precision", "fp32",
        "--device", "cpu"])
    assert imgs.shape == (2, SIZE, SIZE, 3) and imgs.dtype == np.uint8
    assert imgs.std() > 1.0
    (folder,) = os.listdir(tmp_path / "samples")
    assert sorted(os.listdir(tmp_path / "samples" / folder)) == \
        ["00000.jpg", "00001.jpg", "grid.jpg"]


def test_ti_step_draws_regulariser_and_frozen_modules(d):
    """``make_ti_train_step`` with the generator's draws: the same seed gives
    the same loss, ``reg_weight`` adds exactly its share of
    ``embedding_reg_loss``, and only the vectors change."""
    pipe, tok = d["tp"], d["tok"]
    cfg = tti.TIConfig(("*",), num_vectors_per_token=1, token_dim=64)
    ph = tti.placeholder_token_ids(cfg, tok)
    init = tti.init_ti_params(cfg, tok, pipe.token_table(), ["face"])
    batch = {"image": t(np.random.default_rng(4).uniform(
        -1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)),
        "tokens": t(tok(["a photo of *", "* smiling"])).long()}
    moved = init + 0.5
    plain = train_ti.make_ti_loss_fn(pipe, cfg, ph)
    reg = train_ti.make_ti_loss_fn(pipe, cfg, ph, reg_weight=0.25,
                                   init_vectors=init)
    gen = lambda: torch.Generator().manual_seed(11)
    with torch.no_grad():
        a, _ = plain(moved, batch, gen())
        b, _ = plain(moved, batch, gen())
        c, logs = reg(moved, batch, gen())
    assert a.item() == b.item() and logs["loss"].item() == a.item()
    np.testing.assert_allclose(
        c.item(), a.item() + 0.25 * tti.embedding_reg_loss(moved, init).item(),
        rtol=1e-6)

    before = {k: v.clone() for k, v in pipe.state_dict().items()}
    param = torch.nn.Parameter(init.clone())
    step = train_ti.make_ti_train_step(pipe, cfg, ph, make_optimizer(
        {"ti": [param]}, lr=LR))
    g = gen()
    losses = [step(param, batch, g)["loss"].item() for _ in range(2)]
    assert losses[0] != losses[1]                 # fresh draws each step
    assert not torch.equal(param.detach(), init)
    assert all(torch.equal(v, before[k]) for k, v in
               pipe.state_dict().items())
    assert not any(p.requires_grad or p.grad is not None
                   for p in pipe.parameters())
