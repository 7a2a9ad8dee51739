"""PyTorch port, the first-stage GAN trainer against the JAX package on the
CPU at tiny size (float32, 32x32 images, random weights on every leaf
carried across by ``bridge.from_jax_params``):

* LPIPS (VGG16 trunk and heads) and the PatchGAN discriminator with
  BatchNorm and with ActNorm: outputs within 1e-4 of the largest; hinge and
  vanilla discriminator losses within 1e-6;
* one ``AETrainer.train_batch`` of a KL autoencoder
  (``LPIPSWithDiscriminator``) and of a VQ one
  (``VQLPIPSWithDiscriminator``, with perplexity; its perceptual weight 0,
  and both with a one-layer PatchGAN, for the JAX compile's sake), from the
  same weights at step 0 and at step 1 of ``disc_start`` 1 (the factor the
  port resolves before its step against the JAX step's own): both
  passes' logs --
  the losses, the adaptive ``d_weight`` (the reference's
  ``torch.autograd.grad`` against the decoder's last conv here, a pullback
  there), the logits -- within 1e-4 (relative), the generator's and the
  discriminator's gradients within 1e-4 of each leaf's largest entry, the
  parameters of both optimizers after Adam within 2e-2 of each one's lr
  (``assert_adamw_close``; the generator at lr_g_factor 0.1), ``logvar``
  in neither optimizer; before ``disc_start`` the logs and the
  generator's gradients, the discriminator's gradients zero on both sides
  and its parameters unmoved.  The JAX
  trainer's posterior noise comes from ``sample_posterior``, which is
  patched to hand it the port's draws (generator pass, then discriminator
  pass); its optimizers are Adam (betas 0.5 / 0.9) chained behind
  ``stash_grads``, which keeps the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from celebbasis_tpu.models import vae as jvae
from celebbasis_tpu.models import vq as jvq
from celebbasis_tpu.models.lpips import LPIPS as JLPIPS
from celebbasis_tpu.train import ae_loss as jloss
from celebbasis_tpu.train import ae_trainer as jtrainer
from celebbasis_tpu_torch.models import vae as tvae
from celebbasis_tpu_torch.models import vq as tvq
from celebbasis_tpu_torch.models.lpips import LPIPS
from celebbasis_tpu_torch.train import ae_loss as tloss
from celebbasis_tpu_torch.train.ae_trainer import AETrainer
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import (assert_adamw_close,  # noqa: F401
                                 assert_trained_grads_close,
                                 compiled_optimizer, np_tree,
                                 one_blas_thread, random_params,
                                 stash_grads)

KEY = jax.random.key(0)
# the discriminator's rate, and the generator's (lr_g_factor 0.1): the
# discriminator pass reconstructs with the updated generator, whose update
# differs between the two sides where a gradient is below the checks'
# resolution (``assert_adamw_close``); at 1e-4 that difference stays below
# the discriminator gradients' 1e-4
LR, G_FACTOR = 1e-3, 0.1


def _close(got, ref, rel=1e-4):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= rel * scale, \
        (float(np.abs(got - ref).max()), scale)


def _images(seed, n=2):
    r = np.random.default_rng(seed)
    return r.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)


def test_lpips_discriminator_and_d_losses_match_jax():
    x, y = _images(0), _images(1)
    jm = JLPIPS()
    params = random_params(jm.init, KEY, x, y, seed=1)
    tm = LPIPS()
    tm.load_state_dict(bridge.from_jax_params(np_tree(params)), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2, 1, 1, 1)
    _close(got, jax.jit(jm.apply)(params, x, y))

    for actnorm in (False, True):
        jd = jloss.NLayerDiscriminator(ndf=8, n_layers=3,
                                       use_actnorm=actnorm)
        dp = random_params(jd.init, KEY, x, seed=2)
        td = tloss.NLayerDiscriminator(3, ndf=8, n_layers=3,
                                       use_actnorm=actnorm)
        td.load_state_dict(bridge.from_jax_params(np_tree(dp)), strict=True)
        with torch.no_grad():
            logits = td(torch.from_numpy(x))
        ref = jax.jit(jd.apply)(dp, x)
        _close(logits, ref)
    a, b = np.asarray(ref), _images(2, 2)[..., :1] * 2
    for tf, jf in ((tloss.hinge_d_loss, jloss.hinge_d_loss),
                   (tloss.vanilla_d_loss, jloss.vanilla_d_loss)):
        assert abs(float(tf(torch.from_numpy(a), torch.from_numpy(b)))
                   - float(jf(a, b))) <= 1e-6


def _vae_cfgs(double_z):
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=3,
              embed_dim=3, double_z=double_z, resolution=32)
    return jvae.VAEConfig(**kw), tvae.VAEConfig(**kw)


@pytest.mark.parametrize("kind", ["kl", "vq"])
def test_ae_trainer_step_matches_jax(kind, monkeypatch):
    """One batch from the same weights on both sides of ``disc_start`` 1:
    at step 0 (the discriminator's factor 0: its pass moves nothing) and at
    step 1 (the full GAN step, every check)."""
    jcfg, tcfg = _vae_cfgs(kind == "kl")
    # a one-layer PatchGAN: the three-layer one (checked above) doubles the
    # JAX compile
    dkw = dict(disc_start=1, disc_ndf=8, disc_weight=0.5, disc_num_layers=1)
    if kind == "kl":
        jmodel = jvae.AutoencoderKL(jcfg, dtype=jnp.float32)
        make_model = lambda: tvae.AutoencoderKL(tcfg, dtype=torch.float32)
        dcfg = dict(dkw, kl_weight=1e-3, logvar_init=0.3)
        jl = jloss.LPIPSWithDiscriminator(jloss.DiscLossConfig(**dcfg))
        make_loss = lambda: tloss.LPIPSWithDiscriminator(
            tloss.DiscLossConfig(**dcfg))
    else:
        jmodel = jvq.VQModel(jcfg, n_embed=16, dtype=jnp.float32)
        make_model = lambda: tvq.VQModel(tcfg, n_embed=16,
                                         dtype=torch.float32)
        # LPIPS has its checks above and in the KL case
        dcfg = dict(dkw, n_classes=16, perceptual_weight=0.0)
        jl = jloss.VQLPIPSWithDiscriminator(jloss.DiscLossConfig(**dcfg))
        make_loss = lambda: tloss.VQLPIPSWithDiscriminator(
            tloss.DiscLossConfig(**dcfg))
    adam = lambda lr: compiled_optimizer(optax.chain(
        stash_grads(), optax.adam(lr, b1=0.5, b2=0.9)))
    jt = jtrainer.AETrainer(jmodel, jl, LR, tx_g=adam(LR * G_FACTOR),
                            tx_d=adam(LR))
    params = random_params(lambda k: jt.init(k, image_size=32).params, KEY,
                           seed=5)
    params["loss"]["logvar"] = np.asarray(0.3, np.float32)
    x = _images(3)
    gen = torch.Generator().manual_seed(4)
    zshape = (2, 16, 16, 3)
    eps = [torch.randn(zshape, generator=gen) for _ in range(2)]
    draws = []
    monkeypatch.setattr(
        jtrainer, "sample_posterior",
        lambda rng, mean, logvar: mean + jnp.exp(0.5 * logvar) * draws.pop(0))

    def both_sides(step):
        tmodel, tl = make_model(), make_loss()
        tmodel.load_state_dict(bridge.from_jax_params(np_tree(params["ae"])),
                               strict=True)
        tl.load_state_dict(bridge.from_jax_params(np_tree(params["loss"])),
                           strict=True)
        tt = AETrainer(tmodel, tl, LR, lr_g_factor=G_FACTOR)
        tt.global_step = step
        log = tt.train_batch(torch.from_numpy(x), override_eps=tuple(eps))
        assert tt.global_step == step + 1
        draws[:] = [jnp.asarray(e.numpy()) for e in eps]
        state = jtrainer.AETrainState(params, jt.tx_g.init(params["ae"]),
                                      jt.tx_d.init(params["loss"]["disc"]),
                                      step)
        state, jlog = jt.train_batch(state, jnp.asarray(x),
                                     jax.random.key(1))
        assert sorted(log) == sorted(jlog)
        for k, v in jlog.items():
            ref = float(v)
            assert abs(float(log[k]) - ref) <= 1e-4 * max(abs(ref), 1e-3), \
                (k, float(log[k]), ref)
        assert float(jlog["train/d_weight"]) > 0
        assert float(log["train/disc_factor"]) == float(step >= 1)
        grads = {**{f"ae.{n}": p.grad for n, p in tmodel.named_parameters()},
                 **{f"disc.{n}": p.grad
                    for n, p in tl.disc.named_parameters()}}
        jgrads = bridge.from_jax_params(np_tree(
            {"ae": state.opt_g[0], "disc": state.opt_d[0]}))
        return tmodel, tl, state, grads, jgrads

    before = {f"{part}.{k}": v for part, tree in (
        ("ae", params["ae"]), ("disc", params["loss"]["disc"]))
        for k, v in bridge.from_jax_params(np_tree(tree)).items()}
    # before disc_start: the generator's gradients hold, the
    # discriminator's are zero on both sides and its parameters stay
    tmodel, tl, state, grads, jgrads = both_sides(0)
    ae = lambda d: {k: v for k, v in d.items() if k.startswith("ae.")}
    assert_trained_grads_close(ae(grads), ae(jgrads))
    for n, p in tl.disc.named_parameters():
        assert float(grads[f"disc.{n}"].abs().max()) == 0.0 \
            == float(np.abs(np.asarray(jgrads[f"disc.{n}"])).max())
        assert torch.equal(p.detach(), before[f"disc.{n}"])

    tmodel, tl, state, grads, jgrads = both_sides(1)
    assert_trained_grads_close(grads, jgrads)
    for part, module, lr, new_ in (
            ("ae", tmodel, LR * G_FACTOR, state.params["ae"]),
            ("disc", tl.disc, LR, state.params["loss"]["disc"])):
        now = {f"{part}.{n}": p for n, p in module.named_parameters()}
        moved = max(float((now[k].detach() - before[k]).abs().max())
                    for k in now)
        # Adam's first step moves by about lr (plus two float32 ulps of 1)
        assert 0.5 * lr < moved <= 1.01 * lr + 2.4e-7
        assert_adamw_close(now, bridge.from_jax_params(np_tree(
            {part: new_})), lr, {k: jgrads[k] for k in now})
    assert float(tl.logvar) == pytest.approx(0.3)   # in neither optimizer

