"""PyTorch port, UNet with ``remat=True`` (a config's ``use_checkpoint``):
each ResBlock and SpatialTransformer is recomputed in the backward pass, as
``nn.remat`` does in the JAX module.

* output and parameter gradients of a tiny UNet with ``remat=True`` against
  the JAX UNet with ``remat=True`` (fp32; output within 1e-4 as in
  ``test_torch_unet``, gradients within 1e-4 of the largest entry of each
  leaf, floored at a thousandth of the largest entry of the tree, as in
  ``test_torch_train_step``; a leaf whose gradient is zero by construction
  holds rounding noise, below 1e-6 of the tree's largest entry on both
  sides);
* against the port's own ``remat=False``: output and gradients bit for bit,
  and the blocks run twice per step (forward, then recomputed in backward)
  where ``remat=False`` runs them once; ``no_grad`` does not recompute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.models import unet as junet
from celebbasis_tpu_torch.models import unet as tunet
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import np_tree, random_params, t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)


def _inputs(seed=3):
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ts = np.array([7, 640], np.int32)
    ctx = r.standard_normal((2, 77, 64)).astype(np.float32)
    w = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    return x, ts, ctx, w


@pytest.fixture(scope="module")
def params():
    jm = junet.UNetModel(junet.UNetConfig.tiny(), jnp.float32)
    return random_params(jm.init, jax.random.key(0), jnp.zeros((1, 8, 8, 4)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)),
                         seed=4)


def _port(params, remat):
    m = tunet.UNetModel(dataclasses.replace(tunet.UNetConfig.tiny(),
                                            remat=remat), torch.float32)
    return bridge.load_jax_params(m, np_tree(params)).train()


def _port_step(m, x, ts, ctx, w):
    """Output and d(sum(out * w))/d(params), by parameter name."""
    m.zero_grad(set_to_none=True)
    out = m(t(x), t(ts).long(), t(ctx))
    (out * t(w)).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in m.named_parameters()}


def _count_block_calls(m):
    calls = []
    for name, mod in m.named_modules():
        if isinstance(mod, (tunet.ResBlock, tunet.SpatialTransformer)):
            # a pre-hook: the recomputation stops once it has what the
            # backward needs, before the module's forward hooks would run
            mod.register_forward_pre_hook(
                lambda *_a, _n=name: calls.append(_n))
    return calls


def test_remat_output_and_gradients_match_jax_remat(params):
    x, ts, ctx, w = _inputs()
    jm = junet.UNetModel(dataclasses.replace(junet.UNetConfig.tiny(),
                                             remat=True), jnp.float32)

    def loss(p):
        out = jm.apply(p, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
        return (out * jnp.asarray(w)).sum(), out

    (_, ref_out), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    ref_grads = bridge.from_jax_params(np_tree(ref_grads))
    out, grads = _port_step(_port(params, True), x, ts, ctx, w)
    assert np.abs(np.asarray(ref_out)).max() > 0.05
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-4)
    assert sorted(grads) == sorted(ref_grads)
    top = max(float(r.abs().max()) for r in ref_grads.values())
    for name, g in grads.items():
        r = ref_grads[name]
        if float(r.abs().max()) < 1e-6 * top:
            # a conv bias in front of a one-channel-per-group GroupNorm: zero
            # by construction, rounding noise on both sides
            assert float(g.abs().max()) < 1e-6 * top, name
            continue
        scale = max(float(r.abs().max()), 1e-3 * top)
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4 * scale,
                                   err_msg=name)


def test_remat_recomputes_and_equals_no_remat_bit_for_bit(params):
    x, ts, ctx, w = _inputs(5)
    runs = {}
    for remat in (False, True):
        m = _port(params, remat)
        calls = _count_block_calls(m)
        out, grads = _port_step(m, x, ts, ctx, w)
        runs[remat] = (out, grads, len(calls))
        with torch.no_grad():
            calls.clear()
            m(t(x), t(ts).long(), t(ctx))
            assert len(calls) == runs[False][2]     # no recompute
    (o0, g0, n0), (o1, g1, n1) = runs[False], runs[True]
    assert n0 > 0 and n1 == 2 * n0
    assert torch.equal(o0, o1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
