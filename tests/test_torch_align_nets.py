"""PyTorch port, W0 nets: FaceBoxes (V2 and V1) and PIPNet (the tiny
bottleneck ResNet; ResNet-18 at net_stride 16, 64 and 128; MobileNetV2 and
the reference's MobileNetV3 with its SE layers) against the JAX
modules with the same random weights, carried across by
``utils.bridge.load_jax_params`` (strict), on the same inputs from a seed.

fp32 on the CPU; every output within 1e-4 of the largest entry of that
output (summation order inside the convolutions), as for the evaluation
networks.  The stride-16 case also pins the transposed convolution's
kernel layout (flax ``transpose_kernel=True`` against torch's
``ConvTranspose2d``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celebbasis_tpu.align import faceboxes as jfb
from celebbasis_tpu.align import pipnet as jpip
from celebbasis_tpu_torch.align import faceboxes as tfb
from celebbasis_tpu_torch.align import pipnet as tpip
from celebbasis_tpu_torch.utils import bridge

from _torch_port_helpers import np_tree, random_params, t
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REL_TOL = 1e-4


def _close(got: torch.Tensor, ref, name):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    assert scale > 0, name
    np.testing.assert_allclose(got.numpy(), ref, atol=REL_TOL * scale,
                               rtol=0, err_msg=name)


@pytest.mark.parametrize("version", [2, 1])
def test_faceboxes_matches_jax(version):
    jnet = jfb.FaceBoxesV2() if version == 2 else jfb.FaceBoxesV1()
    tnet = tfb.FaceBoxesV2() if version == 2 else tfb.FaceBoxesV1()
    params = random_params(jnet.init, jax.random.key(0),
                           jnp.zeros((1, 96, 128, 3)), seed=version)
    bridge.load_jax_params(tnet, np_tree(params))
    x = np.random.default_rng(version).uniform(
        -120, 150, (2, 96, 128, 3)).astype(np.float32)
    ref_loc, ref_conf = jax.jit(jnet.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        loc, conf = tnet.eval()(t(x))
    assert loc.shape == ref_loc.shape and conf.shape == ref_conf.shape
    _close(loc, ref_loc, "loc")
    _close(conf, ref_conf, "conf")


@pytest.mark.parametrize("cfg", [
    jpip.PIPNetConfig.tiny(),
    jpip.PIPNetConfig.resnet18(num_lms=12, num_nb=3, input_size=64,
                               net_stride=16),
    jpip.PIPNetConfig.resnet18(num_lms=12, num_nb=3, input_size=64,
                               net_stride=64),
    jpip.PIPNetConfig.resnet18(num_lms=12, num_nb=3, input_size=128,
                               net_stride=128),
    jpip.PIPNetConfig.mbnetv2(num_lms=12, num_nb=3, input_size=64),
    jpip.PIPNetConfig.mbnetv3(num_lms=12, num_nb=3, input_size=64),
], ids=["tiny", "r18_s16", "r18_s64", "r18_s128", "mbnetv2", "mbnetv3"])
def test_pipnet_matches_jax(cfg):
    S = cfg.input_size
    jnet = jpip.PIPNet(cfg)
    params = random_params(jnet.init, jax.random.key(0),
                           jnp.zeros((1, S, S, 3)), seed=cfg.net_stride)
    tnet = tpip.PIPNet(tpip.PIPNetConfig(**cfg.__dict__))
    bridge.load_jax_params(tnet, np_tree(params))
    x = np.random.default_rng(S).standard_normal((2, S, S, 3)).astype(
        np.float32)
    refs = jax.jit(jnet.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        outs = tnet.eval()(t(x))
    g = S // (32 if cfg.arch != "resnet" else cfg.net_stride)
    for name, got, ref in zip(("cls", "x", "y", "nb_x", "nb_y"), outs, refs):
        assert got.shape[:3] == (2, g, g), (name, got.shape)
        _close(got, ref, name)
