"""PyTorch port, the readers of the W0 nets' checkpoints
(``utils.bridge_align``):

* against the JAX ``convert_faceboxes`` / ``convert_pipnet``, for FaceBoxes
  V2 and V1 and PIPNet ResNet-101, ResNet-18 at stride 16, MobileNetV2 and
  MobileNetV3, on one reference-layout state dict each (the port's random
  weights written in the reference's layout, with a ``module.`` key the
  readers leave unused): both through ``from_jax_params``, equal tensors,
  and equal to the weights written out;
* every key and shape of ``manifests/faceboxesv2.json`` (192 keys) and
  ``manifests/pipnet_wflw_r101.json`` (634 keys) read on the ``meta``
  device, all but ``num_batches_tracked`` used, loaded strictly.
"""
import json
import os

import pytest
import torch

from celebbasis_tpu.align import pipnet as jpip
from celebbasis_tpu.utils import bridge_align as jba
from celebbasis_tpu_torch.align import faceboxes as tfb
from celebbasis_tpu_torch.align import pipnet as tpip
from celebbasis_tpu_torch.utils import bridge, bridge_align

from _torch_port_helpers import reference_layout
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch", [
    "fb2", "fb1", "r101", "r18_s16", "mbnetv2", "mbnetv3"])
def test_readers_equal_the_jax_converters(arch):
    if arch.startswith("fb"):
        version = int(arch[2])
        with torch.device("meta"):
            shapes = (tfb.FaceBoxesV2() if version == 2
                      else tfb.FaceBoxesV1()).state_dict()
        export = lambda s: reference_layout(
            s, bridge_align.faceboxes_pairs(version))
        jconv = lambda s: jba.convert_faceboxes(s, version)
        tconv = lambda s: bridge_align.convert_faceboxes(s, version)
    else:
        jcfg = {"r101": jpip.PIPNetConfig(),
                "r18_s16": jpip.PIPNetConfig.resnet18(net_stride=16),
                "mbnetv2": jpip.PIPNetConfig.mbnetv2(),
                "mbnetv3": jpip.PIPNetConfig.mbnetv3()}[arch]
        tcfg = tpip.PIPNetConfig(**jcfg.__dict__)
        with torch.device("meta"):
            shapes = tpip.PIPNet(tcfg).state_dict()
        export = lambda s: reference_layout(
            s, bridge_align.pipnet_pairs(tcfg))
        jconv = lambda s: jba.convert_pipnet(s, jcfg)
        tconv = lambda s: bridge_align.convert_pipnet(s, tcfg)
    g = torch.Generator().manual_seed(len(arch))
    ours = {k: torch.rand(v.shape, generator=g) + 0.5 for k, v in
            shapes.items()}
    ref_layout = export(ours)
    ref_layout["module.extra.num_batches_tracked"] = torch.tensor(3)
    used = set()
    got = (bridge_align.convert_faceboxes(ref_layout, version, used=used)
           if arch.startswith("fb") else
           bridge_align.convert_pipnet(ref_layout, tcfg, used=used))
    assert sorted(ref_layout) == sorted(used | {
        "module.extra.num_batches_tracked"})
    ref = bridge.from_jax_params(jconv({k: v.numpy() for k, v in
                                        ref_layout.items()}))
    assert sorted(got) == sorted(ref) == sorted(ours)
    for k in ref:
        assert torch.equal(got[k], ref[k]) and torch.equal(got[k], ours[k]), k
    assert sorted(tconv(ref_layout)) == sorted(got)


def test_readers_take_every_manifest_key_on_meta():
    for name, convert, module in (
            ("faceboxesv2", bridge_align.convert_faceboxes, tfb.FaceBoxesV2),
            ("pipnet_wflw_r101",
             lambda s, used: bridge_align.convert_pipnet(
                 s, tpip.PIPNetConfig(), used=used),
             lambda: tpip.PIPNet(tpip.PIPNetConfig()))):
        with open(os.path.join(REPO, "manifests", name + ".json")) as f:
            keys = json.load(f)["keys"]
        with torch.device("meta"):
            state = {k: torch.empty(s) for k, s in keys.items()}
            net = module()
        used = set()
        got = convert(state, used=used)
        assert set(keys) - used == {k for k in keys
                                    if k.endswith("num_batches_tracked")}
        net.load_state_dict(got, strict=True, assign=True)
        assert len(keys) == {"faceboxesv2": 192,
                             "pipnet_wflw_r101": 634}[name]
