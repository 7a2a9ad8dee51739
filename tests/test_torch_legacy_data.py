"""PyTorch port, the legacy family's host-side modules against the JAX
package's (the port keeps its own copies): bit for bit, on the CPU.

* ``utils/image_ops.py``: every array function on the same inputs (resize
  kernels, colour spaces, crops, augmentations, PSNR / SSIM, patches);
* ``data/degradation.py``: the BSRGAN chains (variant, paired, plus; light
  and full) from one ``np.random.Generator`` seed, and its building blocks;
* ``data/legacy.py``: LSUN-style lists, FacesHQ, the ImageNet folder, and
  ``ImageNetSR`` with a PIL degradation and with ``bsrgan`` /
  ``bsrgan_light``, item by item from one seed;
* ``train/lr_schedule.py``: the four schedules at 20 steps, exactly
  (``lambda_linear_traceable`` against the JAX package's jnp twin);
* ``utils/registry.py`` resolves the reference's targets to the port's
  classes; ``utils/misc.py`` equals its JAX counterpart.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from celebbasis_tpu.data import degradation as jdeg
from celebbasis_tpu.data import legacy as jdata
from celebbasis_tpu.train import lr_schedule as jlr
from celebbasis_tpu.utils import image_ops as jops
from celebbasis_tpu.utils import misc as jmisc
from celebbasis_tpu_torch.data import degradation as tdeg
from celebbasis_tpu_torch.data import legacy as tdata
from celebbasis_tpu_torch.train import lr_schedule as tlr
from celebbasis_tpu_torch.utils import image_ops as tops
from celebbasis_tpu_torch.utils import misc as tmisc

from _torch_threads import one_blas_thread  # noqa: F401  (one thread)


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")


def test_image_ops_equal_jax(tmp_path):
    r = np.random.default_rng(0)
    f32 = r.random((37, 41, 3)).astype(np.float32)
    u8 = r.integers(0, 256, (40, 44, 3), dtype=np.uint8)
    u8b = np.clip(u8.astype(int) + r.integers(-9, 10, u8.shape), 0,
                  255).astype(np.uint8)
    calls = [("uint2single", (u8,)), ("single2uint", (f32,)),
             ("uint162single", ((u8.astype(np.uint16) * 257),)),
             ("single2uint16", (f32,)), ("modcrop", (u8, 3)),
             ("modcrop", (u8[..., 0], 3)), ("shave", (u8, 2)),
             ("rgb2ycbcr", (u8, True)), ("rgb2ycbcr", (f32, False)),
             ("bgr2ycbcr", (u8, False)), ("bgr2ycbcr", (f32, True)),
             ("ycbcr2rgb", (f32,)), ("ycbcr2rgb", (u8,)),
             ("channel_convert", (3, "gray", [u8, f32])),
             ("channel_convert", (3, "y", [u8])),
             ("channel_convert", (1, "RGB", [u8[..., :1]])),
             ("calculate_psnr", (u8, u8b, 2)),
             ("calculate_ssim", (u8, u8b, 1)),
             ("calculate_ssim", (u8[..., 0], u8b[..., 0], 0)),
             ("cubic", (np.linspace(-3, 3, 61),)),
             ("calculate_weights_indices", (37, 19, 0.5, "cubic", 4, True)),
             ("calculate_weights_indices", (37, 74, 2.0, "cubic", 4, True)),
             ("imresize_np", (f32, 0.5, True)), ("imresize_np", (f32, 1.7)),
             ("imresize_np", (f32[..., 0], 1 / 3, False)),
             ("imresize", (f32.transpose(2, 0, 1).copy(), 0.4, True)),
             ("patches_from_image", (u8, 16, 4, 30)),
             ("patches_from_image", (u8, 16, 4, 50))]
    calls += [("augment_img", (u8, m)) for m in range(8)]
    calls += [("augment_img_np3", (f32, m)) for m in range(8)]
    for name, args in calls:
        _same(getattr(tops, name)(*args), getattr(jops, name)(*args))
    for seed in range(4):
        _same(tops.augment_imgs([u8, f32[:40, :40]],
                                rng=np.random.default_rng(seed)),
              jops.augment_imgs([u8, f32[:40, :40]],
                                rng=np.random.default_rng(seed)))
    for side, mod in (("port", tops), ("jax", jops)):
        mod.imsave(u8, str(tmp_path / f"{side}.png"))
    _same(tops.imread_uint(str(tmp_path / "jax.png")),
          jops.imread_uint(str(tmp_path / "port.png")))
    assert tops.get_image_paths(str(tmp_path)) == \
        jops.get_image_paths(str(tmp_path))


def test_degradation_equal_jax():
    r = np.random.default_rng(1)
    img = r.integers(0, 256, (96, 96, 3), dtype=np.uint8)
    for seed in range(3):
        for light in (True, False):
            _same(tdeg.degradation_bsrgan_variant(
                      img, sf=4, rng=np.random.default_rng(seed),
                      light=light),
                  jdeg.degradation_bsrgan_variant(
                      img, sf=4, rng=np.random.default_rng(seed),
                      light=light))
        _same(tdeg.degradation_bsrgan(img, sf=4, lq_patchsize=16,
                                      rng=np.random.default_rng(seed)),
              jdeg.degradation_bsrgan(img, sf=4, lq_patchsize=16,
                                      rng=np.random.default_rng(seed)))
        _same(tdeg.degradation_bsrgan_plus(img, sf=4, lq_patchsize=16,
                                           rng=np.random.default_rng(seed)),
              jdeg.degradation_bsrgan_plus(img, sf=4, lq_patchsize=16,
                                           rng=np.random.default_rng(seed)))
    f = img.astype(np.float32) / 255.0
    _same(tdeg.anisotropic_gaussian_kernel(15, 0.3, 2.0, 4.0),
          jdeg.anisotropic_gaussian_kernel(15, 0.3, 2.0, 4.0))
    _same(tdeg.fspecial("gaussian", 7, 1.5), jdeg.fspecial("gaussian", 7,
                                                           1.5))
    _same(tdeg.add_sharpening(f), jdeg.add_sharpening(f))
    _same(tdeg.bicubic_degradation(f, 2), jdeg.bicubic_degradation(f, 2))


def _write_tree(root, n=4, seed=2):
    r = np.random.default_rng(seed)
    rels = []
    for i in range(n):
        syn = f"n0000000{i % 2}"
        os.makedirs(os.path.join(root, syn), exist_ok=True)
        rel = f"{syn}/img_{i}.png"
        h, w = 70 + 9 * i, 90 - 5 * i
        Image.fromarray(r.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, rel))
        rels.append(rel)
    return rels


def test_legacy_datasets_equal_jax(tmp_path):
    root = str(tmp_path / "imgs")
    rels = _write_tree(root)
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(rels))
    pairs = [
        (lambda m: m.ImageListBase(str(lst), root, size=32, seed=3)),
        (lambda m: m.FacesHQBase(str(lst), root, size=32)),
        (lambda m: m.ImageNetFolder(root, size=32, random_crop=True,
                                    seed=4)),
        (lambda m: m.ImageNetSRTrain(data_root=root, size=64,
                                     degradation="pil_bicubic", seed=5)),
        (lambda m: m.ImageNetSRValidation(data_root=root, size=64,
                                          degradation="bsrgan_light",
                                          seed=6)),
        (lambda m: m.ImageNetSRTrain(data_root=root, size=64,
                                     degradation="bsrgan", seed=7))]
    for make in pairs:
        ours, ref = make(tdata), make(jdata)
        assert len(ours) == len(ref) == len(rels)
        for i in range(len(rels)):
            _same(ours[i], ref[i])
    lr_img = tdata.ImageNetSRTrain(data_root=root, size=64,
                                   degradation="bsrgan", seed=7)[0]
    assert lr_img["LR_image"].shape == (16, 16, 3)


def test_lr_schedules_equal_jax():
    steps = range(20)
    cyc = dict(warm_up_steps=[3, 2], f_min=[0.1, 0.2], f_max=[1.0, 0.8],
               f_start=[1e-3, 0.05], cycle_lengths=[8, 12])
    for name, args in (
            ("warmup_cosine", (2e-4, 5, 0.1, 1.0, 1e-3, 15)),
            ("warmup_cosine_cycles", (3e-4,)),
            ("lambda_linear", (5e-5,))):
        kw = cyc if len(args) == 1 else {}
        ours = getattr(tlr, name)(*args, **kw)
        ref = getattr(jlr, name)(*args, **kw)
        for s in steps:
            assert ours(s) == ref(s), (name, s)
    ours = tlr.lambda_linear_traceable(5e-5, **cyc)
    ref = jlr.lambda_linear_traceable(5e-5, **cyc)
    for s in steps:
        got, want = ours(s), ref(jnp.asarray(s))
        assert np.float32(got) == np.asarray(want), s
        assert np.float32(got).dtype == np.asarray(want).dtype
    # a LambdaLR multiplier, and set_lr into a tensor rate
    p = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.AdamW([p], lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, tlr.lambda_linear(
        1.0, **cyc))
    for s in range(1, 6):
        opt.step()
        sched.step()
        assert opt.param_groups[0]["lr"] == pytest.approx(
            jlr.lambda_linear(1.0, **cyc)(s))
    opt = tlr.adamw_with_schedule([p], tlr.lambda_linear(1e-3, **cyc))
    assert opt.defaults["weight_decay"] == 1e-2
    opt.param_groups[0]["lr"] = torch.tensor(0.0)
    tlr.set_lr(opt, 0.25)
    assert float(opt.param_groups[0]["lr"]) == 0.25


def test_registry_and_misc():
    from celebbasis_tpu_torch.data.face_id import FaceIdDataset
    from celebbasis_tpu_torch.models.cond_stages import SpatialRescaler
    from celebbasis_tpu_torch.train import ae_loss
    from celebbasis_tpu_torch.utils import registry
    from celebbasis_tpu.utils import registry as jregistry

    assert sorted(registry.REFERENCE_TARGETS) == \
        sorted(jregistry.REFERENCE_TARGETS)
    inst = registry.instantiate_from_config
    loss = inst({"target": "ldm.modules.losses.LPIPSWithDiscriminator",
                 "params": {"disc_start": 5, "kl_weight": 1e-6,
                            "disc_weight": 0.5, "disc_ndf": 8}})
    assert isinstance(loss, ae_loss.LPIPSWithDiscriminator)
    assert loss.cfg.disc_start == 5
    vq = inst({"target": "taming.modules.losses.vqperceptual."
                         "VQLPIPSWithDiscriminator",
               "params": {"disc_start": 1, "perceptual_loss": "lpips",
                          "disc_ndf": 8}})
    assert isinstance(vq, ae_loss.VQLPIPSWithDiscriminator)
    sched = inst({"target": "ldm.lr_scheduler.LambdaLinearScheduler",
                  "params": {"warm_up_steps": [10],
                             "cycle_lengths": [10 ** 12], "f_start": [1e-6],
                             "f_max": [1.0], "f_min": [1.0],
                             "verbosity_interval": 0}})
    assert abs(sched(10 ** 7) - 1.0) < 1e-9
    resc = inst({"target": "ldm.modules.encoders.modules.SpatialRescaler",
                 "params": {"n_stages": 2, "in_channels": 5,
                            "out_channels": 3}})
    assert isinstance(resc, SpatialRescaler)
    assert inst({"target": "torch.nn.Identity"})(7) == 7
    assert inst("__is_unconditional__") is None
    assert registry.REFERENCE_TARGETS[
        "ldm.data.face_id.FaceIdDatasetOneShot"].__module__ == \
        registry.__name__
    with pytest.raises(ValueError, match="no registered counterpart"):
        inst({"target": "ldm.models.diffusion.ddpm.Foo"})
    assert FaceIdDataset.__module__.startswith("celebbasis_tpu_torch")

    tree = {"a": torch.zeros(3, 4), "b": [torch.zeros(5)]}
    assert tmisc.count_params(tree) == 17 == jmisc.count_params(
        {"a": jnp.zeros((3, 4)), "b": [jnp.zeros(5)]})
    assert tmisc.count_params(torch.nn.Linear(3, 2)) == 8
    _same(tmisc.log_txt_as_img((64, 32), ["hello world", "two"]),
          jmisc.log_txt_as_img((64, 32), ["hello world", "two"]))
    x = np.zeros((2, 8, 8, 3))
    assert tmisc.isimage(x) and not tmisc.ismap(x)
    assert tmisc.ismap(np.zeros((2, 8, 8, 5)))
