"""PyTorch port, the legacy trainers' CLIs and the bridge's new converters,
on the CPU at tiny size:

* ``cli/train_legacy.py`` resumed: 2 steps, save, restore (``-r``), 2 more
  give the uninterrupted 4-step run's state -- UNet, EMA, AdamW, generator
  -- bit for bit; its ``--export-torch`` file, read back by
  ``legacy.load_reference_checkpoint``, holds the EMA UNet, the first stage
  and BERT bit for bit;
* ``cli/train_ae.py`` resumed the same way (both optimizers, the
  discriminator), its export read back by ``bridge.convert_vae``;
* ``make_legacy_trainer`` over the cond kinds the parity tests do not reach
  (a trainable class embedder, the SpatialRescaler, the first stage as cond
  stage): a finite loss, the UNet and a trainable cond stage moved, a frozen
  one not;
* ``bridge.convert_encoder_unet`` (each pooling head), ``convert_vgg16`` and
  ``convert_lpips`` bit for bit against the JAX converters on synthetic
  CompVis / torchvision / LPIPS states, and the exporters
  (``export_unet`` / ``export_vq`` / ``export_bert_text`` /
  ``export_encoder_unet``) read back by the JAX converters to the port's
  own state.
"""
import os

import pytest
import torch
import yaml

from celebbasis_tpu.models import unet as junet
from celebbasis_tpu.utils import bridge as jbridge
from celebbasis_tpu_torch import legacy
from celebbasis_tpu_torch.cli import train_ae, train_legacy
from celebbasis_tpu_torch.models import unet as tunet
from celebbasis_tpu_torch.utils import bridge

from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny_legacy.yaml")


def _equal_states(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_states(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        elif isinstance(a[k], list):
            assert len(a[k]) == len(b[k]), k
            for x, y in zip(a[k], b[k]):
                _equal_states(x, y) if isinstance(x, dict) else \
                    (x == y) or pytest.fail(k)
        else:
            assert a[k] == b[k], k


def _resume_state(logdir, step):
    return torch.load(os.path.join(logdir, "resume", f"step_{step:08d}.pt"),
                      weights_only=True)


def test_train_legacy_resume_is_the_uninterrupted_run(tmp_path):
    common = ["--config", TINY, "--fake-data", "6", "--batch-size", "2",
              "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    run_a = train_legacy.main(common + ["--max-steps", "4", "--logdir", a])
    train_legacy.main(common + ["--max-steps", "2", "--logdir", b])
    run_b = train_legacy.main(common + ["--max-steps", "4", "--logdir", b,
                                        "-r"])
    assert sorted(run_b["losses"]) == [2, 3]
    assert run_b["losses"][3] == run_a["losses"][3]
    _equal_states(_resume_state(a, 4), _resume_state(b, 4))
    for x, y in zip(run_a["ldm"].unet.parameters(),
                    run_b["ldm"].unet.parameters()):
        assert torch.equal(x, y)


def test_train_legacy_export_reads_back(tmp_path):
    cfg_path = os.path.join(REPO, "configs", "tiny_legacy_bert.yaml")
    ckpt = str(tmp_path / "out.ckpt")
    run = train_legacy.main(["--config", cfg_path, "--fake-data", "4",
                             "--batch-size", "2", "--max-steps", "2",
                             "--device", "cpu", "--logdir",
                             str(tmp_path / "log"), "--export-torch", ckpt])
    ldm, ema = run["ldm"], run["trainer"].ema
    with open(cfg_path) as f:
        fresh = legacy.build_legacy_ldm(yaml.safe_load(f), torch.float32,
                                        device="cpu")
    assert legacy.load_reference_checkpoint(fresh, ckpt) == []
    for n, p in fresh.unet.named_parameters():
        assert torch.equal(p, ema.params[n]), n
    assert any(not torch.equal(ema.params[n], p)
               for n, p in ldm.unet.named_parameters())
    for mod in ("first_stage", "cond_stage"):
        mine = getattr(ldm, mod).state_dict()
        for k, v in getattr(fresh, mod).state_dict().items():
            assert torch.equal(v, mine[k].float()), (mod, k)


def test_train_ae_resume_and_export(tmp_path):
    cfg = os.path.join(REPO, "configs", "tiny_ae.yaml")
    common = ["--config", cfg, "--fake-data", "4", "--ckpt-every", "1",
              "--log-every", "1", "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ckpt = str(tmp_path / "ae.ckpt")
    run_a = train_ae.main(common + ["--max-steps", "3", "--logdir", a,
                                    "--export-torch", ckpt])
    train_ae.main(common + ["--max-steps", "2", "--logdir", b])
    run_b = train_ae.main(common + ["--max-steps", "3", "--logdir", b, "-r"])
    assert run_a["logs"][2] == run_b["logs"][2]
    _equal_states(_resume_state(a, 3), _resume_state(b, 3))
    model = run_a["trainer"].model
    sd = torch.load(ckpt, weights_only=True)["state_dict"]
    back = bridge.convert_vae(sd, model.cfg, prefix="")
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v.float()), k
    assert float(run_a["trainer"].loss.logvar) == 0.0   # never trained


def _tiny_cfg(kind):
    with open(TINY) as f:
        cfg = yaml.safe_load(f)
    mp = cfg["model"]["params"]
    up = mp["unet_config"]["params"]
    if kind == "class":
        mp["cond_stage_config"] = {
            "target": "ldm.modules.encoders.modules.ClassEmbedder",
            "params": {"n_classes": 5, "embed_dim": 16}}
        mp["conditioning_key"] = "crossattn"
        mp["cond_stage_trainable"] = True
        up.update(use_spatial_transformer=True, context_dim=16,
                  num_heads=4, num_head_channels=-1)
    elif kind == "rescaler":
        mp["cond_stage_config"] = {
            "target": "ldm.modules.encoders.modules.SpatialRescaler",
            "params": {"n_stages": 1, "in_channels": 5, "out_channels": 3}}
        mp["conditioning_key"] = "concat"
        up["in_channels"] = 6
    else:                     # the first stage as cond stage (inpainting)
        mp["cond_stage_config"] = "__is_first_stage__"
        mp["conditioning_key"] = "concat"
        up["in_channels"] = 6
    return cfg


def test_trainer_cond_kinds():
    for kind in ("class", "rescaler", "first_stage"):
        cfg = _tiny_cfg(kind)
        ldm = train_legacy.build_model(cfg, seed=1,
                                       device=torch.device("cpu"))
        assert ldm.cond_kind == kind
        tr = train_legacy.make_legacy_trainer(
            ldm, cfg, 2, ema=train_legacy.make_ema(ldm.unet),
            generator=torch.Generator().manual_seed(0))
        assert tr.cond_trainable == (kind == "class")
        data, labels, caps, conds = train_legacy.fake_dataset(ldm, 2)
        before = {n: p.detach().clone() for n, p in ldm.named_parameters()}
        loss = tr.step(torch.from_numpy(data),
                       train_legacy.cond_batch(ldm, labels, caps, conds))
        assert torch.isfinite(loss), kind
        moved = {n.split(".")[0] for n, p in ldm.named_parameters()
                 if not torch.equal(p, before[n])}
        assert moved == ({"unet", "cond_stage"} if kind == "class"
                         else {"unet"}), kind


def _random_state(module, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g)
            for k, v in module.state_dict().items()}


def test_bridge_converters_equal_jax():
    kw = dict(in_channels=4, out_channels=5, model_channels=32,
              channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(2,), num_head_channels=16,
              use_spatial_transformer=False)
    tcfg, jcfg = tunet.UNetConfig(**kw), junet.UNetConfig(**kw)
    np_of = lambda st: {k: v.numpy() for k, v in st.items()}
    for seed, pool in enumerate(("attention", "adaptive", "spatial",
                                 "spatial_v2")):
        state = _random_state(tunet.EncoderUNetModel(
            tcfg, image_size=8, pool=pool, dtype=torch.float32), seed)
        ckpt = bridge.export_encoder_unet(state, tcfg, pool)
        assert all(k.startswith("model.") for k in ckpt)
        used = set()
        ours = bridge.convert_encoder_unet(ckpt, tcfg, pool, used=used)
        assert used == set(ckpt)
        theirs = bridge.from_jax_params(jbridge.convert_encoder_unet(
            np_of(ckpt), jcfg, pool))
        for got in (ours, theirs):
            assert sorted(got) == sorted(state)
            for k in state:
                assert torch.equal(got[k], state[k]), (pool, k)

    g = torch.Generator().manual_seed(7)
    idx = bridge._VGG16_FEATURE_IDX
    chans = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
    vgg, cin = {}, 3
    for i, c in zip(idx, chans):
        vgg[f"features.{i}.weight"] = torch.randn(c, cin, 3, 3, generator=g)
        vgg[f"features.{i}.bias"] = torch.randn(c, generator=g)
        cin = c
    vgg["classifier.0.weight"] = torch.zeros(2, 2)        # not read
    heads = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g)
             for i, c in enumerate((64, 128, 256, 512, 512))}
    ours = bridge.convert_lpips(heads, vgg)
    theirs = bridge.from_jax_params(jbridge.convert_lpips(
        np_of(heads), np_of(vgg)))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    from celebbasis_tpu_torch.models.lpips import LPIPS
    LPIPS().load_state_dict(ours, strict=True)
    v16 = bridge.convert_vgg16(vgg)
    assert all(torch.equal(v16[k], ours[f"vgg.{k}"]) for k in v16)

    # the exporters: the JAX converters read them back to the port's state
    with open(os.path.join(REPO, "configs", "tiny_legacy_bert.yaml")) as f:
        ldm = legacy.build_legacy_ldm(yaml.safe_load(f), torch.float32,
                                      device="cpu")
    unet = _random_state(ldm.unet, 11)
    ckpt = bridge.export_unet(unet, ldm.unet.cfg)
    jucfg = junet.UNetConfig(**{f: getattr(ldm.unet.cfg, f)
                                for f in ldm.unet.cfg.__dataclass_fields__})
    back = bridge.from_jax_params(jbridge.convert_unet(np_of(ckpt), jucfg))
    assert all(torch.equal(back[k], unet[k]) for k in unet)
    bert = _random_state(ldm.cond_stage, 12)
    back = bridge.convert_bert_text(
        bridge.export_bert_text(bert, ldm.cond_stage.cfg.depth),
        ldm.cond_stage.cfg.depth)
    assert sorted(back) == sorted(bert)
    assert all(torch.equal(back[k], bert[k]) for k in bert)
    with open(TINY) as f:
        vq = legacy.build_legacy_ldm(yaml.safe_load(f), torch.float32,
                                     device="cpu").first_stage
    vstate = _random_state(vq, 13)
    back = bridge.convert_vq(bridge.export_vq(vstate, vq.cfg), vq.cfg)
    assert all(torch.equal(back[k], vstate[k]) for k in vstate)
    with pytest.raises(KeyError, match="not exported"):
        bridge.export_vq({**vstate, "extra.weight": torch.zeros(1)}, vq.cfg)
