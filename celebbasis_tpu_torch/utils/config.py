"""Config system: typed specs + reference-YAML compatibility.

Counterpart of ``celebbasis_tpu/utils/config.py``: plain-YAML loading with
left-to-right deep merge and ``key=value`` dot-list overrides, and a
validated ``RunSpec`` that checks the cross-field invariants the reference
leaves to comments.  ``yaml`` is imported inside the loading functions, so
that a caller without it can still take the typed defaults:
``RunSpec.sd_v1()`` is pinned (by a test) equal to what
``configs/aigc_id.yaml`` loads to.

The trainer section is a ``train.trainer.TrainerConfig`` and the dataset
sections are ``data.face_id.FaceIdDatasetConfig``s.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

from celebbasis_tpu_torch.core.basis import BasisConfig
from celebbasis_tpu_torch.data.face_id import FaceIdDatasetConfig
from celebbasis_tpu_torch.models.clip_text import CLIPTextConfig
from celebbasis_tpu_torch.models.unet import UNetConfig
from celebbasis_tpu_torch.models.vae import VAEConfig
from celebbasis_tpu_torch.text.tokenizer import \
    PLACEHOLDER_WORDS as PLACEHOLDER_STRINGS
from celebbasis_tpu_torch.train.trainer import TrainerConfig


def deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def parse_dotlist(items: Sequence[str]) -> Dict:
    """['a.b=1', 'c=[1,2]'] -> nested dict with YAML-parsed values."""
    import yaml
    out: Dict[str, Any] = {}
    for item in items:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, val = item.split("=", 1)
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(val)
    return out


def load_yaml_configs(paths: Sequence[str],
                      overrides: Sequence[str] = ()) -> Dict:
    import yaml
    cfg: Dict = {}
    for p in paths:
        with open(p) as f:
            cfg = deep_merge(cfg, yaml.safe_load(f) or {})
    return deep_merge(cfg, parse_dotlist(overrides)) if overrides else cfg


def get(cfg: Dict, path: str, default=None):
    node: Any = cfg
    for p in path.split("."):
        if not isinstance(node, dict) or p not in node:
            return default
        node = node[p]
    return node


@dataclass
class RunSpec:
    """Everything a run needs, extracted from a (reference-style) YAML."""
    unet: UNetConfig
    vae: VAEConfig
    clip: CLIPTextConfig
    basis: BasisConfig
    celeb_txt: str
    placeholder_strings: tuple
    initializer_words: tuple
    max_ids: int
    num_embeds_per_token: int
    meta_mlp_depth: int
    meta_inner_dim: int
    meta_heads: int
    momentum: float
    test_mode: str
    save_fp16: bool
    loss_type: str
    use_rm_mlp: bool
    scale_factor: float
    timesteps: int
    linear_start: float
    linear_end: float
    unfreeze_model: bool
    model_lr: float
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    train_data: Optional[FaceIdDatasetConfig] = None
    val_data: Optional[FaceIdDatasetConfig] = None
    raw: Dict = field(repr=False, compare=False, default_factory=dict)

    @staticmethod
    def sd_v1() -> "RunSpec":
        """The typed default: what ``configs/aigc_id.yaml`` loads to."""
        return RunSpec(
            unet=UNetConfig.sd_v1(), vae=VAEConfig.sd_v1(),
            clip=CLIPTextConfig.sd_v1(), basis=BasisConfig(),
            celeb_txt="./infer_images/wiki_names_v2.txt",
            placeholder_strings=PLACEHOLDER_STRINGS,
            initializer_words=("face",) * 10, max_ids=10,
            num_embeds_per_token=2, meta_mlp_depth=1, meta_inner_dim=512,
            meta_heads=1, momentum=0.99, test_mode="coefficient",
            save_fp16=False, loss_type="none", use_rm_mlp=False,
            scale_factor=0.18215, timesteps=1000, linear_start=0.00085,
            linear_end=0.0120, unfreeze_model=False, model_lr=0.0,
            trainer=TrainerConfig(max_steps=800, ckpt_every=200,
                                  batch_size=2, base_lr=5.0e-3,
                                  loss_type="none", tensorboard=False),
            train_data=FaceIdDatasetConfig(
                pickle_path="./data/ffhq.pickle", image_size=512, num_ids=2,
                specific_ids=[1, 2], images_per_id=1, repeats=1000,
                split="train", diff_cnt=0, reg_ids=0, reg_repeats=0),
            val_data=None).validate()

    def validate(self) -> "RunSpec":
        if self.basis.n_components != self.meta_inner_dim:
            raise ValueError(
                f"n_components ({self.basis.n_components}) must equal "
                f"meta_inner_dim ({self.meta_inner_dim})")
        if self.basis.num_embeds_per_token != self.num_embeds_per_token:
            raise ValueError(
                "cond_stage num_embeds_per_token must match "
                "personalization num_embeds_per_token")
        if self.basis.n_components > self.basis.n_samples - 1:
            # the reference ships such a config (n_samples only matters in
            # sample-reduce basis builds): warn, do not refuse
            warnings.warn(
                f"n_components ({self.basis.n_components}) > n_samples-1 "
                f"({self.basis.n_samples - 1}): fine when loading a saved "
                "basis; a sample-reduce build would fail")
        if self.test_mode not in ("coefficient", "embedding", "image"):
            raise ValueError(f"unknown test_mode {self.test_mode!r}")
        if len(self.initializer_words) not in (0, self.max_ids):
            raise ValueError("initializer_words must be empty or max_ids long")
        return self


def _dataset_cfg(node: Optional[Dict]) -> Optional[FaceIdDatasetConfig]:
    if not node:
        return None
    p = node.get("params", {})
    return FaceIdDatasetConfig(
        pickle_path=p.get("pickle_path", ""),
        image_size=p.get("image_size", 512),
        num_ids=p.get("num_ids", 10),
        specific_ids=p.get("specific_ids"),
        images_per_id=p.get("images_per_id", 1),
        repeats=p.get("repeats", 100),
        split=p.get("split", "train"),
        diff_cnt=p.get("diff_cnt", 0),
        reg_ids=p.get("reg_ids", 0),
        reg_repeats=p.get("reg_repeats", 0),
    )


def run_spec_from_config(cfg: Dict) -> RunSpec:
    """Build a validated RunSpec from a reference-format config dict (the
    aigc_id.yaml schema)."""
    mp = get(cfg, "model.params", {}) or {}
    up = get(cfg, "model.params.unet_config.params", {}) or {}
    fp = get(cfg, "model.params.first_stage_config.params", {}) or {}
    dd = fp.get("ddconfig", {})
    cp = get(cfg, "model.params.cond_stage_config.params", {}) or {}
    pp = get(cfg, "model.params.personalization_config.params", {}) or {}

    unet = UNetConfig(
        in_channels=up.get("in_channels", 4),
        out_channels=up.get("out_channels", 4),
        model_channels=up.get("model_channels", 320),
        num_res_blocks=up.get("num_res_blocks", 2),
        attention_resolutions=tuple(up.get("attention_resolutions", (4, 2, 1))),
        channel_mult=tuple(up.get("channel_mult", (1, 2, 4, 4))),
        num_heads=up.get("num_heads", 8),
        transformer_depth=up.get("transformer_depth", 1),
        context_dim=up.get("context_dim", 768),
        remat=up.get("use_checkpoint", False),
    )
    vae = VAEConfig(
        ch=dd.get("ch", 128),
        ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        num_res_blocks=dd.get("num_res_blocks", 2),
        z_channels=dd.get("z_channels", 4),
        embed_dim=fp.get("embed_dim", 4),
        scale_factor=mp.get("scale_factor", 0.18215),
    )
    basis = BasisConfig(
        n_components=cp.get("n_components", 512),
        num_embeds_per_token=cp.get("num_embeds_per_token", 2),
        rm_repeats=cp.get("rm_repeats", True),
        use_svd=cp.get("use_svd", True),
        use_flatten=cp.get("use_flatten", False),
        use_sample_reduce=cp.get("use_sample_reduce", False),
        n_samples=cp.get("n_samples", 513),
    )
    cl = cp.get("clip", {}) or {}
    clip = CLIPTextConfig(
        vocab_size=cl.get("vocab_size", 49408),
        width=cl.get("width", 768),
        layers=cl.get("layers", 12),
        heads=cl.get("heads", 12),
        mlp_dim=cl.get("mlp_dim", 3072),
    )
    trainer = TrainerConfig(
        max_steps=get(cfg, "lightning.trainer.max_steps", 800),
        ckpt_every=get(cfg, "lightning.modelcheckpoint.params."
                            "every_n_train_steps", 200),
        batch_size=get(cfg, "data.params.batch_size", 2),
        base_lr=mp.get("base_learning_rate", 5.0e-3),
        # the loss_type knob lives under personalization_config in the
        # reference YAMLs; it also selects the train step's auxiliary loss
        loss_type=pp.get("loss_type", "none"),
        tensorboard=get(cfg, "lightning.tensorboard", False),
        log_every=get(cfg, "lightning.trainer.log_every_n_steps", 10),
    )
    spec = RunSpec(
        unet=unet, vae=vae, clip=clip, basis=basis,
        celeb_txt=cp.get("celeb_txt", "./infer_images/wiki_names_v2.txt"),
        placeholder_strings=tuple(pp.get("placeholder_strings",
                                         PLACEHOLDER_STRINGS)),
        initializer_words=tuple(pp.get("initializer_words", ())),
        max_ids=pp.get("max_ids", pp.get(
            "num_ids", len(pp.get("placeholder_strings", (0,) * 10)))),
        num_embeds_per_token=pp.get("num_embeds_per_token", 2),
        meta_mlp_depth=pp.get("meta_mlp_depth", 1),
        meta_inner_dim=pp.get("meta_inner_dim", 512),
        meta_heads=pp.get("meta_heads", 1),
        momentum=pp.get("momentum", 0.99),
        test_mode=pp.get("test_mode", "coefficient"),
        save_fp16=pp.get("save_fp16", False),
        loss_type=pp.get("loss_type", "none"),
        use_rm_mlp=pp.get("use_rm_mlp", False),
        scale_factor=mp.get("scale_factor", 0.18215),
        timesteps=mp.get("timesteps", 1000),
        linear_start=mp.get("linear_start", 0.00085),
        linear_end=mp.get("linear_end", 0.0120),
        unfreeze_model=mp.get("unfreeze_model", False),
        model_lr=mp.get("model_lr", 0.0),
        trainer=trainer,
        train_data=_dataset_cfg(get(cfg, "data.params.train")),
        val_data=_dataset_cfg(get(cfg, "data.params.validation")),
        raw=cfg,
    )
    return spec.validate()


def load_run_spec(paths: Sequence[str], overrides: Sequence[str] = ()
                  ) -> RunSpec:
    if isinstance(paths, str):
        paths = [paths]
    return run_spec_from_config(load_yaml_configs(paths, overrides))
