"""Dynamic ``target:`` instantiation + reference-class registry.

Counterpart of ``celebbasis_tpu/utils/registry.py``: the reference's
``ldm/util.py`` ``instantiate_from_config`` / ``get_obj_from_str``, with a
translation table so that configs written for the reference -- whose
``target`` strings name its classes, like
``ldm.data.face_id.FaceIdDatasetOneShot`` -- instantiate the port's
counterparts without edits.  The table has the JAX module's keys; each
resolves to the port's class (``celebbasis_tpu_torch.*``).
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict


def _dataset(cls_defaults: Dict[str, Any] = {}):
    def make(**params):
        from celebbasis_tpu_torch.data.face_id import (FaceIdDataset,
                                                 FaceIdDatasetConfig)
        import dataclasses
        merged = {**cls_defaults, **params}
        known = {f.name for f in dataclasses.fields(FaceIdDatasetConfig)}
        cfg = FaceIdDatasetConfig(**{k: v for k, v in merged.items()
                                     if k in known})
        return FaceIdDataset(cfg)
    return make


def _personalized(style: bool):
    def make(**params):
        from celebbasis_tpu_torch.data.personalized import (PersonalizedBase,
                                                      PersonalizedConfig)
        import dataclasses
        known = {f.name for f in dataclasses.fields(PersonalizedConfig)}
        params = dict(params)
        params.setdefault("style", style)
        if "placeholder_token" in params:
            params["placeholder"] = params.pop("placeholder_token")
        cfg = PersonalizedConfig(**{k: v for k, v in params.items()
                                    if k in known})
        return PersonalizedBase(cfg)
    return make


def _legacy_data(name: str):
    def make(**params):
        import celebbasis_tpu_torch.data.legacy as mod
        return getattr(mod, name)(**params)
    return make


def _lr(name: str):
    def make(**params):
        import celebbasis_tpu_torch.train.lr_schedule as mod
        params.pop("verbosity_interval", None)
        return getattr(mod, name)(1.0, **params)   # reference: base_lr 1.0
    return make


def _ae_loss(name: str):
    def make(**params):
        import celebbasis_tpu_torch.train.ae_loss as mod
        ploss = params.pop("perceptual_loss", "lpips")
        assert ploss == "lpips", f"unsupported perceptual_loss {ploss!r}"
        return getattr(mod, name)(mod.DiscLossConfig(**params))
    return make


# reference target -> factory accepting the reference's params
REFERENCE_TARGETS: Dict[str, Callable] = {
    "ldm.data.face_id.FaceIdDatasetOneShot": _dataset(),
    "ldm.data.face_id.FaceIdDatasetStyleGAN3": _dataset(),
    "ldm.data.face_id.FaceIdDatasetE4T": _dataset(),
    "ldm.data.face_id.FaceIdDatasetNobody": _dataset(),
    "ldm.data.face_id.FaceIdDatasetVGG": _dataset(),
    "ldm.data.personalized.PersonalizedBase": _personalized(False),
    "ldm.data.personalized_style.PersonalizedBase": _personalized(True),
    "torch.nn.Identity": lambda **_: (lambda x: x),
    # legacy-LDM datasets (ldm/data/lsun.py, imagenet.py; taming faceshq)
    **{f"ldm.data.lsun.LSUN{name}": _legacy_data(f"LSUN{name}")
       for name in ("ChurchesTrain", "ChurchesValidation", "BedroomsTrain",
                    "BedroomsValidation", "CatsTrain", "CatsValidation")},
    **{f"ldm.data.imagenet.{name}": _legacy_data(name)
       for name in ("ImageNetTrain", "ImageNetValidation", "ImageNetSRTrain",
                    "ImageNetSRValidation")},
    **{f"taming.data.faceshq.{name}": _legacy_data(name)
       for name in ("FFHQTrain", "FFHQValidation", "CelebAHQTrain",
                    "CelebAHQValidation")},
    # LR schedulers (ldm/lr_scheduler.py)
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler": _lr("warmup_cosine"),
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler2":
        _lr("warmup_cosine_cycles"),
    "ldm.lr_scheduler.LambdaLinearScheduler": _lr("lambda_linear"),
    # first-stage training losses (ldm/modules/losses)
    "ldm.modules.losses.LPIPSWithDiscriminator":
        _ae_loss("LPIPSWithDiscriminator"),
    "ldm.modules.losses.contperceptual.LPIPSWithDiscriminator":
        _ae_loss("LPIPSWithDiscriminator"),
    "ldm.modules.losses.vqperceptual.VQLPIPSWithDiscriminator":
        _ae_loss("VQLPIPSWithDiscriminator"),
    "taming.modules.losses.vqperceptual.VQLPIPSWithDiscriminator":
        _ae_loss("VQLPIPSWithDiscriminator"),
    # inference-only zoo configs carry a placeholder loss (contperceptual.py)
    "ldm.modules.losses.contperceptual.DummyLoss": lambda **_: None,
    # spatial cond stage for the concat-mode semantic-synthesis configs
    "ldm.modules.encoders.modules.SpatialRescaler": (
        lambda **p: __import__(
            "celebbasis_tpu_torch.models.cond_stages",
            fromlist=["SpatialRescaler"]).SpatialRescaler(
                n_stages=p.get("n_stages", 1),
                method=p.get("method", "bilinear"),
                multiplier=p.get("multiplier", 0.5),
                in_channels=p.get("in_channels", 3),
                out_channels=p.get("out_channels"),
                bias=p.get("bias", False))),
}


def get_obj_from_str(string: str, reload: bool = False):
    module, cls = string.rsplit(".", 1)
    mod = importlib.import_module(module)
    if reload:
        importlib.reload(mod)
    return getattr(mod, cls)


def instantiate_from_config(config: Dict) -> Any:
    """{'target': 'pkg.Class', 'params': {...}} -> instance.

    Reference targets are redirected to the port's counterparts; unknown
    ``ldm.*``/``torch.*`` targets raise with the list of known ones instead
    of importing the reference's code.
    """
    if "target" not in config:
        if config in ("__is_first_stage__", "__is_unconditional__"):
            return None
        raise KeyError("Expected key `target` to instantiate.")
    target = config["target"]
    params = config.get("params", {}) or {}
    if target in REFERENCE_TARGETS:
        return REFERENCE_TARGETS[target](**params)
    if target.startswith(("ldm.", "torch.", "main.")):
        raise ValueError(
            f"reference target {target!r} has no registered counterpart "
            f"in the port; "
            f"supported: {sorted(REFERENCE_TARGETS)}")
    return get_obj_from_str(target)(**params)
