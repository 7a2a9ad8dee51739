"""PyTorch port: what it imports, what it needs, and where it runs.

* importing every module of ``celebbasis_tpu_torch`` and ``chip_smoke`` pulls
  in neither ``jax``, ``flax``, ``optax``, ``triton``, ``cv2`` nor
  ``celebbasis_tpu``,
  and builds nothing (no CUDA kernel, no host C++ of the alignment path);
* an entry point without a card and without ``device="cpu"`` raises;
* the serving path's optional modules have stand-ins that agree with them
  (stdlib token split vs ``regex``; typed defaults vs ``configs/aigc_id.yaml``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, os, pkgutil, sys
import celebbasis_tpu_torch
build_dir = os.path.join(os.path.dirname(celebbasis_tpu_torch.__file__),
                         "_build")
ls = lambda: set(os.listdir(build_dir)) if os.path.isdir(build_dir) else set()
before = ls()
names = ["celebbasis_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(celebbasis_tpu_torch.__path__,
                                          "celebbasis_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "triton", "celebbasis_tpu", "cv2"))
print("MODULES", len(names))
print("TRAIN_RUN", sorted(n for n in names if n.endswith(
    (".face_id", ".tb", ".callbacks", "cli.train", ".pt_io"))))
print("TI_EVAL", sorted(n for n in names if n.endswith(
    (".textual_inversion", ".personalized", ".clip_vit", ".train_ti",
     ".merge", ".gen_imgs", ".eval_imgs", ".evaluate_model"))
    or ".eval." in n))
print("ALIGN", sorted(n for n in names if ".align" in n
                      or n.endswith((".bridge_align", "_pipnet",
                                     "_pipnet_gssl"))))
print("LEGACY", sorted(n for n in names if n.endswith(
    (".legacy", ".bert_text", ".bert_tokenizer", ".vq", ".cond_stages",
     ".xtransformer", ".bridge_xt", ".sample_diffusion", ".inpaint",
     ".evaluate_model"))))
print("KERNEL_MODULES", sorted(n for n in names if n.endswith(
    (".flash_attention", ".geglu", ".quant"))))
print("BAD", bad)
print("BUILT", sorted(ls() - before))
"""


def test_imports_pull_in_no_jax_and_build_nothing():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.strip().splitlines())
    assert int(lines["MODULES"]) >= 25
    assert lines["KERNEL_MODULES"] == str(sorted(
        f"celebbasis_tpu_torch.ops.{m}" for m in ("flash_attention", "geglu",
                                                  "quant")))
    assert lines["BAD"] == "[]"
    assert lines["BUILT"] == "[]"
    # the modules of the personalisation run are among those imported
    assert lines["TRAIN_RUN"] == str(sorted(
        f"celebbasis_tpu_torch.{m}" for m in (
            "data.face_id", "utils.tb", "train.callbacks", "cli.train",
            "utils.pt_io")))
    # and those of textual inversion and the evaluation
    assert lines["TI_EVAL"] == str(sorted(
        f"celebbasis_tpu_torch.{m}" for m in (
            "core.textual_inversion", "data.personalized", "models.clip_vit",
            "cli.train_ti", "cli.merge", "cli.gen_imgs", "cli.eval_imgs",
            "cli.evaluate_model", "eval.base", "eval.evaluators", "eval.fid",
            "eval.inception", "eval.prompt_templates", "eval.sphere",
            "eval.survey")))
    # and those of the legacy latent-diffusion family
    assert lines["LEGACY"] == str(sorted(
        f"celebbasis_tpu_torch.{m}" for m in (
            "legacy", "models.bert_text", "text.bert_tokenizer", "models.vq",
            "models.cond_stages", "models.xtransformer", "utils.bridge_xt",
            "cli.sample_diffusion", "cli.inpaint", "cli.evaluate_model")))
    # and those of W0 alignment
    assert lines["ALIGN"] == str(sorted(
        f"celebbasis_tpu_torch.{m}" for m in (
            "align", "align.alignment", "align.cv_resample",
            "align.faceboxes", "align.metrics", "align.native", "align.nms",
            "align.pipnet", "align.pipnet_gssl", "align.pipnet_train",
            "align.preprocess", "cli.align", "cli.preprocess_pipnet",
            "cli.train_pipnet", "cli.train_pipnet_gssl",
            "utils.bridge_align")))


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    from celebbasis_tpu_torch.cli.serve import (TxtToImgService,
                                                build_argparser)
    from celebbasis_tpu_torch.loader import assemble, resolve_device
    from celebbasis_tpu_torch.utils.config import load_run_spec

    spec = load_run_spec([os.path.join(REPO, "configs", "tiny.yaml")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        assemble(spec, image_size=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TxtToImgService(build_argparser().parse_args(
            ["--config", os.path.join(REPO, "configs", "tiny.yaml")]))
    from celebbasis_tpu_torch.cli import (align, eval_imgs, gen_imgs,
                                          inpaint, train_ti)
    cfg = os.path.join(REPO, "configs", "tiny.yaml")
    for cli, argv in (
            (inpaint, ["--indir", REPO, "--outdir", "unused", "--config",
                       os.path.join(REPO, "configs", "tiny_legacy.yaml")]),
            (align, ["--in_folder", "unused", "--out_folder", "unused"]),
            (train_ti, ["--base", cfg, "--data_root", "unused"]),
            (gen_imgs, ["--config", cfg, "--embedding_path", "e.pt",
                        "--from-file", "prompts_two.txt"]),
            (eval_imgs, ["--eval_folder", "unused", "--tiny"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    from celebbasis_tpu_torch.align.faceboxes import (FaceBoxesDetector,
                                                      FaceBoxesV2)
    from celebbasis_tpu_torch.align.pipnet import (PIPNet, PIPNetConfig,
                                                   PIPNetLandmarker)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FaceBoxesDetector(FaceBoxesV2().state_dict())
    cfg = PIPNetConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PIPNetLandmarker(PIPNet(cfg).state_dict(), cfg,
                         np.random.default_rng(0).uniform(size=(12, 2)))
    assert resolve_device("cpu").type == "cpu"
    asm = assemble(spec, image_size=32, device="cpu", dtype=torch.float32)
    assert asm.meta_net.cfg.inner_dim == spec.meta_inner_dim
    assert not any(p.requires_grad for p in asm.meta_net.parameters())
    assert asm.device.type == "cpu"
    assert next(asm.pipeline.parameters()).device.type == "cpu"


def test_kernel_wrapper_refuses_a_cuda_tensor_it_cannot_serve():
    """No card here: there is no CUDA tensor to hand over, but the build
    module must raise (not fall back) when asked to build without nvcc."""
    import shutil

    from celebbasis_tpu_torch.ops import cuda_build
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this check is for machines without nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()
    for source in ("flash_attention_fwd", "flash_attention_bwd", "geglu",
                   "int8_matmul"):
        assert os.path.isfile(os.path.join(cuda_build.CSRC_DIR,
                                           source + ".cu"))


def test_stdlib_token_split_equals_regex():
    regex = pytest.importorskip("regex")
    from celebbasis_tpu_torch.text import tokenizer as tk
    samples = [
        "a photo of sks person's face, don't we'll i'm you've he'd 'twas",
        "2½ ² Ⅳ 123 １２３ x² m³",
        "<|startoftext|> héllo wörld 你好 мир <|endoftext|>",
        "_x_ !!! a&b * ` ~~ --- ...", "İstanbul ǆ ǅ ß", "tab\tnew\nline  x",
        "emoji 😀 ok", "",
    ]
    assert tk._TOKEN_PAT is not None
    for s in samples:
        text = tk._whitespace_clean(tk._basic_clean(s)).lower()
        assert tk._find_tokens_stdlib(text) == tk._TOKEN_PAT.findall(text), s


def test_tokenizer_equals_the_jax_package_copy():
    from celebbasis_tpu.text.tokenizer import CLIPTokenizer as J
    from celebbasis_tpu_torch.text.tokenizer import (CLIPTokenizer,
                                                     token_for_string)
    import numpy as np
    a, b = J.synthetic(), CLIPTokenizer.synthetic()
    prompts = ["a photo of a sks person", "Anne Hathaway & ks, smiling!", ""]
    np.testing.assert_array_equal(a(prompts), b(prompts))
    assert b.vocab_size == 49408 and token_for_string(b, "sks") == \
        a.tokenize("sks")[0]
    with pytest.raises(ValueError):
        token_for_string(b, "two words")


def test_typed_defaults_equal_the_yaml():
    pytest.importorskip("yaml")
    from celebbasis_tpu.utils.config import load_run_spec as j_load
    from celebbasis_tpu_torch.pipeline import PipelineConfig
    from celebbasis_tpu_torch.loader import pipeline_config_from_spec
    from celebbasis_tpu_torch.utils.config import RunSpec, load_run_spec
    import dataclasses

    path = os.path.join(REPO, "configs", "aigc_id.yaml")
    loaded = load_run_spec([path])
    assert loaded == RunSpec.sd_v1()
    assert pipeline_config_from_spec(loaded) == PipelineConfig.sd_v1()
    # and the JAX package reads the same file to the same numbers
    theirs = j_load([path])
    for name in ("unet", "vae", "clip", "basis", "train_data"):
        ours = dataclasses.asdict(getattr(loaded, name))
        ref = dataclasses.asdict(getattr(theirs, name))
        assert ours == ref, name
    for name in ("celeb_txt", "placeholder_strings", "initializer_words",
                 "max_ids", "num_embeds_per_token", "meta_inner_dim",
                 "momentum", "test_mode", "scale_factor", "timesteps",
                 "linear_start", "linear_end"):
        assert getattr(loaded, name) == getattr(theirs, name), name


def test_cast_float_params():
    from celebbasis_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                       CLIPTextEncoder)
    from celebbasis_tpu_torch.utils.precision import cast_float_params
    m = CLIPTextEncoder(CLIPTextConfig.tiny(), torch.bfloat16)
    cast_float_params(m, torch.bfloat16)
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    with torch.no_grad():
        out = m(torch.zeros(1, 77, dtype=torch.long))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
