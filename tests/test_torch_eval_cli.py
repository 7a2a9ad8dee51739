"""PyTorch port, W4 evaluation end to end on the CPU at tiny size:
``cli/gen_imgs.py`` (two items of one sample, two DDIM steps), then
``cli/eval_imgs.py --tiny --fid`` (CLIP-FID) and with ``--inception_ckpt``
(Inception-v3 pool3 from a file of ``manifests/fid_inception.json``'s keys).

* the folder is the JAX package's contract (``prompts.txt``,
  ``in_image_paths.txt``, ``in_image_ids.txt`` and
  ``imgs/{i:05d}_id{id:05d}_{prompt}/{cnt:05d}.jpg``), read back equally by
  both packages' ``GeneratedEvalFolder``; a second run adds nothing;
* ``scores.json`` holds the JAX key set, and ``IDCLIPScoreCalculator`` on
  that folder gives the JAX scores to 1e-4 (absolute, the scores are
  cosines and distances of unit vectors) with one set of tiny weights;
* the legacy family's training (``LegacyLDM.make_train_step``) is ported
  (its parity: ``test_torch_legacy_train``) and returns a step; the
  loader's per-host shard needs a mesh or a process group
  (``test_torch_mesh`` runs it), and raises without;
  ``cli/evaluate_model.py`` is ported and asks for its ``--data-dir`` (``test_torch_legacy_eval_cli``; the alignment cropper:
  ``test_torch_align_cli``); the plain-Python copies (templates, grid,
  survey) equal JAX's.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from celebbasis_tpu.eval import base as jbase
from celebbasis_tpu.eval import evaluators as jev
from celebbasis_tpu.eval import prompt_templates as jtemplates
from celebbasis_tpu.eval import sphere as jsphere
from celebbasis_tpu.eval import survey as jsurvey
from celebbasis_tpu.models import clip_text as jclip_text
from celebbasis_tpu.models import clip_vit as jvit
from celebbasis_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from celebbasis_tpu_torch.cli import eval_imgs, evaluate_model, gen_imgs
from celebbasis_tpu_torch.core import manager as mgr
from celebbasis_tpu_torch.eval import base as tbase
from celebbasis_tpu_torch.eval import evaluators as tev
from celebbasis_tpu_torch.eval import prompt_templates as ttemplates
from celebbasis_tpu_torch.eval import survey as tsurvey
from celebbasis_tpu_torch.eval.sphere import SphereConfig
from celebbasis_tpu_torch.loader import assemble
from celebbasis_tpu_torch.models import clip_vit as tvit
from celebbasis_tpu_torch.models.clip_text import CLIPTextConfig
from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer
from celebbasis_tpu_torch.utils import bridge
from celebbasis_tpu_torch.utils.config import load_run_spec

from _torch_port_helpers import np_tree, random_params
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "tiny.yaml")
SIZE = 32
JAX_KEYS = {"image_sim", "text_sim", "id_cos_sim", "id_mse_dist",
            "id_l2_dist", "num_has_face", "num_no_face", "n_items",
            "n_id_items"}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """gen_imgs' folder: ids 0 and 1, one two-person prompt, one sample."""
    root = tmp_path_factory.mktemp("eval_cli")
    asm = assemble(load_run_spec([CFG]), image_size=SIZE, device="cpu",
                   dtype=torch.float32, cache_dir=None)
    state = asm.manager_state._replace(id_coefficients=torch.randn(
        asm.manager_state.id_coefficients.shape,
        generator=torch.Generator().manual_seed(0)))
    emb = str(root / "embeddings_gs-1.pt")
    mgr.save_checkpoint(asm.pipeline.manager_cfg, state, emb)
    src = root / "src"
    src.mkdir()
    r = np.random.default_rng(0)
    for j in (0, 1):
        Image.fromarray(r.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)
                        ).save(src / f"face_id{j}_#0.png")
    prompts = root / "eval_two.txt"
    prompts.write_text("a photo of sks person and ks person\n")
    argv = ["--config", CFG, "--embedding_path", emb, "--from-file",
            str(prompts), "--outdir", str(root / "gen"), "--ids", "0", "1",
            "--src_folder", str(src), "--n_samples", "1", "--ddim_steps",
            "2", "--H", str(SIZE), "--precision", "fp32", "--device", "cpu"]
    assert gen_imgs.main(argv) == 2
    assert gen_imgs.main(argv) == 0           # resumable: nothing to add
    return str(root / "gen"), str(src)


def test_gen_imgs_folder_contract(folder):
    gen, src = folder
    with open(os.path.join(gen, "prompts.txt")) as f:
        assert f.read().splitlines() == \
            ["a photo of sks person and ks person"] * 2
    with open(os.path.join(gen, "in_image_ids.txt")) as f:
        assert f.read().splitlines() == ["[0, 1]", "[1, 0]"]
    ours, ref = tev.GeneratedEvalFolder(gen), jev.GeneratedEvalFolder(gen)
    assert ours.src_img_paths == ref.src_img_paths
    assert ours.src_img_paths[0] == [os.path.join(src, "face_id0_#0.png"),
                                     os.path.join(src, "face_id1_#0.png")]
    assert ours.src_ids == ref.src_ids == [["0", "1"], ["1", "0"]]
    assert ours.gen_img_folders == ref.gen_img_folders
    for i in range(len(ref)):
        (p1, s1, g1), (p2, s2, g2) = ours[i], ref[i]
        assert p1 == p2 and g1.shape == (1, SIZE, SIZE, 3)
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(g1, g2)
        assert os.listdir(ours.gen_img_folders[i]) == ["00000.jpg"]


def test_eval_imgs_scores_json(folder, tmp_path):
    gen, _ = folder
    scores = eval_imgs.main(["--eval_folder", gen, "--tiny", "--fid",
                             "--img_size", str(SIZE), "--device", "cpu"])
    with open(os.path.join(gen, "scores.json")) as f:
        assert json.load(f) == scores
    assert set(scores) == JAX_KEYS | {"clip_fid"}
    assert scores["n_items"] == 2 and scores["num_has_face"] == 4
    assert all(np.isfinite(v) for v in scores.values())
    for k in ("image_sim", "text_sim", "id_cos_sim"):
        assert -1.0 <= scores[k] <= 1.0

    # Inception-FID from a file in pytorch-fid's layout
    with open(os.path.join(REPO, "manifests", "fid_inception.json")) as f:
        keys = json.load(f)["keys"]
    g = torch.Generator().manual_seed(1)
    state = {k: (torch.tensor(0) if k.endswith("num_batches_tracked") else
                 torch.rand(s, generator=g) + 0.5 if k.endswith("var") else
                 torch.randn(s, generator=g) * (np.prod(s[1:]) ** -0.5
                                                 if len(s) > 1 else 0.1))
             for k, s in keys.items()}
    torch.save(state, tmp_path / "pt_inception.pth")
    out = str(tmp_path / "scores.json")
    with_inception = eval_imgs.main([
        "--eval_folder", gen, "--tiny", "--fid", "--img_size", str(SIZE),
        "--inception_ckpt", str(tmp_path / "pt_inception.pth"), "--out",
        out, "--device", "cpu"])
    assert set(with_inception) == JAX_KEYS | {"fid"}
    assert np.isfinite(with_inception["fid"])


def test_score_calculator_matches_jax(folder):
    gen, _ = folder
    vcfg, tcfg = tvit.CLIPVisionConfig.tiny(), CLIPTextConfig.tiny()
    jv, jt = jvit.CLIPVisionConfig.tiny(), jclip_text.CLIPTextConfig.tiny()
    vp = random_params(jvit.CLIPVisionEncoder(jv).init, jax.random.key(0),
                       jnp.zeros((1, 32, 32, 3)), seed=1)
    tp = random_params(jvit.CLIPTextTower(jt, proj_dim=jv.proj_dim).init,
                       jax.random.key(0), jnp.zeros((1, 77), jnp.int32),
                       seed=2)
    sp = random_params(jsphere.SphereNet(jsphere.SphereConfig.tiny()).init,
                       jax.random.key(0), jnp.zeros((1, 32, 32, 3)), seed=3)
    jcalc = jev.IDCLIPScoreCalculator(gen, jev.IdCLIPEvaluator(
        jev.CLIPEvaluator(vp, tp, JTokenizer.synthetic(1024), jv, jt),
        jev.IdentityEvaluator(sp, cfg=jsphere.SphereConfig.tiny(),
                              img_size=SIZE, face_size=32)), verbose=False)
    conv = lambda p: bridge.from_jax_params(np_tree(p))
    tcalc = tev.IDCLIPScoreCalculator(gen, tev.IdCLIPEvaluator(
        tev.CLIPEvaluator(conv(vp), conv(tp), CLIPTokenizer.synthetic(1024),
                          vcfg, tcfg, device="cpu"),
        tev.IdentityEvaluator(conv(sp), cfg=SphereConfig.tiny(),
                              img_size=SIZE, face_size=32, device="cpu")),
        verbose=False)
    ref, got = jcalc.start_calc(), tcalc.start_calc()
    assert set(got) == set(ref) == JAX_KEYS
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, err_msg=k)
    assert abs(ref["image_sim"]) > 1e-3


def test_what_is_not_ported_raises(folder):
    # the legacy family is ported, training (tests/test_torch_legacy_train)
    # and sampling (tests/test_torch_legacy_*); the loader's per-host shard
    # is too, and needs a mesh or a process group (tests/test_torch_mesh)
    import yaml

    from celebbasis_tpu_torch import legacy
    from celebbasis_tpu_torch.data.face_id import PrefetchLoader
    with open(os.path.join(REPO, "configs", "tiny_legacy.yaml")) as f:
        ldm = legacy.build_legacy_ldm(yaml.safe_load(f), torch.float32)
    assert callable(ldm.make_train_step(None))
    with pytest.raises(ValueError, match="process group"):
        PrefetchLoader.for_host(None, None, 2)
    with pytest.raises(SystemExit):          # it needs --data-dir
        evaluate_model.main([])
    # the cropper is ported: building it does not raise
    assert callable(tev.face_cropper_from_nets(None, None))


def test_plain_python_copies_equal_jax(tmp_path):
    for name in ("pot_single.txt", "style.txt", "tmp.txt", "celeb_two.txt"):
        assert ttemplates.get_pos_neg_temps(name) == \
            jtemplates.get_pos_neg_temps(name)
    with pytest.raises(ValueError):
        ttemplates.get_pos_neg_temps("unknown.txt")
    prompts = ["a photo of sks person", "sks person and ks person"]
    ours = list(tbase.EvalGrid(prompts, [0, 1, 2], str(tmp_path)))
    ref = list(jbase.EvalGrid(prompts, [0, 1, 2], str(tmp_path)))
    assert [vars(i) for i in ours] == [vars(i) for i in ref]
    assert tbase.parse_image_name(tbase.image_name(3, 7, 2)) == (3, 7, 2)
    csv = tmp_path / "survey.csv"
    csv.write_text("time,q1,q2\nt0,ours,ref\nt1,ours,ours\nt2,ref,\n")
    rows = tsurvey.read_survey_csv(str(csv))
    assert rows == jsurvey.read_survey_csv(str(csv))
    assert tsurvey.preference_counts(rows) == \
        jsurvey.preference_counts(rows)
    assert tsurvey.preference_rates(rows) == jsurvey.preference_rates(rows)
