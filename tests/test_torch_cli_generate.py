"""PyTorch port, the generation CLIs (``cli/{txt2img,img2img,extract,
build_basis}``), ``--plms`` on the daemon, and ``utils/pt_io``.

The CLIs run in process through ``main(argv)`` with ``--device cpu`` on the
tiny config; each case checks the files written and that the images equal
what the port's functions give for the same seed on an assembly made the
same way (image i of a run draws from ``sample_seed(--seed, i)``).  Without
``--device`` and without a card every CLI raises.  ``pt_io``: the JAX
package's ``load_pt`` reads what the port writes, and the port reads what the
JAX package's ``save_pt`` writes (float32, float16 and int64 leaves in
nested dicts and lists), both exactly.
"""
import os

import numpy as np
import pytest
import torch

from celebbasis_tpu.utils import pt_io as jpt_io
from celebbasis_tpu_torch.cli import build_basis, extract, img2img, txt2img
from celebbasis_tpu_torch.diffusion.sampler import sample_seed
from celebbasis_tpu_torch.loader import assemble
from celebbasis_tpu_torch.utils import pt_io
from celebbasis_tpu_torch.utils.config import load_run_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "tiny.yaml")
SIZE, SEED = 32, 42


@pytest.fixture(scope="module")
def asm():
    """The assembly every CLI run below makes for itself (same config, size
    and seed; fp32 storage)."""
    return assemble(load_run_spec([CFG]), image_size=SIZE, seed=SEED,
                    device="cpu")


@pytest.fixture(scope="module")
def pictures(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("pictures")
    r = np.random.default_rng(0)
    paths = {}
    for name, shape in (("face0", (40, 40, 3)), ("face1", (48, 48, 3)),
                        ("init", (70, 64, 3))):
        paths[name] = str(root / f"{name}.png")
        Image.fromarray(r.integers(0, 256, shape).astype(np.uint8)).save(
            paths[name])
    mask = np.zeros((64, 64), np.uint8)
    mask[:, 32:] = 255
    paths["mask"] = str(root / "mask.png")
    Image.fromarray(mask).save(paths["mask"])
    return paths


def _gens(n, start=0):
    return [torch.Generator().manual_seed(sample_seed(SEED, start + j))
            for j in range(n)]


def _requests(asm, prompts, ids_row, n_active):
    L = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    B = len(prompts)
    return (L(asm.tokenizer(prompts)), L(asm.tokenizer([""] * B)),
            L(np.tile(ids_row, (B, 1))), L([n_active] * B))


def _common(tmp_path):
    return ["--config", CFG, "--device", "cpu", "--precision", "fp32",
            "--outdir", str(tmp_path)]


def test_txt2img_cli_plms_from_file(asm, tmp_path):
    prompts = ["a photo of a sks person", "a ks person in the snow"]
    (tmp_path / "prompts.txt").write_text("\n".join(prompts) + "\n\n")
    imgs = txt2img.main(_common(tmp_path) + [
        "--H", "32", "--W", "32", "--ddim_steps", "5", "--plms",
        "--n_samples", "2", "--from-file", str(tmp_path / "prompts.txt"),
        "--ids", "1", "2"])
    assert imgs.shape == (4, SIZE, SIZE, 3) and imgs.dtype == np.uint8
    dirs = sorted(d for d in os.listdir(tmp_path) if d != "prompts.txt")
    assert dirs == ["000_a-photo-of-a-sks-person",
                    "001_a-ks-person-in-the-snow"]
    assert sorted(os.listdir(tmp_path / dirs[1])) == [
        "00002.jpg", "00003.jpg", "grid.jpg"]
    fn = asm.pipeline.make_txt2img_fn(num_steps=5, image_size=SIZE,
                                      sampler="plms", output="uint8")
    k = len(asm.pipeline.manager_cfg.placeholder_token_ids)
    for pi, prompt in enumerate(prompts):
        want = fn(asm.manager_state, asm.basis,
                  *_requests(asm, [prompt] * 2, [1, 2] + [0] * (k - 2), 2),
                  _gens(2, 2 * pi)).numpy()
        np.testing.assert_array_equal(imgs[2 * pi:2 * pi + 2], want)
    assert np.abs(imgs[0].astype(int) - imgs[2].astype(int)).max() > 0


def test_txt2img_cli_faces(asm, pictures, tmp_path):
    faces = [pictures["face0"], pictures["face1"]]
    imgs = txt2img.main(_common(tmp_path) + [
        "--H", "32", "--W", "32", "--ddim_steps", "2", "--n_samples", "2",
        "--no-grid", "--faces"] + faces)
    (folder,) = os.listdir(tmp_path)
    assert sorted(os.listdir(tmp_path / folder)) == ["00000.jpg",
                                                     "00001.jpg"]
    crops = torch.from_numpy(txt2img.load_face_crops(faces, SIZE))
    assert crops.shape == (2, SIZE, SIZE, 3) and crops.abs().max() <= 1
    fn = asm.pipeline.make_txt2img_faces_fn(asm.meta_net, num_steps=2,
                                            image_size=SIZE, output="uint8")
    tokens, uncond, ids, num_ids = _requests(
        asm, ["a photo of a sks person"] * 2, [0, 1], 2)
    want = fn(asm.basis, tokens, uncond, crops[None].expand(2, -1, -1, -1, -1),
              ids, num_ids, _gens(2)).numpy()
    np.testing.assert_array_equal(imgs, want)


def test_img2img_cli_with_mask(asm, pictures, tmp_path):
    imgs = img2img.main(_common(tmp_path) + [
        "--init-img", pictures["init"], "--mask", pictures["mask"],
        "--ddim_steps", "4", "--strength", "0.5", "--n_samples", "2"])
    # the init image is 64 wide: 64x64, 32x32 latents
    assert imgs.shape == (2, 64, 64, 3) and imgs.dtype == np.uint8
    assert sorted(os.listdir(tmp_path)) == ["00000.jpg", "00001.jpg"]
    big = assemble(load_run_spec([CFG]), image_size=64, seed=SEED,
                   device="cpu")
    from PIL import Image
    init = np.asarray(Image.open(pictures["init"]).convert("RGB").resize(
        (64, 64), Image.LANCZOS), np.float32) / 127.5 - 1.0
    m = np.asarray(Image.open(pictures["mask"]).convert("L").resize(
        (32, 32), Image.NEAREST)) > 127
    fn = img2img.make_img2img_fn(big.pipeline, 4, 0.5, 10.0, 64,
                                 output="uint8")
    k = len(big.pipeline.manager_cfg.placeholder_token_ids)
    tokens, uncond, ids, num_ids = _requests(
        big, ["a photo of a sks person"] * 2, [0] + [0] * (k - 1), 1)
    want = fn(big.manager_state, big.basis,
              torch.from_numpy(init)[None].expand(2, -1, -1, -1),
              torch.from_numpy(m.astype(np.float32))[None, :, :, None],
              tokens, uncond, ids, num_ids, _gens(2)).numpy()
    np.testing.assert_array_equal(imgs, want)


def test_extract_and_build_basis_write_reference_files(asm, tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)         # the basis cache goes there
    from celebbasis_tpu_torch.core import manager as mgr
    from celebbasis_tpu_torch.core.basis import (build_celeb_basis,
                                                 reconstruct)
    m_cfg = asm.pipeline.manager_cfg
    state = mgr.init_state(m_cfg, torch.Generator().manual_seed(7))
    ckpt = str(tmp_path / "embeddings_gs-5.pt")
    mgr.save_checkpoint(m_cfg, state, ckpt)
    out = tmp_path / "ti"
    extract.main(["--config", CFG, "--device", "cpu", "--embedding_path",
                  ckpt, "--outdir", str(out)])
    h = m_cfg.heads
    names = sorted(os.listdir(out))
    assert names == sorted(["celeb_basis.pt"] + [
        f"id_{kind}_{i}.pt" for kind in ("embedding", "coefficient")
        for i in range(m_cfg.max_ids)])
    basis = torch.load(out / "celeb_basis.pt", weights_only=True)
    assert basis.shape == (2, 9, 64) and basis.dtype == torch.float32
    np.testing.assert_array_equal(jpt_io.load_pt(str(out / "celeb_basis.pt")),
                                  basis.numpy())
    for i in (0, m_cfg.max_ids - 1):
        coeff = torch.load(out / f"id_coefficient_{i}.pt", weights_only=True)
        z = torch.load(out / f"id_embedding_{i}.pt", weights_only=True)
        assert coeff.shape == (2, h, 8) and z.shape == (2 * h, 64)
        torch.testing.assert_close(coeff, state.id_coefficients[i],
                                   rtol=0, atol=0)
        np.testing.assert_allclose(
            z.numpy(), reconstruct(coeff.numpy(), basis.numpy()), atol=1e-6)

    names_txt = tmp_path / "names.txt"
    celebs = ["Anne Hathaway", "Barack Obama", "Elon Musk", "Taylor Swift",
              "Emma Watson", "Brad Pitt", "Keanu Reeves", "Tom Hanks",
              "Will Smith", "Rihanna", "Oprah Winfrey", "Meryl Streep"]
    names_txt.write_text("\n".join(celebs) + "\n")
    target = tmp_path / "weights" / "celeb_basis.pt"
    build_basis.main(["--config", CFG, "--device", "cpu", "--celeb_txt",
                      str(names_txt), "--out", str(target)])
    built = torch.load(target, weights_only=True)
    # the tiny config's token table at extract's and build_basis' seed 0
    seed0 = assemble(load_run_spec([CFG]), device="cpu")
    want = build_celeb_basis(celebs, seed0.tokenizer,
                             seed0.pipeline.token_table(),
                             seed0.spec.basis)
    np.testing.assert_array_equal(built.numpy(), want)


def test_plms_daemon_matches_the_pipeline():
    from celebbasis_tpu_torch.cli.serve import TxtToImgService, build_argparser
    service = TxtToImgService(build_argparser().parse_args([
        "--config", CFG, "--H", "32", "--ddim_steps", "3", "--batch", "2",
        "--precision", "fp32", "--ids", "0", "--device", "cpu", "--plms"]))
    try:
        assert service.sampler == "plms"
        got = service.generate("a photo of a sks person", seed=3)
    finally:
        service.stop()
    asm = service.asm
    fn = asm.pipeline.make_txt2img_fn(num_steps=3, image_size=SIZE,
                                      sampler="plms", output="uint8")
    k = len(asm.pipeline.manager_cfg.placeholder_token_ids)
    L = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    tokens = L(asm.tokenizer(["a photo of a sks person", ""]))
    want = fn(asm.manager_state, asm.basis, tokens,
              L(asm.tokenizer(["", ""])), L([[0] * k, [0] * k]), L([1, 0]),
              [torch.Generator().manual_seed(sample_seed(3, 0)),
               torch.Generator().manual_seed(0)]).numpy()
    np.testing.assert_array_equal(got[0], want[0])


def test_clis_refuse_what_is_not_ported_and_need_a_device(pictures,
                                                          tmp_path):
    base = ["--config", CFG, "--device", "cpu", "--outdir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="A5"):
        txt2img.main(base + ["--ti_embedding", "ti.pt"])
    for flag in ("--mesh", "--tp"):
        with pytest.raises(NotImplementedError, match="A10"):
            txt2img.main(base + [flag, "2"])
    for args in (["--ckpt", "sd.ckpt"], ["--fr_ckpt", "backbone.pth"]):
        with pytest.raises(NotImplementedError, match="not ported"):
            txt2img.main(base + args)
    if torch.cuda.is_available():
        return
    for cli, argv in ((txt2img, []), (img2img, ["--init-img",
                                                pictures["init"]]),
                      (extract, ["--embedding_path", "e.pt"]),
                      (build_basis, ["--out", str(tmp_path / "b.pt")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--config", CFG] + argv)


@pytest.mark.parametrize("direction", ["port_writes", "jax_writes"])
def test_pt_io_both_ways(tmp_path, direction):
    r = np.random.default_rng(3)
    tree = {"id_coefficients": [r.standard_normal((2, 1, 8)).astype(np.float32)
                                for _ in range(3)],
            "half": r.standard_normal((4, 5)).astype(np.float16),
            "steps": np.arange(6, dtype=np.int64).reshape(2, 3),
            "nested": {"basis": r.standard_normal((2, 9, 4)).astype(
                np.float32)}}
    path = str(tmp_path / "tree.pt")
    if direction == "port_writes":
        pt_io.save_pt(tree, path)
        back = jpt_io.load_pt(path)
        as_np = lambda x: np.asarray(x)
        real = torch.load(path, weights_only=True)     # and real torch
        assert real["half"].dtype == torch.float16
    else:
        jpt_io.save_pt(tree, path)
        back = pt_io.load_pt(path)
        assert isinstance(back["steps"], torch.Tensor)
        as_np = lambda x: x.numpy()
    for a, b in zip(tree["id_coefficients"], back["id_coefficients"]):
        np.testing.assert_array_equal(as_np(b), a)
    for name in ("half", "steps"):
        assert as_np(back[name]).dtype == tree[name].dtype
        np.testing.assert_array_equal(as_np(back[name]), tree[name])
    np.testing.assert_array_equal(as_np(back["nested"]["basis"]),
                                  tree["nested"]["basis"])
