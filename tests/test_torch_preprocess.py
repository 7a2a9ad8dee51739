"""PyTorch port, PIPNet dataset preprocessing (``align/preprocess.py``)
against the JAX package's, on the CPU:

* every ``process_*_arrays`` (300W at scales 1.1 and 1.3, COFW, WFLW with
  and without the GSSL top drop, AFLW, CelebA, COFW-68 train and test),
  ``wflw98_to_68`` and the two WFLW 98 -> 68 file converters: crops, labels
  and files equal to JAX's (the port resizes with its copy of OpenCV's
  resize, the JAX package with OpenCV's);
* ``gen_data`` on synthetic raw 300W (PNG and JPEG), WFLW (with the
  per-attribute test lists), COFW and AFLW (``.mat`` files written by
  ``scipy.io.savemat``) layouts, and ``gen_data_gssl`` on data_300W_CELEBA
  and data_300W_COFW_WFLW: every file the two packages write -- crops,
  label files, meanface -- byte for byte the same (both encode with
  OpenCV's codecs).
"""
import os

import numpy as np
import pytest

from celebbasis_tpu.align import preprocess as jpp
from celebbasis_tpu_torch.align import preprocess as tpp

import _pipnet_layouts as layouts
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

cv2 = pytest.importorskip("cv2")


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_process_arrays_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = lambda h, w: rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    pts = lambda n, h, w: layouts._points(rng, n, h, w)
    cases = []
    for i in range(3):
        h, w, size = 100 + 7 * i, 120 - 5 * i, 40 + 8 * i
        box = [12.0 + i, 9.0 + i, 70.0, 80.0]
        phis = np.concatenate([rng.uniform(15, 60, 29),
                               rng.uniform(12, 76, 29),
                               rng.integers(0, 2, 29).astype(float)])
        lms196 = [str(v) for v in pts(98, h, w).flatten()]
        wbox = [14.0, 20.0, w - 10.0, h - 8.0]
        aflw = np.concatenate(pts(19, h, w).T) + rng.uniform(-8, 8, 38)
        cases += [
            ("process_300w_arrays", (img(h, w), pts(68, h, w), size), {}),
            ("process_300w_arrays", (img(h, w), pts(68, h, w), size),
             {"scale": 1.3}),
            ("process_cofw_arrays", (img(h, w), np.asarray(box), phis,
                                     size), {}),
            ("process_wflw_arrays", (img(h, w), lms196, wbox, size), {}),
            ("process_wflw_arrays", (img(h, w), lms196, wbox, size),
             {"drop_top": True}),
            ("process_aflw_arrays", (img(h, w), [8.0, w - 9.0, 5.0,
                                                 h - 7.0], aflw, size), {}),
            ("process_celeba_arrays", (img(h, w), [10, 12, w - 15, h - 9],
                                       size), {}),
            ("process_cofw68_train_arrays", (img(h, w), box, phis, size),
             {}),
            ("process_cofw68_test_arrays", (img(h, w), box, pts(68, h, w),
                                            size), {})]
    for name, args, kw in cases:
        ref = getattr(jpp, name)(*args, **kw)
        got = getattr(tpp, name)(*args, **kw)
        if name == "process_celeba_arrays":
            ref, got = (ref, None), (got, None)
        np.testing.assert_array_equal(got[0], ref[0], err_msg=name)
        assert got[0].dtype == ref[0].dtype
        if ref[1] is not None:
            np.testing.assert_array_equal(np.asarray(got[1]),
                                          np.asarray(ref[1]), err_msg=name)
    p98 = pts(98, 200, 200)
    np.testing.assert_array_equal(tpp.wflw98_to_68(p98),
                                  jpp.wflw98_to_68(p98))
    # the two 98 -> 68 file converters
    rows = [f"img_{i}.jpg " + " ".join(str(v) for v in rng.uniform(0, 1, 196))
            for i in range(3)]
    for side in ("jax", "torch"):
        os.makedirs(tmp_path / side / "task")
        (tmp_path / side / "task" / "test_WFLW_98.txt").write_text(
            "\n".join(rows) + "\n")
        (tmp_path / side / "wflw_test.txt").write_text("\n".join(rows) + "\n")
    for side, mod in (("jax", jpp), ("torch", tpp)):
        mod.convert_wflw_gssl(str(tmp_path / side), "task")
        mod.convert_wflw(str(tmp_path / side), "task",
                         str(tmp_path / side / "wflw_test.txt"))
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")


def _run_both(tmp_path, write, run):
    """The same raw layout under ``jax/`` and ``torch/``, each side's driver
    on its own copy; -> the files each driver wrote (the raw ``.mat`` files
    carry the second they were written in their headers)."""
    out = []
    for side, mod in (("torch", tpp), ("jax", jpp)):
        root = tmp_path / side
        write(str(root))
        raw = _tree(root)
        run(mod, str(root))
        out.append({k: v for k, v in _tree(root).items()
                    if raw.get(k) != v})
    return out


GEN_DATA = {
    "data_300W_png": ("data_300W", lambda root: layouts.write_300w(
        root, np.random.default_rng(1), ext="png")),
    "data_300W_jpg": ("data_300W", lambda root: layouts.write_300w(
        root, np.random.default_rng(2), ext="jpg")),
    "WFLW": ("WFLW", lambda root: layouts.write_wflw(
        root, np.random.default_rng(3))),
    "COFW": ("COFW", lambda root: layouts.write_cofw(
        root, np.random.default_rng(4))),
    "AFLW": ("AFLW", lambda root: layouts.write_aflw(
        root, np.random.default_rng(5))),
}


@pytest.mark.parametrize("case", sorted(GEN_DATA))
def test_gen_data_writes_the_jax_bytes(tmp_path, case):
    data_name, write = GEN_DATA[case]
    got, ref = _run_both(tmp_path, write, lambda mod, root: mod.gen_data(
        root, data_name, 48))
    written = [k for k in ref if "images_t" in k or k.endswith(".txt")]
    assert any(k.endswith("meanface.txt") for k in written)
    assert sum("images_train" in k for k in written) >= 2
    if data_name == "WFLW":
        assert {"WFLW/test_pose.txt", "WFLW/test_illu.txt",
                "WFLW/test_occu.txt"} <= set(written)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k] == ref[k], k


@pytest.mark.parametrize("task", ["data_300W_CELEBA", "data_300W_COFW_WFLW"])
def test_gen_data_gssl_writes_the_jax_bytes(tmp_path, task):
    def run(mod, root):
        if task == "data_300W_CELEBA":
            mod.gen_data_gssl(root, "CELEBA", 48)
        mod.gen_data_gssl(root, task, 48)
    got, ref = _run_both(tmp_path, lambda root: layouts.write_gssl(root,
                                                                   task),
                         run)
    for name in ("train_300W.txt", "test_300W.txt", "test_COFW.txt",
                 "test_WFLW_98.txt", "test_WFLW.txt", "meanface.txt"):
        assert os.path.join(task, name) in ref, name
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k] == ref[k], k
