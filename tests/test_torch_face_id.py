"""PyTorch port: ``data/face_id.py`` -- ``FaceIdDataset`` and
``PrefetchLoader`` against the JAX package's on one synthetic aligned-face
pickle, in both layouts (the flat one-shot path list and VGG-style
``(path, quality)`` tuples), shuffled and not, with the two-person mix and
other-identity crops switched on.  Same pickle and seed: arrays equal bit
for bit, captions and tokens identical.  Also: the worker thread stops when
the iterator is dropped, and an error in it reaches the caller.
"""
import dataclasses
import pickle
import threading

import numpy as np
import pytest
from PIL import Image

from celebbasis_tpu.data import face_id as jface
from celebbasis_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from celebbasis_tpu_torch.data import face_id as tface
from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

SIZE = 24


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """A flat pickle of six one-shot identities (32x32 PNGs, resized to
    SIZE by the dataset) and a VGG-style pickle of three folders of two."""
    d = tmp_path_factory.mktemp("faces")
    rng = np.random.default_rng(0)
    flat, vgg = [], []
    for i in range(6):
        p = d / f"{i:05d}.png"
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
                        ).save(p)
        flat.append(str(p))
        person = d / f"person{i // 2}"
        person.mkdir(exist_ok=True)
        q = person / f"{i}.png"
        Image.fromarray(rng.integers(0, 255, (28, 28, 3), dtype=np.uint8)
                        ).save(q)
        vgg.append((str(q), float(rng.uniform())))
    out = {}
    for name, paths in (("flat", flat), ("vgg", vgg)):
        out[name] = str(d / f"{name}.pickle")
        with open(out[name], "wb") as f:
            pickle.dump(paths, f)
    return out


def _configs(path, layout):
    common = dict(pickle_path=path, image_size=SIZE, repeats=3, diff_cnt=1,
                  dual_prob=0.5, seed=7)
    if layout == "flat":
        common.update(num_ids=4, specific_ids="1-5")
    else:
        common.update(num_ids=3, images_per_id=2)
    return (tface.FaceIdDatasetConfig(**common),
            jface.FaceIdDatasetConfig(**common))


def _assert_batches_equal(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        if k == "captions":
            assert ours[k] == ref[k]
        else:
            a, b = np.asarray(ours[k]), np.asarray(ref[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_config_and_templates_match_the_jax_package():
    assert [f.name for f in dataclasses.fields(tface.FaceIdDatasetConfig)] \
        == [f.name for f in dataclasses.fields(jface.FaceIdDatasetConfig)]
    assert tface.FaceIdDatasetConfig("p") == tface.FaceIdDatasetConfig(
        **dataclasses.asdict(jface.FaceIdDatasetConfig("p")))
    assert tface.TEMPLATES_SMALL == jface.TEMPLATES_SMALL
    assert tface.TEMPLATES_DUAL == jface.TEMPLATES_DUAL
    assert tuple(tface.PLACEHOLDER_STRINGS) == tuple(
        jface.PLACEHOLDER_STRINGS)
    for spec in (None, [2, 5], "3-7"):
        assert tface.parse_specific_ids(spec) == \
            jface.parse_specific_ids(spec)


@pytest.mark.parametrize("layout", ["flat", "vgg"])
def test_items_match_the_jax_dataset_bit_for_bit(pickles, layout):
    tcfg, jcfg = _configs(pickles[layout], layout)
    ours, ref = tface.FaceIdDataset(tcfg), jface.FaceIdDataset(jcfg)
    assert len(ours) == len(ref) and ours.img_dict == ref.img_dict
    duals = 0
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a["caption"] == b["caption"] and a["id_idx"] == b["id_idx"]
        duals += a["num_ids"] == 2
        for k in ("image", "faces", "ids", "num_ids"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert 0 < duals < len(ref)          # both captions and compositions
    # the dev split skips the jitter and the background paste
    dev = dataclasses.replace(tcfg, split="dev", dual_prob=0.0)
    jdev = dataclasses.replace(jcfg, split="dev", dual_prob=0.0)
    np.testing.assert_array_equal(tface.FaceIdDataset(dev)[1]["image"],
                                  jface.FaceIdDataset(jdev)[1]["image"])


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("layout", ["flat", "vgg"])
def test_loader_batches_match_the_jax_loader(pickles, layout, shuffle):
    tcfg, jcfg = _configs(pickles[layout], layout)
    kw = dict(batch_size=2, face_size=16, shuffle=shuffle, seed=3,
              prefetch=2)
    ours = tface.PrefetchLoader(tface.FaceIdDataset(tcfg),
                                CLIPTokenizer.synthetic(1024), **kw)
    ref = jface.PrefetchLoader(jface.FaceIdDataset(jcfg),
                               JTokenizer.synthetic(1024), **kw)
    assert len(ours) == len(ref)
    for epoch in range(2):               # the order's generator advances
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ref)
        for a, b in zip(got, want):
            _assert_batches_equal(a, b)
        assert got[0]["faces"].shape == (2, 4, 16, 16, 3)


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == "PrefetchLoader"]


def test_worker_stops_when_the_iterator_is_dropped(pickles):
    tcfg, _ = _configs(pickles["flat"], "flat")
    loader = tface.PrefetchLoader(tface.FaceIdDataset(tcfg),
                                  CLIPTokenizer.synthetic(1024), 1,
                                  prefetch=1)
    before = set(_loader_threads())
    it = iter(loader)
    next(it)
    (worker,) = set(_loader_threads()) - before
    assert worker.daemon
    del it                               # closes the generator
    worker.join(timeout=5)
    assert not worker.is_alive()


def test_worker_errors_reach_the_caller_and_for_host_raises(pickles):
    tcfg, _ = _configs(pickles["flat"], "flat")
    ds = tface.FaceIdDataset(tcfg)
    ds.img_dict[0]["images"] = ["/nonexistent.png"]
    loader = tface.PrefetchLoader(ds, CLIPTokenizer.synthetic(1024), 2,
                                  shuffle=False)
    with pytest.raises(FileNotFoundError):
        list(loader)
    # for_host shards by process: without a mesh or a process group it
    # raises (tests/test_torch_mesh.py runs it over two processes); a shard
    # given by hand is the JAX loader's strided slice of one global order
    with pytest.raises(ValueError, match="process group"):
        tface.PrefetchLoader.for_host(ds, CLIPTokenizer.synthetic(1024), 2)
    with pytest.raises(ValueError, match="shard 2 of 2"):
        tface.PrefetchLoader(ds, CLIPTokenizer.synthetic(1024), 2,
                             shard_id=2, num_shards=2)
    tcfg, jcfg = _configs(pickles["flat"], "flat")
    ours = tface.PrefetchLoader(tface.FaceIdDataset(tcfg),
                                CLIPTokenizer.synthetic(1024), 2, seed=5,
                                shard_id=1, num_shards=2)
    ref = jface.PrefetchLoader(jface.FaceIdDataset(jcfg),
                               JTokenizer.synthetic(1024), 2, seed=5,
                               shard_id=1, num_shards=2)
    for a, b in zip(ours, ref, strict=True):
        _assert_batches_equal(a, b)
    with pytest.raises(ValueError, match="not enough identities"):
        tface.FaceIdDataset(dataclasses.replace(tcfg, num_ids=9))
