"""PyTorch port: ``parallel/mesh.py`` and the paths that run over a mesh.

* The partition rules (``param_partition_spec`` with TP on, conv TP on and
  off; ``fsdp_partition_spec`` at ``min_size`` 64 and ``n_data`` 2 and 8)
  equal the JAX functions on every leaf of the tiny UNet, VAE and CLIP,
  each JAX spec carried to the port's name and layout as
  ``utils.bridge.from_jax_params`` carries the leaf.
* One gloo group of two processes on the CPU (``_torch_mesh_ranks.py``,
  started once for the module) runs every multi-rank case, held against
  the port's one-process runs at the same global batch: the data-parallel
  and FSDP train steps at the limits of ``tests/test_train_multichip.py``
  (loss rtol 1e-5; trained MLP and ``id_coefficients`` rtol 2e-5, atol
  2e-6; the manager state equal on both ranks), the FSDP bytes a rank
  stores, ``PrefetchLoader.for_host`` against the JAX loader's shards,
  ``--mesh 2`` and ``--tp 2`` sampling at ``tests/test_tp_sampling.py``'s
  rtol 1e-4, atol 2e-4 (fp32) and through ``cli/txt2img.py``, and the
  GEGLU block's ``proj_in`` split half by half (a contiguous split fails).
"""
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from celebbasis_tpu.parallel import mesh as jmesh
from celebbasis_tpu_torch.parallel import mesh as tmesh

import _torch_mesh_ranks as ranks_mod
from _torch_threads import one_blas_thread  # noqa: F401  (one thread)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def _port_name(path):
    """A flax path's leaf name in the port (``utils.bridge``'s walk)."""
    from celebbasis_tpu_torch.utils import bridge
    keys = [k.key for k in path]
    parts = [k for k in keys[:-1] if k not in bridge._WRAPPER_LEVELS
             and k not in bridge._COLLECTIONS]
    return ".".join(parts + [bridge._LEAF_NAMES[keys[-1]]]), keys[-1]


def _to_port(spec, kind, ndim):
    """A JAX PartitionSpec of a leaf in the port's layout."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    if not any(spec):
        return ()
    return tuple(spec[j] for j in tmesh.jax_axes(kind, ndim))


def test_partition_rules_equal_jax_on_every_leaf():
    from celebbasis_tpu import pipeline as jpipe
    from celebbasis_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
    from celebbasis_tpu_torch import pipeline as tpipe
    from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer

    jp = jpipe.CelebBasisPipeline(jpipe.PipelineConfig.tiny(),
                                  JTokenizer.synthetic(1024))
    shapes = jax.eval_shape(lambda k: jp.init_params(k, image_size=32),
                            jax.random.key(0))
    tp = tpipe.CelebBasisPipeline(tpipe.PipelineConfig.tiny(),
                                  CLIPTokenizer.synthetic(1024))
    tp.requires_grad_(False)              # frozen, as loader.assemble makes it
    ours = {name: (p, kind) for name, _, _, p, kind in tmesh.leaves(tp)}
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(flat) == len(ours)
    seen = {"unet": 0, "clip": 0, "vae": 0}
    claimed = {"tp": 0, "conv": 0, "fsdp": 0}
    for path, leaf in flat:
        name, jleaf = _port_name(path)
        p, kind = ours[name]
        assert (kind is not None) == (jleaf == "kernel"), name
        jpath = jax.tree_util.keystr(path, simple=True, separator="/")
        seen[name.split(".")[0]] += 1
        for conv_tp in (False, True):
            want = _to_port(jmesh.param_partition_spec(
                jpath, leaf.ndim, True, conv_tp), kind, p.ndim)
            got = tmesh.param_partition_spec(name, p.ndim, True, conv_tp,
                                             kind)
            assert got == want, (name, conv_tp)
            claimed["conv" if conv_tp else "tp"] += bool(got)
        assert tmesh.param_partition_spec(name, p.ndim, False) == ()
        for n_data in (2, 8):
            want = _to_port(jmesh.fsdp_partition_spec(leaf.shape, n_data,
                                                      min_size=64),
                            kind, p.ndim)
            got = tmesh.fsdp_partition_spec(p.shape, n_data, 64, kind)
            assert got == want, (name, n_data)
            claimed["fsdp"] += bool(got)
    assert min(seen.values()) > 0
    assert 0 < claimed["tp"] < claimed["conv"] and claimed["fsdp"] > 0
    # the composition: a TP rule first, else (frozen leaves) the FSDP rule
    specs = tmesh.param_shardings(tp, 2, use_tp=True, fsdp=True, min_size=64)
    for path, leaf in flat:
        name, _ = _port_name(path)
        jpath = jax.tree_util.keystr(path, simple=True, separator="/")
        want = jmesh.param_partition_spec(jpath, leaf.ndim, True)
        if want == jmesh.P():
            want = jmesh.fsdp_partition_spec(leaf.shape, 2, min_size=64)
        assert specs[name] == _to_port(want, ours[name][1], leaf.ndim), name
    # the option the port does not run
    with pytest.raises(ValueError, match="GroupNorm"):
        tmesh.shard_params(tp, None, use_tp=True, conv_tp=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the two-process gloo group once (``_torch_mesh_ranks.py``, one
    thread each) and meanwhile computes the one-process references here;
    -> (references, [rank 0's results, rank 1's], the work folder)."""
    work = str(tmp_path_factory.mktemp("mesh"))
    ranks_mod.write_faces(work)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, TESTS]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "_torch_mesh_ranks.py"), work],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        ref = ranks_mod.references(work)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return ref, [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)], work


def _close(got, want, rtol=2e-5, atol=2e-6):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=atol)


def test_data_parallel_and_fsdp_steps_match_one_process(ranks):
    ref, (r0, r1), _ = ranks
    for case in ("dp", "fsdp"):
        np.testing.assert_allclose(r0[case]["loss"], ref[case]["loss"],
                                   rtol=1e-5)
        assert len(r0[case]["loss"]) == ranks_mod.STEPS
        for got, want in zip(r0[case]["mlp"], ref[case]["mlp"],
                             strict=True):
            _close(got, want)
        _close(r0[case]["id_coefficients"], ref[case]["id_coefficients"])
        # every rank ran the momentum update over the global rows
        for key in ("mlp", "id_coefficients", "id_embeddings"):
            a, b = r0[case][key], r1[case][key]
            for x, y in zip(*((a, b) if isinstance(a, list) else ([a], [b]))):
                assert torch.equal(x, y), (case, key)
    # FSDP: each rank stores what the rule predicts, less than it would whole
    for r in (r0, r1):
        assert r["fsdp_sharded"] > 0
        assert r["fsdp_stored_bytes"] == r["fsdp_predicted_bytes"] \
            < r["fsdp_whole_bytes"]


def test_for_host_shards_match_the_jax_loader(ranks):
    from celebbasis_tpu.data import face_id as jface
    from celebbasis_tpu.text.tokenizer import CLIPTokenizer as JTokenizer

    _, results, work = ranks
    for r, res in enumerate(results):
        ds = jface.FaceIdDataset(jface.FaceIdDatasetConfig(
            **ranks_mod.face_config(work)))
        it = iter(jface.PrefetchLoader(ds, JTokenizer.synthetic(1024),
                                       ranks_mod.LOADER_BATCH, seed=3,
                                       shard_id=r, num_shards=2))
        for ours in res["for_host"]:
            want = next(it)
            assert ours["captions"] == want["captions"]
            for k in ("image", "faces", "ids", "num_ids", "tokens"):
                np.testing.assert_array_equal(np.asarray(ours[k]),
                                              np.asarray(want[k]), err_msg=k)


def test_mesh_and_tp_sampling_match_one_process(ranks):
    ref, (r0, r1), _ = ranks
    want = ref["sample"].numpy()
    for r in (r0, r1):
        for case in ("sample_mesh", "sample_tp"):
            np.testing.assert_allclose(r[case].numpy(), want, rtol=1e-4,
                                       atol=2e-4, err_msg=case)
        # 4 tiny heads a CrossAttention and a CLIP layer, 2 a rank
        assert r["tp_heads"] == [2]
    # the CLI: the one-process run's files and pixels, from every rank
    imgs, files = ref["txt2img"]
    for case in ("txt2img_mesh", "txt2img_tp"):
        for r in (r0, r1):
            got, got_files = r[case]
            assert got.shape == imgs.shape and got.dtype == np.uint8
            assert np.abs(got.astype(int) - imgs).max() <= 1, case
        assert r0[case][1] == files and r1[case][1] == []


def test_geglu_proj_in_splits_half_by_half(ranks):
    for r in ranks[1]:
        assert r["geglu"]["halves"] < 1e-5
        assert r["geglu"]["contiguous"] > 1e-2
