"""PyTorch port: ``parallel/mesh.py`` and the paths that run over a mesh.

* The partition rules (``param_partition_spec`` with TP on, conv TP on and
  off; ``fsdp_partition_spec`` at ``min_size`` 64 and ``n_data`` 2 and 8)
  equal the JAX functions on every leaf of the tiny UNet, VAE and CLIP,
  each JAX spec carried to the port's name and layout as
  ``utils.bridge.from_jax_params`` carries the leaf.
* A GroupNorm whose groups straddle a channel split (96 channels in 32
  groups, split 3 ways) computed from the blocks' summed statistics
  (``group_sums``, ``group_norm_from_sums``) equals the unsplit norm
  within 1e-5 (float32, unit-scale inputs).
* One gloo group of two processes on the CPU (``_torch_mesh_ranks.py``,
  started once for the module) runs every multi-rank case, held against
  the port's one-process runs at the same global batch: the data-parallel
  and FSDP train steps at the limits of ``tests/test_train_multichip.py``
  (loss rtol 1e-5; trained MLP and ``id_coefficients`` rtol 2e-5, atol
  2e-6; the manager state equal on both ranks), the FSDP bytes a rank
  stores, ``PrefetchLoader.for_host`` against the JAX loader's shards,
  ``--mesh 2`` and ``--tp 2`` sampling at ``tests/test_tp_sampling.py``'s
  rtol 1e-4, atol 2e-4 (fp32) and through ``cli/txt2img.py``, the GEGLU
  block's ``proj_in`` split half by half (a contiguous split fails), its
  ``"cuda"`` route under TP (the ``geglu_ffn`` kernel's plain version on
  the CPU) within 2e-5 of the largest output of the whole ``"xla"``
  block, a FiLM ResBlock under ``conv_tp`` with scale and shift split
  block by block (output and input gradients within 1e-5 of the largest
  entry; a contiguous split fails), and a GroupNorm whose middle group
  straddles the two ranks (output and gradient within 1e-5).
* Against the JAX package on one device, on its tiny weights carried over
  (``jax_side.pt``): ``conv_tp`` sampling (UNet, VAE and CLIP sharded by
  every rule) at ``test_tp_sampling.py``'s rtol 1e-4, atol 2e-4, with
  JAX's replicated leaves whole on every rank; the W2 train step
  (``make_train_step``) with TP-sharded frozen weights, ``use_tp`` alone
  and with ``conv_tp``: loss rtol 1e-5, the MLP gradient within 1e-4 of
  its largest entry.
"""
import concurrent.futures
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from celebbasis_tpu.parallel import mesh as jmesh
from celebbasis_tpu_torch.ops import basic as tbasic
from celebbasis_tpu_torch.parallel import mesh as tmesh

import _torch_mesh_ranks as ranks_mod
from _torch_port_helpers import np_tree, random_params, stash_grads, \
    tiny_pipelines
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


def test_straddling_group_norm_equals_the_unsplit_norm():
    """96 channels in 32 groups split 3 ways: every block but the first
    starts inside a group."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 96, 5, 7, generator=g) * 1.5 + 0.3
    norm = tbasic.GroupNorm(96)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5, generator=g)
        norm.bias.normal_(generator=g)
        want = norm(x)
        blocks = x.chunk(3, dim=1)
        sums = sum(tbasic.group_sums(b, 32, 96, 32 * i)
                   for i, b in enumerate(blocks))
        got = torch.cat([tbasic.group_norm_from_sums(
            b, sums, 32, 96, 32 * i, norm.weight[32 * i:32 * (i + 1)],
            norm.bias[32 * i:32 * (i + 1)], norm.epsilon)
            for i, b in enumerate(blocks)], dim=1)
        # one block's own statistics are not the group's
        alone = tbasic.group_norm_from_sums(
            blocks[1], tbasic.group_sums(blocks[1], 32, 96, 32), 32, 96, 32,
            norm.weight[32:64], norm.bias[32:64], norm.epsilon)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert (alone - want[:, 32:64]).abs().max() > 1e-2


NAMES = ["Anne Hathaway", "Barack Obama", "Elon Musk", "Robert Downey",
         "Taylor Swift", "Emma Watson", "Brad Pitt", "Scarlett Johansson",
         "Leonardo DiCaprio", "Oprah Winfrey", "Keanu Reeves", "Rihanna"]
META = dict(inner_dim=8, token_dim=64)
LR = 1e-2


def _jax_side(work):
    """The tiny pipeline, face net, basis, manager state, a W2 batch with
    its draws and a sampling request made on the JAX side; the port's copy
    of them goes to ``work/jax_side.pt`` for the ranks.  -> the JAX side."""
    from celebbasis_tpu.core import meta_net as jmeta
    from celebbasis_tpu_torch.core import meta_net as tmeta
    from celebbasis_tpu_torch.utils import bridge

    d = tiny_pipelines(ranks_mod.SIZE, NAMES)
    jnet = jmeta.MetaIdNet(dataclasses.replace(jmeta.MetaNetConfig.tiny(),
                                               **META), dtype=jnp.float32)
    r = np.random.default_rng(11)
    B, size, tok = 2, ranks_mod.SIZE, d["tok"]
    lat = size // d["tp"].latent_factor
    k = len(d["tp"].manager_cfg.placeholder_token_ids)
    batch = {
        "image": r.uniform(-1, 1, (B, size, size, 3)).astype(np.float32),
        "tokens": np.asarray(tok(["face of sks person",
                                  "a photo of sks person and ks person"])),
        "faces": r.uniform(-1, 1, (B, 2, 40, 40, 3)).astype(np.float32),
        "ids": np.array([[0, 1], [0, 1]], np.int32),
        "num_ids": np.array([1, 2], np.int32),
        "override_znoise": r.standard_normal((B, lat, lat, 4)).astype(
            np.float32),
        "override_t": r.integers(0, 1000, (B,)).astype(np.int32),
        "override_noise": r.standard_normal((B, lat, lat, 4)).astype(
            np.float32)}
    request = {
        "tokens": np.asarray(tok(["a photo of a sks person",
                                  "a ks person and a sks person"])),
        "uncond": np.asarray(tok([""] * B)),
        "ids": np.array([[1, 0] + [0] * (k - 2), [2, 3] + [0] * (k - 2)],
                        np.int32),
        "num_ids": np.array([1, 2], np.int32),
        "x_T": r.standard_normal((B, lat, lat, 4)).astype(np.float32)}
    meta_params = random_params(
        jnet.init, jax.random.key(1), jnp.asarray(batch["faces"][:, 0]),
        jnp.zeros((B,), jnp.int32), d["jbasis"], seed=2)
    tnet = tmeta.MetaIdNet(dataclasses.replace(tmeta.MetaNetConfig.tiny(),
                                               **META), dtype=torch.float32)
    bridge.load_jax_params(tnet, np_tree(meta_params))
    torch.save({"pipeline": d["tp"].state_dict(), "meta": tnet.state_dict(),
                "meta_cfg": META, "basis": d["tbasis"], "mstate": d["tstate"],
                "batch": batch, "request": request},
               os.path.join(work, "jax_side.pt"))
    return dict(d, jnet=jnet, meta_params=meta_params, batch=batch,
                request=request)


def _jax_references(side):
    """The JAX package's one-device txt2img on the request and W2 step on
    the batch (its loss and MLP gradient, from ``stash_grads``)."""
    from celebbasis_tpu.train import step as jstep
    from celebbasis_tpu_torch.utils import bridge

    jp, req = side["jp"], {k: jnp.asarray(v)
                           for k, v in side["request"].items()}
    sample = np.asarray(jp.make_txt2img_fn(
        num_steps=3, guidance_scale=5.0, image_size=ranks_mod.SIZE,
        output="float")(side["params"], side["jstate"], side["jbasis"],
                        req["tokens"], req["uncond"], req["ids"],
                        req["num_ids"], jax.random.key(0), req["x_T"]))
    trainable, meta_frozen = jstep.split_meta_params(side["meta_params"])
    frozen = {**side["params"], "meta_frozen": meta_frozen}
    opt = optax.chain(stash_grads(), jstep.make_optimizer(LR))
    state = jstep.init_train_state(jax.random.key(3), trainable, opt,
                                   side["jstate"])
    state, logs = jax.jit(jstep.make_train_step(side["jp"], side["jnet"],
                                                opt))(
        state, frozen, side["jbasis"],
        {k: jnp.asarray(v) for k, v in side["batch"].items()})
    return {"sample": sample, "loss": float(logs["loss"]),
            "mlp": bridge.from_jax_params(np_tree(state.opt_state[0]))}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the two-process gloo group once (``_torch_mesh_ranks.py``, one
    thread each) and meanwhile computes the one-process references here,
    the JAX package's in a thread of their own; -> (references, [rank 0's
    results, rank 1's], the work folder)."""
    work = str(tmp_path_factory.mktemp("mesh"))
    ranks_mod.write_faces(work)
    side = _jax_side(work)
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
        # the JAX references compile while the port's run beside them
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            jax_refs = pool.submit(_jax_references, side)
            ref = ranks_mod.references(work)
            ref["jax"] = jax_refs.result()
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


def test_geglu_cuda_route_under_tp_matches_the_xla_block(ranks):
    for r in ranks[1]:
        got = r["geglu"]
        assert got["cuda_route"] <= 2e-5 * got["scale"]
        # the plain version of the kernel: no launch on the CPU
        assert got["launches"] == {"geglu_block": 0, "geglu_ffn": 0}


def test_scale_shift_splits_block_by_block(ranks):
    for r in ranks[1]:
        got = r["scale_shift"]
        # output, x's gradient, the time embedding's gradient
        for diff, scale in zip(got["blocks"], got["scale"], strict=True):
            assert diff <= 1e-5 * scale
        assert got["contiguous"][0] > 1e-2 * got["scale"][0]


def test_straddling_group_norm_over_two_ranks(ranks):
    for r in ranks[1]:
        got = r["gn_straddle"]
        assert got["out"] <= 1e-5 * got["scale"][0]
        assert got["grad"] <= 1e-5 * got["scale"][1]


def test_conv_tp_sampling_matches_jax(ranks):
    ref, results, _ = ranks
    want = ref["jax"]["sample"]
    assert want.std() > 0.05
    for r in results:
        got = r["conv_tp_sample"]
        np.testing.assert_allclose(got["images"].numpy(), want, rtol=1e-4,
                                   atol=2e-4)
        # the UNet's and the VAE's residual blocks ran channel parallel
        assert got["blocks"] == sum(
            1 for n in got["specs"] if n.endswith("conv1.weight"))
        assert got["blocks"] > 0
        # claimed leaves hold this rank's half, every other leaf is whole
        halves = 0
        for name, spec in got["specs"].items():
            want_shape = list(got["whole"][name])
            if tmesh.MODEL in spec:
                want_shape[spec.index(tmesh.MODEL)] //= 2
                halves += 1
            assert got["shapes"][name] == tuple(want_shape), name
        assert halves > 0
        for name in ("unet.down_0_res_0.norm2.weight",
                     "unet.down_0_res_0.emb_proj.weight",
                     "unet.down_0_res_0.conv2.weight",
                     "vae.encoder.down_1_res_0.nin_shortcut.weight"):
            assert got["specs"][name] == () and \
                got["shapes"][name] == got["whole"][name], name
        assert "does not run channel-parallel convs" in got["refused"]


@pytest.mark.parametrize("case", ["tp", "conv_tp"])
def test_tp_train_step_matches_jax(ranks, case):
    ref, results, _ = ranks
    want = ref["jax"]
    floor = 1e-3 * max(float(g.abs().max()) for g in want["mlp"].values())
    for r in results:
        got = r["tp_step"][case]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert set(got["grads"]) == set(want["mlp"])
        for name, g in want["mlp"].items():
            scale = max(float(g.abs().max()), floor)
            np.testing.assert_allclose(got["grads"][name].numpy(),
                                       g.numpy(), atol=1e-4 * scale,
                                       err_msg=name)
        assert got["local_heads"] == [2]
