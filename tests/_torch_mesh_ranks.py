"""The multi-process side of ``tests/test_torch_mesh.py``: one rank of a gloo
group on the CPU, and the one-process references it is held against.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_mesh_ranks.py WORK_DIR

runs every multi-rank case in one group (``run_rank``) and writes its
results to ``WORK_DIR/rank<r>.pt``; ``references(work)`` computes what they
are compared with, in one process without a mesh.  Tiny configs, float32,
one thread; the model comes from ``loader.assemble`` with a tiny face net
and drawn UNet output convs, so that every layer takes part.  JAX-free.
"""
import dataclasses
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, FACE, B_GLOBAL, STEPS = 32, 40, 4, 2
CFG = os.path.join(REPO, "configs", "tiny.yaml")
FSDP_MIN_SIZE = 64               # the JAX test's floor: tiny leaves shard
LOADER_BATCH = 2


def assembled():
    from celebbasis_tpu_torch.core.meta_net import MetaIdNet, MetaNetConfig
    from celebbasis_tpu_torch.loader import assemble, init_weights
    from celebbasis_tpu_torch.utils.config import load_run_spec

    spec = load_run_spec([CFG])
    a = assemble(spec, image_size=SIZE, device="cpu", dtype=torch.float32,
                 cache_dir=None)
    cfg = dataclasses.replace(MetaNetConfig.tiny(),
                              inner_dim=spec.meta_inner_dim,
                              token_dim=spec.clip.width)
    a.meta_net = init_weights(
        MetaIdNet(cfg, dtype=torch.float32).requires_grad_(False).eval(),
        torch.Generator().manual_seed(1))
    init_weights(a.pipeline.unet, torch.Generator().manual_seed(2),
                 zero_convs=False)
    return a


def global_batches(asm):
    """STEPS global batches of B_GLOBAL rows (numpy, as a loader yields)."""
    r = np.random.default_rng(0)
    tokens = np.asarray(asm.tokenizer(["face of sks person",
                                       "sks person and ks person"] * 2))
    return [{
        "image": r.uniform(-1, 1, (B_GLOBAL, SIZE, SIZE, 3)).astype(
            np.float32),
        "tokens": tokens,
        "faces": r.uniform(-1, 1, (B_GLOBAL, 2, FACE, FACE, 3)).astype(
            np.float32),
        "ids": np.array([[0, 1], [2, 1], [1, 3], [0, 2]]),
        "num_ids": np.array([1, 2, 2, 1]),
    } for _ in range(STEPS)]


def train(asm, work, tag, mesh=None, **kw):
    """Two steps of ``Trainer.fit`` at the global batch; -> the logged
    losses (rank 0 / one process), the trained MLP and the manager state."""
    import json

    from celebbasis_tpu_torch.parallel import mesh as pmesh
    from celebbasis_tpu_torch.train import trainer as ttrainer

    run = os.path.join(work, tag)
    os.makedirs(os.path.join(run, "checkpoints"), exist_ok=True)
    cfg = ttrainer.TrainerConfig(
        logdir=work, max_steps=STEPS, ckpt_every=1000, log_every=1,
        batch_size=B_GLOBAL, scale_lr=False, seed=23,
        n_data_shards=pmesh.axis_size(mesh, pmesh.DATA), **kw)
    tr = ttrainer.Trainer(asm.pipeline, asm.meta_net, asm.basis,
                          global_batches(asm), cfg, run_dir=run, mesh=mesh)
    state = tr.fit(tr.init_state(asm.manager_state))
    out = {"mlp": [p.detach().clone() for p in tr.trainable["meta"]],
           "id_coefficients": state.manager_state.id_coefficients.clone(),
           "id_embeddings": state.manager_state.id_embeddings.clone()}
    if pmesh.is_writer(mesh):
        with open(tr.metrics_path) as f:
            out["loss"] = [json.loads(line)["loss"] for line in f]
    return out


def sample(pipe, mesh=None):
    """The tiny txt2img sampler (float images) on this rank's rows of a
    B_GLOBAL batch, every data rank's rows gathered in order; row i draws
    from ``sample_seed(0, i)`` as the CLI's image i does."""
    from celebbasis_tpu_torch.core import manager as tmgr
    from celebbasis_tpu_torch.diffusion.sampler import sample_seed
    from celebbasis_tpu_torch.parallel import mesh as pmesh

    b = B_GLOBAL // pmesh.axis_size(mesh, pmesh.DATA)
    first = pmesh.axis_index(mesh, pmesh.DATA) * b
    tok = lambda p: torch.as_tensor(np.asarray(pipe.tokenizer(p)))
    cfg = pipe.manager_cfg
    fn = pipe.make_txt2img_fn(num_steps=3, guidance_scale=5.0,
                              image_size=SIZE)
    state = tmgr.init_state(cfg, torch.Generator().manual_seed(2))
    basis = torch.randn(cfg.num_es, 1 + cfg.inner_dim, cfg.token_dim,
                        generator=torch.Generator().manual_seed(3)) * 0.1
    k = len(cfg.placeholder_token_ids)
    with torch.no_grad():
        out = fn(state, basis, tok(["a photo of sks person"] * b),
                 tok([""] * b), torch.zeros((b, k), dtype=torch.int64),
                 torch.ones(b, dtype=torch.int64),
                 [torch.Generator().manual_seed(sample_seed(0, first + j))
                  for j in range(b)])
    if mesh is not None:
        out = pmesh.all_gather(out, mesh.get_group(pmesh.DATA))
    return out


def txt2img(work, tag, *flags):
    """``cli/txt2img.py`` at the tiny config, computing in float32 (the CLI
    computes in bf16, whose rounding a tensor-parallel sum changes) with the
    UNet's output convs drawn (a random-init UNet would predict eps = 0
    whatever it is given); -> the images and the files it wrote."""
    from celebbasis_tpu_torch import loader
    from celebbasis_tpu_torch.cli import txt2img as cli

    real = loader.assemble

    def drawn(*args, **kw):
        asm = real(*args, **dict(kw, dtype=torch.float32))
        loader.init_weights(asm.pipeline.unet,
                            torch.Generator().manual_seed(5),
                            zero_convs=False)
        return asm
    loader.assemble = drawn
    outdir = os.path.join(work, tag)
    try:
        imgs = cli.main(["--config", CFG, "--H", str(SIZE), "--W", str(SIZE),
                         "--ddim_steps", "3", "--n_samples", str(B_GLOBAL),
                         "--precision", "fp32", "--device", "cpu", "--outdir",
                         outdir, *flags])
    finally:
        loader.assemble = real
    files = sorted(os.path.relpath(os.path.join(d, f), outdir)
                   for d, _, fs in os.walk(outdir) for f in fs)
    return imgs, files


def geglu_split(mesh):
    """A tensor-parallel FF block against the whole one, with proj_in split
    half by half (the rule) and in one contiguous block; -> max |diff| of
    each."""
    from celebbasis_tpu_torch.models.unet import FeedForwardGEGLU
    from celebbasis_tpu_torch.parallel import mesh as pmesh

    def block():
        torch.manual_seed(3)
        holder = torch.nn.Module()     # the rules name the block 'ff'
        holder.ff = FeedForwardGEGLU(32, torch.float32)
        for p in holder.parameters():
            torch.nn.init.normal_(p, std=0.2)
        return holder
    x = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    ln = (torch.rand(32, generator=g) + 0.5,
          torch.randn(32, generator=g) * 0.1)
    with torch.no_grad():
        want = block().ff(x, ln)
        out = {}
        for name, chunks in (("halves", pmesh._TP_CHUNKS), ("contiguous", [])):
            saved, pmesh._TP_CHUNKS = pmesh._TP_CHUNKS, chunks
            try:
                ff = pmesh.shard_params(block(), mesh, use_tp=True).ff
                out[name] = float((ff(x, ln) - want).abs().max())
            finally:
                pmesh._TP_CHUNKS = saved
    return out


def for_host_batches(work, mesh):
    """Two batches of ``PrefetchLoader.for_host`` on this rank's shard."""
    from celebbasis_tpu_torch.data import face_id as tface
    from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer

    ds = tface.FaceIdDataset(tface.FaceIdDatasetConfig(**face_config(work)))
    it = iter(tface.PrefetchLoader.for_host(
        ds, CLIPTokenizer.synthetic(1024), LOADER_BATCH, mesh=mesh, seed=3))
    out = [next(it) for _ in range(2)]
    it.close()
    return out


def face_config(work):
    return dict(pickle_path=os.path.join(work, "faces.pickle"),
                image_size=24, repeats=3, num_ids=4, seed=7)


def write_faces(work):
    """Six one-shot identities as 32x32 PNGs and their pickle."""
    import pickle

    from PIL import Image
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        p = os.path.join(work, f"{i:05d}.png")
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(p)
    with open(os.path.join(work, "faces.pickle"), "wb") as f:
        pickle.dump(paths, f)


def references(work):
    """The one-process runs the ranks are held against."""
    asm = assembled()
    out = {"sample": sample(asm.pipeline)}
    mlp0 = {k: v.clone() for k, v in asm.meta_net.state_dict().items()}
    out["dp"] = train(asm, work, "ref_dp", loss_type="contra")
    asm.meta_net.load_state_dict(mlp0)
    out["fsdp"] = train(asm, work, "ref_fsdp")
    out["txt2img"] = txt2img(work, "ref_txt2img")
    return out


def fsdp_predicted_bytes(modules, n_data):
    """What FSDP leaves on a rank: each frozen leaf whole, or 1/n_data of
    it where the rule shards it."""
    from celebbasis_tpu_torch.parallel import mesh as pmesh

    total = 0
    for m in modules:
        specs = pmesh.param_shardings(m, n_data, fsdp=True)
        for name, _, _, p, _ in pmesh.leaves(m):
            if not p.requires_grad:
                shards = n_data if specs[name] else 1
                total += p.numel() // shards * p.element_size()
    return total


def run_rank(work):
    import torch.distributed as dist

    from celebbasis_tpu_torch.parallel import mesh as pmesh
    from celebbasis_tpu_torch.train import step as tstep

    dist.init_process_group("gloo")
    rank = dist.get_rank()
    out = {}
    asm = assembled()
    dp = pmesh.make_mesh(2, 1, device="cpu")
    out["sample_mesh"] = sample(asm.pipeline, dp)
    mlp0 = {k: v.clone() for k, v in asm.meta_net.state_dict().items()}
    out["dp"] = train(asm, work, "dp", dp, loss_type="contra")
    asm.meta_net.load_state_dict(mlp0)
    pmesh._FSDP_MIN_SIZE = FSDP_MIN_SIZE
    frozen = [asm.pipeline, asm.meta_net]
    tstep.build_trainable(asm.meta_net)      # the MLP trains: not sharded
    out["fsdp_whole_bytes"] = sum(pmesh.stored_bytes(m) for m in frozen)
    out["fsdp_predicted_bytes"] = fsdp_predicted_bytes(frozen, 2)
    out["fsdp_sharded"] = sum(
        bool(s) for m in frozen
        for s in pmesh.param_shardings(m, 2, fsdp=True).values())
    out["fsdp"] = train(asm, work, "fsdp", dp, fsdp=True)
    out["fsdp_stored_bytes"] = sum(pmesh.stored_bytes(m) for m in frozen)
    out["for_host"] = for_host_batches(work, dp)
    tp = pmesh.make_mesh(1, 2, device="cpu")
    out["geglu"] = geglu_split(tp)
    pipe = assembled().pipeline
    pmesh.shard_params(pipe, tp, use_tp=True)
    out["tp_heads"] = sorted({m.heads for m in pipe.modules()
                              if hasattr(m, "heads")})
    out["sample_tp"] = sample(pipe, None)
    # each rank its own folder: only rank 0 writes
    out["txt2img_mesh"] = txt2img(work, f"mesh{rank}", "--mesh", "2")
    out["txt2img_tp"] = txt2img(work, f"tp{rank}", "--tp", "2")
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    run_rank(sys.argv[1])
