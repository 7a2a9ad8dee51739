"""The multi-process side of ``tests/test_torch_mesh.py``: one rank of a gloo
group on the CPU, and the one-process references it is held against.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_mesh_ranks.py WORK_DIR

runs every multi-rank case in one group (``run_rank``) and writes its
results to ``WORK_DIR/rank<r>.pt``; ``references(work)`` computes what they
are compared with, in one process without a mesh.  Tiny configs, float32,
one thread; the model comes from ``loader.assemble`` with a tiny face net
and drawn UNet output convs, so that every layer takes part.  The cases
held against the JAX package read its weights, batch and requests from
``WORK_DIR/jax_side.pt`` (written by the test as the port's state dicts and
numpy arrays).  JAX-free.
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
    """A tensor-parallel FF block against the whole one (``"xla"`` route),
    with proj_in split half by half (the rule) and in one contiguous block,
    and split half by half on the ``"cuda"`` route (on the CPU the plain
    version of the ``geglu_ffn`` kernel); -> max |diff| of each, the largest
    output and the GEGLU kernels' launch counts (none on the CPU)."""
    from celebbasis_tpu_torch.models.unet import FeedForwardGEGLU
    from celebbasis_tpu_torch.ops import geglu
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
    geglu.reset_launch_count()
    with torch.no_grad():
        want = block().ff(x, ln)
        out = {"scale": float(want.abs().max())}
        for name, chunks, route in (
                ("halves", pmesh._TP_CHUNKS, None),
                ("contiguous", [], None),
                ("cuda_route", pmesh._TP_CHUNKS, "cuda")):
            saved, pmesh._TP_CHUNKS = pmesh._TP_CHUNKS, chunks
            geglu.set_default_impl(route)
            try:
                ff = pmesh.shard_params(block(), mesh, use_tp=True).ff
                out[name] = float((ff(x, ln) - want).abs().max())
            finally:
                pmesh._TP_CHUNKS = saved
                geglu.set_default_impl(None)
    out["launches"] = geglu.launch_counts()
    return out


def scale_shift_split(mesh):
    """A FiLM ResBlock (``scale_shift``, with a skip conv) channel-parallel
    under ``conv_tp`` against the whole one, with scale and shift split block
    by block (the rule) and as one contiguous block of emb_proj's output;
    -> max |diff| of the output, and of the gradients of x and of the time
    embedding (block by block), each beside the largest reference entry."""
    from celebbasis_tpu_torch.models import unet
    from celebbasis_tpu_torch.parallel import mesh as pmesh

    def block():
        torch.manual_seed(8)
        holder = torch.nn.Module()
        holder.res = unet.ResBlock(32, 64, 16, torch.float32,
                                   scale_shift=True)
        for p in holder.parameters():
            torch.nn.init.normal_(p, std=0.2)
        return holder
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 32, 6, 6, generator=g)
    emb = torch.randn(2, 16, generator=g)
    up = torch.randn(2, 64, 6, 6, generator=g)

    def run(res):
        xs, es = x.clone().requires_grad_(), emb.clone().requires_grad_()
        out = res(xs, es)
        out.backward(up)
        return out.detach(), xs.grad, es.grad
    want = run(block().res)
    out = {"scale": [float(w.abs().max()) for w in want]}
    for name, chunks in (("blocks", 2), ("contiguous", 1)):
        saved, unet.SCALE_SHIFT_CHUNKS = unet.SCALE_SHIFT_CHUNKS, chunks
        try:
            res = pmesh.shard_params(block(), mesh, use_tp=True,
                                     conv_tp=True).res
            got = run(res)
        finally:
            unet.SCALE_SHIFT_CHUNKS = saved
        out[name] = [float((a - b).abs().max()) for a, b in zip(got, want)]
    return out


def group_norm_straddle(mesh):
    """A GroupNorm of 3 groups over 48 channels split in two (the middle
    group straddles the ranks) against the unsplit norm: max |diff| of the
    output and of x's gradient, beside the largest reference entries."""
    from celebbasis_tpu_torch.ops.basic import GroupNorm
    from celebbasis_tpu_torch.parallel import mesh as pmesh

    g = torch.Generator().manual_seed(10)
    x = torch.randn(2, 48, 5, 7, generator=g) * 1.5 + 0.3
    up = torch.randn(2, 48, 5, 7, generator=g)
    norm = GroupNorm(48, num_groups=3)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5, generator=g)
        norm.bias.normal_(generator=g)
    xs = x.clone().requires_grad_()
    want = norm(xs)
    want.backward(up)
    shard = pmesh.ModelShard(pmesh.axis_index(mesh, pmesh.MODEL), 2,
                             mesh.get_group(pmesh.MODEL))
    mine = shard.block(x, 1).clone().requires_grad_()
    got = norm(mine, shard)
    got.backward(shard.block(up, 1))
    return {"out": float((got - shard.block(want, 1)).abs().max()),
            "grad": float((mine.grad - shard.block(xs.grad, 1)).abs().max()),
            "scale": [float(want.abs().max()), float(xs.grad.abs().max())]}


def jax_side_models(side):
    """The tiny pipeline and face net on the JAX side's weights, frozen,
    and the basis and manager state beside them."""
    from celebbasis_tpu_torch import pipeline as tpipe
    from celebbasis_tpu_torch.core import meta_net as tmeta
    from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer

    pipe = tpipe.CelebBasisPipeline(tpipe.PipelineConfig.tiny(),
                                    CLIPTokenizer.synthetic(1024))
    pipe.load_state_dict(side["pipeline"], strict=True)
    net = tmeta.MetaIdNet(dataclasses.replace(tmeta.MetaNetConfig.tiny(),
                                              **side["meta_cfg"]),
                          dtype=torch.float32)
    net.load_state_dict(side["meta"], strict=True)
    return (pipe.requires_grad_(False).eval(),
            net.requires_grad_(False).eval())


def conv_tp_sample(side, mesh):
    """The tiny txt2img (float images, given x_T) with the pipeline sharded
    by every TP rule, ``conv_tp`` included; -> the images, each leaf's
    shape before and after, its spec, and the refusal of a block that does
    not run channel-parallel convs."""
    from celebbasis_tpu_torch.align.pipnet import Bottleneck
    from celebbasis_tpu_torch.parallel import mesh as pmesh

    pipe, _ = jax_side_models(side)
    specs = pmesh.param_shardings(pipe, use_tp=True, conv_tp=True)
    whole = {n: tuple(p.shape) for n, _, _, p, _ in pmesh.leaves(pipe)}
    pmesh.shard_params(pipe, mesh, use_tp=True, conv_tp=True)
    shapes = {n: tuple(p.shape) for n, _, _, p, _ in pmesh.leaves(pipe)}
    req = {k: torch.as_tensor(v) for k, v in side["request"].items()}
    fn = pipe.make_txt2img_fn(num_steps=3, guidance_scale=5.0,
                              image_size=SIZE, output="float")
    with torch.no_grad():
        img = fn(side["mstate"], side["basis"], req["tokens"].long(),
                 req["uncond"].long(), req["ids"].long(),
                 req["num_ids"].long(), None, x_T=req["x_T"])
    holder = torch.nn.Module()
    holder.block = Bottleneck(16, 8, 1)
    try:
        pmesh.shard_params(holder, mesh, use_tp=True, conv_tp=True)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"images": img, "whole": whole, "shapes": shapes,
            "specs": specs, "refused": refused,
            "blocks": sum(m.tp is not None for m in pipe.modules()
                          if getattr(m, "runs_conv_tp", False))}


def tp_train_step(side, mesh, conv_tp):
    """One ``make_train_step`` step of the tiny W2 step with the pipeline
    and the face net sharded by the TP rules (``conv_tp`` too, or not), on
    the JAX side's batch and draws; -> the logged loss and the MLP's
    gradient by the port's names."""
    from celebbasis_tpu_torch.parallel import mesh as pmesh
    from celebbasis_tpu_torch.train import step as tstep

    pipe, net = jax_side_models(side)
    trainable = tstep.build_trainable(net)
    for m in (pipe, net):
        pmesh.shard_params(m, mesh, use_tp=True, conv_tp=conv_tp)
    opt = tstep.make_optimizer(trainable, 1e-2)
    step = tstep.make_train_step(pipe, net, opt, mesh=mesh)
    state = tstep.init_train_state(torch.Generator().manual_seed(0),
                                   trainable, opt, side["mstate"])
    batch = {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
             else torch.as_tensor(v) for k, v in side["batch"].items()}
    state, logs = step(state, side["basis"], batch)
    return {"loss": float(logs["loss"]),
            "grads": {n: p.grad.clone()
                      for n, p in net.mlp.named_parameters(prefix="mlp")},
            "local_heads": sorted({m.heads for m in pipe.modules()
                                   if hasattr(m, "heads")})}


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
    out["scale_shift"] = scale_shift_split(tp)
    out["gn_straddle"] = group_norm_straddle(tp)
    side = torch.load(os.path.join(work, "jax_side.pt"), weights_only=False)
    out["conv_tp_sample"] = conv_tp_sample(side, tp)
    out["tp_step"] = {case: tp_train_step(side, tp, case == "conv_tp")
                      for case in ("tp", "conv_tp")}
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
