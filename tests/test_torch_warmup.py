"""PyTorch port: ``cli/warmup.py`` and the captured paths.

On the CPU, ``cli/warmup.py --device cpu`` at the tiny config on each of its
paths (both, ``--skip_train``, ``--skip_sample``): it runs the same Python
the card captures, eagerly, builds no kernel and writes its record.

The ``cuda`` cases need a card and skip here, inside the test: the txt2img
function and the train step captured as CUDA graphs give the bits their
eager runs give (images; loss, MLP gradients and parameters after AdamW),
the wrappers' launch counts per replay equal the eager counts, and a
capture that fails raises (no eager retry).

This file imports neither JAX nor the JAX package, so its ``cuda`` cases run
on a machine with the port's requirements alone:

    python -m pytest tests/test_torch_warmup.py -m cuda -q --noconftest
"""
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)       # six workers share the machine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "tiny.yaml")


@pytest.mark.parametrize("skip", [[], ["--skip_train"], ["--skip_sample"]])
def test_warmup_cli_on_cpu(tmp_path, skip):
    from celebbasis_tpu_torch.cli import warmup

    record = warmup.main([
        "--config", CFG, "--cache_dir", str(tmp_path / "cache"),
        "--image_size", "32", "--ddim_steps", "2", "--n_samples", "2",
        "--batch_size", "2", "--device", "cpu", *skip])
    assert record["device"] == "cpu" and "libraries" not in record
    assert ("train_s" in record) == ("--skip_train" not in skip)
    assert ("txt2img_s" in record) == ("--skip_sample" not in skip)
    with open(tmp_path / "cache" / "warmup.json") as f:
        assert json.load(f) == record


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are CUDA graphs")


def _tiny(remat=False):
    import dataclasses

    from celebbasis_tpu_torch.loader import assemble, init_weights
    from celebbasis_tpu_torch.utils.config import load_run_spec

    spec = load_run_spec([CFG])
    spec.unet = dataclasses.replace(spec.unet, remat=remat)
    asm = assemble(spec, image_size=32, device="cuda", dtype=torch.float32)
    init_weights(asm.pipeline.unet, torch.Generator(device="cuda")
                 .manual_seed(5), zero_convs=False)
    return asm


def _counts():
    from celebbasis_tpu_torch.ops import flash_attention as fa
    return fa.launch_counts()


@pytest.mark.cuda
def test_txt2img_graph_equals_eager_on_card():
    """DDIM at eta 0.5 (the step noise drawn before the graph) and PLMS (its
    first steps unrolled at capture)."""
    _need_card()
    from celebbasis_tpu_torch.ops import flash_attention as fa

    asm = _tiny()
    pipe, B = asm.pipeline, 2
    L = lambda a: torch.as_tensor(np.asarray(a, np.int64), device="cuda")
    args = (asm.manager_state, asm.basis,
            L(asm.tokenizer(["a photo of sks", "ks smiling"])),
            L(asm.tokenizer([""] * B)), L([[0, 1], [1, 0]]), L([2, 1]))
    gens = lambda: [torch.Generator(device="cuda").manual_seed(s)
                    for s in (3, 4)]
    for sampler, eta in (("ddim", 0.5), ("plms", 0.0)):
        fn = pipe.make_txt2img_fn(num_steps=4, image_size=32,
                                  sampler=sampler, eta=eta, output="float")
        fa.reset_launch_count()
        eager = fn.eager(*args, gens())
        torch.cuda.synchronize()
        n_eager = _counts()
        graph = [fn(*args, gens()) for _ in range(2)]
        fa.reset_launch_count()
        again = fn(*args, gens())
        torch.cuda.synchronize()
        assert all(torch.equal(g, eager) for g in graph + [again]), sampler
        assert _counts() == n_eager
        assert fn.captured.launches_per_replay() == {
            k: v for k, v in n_eager.items() if v}


@pytest.mark.cuda
def test_train_step_graph_equals_eager_on_card(monkeypatch):
    """An optimizer step each micro-batch, and two micro-batches a step with
    the UNet's remat (its blocks recomputed in the backward, inside the
    graph).  fp32 compute: cuDNN's default choice of float32 convolution
    algorithms does not repeat its bits from one eager step to the next
    (``torch_scripts/graph_repeatability.py`` shows it), so both runs
    take cuDNN's deterministic algorithms; bf16, the main path's compute
    type, repeats its bits either way."""
    _need_card()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    for accumulate, remat in ((1, False), (2, True)):
        _check_train_step(accumulate, remat)


def _check_train_step(accumulate, remat):
    from celebbasis_tpu_torch.train import step as tstep

    asm = _tiny(remat)
    assert asm.pipeline.unet.cfg.remat == remat
    pipe, meta = asm.pipeline, asm.meta_net
    r = np.random.default_rng(0)
    dev = lambda a, dt=torch.float32: torch.as_tensor(a, device="cuda",
                                                      dtype=dt)
    batch = {"image": dev(r.uniform(-1, 1, (2, 32, 32, 3))),
             "tokens": dev(asm.tokenizer(["a sks person", "a ks person"]),
                           torch.int64),
             "faces": dev(r.uniform(-1, 1, (2, 2, 32, 32, 3))),
             "ids": dev([[0, 1], [1, 0]], torch.int64),
             "num_ids": dev([2, 1], torch.int64)}
    start = {n: p.detach().clone() for n, p in meta.mlp.named_parameters()}

    def run(eager):
        with torch.no_grad():
            for n, p in meta.mlp.named_parameters():
                p.copy_(start[n])
        trainable = tstep.build_trainable(meta)
        opt = tstep.make_optimizer(trainable, 1e-2, accumulate=accumulate)
        step = tstep.make_train_step(pipe, meta, opt)
        state = tstep.init_train_state(
            torch.Generator(device="cuda").manual_seed(1), trainable, opt,
            asm.manager_state)
        fn = step.eager if eager else step
        losses = []
        for _ in range(3):
            state, logs = fn(state, asm.basis, batch)
            losses.append(logs["loss"].clone())
        grads = [p.grad.clone() for p in trainable["meta"]]
        params = [p.detach().clone() for p in trainable["meta"]]
        return losses, grads, params, state.manager_state, step

    ref = run(eager=True)
    got = run(eager=False)
    for a, b in zip(ref[:4], got[:4]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert got[4].captured.capture_s     # the graphs were captured


@pytest.mark.cuda
def test_failed_capture_raises_on_card():
    _need_card()
    from celebbasis_tpu_torch.utils import graphs

    def reads_the_host(x):
        return x * float(x.sum())          # a sync inside the capture

    with pytest.raises(RuntimeError):
        graphs.Captured(reads_the_host)(torch.ones(4, device="cuda"))
