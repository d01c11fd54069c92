"""Semi-supervised training as ``engine/runner.py::train_epoch`` drives it:
one ``make_train_step`` step after another on a ring of distinct seeded
batches already on the device, the step's dropout generator re-seeded from
(seed, epoch, step) before each step, and the metrics fetched to the host
every ``PRINT_FREQ`` steps.  The optimizer resumes at the first update of
epoch ``start_epoch`` of ``iters_per_epoch`` updates, as a checkpoint
resume sets it.

Set-up builds the one train step and drives it through its first
``compared_steps`` steps (on ring batches 0, 1, 2), which the reference
follows after the window: each step's loss, the first gradient as AdamW got
it (its first moment after one step) and each parameter's change over the
steps, by leaf.  Then the same step object runs the window.

Traffic parameters: ``batch``, ``ring``, ``labelled`` (the share of joints
labelled), ``iters_per_epoch``, ``start_epoch``, ``compared_steps``,
``trace_steps`` and optionally ``dtype``.

End-to-end: ``train_clips_per_s``, every clip of every completed step over
the whole window (closed by a synchronisation).
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import compare, program, trace, weights
from portbench.reference import model as ref_model
from portbench.reference import ops
from portbench.reference import train as ref_train


def batches(cfg: dict, tr: dict, seed: int, dev) -> list:
    gen = weights.generator(seed, "train batches", dev)
    ring = []
    for _ in range(tr["ring"]):
        inputs, margin = weights.clips(cfg, tr["batch"], gen, dev)
        target, weight = weights.targets(cfg, tr["batch"], tr["labelled"], gen, dev)
        ring.append({"inputs": inputs, "margin": margin, "target": target,
                     "target_weight": weight})
    return ring


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def first_steps(step, opt, model, ring, seeds, generator) -> dict:
    """Run the program's first steps; their losses, its first moments
    after one step and each parameter's change over them, as norms."""
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, grad = [], None
    for k, s in enumerate(seeds):
        generator.manual_seed(s)
        losses.append(step(ring[k % len(ring)])["final_loss"])
        if k == 0:
            grad = norms(program.first_moments(opt, model))
    change = norms({n: p.detach() - start[n] for n, p in model.named_parameters()})
    return {"losses": [float(v) for v in losses], "grad": grad, "change": change}


def reference_steps(state: dict, cfg: dict, tr: dict, ring, seeds, dev,
                    precision: str = "f32") -> dict:
    """The reference's readings of the same steps from ``state``."""
    model = ref_model.OTPose(ref_model.Spec.from_config(cfg)).to(dev)
    model.load_state_dict(state)
    start_step = tr["start_epoch"] * tr["iters_per_epoch"]
    trainer = ref_train.Trainer(model, cfg, tr["iters_per_epoch"], start_step)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=dev)
    losses, grad = [], None
    with ops.exact_f32(), ops.lowered(precision):
        for k, s in enumerate(seeds):
            gen.manual_seed(s)
            losses.append(trainer.step(ring[k % len(ring)], gen, cfg["LOSS"]["TOPK"]))
            if k == 0:
                grad = norms(trainer.first_moments())
    change = norms({n: p.detach() - start[n] for n, p in model.named_parameters()})
    return {"losses": losses, "grad": grad, "change": change}


def step_seeds(tr: dict, seed: int, first: int, count: int) -> list:
    return [program.step_seed(seed, tr["start_epoch"], first + k) for k in range(count)]


def setup(config: dict, tr: dict, seed: int, dev, phase=lambda name: None) -> dict:
    """The train state: the initial weights on the host (``state``), the
    program's ``model``, ``step``, ``opt`` and dropout ``generator``, the
    ``ring`` of batches and the compared steps' ``seeds``."""
    cfg = config["cfg"]
    ref = weights.make_reference(cfg, seed, dev)
    phase("weights")
    state = {k: v.detach().cpu() for k, v in ref.state_dict().items()}
    model = program.build(config, ref.state_dict(), dev)
    del ref
    gen = torch.Generator(device=dev)
    dtype = tr.get("dtype", cfg["TPU"]["COMPUTE_DTYPE"])
    start_step = tr["start_epoch"] * tr["iters_per_epoch"]
    step, opt = program.train_step(model, config, dtype, tr["iters_per_epoch"], start_step, gen)
    phase("program model")
    ring = batches(cfg, tr, seed, dev)
    phase("inputs")
    return {"state": state, "model": model, "step": step, "opt": opt, "generator": gen,
            "ring": ring, "seeds": step_seeds(tr, seed, 0, tr["compared_steps"]), "dtype": dtype}


def run(cell) -> None:
    config, tr, dev = cell.config, cell.traffic, cell.device
    cfg = config["cfg"]
    n_cmp = tr["compared_steps"]

    cell.phase("imports")
    st = setup(config, tr, cell.seed, dev, cell.phase)
    step, ring, gen = st["step"], st["ring"], st["generator"]
    got = first_steps(step, st["opt"], st["model"], ring, st["seeds"], gen)
    program.sync(dev)
    cell.window_starts()

    print_freq = cfg["PRINT_FREQ"]
    host, k = [], n_cmp
    t0 = time.perf_counter()
    while True:
        gen.manual_seed(program.step_seed(cell.seed, tr["start_epoch"], k))
        t_call = time.perf_counter()
        metrics = step(ring[k % len(ring)])
        host.append(time.perf_counter() - t_call)
        if k % print_freq == 0:
            metrics = {key: float(v) for key, v in metrics.items()}
        k += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    program.sync(dev)
    seconds = time.perf_counter() - t0
    steps = k - n_cmp
    cell.report(train_clips_per_s=steps * tr["batch"] / seconds)
    cell.reading.update(host_call_s=host, window_s=seconds, steps=steps, batch=tr["batch"],
                        dtype=st["dtype"], train=True)
    if cell.trace:
        found: dict = {}
        with trace.profiled(tr["trace_steps"], found):
            with trace.window():
                for j in range(tr["trace_steps"]):
                    gen.manual_seed(program.step_seed(cell.seed, tr["start_epoch"], k))
                    with torch.profiler.record_function("portbench::step"):
                        step(ring[k % len(ring)])
                    k += 1
                program.sync(dev)
        cell.reading["summary"] = found["summary"]
    cell.memory_peak()
    state, seeds = st["state"], st["seeds"]
    del step, st, metrics
    gc.collect()
    torch.cuda.empty_cache()

    want = reference_steps(state, cfg, tr, ring, seeds, dev)
    numbers = compare.train_numbers(got, want)
    correct = compare.judge(numbers, cell.limits)[0]
    cell.check(numbers, attempted=k, failed=0 if correct else n_cmp)
