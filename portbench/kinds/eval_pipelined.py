"""Decoded evaluation as ``engine/runner.py::evaluate_epoch_decoded`` drives
it: a closed loop with one batch in flight (``_pipelined_forward``): batch
i + 1's step is called before batch i's keypoints are fetched to the host.
The inputs are a ring of distinct seeded batches already on the device.

Traffic parameters: ``batch``, ``ring`` (distinct batches), ``warmup``
(steps before the window), ``trace_batches`` (the profiled burst of a
traced run), ``reference_rows`` (clips a reference forward takes at once),
and optionally ``dtype`` (else the configuration's ``TPU.COMPUTE_DTYPE``).

End-to-end: ``eval_clips_per_s``, every clip whose keypoints reached the
host over the whole window; ``eval_batch_p90_ms``, the 90th percentile over
every batch of the window of the time from the step's call to its keypoints
on the host.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from portbench import compare, program, trace, weights
from portbench.reference import model as ref_model
from portbench.reference import ops
from portbench.reference import train as ref_train


def pipelined(step, ring, *, seconds: float = 0.0, batches: int = 0) -> dict:
    """Drive ``step`` over ``ring`` for ``seconds`` (or ``batches`` batches)
    with one batch in flight.  Returns the window's seconds, each batch's
    host seconds in the step's call and its latency, and the fetched
    outputs by ring slot."""
    outs, lat, host = [], [], []
    pending = None

    def fetch(p):
        got, t_call, slot = p
        with torch.profiler.record_function("portbench::fetch"):
            host_outs = tuple(o.cpu() for o in got)
        lat.append(time.perf_counter() - t_call)
        outs.append((slot, host_outs))

    t0 = time.perf_counter()
    i = 0
    while True:
        slot = i % len(ring)
        t_call = time.perf_counter()
        with torch.profiler.record_function("portbench::step"):
            got = step(*ring[slot])
        host.append(time.perf_counter() - t_call)
        if pending is not None:
            fetch(pending)
        pending = (got, t_call, slot)
        i += 1
        if (batches and i >= batches) or (not batches and time.perf_counter() - t0 >= seconds):
            break
    fetch(pending)
    return {"seconds": time.perf_counter() - t0, "latency_s": lat, "host_s": host,
            "outputs": outs}


def p90(values) -> float:
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def setup(config: dict, tr: dict, seed: int, dev, phase=lambda name: None):
    """(the float32 reference on the host, the program's step, the ring of
    batches), the step warmed on the ring."""
    cfg = config["cfg"]
    ref = weights.make_reference(cfg, seed, dev, center=True)
    phase("weights")
    model = program.build(config, ref.state_dict(), dev)
    phase("program model")
    ref = ref.cpu()
    step = program.eval_step(model, tr.get("dtype", cfg["TPU"]["COMPUTE_DTYPE"]))
    gen = weights.generator(seed, "clips", dev)
    ring = [weights.clips(cfg, tr["batch"], gen, dev) for _ in range(tr["ring"])]
    phase("inputs")
    for i in range(tr["warmup"]):
        step(*ring[i % len(ring)])
    program.sync(dev)
    return ref, step, ring


def run(cell) -> None:
    cfg, tr, dev = cell.config["cfg"], cell.traffic, cell.device
    dtype = tr.get("dtype", cfg["TPU"]["COMPUTE_DTYPE"])
    batch = tr["batch"]

    cell.phase("imports")
    ref, step, ring = setup(cell.config, tr, cell.seed, dev, cell.phase)
    cell.window_starts()

    win = pipelined(step, ring, seconds=cell.seconds)
    clips = batch * len(win["outputs"])
    cell.report(eval_clips_per_s=clips / win["seconds"],
                eval_batch_p90_ms=p90(win["latency_s"]) * 1e3)
    outputs = win["outputs"]
    cell.reading.update(host_call_s=win["host_s"], window_s=win["seconds"],
                        steps=len(outputs), batch=batch, dtype=dtype, train=False)
    if cell.trace:
        found: dict = {}
        with trace.profiled(tr["trace_batches"], found):
            with trace.window():
                burst = pipelined(step, ring, batches=tr["trace_batches"])
        cell.reading["summary"] = found["summary"]
        outputs = outputs + burst["outputs"]
    cell.memory_peak()
    del step
    gc.collect()
    torch.cuda.empty_cache()

    ref = ref.to(dev).eval()
    worst: dict = {}
    failed = 0
    for slot, (inputs, margin) in enumerate(ring):
        heat = reference_heatmaps(ref, inputs, margin, tr["reference_rows"])
        for s, (coords, maxvals, raw) in outputs:
            if s != slot:
                continue
            numbers = compare.eval_numbers(heat, coords, maxvals, raw)
            failed += not compare.judge(numbers, cell.limits)[0]
            for k, v in numbers.items():
                worst[k] = max(worst.get(k, 0.0), v)
    cell.check(worst, attempted=len(outputs), failed=failed)


@torch.no_grad()
def reference_heatmaps(ref, inputs, margin, rows: int, precision: str = "f32"):
    """The reference's refined heatmaps (B, J, h, w) of a batch, ``rows``
    clips a forward."""
    parts = []
    with ops.exact_f32(), ops.lowered(precision):
        for i in range(0, inputs.shape[0], rows):
            parts.append(ref_model.forward(ref, inputs[i:i + rows], margin[i:i + rows])[0])
    return torch.cat(parts)


def reference_decoded(ref, inputs, margin, rows: int, precision: str):
    """The reference's heatmaps decoded as the program decodes its own:
    (coords, maxvals, raw coords)."""
    return ref_train.decode(reference_heatmaps(ref, inputs, margin, rows, precision))
