"""Decoded evaluation of OTPose over a ViTPose estimator, driven as
``eval_pipelined`` drives it (``pipelined``: a closed loop with one batch in
flight over a ring of seeded batches on the device), against the float32
reference of ``reference/vitpose.py``.

Traffic parameters and end-to-end metrics are ``eval_pipelined``'s.  A
traced run also keeps the device time of each kernel that a CUDA graph
replay launched (``reading["replayed"]``: the kernels whose launch, by the
trace's correlation ids, is a graph launch), which the ViT's roofline
readers split by kernel name (``PRODUCT_KEYS``, ``ATTENTION_KEYS``).

The readings the cell's limits are set from (as ``control.py`` takes them
for the other eval cells: the program's numbers on every ring batch of a
short window, and for the control seeds the fp8 reference in the program's
place and the program's answers with one clip mirrored):

    python3 -m portbench.kinds.eval_vitpose --workload <name> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import sys
import tempfile

import torch

from portbench import compare, control, harness, program, trace, weights
from portbench.kinds import eval_pipelined
from portbench.reference import model as ref_model
from portbench.reference import ops, vitpose

# kernel names (lower case) of the dense products: cuBLAS's (``nvjet_*`` on
# Hopper, ``sm90_xmma_gemm_*``, CUTLASS's), not cuDNN's convolutions, not
# the attention, not the port's own wide products (``hgemm_kernel``)
PRODUCT_KEYS = ("gemm", "nvjet", "cutlass", "cublas", "splitkreduce")
NOT_PRODUCT_KEYS = ("fprop", "dgrad", "wgrad", "implicit", "conv", "nchw", "nhwc", "flash",
                    "fmha", "sdpa", "attention", "hgemm")
# the fused attention's kernels: flash's, and cuDNN's fused attention
ATTENTION_KEYS = ("flash", "fmha", "sdpa")
GRAPH_LAUNCH = "GraphLaunch"


@torch.no_grad()
def make_reference(cfg: dict, seed: int, device, center: bool = False) -> vitpose.OTPose:
    """The calibrated float32 reference of ``cfg`` for ``seed``, in eval
    mode on ``device``, drawn as ``weights.make_reference`` draws HRNet's
    configurations (one call of the device's generator; convolution and
    dense weights N(0, 1 / fan_in), biases N(0, 0.01), BN biases N(3, 0.01),
    norm weights 1, block scales 1 + N(0, 0.01)); ``pos_embed`` N(0, 0.01),
    as a bias.  Then one calibrating forward over two clips
    (``reference/model.py::forward``)."""
    with torch.device(device):
        model = vitpose.OTPose(cfg)
    params = list(model.named_parameters())
    noise = torch.randn(sum(p.numel() for _, p in params),
                        generator=weights.generator(seed, "weights", device), device=device)
    at = 0
    for name, p in params:
        n = noise[at:at + p.numel()].view_as(p)
        at += p.numel()
        kind = weights._owner_kind(model, name)
        if kind in ("BatchNorm", "LayerNormCT", "LayerNorm") and name.endswith("weight"):
            p.fill_(1.0)
        elif kind == "AffineScale":
            p.copy_(1.0 + 0.1 * n)
        elif kind == "BatchNorm":
            p.copy_(weights.BN_BIAS + 0.1 * n)
        elif name.endswith(("bias", "pos_embed")):
            p.copy_(0.1 * n)
        else:
            p.copy_(n / math.sqrt(p[0].numel()))
    del noise
    spec = model.spec
    x = torch.randn(weights.CALIBRATION_CLIPS, spec.pe_h * 4, spec.pe_w * 4, 15,
                    generator=weights.generator(seed, "calibration", device), device=device)
    model.eval()
    with ops.exact_f32():
        ref_model.forward(model, x, torch.ones(weights.CALIBRATION_CLIPS, 4, device=device),
                          calibrate=True, center=center)
    return model


def setup(config: dict, tr: dict, seed: int, dev, phase=lambda name: None):
    """(the float32 reference on the host, the program's step, the ring of
    batches), the step warmed on the ring (its warm-up captures the
    estimator's graph)."""
    cfg = config["cfg"]
    ref = make_reference(cfg, seed, dev, center=True)
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


def replayed(events: list, window: tuple) -> list:
    """[(kernel name, device seconds)] of the kernels in ``window`` whose
    launch is a CUDA graph launch."""
    graph = set()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in trace.LAUNCH_CATS \
                and GRAPH_LAUNCH in e.get("name", ""):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                graph.add(corr)
    lo, hi = window
    return [(e["name"], float(e["dur"]) * 1e-6) for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"
            and (e.get("args") or {}).get("correlation") in graph
            and lo <= e["ts"] and e["ts"] + e["dur"] <= hi]


def replayed_s(cell, keys, exclude=()) -> float | None:
    """Device seconds of the replayed kernels whose name holds one of
    ``keys`` and none of ``exclude``; None without a traced replay."""
    kernels = cell.reading.get("replayed")
    if not kernels:
        return None
    return sum(s for name, s in kernels
               if any(k in name.lower() for k in keys)
               and not any(k in name.lower() for k in exclude))


@contextlib.contextmanager
def profiled(steps: int, out: dict):
    """``trace.profiled``, which also keeps the replayed kernels in
    ``out["replayed"]``."""
    acts = [a for a in (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
            if a in torch.profiler.supported_activities()]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        yield
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out["summary"] = trace.parse(events, steps)
    out["replayed"] = replayed(events, out["summary"].window)


def run(cell) -> None:
    cfg, tr, dev = cell.config["cfg"], cell.traffic, cell.device
    dtype = tr.get("dtype", cfg["TPU"]["COMPUTE_DTYPE"])
    batch = tr["batch"]

    cell.phase("imports")
    ref, step, ring = setup(cell.config, tr, cell.seed, dev, cell.phase)
    cell.window_starts()

    win = eval_pipelined.pipelined(step, ring, seconds=cell.seconds)
    clips = batch * len(win["outputs"])
    cell.report(eval_clips_per_s=clips / win["seconds"],
                eval_batch_p90_ms=eval_pipelined.p90(win["latency_s"]) * 1e3)
    outputs = win["outputs"]
    cell.reading.update(host_call_s=win["host_s"], window_s=win["seconds"],
                        steps=len(outputs), batch=batch, dtype=dtype, train=False)
    if cell.trace:
        found: dict = {}
        with profiled(tr["trace_batches"], found):
            with trace.window():
                burst = eval_pipelined.pipelined(step, ring, batches=tr["trace_batches"])
        cell.reading.update(summary=found["summary"], replayed=found["replayed"])
        outputs = outputs + burst["outputs"]
    cell.memory_peak()
    del step
    gc.collect()
    torch.cuda.empty_cache()

    ref = ref.to(dev).eval()
    worst: dict = {}
    failed = 0
    for slot, (inputs, margin) in enumerate(ring):
        heat = eval_pipelined.reference_heatmaps(ref, inputs, margin, tr["reference_rows"])
        for s, (coords, maxvals, raw) in outputs:
            if s != slot:
                continue
            numbers = compare.eval_numbers(heat, coords, maxvals, raw)
            failed += not compare.judge(numbers, cell.limits)[0]
            for k, v in numbers.items():
                worst[k] = max(worst.get(k, 0.0), v)
    cell.check(worst, attempted=len(outputs), failed=failed)


def control_seed(files: dict, seed: int, with_control: bool, dev) -> dict:
    """One seed's readings, as ``control.py::eval_seed`` takes them."""
    tr = files["traffic"]
    ref, step, ring = setup(files["config"], tr, seed, dev)
    ref = ref.to(dev)
    outs = eval_pipelined.pipelined(step, ring, batches=2 * len(ring))["outputs"]
    del step
    control.free()
    rows = {"seed": seed, "program": {}, "control": {}, "fault_answer": {}}
    for slot, (inputs, margin) in enumerate(ring):
        heat = eval_pipelined.reference_heatmaps(ref, inputs, margin, tr["reference_rows"])
        for s, (coords, maxvals, raw) in outs:
            if s == slot:
                control._worst(rows["program"], compare.eval_numbers(heat, coords, maxvals, raw))
        if with_control:
            got = eval_pipelined.reference_decoded(ref, inputs, margin, tr["reference_rows"], "fp8")
            control._worst(rows["control"], compare.eval_numbers(heat, *got))
            out = next(o for s, o in outs if s == slot)
            control._worst(rows["fault_answer"],
                           compare.eval_numbers(heat, *control.mirrored(out, heat.shape[-1])))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the readings of a ViTPose cell's limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.kinds.eval_vitpose: needs a CUDA device", file=sys.stderr)
        return 2
    files = harness.cell_files(harness.load_json(harness.SPEC), args.workload)
    dev = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        row = dict(control_seed(files, seed, seed in args.control_seeds, dev),
                   workload=args.workload, card=torch.cuda.get_device_name(dev))
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
