"""The traced part of a run: ``torch.profiler`` over a burst of steps, its
Chrome trace written to the run's temporary directory, read back into a
``Summary`` and deleted.

Kernels, copies and sets are the device's operations.  A kernel is charged
to the program's op (``otpose::<name>``) whose host interval, on the thread
that launched it, holds the kernel's launch (the runtime call with the
kernel's correlation id).  The window is the harness's
``portbench::window`` range; the idle gaps are the times in it when no
device operation ran, each named by the innermost host op running at its
start.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile

import torch

WINDOW = "portbench::window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# device ms by kernel name, eval (``otpose_tpu_torch/tools/profile_eval.py``)
EVAL_CATEGORIES = (
    ("fused_attn", ("qkv_scores", "attn_softmax", "att_v_", "wide_ln1", "wide_conv_ln",
                    "wide_softmax", "AttnProj", "AttnScores", "AttnOut")),
    ("fused_mlp", ("fused_mlp_", "wide_ln_kernel", "MlpUp", "MlpDown")),
    ("fused (f32 weight split)", ("split_tf32",)),
    ("deform_conv", ("deform_staged_kernel", "deform_reduce_kernel", "deform_wide",
                     "wide_wfrag")),
    ("convolution", ("conv", "cudnn", "implicit_gemm", "wgrad", "dgrad", "xmma_fprop",
                     "nchwToNhwc", "nhwcToNchw")),
    ("matmul", ("gemm", "cutlass", "cublas", "sm90_xmma", "splitKreduce")),
)
# and train (``otpose_tpu_torch/tools/profile_train.py``); the rest is elementwise
TRAIN_CATEGORIES = (
    ("dcn_backward", ("dcn_bwd",)),
    ("dcn_forward", ("deform_staged_kernel", "deform_reduce_kernel", "deform_wide",
                     "wide_wfrag")),
    ("conv_backward", ("dgrad", "wgrad", "bprop", "convolve_sgemm_bwd", "bn_bw")),
    ("conv_forward", ("fprop", "cudnn", "implicit_gemm", "conv", "nchwToNhwc", "nhwcToNchw")),
    ("matmul", ("gemm", "cutlass", "cublas", "sm90_xmma", "splitKreduce")),
)
ELEMENTWISE = "elementwise"


def category(name: str, table) -> str:
    low = name.lower()
    for cat, keys in table:
        if any(k.lower() in low for k in keys):
            return cat
    return ELEMENTWISE


@dataclasses.dataclass
class Op:
    name: str
    ts: float
    dur: float
    tid: int
    dims: list
    types: list
    concrete: list


@dataclasses.dataclass
class Summary:
    """What one traced burst of ``steps`` steps did, times in seconds."""
    steps: int
    window: tuple             # (start, end) in microseconds of the trace's clock
    device: list              # (name, ts, dur, cat) of every device operation in the window
    ops: list                 # program ops (``otpose::*``) with the device seconds they launched
    host: dict                # tid -> sorted [(ts, end, name)] of host ops

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self) -> float:
        return sum(e - s for s, e in _merged(self.device)) * 1e-6

    def launches(self) -> int:
        return sum(1 for d in self.device if d[3] == "kernel")

    def seconds_by_category(self, table) -> dict:
        out: dict = {}
        for name, _ts, dur, _cat in self.device:
            cat = category(name, table)
            out[cat] = out.get(cat, 0.0) + dur * 1e-6
        return out

    def top_device_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, _ts, dur, _cat in self.device:
            by[name] = by.get(name, 0.0) + dur * 1e-6
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time of the window by the host op running at each gap's
        start (the innermost on any thread), largest first."""
        lo, hi = self.window
        gaps, cursor = [], lo
        for s, e in _merged(self.device) + [(hi, hi)]:
            s, e = max(s, lo), min(e, hi)
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        names = [None] * len(gaps)
        starts = [0.0] * len(gaps)
        for spans in self.host.values():
            for k, span in enumerate(_innermost(spans, [g[0] for g in gaps])):
                if span is not None and (names[k] is None or span[0] >= starts[k]):
                    names[k], starts[k] = span[2], span[0]
        by: dict = {}
        for (s, e), name in zip(gaps, names):
            key = name or "no host op"
            by[key] = by.get(key, 0.0) + (e - s) * 1e-6
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _innermost(spans: list, times: list) -> list:
    """For each of the ascending ``times``, the innermost of the nested,
    start-sorted ``spans`` (ts, end, name) that holds it, or None; the
    harness's window range is left out."""
    stack: list = []
    out = []
    i = 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            if spans[i][2] != WINDOW:
                stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _merged(device) -> list:
    spans = sorted((ts, ts + dur) for _n, ts, dur, _c in device)
    out: list = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def parse(events: list, steps: int) -> Summary:
    """A ``Summary`` of Chrome trace events."""
    windows = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0 = min(e["ts"] for e in windows)
    w1 = max(e["ts"] + e["dur"] for e in windows)
    device = [(e["name"], float(e["ts"]), float(e["dur"]), e["cat"]) for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
              and w0 <= e["ts"] and e["ts"] + e["dur"] <= w1]
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (float(e["ts"]), e["tid"])
    host: dict = {}
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("cpu_op", "user_annotation"):
            continue
        host.setdefault(e["tid"], []).append((float(e["ts"]), float(e["ts"] + e["dur"]),
                                              e["name"]))
        if e["name"].startswith("otpose::") and w0 <= e["ts"] <= w1:
            args = e.get("args") or {}
            ops.append(Op(e["name"], float(e["ts"]), float(e["dur"]), e["tid"],
                          args.get("Input Dims", []), args.get("Input type", []),
                          args.get("Concrete Inputs", [])))
    for spans in host.values():
        spans.sort(key=lambda sp: (sp[0], -sp[1]))      # an outer span before its children
    kernel_s = {id(op): 0.0 for op in ops}
    by_tid: dict = {}
    for op in ops:
        by_tid.setdefault(op.tid, []).append(op)
    for lst in by_tid.values():
        lst.sort(key=lambda o: o.ts)
    starts = {tid: [o.ts for o in lst] for tid, lst in by_tid.items()}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr not in launch:
            continue
        ts, tid = launch[corr]
        lst = by_tid.get(tid)
        if not lst:
            continue
        i = bisect.bisect_right(starts[tid], ts) - 1
        while i >= 0:
            op = lst[i]
            if op.ts <= ts <= op.ts + op.dur:
                kernel_s[id(op)] += float(e["dur"]) * 1e-6
                break
            i -= 1
    return Summary(steps, (w0, w1), device,
                   [(op, kernel_s[id(op)]) for op in ops], host)


@contextlib.contextmanager
def profiled(steps: int, out: dict):
    """Profile the body (which runs ``steps`` steps inside
    ``window()``); on exit ``out["summary"]`` holds its ``Summary``."""
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
    out["summary"] = parse(events, steps)


def window():
    """The range that marks the traced window."""
    return torch.profiler.record_function(WINDOW)
