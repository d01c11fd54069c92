"""What the per-layer metric readers (``metrics/<name>.py``) share: each
reads the run's ``Cell.reading`` (the window's host clock readings and, in
a traced run, the profiled burst's ``trace.Summary``) and returns a number,
or None where it finds nothing to read."""

from __future__ import annotations

from portbench import counts, trace
from portbench.counts import flops


def _summary(cell):
    return cell.reading.get("summary")


def host_ms(cell) -> float | None:
    """Mean host milliseconds in the step's call, before any wait, over
    the window."""
    calls = cell.reading.get("host_call_s")
    return sum(calls) / len(calls) * 1e3 if calls else None


def launches(cell) -> float | None:
    s = _summary(cell)
    return s.launches() / s.steps if s else None


def category_ms(cell, wanted) -> float | None:
    """Device ms a step of the kernel categories ``wanted``."""
    s = _summary(cell)
    if s is None:
        return None
    table = trace.TRAIN_CATEGORIES if cell.reading["train"] else trace.EVAL_CATEGORIES
    by = s.seconds_by_category(table)
    return sum(by.get(c, 0.0) for c in wanted) * 1e3 / s.steps


def idle_share(cell) -> float | None:
    s = _summary(cell)
    return (1 - s.busy_s() / s.window_s) * 100 if s else None


def mfu(cell) -> float | None:
    """The step's model FLOPs (``counts/flops.py``) over the window's
    seconds a step at the bf16 peak."""
    r = cell.reading
    if not r.get("steps"):
        return None
    per_step = flops.step_flops(cell.config["cfg"], r["batch"], r["train"])
    return per_step * r["steps"] / (r["window_s"] * counts.PEAK_BF16) * 100


def _dtype(op, fallback: str) -> str:
    kind = str(op.types[0]) if op.types else ""
    if "BFloat16" in kind:
        return "bfloat16"
    if kind in ("float", "c10::Float") or "Float" in kind:
        return "float32"
    return fallback


def _heads(op, c: int, joints: int) -> int:
    for v in reversed(op.concrete or []):
        try:
            return int(v)
        except (TypeError, ValueError):
            continue
    return 1 if c == joints else 2


def op_work(op, cfg: dict, dtype: str):
    """The ``counts.Work`` of one program op from its recorded shapes."""
    j = cfg["MODEL"]["NUM_JOINTS"]
    d = len(cfg["MODEL"]["DEFORMABLE_CONV"]["DILATION"])
    dt = _dtype(op, dtype)
    if op.name == "otpose::fused_attn":
        b, c, t = op.dims[0]
        return counts.fused_attn(b, c, t, _heads(op, c, j), dt)
    if op.name == "otpose::fused_mlp":
        b, c, t = op.dims[0]
        return counts.fused_mlp(b, c, t, dt)
    if op.name == "otpose::deform_conv":
        b, c, h, w = op.dims[0]
        return counts.deform_conv(b, c, h, w, d, j, dt)
    if op.name == "otpose::deform_conv_bwd":
        o = op.dims[0][1]
        b, c, h, w = op.dims[1]
        return counts.deform_conv_bwd(b, c, h, w, d, o, dt)
    raise KeyError(op.name)


def roofline(cell, op_name: str) -> float | None:
    """Percent: the least time of every call of ``op_name`` in the traced
    burst over the device time of the kernels those calls launched."""
    s = _summary(cell)
    if s is None:
        return None
    least = device = 0.0
    for op, seconds in s.ops:
        if op.name == op_name and seconds > 0:
            least += op_work(op, cell.config["cfg"], cell.reading["dtype"]).least_s()
            device += seconds
    return least / device * 100 if device > 0 else None
