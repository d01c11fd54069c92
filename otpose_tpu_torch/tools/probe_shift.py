"""Run each mode of the token-shift kernel against its numpy target.

    python -m otpose_tpu_torch.tools.probe_shift [--device cpu] [--time]

The counterpart of ``tools/probe_shift.py``, which asked which bf16
lane-shift constructs a TPU compiles.  On a (16, 256) bf16 array from
``numpy.random.RandomState(0)`` it runs ``ops/cuda/token_shift.py`` in each
mode and prints ``<mode>: OK`` when the result equals the mode's numpy
target exactly, else ``<mode>: WRONG RESULT``.  It exits non-zero if any
mode is wrong.

``--time`` (CUDA only) times every mode at the fused attention's halo size,
(16 * 136, 6912) bf16: CUDA events around eager calls and a CUDA-graph
replay, beside the mode's bound (bytes over the card's 3.35 TB/s: read and
write for right, left and rotate; write only for handoff), the plain
version and, for rotate, ``torch.roll``.  Each call takes the next of four
input tensors, 120 MB together, and its output stays alive for four calls,
so that no call finds its input or its output in the 50 MB L2.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from otpose_tpu_torch.ops.cuda import token_shift as ts
from otpose_tpu_torch.ops.cuda.token_shift import MODES, token_shift
from otpose_tpu_torch.utils.device import resolve_device
from otpose_tpu_torch.utils.timing import graph_ms, time_ms

R, L = 16, 256
HALO = (16 * 136, 6912)
PEAK_BYTES = 3.35e12      # NVIDIA H100 SXM data sheet


def numpy_target(x: np.ndarray, mode: str) -> np.ndarray:
    """What each mode must give, written with numpy."""
    want = np.zeros_like(x)
    if mode == "right":
        want[:, 1:] = x[:, :-1]
    elif mode == "left":
        want[:, :-1] = x[:, 1:]
    elif mode == "rotate":
        want = np.roll(x, 1, axis=1)
    else:                                           # handoff
        want[:, 0] = x[:, -1]
    return want


def probe(device=None, out=print) -> dict:
    """{mode: True if the kernel's result equals the target}."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.random.RandomState(0).randn(R, L).astype(np.float32))
    x = x.to(torch.bfloat16)
    xf = x.float().numpy()
    x = x.to(dev)
    results = {}
    for mode in MODES:
        got = token_shift(x, mode).float().cpu().numpy()
        results[mode] = bool(np.array_equal(got, numpy_target(xf, mode)))
        out(f"{mode}: {'OK' if results[mode] else 'WRONG RESULT'}")
    return results


def _rotating(fn, xs):
    """``fn`` on the next of ``xs`` at every call; the last ``len(xs)``
    results stay alive, so that consecutive calls write other buffers too."""
    kept = [None] * len(xs)
    turn = [0]

    def call():
        i = turn[0] = (turn[0] + 1) % len(xs)
        kept[i] = fn(xs[i])

    return call


def time_modes(shape=HALO, dtype=torch.bfloat16, copies: int = 4) -> dict:
    """{mode: {ms, graph_ms, bound_ms, tbps, plain_ms}} of the kernel on a
    CUDA device, plus ``roll``: {ms, graph_ms} of ``torch.roll``.  ``tbps``
    is the bound's bytes over the graph-replay time."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    xs = [torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(copies)]
    nbytes = xs[0].numel() * xs[0].element_size()
    res = {}
    for mode in MODES:
        moved = nbytes if mode == "handoff" else 2 * nbytes
        call = _rotating(lambda x: token_shift(x, mode), xs)
        row = {"ms": time_ms(call, 40, warmup=10), "graph_ms": graph_ms(call, 40),
               "bound_ms": moved / PEAK_BYTES * 1e3}
        row["tbps"] = moved / (row["graph_ms"] * 1e-3) / 1e12
        row["plain_ms"] = time_ms(_rotating(lambda x: ts.token_shift_plain(x, mode), xs), 20)
        res[mode] = row
    roll = _rotating(lambda x: torch.roll(x, 1, 1), xs)
    res["roll"] = {"ms": time_ms(roll, 40, warmup=10), "graph_ms": graph_ms(roll, 40)}
    return res


def report(res: dict, out=print) -> None:
    for mode in MODES:
        r = res[mode]
        out(f"time token_shift {mode}: eager {r['ms']:.4f} ms, graph replay "
            f"{r['graph_ms']:.4f} ms ({r['tbps']:.3f} TB/s, {r['bound_ms'] / r['graph_ms']:.1%} "
            f"of the {r['bound_ms']:.4f} ms bound)"
            + f", plain {r['plain_ms']:.4f} ms"
            + (f", torch.roll eager {res['roll']['ms']:.4f} / graph "
               f"{res['roll']['graph_ms']:.4f} ms" if mode == "rotate" else ""))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--time", action="store_true", help="time every mode at the halo size")
    args = ap.parse_args(argv)
    if not all(probe(args.device).values()):
        sys.exit(1)
    if args.time:
        if resolve_device(args.device).type != "cuda":
            sys.exit("probe_shift: timing needs a CUDA device")
        report(time_modes())


if __name__ == "__main__":
    main()
