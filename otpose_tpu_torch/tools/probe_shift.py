"""Run each mode of the token-shift kernel against its numpy target.

    python -m otpose_tpu_torch.tools.probe_shift [--device cpu]

The counterpart of ``tools/probe_shift.py``, which asked which bf16
lane-shift constructs a TPU compiles.  On a (16, 256) bf16 array from
``numpy.random.RandomState(0)`` it runs ``ops/cuda/token_shift.py`` in each
mode and prints ``<mode>: OK`` when the result equals the mode's numpy
target exactly, else ``<mode>: WRONG RESULT``.  It exits non-zero if any
mode is wrong.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from otpose_tpu_torch.ops.cuda.token_shift import MODES, token_shift
from otpose_tpu_torch.utils.device import resolve_device

R, L = 16, 256


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not all(probe(args.device).values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
