"""Shipped DCN against the fused-sampling one, at the flagship shape.

    python -m otpose_tpu_torch.tools.exp_deform_fused [--batch 16] [--iters 20]
    python -m otpose_tpu_torch.tools.exp_deform_fused --check --device cpu --batch 1

The counterpart of ``tools/exp_deform_pallas3.py``.  On random inputs from a
seed (B x 17 groups at 96x72, dilations 3, 6, 9, 12, 15) it runs
``ops/cuda/deform_conv.py`` (the model's DCN) and
``ops/cuda/deform_conv_fused.py`` (make_pallas3's rounding points).  Both
launch one kernel, ``csrc/deform_conv.cu``, in its two rounding modes, so the
times compare the two sample functions on one pipeline.  It prints their max
difference against the output's scale and
then, for 4 rounds, ``round r: shipped ... ms  fused ... ms`` from CUDA
events, in bf16.  ``--check`` compares only, in f32, and fails if the two
differ by more than 5e-4 of the scale; with ``--device cpu`` it compares the
two plain versions.
"""

from __future__ import annotations

import argparse

import torch

from otpose_tpu_torch.ops.cuda.deform_conv import modulated_deform_conv_multi
from otpose_tpu_torch.ops.cuda.deform_conv_fused import deform_conv_fused
from otpose_tpu_torch.utils.timing import time_ms
from otpose_tpu_torch.utils.device import resolve_device, resolve_dtype

H, W, G = 96, 72, 17
DILATIONS = (3, 6, 9, 12, 15)


def make_inputs(batch: int, dtype, device):
    """The experiment's inputs, drawn on ``device`` from seed 0: x ~ N(0, 1), offsets
    ~ N(0, 4), raw masks ~ N(0, 1), weights ~ N(0, 0.01), biases ~ N(0, 0.01)."""
    gen = torch.Generator(device=device).manual_seed(0)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    d = len(DILATIONS)
    x = r(batch, G, H, W).to(dtype)
    offs = [r(batch, 18 * G, H, W, scale=2.0).to(dtype) for _ in DILATIONS]
    masks = [r(batch, 9 * G, H, W).to(dtype) for _ in DILATIONS]
    return x, offs, masks, r(d, G, G, 3, 3, scale=0.1), r(d, G, scale=0.1), DILATIONS


def run(batch: int = 16, dtype=torch.bfloat16, device=None, rounds: int = 4,
        iters: int = 20, check: bool = False, out=print) -> dict:
    """Compare (and unless ``check``, time) the two kernels; returns
    {"maxdiff", "scale", "rounds": [(shipped_ms, fused_ms), ...]}."""
    dev = resolve_device(device)
    args = make_inputs(batch, resolve_dtype(dtype), dev)
    shipped = lambda: modulated_deform_conv_multi(*args)  # noqa: E731
    fused = lambda: deform_conv_fused(*args)  # noqa: E731
    o0, o1 = shipped().float(), fused().float()
    maxdiff = (o1 - o0).abs().max().item()
    scale = o0.abs().max().item()
    out(f"device={dev.type} dt={str(args[0].dtype)[6:]} maxdiff={maxdiff:.3e} "
        f"(scale {scale:.2f})")
    result = {"maxdiff": maxdiff, "scale": scale, "rounds": []}
    if check:
        if args[0].dtype == torch.float32 and not maxdiff <= 5e-4 * scale:
            raise AssertionError(f"the two kernels differ by {maxdiff:.3e} "
                                 f"(scale {scale:.2f})")
        out("check OK")
        return result
    if dev.type != "cuda":
        raise RuntimeError("exp_deform_fused: timing needs a CUDA device")
    for fn in (shipped, fused):
        time_ms(fn, 3, warmup=0)
    for r in range(rounds):
        m0, m1 = time_ms(shipped, iters, warmup=0), time_ms(fused, iters, warmup=0)
        out(f"round {r}: shipped {m0:7.3f} ms   fused {m1:7.3f} ms")
        result["rounds"].append((m0, m1))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--check", action="store_true", help="compare the two kernels only")
    args = ap.parse_args(argv)
    dtype = torch.float32 if args.check else torch.bfloat16
    run(args.batch, dtype, args.device, iters=args.iters, check=args.check)


if __name__ == "__main__":
    main()
