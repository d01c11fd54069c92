"""Where the time of the bf16 fused kernels and the DCN goes, phase by phase.

    python -m otpose_tpu_torch.tools.kernel_phases [--batch 16 1]

Builds ``csrc/fused_attn.cu``, ``csrc/fused_mlp.cu`` and ``csrc/deform_conv.cu``
a second time with ``-DOTP_PHASE_CLOCK`` (thread 0 of every block adds the
``clock64()`` cycles of each phase to a slot: ``csrc/common.cuh``), runs each
at the flagship shapes (C = 136, two heads, T = 6912; the DCN at 17 x 96 x 72
with five dilations, in both rounding modes) on random bf16 inputs and prints
each phase's share of the summed cycles, beside the kernel's time in the
normal build (CUDA events, 20 launches).  The shares are of thread 0's time
between barriers, so a phase includes its wait for the slowest warp; the
DCN's sampling phase can end before its last loads return, so the
contraction includes that wait, and its B = 1 reduction is a second kernel.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys

import torch

from otpose_tpu_torch.utils.timing import time_ms

ATTN_PHASES = ("chunk load", "ln1", "conv + LN (x3)", "projection (x3)",
               "epilogue + v store (x3)", "scores")
MLP_PHASES = ("x load", "LN", "tile wait", "product 1", "GELU", "product 2",
              "epilogue + store")
DCN_PHASES = ("stage wait", "sampling", "contraction", "B = 1 reduction")


def _inputs(batch: int, gen):
    """Flagship-shaped attention and MLP arguments in bf16 (the q and k
    projections drawn small so that |S| stays near 10, as in chip_smoke.py)."""
    c, t, bf = 136, 6912, torch.bfloat16
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device="cuda") * scale  # noqa: E731
    x = r(batch, c, t).to(bf)
    attn = [x, 1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    attn += [r(c, 1, 3, scale=1 / math.sqrt(3)).to(bf) for _ in range(3)]
    for _ in range(3):
        attn += [1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    for p in range(3):
        small = p < 2
        attn += [r(c, c, 1, scale=(0.25 if small else 1.0) / math.sqrt(c)).to(bf),
                 r(c, scale=0.01 if small else 0.1).to(bf)]
    mlp = [x, 1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1),
           r(4 * c, c, 1, scale=1 / math.sqrt(c)).to(bf), r(4 * c, scale=0.1).to(bf),
           r(c, 4 * c, 1, scale=1 / math.sqrt(4 * c)).to(bf), r(c, scale=0.1).to(bf)]
    return attn, mlp


def phases(name: str, module, call, names) -> dict:
    """{phase: share of cycles} of one launch of ``call`` through the
    phase-clock build of kernel ``name``, and the normal build's ms."""
    from otpose_tpu_torch.ops.cuda import build

    ms = time_ms(call, iters=20, warmup=1)
    sigs = dict(module._SIGNATURES, otp_phase_cycles=(ctypes.c_int, [ctypes.c_void_p]))
    lib = build.load(name, sigs, defines=("OTP_PHASE_CLOCK",))
    normal = build._libs.get(name)
    build._libs[name] = lib
    try:
        slots = (ctypes.c_ulonglong * 16)()
        build.check(lib, lib.otp_phase_cycles(ctypes.addressof(slots)), "phase clocks")
        call()
        torch.cuda.synchronize()
        build.check(lib, lib.otp_phase_cycles(ctypes.addressof(slots)), "phase clocks")
    finally:
        build._libs[name] = normal
    total = sum(slots[:len(names)])
    return {"ms": ms, "cycles": total,
            "shares": {n: slots[i] / total for i, n in enumerate(names)}}


def dcn_calls(batch: int, gen) -> dict:
    """{mode: call} of the DCN kernel in its two modes on random bf16 inputs
    at the flagship shape (B x 17 x 96 x 72, offsets N(0, 4), five
    dilations), weights packed."""
    from otpose_tpu_torch.ops.cuda import deform_conv, deform_conv_fused

    c, h, w, dil = 17, 96, 72, (3, 6, 9, 12, 15)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device="cuda") * scale  # noqa: E731
    x = r(batch, c, h, w).to(torch.bfloat16)
    offs = [r(batch, 18 * c, h, w, scale=2.0).to(torch.bfloat16) for _ in dil]
    masks = [r(batch, 9 * c, h, w).to(torch.bfloat16) for _ in dil]
    pk = deform_conv.pack_dcn_weights(r(len(dil), c, c, 3, 3, scale=1 / math.sqrt(9 * c)),
                                      r(len(dil), c, scale=0.1))
    return {"exact": lambda: deform_conv.modulated_deform_conv_multi(
                x, offs, masks, dilations=dil, packed=pk),
            "make_pallas3": lambda: deform_conv_fused.deform_conv_fused(
                x, offs, masks, dilations=dil, packed=pk)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[16, 1])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_phases: needs a CUDA device")
    from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch in args.batch:
        attn, mlp = _inputs(batch, gen)
        apk = fused_attn.pack_attn_weights(*attn[1:], torch.bfloat16)
        mpk = fused_mlp.pack_mlp_weights(*mlp[1:], torch.bfloat16)
        for name, module, call, names in (
                ("fused_attn", fused_attn,
                 lambda: fused_attn.fused_attn_ct(attn[0], packed=apk, n_head=2),
                 ATTN_PHASES),
                ("fused_mlp", fused_mlp,
                 lambda: fused_mlp.fused_mlp_residual_ct(mlp[0], packed=mpk), MLP_PHASES)):
            res = phases(name, module, call, names)
            shares = ", ".join(f"{n} {s:.1%}" for n, s in res["shares"].items())
            print(f"{name} bf16 B={batch}: {res['ms']:.4f} ms; {shares} "
                  f"({res['cycles']} cycles over all blocks)", flush=True)
        for mode, call in dcn_calls(batch, gen).items():
            res = phases("deform_conv", deform_conv, call, DCN_PHASES)
            shares = ", ".join(f"{n} {s:.1%}" for n, s in res["shares"].items())
            print(f"deform_conv {mode} bf16 B={batch}: {res['ms']:.4f} ms; {shares} "
                  f"({res['cycles']} cycles over all blocks)", flush=True)


if __name__ == "__main__":
    main()
