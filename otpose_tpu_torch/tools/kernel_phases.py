"""Where the time of the fused kernels and the DCN goes, phase by phase.

    python -m otpose_tpu_torch.tools.kernel_phases [--batch 16 1] [--bwd-batch 8 1]
    python -m otpose_tpu_torch.tools.kernel_phases --wide

Builds ``csrc/fused_attn.cu``, ``csrc/fused_mlp.cu``, ``csrc/deform_conv.cu``
and ``csrc/deform_conv_bwd.cu`` a second time with ``-DOTP_PHASE_CLOCK``
(thread 0 of every block adds the ``clock64()`` cycles of each phase to a
slot: ``csrc/common.cuh``), runs each at the flagship shapes (C = 136, two
heads, T = 6912, the fused kernels in bf16 and in f32, whose split-TF32
kernels have the same phase marks; the DCN at 17 x 96 x 72 with
five dilations, bf16, in both rounding modes; its backward at
``--bwd-batch``, bf16 and f32) on random
inputs and prints each phase's share of the summed cycles, beside the
kernel's time in the normal build (CUDA events, 20 launches).  The shares
are of thread 0's time between marks, so a phase includes its wait for the
slowest warp; the DCN's sampling phase can end before its last loads return,
so the contraction includes that wait, and its B = 1 reduction is a second
kernel.  The backward's marks sit inside its pixel loop (thread 0 is the
first lane of the warp of tap 0): they order the loop's instructions, so its
shares are of a build that runs a little slower than the normal one.
``--wide`` runs the DCN's wide paths instead (O = C = 133, 96 x 72, B = 2,
five dilations, bf16 and f32, offsets from ``utils/testing.py::dcn_case``):
the forward's stage wait, sampling and product, the backward's stage wait
and plane changes, G product, sampling, d W product and last segment.
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

# f32: the epilogue's slot also holds the barrier after the projection and
# the next weights' copy being issued
ATTN_PHASES = ("chunk load", "ln1", "conv + LN (x3)", "projection (x3)",
               "epilogue + v store (x3)", "scores", "weight wait (x3, f32 only)")
MLP_PHASES = ("x load", "LN", "tile wait", "product 1", "GELU", "product 2",
              "epilogue + store")
DCN_PHASES = ("stage wait", "sampling", "contraction", "B = 1 reduction")
DCN_BWD_PHASES = ("stage wait and plane changes", "sampling", "G", "d x atomics",
                  "stores and d W", "last segment out", "d x reduction")
WIDE_PHASES = ("stage wait", "sampling", "product")
WIDE_BWD_PHASES = ("stage wait and plane changes", "G product", "sampling", "d W product",
                   "last segment out")


def _inputs(batch: int, gen, dtype):
    """Flagship-shaped attention and MLP arguments in ``dtype`` (the q and k
    projections drawn small so that |S| stays near 10, as in chip_smoke.py's
    bf16 case)."""
    c, t = 136, 6912
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device="cuda") * scale  # noqa: E731
    x = r(batch, c, t).to(dtype)
    attn = [x, 1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    attn += [r(c, 1, 3, scale=1 / math.sqrt(3)).to(dtype) for _ in range(3)]
    for _ in range(3):
        attn += [1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    for p in range(3):
        small = p < 2
        attn += [r(c, c, 1, scale=(0.25 if small else 1.0) / math.sqrt(c)).to(dtype),
                 r(c, scale=0.01 if small else 0.1).to(dtype)]
    mlp = [x, 1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1),
           r(4 * c, c, 1, scale=1 / math.sqrt(c)).to(dtype), r(4 * c, scale=0.1).to(dtype),
           r(c, 4 * c, 1, scale=1 / math.sqrt(4 * c)).to(dtype), r(c, scale=0.1).to(dtype)]
    return attn, mlp


def phases(name: str, signatures: dict, call, names) -> dict:
    """{phase: share of cycles} of one launch of ``call`` through the
    phase-clock build of kernel ``name`` (C functions ``signatures``), and
    the normal build's ms."""
    from otpose_tpu_torch.ops.cuda import build

    ms = time_ms(call, iters=20, warmup=1)
    sigs = dict(signatures, otp_phase_cycles=(ctypes.c_int, [ctypes.c_void_p]))
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


def dcn_bwd_call(batch: int, dtype, gen):
    """A call of the DCN's backward kernel at the flagship shape (offsets from
    ``utils/testing.py::dcn_case``, most samples inside the image)."""
    from otpose_tpu_torch.ops.cuda import deform_conv
    from otpose_tpu_torch.utils.testing import dcn_case

    x, offs, masks, weights, biases, dil = dcn_case(batch, 17, 17, 96, 72, (3, 6, 9, 12, 15),
                                                    dtype, gen)
    g = torch.randn(batch, 17, 96, 72, generator=gen, device="cuda").to(dtype)
    pk = deform_conv.pack_dcn_weights(weights, biases)
    return lambda: deform_conv.launch_backward(g, x, offs, masks, pk, dil)


def wide(gen) -> None:
    """The DCN's wide paths at the 133-joint model's shape, phase by phase."""
    from otpose_tpu_torch.ops.cuda import deform_conv
    from otpose_tpu_torch.utils.testing import dcn_case

    for dtype in (torch.bfloat16, torch.float32):
        x, offs, masks, weights, biases, dil = dcn_case(2, 133, 133, 96, 72, (3, 6, 9, 12, 15),
                                                        dtype, gen)
        g = torch.randn(2, 133, 96, 72, generator=gen, device="cuda").to(dtype)
        pk = deform_conv.pack_dcn_weights(weights, biases)
        for name, sigs, call, names in (
                ("deform_conv", deform_conv._SIGNATURES,
                 lambda: deform_conv.modulated_deform_conv_multi(x, offs, masks, dilations=dil,
                                                                 packed=pk), WIDE_PHASES),
                ("deform_conv_bwd", deform_conv._BWD_SIGNATURES,
                 lambda: deform_conv.launch_backward(g, x, offs, masks, pk, dil),
                 WIDE_BWD_PHASES)):
            res = phases(name, sigs, call, names)
            shares = ", ".join(f"{n} {s:.1%}" for n, s in res["shares"].items())
            print(f"{name} wide {str(dtype)[6:]} O=133 B=2 D=5: {res['ms']:.4f} ms; {shares} "
                  f"({res['cycles']} cycles over all blocks)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="*", default=[16, 1])
    ap.add_argument("--bwd-batch", type=int, nargs="*", default=[8, 1])
    ap.add_argument("--wide", action="store_true",
                    help="the DCN's wide paths at O = C = 133 instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_phases: needs a CUDA device")
    from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.wide:
        wide(gen)
        return
    for batch in args.batch:
        for dtype in (torch.bfloat16, torch.float32):
            attn, mlp = _inputs(batch, gen, dtype)
            apk = fused_attn.pack_attn_weights(*attn[1:], dtype)
            mpk = fused_mlp.pack_mlp_weights(*mlp[1:], dtype)
            for name, sigs, call, names in (
                    ("fused_attn", fused_attn._SIGNATURES,
                     lambda: fused_attn.fused_attn_ct(attn[0], packed=apk, n_head=2),
                     ATTN_PHASES),
                    ("fused_mlp", fused_mlp._SIGNATURES,
                     lambda: fused_mlp.fused_mlp_residual_ct(mlp[0], packed=mpk), MLP_PHASES)):
                res = phases(name, sigs, call, names)
                shares = ", ".join(f"{n} {s:.1%}" for n, s in res["shares"].items())
                print(f"{name} {str(dtype)[6:]} B={batch}: {res['ms']:.4f} ms; {shares} "
                      f"({res['cycles']} cycles over all blocks)", flush=True)
        for mode, call in dcn_calls(batch, gen).items():
            res = phases("deform_conv", deform_conv._SIGNATURES, call, DCN_PHASES)
            shares = ", ".join(f"{n} {s:.1%}" for n, s in res["shares"].items())
            print(f"deform_conv {mode} bf16 B={batch}: {res['ms']:.4f} ms; {shares} "
                  f"({res['cycles']} cycles over all blocks)", flush=True)
    for batch in args.bwd_batch:
        for dtype in (torch.bfloat16, torch.float32):
            res = phases("deform_conv_bwd", deform_conv._BWD_SIGNATURES,
                         dcn_bwd_call(batch, dtype, gen), DCN_BWD_PHASES)
            shares = ", ".join(f"{n} {s:.1%}" for n, s in res["shares"].items())
            print(f"deform_conv_bwd {str(dtype)[6:]} B={batch}: {res['ms']:.4f} ms; {shares} "
                  f"({res['cycles']} cycles over all blocks)", flush=True)


if __name__ == "__main__":
    main()
