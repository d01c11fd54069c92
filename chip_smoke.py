#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``otpose_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. checks for a CUDA device and prints its ``nvidia-smi`` name and power limit;
2. builds the five kernel sources from ``otpose_tpu_torch/csrc`` with
   ``nvcc``, in parallel;
3. holds each of the five kernel rows against its plain PyTorch version at
   the shapes its paths give it, in f32 (TF32 off) and bf16, and times both
   with CUDA events: fused attention, fused MLP and the DCN at the flagship
   shapes at B = 16 (eval) and B = 1 (inference); the fused-sampling DCN
   (the DCN's kernel in its make_pallas3 rounding mode) at the same shapes,
   and against the exact mode: in f32 the same function, in bf16 it must
   share its plain version's rounding far more often than the exact mode
   does; the token shift in its four modes, f32 and bf16, at (16, 256), at
   the attention's halo size (16 * 136, 6912) and at the shapes that stress
   its vector path (L not a multiple of a 16-byte vector, L odd, L shorter
   than a vector, R = 1, more rows than the grid, a view that starts off a
   16-byte boundary), where it must be exact, then timed in every mode at
   the halo size (eager and CUDA-graph replay, ``torch.roll`` beside
   ``rotate``, achieved TB/s); in bf16
   the fused MLP, the attention and both DCN modes also print the share of
   outputs that differ from their own plain version (the MLP and the exact
   DCN must stay at or below 5%); the fused kernels and the DCN are timed
   through weights packed once, as the model calls them; every row's ``ms``
   is CUDA events around eager calls, and the DCN (at B = 16 and B = 1, both
   modes, both dtypes) is also timed by replaying a CUDA graph of 20 calls
   (``graph_ms``), the device's time without the wrapper's host work;
4. runs the flagship decoded eval (HRNet-W48, 384x288, B = 16) from
   ``build_model`` in bf16 with bf16 weights, then in f32, checks the output
   shapes and values and the kernel launch counts (12 / 16 / 1 per forward),
   that the counted step packs no weights (the blocks and the model cache
   their packs, the DCN's included),
   and times the bf16 step in clips/s;
5. runs the flagship flip-test decoded eval in bf16 (two forwards a step:
   24 / 32 / 2 launches) and times it in clips/s;
6. runs the single-clip inference API (``PoseEstimator.infer_images``, B = 1,
   bf16) on five synthetic 720x1280 frames: a finite (17, 3) result and
   12 / 16 / 1 launches per call; prints the median latency of 20 calls and
   its preprocess / forward / decode split;
7. runs the two experiment tools as functions: one round of
   ``tools/exp_deform_fused`` (the DCN kernel's two rounding modes) and
   ``tools/probe_shift`` (every token-shift mode OK);
8. runs the tiny config on the GPU and on the CPU (plain versions) with the
   same weights (offset and mask convs calibrated, most DCN samples inside
   the image) and holds the decoded results against each other;
9. runs the eval CLI (``cli/eval.py::Eval("validate", args).eval()``) at
   flagship width and depth in bf16, B = 16, no flip, over a synthetic
   PoseTrack-format tree of 64 boxes made from a seed in a temporary
   directory (frames as uint8 arrays, cropped by the port's torch warp: the
   card's machine has no cv2), from a checkpoint of random weights saved in
   the reference's ``.pth`` layout, five times: an untimed first run with
   ``TPU.DEVICE_PREPROCESS full`` (the device warp; the process's first
   steps), then with the key left at the config's ``auto`` (the device
   loader in its crops mode), with ``off`` (the host loader) on four and on
   one loader thread, and with ``full`` again.  Each run: 12 / 16 / 1 launches a batch, one
   json a video, an AP table of 8 entries that is not perfect; the device
   loader's first batch equals the host loader's on the card, the auto
   run's AP table equals the off run's to 1e-9, the one-thread run agrees
   with the four-thread one, and the full run's AP is printed beside them.
   Prints boxes/s of each whole loop, the share of its wall time that the
   CUDA events around the steps span (the device busy, or waiting for the
   host's next launch) and the host's time in each step's launches.

10. holds the DCN's backward kernel (``csrc/deform_conv_bwd.cu``) against
    the plain version's autograd at the flagship shape (B = 8 in f32 and
    bf16, B = 1 in bf16), at offsets calibrated so that most samples fall
    inside the image: each of the five gradients' worst error over its peak
    (f32 1e-4, bf16 5e-2), in bf16 the share of elements that differ, two
    calls bit-equal in every gradient, the kernel's ms against the plain
    backward's and the bound;
11. checks that the fused attention, fused MLP and token shift raise on a
    CUDA tensor that requires grad (they have no backward);
12. runs the flagship train step (``configs/17/model_RSN.yaml`` at full
    width and depth, reference init, synthetic batches with Gaussian targets
    from ``ops/heatmap.py::generate_heatmaps``, some joints labelled and some
    not): first one step each in bf16 and f32 from copies of the initial
    model on one B = 2 batch (the two losses), then on one model and
    optimizer bf16 at B = 8 (2 warm-up steps, 5 timed), f32 at B = 2 (3
    steps) and bf16 at B = 16 with ``ACCUM_STEPS 2`` (1 step), each step's
    six metrics finite, its ms (CUDA events), clips/s, peak memory and
    launches (0 / 0 / 1 / 1 per micro-batch); then every trainable parameter
    must hold a finite gradient and every BN running stat must have moved;
13. runs one train step of the tiny config in f32 on the card and on the
    CPU from the same weights (mask convs calibrated, offset convs zeroed,
    dropout rates 0, SGD) and holds every gradient and every update against
    each other (1e-3 of its peak, 2e-2 for HRNet's stem and layer1, plus
    1e-6 of the largest, for gradients that are residues).

Each path (phases 4 to 7, 9 and 12) is driven with every launch count set to 0
just before it and read just after.  It prints a ``kernels`` JSON line, the
card line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
BATCH = 16
KERNEL_MODULES = ("fused_attn", "fused_mlp", "deform_conv", "deform_conv_fused", "token_shift")
FORWARD_COUNTS = {"fused_attn": 12, "fused_mlp": 16, "deform_conv": 1, "deform_conv_bwd": 0,
                  "deform_conv_fused": 0, "token_shift": 0}
# a train step's launches for each micro-batch: the fused kernels are eval-only
TRAIN_COUNTS = {"fused_attn": 0, "fused_mlp": 0, "deform_conv": 1, "deform_conv_bwd": 1,
                "deform_conv_fused": 0, "token_shift": 0}
DCN_DILATIONS = (3, 6, 9, 12, 15)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attn_case(dtype, gen, batch):
    """Flagship attention inputs.  In bf16 the q and k projection weights
    are drawn 4x and their biases 10x smaller, so that |S| stays near 10:
    the model rounds S to bf16 before the softmax (as the reference does),
    and where |S| is near 100 a bf16 ulp of S is 0.5, so two correct
    summation orders that round one score to neighbouring values move its
    attention weight by up to e^0.5 (seen on the chip: 0.3 at |S| = 75)."""
    import torch

    c, t = 136, 6912
    f = dict(device="cuda", dtype=torch.float32)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, **f) * scale  # noqa: E731
    args = [r(batch, c, t).to(dtype),
            1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    args += [r(c, 1, 3, scale=1 / math.sqrt(3)).to(dtype) for _ in range(3)]
    for _ in range(3):
        args += [1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    proj = []
    for p in range(3):
        small = dtype == torch.bfloat16 and p < 2
        proj += [r(c, c, 1, scale=(0.25 if small else 1.0) / math.sqrt(c)).to(dtype),
                 r(c, scale=0.01 if small else 0.1).to(dtype)]
    return args + proj + [2]


def mlp_case(dtype, gen, t, batch):
    import torch

    c = 136
    f = dict(device="cuda", dtype=torch.float32)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, **f) * scale  # noqa: E731
    return [r(batch, c, t).to(dtype), 1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1),
            r(4 * c, c, 1, scale=1 / math.sqrt(c)).to(dtype), r(4 * c, scale=0.1).to(dtype),
            r(c, 4 * c, 1, scale=1 / math.sqrt(4 * c)).to(dtype), r(c, scale=0.1).to(dtype)]


def dcn_case(dtype, gen, batch):
    import torch

    c, h, w, dil = 17, 96, 72, (3, 6, 9, 12, 15)
    f = dict(device="cuda", dtype=torch.float32)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, **f) * scale  # noqa: E731
    x = r(batch, c, h, w).to(dtype)
    offs = [r(batch, 18 * c, h, w, scale=2.0).to(dtype) for _ in dil]
    masks = [r(batch, 9 * c, h, w).to(dtype) for _ in dil]
    weights = r(len(dil), c, c, 3, 3, scale=1 / math.sqrt(9 * c)).to(dtype)
    biases = r(len(dil), c, scale=0.1)
    return [x, offs, masks, weights, biases, dil]


def work(name, args):
    """(bytes, operations, peak rate of those operations) the function needs:
    matrix products at the tensor-core bf16 rate, or the f32 rate outside
    the tensor cores in f32 (TF32 is off); the deformable conv's sampling
    and FMAs are scalar f32 work."""
    import torch

    mm_peak = PEAK_F32 if args[0].dtype == torch.float32 else PEAK_BF16
    if name == "fused_attn":
        x = args[0]
        b, c, t = x.shape
        hs = c // args[-1]
        ops = 3 * 2 * c * c * t * b + 2 * (2 * c * hs * t * b)
        return 2 * nbytes(x), ops, mm_peak
    if name == "fused_mlp":
        x, w1 = args[0], args[3]
        b, c, t = x.shape
        return 2 * nbytes(x), 2 * 2 * c * w1.shape[0] * t * b, mm_peak
    x, offs, masks, weights = args[:4]
    b, c, h, w = x.shape
    d, o = weights.shape[:2]
    samples = d * 9 * c * b * h * w
    # per sample: bilinear weights and 4 corners (~11 flops), mask, O FMAs
    ops = samples * (12 + 2 * o)
    moved = nbytes(x, *offs, *masks, weights) + b * o * h * w * x.element_size()
    return moved, ops, PEAK_F32


def attn_f64_errors(args, got, want):
    """max|kernel - ref| and max|plain - ref|, where ref runs the plain f32
    front (LN, depthwise, LN, projections) and then the scores, softmax and
    att @ v in f64."""
    import torch

    from otpose_tpu_torch.models import core

    (x, l1w, l1b, dq, dk, dv, nqw, nqb, nkw, nkb, nvw, nvb,
     wq, bq, wk, bk, wv, bv, n_head) = args
    n = core.layer_norm_ct(x, l1w, l1b)
    q, k, v = (core.dense_1x1_ct(core.layer_norm_ct(core.depthwise_conv1d_k3_ct(n, dw), nw, nb),
                                 w, b)
               for dw, nw, nb, w, b in ((dq, nqw, nqb, wq, bq), (dk, nkw, nkb, wk, bk),
                                        (dv, nvw, nvb, wv, bv)))
    b, c, t = q.shape
    hs = c // n_head
    qs = (q * q.new_tensor(1 / math.sqrt(hs))).double().reshape(b, n_head, hs, t)
    s64 = qs @ k.double().reshape(b, n_head, hs, t).transpose(-1, -2)
    ref = (torch.softmax(s64, -1) @ v.double().reshape(b, n_head, hs, t)).reshape(b, c, t)
    return ((got.double() - ref).abs().max().item(), (want.double() - ref).abs().max().item())


def packed_call(name, kern, args):
    """A call of ``kern`` on ``args`` through weights packed once, as the
    model makes them (the DCN's pack serves both of its modes)."""
    from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp

    x, dtype = args[0], args[0].dtype
    if name in ("deform_conv", "deform_conv_fused"):
        pk = deform_conv.pack_dcn_weights(args[3], args[4])
        return lambda: kern(*args[:3], dilations=args[5], packed=pk)
    if name == "fused_mlp":
        pk = fused_mlp.pack_mlp_weights(*args[1:], dtype)
        return lambda: fused_mlp.fused_mlp_residual_ct(x, packed=pk)
    if name == "fused_attn":
        pk = fused_attn.pack_attn_weights(*args[1:-1], dtype)
        return lambda: fused_attn.fused_attn_ct(x, packed=pk, n_head=args[-1])
    return lambda: kern(*args)


def check_kernels():
    import torch

    from otpose_tpu_torch.ops.cuda import deform_conv, deform_conv_fused, fused_attn, fused_mlp
    from otpose_tpu_torch.utils.timing import graph_ms, time_ms

    kernels = {
        "fused_attn": (fused_attn.fused_attn_ct, fused_attn.fused_attn_plain,
                       "otpose_tpu_torch/csrc/fused_attn.cu",
                       "otpose_tpu/ops/pallas/fused_attn.py:196"),
        "fused_mlp": (fused_mlp.fused_mlp_residual_ct, fused_mlp.fused_mlp_plain,
                      "otpose_tpu_torch/csrc/fused_mlp.cu",
                      "otpose_tpu/ops/pallas/fused_mlp.py:87"),
        "deform_conv": (deform_conv.modulated_deform_conv_multi,
                        deform_conv.modulated_deform_conv_multi_plain,
                        "otpose_tpu_torch/csrc/deform_conv.cu",
                        "otpose_tpu/ops/deform_conv.py:276"),
        "deform_conv_fused": (deform_conv_fused.deform_conv_fused,
                              deform_conv_fused.deform_conv_fused_plain,
                              "otpose_tpu_torch/csrc/deform_conv.cu",
                              "tools/exp_deform_pallas3.py:50"),
    }
    # tolerance on max|kernel - plain| as a share of max(1, max|plain|).
    # f32: the two differ by summation order, and the plain attention's
    # cuBLAS score sum over T = 6912 (|S| in the hundreds) errs by ~1e-4 of
    # the output's peak itself, which attn_f64_errors shows; bf16: a one-ulp
    # rounding flip where the two sums land on either side of a bf16
    # boundary, the tolerance of the JAX package's bf16 kernel tests.
    tol = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, shares, dcn_ms, dcn_graph_ms = {}, {}, {}, {}
    for name, (kern, plain, src, replaces) in kernels.items():
        for dtype in (torch.float32, torch.bfloat16):
            # the eval's batch first (the timed case), then the inference API's
            cases = [case for batch in (BATCH, 1) for case in (
                [mlp_case(dtype, gen, t, batch) for t in (6912, 3456, 1728)]
                if name == "fused_mlp" else
                [attn_case(dtype, gen, batch) if name == "fused_attn"
                 else dcn_case(dtype, gen, batch)])]
            for i, args in enumerate(cases):
                got = kern(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1.0, want.float().abs().max().item())
                ok = math.isfinite(err) and err <= tol[dtype] * scale
                shape = tuple(args[0].shape)
                log(f"check {name} {str(dtype)[6:]} x{shape}: max_abs_err {err:.3e} "
                    f"(tolerance {tol[dtype]:.0e} x {scale:.3g}) {'ok' if ok else 'FAILED'}")
                if not ok:
                    fail(f"{name} {dtype} disagrees with its plain version")
                if name == "fused_attn" and dtype == torch.float32:
                    k_err, p_err = attn_f64_errors(args, got, want)
                    log(f"check fused_attn float32 against an f64 score/softmax tail: kernel "
                        f"{k_err:.3e}, plain {p_err:.3e} (kernel tolerance 1e-04 x {scale:.3g})")
                    if not k_err <= 1e-4 * scale:
                        fail("fused_attn f32 disagrees with the f64 reference")
                if name in ("fused_attn", "fused_mlp") and dtype == torch.bfloat16:
                    # the max error cannot see a dropped rounding point (it
                    # stays within an ulp of the peak); the share of outputs
                    # that differ can.  The MLP's two products accumulate in
                    # f32 on both sides, so only summation-order flips remain;
                    # in the attention one flipped bf16 score moves a whole
                    # softmax row, so its share is printed with no limit.
                    share = (got != want).float().mean().item()
                    shares.setdefault(name, {})[f"{shape}"] = share
                    log(f"check {name} bfloat16 rounding x{shape}: outputs that differ from "
                        f"the plain version: {share:.4%}"
                        + (" (limit 5%)" if name == "fused_mlp" else " (no limit)"))
                    if name == "fused_mlp" and not share <= 0.05:
                        fail("fused_mlp bf16 does not round as its plain version does")
                if name == "deform_conv_fused" and dtype == torch.float32:
                    # in f32 the two modes of the DCN kernel are one function
                    shipped = deform_conv.modulated_deform_conv_multi(*args)
                    d_err = (got - shipped).abs().max().item()
                    log(f"check deform_conv_fused float32 against the exact mode: "
                        f"{d_err:.3e} (tolerance 1e-03 x {scale:.3g})")
                    if not d_err <= 1e-3 * scale:
                        fail("deform_conv_fused f32 disagrees with the exact mode")
                if name == "deform_conv" and dtype == torch.bfloat16:
                    # the exact mode rounds once, as its plain version does:
                    # only summation-order flips may remain
                    share = (got != want).float().mean().item()
                    shares.setdefault(name, {})[f"{shape}"] = share
                    log(f"check deform_conv bfloat16 rounding x{shape}: outputs "
                        f"that differ from the plain version: {share:.4%} (limit 5%)")
                    if not share <= 0.05:
                        fail("deform_conv bf16 does not round as its plain version does")
                if name == "deform_conv_fused" and dtype == torch.bfloat16:
                    # bf16 outputs a rounding apart differ by one ulp, inside
                    # the tolerance above whatever the rounding points, so
                    # count the outputs that differ: this mode rounds where
                    # its plain version does, the exact mode does not
                    shipped = deform_conv.modulated_deform_conv_multi(*args)
                    own = (got != want).float().mean().item()
                    other = (shipped != want).float().mean().item()
                    shares.setdefault(name, {})[f"{shape}"] = own
                    log(f"check deform_conv_fused bfloat16 rounding x{shape}: "
                        f"outputs that differ from the plain version: kernel {own:.4%}, exact "
                        f"mode {other:.4%} (kernel must stay below a tenth of the other)")
                    if not own < 0.1 * other:
                        fail("deform_conv_fused bf16 does not round as its plain version does")
                # time the eval's case, and the DCN's inference case too
                dcn = name in ("deform_conv", "deform_conv_fused")
                if i == 0 or (dcn and i == len(cases) - 1):
                    call = packed_call(name, kern, args)
                    if name in ("fused_mlp", "deform_conv") and not torch.equal(call(), got):
                        fail(f"{name} {dtype}: the packed-weight call differs from the "
                             "raw-weight call")
                    ms = time_ms(call, iters=20)
                    # the DCN by graph replay too: at B = 1 eager calls time
                    # the wrapper's host work as well as the kernel
                    gms = graph_ms(call) if dcn else None
                    plain_ms = time_ms(lambda: plain(*args), iters=3)
                    moved, ops, peak = work(name, args)
                    t_bytes, t_ops = moved / PEAK_BYTES * 1e3, ops / peak * 1e3
                    bound = max(t_bytes, t_ops)
                    log(f"time {name} {str(dtype)[6:]} B={shape[0]}: kernel {ms:.4f} ms"
                        + (f" (graph replay {gms:.4f} ms)" if dcn else "")
                        + f", plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({moved / 1e6:.1f} MB,"
                        f" {ops / 1e9:.2f} GFLOP; {bound / ms:.1%} of it)")
                    if dtype == torch.bfloat16 and i == 0:
                        rows[name] = dict(
                            name=name, route="cuda", source=src, replaces=replaces,
                            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by="bytes" if t_bytes >= t_ops else "operations",
                            library_ms=None)
                        if dcn:
                            rows[name]["graph_ms"] = gms
                    elif dtype == torch.bfloat16:
                        rows[name].update(ms_b1=ms, plain_ms_b1=plain_ms, bound_ms_b1=bound)
                        if dcn:
                            rows[name]["graph_ms_b1"] = gms
                    if dcn:
                        case = f"{str(dtype)[6:]} B={shape[0]}"
                        dcn_ms.setdefault(name, {})[case] = ms
                        dcn_graph_ms.setdefault(name, {})[case] = gms
    for name, by_shape in shares.items():
        rows[name]["bf16_differ_share"] = by_shape
    for name, by_case in dcn_ms.items():
        rows[name]["ms_by_case"] = by_case
        rows[name]["graph_ms_by_case"] = dcn_graph_ms[name]
    return rows


# token-shift shapes beyond the probe's (16, 256) and the halo size: L not a
# multiple of a 16-byte vector, L odd, L shorter than one vector, R = 1, more
# rows than the grid's 65535, a row of more than one chunk
SHIFT_SHAPES = ((16, 256), (16, 250), (3, 6911), (5, 129), (1, 1), (1, 2), (2, 7), (1, 8),
                (1, 6912), (70000, 24), (7, 4099))


def check_token_shift():
    """Every mode of the token shift against its plain version, exactly, in
    bf16 and f32, at ``SHIFT_SHAPES``, at the attention's halo size and on
    views that start 1 and 3 elements off a 16-byte boundary (the
    element-wise kernel); then ``tools/probe_shift.py::time_modes`` at the
    halo size in bf16.  The JSON row times the ``rotate`` mode, the one that
    a single PyTorch call (``torch.roll``) computes; its ``max_abs_err`` is
    the largest over every case."""
    import torch

    from otpose_tpu_torch.ops.cuda import token_shift
    from otpose_tpu_torch.tools import probe_shift

    gen = torch.Generator(device="cuda").manual_seed(6)
    halo = probe_shift.HALO
    err, cases = 0.0, 0
    for shape in SHIFT_SHAPES + (halo,):
        for dtype in (torch.float32, torch.bfloat16):
            base = torch.randn(shape[0] * shape[1] + 8, generator=gen, device="cuda").to(dtype)
            for offset in (0, 1, 3):
                x = base[offset:offset + shape[0] * shape[1]].view(*shape)
                for mode in token_shift.MODES:
                    got = token_shift.token_shift(x, mode)
                    want = token_shift.token_shift_plain(x, mode)
                    torch.cuda.synchronize()
                    err = max(err, (got.float() - want.float()).abs().max().item())
                    cases += 1
                    if not torch.equal(got, want):
                        fail(f"token_shift {mode} {dtype} {shape} at offset {offset} differs "
                             "from its plain version")
    log(f"check token_shift: {cases} cases (4 modes x f32, bf16 x {len(SHIFT_SHAPES) + 1} "
        "shapes x 3 offsets from a 16-byte boundary) exact")
    res = probe_shift.time_modes(halo, torch.bfloat16)
    probe_shift.report(res, out=log)
    rot = res["rotate"]
    for mode in token_shift.MODES:
        if not res[mode]["graph_ms"] >= res[mode]["bound_ms"]:
            fail(f"token_shift {mode}: {res[mode]['graph_ms']:.4f} ms is under its bound of "
                 f"{res[mode]['bound_ms']:.4f} ms: the timing loop reads a warm cache")
    return dict(name="token_shift", route="cuda", source="otpose_tpu_torch/csrc/token_shift.cu",
                replaces="tools/probe_shift.py:25", launches=None, max_abs_err=err, ms=rot["ms"],
                plain_ms=rot["plain_ms"], bound_ms=rot["bound_ms"], bound_by="bytes",
                library_ms=res["roll"]["ms"], graph_ms=rot["graph_ms"],
                library_graph_ms=res["roll"]["graph_ms"], mode="rotate",
                modes={m: {k: res[m][k] for k in ("ms", "graph_ms", "plain_ms", "bound_ms", "tbps")}
                       for m in token_shift.MODES})


# ---------------------------------------------------------------------------
# phases 4 to 9: the paths
# ---------------------------------------------------------------------------

def _kernel_modules():
    import importlib

    return {name: importlib.import_module(f"otpose_tpu_torch.ops.cuda.{name}")
            for name in KERNEL_MODULES}


def reset_counts():
    mods = _kernel_modules()
    for mod in mods.values():
        mod.calls = mod.launches = 0
    mods["deform_conv"].bwd_launches = 0


def read_counts():
    mods = _kernel_modules()
    counts = {name: mod.launches for name, mod in mods.items()}
    counts["deform_conv_bwd"] = mods["deform_conv"].bwd_launches
    return counts


def read_packs():
    """Weight packs made so far by the kernels whose weights are packed."""
    mods = _kernel_modules()
    return {name: mods[name].packs for name in ("fused_attn", "fused_mlp", "deform_conv")}


def flagship_eval():
    import torch

    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.models.otpose import prepare_eval_params
    from otpose_tpu_torch.utils.testing import flagship_otpose_cfg

    cfg = flagship_otpose_cfg()
    t0 = time.perf_counter()
    spec, model = build_model(cfg, seed=0)
    log(f"flagship model built on {next(model.parameters()).device} in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(1)
    w, h = cfg.MODEL.IMAGE_SIZE
    inputs = torch.randn(BATCH, h, w, 15, generator=gen, device="cuda")
    margin = torch.randint(0, 3, (BATCH, 4), generator=gen, device="cuda").float()
    j = spec.num_joints
    want_counts = FORWARD_COUNTS
    results = {}
    f32_model = copy.deepcopy(model)
    prepare_eval_params(model, torch.bfloat16)
    for label, m, dtype in (("bf16", model, torch.bfloat16), ("f32", f32_model, torch.float32)):
        step = make_decoded_eval_step(m, compute_dtype=dtype)
        step(inputs, margin)                   # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        reset_counts()
        packs = read_packs()
        coords, maxvals, raw = step(inputs, margin)
        torch.cuda.synchronize()
        counts = read_counts()
        packed = {k: v - packs[k] for k, v in read_packs().items()}
        log(f"flagship {label}: launches {counts}; weight packs in the step {packed}")
        if counts != want_counts:
            fail(f"flagship {label} launches {counts}, expected {want_counts}")
        if any(packed.values()):
            fail(f"flagship {label}: a steady forward packed weights {packed}")
        for name, t, shape in (("coords", coords, (BATCH, j, 2)), ("maxvals", maxvals, (BATCH, j, 1)),
                               ("raw_coords", raw, (BATCH, j, 2))):
            if tuple(t.shape) != shape or not torch.isfinite(t).all():
                fail(f"flagship {label} {name}: shape {tuple(t.shape)} or non-finite values")
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            step(inputs, margin)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / iters
        log(f"flagship {label}: {sec * 1e3:.2f} ms per step of {BATCH} clips, "
            f"{BATCH / sec:.3f} clips/s")
        results[label] = dict(counts=counts, clips_per_s=BATCH / sec,
                              peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                              coords=coords.float().cpu(), maxvals=maxvals.float().cpu())
    # bf16 (bf16 weights) against f32 keypoints on the same clips: the
    # reference init's heatmaps are nearly flat, so ties and near-ties move
    same = (results["bf16"]["coords"] == results["f32"]["coords"]).all(-1).float().mean().item()
    log(f"flagship bf16 against f32 decoded keypoints: {same:.2%} identical, maxvals differ by "
        f"{(results['bf16']['maxvals'] - results['f32']['maxvals']).abs().max().item():.3e} at "
        f"most (peak {results['f32']['maxvals'].abs().max().item():.3e})")
    results["flip"] = flip_eval(model, inputs, margin, j)
    results["model"] = (cfg, model)
    return results


def flip_eval(model, inputs, margin, j):
    """The flip-test decoded eval in bf16 on the bf16-weight flagship model:
    two forwards a step, so twice the forward's launches."""
    import torch

    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step

    step = make_decoded_eval_step(model, compute_dtype=torch.bfloat16, flip=True)
    step(inputs, margin)
    torch.cuda.synchronize()
    reset_counts()
    coords, maxvals, raw = step(inputs, margin)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: 2 * v for k, v in FORWARD_COUNTS.items()}
    log(f"flagship flip bf16: launches {counts}")
    if counts != want:
        fail(f"flagship flip launches {counts}, expected {want}")
    for name, t, shape in (("coords", coords, (BATCH, j, 2)), ("maxvals", maxvals, (BATCH, j, 1)),
                           ("raw_coords", raw, (BATCH, j, 2))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            fail(f"flagship flip {name}: shape {tuple(t.shape)} or non-finite values")
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        step(inputs, margin)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / iters
    log(f"flagship flip bf16: {sec * 1e3:.2f} ms per step of {BATCH} clips, "
        f"{BATCH / sec:.3f} clips/s")
    return dict(counts=counts, clips_per_s=BATCH / sec)


def inference_api(cfg, model):
    """``PoseEstimator.infer_images`` at B = 1 in bf16 on five synthetic
    720x1280 uint8 frames: one call's launches, then the median latency of
    20 calls and of 20 split ones (preprocess, forward, decode), each part
    ending in a synchronise."""
    import numpy as np
    import torch

    from otpose_tpu_torch.cli.inference import PoseEstimator
    from otpose_tpu_torch.ops.heatmap import get_final_preds

    est = PoseEstimator(cfg, model)
    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(5)]
    box, margin = [500, 120, 260, 420], (1, 1, 2, 2)
    est.infer_images(frames, box, margin)
    torch.cuda.synchronize()
    reset_counts()
    out = est.infer_images(frames, box, margin)
    counts = read_counts()
    log(f"inference B=1 bf16: launches {counts} per call")
    if counts != FORWARD_COUNTS:
        fail(f"inference launches {counts}, expected {FORWARD_COUNTS}")
    if out.shape != (17, 3) or not np.isfinite(out).all():
        fail(f"inference result: shape {out.shape} or non-finite values")
    total, split = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        est.infer_images(frames, box, margin)
        total.append(time.perf_counter() - t0)
    for _ in range(20):
        t0 = time.perf_counter()
        x, center, scale = est.preprocess(frames, box)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        heat = est.forward(x, margin)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        get_final_preds(heat, center[None], scale[None])
        split.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    med = lambda v: float(np.median(v)) * 1e3  # noqa: E731
    res = dict(counts=counts, latency_ms=med(total), preprocess_ms=med([s[0] for s in split]),
               forward_ms=med([s[1] for s in split]), decode_ms=med([s[2] for s in split]))
    log(f"inference latency B=1 ms: {res['latency_ms']:.3f} (median of 20 calls); split: "
        f"preprocess {res['preprocess_ms']:.3f}, forward {res['forward_ms']:.3f}, "
        f"decode {res['decode_ms']:.3f} ms")
    return res


def tools():
    """The two experiment tools, called as functions, each its own path."""
    import torch

    from otpose_tpu_torch.tools import exp_deform_fused, probe_shift

    reset_counts()
    result = exp_deform_fused.run(batch=BATCH, dtype=torch.bfloat16, rounds=1, iters=5,
                                  out=lambda s: log(f"exp_deform_fused: {s}"))
    exp_counts = read_counts()
    if not result["maxdiff"] <= 5e-2 * max(1.0, result["scale"]):
        fail("exp_deform_fused: the DCN kernel's two modes disagree")
    reset_counts()
    ok = probe_shift.probe(out=lambda s: log(f"probe_shift: {s}"))
    probe_counts = read_counts()
    if not all(ok.values()):
        fail(f"probe_shift: {ok}")
    log(f"tools: launches exp_deform_fused {exp_counts}, probe_shift {probe_counts}")
    if exp_counts["deform_conv_fused"] < 1 or probe_counts["token_shift"] != 4:
        fail("the tools did not launch their kernels")
    return {"exp_deform_fused": exp_counts, "probe_shift": probe_counts}


def _scaled_weights_(model, seed: int):
    """Weights of std 1/sqrt(fan_in) so the tiny model's heatmaps are O(1)
    (the reference init's are ~1e-19); norm params and BN stats stay 1/0."""
    import torch

    from otpose_tpu_torch.models.jax_bridge import is_channel_param

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2 and not is_channel_param(name):
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p[0].numel()))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))


def tiny_agreement():
    import torch

    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.models.otpose import otpose_forward
    from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

    _, gpu_model = build_model(tiny_otpose_cfg(), seed=2)
    _scaled_weights_(gpu_model, 2)
    _calibrate_refinement_(gpu_model, 2)
    cpu_model = copy.deepcopy(gpu_model).cpu()
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 64, 64, 15, generator=gen)
    margin = torch.tensor([[1.0, 1, 2, 2], [1, 0, 2, 0]])
    with torch.no_grad():
        want = otpose_forward(cpu_model, x, margin)
        reset_counts()
        got = otpose_forward(gpu_model, x.cuda(), margin.cuda())
        torch.cuda.synchronize()
    counts = read_counts()
    if counts != dict(FORWARD_COUNTS, fused_attn=4, fused_mlp=6):
        fail(f"tiny run launches {counts}")
    worst = 0.0
    for g, w in zip(got, want):
        err = (g.cpu() - w).abs().max().item() / max(1.0, w.abs().max().item())
        worst = max(worst, err)
    log(f"tiny f32 GPU (kernels) vs CPU (plain): worst error {worst:.3e} of the peak")
    if not worst <= 1e-3:
        fail("tiny GPU forward disagrees with the CPU plain path")
    c_gpu = make_decoded_eval_step(gpu_model)(x.cuda(), margin.cuda())
    c_cpu = make_decoded_eval_step(cpu_model)(x, margin)
    heat = want[0].permute(0, 3, 1, 2).reshape(2, 17, -1)
    top2 = heat.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3
    same = (c_gpu[0].cpu() == c_cpu[0]).all(-1)
    log(f"tiny decoded coords equal on {int((same & clear).sum())}/{int(clear.sum())} "
        "clear peaks")
    if not bool(same[clear].all()):
        fail("tiny decoded coords differ between GPU and CPU")


def _calibrate_refinement_(model, seed: int) -> float:
    """Scale the offset and mask convs so that, on a random clip, the DCN's
    offsets have a deviation of 2 pixels and its masks of 1: at the O(1)
    weight scales of ``_scaled_weights_`` the refinement's features reach the
    thousands, every sample would leave the image and the heatmaps would be
    flat.  Returns the share of the DCN's samples inside the image after."""
    import torch

    from otpose_tpu_torch.utils.testing import dcn_inside_share

    seen = {"offsets": [], "masks": []}
    hooks = [m["0"].register_forward_hook(
        lambda _m, _i, out, key=key: seen[key].append(out.float()))  # the output stays
        for key, convs in (("offsets", model.offsets_list), ("masks", model.masks_list))
        for m in convs]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w, h = model.spec.pe_w * 4, model.spec.pe_h * 4
    x = torch.randn(2, h, w, 15, generator=gen, device="cuda")
    with torch.no_grad():
        model(x, torch.ones(2, 4, device="cuda"))
        std = {key: seen[key][0].std().item() for key in seen}
        for convs, key, target in ((model.offsets_list, "offsets", 2.0),
                                   (model.masks_list, "masks", 1.0)):
            for m in convs:
                for p in m["0"].parameters():
                    p.mul_(target / std[key])
        for v in seen.values():
            v.clear()
        model(x, torch.ones(2, 4, device="cuda"))
    for hook in hooks:
        hook.remove()
    offs = seen["offsets"]
    shape = (offs[0].shape[0], model.spec.num_joints) + tuple(offs[0].shape[2:])
    inside = dcn_inside_share((torch.empty(shape, device=offs[0].device), offs, None, None, None,
                               model.spec.dilations))
    log(f"refinement calibrated: offsets' deviation {std['offsets']:.3g} -> 2, masks' "
        f"{std['masks']:.3g} -> 1; {inside:.1%} of the DCN's samples inside the image")
    if not inside > 0.5:
        fail("the calibrated refinement samples mostly outside the image")
    return inside


def _first_batch(loader):
    it = iter(loader)
    try:
        return next(it)[0]
    finally:
        it.close()


def eval_cli(seed: int = 0):
    """``Eval("validate", args).eval()`` on the card over a synthetic tree of
    64 boxes: index, window selection, metas, loader, pipelined forward,
    device decode, back-projection, json writing and poseval AP are the
    port's own code; only the frames come as arrays.  Runs: the yaml's
    ``TPU.DEVICE_PREPROCESS`` left at ``auto`` (the device loader, crops),
    ``off`` (the host loader) with four and with one loader thread, and
    ``full`` (the device warp)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from otpose_tpu_torch.cli.eval import Eval
    from otpose_tpu_torch.config import default_parse_args
    from otpose_tpu_torch.data.device_loader import DeviceLoader
    from otpose_tpu_torch.data.loader import Loader
    from otpose_tpu_torch.data.synthetic import ArrayFramesDataset, make_synthetic_posetrack
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.utils.testing import flagship_otpose_cfg

    class TimedEval(Eval):
        """Eval whose steps are bracketed by CUDA events and by the host's
        clock (the time the host spends launching a step), and which notes
        when its model was loaded (the loop starts there)."""

        def _load(self, model_file):
            model = super()._load(model_file)
            torch.cuda.synchronize()
            self.loaded_at = time.perf_counter()
            return model

        def make_step(self, model):
            step, self.events, self.launch_s = super().make_step(model), [], []

            def timed(inputs, margin):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                out = step(inputs, margin)
                end.record()
                self.launch_s.append(time.perf_counter() - t0)
                self.events.append((start, end))
                return out

            return timed

    root = tempfile.mkdtemp(prefix="otpose_eval_cli_")
    try:
        t0 = time.perf_counter()
        json_dir, img_dir, annot_dir = make_synthetic_posetrack(
            root, num_videos=4, frames_per_video=8, people_per_frame=2, img_w=640, img_h=480,
            seed=seed)
        cfg = flagship_otpose_cfg()
        cfg.EXPERIMENT_NAME = "chip_smoke"
        cfg.OUTPUT_DIR = os.path.join(root, "output")
        cfg.DATASET.NAME = "PoseTrack"
        cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR, cfg.DATASET.TEST_IMG_DIR = (
            json_dir, img_dir, img_dir)
        cfg.VAL.ANNOT_DIR = annot_dir
        cfg.VAL.USE_GT_BBOX = True
        cfg.VAL.BATCH_SIZE_PER_GPU = BATCH
        cfg.VAL.FLIP_VAL = False
        cfg.VAL.MODEL_FILE = os.path.join(root, "random_weights.pth")
        cfg.WORKERS = 4
        cfg.TPU.COMPUTE_DTYPE = "bfloat16"
        cfg.TPU.PARAM_DTYPE = "bfloat16"
        if cfg.TPU.DEVICE_PREPROCESS != "auto":
            fail(f"eval CLI: the flagship config sets TPU.DEVICE_PREPROCESS "
                 f"{cfg.TPU.DEVICE_PREPROCESS!r}, not the repository's auto")
        yaml_path = os.path.join(root, "flagship.yaml")
        with open(yaml_path, "w") as fh:
            fh.write(cfg.dump())
        _, model = build_model(cfg, seed=seed)
        _scaled_weights_(model, seed)
        _calibrate_refinement_(model, seed)
        torch.save({"state_dict": model.state_dict()}, cfg.VAL.MODEL_FILE)
        del model
        log(f"eval CLI: tree of 32 frames of 480x640 and the checkpoint written in "
            f"{time.perf_counter() - t0:.1f} s")

        # quoted: on a command line a bare off is YAML's false, not the mode
        OFF = "'off'"

        def make(opts):
            return TimedEval("validate",
                             default_parse_args(["--cfg", yaml_path, "--root_dir", root, *opts]),
                             dataset_cls=ArrayFramesDataset)

        # the device loader's first batch against the host loader's: the same
        # host warp, so the same pixels; the targets drawn on the card
        dev_b = _first_batch(make([]).loader)
        host_b = _first_batch(make(["TPU.DEVICE_PREPROCESS", OFF]).loader)
        for k in ("inputs", "target", "target_weight", "margin"):
            want = torch.from_numpy(np.asarray(host_b[k])).to("cuda")
            got = dev_b[k]
            err = (got.float() - want.float()).abs().max().item()
            if got.device.type != "cuda" or got.shape != want.shape or not err <= (
                    0.0 if k in ("inputs", "margin") else 1e-6):
                fail(f"eval CLI: the device loader's {k} is {tuple(got.shape)} on {got.device}, "
                     f"{err:.3e} from the host loader's")
        log("eval CLI: the device loader's first batch equals the host loader's on the card "
            "(inputs and margins bit-equal, targets and weights to 1e-6)")

        runs = []
        # a first run takes the process's first steps (cuDNN's choices, the
        # weight packs, the allocator's growth): full, the device warp, once
        # untimed; then auto (the device loader, crops) and off (the host
        # loader) on four loader threads, off on one thread (what the
        # loader's threads cost the thread that launches the steps), full
        for label, opts, workers, kind in (
                ("full", ["TPU.DEVICE_PREPROCESS", "full"], 4, "full"),
                ("auto", [], 4, "crops"), ("off", ["TPU.DEVICE_PREPROCESS", OFF], 4, "off"),
                ("off", ["TPU.DEVICE_PREPROCESS", OFF], 1, "off"),
                ("full", ["TPU.DEVICE_PREPROCESS", "full"], 4, "full")):
            ev = make([*opts, "WORKERS", str(workers)])
            loader_kind = (ev.loader.mode if isinstance(ev.loader, DeviceLoader)
                           else "off" if type(ev.loader) is Loader else "?")
            if loader_kind != kind:
                fail(f"eval CLI under {label}: loader {type(ev.loader).__name__} "
                     f"({loader_kind}), expected {kind}")
            kept = {}
            inner = ev.dataset.evaluate

            def spy(cfg_, preds, *args, inner=inner, kept=kept, **kwargs):
                kept["preds"] = np.array(preds)
                return inner(cfg_, preds, *args, **kwargs)

            ev.dataset.evaluate = spy
            boxes, batches = len(ev.dataset), len(ev.loader)
            if boxes < 64 or ev.batch != BATCH or ev.device.type != "cuda":
                fail(f"eval CLI: {boxes} boxes in batches of {ev.batch} on {ev.device}")
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            results = ev.eval()
            torch.cuda.synchronize()
            total, wall = time.perf_counter() - t0, time.perf_counter() - ev.loaded_at
            counts = read_counts()
            want = {k: v * batches for k, v in FORWARD_COUNTS.items()}
            if counts != want:
                fail(f"eval CLI launches {counts}, expected {want} over {batches} batches")
            if len(results) != 1 or len(ev.events) != batches:
                fail(f"eval CLI: {len(results)} results, {len(ev.events)} steps")
            _, name_values, mean_ap = results[0]
            table = np.asarray(list(name_values.values()), np.float64)
            out_dir = os.path.join(ev.cfg.OUTPUT_DIR, "val_set_json_results")
            files = sorted(os.listdir(out_dir))
            for name in files:
                with open(os.path.join(out_dir, name)) as fh:
                    if len(json.load(fh)["annolist"]) != 8:
                        fail(f"eval CLI: {name} does not hold 8 frames")
            if len(files) != 4 or files != sorted(os.listdir(annot_dir)):
                fail(f"eval CLI: json files {files}")
            if table.shape != (8,) or np.isinf(table).any() or not np.isfinite(table).any():
                fail(f"eval CLI: AP table {table}")
            if not np.nanmin(table) < 99.0 or not np.isfinite(kept["preds"]).all():
                fail(f"eval CLI: a perfect table from random weights, or non-finite "
                     f"keypoints: {table}")
            spans = [s.elapsed_time(e) * 1e-3 for s, e in ev.events]
            span = sum(spans)
            log(f"eval CLI TPU.DEVICE_PREPROCESS {label} ({kind}), {workers} loader thread(s): "
                f"{boxes} boxes; the loop (loader, {batches} steps, decode, "
                f"json, poseval) took {wall:.3f} s, {boxes / wall:.3f} boxes/s ({total:.3f} s "
                f"with the model's build and load); the steps' CUDA events span {span:.3f} s, "
                f"{span / wall:.1%} of the loop's wall time ("
                + ", ".join(f"{v:.3f}" for v in spans) + " s), and the host spent "
                + ", ".join(f"{v:.3f}" for v in ev.launch_s) + f" s launching them; launches "
                f"{counts}; AP " + " ".join(f"{k} {v:.4f}" for k, v in name_values.items()))
            runs.append(dict(counts=counts, boxes_per_s=boxes / wall, step_span_share=span / wall,
                             workers=workers, preprocess=label, loader=kind,
                             table=table, preds=kept["preds"], wall_s=wall, batches=batches))
        runs = runs[1:]   # the warm-up run's readings are not kept
        auto, off4, off1, full = runs

        def agreement(a, b):
            same = (a["preds"][..., :2] == b["preds"][..., :2]).all(-1).mean()
            diff = np.nanmax(np.abs(a["table"] - b["table"]))
            nan_same = (np.isnan(a["table"]) == np.isnan(b["table"])).all()
            return same, diff, nan_same

        same, diff, nan_same = agreement(auto, off4)
        log(f"eval CLI: auto (device loader) against off (host loader): {same:.2%} of keypoints "
            f"identical, AP tables differ by at most {diff:.3e} (limit 1e-9)")
        if not (diff <= 1e-9 and nan_same):
            fail("eval CLI: the device loader's AP table differs from the host loader's")
        # the fused attention sums its score tiles with f32 atomics, so two
        # runs differ in the last bits and a near-tied argmax may move by a
        # cell: the runs must agree on nearly every keypoint, and on the
        # table up to what those few can move
        same, diff, nan_same = agreement(off4, off1)
        log(f"eval CLI: off with one loader thread against four: {same:.2%} of keypoints "
            f"identical, AP table differs by at most {diff:.4f}")
        if not (same >= 0.98 and diff <= 1.0 and nan_same):
            fail("eval CLI: two runs on the same seed disagree")
        same, diff, _ = agreement(full, off4)
        log(f"eval CLI: full (the device warp) against off: {same:.2%} of keypoints identical, "
            f"AP tables differ by at most {diff:.4f} (no limit: float warp against the uint8 "
            f"crops); full AP " + " ".join(f"{v:.4f}" for v in full["table"]))
        return runs
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phases 10 to 13: the DCN's backward kernel and the train step
# ---------------------------------------------------------------------------

def dcn_bwd_work(args, o):
    """(bytes, operations) the DCN's backward needs: offsets, masks, x and g
    read once; d offsets, d masks and d x written once (d W and d bias are
    kilobytes); per sample G (2 O), the bilinear sample and its two
    derivatives (~20), the three gradients and four d x corners (~12), and
    m * s against g for d W (2 O)."""
    x, offs, masks = args[:3]
    b, c, h, w = x.shape
    g_bytes = b * o * h * w * x.element_size()
    moved = 2 * nbytes(*offs, *masks) + 2 * nbytes(x) + g_bytes
    samples = len(offs) * 9 * c * b * h * w
    return moved, samples * (4 * o + 32)


def check_dcn_backward():
    """The backward kernel against the plain version's autograd at the
    flagship shape (B = 8 in f32 and bf16, B = 1 in bf16), at offsets
    calibrated so that most samples fall inside the image: each gradient's
    worst error over its peak, in bf16 the share of elements that differ,
    the kernel's ms (CUDA events around the backward launch alone) against
    the plain version's backward and the bound."""
    import torch

    from otpose_tpu_torch.ops.cuda import deform_conv
    from otpose_tpu_torch.utils.testing import dcn_case, dcn_gradients, dcn_inside_share
    from otpose_tpu_torch.utils.timing import time_ms

    names = ("x", "offsets", "masks", "weights", "biases")
    tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    gen = torch.Generator(device="cuda").manual_seed(21)
    row, worst = None, 0.0
    for batch, dtype in ((8, torch.float32), (8, torch.bfloat16), (1, torch.bfloat16)):
        args = dcn_case(batch, 17, 17, 96, 72, DCN_DILATIONS, dtype, gen)
        inside = dcn_inside_share(args)
        g = torch.randn(batch, 17, 96, 72, generator=gen, device="cuda").to(dtype)
        got = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
        want = dcn_gradients(deform_conv.modulated_deform_conv_multi_plain, args, g)
        torch.cuda.synchronize()
        d = len(DCN_DILATIONS)
        groups = lambda gr: [gr[0], torch.cat([t.flatten() for t in gr[1:1 + d]]),  # noqa: E731
                             torch.cat([t.flatten() for t in gr[1 + d:1 + 2 * d]]), gr[-2], gr[-1]]
        parts = []
        for name, gk, gp in zip(names, groups(got), groups(want)):
            err = (gk.float() - gp.float()).abs().max().item()
            peak = gp.float().abs().max().item()
            rel = err / peak
            worst = max(worst, err) if batch == 8 and dtype == torch.bfloat16 else worst
            part = f"{name} {rel:.3e}"
            if dtype == torch.bfloat16 and gk.dtype == torch.bfloat16:
                part += f" (differ {(gk != gp).float().mean().item():.3%})"
            parts.append(part)
            if not (math.isfinite(err) and peak > 0 and rel <= tol[dtype]):
                fail(f"deform_conv backward {dtype} B={batch}: d {name} err {err:.3e} over "
                     f"peak {peak:.3e}")
        log(f"check deform_conv_bwd {str(dtype)[6:]} B={batch}: {inside:.1%} of samples inside "
            f"the image; worst error over peak: " + ", ".join(parts)
            + f" (tolerance {tol[dtype]:.0e}) ok")
        again = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
        same = [torch.equal(a, b) for a, b in zip(groups(got), groups(again))]
        log(f"deform_conv_bwd {str(dtype)[6:]} B={batch}: two calls bit-equal: "
            + ", ".join(f"{n} {'yes' if ok else 'no'}" for n, ok in zip(names, same)))
        if not all(same):   # d x is an exact fixed-point sum, the rest fixed-order sums
            fail(f"deform_conv backward {dtype} B={batch}: two calls differ")
        x, offs, masks, weights, biases, dil = args
        pk = deform_conv.pack_dcn_weights(weights, biases)
        ms = time_ms(lambda: deform_conv.launch_backward(g, x, offs, masks, pk, dil), iters=10)
        leaves = [t.detach().clone().requires_grad_() for t in (x, *offs, *masks, weights, biases)]
        out = deform_conv.modulated_deform_conv_multi_plain(
            leaves[0], leaves[1:1 + d], leaves[1 + d:1 + 2 * d], leaves[-2], leaves[-1], dil)
        plain_ms = time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True),
                           iters=2, warmup=1)
        del out, leaves
        moved, ops = dcn_bwd_work(args, 17)
        t_bytes, t_ops = moved / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
        bound = max(t_bytes, t_ops)
        log(f"time deform_conv_bwd {str(dtype)[6:]} B={batch}: kernel {ms:.4f} ms, plain backward "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({moved / 1e6:.1f} MB, {ops / 1e9:.2f} "
            f"GFLOP; {bound / ms:.1%} of it)")
        key = f"{str(dtype)[6:]} B={batch}"
        if row is None:
            row = dict(name="deform_conv_bwd", route="cuda",
                       source="otpose_tpu_torch/csrc/deform_conv_bwd.cu",
                       replaces="otpose_tpu/ops/deform_conv.py:276", launches=None,
                       max_abs_err=None, ms=None, plain_ms=None, bound_ms=None,
                       bound_by=None, library_ms=None, ms_by_case={}, plain_ms_by_case={},
                       bound_ms_by_case={}, inside_share_by_case={}, bit_equal={})
        row["ms_by_case"][key], row["plain_ms_by_case"][key] = ms, plain_ms
        row["bound_ms_by_case"][key], row["inside_share_by_case"][key] = bound, inside
        row["bit_equal"][key] = dict(zip(names, same))
        if batch == 8 and dtype == torch.bfloat16:
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
    row["max_abs_err"] = worst
    return row


def synthetic_train_batch(cfg, batch: int, gen, labelled: float = 0.6):
    """A train batch on the card: random frames and margins, Gaussian targets
    from ``ops/heatmap.py::generate_heatmaps`` at random joints.  Joints
    17 * labelled onwards are invisible in every clip (weight 0, no peak), so
    the loss's batch-global test finds some joints labelled and some not."""
    import numpy as np
    import torch

    from otpose_tpu_torch.ops.heatmap import generate_heatmaps

    rng = np.random.RandomState(int(torch.randint(0, 2 ** 31, (1,), generator=gen,
                                                  device=gen.device)))
    w, h = cfg.MODEL.IMAGE_SIZE
    j = cfg.MODEL.NUM_JOINTS
    targets, weights = [], []
    for _ in range(batch):
        joints = np.zeros((j, 3))
        joints[:, 0] = rng.uniform(8, w - 8, j)
        joints[:, 1] = rng.uniform(8, h - 8, j)
        vis = np.zeros((j, 3))
        vis[:int(j * labelled), 0] = 1.0
        t, tw = generate_heatmaps(joints, vis, cfg.MODEL.SIGMA, cfg.MODEL.IMAGE_SIZE,
                                  cfg.MODEL.HEATMAP_SIZE, j)
        targets.append(t.transpose(1, 2, 0))
        weights.append(tw)
    dev = dict(device="cuda")
    return {"inputs": torch.randn(batch, h, w, 15, generator=gen, **dev),
            "margin": torch.randint(0, 3, (batch, 4), generator=gen, **dev).float(),
            "target": torch.from_numpy(np.stack(targets)).to(**dev),
            "target_weight": torch.from_numpy(np.stack(weights)).to(**dev)}


def _train_run(label, step, batch, steps, warmup, micro):
    """``steps`` train steps after ``warmup`` ones, each timed by CUDA events,
    with its metrics, launches and peak memory."""
    import torch

    want = {k: v * micro for k, v in TRAIN_COUNTS.items()}
    for _ in range(warmup):
        step(batch)
    torch.cuda.synchronize()
    times, counts, first = [], None, None
    for i in range(steps):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        metrics = step(batch)
        end.record()
        torch.cuda.synchronize()
        counts = read_counts()
        ms = start.elapsed_time(end)
        times.append(ms)
        vals = {k: v.item() for k, v in metrics.items()}
        first = vals if first is None else first
        b = batch["inputs"].shape[0]
        log(f"train {label} step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in vals.items())
            + f"; {ms:.2f} ms, {b / ms * 1e3:.3f} clips/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches {counts}")
        if len(vals) != 6 or not all(math.isfinite(v) for v in vals.values()):
            fail(f"train {label}: metrics {vals}")
        if counts != want:
            fail(f"train {label}: launches {counts} a step, expected {want}")
    return dict(ms=times, clips_per_s=[batch["inputs"].shape[0] / t * 1e3 for t in times],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, counts=counts,
                first=first)


def flagship_train(card: str):
    """The flagship train step (``configs/17/model_RSN.yaml``, full width and
    depth, reference init, synthetic batches) on one model and optimizer:
    bf16 at B = 8 (2 warm-up steps, 5 timed), f32 at B = 2 (3 steps), one
    step at B = 16 with ``TPU.ACCUM_STEPS 2``.  The LR comes from
    ``make_schedule`` with 1 iteration an epoch: lr(t) = t * LR / 11 in the
    warm-up, > 0 from the second update on.  Then every trainable parameter
    must hold a finite gradient and every BN running stat must have moved.
    Before that, one step each in bf16 and f32 from copies of the initial
    model on one B = 2 batch and one dropout seed: the two first-step
    losses."""
    import torch

    from otpose_tpu_torch.config import get_cfg
    from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
    from otpose_tpu_torch.engine.trainer import make_train_step
    from otpose_tpu_torch.models.core import BatchNorm
    from otpose_tpu_torch.models.factory import build_model

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs/17/model_RSN.yaml"))
    spec, model = build_model(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(31)
    b2 = synthetic_train_batch(cfg, cfg.TRAIN.BATCH_SIZE_PER_GPU, gen)
    first = {}
    for dtype in ("bfloat16", "float32"):
        twin = copy.deepcopy(model)
        step = make_train_step(twin, make_optimizer(twin, cfg, make_schedule(cfg, 1)),
                               compute_dtype=dtype,
                               generator=torch.Generator(device="cuda").manual_seed(5))
        first[dtype] = step(b2)["final_loss"].item()
        del twin, step
    rel = abs(first["bfloat16"] - first["float32"]) / abs(first["float32"])
    log(f"train first-step loss on one B=2 batch: bf16 {first['bfloat16']:.6g}, f32 "
        f"{first['float32']:.6g} (relative difference {rel:.3e})")
    if not rel <= 5e-2:
        fail("train: the bf16 first-step loss is far from the f32 one")

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers() if "running" in n}
    opt = make_optimizer(model, cfg, make_schedule(cfg, 1))
    tgen = torch.Generator(device="cuda").manual_seed(7)
    runs = {}
    for label, dtype, batch, steps, warmup, accum in (
            ("bf16 B=8", "bfloat16", 8, 5, 2, 1),
            ("f32 B=2", "float32", cfg.TRAIN.BATCH_SIZE_PER_GPU, 3, 0, 1),
            ("bf16 B=16 ACCUM_STEPS 2", "bfloat16", 16, 1, 0, 2)):
        step = make_train_step(model, opt, compute_dtype=dtype, accum_steps=accum,
                               generator=tgen)
        runs[label] = _train_run(label, step, synthetic_train_batch(cfg, batch, gen), steps,
                                 warmup, accum)
        r = runs[label]
        log(f"train {label}: median {sorted(r['ms'])[len(r['ms']) // 2]:.2f} ms a step, "
            f"{max(r['clips_per_s']):.3f} clips/s at best, peak {r['peak_gib']:.2f} GiB ({card})")
    bad = [n for n, p in model.named_parameters()
           if p.requires_grad and (p.grad is None or not torch.isfinite(p.grad).all())]
    if bad:
        fail(f"train: {len(bad)} trainable parameters without a finite gradient, e.g. {bad[:3]}")
    moved = sum(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    still = [n for n, b in model.named_buffers() if n in stats and torch.equal(b, stats[n])]
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    log(f"train: every one of {len(before)} parameters has a finite gradient; {moved} moved "
        f"after {opt.count} updates; {len(stats) - len(still)} of {len(stats)} running stats "
        f"({n_bn} BN layers) moved")
    if still or moved < 0.9 * len(before):
        fail(f"train: running stats {still[:3]} did not move, or only {moved} parameters did")
    return runs


def tiny_train_agreement():
    """The tiny spec in f32 with weights of std 1/sqrt(fan_in), conditioned
    for gradients (``utils/testing.py::condition_for_gradients_``: every BN
    bias raised by 3, so no ReLU input sits within f32 rounding of the
    kink, and HRNet's final conv rescaled so the losses stay O(1)), the
    mask convs calibrated, the offset convs zeroed and the dropout rates at
    0.  The gradients of one forward and backward on the card (the DCN's
    forward and backward kernels) and on the CPU (plain versions), the
    CPU's also in f64 as the witness; then one SGD step (no weight decay)
    on each, whose update is the momentum buffer, the clipped gradient.
    Each gradient, however small beside the largest, is held to 1e-3 of its
    own peak three ways: card against CPU, card against f64, and the
    card's update against the CPU's.  A tensor whose f32 gradient is itself
    ill-conditioned on this input (the CPU's misses the f64 one by more than
    1e-3 of the peak: a sum that cancels, such as an encoder's output bias
    whose shift the next batch-statistics BN removes but for the image
    border) passes if the card is no farther from f64 than twice the CPU;
    at most 5% of the tensors may, and they are printed.  Gradients that
    are zero in exact arithmetic (f64 peak under 1e-12 of the largest) are
    f32 residue, held to 1e-6 of the largest.  Zero offsets put every
    sample exactly on a pixel, so rounding moves none across the bilinear
    derivative's jump at integer positions (``check_dcn_backward`` holds
    the kernel at fractional positions)."""
    import torch

    from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
    from otpose_tpu_torch.engine.trainer import make_train_step
    from otpose_tpu_torch.models.blocks import set_drop_rates
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.utils.testing import (condition_for_gradients_, loss_gradients,
                                                tiny_otpose_cfg)

    cfg = tiny_otpose_cfg()
    cfg.TRAIN.OPTIMIZER, cfg.TRAIN.WARMUP, cfg.TRAIN.WD = "SGD", False, 0.0
    _, gpu_model = build_model(cfg, seed=4)
    _scaled_weights_(gpu_model, 4)
    set_drop_rates(gpu_model)
    gen = torch.Generator(device="cuda").manual_seed(9)
    batch = synthetic_train_batch(cfg, 2, gen)
    condition_for_gradients_(gpu_model, batch["inputs"], batch["margin"])
    _calibrate_refinement_(gpu_model, 4)
    with torch.no_grad():
        for m in gpu_model.offsets_list:
            m["0"].weight.zero_()
    cpu_model = copy.deepcopy(gpu_model).cpu()
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    # the unclipped gradients, on copies of the models before the step
    grads = {dev: {n: g.detach().cpu() for n, g in loss_gradients(m, b)[2].items()}
             for dev, m, b in (("cuda", gpu_model, batch), ("cpu", cpu_model, cpu_batch))}
    loss64, _, exact = loss_gradients(cpu_model, cpu_batch, torch.float64)
    results = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        opt = make_optimizer(model, cfg, make_schedule(cfg, 4))
        step = make_train_step(model, opt)
        reset_counts()
        metrics = step(batch if dev == "cuda" else cpu_batch)
        counts = read_counts()
        state = opt.opt.state
        results[dev] = dict(
            counts=counts, loss=metrics["final_loss"].item(),
            updates={n: state[p]["momentum_buffer"].cpu() for n, p in model.named_parameters()})
    if results["cuda"]["counts"] != TRAIN_COUNTS:
        fail(f"tiny train step launches {results['cuda']['counts']}")
    top64 = max(g.abs().max().item() for g in exact.values())
    top_u = max(u.abs().max().item() for u in results["cpu"]["updates"].values())
    zeros, strict, exempt, bad, worst = [], 0, [], [], (0.0, "")
    for n, w in exact.items():
        card, cpu = grads["cuda"][n].double(), grads["cpu"][n].double()
        u_card, u_cpu = results["cuda"]["updates"][n], results["cpu"]["updates"][n]
        if w.abs().max().item() <= 1e-12 * top64:
            zeros.append(n)
            if not (card.abs().max().item() <= 1e-6 * top64
                    and u_card.abs().max().item() <= 1e-6 * top_u):
                bad.append((n, "zero in exact arithmetic"))
            continue
        peak = w.abs().max().item()
        e_card = (card - w).abs().max().item() / peak
        e_cpu = (cpu - w).abs().max().item() / peak
        e_pair = (card - cpu).abs().max().item() / peak
        e_upd = (u_card - u_cpu).abs().max().item() / u_cpu.abs().max().item()
        err = max(e_card, e_pair, e_upd)
        worst = max(worst, (err, n))
        if err <= 1e-3:
            strict += 1
        elif e_card <= 2 * e_cpu:
            exempt.append((n, e_card, e_cpu))
        else:
            bad.append((n, e_card, e_cpu, e_pair, e_upd))
    live = len(exact) - len(zeros)
    log("tiny train step f32 GPU (kernels) vs CPU (plain), CPU f64 the witness: loss "
        f"{results['cuda']['loss']:.6g} / {results['cpu']['loss']:.6g} / {loss64:.6g}; "
        f"{strict} of {live} gradients (and their updates) within 1e-3 of their peak on all "
        f"three counts, worst {worst[0]:.3e} ({worst[1]}); {len(exempt)} where f32 itself "
        "misses 1e-3 and the card is no farther from f64 than twice the CPU ("
        + ", ".join(f"{n} {c:.2e} vs {p:.2e}" for n, c, p in exempt[:4]) + f"); {len(zeros)} "
        f"zero in exact arithmetic; launches {results['cuda']['counts']}")
    if bad or len(exempt) > 0.05 * live:
        fail(f"tiny train step disagrees between the card and the CPU: {bad[:5]}, "
             f"{len(exempt)} exempt")


def check_grad_refusals():
    """F1 on the card: the kernels without a backward raise on a CUDA tensor
    that requires grad."""
    import torch

    from otpose_tpu_torch.ops.cuda import fused_attn, fused_mlp, token_shift

    gen = torch.Generator(device="cuda").manual_seed(8)
    a = attn_case(torch.float32, gen, 1)
    m = mlp_case(torch.float32, gen, 64, 1)
    x = torch.randn(4, 64, device="cuda")
    for name, fn, args in (("fused_attn_ct", fused_attn.fused_attn_ct, a),
                           ("fused_mlp_residual_ct", fused_mlp.fused_mlp_residual_ct, m),
                           ("token_shift", token_shift.token_shift, [x, "right"])):
        try:
            fn(args[0].clone().requires_grad_(), *args[1:])
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            fail(f"{name} ran on a CUDA tensor that requires grad")
    log("F1: fused_attn_ct, fused_mlp_residual_ct and token_shift raise under grad on the card")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        from otpose_tpu_torch.ops.cuda import build
    except ImportError as e:
        fail(f"the otpose_tpu_torch package is not beside this script ({e})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # plain bf16 products accumulate in f32 throughout, as the kernels do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {len(secs)} kernels in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for name, report in build.ptxas_report.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "properties for" in line:
                log(f"ptxas {name}: {line.strip()}")

    rows = check_kernels()
    rows["token_shift"] = check_token_shift()
    flag = flagship_eval()
    infer = inference_api(*flag["model"])
    eval_rates = {k: flag[k]["clips_per_s"] for k in ("bf16", "f32", "flip")}
    latency = infer["latency_ms"]
    paths = {"decoded_eval": flag["bf16"]["counts"], "flip_eval": flag["flip"]["counts"],
             "inference": infer["counts"], **tools()}
    tiny_agreement()
    cli = eval_cli()
    per_batch = {k: v // cli[0]["batches"] for k, v in cli[0]["counts"].items()}
    paths["eval_cli_per_batch"] = per_batch
    del flag, infer
    torch.cuda.empty_cache()
    rows["deform_conv_bwd"] = check_dcn_backward()
    check_grad_refusals()
    train = flagship_train(card)
    paths["train_step_bf16_b8"] = train["bf16 B=8"]["counts"]
    tiny_train_agreement()
    # each kernel's launches on its own path: the eval's for the model's
    # kernels, the experiment tool's for the other two, a train step's for
    # the DCN's backward
    own = {"deform_conv_fused": "exp_deform_fused", "token_shift": "probe_shift",
           "deform_conv_bwd": "train_step_bf16_b8"}
    for name, row in rows.items():
        row["launches"] = paths[own.get(name, "decoded_eval")][name]
        row["launches_by_path"] = {p: c[name] for p, c in paths.items()}
    log(f"flagship decoded eval bf16: {eval_rates['bf16']:.3f} clips/s, "
        f"f32: {eval_rates['f32']:.3f} clips/s, flip bf16: "
        f"{eval_rates['flip']:.3f} clips/s (B={BATCH}); inference latency B=1: "
        f"{latency:.3f} ms; train step: "
        + "; ".join(f"{k} {sorted(r['ms'])[len(r['ms']) // 2]:.2f} ms, peak {r['peak_gib']:.2f} GiB"
                    for k, r in train.items())
        + "; eval CLI over a synthetic tree: "
        + "; ".join(f"{r['preprocess']} ({r['loader']}) {r['boxes_per_s']:.3f} boxes/s with "
                    f"{r['workers']} loader thread(s), the "
                    f"steps' events span {r['step_span_share']:.1%} of the loop's wall time"
                    for r in cli) + f" ({card})")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(f"nvidia-smi: {card}", flush=True)
    # the script drives one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}), flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
