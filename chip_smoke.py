#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``otpose_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. checks for a CUDA device and prints its ``nvidia-smi`` name and power limit;
2. builds the four kernel sources from ``otpose_tpu_torch/csrc`` with
   ``nvcc``, in parallel;
3. holds each of the five kernel rows against its plain PyTorch version at
   the shapes its paths give it, in f32 (TF32 off) and bf16, and times both
   with CUDA events: fused attention, fused MLP and the DCN at the flagship
   shapes at B = 16 (eval) and B = 1 (inference); the fused-sampling DCN
   (the DCN's kernel in its make_pallas3 rounding mode) at the same shapes,
   and against the exact mode: in f32 the same function, in bf16 it must
   share its plain version's rounding far more often than the exact mode
   does; the token shift in its four modes at (16, 256) and at the
   attention's halo size (16 * 136, 6912), where it must be exact; in bf16
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
   same weights and holds the decoded results against each other.

Each path (phases 4 to 7) is driven with every launch count set to 0 just
before it and read just after.  It prints a ``kernels`` JSON line, the card
line, and last ``{"ok": true, "device": {...}}``.
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
FORWARD_COUNTS = {"fused_attn": 12, "fused_mlp": 16, "deform_conv": 1,
                  "deform_conv_fused": 0, "token_shift": 0}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms of one ``fn()``: a CUDA graph of ``iters`` calls, replayed."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def check_token_shift():
    """Every mode of the token shift against its plain version, exactly,
    at the probe's (16, 256) and at the attention's halo size, in bf16 and
    f32; times at the halo size in bf16.  The JSON row times the ``rotate``
    mode, the one that a single PyTorch call (``torch.roll``) computes; its
    ``max_abs_err`` is the largest over every case."""
    import torch

    from otpose_tpu_torch.ops.cuda import token_shift

    gen = torch.Generator(device="cuda").manual_seed(6)
    halo = (BATCH * 136, 6912)
    modes_ms, err = {}, 0.0
    for shape in ((16, 256), halo):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
            for mode in token_shift.MODES:
                got = token_shift.token_shift(x, mode)
                want = token_shift.token_shift_plain(x, mode)
                torch.cuda.synchronize()
                err = max(err, (got.float() - want.float()).abs().max().item())
                if not torch.equal(got, want):
                    fail(f"token_shift {mode} {dtype} {shape} differs from its plain version")
                if shape == halo and dtype == torch.bfloat16:
                    modes_ms[mode] = (time_ms(lambda: token_shift.token_shift(x, mode), 20),
                                      time_ms(lambda: token_shift.token_shift_plain(x, mode), 20))
            log(f"check token_shift {str(dtype)[6:]} x{shape}: all four modes exact")
    x = torch.randn(*halo, generator=gen, device="cuda").to(torch.bfloat16)
    roll_ms = time_ms(lambda: torch.roll(x, 1, 1), 20)
    bound = 2 * nbytes(x) / PEAK_BYTES * 1e3
    for mode, (ms, plain_ms) in modes_ms.items():
        log(f"time token_shift {mode} bfloat16 x{halo}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({2 * nbytes(x) / 1e6:.1f} MB)"
            + (f", torch.roll {roll_ms:.4f} ms" if mode == "rotate" else ""))
    ms, plain_ms = modes_ms["rotate"]
    return dict(name="token_shift", route="cuda", source="otpose_tpu_torch/csrc/token_shift.cu",
                replaces="tools/probe_shift.py:25", launches=None, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", library_ms=roll_ms,
                mode="rotate", modes_ms={m: v[0] for m, v in modes_ms.items()})


# ---------------------------------------------------------------------------
# phases 4 to 8: the paths
# ---------------------------------------------------------------------------

def _kernel_modules():
    import importlib

    return {name: importlib.import_module(f"otpose_tpu_torch.ops.cuda.{name}")
            for name in KERNEL_MODULES}


def reset_counts():
    for mod in _kernel_modules().values():
        mod.calls = mod.launches = 0


def read_counts():
    return {name: mod.launches for name, mod in _kernel_modules().items()}


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
                              peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
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

    _, cpu_model = build_model(tiny_otpose_cfg(), seed=2, device="cpu")
    _scaled_weights_(cpu_model, 2)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
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
    paths = {"decoded_eval": flag["bf16"]["counts"], "flip_eval": flag["flip"]["counts"],
             "inference": infer["counts"], **tools()}
    tiny_agreement()
    # each kernel's launches on its own path: the eval's for the model's
    # kernels, the experiment tool's for the other two
    own = {"deform_conv_fused": "exp_deform_fused", "token_shift": "probe_shift"}
    for name, row in rows.items():
        row["launches"] = paths[own.get(name, "decoded_eval")][name]
        row["launches_by_path"] = {p: c[name] for p, c in paths.items()}
    log(f"flagship decoded eval bf16: {flag['bf16']['clips_per_s']:.3f} clips/s, "
        f"f32: {flag['f32']['clips_per_s']:.3f} clips/s, flip bf16: "
        f"{flag['flip']['clips_per_s']:.3f} clips/s (B={BATCH}); inference latency B=1: "
        f"{infer['latency_ms']:.3f} ms ({card})")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(f"nvidia-smi: {card}", flush=True)
    # the script drives one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}), flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
