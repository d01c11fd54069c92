#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``otpose_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. checks for a CUDA device and prints its ``nvidia-smi`` name and power limit;
2. builds the three kernels from ``otpose_tpu_torch/csrc`` with ``nvcc``;
3. holds each kernel against its plain PyTorch version at the flagship
   shapes, in f32 (TF32 off) and bf16, and times both with CUDA events;
4. runs the flagship decoded eval (HRNet-W48, 384x288, B = 16) from
   ``build_model`` in bf16 with bf16 weights, then in f32, checks the output
   shapes and values and the kernel launch counts (12 / 16 / 1 per forward),
   and times the bf16 step in clips/s;
5. runs the tiny config on the GPU and on the CPU (plain versions) with the
   same weights and holds the decoded results against each other.

It prints a ``kernels`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``.
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attn_case(dtype, gen):
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
    args = [r(BATCH, c, t).to(dtype),
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


def mlp_case(dtype, gen, t):
    import torch

    c = 136
    f = dict(device="cuda", dtype=torch.float32)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, **f) * scale  # noqa: E731
    return [r(BATCH, c, t).to(dtype), 1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1),
            r(4 * c, c, 1, scale=1 / math.sqrt(c)).to(dtype), r(4 * c, scale=0.1).to(dtype),
            r(c, 4 * c, 1, scale=1 / math.sqrt(4 * c)).to(dtype), r(c, scale=0.1).to(dtype)]


def dcn_case(dtype, gen):
    import torch

    c, h, w, dil = 17, 96, 72, (3, 6, 9, 12, 15)
    f = dict(device="cuda", dtype=torch.float32)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, **f) * scale  # noqa: E731
    x = r(BATCH, c, h, w).to(dtype)
    offs = [r(BATCH, 18 * c, h, w, scale=2.0).to(dtype) for _ in dil]
    masks = [r(BATCH, 9 * c, h, w).to(dtype) for _ in dil]
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


def check_kernels():
    import torch

    from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp

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
    }
    # tolerance on max|kernel - plain| as a share of max(1, max|plain|).
    # f32: the two differ by summation order, and the plain attention's
    # cuBLAS score sum over T = 6912 (|S| in the hundreds) errs by ~1e-4 of
    # the output's peak itself, which attn_f64_errors shows; bf16: a one-ulp
    # rounding flip where the two sums land on either side of a bf16
    # boundary, the tolerance of the JAX package's bf16 kernel tests.
    tol = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, (kern, plain, src, replaces) in kernels.items():
        for dtype in (torch.float32, torch.bfloat16):
            cases = ([mlp_case(dtype, gen, t) for t in (6912, 3456, 1728)]
                     if name == "fused_mlp" else
                     [attn_case(dtype, gen) if name == "fused_attn" else dcn_case(dtype, gen)])
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
                if i == 0:
                    ms = time_ms(lambda: kern(*args))
                    plain_ms = time_ms(lambda: plain(*args), iters=3)
                    moved, ops, peak = work(name, args)
                    t_bytes, t_ops = moved / PEAK_BYTES * 1e3, ops / peak * 1e3
                    log(f"time {name} {str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
                        f" bound {max(t_bytes, t_ops):.4f} ms ({moved / 1e6:.1f} MB,"
                        f" {ops / 1e9:.2f} GFLOP)")
                    if dtype == torch.bfloat16:
                        rows[name] = dict(
                            name=name, route="cuda", source=src, replaces=replaces,
                            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes >= t_ops else "operations",
                            library_ms=None)
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: the decoded eval
# ---------------------------------------------------------------------------

def reset_counts():
    from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp

    for mod in (fused_attn, fused_mlp, deform_conv):
        mod.calls = mod.launches = 0


def read_counts():
    from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp

    return {"fused_attn": fused_attn.launches, "fused_mlp": fused_mlp.launches,
            "deform_conv": deform_conv.launches}


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
    want_counts = {"fused_attn": 12, "fused_mlp": 16, "deform_conv": 1}
    results = {}
    f32_model = copy.deepcopy(model)
    prepare_eval_params(model, torch.bfloat16)
    for label, m, dtype in (("bf16", model, torch.bfloat16), ("f32", f32_model, torch.float32)):
        step = make_decoded_eval_step(m, compute_dtype=dtype)
        step(inputs, margin)                   # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        reset_counts()
        coords, maxvals, raw = step(inputs, margin)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"flagship {label}: launches {counts}")
        if counts != want_counts:
            fail(f"flagship {label} launches {counts}, expected {want_counts}")
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
    return results


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
    if counts != {"fused_attn": 4, "fused_mlp": 6, "deform_conv": 1}:
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
    flag = flagship_eval()
    tiny_agreement()
    for name, row in rows.items():
        row["launches"] = flag["bf16"]["counts"][name]
    log(f"flagship decoded eval bf16: {flag['bf16']['clips_per_s']:.3f} clips/s, "
        f"f32: {flag['f32']['clips_per_s']:.3f} clips/s (B={BATCH}, {card})")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(f"nvidia-smi: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
