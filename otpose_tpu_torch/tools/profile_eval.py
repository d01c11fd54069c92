"""Where the time of one flagship decoded-eval step goes on the GPU.

    python -m otpose_tpu_torch.tools.profile_eval [--batch 16] [--dtype bfloat16]
        [--steps 3] [--trace eval_trace.json] [--no-fused] [--joints 17]

Builds the flagship model (random reference init), runs the decoded eval
step under ``torch.profiler`` and prints: the wall time per step, the summed
device (kernel) time per step and the device's idle share, the device time
by category (the port's three kernels, convolutions, matrix products, other
elementwise and copy kernels), and the top kernels by device time.
``--no-fused`` runs every transformer block on its plain PyTorch path
(``make_decoded_eval_step(fused=False)``), the counterpart of the JAX
package's ``tools/perf_experiments.py::exp_fused_*``.  ``--joints`` sets
``MODEL.NUM_JOINTS`` (the temporal encoders are 8 x joints wide: past 20
joints the fused kernels take their wide paths).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

CATEGORIES = (
    # f32 (_tf32), bf16 (_tc); the wide path's kernels and products by their epilogue
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


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "elementwise/other"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default="")
    ap.add_argument("--joints", type=int, default=17, help="MODEL.NUM_JOINTS")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    help="every block on its plain path (no fused attention or MLP)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_eval: needs a CUDA device")

    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.models.otpose import prepare_eval_params
    from otpose_tpu_torch.ops.cuda import build
    from otpose_tpu_torch.utils.testing import flagship_otpose_cfg

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    dtype = getattr(torch, args.dtype)
    cfg = flagship_otpose_cfg()
    cfg.MODEL.NUM_JOINTS = args.joints
    _, model = build_model(cfg, seed=0)
    if dtype == torch.bfloat16:
        prepare_eval_params(model, dtype)
    step = make_decoded_eval_step(model, compute_dtype=dtype, fused=args.fused)
    gen = torch.Generator(device="cuda").manual_seed(1)
    w, h = cfg.MODEL.IMAGE_SIZE
    x = torch.randn(args.batch, h, w, 15, generator=gen, device="cuda")
    margin = torch.ones(args.batch, 4, device="cuda")
    for _ in range(2):
        step(x, margin)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(x, margin)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_cat: dict = {}
    kernels = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        # aten:: and the port's own ops (otpose::) are host-side events whose
        # device time is their kernels', which are counted by their own names
        if dev <= 0 or e.key.startswith(("aten::", "otpose::")):
            continue
        ms = dev / 1e3 / args.steps
        kernels.append((ms, e.count // args.steps, e.key))
        cat = category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    busy = sum(by_cat.values())
    print(f"card: {card}; {args.joints} joints, batch {args.batch} {args.dtype}"
          f"{'' if args.fused else ', no fused kernels'}; {args.steps} profiled steps")
    print(f"wall {wall * 1e3:.3f} ms per step ({args.batch / wall:.3f} clips/s); device "
          f"kernels {busy:.3f} ms per step; device idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:20s} {ms:9.3f} ms  {ms / busy:6.1%}")
    print("top kernels (ms per step, launches per step, name):")
    for ms, n, name in sorted(kernels, reverse=True)[:25]:
        print(f"  {ms:9.3f}  {n:4d}  {name[:110]}")
    print(json.dumps({"wall_ms": wall * 1e3, "device_ms": busy, "by_category_ms": by_cat,
                      "card": card, "joints": args.joints, "batch": args.batch,
                      "dtype": args.dtype,
                      "fused": args.fused}))


if __name__ == "__main__":
    main()
