"""Where the time of one flagship train step goes on the GPU.

    python -m otpose_tpu_torch.tools.profile_train [--joints 133 --batch 2]

The port's counterpart of ``tools/time_train_step.py``: builds the flagship
train step (``configs/17/model_RSN.yaml``, reference init, AdamW from
``engine/optim.py``) on synthetic batches (N(0, 1) clips, margins 0-2,
Gaussian targets at random joints, the first 10 labelled), runs it in bf16 at B = 8
(``--batch``; ``--joints`` sets ``MODEL.NUM_JOINTS``, the DCN's O and C) under
``torch.profiler`` for three steps after two warm-up steps, and prints the wall time a step
(CUDA-synchronised host clock), the device's summed kernel time and idle
share, and the kernel time a step by category:

- ``dcn_forward`` / ``dcn_backward``: ``csrc/deform_conv.cu`` /
  ``csrc/deform_conv_bwd.cu``, by kernel name (the wide paths' weight
  fragments, ``otp_dcn::wide_wfrag_kernel``, under the forward for both);
- ``conv_forward`` / ``conv_backward``: cuDNN (fprop; dgrad and wgrad), by
  kernel name;
- ``matmul``: cuBLAS and CUTLASS products, by kernel name;
- ``bn_batch_stats``: the kernels of ``models/core.py::batch_norm_train``
  (the op is wrapped in a profiler range here) and of the backward nodes
  that autograd made from its ops (matched by sequence number);
- ``optimizer``: the kernels of ``Optimizer.step`` (clip and AdamW);
- ``elementwise_forward`` / ``elementwise_backward``: every other kernel,
  by whether a backward node launched it.

The whole step, forward and backward, is profiled; the parent's tree can be
profiled by running this file by its path with that checkout first on the
path (``PYTHONPATH=<checkout> python otpose_tpu_torch/tools/profile_train.py``).
Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

KERNEL_CATEGORIES = (
    ("dcn_backward", ("dcn_bwd",)),
    ("dcn_forward", ("deform_staged_kernel", "deform_reduce_kernel", "deform_wide",
                     "wide_wfrag")),
    ("conv_backward", ("dgrad", "wgrad", "bprop", "convolve_sgemm_bwd", "bn_bw")),
    ("conv_forward", ("fprop", "cudnn", "implicit_gemm", "conv", "nchwToNhwc", "nhwcToNchw")),
    ("matmul", ("gemm", "cutlass", "cublas", "sm90_xmma", "splitKreduce")),
)
BN_RANGE, OPT_RANGE = "otpose::batch_norm_train", "otpose::optimizer_step"
BATCH, DTYPE, STEPS = 8, "bfloat16", 3
# the flagship config, found from this file (also when it profiles another checkout)
CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "configs", "17",
                   "model_RSN.yaml")
BACKWARD = "autograd::engine::evaluate_function"


def kernel_category(name: str):
    low = name.lower()
    for cat, keys in KERNEL_CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return None


def categorize(events, steps: int) -> dict:
    """{category: device ms a step} over the profiler's ``events``: each
    kernel is charged to the CPU op that launched it, and that op's
    ancestors decide the scope categories."""
    def ancestors(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    bn_seq = set()
    for e in events:
        if e.name == BN_RANGE:
            stack = list(e.cpu_children)
            while stack:
                c = stack.pop()
                if getattr(c, "sequence_nr", -1) >= 0:
                    bn_seq.add(c.sequence_nr)
                stack.extend(c.cpu_children)
    by_cat: dict = {}
    for e in events:
        for k in getattr(e, "kernels", []):
            cat = kernel_category(k.name)
            if cat is None:
                names = [a.name for a in ancestors(e)]
                backward = [a for a in ancestors(e) if a.name.startswith(BACKWARD)]
                if OPT_RANGE in names:
                    cat = "optimizer"
                elif BN_RANGE in names or (backward and backward[-1].sequence_nr in bn_seq):
                    cat = "bn_batch_stats"
                elif backward:
                    cat = "elementwise_backward"
                else:
                    cat = "elementwise_forward"
            by_cat[cat] = by_cat.get(cat, 0.0) + k.duration / 1e3 / steps
    return by_cat


def synthetic_batch(cfg, batch: int, gen) -> dict:
    """Random clips and margins with Gaussian targets (peak 1, the config's
    sigma) at random joints, the first 10 labelled.  Plain torch, so
    that an older checkout of the package can be profiled too."""
    w, h = cfg.MODEL.IMAGE_SIZE
    hw, hh = cfg.MODEL.HEATMAP_SIZE
    j = cfg.MODEL.NUM_JOINTS
    dev = dict(device="cuda")
    mu = torch.rand(batch, j, 2, generator=gen, **dev) * torch.tensor([hw - 4.0, hh - 4.0], **dev)
    mu = torch.round(mu + 2.0)
    vis = (torch.arange(j, **dev) < 10).float().expand(batch, j)
    dx = torch.arange(hw, **dev).float()[None, None, None, :] - mu[..., 0, None, None]
    dy = torch.arange(hh, **dev).float()[None, None, :, None] - mu[..., 1, None, None]
    target = torch.exp(-(dx ** 2 + dy ** 2) / (2.0 * float(cfg.MODEL.SIGMA) ** 2))
    target = target * vis[..., None, None]
    return {"inputs": torch.randn(batch, h, w, 15, generator=gen, **dev),
            "margin": torch.randint(0, 3, (batch, 4), generator=gen, **dev).float(),
            "target": target.permute(0, 2, 3, 1).contiguous(), "target_weight": vis[..., None]}


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--joints", type=int, default=None,
                        help="MODEL.NUM_JOINTS (default: the config's 17)")
    parser.add_argument("--batch", type=int, default=BATCH)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_train: needs a CUDA device")

    from otpose_tpu_torch.config import get_cfg
    from otpose_tpu_torch.engine import optim
    from otpose_tpu_torch.engine.trainer import make_train_step
    from otpose_tpu_torch.models import core
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.ops.cuda import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    cfg = get_cfg()
    cfg.merge_from_file(CFG)
    if args.joints is not None:
        cfg.MODEL.NUM_JOINTS = args.joints
    _, model = build_model(cfg, seed=0)
    opt = optim.make_optimizer(model, cfg, optim.make_schedule(cfg, 1))
    step = make_train_step(model, opt, compute_dtype=DTYPE,
                           generator=torch.Generator(device="cuda").manual_seed(5))
    batch = synthetic_batch(cfg, args.batch, torch.Generator(device="cuda").manual_seed(3))

    # profiler ranges around train BN and the optimizer, in this process only
    bn_train, opt_step = core.batch_norm_train, optim.Optimizer.step

    def bn_ranged(*a, **k):
        with torch.profiler.record_function(BN_RANGE):
            return bn_train(*a, **k)

    def step_ranged(self):
        with torch.profiler.record_function(OPT_RANGE):
            return opt_step(self)

    core.batch_norm_train, optim.Optimizer.step = bn_ranged, step_ranged
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / STEPS
    core.batch_norm_train, optim.Optimizer.step = bn_train, opt_step

    by_cat = categorize(prof.events(), STEPS)
    busy = sum(by_cat.values())
    idle = max(0.0, 1 - busy / (wall * 1e3))
    print(f"card: {card}; train step {DTYPE} B={args.batch}, {cfg.MODEL.NUM_JOINTS} joints; "
          f"{STEPS} profiled steps")
    print(f"wall {wall * 1e3:.3f} ms per step ({args.batch / wall:.3f} clips/s); device kernels "
          f"{busy:.3f} ms per step; device idle share {idle:.3f}")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:22s} {ms:9.3f} ms  {ms / busy:6.1%}")
    print(json.dumps({"wall_ms": wall * 1e3, "device_ms": busy, "idle_share": idle,
                      "by_category_ms": by_cat, "card": card, "batch": args.batch,
                      "joints": cfg.MODEL.NUM_JOINTS,
                      "dtype": DTYPE, "source": core.__file__}), flush=True)


if __name__ == "__main__":
    main()
