"""Time the flagship train step (counterpart of ``tools/time_train_step.py``).

    python -m otpose_tpu_torch.tools.time_train_step [--batch 8] [--iters 10]
        [--mode step|fwd] [--no-remat] [--accum K] [--ab-dropout]
    python -m otpose_tpu_torch.tools.time_train_step --device cpu --tiny --batch 2 --iters 2

``step`` times ``engine/trainer.py::make_train_step`` (forward, backward and
the optimizer; ``--accum K`` micro-batches; remat on unless ``--no-remat``),
``fwd`` the train-mode loss alone (no gradient, no update).  The model is
``utils/testing.py::flagship_otpose_cfg``'s at the reference init (``--tiny``:
``tiny_otpose_cfg``), the batch random clips, unit margins, uniform targets
and unit weights; bf16 on the card, f32 on the CPU.  After two warm-up
steps (the JAX tool's compile and first step) each step is timed alone by
CUDA events around it (on the CPU by the host's clock), as
``chip_smoke.py``'s train phase times its steps; the tool prints the median
ms a step, train clips/s and the kernels' launches a step.  ``--ab-dropout`` runs the dropout rates as
configured against all of them 0 (``models/blocks.py::set_drop_rates``), on
two copies of the model, in three interleaved rounds in one process.
"""

from __future__ import annotations

import argparse
import copy
import time

import torch

KERNELS = ("fused_attn", "fused_mlp", "deform_conv", "deform_conv_fused", "token_shift")


def _counts() -> dict:
    from otpose_tpu_torch.utils import profiling

    made = profiling.counters()
    out = {k: made.get(f"{k}.launches", 0) for k in KERNELS}
    out["deform_conv_bwd"] = made.get("deform_conv.bwd_launches", 0)
    return out


def make_batch(cfg, batch: int, device) -> dict:
    """The tool's batch: N(0, 1) clips, unit margins, U(0, 1) targets and
    unit target weights, made on ``device`` from a fixed seed."""
    gen = torch.Generator(device=device).manual_seed(0)
    w, h = cfg.MODEL.IMAGE_SIZE
    hw, hh = cfg.MODEL.HEATMAP_SIZE
    j = cfg.MODEL.NUM_JOINTS
    dev = dict(device=device)
    return {"inputs": torch.randn(batch, h, w, 15, generator=gen, **dev),
            "margin": torch.ones(batch, 4, **dev),
            "target": torch.rand(batch, hh, hw, j, generator=gen, **dev),
            "target_weight": torch.ones(batch, j, 1, **dev)}


def build_step(model, cfg, *, mode: str, dtype, remat: bool, accum: int, generator):
    """``step(batch) -> metrics`` for ``mode``: the train step, or ``fwd``,
    the train-mode losses without a gradient or an update (the BN updates
    of the pass are dropped)."""
    from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
    from otpose_tpu_torch.engine.trainer import compute_losses, make_train_step
    from otpose_tpu_torch.models import core

    if mode == "step":
        opt = make_optimizer(model, cfg, make_schedule(cfg, 1000))
        return make_train_step(model, opt, compute_dtype=dtype, remat=remat,
                               accum_steps=accum, generator=generator)

    @torch.no_grad()
    def fwd(batch):
        model.train()
        with core.use_generator(generator):
            _, metrics, _ = compute_losses(model, batch, compute_dtype=dtype)
        for m in model.modules():
            if isinstance(m, core.BatchNorm):
                m.pending = None
        return metrics

    return fwd


def _timed(step, batch, iters: int, device) -> float:
    """The median ms of ``iters`` steps, each timed alone: CUDA events
    around it and a synchronisation after it on a card, the host's clock on
    the CPU (where nothing is asynchronous)."""
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            metrics = step(batch)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            metrics = step(batch)
            times.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(metrics["final_loss"]).item():
            raise RuntimeError(f"time_train_step: a non-finite loss {metrics['final_loss']}")
    return sorted(times)[len(times) // 2]


def run(*, batch: int = 8, iters: int = 10, mode: str = "step", remat: bool = True,
        accum: int = 1, ab_dropout: bool = False, tiny: bool = False, device=None,
        log=print) -> dict:
    """Build the model, time its step and return {"ms" (the median a
    step), "clips_per_s", "launches" (a step, of the timed steps)}; with
    ``ab_dropout`` the rounds' median ms of both arms."""
    from otpose_tpu_torch.models.blocks import set_drop_rates
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.utils.device import resolve_device
    from otpose_tpu_torch.utils.testing import flagship_otpose_cfg, tiny_otpose_cfg

    dev = resolve_device(device)
    cfg = tiny_otpose_cfg() if tiny else flagship_otpose_cfg()
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    _, model = build_model(cfg, seed=0, device=dev)
    data = make_batch(cfg, batch, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    label = (f"mode={mode} batch={batch} remat={remat} accum={accum} "
             f"dtype={str(dtype)[6:]} device={dev}")
    if ab_dropout:
        off = set_drop_rates(copy.deepcopy(model))
        steps = {arm: build_step(m, cfg, mode=mode, dtype=dtype, remat=remat, accum=accum,
                                 generator=gen)
                 for arm, m in (("dropout", model), ("no-dropout", off))}
        for step in steps.values():
            _timed(step, data, 2, dev)
        rounds = []
        for rnd in range(3):
            ms = {arm: _timed(step, data, iters, dev) for arm, step in steps.items()}
            rounds.append(ms)
            log(f"round {rnd}: dropout {ms['dropout']:.1f} ms   no-dropout "
                f"{ms['no-dropout']:.1f} ms   delta {ms['dropout'] - ms['no-dropout']:+.1f} ms "
                f"({label})")
        return {"rounds": rounds}
    step = build_step(model, cfg, mode=mode, dtype=dtype, remat=remat, accum=accum,
                      generator=gen)
    t0 = time.perf_counter()
    _timed(step, data, 2, dev)
    log(f"two warm-up steps: {time.perf_counter() - t0:.1f} s")
    before = _counts()
    ms = _timed(step, data, iters, dev)
    launches = {k: (v - before[k]) // iters for k, v in _counts().items()}
    log(f"{label}: {ms:.1f} ms/step = {batch / ms * 1e3:.2f} train clips/s; kernel launches "
        f"a step {launches}")
    return {"ms": ms, "clips_per_s": batch / ms * 1e3, "launches": launches}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mode", choices=("step", "fwd"), default="step",
                    help="step: the full train step; fwd: the train-mode loss only")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation micro-batches (mode step)")
    ap.add_argument("--ab-dropout", action="store_true",
                    help="interleaved in one process: dropout on against off")
    ap.add_argument("--tiny", action="store_true", help="the tiny config (CPU runs)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(batch=args.batch, iters=args.iters, mode=args.mode, remat=not args.no_remat,
               accum=args.accum, ab_dropout=args.ab_dropout, tiny=args.tiny,
               device=args.device)


if __name__ == "__main__":
    main()
