"""Train and eval steps of the port (counterpart of
``otpose_tpu/engine/trainer.py``): one device, or one a rank under a
multi-process launch.

The train step (ref: script/Common.py:79-294) is the JAX ``make_train_step``
in PyTorch idiom: the model in ``train()`` mode, f32 master weights and
activations in the compute dtype, the student/teacher loss plus the
occlusion auxiliary loss, backward, then the optimizer of ``engine/optim.py``
(global-norm clip, AdamW or SGD, the LR schedule).  Dropout and drop-path
draw from the step's ``torch.Generator``.  On the card the DCN's gradient
comes from its backward kernel; the fused attention and MLP are eval-only,
as in JAX.  Every step takes ``seq`` (``parallel/mesh.py::seq_group``), the
JAX steps' ``seq_axis``: the encoders' blocks then run on this rank's slice
of the tokens (sequence parallelism).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
import torch.utils.checkpoint

from otpose_tpu_torch.engine.optim import Optimizer
from otpose_tpu_torch.engine.runner import make_flip_eval_step
from otpose_tpu_torch.evaluate.pck import accuracy_device
from otpose_tpu_torch.models import core
from otpose_tpu_torch.models.conv_transformer import seq_sharded_parameters
from otpose_tpu_torch.models.losses import st_ohkw_mse_loss
from otpose_tpu_torch.models.otpose import OTPose, otpose_forward
from otpose_tpu_torch.ops.heatmap import get_max_preds_device, refine_coords_device
from otpose_tpu_torch.parallel import distributed
from otpose_tpu_torch.utils.device import resolve_dtype

METRICS = ("final_loss", "ohkm_loss_s", "mse_loss_s", "occ_final_loss", "pck_acc")


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the number of updates made."""
    model: OTPose
    optimizer: Optimizer

    @property
    def step(self) -> int:
        return self.optimizer.count


def init_train_state(model: OTPose, optimizer: Optimizer) -> TrainState:
    return TrainState(model, optimizer)


def compute_losses(model: OTPose, batch: Dict[str, torch.Tensor], *,
                   compute_dtype=torch.float32, topk: int = 8,
                   use_target_weight: bool = True, seq=None):
    """Forward + the reference's loss combination (ref: Common.py:122-130).

    batch: 'inputs' (B, H, W, 15), 'margin' (B, 4), 'target' (B, Hh, Hw, J),
    'target_weight' (B, J, 1).  Returns (total loss, metrics, output): the
    teacher is ``rough[:B]``, not detached, as in the reference; the
    occlusion target ``(target + intersection) / 2`` is scored against
    ``context_encoding``."""
    out = otpose_forward(model, batch["inputs"], batch["margin"], compute_dtype=compute_dtype,
                         seq=seq)
    output, rough, intersection, _prev_b, context_encoding, _sq, _tb = out
    target, weight = batch["target"], batch["target_weight"]
    losses = st_ohkw_mse_loss(output, rough[:batch["inputs"].shape[0]], target, weight,
                              topk=topk, use_target_weight=use_target_weight)
    occlusion = (target + intersection) / 2
    aux = st_ohkw_mse_loss(context_encoding, context_encoding, occlusion, weight, topk=topk,
                           use_target_weight=use_target_weight)
    total = losses["final_loss"] + aux["final_loss"]
    pck, _ = accuracy_device(output.detach(), target)
    metrics = {"final_loss": total, "ohkm_loss_s": losses["ohkm_loss_s"],
               "mse_loss_s": losses["mse_loss_s"], "occ_final_loss": aux["final_loss"],
               "pck_acc": pck}
    return total, metrics, output


def make_train_step(model: OTPose, optimizer: Optimizer, *, compute_dtype=torch.float32,
                    topk: int = 8, use_target_weight: bool = True, remat: bool = False,
                    accum_steps: int = 1,
                    generator: torch.Generator | None = None, seq=None) -> Callable:
    """``step(batch) -> metrics``: one optimizer update of ``model`` on
    ``batch`` (see ``compute_losses``; tensors on the model's device).
    Metrics are 0-d f32 tensors on the device: the five of
    ``compute_losses`` and ``grad_norm``, the global norm of the unclipped
    gradients.

    ``accum_steps = K`` (``TPU.ACCUM_STEPS``) runs the batch as K
    micro-batches one after another: BN statistics, OHKM and the dropout
    draws are each micro-batch's own, gradients and metrics are averaged,
    the optimizer updates once.  ``remat`` (``TPU.REMAT``) recomputes each
    micro-batch's forward in its backward (``torch.utils.checkpoint``); the
    generator is rewound for the recompute, so the backward sees the same
    dropout masks.  Running stats are committed once per micro-batch.

    Under a multi-process launch (``parallel/distributed.py``) ``batch``
    is this rank's rows of the global batch (``distributed.local_rows``:
    its micro-batch ``i`` is its share of global micro-batch ``i``); BN,
    the loss's labelled test and the PCK meter decide over the global
    (micro-)batch, and the gradients and metrics are averaged across the
    ranks before the optimizer, so every rank makes the JAX step's update
    on the global batch and holds the same weights and running stats.

    Under a ``data x seq`` mesh ``seq`` is this rank's ``SeqGroup``: the
    ranks of a seq group hold the same rows (their data group's) and split
    the encoders' tokens, with the same generator state (the dropout masks
    are drawn whole and sliced).  Each encoder block's parameter
    (``seq_sharded_parameters``) then has a partial gradient, from this
    rank's tokens only: those are summed over the seq group first.  Every
    other gradient is already whole and equal on the seq group's ranks.
    Then every gradient and metric is averaged over the data group (one
    average over every rank would leave the encoders' gradients S times
    too small), and BN, the labelled test and the meter decide over the
    data group."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps (cfg.TPU.ACCUM_STEPS) must be >= 1, got {accum_steps}; "
                         "use 1 to disable gradient accumulation")
    dtype = resolve_dtype(compute_dtype)
    sharded = [] if seq is None else list(seq_sharded_parameters(model))

    def loss_fn(mb):
        total, metrics, _ = compute_losses(model, mb, compute_dtype=dtype, topk=topk,
                                           use_target_weight=use_target_weight, seq=seq)
        return total, metrics

    def run(mb):
        if not remat:
            return loss_fn(mb)
        state = None if generator is None else generator.get_state()

        def rewound(mb):
            if state is not None:
                generator.set_state(state)
            return loss_fn(mb)

        return torch.utils.checkpoint.checkpoint(rewound, mb, use_reentrant=False)

    def step(batch):
        b = batch["inputs"].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch size {b} not divisible by accum_steps {accum_steps}")
        model.train()
        optimizer.zero_grad()
        micro = [{k: v[i * (b // accum_steps):(i + 1) * (b // accum_steps)]
                  for k, v in batch.items()} for i in range(accum_steps)]
        sums = None
        with core.use_generator(generator):
            for mb in micro:
                total, metrics = run(mb)
                after = generator.get_state() if remat and generator is not None else None
                (total / accum_steps).backward()
                if after is not None:     # the recompute may stop short of the end
                    generator.set_state(after)
                core.commit_bn_stats(model)
                metrics = {k: v.detach().float() for k, v in metrics.items()}
                sums = metrics if sums is None else {k: sums[k] + v for k, v in metrics.items()}
        out = {k: v / accum_steps for k, v in sums.items()}
        if distributed.active():
            # the encoders' partial gradients summed over the seq group, then
            # the global batch's gradients and metrics, once a step
            distributed.sum_((p.grad for p in sharded if p.grad is not None), group="seq")
            distributed.average_(p.grad for p in optimizer.params if p.grad is not None)
            values = torch.stack(list(out.values()))
            distributed.average_([values])
            out = dict(zip(out, values))
        out["grad_norm"] = optimizer.step()
        return out

    return step


def make_eval_step(model: OTPose, *, compute_dtype=torch.float32,
                   fused: bool = True, seq=None) -> Callable:
    """Eval forward: ``step(inputs (B, H, W, 15), margin (B, 4))`` ->
    (heatmaps (B, Hh, Hw, J), teacher (B, Hh, Hw, J)): the refined heatmaps
    and the rough heatmaps of the current frame.  The step puts the model
    in eval mode (running-stat BN, no dropout, the fused kernels), as the
    train step puts it in train mode.  ``seq``: sequence parallelism (no
    fused kernel runs, as under JAX's ``seq_axis``)."""
    dtype = resolve_dtype(compute_dtype)

    @torch.inference_mode()
    def step(inputs, margin):
        model.eval()
        out = otpose_forward(model, inputs, margin, compute_dtype=dtype, fused=fused, seq=seq)
        return out[0], out[1][:inputs.shape[0]]

    return step


def make_decoded_eval_step(model: OTPose, *, compute_dtype=torch.float32,
                           flip: bool = False, fused: bool = True, seq=None) -> Callable:
    """Eval forward + on-device decode: ``step(inputs (B, H, W, 15),
    margin (B, 4))`` -> (refined_coords (B, J, 2), maxvals (B, J, 1),
    raw_coords (B, J, 2)), in heatmap space, on the model's device.
    ``flip=True`` decodes the flip-test average of ``make_flip_eval_step``
    (two forwards a step).  ``fused=False`` keeps every block on the plain
    PyTorch path; ``seq`` runs it sequence parallel."""
    dtype = resolve_dtype(compute_dtype)
    if flip:
        forward = make_flip_eval_step(model, compute_dtype=dtype, fused=fused, seq=seq)
    else:
        forward = make_eval_step(model, compute_dtype=dtype, fused=fused, seq=seq)

    @torch.inference_mode()
    def step(inputs, margin):
        heat = forward(inputs, margin)[0].permute(0, 3, 1, 2)
        coords, maxvals = refine_coords_device(heat)
        raw_coords, _ = get_max_preds_device(heat)
        return coords, maxvals, raw_coords

    return step
