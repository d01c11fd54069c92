"""Eval steps of the port (counterpart of ``otpose_tpu/engine/trainer.py``'s
``make_eval_step`` and ``make_decoded_eval_step``, single device)."""

from __future__ import annotations

from typing import Callable

import torch

from otpose_tpu_torch.engine.runner import make_flip_eval_step
from otpose_tpu_torch.models.otpose import OTPose, otpose_forward
from otpose_tpu_torch.ops.heatmap import get_max_preds_device, refine_coords_device
from otpose_tpu_torch.utils.device import resolve_dtype


def make_eval_step(model: OTPose, *, compute_dtype=torch.float32,
                   fused: bool = True) -> Callable:
    """Eval forward: ``step(inputs (B, H, W, 15), margin (B, 4))`` ->
    (heatmaps (B, Hh, Hw, J), teacher (B, Hh, Hw, J)): the refined heatmaps
    and the rough heatmaps of the current frame."""
    dtype = resolve_dtype(compute_dtype)

    @torch.inference_mode()
    def step(inputs, margin):
        out = otpose_forward(model, inputs, margin, compute_dtype=dtype, fused=fused)
        return out[0], out[1][:inputs.shape[0]]

    return step


def make_decoded_eval_step(model: OTPose, *, compute_dtype=torch.float32,
                           flip: bool = False, fused: bool = True) -> Callable:
    """Eval forward + on-device decode: ``step(inputs (B, H, W, 15),
    margin (B, 4))`` -> (refined_coords (B, J, 2), maxvals (B, J, 1),
    raw_coords (B, J, 2)), in heatmap space, on the model's device.
    ``flip=True`` decodes the flip-test average of ``make_flip_eval_step``
    (two forwards a step).  ``fused=False`` keeps every block on the plain
    PyTorch path."""
    dtype = resolve_dtype(compute_dtype)
    if flip:
        forward = make_flip_eval_step(model, compute_dtype=dtype, fused=fused)
    else:
        forward = make_eval_step(model, compute_dtype=dtype, fused=fused)

    @torch.inference_mode()
    def step(inputs, margin):
        heat = forward(inputs, margin)[0].permute(0, 3, 1, 2)
        coords, maxvals = refine_coords_device(heat)
        raw_coords, _ = get_max_preds_device(heat)
        return coords, maxvals, raw_coords

    return step
