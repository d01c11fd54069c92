"""Eval step of the port (counterpart of ``otpose_tpu/engine/trainer.py``'s
``make_decoded_eval_step``, single device, no flip)."""

from __future__ import annotations

from typing import Callable

import torch

from otpose_tpu_torch.models.otpose import OTPose, otpose_forward
from otpose_tpu_torch.ops.heatmap import get_max_preds_device, refine_coords_device
from otpose_tpu_torch.utils.device import resolve_dtype


def make_decoded_eval_step(model: OTPose, *, compute_dtype=torch.float32,
                           fused: bool = True) -> Callable:
    """Eval forward + on-device decode: ``step(inputs (B, H, W, 15),
    margin (B, 4))`` -> (refined_coords (B, J, 2), maxvals (B, J, 1),
    raw_coords (B, J, 2)), in heatmap space, on the model's device.
    ``fused=False`` keeps every block on the plain PyTorch path."""
    dtype = resolve_dtype(compute_dtype)

    @torch.inference_mode()
    def step(inputs, margin):
        out = otpose_forward(model, inputs, margin, compute_dtype=dtype, fused=fused)
        heat = out[0].permute(0, 3, 1, 2)
        coords, maxvals = refine_coords_device(heat)
        raw_coords, _ = get_max_preds_device(heat)
        return coords, maxvals, raw_coords

    return step
