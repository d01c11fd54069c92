"""Flip-test eval forward (counterpart of
``otpose_tpu/engine/runner.py::make_flip_eval_step``)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from otpose_tpu_torch.data.posetrack import FLIP_PAIRS
from otpose_tpu_torch.models.otpose import OTPose, otpose_forward
from otpose_tpu_torch.utils.device import resolve_dtype


def flip_permutation(num_joints: int) -> list:
    """The joint order that swaps each left/right pair of ``FLIP_PAIRS``."""
    pairs = np.asarray(FLIP_PAIRS)
    perm = np.arange(num_joints)
    perm[pairs[:, 0]], perm[pairs[:, 1]] = pairs[:, 1], pairs[:, 0]
    return perm.tolist()


def make_flip_eval_step(model: OTPose, *, compute_dtype=torch.float32,
                        fused: bool = True) -> Callable:
    """Eval forward with horizontal flip-test averaging: ``step(inputs
    (B, H, W, 15), margin (B, 4))`` -> (heatmaps (B, Hh, Hw, J), teacher
    (B, Hh, Hw, J)).

    The clip is flipped on W and run a second time; those heatmaps are
    unflipped, their left/right joints swapped, and shifted right by one
    column with column 0 duplicated (the simple-baselines shift), then
    averaged with the direct pass.  The teacher is the direct pass's rough
    heatmaps of the current frame."""
    dtype = resolve_dtype(compute_dtype)
    perm = flip_permutation(model.spec.num_joints)

    @torch.inference_mode()
    def step(inputs, margin):
        out = otpose_forward(model, inputs, margin, compute_dtype=dtype, fused=fused)
        out_f = otpose_forward(model, torch.flip(inputs, dims=[2]), margin,
                               compute_dtype=dtype, fused=fused)
        heat_f = torch.flip(out_f[0], dims=[2])[..., perm]
        heat_f = torch.cat([heat_f[:, :, :1], heat_f[:, :, :-1]], dim=2)
        return (out[0] + heat_f) * 0.5, out[1][:inputs.shape[0]]

    return step
