"""Batch assembly and batched device preprocessing (counterpart of
``otpose_tpu/data/pipeline.py``).

The reference warps, normalises and draws gaussian targets box by box on
the host (ref: PoseTrackDataset.py:388-425).  The device path ships uint8
pixels and does the rest for the whole batch on the tensors' device.

Host -> device contract per batch:
  raw_frames  (B, 5, H, W, 3) uint8 (decoded, optionally pre-flipped/blurred)
  inv_trans   (B, 2, 3)  inverse crop matrices (shared by all 5 frames,
                          ref: PoseTrackDataset.py:389-399 uses one matrix)
  joints      (B, J, 2)  crop-space joint coords (host-warped, cheap)
  joints_vis  (B, J)
  margins     (B, 4)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from otpose_tpu_torch.data.posetrack import IMAGENET_MEAN, IMAGENET_STD
from otpose_tpu_torch.ops.affine import warp_affine_separable
from otpose_tpu_torch.ops.heatmap import generate_heatmaps_device


def _normalize(crops: torch.Tensor) -> torch.Tensor:
    """uint8-valued f32 pixels -> ImageNet-normalised, as the host path: the
    same three IEEE f32 operations (the divisor 255 is a tensor, not a
    Python number, which a CUDA division would turn into a multiplication
    by its rounded reciprocal), so the crops mode's inputs equal the host
    loader's bit for bit."""
    dev = crops.device
    mean = torch.from_numpy(IMAGENET_MEAN).to(dev)
    std = torch.from_numpy(IMAGENET_STD).to(dev)
    return (crops / torch.tensor(255.0, device=dev) - mean) / std


def _targets(joints, joints_vis, sigma, out_h, out_w, hm_h, hm_w, num_joints):
    """NHWC gaussian targets (B, Hh, Hw, J) and weights (B, J, 1)."""
    feat_stride = torch.tensor([out_w / hm_w, out_h / hm_h], dtype=torch.float32,
                               device=joints.device)
    target, weight = generate_heatmaps_device(joints, joints_vis, sigma, feat_stride,
                                              hm_w, hm_h, num_joints)
    return target.permute(0, 2, 3, 1).contiguous(), weight


def preprocess_batch(raw_frames: torch.Tensor, inv_trans: torch.Tensor, joints: torch.Tensor,
                     joints_vis: torch.Tensor, sigma, *, out_h: int, out_w: int, hm_h: int,
                     hm_w: int, num_joints: int) -> Dict[str, torch.Tensor]:
    """(B, 5, H, W, 3) uint8 frames -> the model's batch, on their device:
    the five frames warped by the separable warp (axis-aligned matrices:
    rotated train samples arrive pre-warped with an identity matrix),
    normalised and stacked to (B, out_h, out_w, 15) in the channel order
    (cur, prev, next, pprev, nnext), with NHWC targets and their weights."""
    b, f, h, w, c = raw_frames.shape
    flat = raw_frames.reshape(b * f, h, w, c).float()
    inv5 = inv_trans.repeat_interleave(f, dim=0)
    crops = _normalize(warp_affine_separable(flat, inv5, out_h, out_w))
    inputs = crops.reshape(b, f, out_h, out_w, c).permute(0, 2, 3, 1, 4).reshape(
        b, out_h, out_w, f * c)
    target, weight = _targets(joints, joints_vis, sigma, out_h, out_w, hm_h, hm_w, num_joints)
    return {"inputs": inputs, "target": target, "target_weight": weight}


def preprocess_crops_batch(crops_u8: torch.Tensor, joints: torch.Tensor,
                           joints_vis: torch.Tensor, sigma, *, hm_h: int, hm_w: int,
                           num_joints: int) -> Dict[str, torch.Tensor]:
    """Pre-warped (B, 5, oh, ow, 3) uint8 crops -> the model's batch, on
    their device: normalise, the 15-channel temporal assembly and the
    gaussian targets.  Pixel numerics equal the host path's (the same host
    warp made the crops)."""
    b, f, oh, ow, c = crops_u8.shape
    crops = _normalize(crops_u8.float())
    inputs = crops.permute(0, 2, 3, 1, 4).reshape(b, oh, ow, f * c)
    target, weight = _targets(joints, joints_vis, sigma, oh, ow, hm_h, hm_w, num_joints)
    return {"inputs": inputs, "target": target, "target_weight": weight}


def collate_host_samples(samples) -> Dict[str, np.ndarray]:
    """Stack host-path samples (from PoseTrackDataset.get_sample_host)."""
    batch = {
        "inputs": np.stack([s["inputs"] for s in samples]),
        "target": np.stack([s["target"] for s in samples]),
        "target_weight": np.stack([s["target_weight"] for s in samples]),
        "margin": np.stack([s["margin"] for s in samples]),
    }
    metas = [s["meta"] for s in samples]
    return batch, metas
