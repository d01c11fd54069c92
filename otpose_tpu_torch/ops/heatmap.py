"""Keypoint decoding (counterpart of ``otpose_tpu/ops/heatmap.py``'s decode).

On the device: argmax and the quarter-pixel shift of the reference's
``get_final_preds`` (ref: utils/heatmap.py:108-171).  On the host, in
numpy: the argmax of ``get_max_preds`` and the back-projection of
``transform_preds`` / ``get_final_preds``.
"""

from __future__ import annotations

import numpy as np
import torch

from otpose_tpu_torch.ops.affine import exec_affine_transform, get_affine_transform


def get_max_preds_device(batch_heatmaps: torch.Tensor):
    """(B, J, H, W) -> (coords (B, J, 2) as (x, y), maxvals (B, J, 1)).
    Ties go to the first maximum; coords are zeroed where the max is <= 0."""
    b, j, h, w = batch_heatmaps.shape
    flat = batch_heatmaps.reshape(b, j, h * w)
    idx = torch.argmax(flat, dim=2)
    maxvals = torch.amax(flat, dim=2)[..., None]
    px = (idx % w).float()
    py = torch.floor(idx.float() / w)
    preds = torch.stack([px, py], dim=-1)
    return preds * (maxvals > 0.0).float(), maxvals


def refine_coords_device(batch_heatmaps: torch.Tensor):
    """Argmax plus the quarter-pixel shift toward the gradient sign, for
    peaks strictly inside the border (1 < p < size - 1)."""
    b, j, h, w = batch_heatmaps.shape
    coords, maxvals = get_max_preds_device(batch_heatmaps)
    px = coords[..., 0].long()
    py = coords[..., 1].long()
    flat = batch_heatmaps.reshape(b, j, h * w)

    def sample(yy, xx):
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        return torch.gather(flat, 2, idx[..., None])[..., 0]

    dx = sample(py, px + 1) - sample(py, px - 1)
    dy = sample(py + 1, px) - sample(py - 1, px)
    inner = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    shift = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25
    return coords + shift * inner[..., None].to(coords.dtype), maxvals


def get_max_preds(batch_heatmaps: np.ndarray):
    """Host argmax decode (ref: utils/heatmap.py:143-171). heatmaps: (B, J, H, W)."""
    if batch_heatmaps.ndim != 4:
        raise ValueError("batch_heatmaps should be 4-ndim")
    batch_size, num_joints = batch_heatmaps.shape[:2]
    width = batch_heatmaps.shape[3]
    flat = batch_heatmaps.reshape((batch_size, num_joints, -1))
    idx = np.argmax(flat, 2).reshape((batch_size, num_joints, 1))
    maxvals = np.amax(flat, 2).reshape((batch_size, num_joints, 1))

    preds = np.tile(idx, (1, 1, 2)).astype(np.float32)
    preds[:, :, 0] = preds[:, :, 0] % width
    preds[:, :, 1] = np.floor(preds[:, :, 1] / width)

    pred_mask = np.tile(np.greater(maxvals, 0.0), (1, 1, 2)).astype(np.float32)
    preds *= pred_mask
    return preds, maxvals


def transform_preds(coords: np.ndarray, center, scale, output_size) -> np.ndarray:
    """Heatmap coords -> original image coords (ref: utils/heatmap.py:135-140)."""
    target_coords = np.zeros(coords.shape)
    trans = get_affine_transform(center, scale, 0, output_size, inv=1)
    for p in range(coords.shape[0]):
        target_coords[p, 0:2] = exec_affine_transform(coords[p, 0:2], trans)
    return target_coords


def get_final_preds(batch_heatmaps, center: np.ndarray, scale: np.ndarray):
    """Full decode (ref: utils/heatmap.py:108-132): ``refine_coords_device``
    on the heatmaps' device (a (B, J, H, W) tensor or array), then the f64
    back-projection on the host.  Returns numpy (preds (B, J, 2),
    maxvals (B, J, 1))."""
    heat = torch.as_tensor(batch_heatmaps)
    coords, maxvals = refine_coords_device(heat)
    coords, maxvals = coords.cpu().numpy(), maxvals.cpu().numpy()
    heatmap_height, heatmap_width = heat.shape[2], heat.shape[3]
    preds = coords.copy()
    for i in range(coords.shape[0]):
        preds[i] = transform_preds(coords[i], center[i], scale[i],
                                   [heatmap_width, heatmap_height])
    return preds, maxvals
