"""On-device keypoint decoding (counterpart of the device half of
``otpose_tpu/ops/heatmap.py``): argmax and the quarter-pixel shift of the
reference's ``get_final_preds`` (ref: utils/heatmap.py:108-171)."""

from __future__ import annotations

import torch


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
