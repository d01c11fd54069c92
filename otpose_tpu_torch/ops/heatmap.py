"""Keypoint decoding and host target generation (counterpart of
``otpose_tpu/ops/heatmap.py``).

On the device: argmax and the quarter-pixel shift of the reference's
``get_final_preds`` (ref: utils/heatmap.py:108-171), and the batched
gaussian targets of the device preprocessing.  On the host, in
numpy: the argmax of ``get_max_preds`` and the back-projection of
``transform_preds`` / ``get_final_preds``, and the gaussian targets of
``generate_heatmaps`` (peak 1.0 at truncated-rounded grid coords, written
inside the clipped 3-sigma window; ref: utils/heatmap.py:48-105), and the
training's sigma annealing ``adjust_sigma``.
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


def generate_heatmaps_device(joints: torch.Tensor, joints_vis: torch.Tensor, sigma,
                             feat_stride: torch.Tensor, hm_w: int, hm_h: int,
                             num_joints: int):
    """Batched gaussian targets on the joints' device (counterpart of
    ``otpose_tpu/ops/heatmap.py::generate_heatmaps_device``; the semantics of
    ``generate_heatmaps``: truncation rounding, the 3-sigma window, peak 1.0,
    weight 0 out of bounds).

    joints: (B, J, 2) f32; joints_vis: (B, J); sigma: a scalar; feat_stride:
    (2,) f32.  Returns target (B, J, Hh, Hw) and weight (B, J, 1), f32."""
    dev = joints.device
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    feat_stride = torch.as_tensor(feat_stride, dtype=torch.float32, device=dev)
    tmp_size = sigma * 3.0
    mu = torch.trunc(joints.float() / feat_stride[None, None, :] + 0.5)   # (B, J, 2)
    mu_x, mu_y = mu[..., 0], mu[..., 1]
    itmp = torch.trunc(tmp_size)
    ul_x, ul_y = mu_x - itmp, mu_y - itmp
    br_x, br_y = mu_x + itmp + 1, mu_y + itmp + 1
    oob = (ul_x >= hm_w) | (ul_y >= hm_h) | (br_x < 0) | (br_y < 0)
    weight = torch.where(oob, torch.zeros((), device=dev), joints_vis.float())   # (B, J)

    xs = torch.arange(hm_w, dtype=torch.float32, device=dev)[None, None, None, :]
    ys = torch.arange(hm_h, dtype=torch.float32, device=dev)[None, None, :, None]
    dx = xs - mu_x[..., None, None]
    dy = ys - mu_y[..., None, None]
    g = torch.exp(-(dx ** 2 + dy ** 2) / (2 * sigma ** 2))
    window = (torch.abs(dx) <= tmp_size) & (torch.abs(dy) <= tmp_size)
    visible = (weight > 0.5)[..., None, None]
    target = torch.where(window & visible, g, torch.zeros((), device=dev))
    return target, weight[..., None]


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


def _trunc_int(x: np.ndarray) -> np.ndarray:
    """python int() semantics: truncation toward zero."""
    return np.trunc(x).astype(np.int64)


def generate_heatmaps(joints: np.ndarray, joints_vis: np.ndarray, sigma: float,
                      image_size, heatmap_size, num_joints: int, **kwargs):
    """Gaussian targets + per-joint weights (ref: utils/heatmap.py:48-105).

    joints: (J, 3) in input-image coords; joints_vis: (J, 3) with vis in col 0.
    image_size/heatmap_size: (w, h). Returns (target (J, Hh, Hw), weight (J, 1)).
    """
    image_size = np.asarray(image_size, dtype=np.float64)
    heatmap_size = np.asarray(heatmap_size, dtype=np.float64)
    hm_w, hm_h = int(heatmap_size[0]), int(heatmap_size[1])

    target_weight = np.ones((num_joints, 1), dtype=np.float32)
    target_weight[:, 0] = joints_vis[:, 0]

    tmp_size = sigma * 3
    feat_stride = image_size / heatmap_size
    mu_x = _trunc_int(joints[:, 0] / feat_stride[0] + 0.5)  # (J,)
    mu_y = _trunc_int(joints[:, 1] / feat_stride[1] + 0.5)
    ul_x, ul_y = mu_x - int(tmp_size), mu_y - int(tmp_size)
    br_x, br_y = mu_x + int(tmp_size) + 1, mu_y + int(tmp_size) + 1

    oob = (ul_x >= hm_w) | (ul_y >= hm_h) | (br_x < 0) | (br_y < 0)
    target_weight[oob, 0] = 0

    xs = np.arange(hm_w, dtype=np.float32)[None, None, :]   # (1, 1, Hw)
    ys = np.arange(hm_h, dtype=np.float32)[None, :, None]   # (1, Hh, 1)
    dx = xs - mu_x[:, None, None].astype(np.float32)
    dy = ys - mu_y[:, None, None].astype(np.float32)
    g = np.exp(-(dx ** 2 + dy ** 2) / (2 * sigma ** 2))
    # only the clipped window region is written; the tail outside stays 0
    window = (np.abs(dx) <= tmp_size) & (np.abs(dy) <= tmp_size)
    visible = (target_weight[:, 0] > 0.5)[:, None, None]
    target = np.where(window & visible & ~oob[:, None, None], g, 0.0).astype(np.float32)

    if kwargs.get("use_different_joints_weight"):
        target_weight = np.multiply(target_weight, kwargs["joints_weight"])
    return target, target_weight


def adjust_sigma(epoch: int, sigma: float, schedule) -> float:
    """Sigma annealing (ref: utils/heatmap.py:181-187): one less for each
    epoch of ``schedule`` that ``epoch`` has reached, never below 1."""
    for step in schedule:
        if epoch >= step:
            sigma -= 1
    return max(sigma, 1)
