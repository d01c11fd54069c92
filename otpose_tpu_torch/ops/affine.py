"""Affine geometry ops (counterpart of ``otpose_tpu/ops/affine.py``).

The host-side matrix construction is the JAX package's numpy code, copied
(ref: utils/transform.py:76-126; ``cv2.getAffineTransform`` as an exact
3-point solve).  ``warp_affine`` is the batched bilinear warp of
``cv2.warpAffine(..., INTER_LINEAR, BORDER_CONSTANT 0)`` in plain torch ops
on the images' device, with the JAX version's arithmetic: f32 source
coordinates from the f32 inverse matrices, four zero-masked corner gathers,
and the fractional weights cast to the image dtype before the blend.
``fliplr_joints`` is the train-time joint flip.
"""

from __future__ import annotations

import numpy as np
import torch


def get_dir(src_point, rot_rad):
    """Rotate a 2-vector (ref: utils/transform.py:108-115)."""
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return [
        src_point[0] * cs - src_point[1] * sn,
        src_point[0] * sn + src_point[1] * cs,
    ]


def get_3rd_point(a, b):
    """Third point of the affine triangle (ref: utils/transform.py:118-120)."""
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 3-point affine solve == cv2.getAffineTransform(src, dst)."""
    a = np.zeros((6, 6), dtype=np.float64)
    b = np.zeros(6, dtype=np.float64)
    for i in range(3):
        a[i, 0:2] = src[i]
        a[i, 2] = 1.0
        a[i + 3, 3:5] = src[i]
        a[i + 3, 5] = 1.0
        b[i] = dst[i, 0]
        b[i + 3] = dst[i, 1]
    x = np.linalg.solve(a, b)
    return x.reshape(2, 3)


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.array([0, 0], dtype=np.float32), inv=0) -> np.ndarray:
    """Center/scale/rot -> 2x3 crop matrix (ref: utils/transform.py:76-105).

    `scale` is in units of pixel_std=200; `output_size` is (w, h). `inv=1`
    returns the back-projection (crop -> original image) matrix.
    """
    center = np.asarray(center, dtype=np.float32)
    if not isinstance(scale, np.ndarray) and not isinstance(scale, list):
        scale = np.array([scale, scale])
    scale = np.asarray(scale, dtype=np.float32)
    shift = np.asarray(shift, dtype=np.float32)

    scale_tmp = scale * 200.0
    src_w = scale_tmp[0]
    dst_w = output_size[0]
    dst_h = output_size[1]

    rot_rad = np.pi * rot / 180.0
    src_dir = get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale_tmp * shift
    src[1, :] = center + src_dir + scale_tmp * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    src[2:, :] = get_3rd_point(src[0, :], src[1, :])
    dst[2:, :] = get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def exec_affine_transform(pt, t) -> np.ndarray:
    """Apply a 2x3 affine to one point (ref: utils/transform.py:123-126)."""
    new_pt = np.array([pt[0], pt[1], 1.0]).T
    return np.dot(t, new_pt)[:2]


def apply_affine_to_points(points: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to an (N, 2) array of points (vectorized)."""
    points = np.asarray(points, dtype=np.float64)
    return points @ t[:, :2].T + t[:, 2]


def invert_affine(t: np.ndarray) -> np.ndarray:
    """Invert a 2x3 affine matrix."""
    m = np.eye(3, dtype=np.float64)
    m[:2, :] = t
    return np.linalg.inv(m)[:2, :]


def warp_affine(images: torch.Tensor, inv_matrices, out_h: int, out_w: int) -> torch.Tensor:
    """Batched bilinear warp given the *inverse* (dst->src) 2x3 matrices.

    images: (B, H, W, C) float tensor; inv_matrices: (B, 2, 3), a tensor or
    an array (use ``invert_affine`` on the forward matrix).  Returns
    (B, out_h, out_w, C) on the images' device, in their dtype."""
    b, in_h, in_w, c = images.shape
    dev = images.device
    m = torch.as_tensor(inv_matrices).to(device=dev, dtype=torch.float32)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")   # (out_h, out_w)

    def coord(row):
        return (m[:, row, 0, None, None] * grid_x + m[:, row, 1, None, None] * grid_y
                + m[:, row, 2, None, None])

    src_x, src_y = coord(0), coord(1)
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    wx = (src_x - x0)[..., None].to(images.dtype)
    wy = (src_y - y0)[..., None].to(images.dtype)
    x0i, y0i = x0.long(), y0.long()
    flat = images.reshape(b, in_h * in_w, c)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < in_h) & (xi >= 0) & (xi < in_w)
        idx = yi.clamp(0, in_h - 1) * in_w + xi.clamp(0, in_w - 1)
        vals = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        return vals.reshape(b, out_h, out_w, c) * valid[..., None].to(images.dtype)

    top = gather(y0i, x0i) * (1 - wx) + gather(y0i, x0i + 1) * wx
    bot = gather(y0i + 1, x0i) * (1 - wx) + gather(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy


def warp_affine_separable(images: torch.Tensor, inv_matrices: torch.Tensor,
                          out_h: int, out_w: int) -> torch.Tensor:
    """Axis-aligned (no rotation or shear) bilinear warp as two batched
    products, ``out = Ty @ img @ Tx^T`` with tent weights
    ``T[i, s] = relu(1 - |coord_i - s|)``: cv2.warpAffine (INTER_LINEAR,
    BORDER_CONSTANT 0) including the border blend (counterpart of
    ``otpose_tpu/ops/affine.py::warp_affine_separable``, which the JAX
    package computes with two einsums outside any Pallas kernel).

    images: (B, H, W, C) float tensor; inv_matrices: (B, 2, 3) diagonal
    dst->src maps (``inv[:, 0, 1] == inv[:, 1, 0] == 0``: every eval crop and
    every un-rotated train sample).  Returns (B, out_h, out_w, C) in the
    images' dtype.  The products accumulate in f32; on a GPU they must not
    run in TF32 (the JAX path asks for full f32 precision), so a call on a
    CUDA tensor raises while ``torch.backends.cuda.matmul.allow_tf32`` is on
    (off is PyTorch's default, and nothing in the port turns it on)."""
    if images.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("warp_affine_separable: TF32 matmuls are on "
                           "(torch.backends.cuda.matmul.allow_tf32); the warp needs full f32")
    b, in_h, in_w, c = images.shape
    dev = images.device
    # the source coordinates a * i + t rounded once to f32, as the JAX
    # package's jit computes them (one fused multiply-add): a product of two
    # f32 values is exact in f64
    m = inv_matrices.to(device=dev, dtype=torch.float32).double()
    ys = torch.arange(out_h, dtype=torch.float64, device=dev)
    xs = torch.arange(out_w, dtype=torch.float64, device=dev)
    src_y = (m[:, 1, 1, None] * ys[None] + m[:, 1, 2, None]).float()     # (B, out_h)
    src_x = (m[:, 0, 0, None] * xs[None] + m[:, 0, 2, None]).float()     # (B, out_w)
    iota_h = torch.arange(in_h, dtype=torch.float32, device=dev)
    iota_w = torch.arange(in_w, dtype=torch.float32, device=dev)
    ty = torch.clamp(1.0 - torch.abs(src_y[:, :, None] - iota_h), min=0.0)  # (B, oh, H)
    tx = torch.clamp(1.0 - torch.abs(src_x[:, :, None] - iota_w), min=0.0)  # (B, ow, W)
    tmp = torch.einsum("boh,bhwc->bowc", ty, images.float())
    out = torch.einsum("bpw,bowc->bopc", tx, tmp)
    return out.to(images.dtype)


def fliplr_joints(joints: np.ndarray, joints_vis: np.ndarray, width: int,
                  matched_parts) -> tuple[np.ndarray, np.ndarray]:
    """Horizontal joint flip with left/right pair swap (ref: utils/transform.py:59-73)."""
    joints = joints.copy()
    joints_vis = joints_vis.copy()
    joints[:, 0] = width - joints[:, 0] - 1
    for pair in matched_parts:
        joints[pair[0], :], joints[pair[1], :] = \
            joints[pair[1], :].copy(), joints[pair[0], :].copy()
        joints_vis[pair[0], :], joints_vis[pair[1], :] = \
            joints_vis[pair[1], :].copy(), joints_vis[pair[0], :].copy()
    return joints * joints_vis, joints_vis
