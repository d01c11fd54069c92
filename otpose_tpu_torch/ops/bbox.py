"""Bounding-box <-> center/scale conversions (the port's copy of
``otpose_tpu/ops/bbox.py``; ref: utils/bbox.py:7-55)."""

from __future__ import annotations

import numpy as np

PIXEL_STD = 200


def box2cs(box, aspect_ratio: float, enlarge_factor: float = 1.0):
    """(x, y, w, h) -> (center, scale) with aspect-ratio fit (ref: utils/bbox.py:7-14)."""
    x, y, w, h = box[:4]
    return xywh2cs(x, y, w, h, aspect_ratio, enlarge_factor)


def xywh2cs(x, y, w, h, aspect_ratio, enlarge_factor):
    """ref: utils/bbox.py:17-31."""
    center = np.zeros(2, dtype=np.float32)
    center[0] = x + w * 0.5
    center[1] = y + h * 0.5

    if w > aspect_ratio * h:
        h = w * 1.0 / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w * 1.0 / PIXEL_STD, h * 1.0 / PIXEL_STD], dtype=np.float32)
    if center[0] != -1:
        scale = scale * enlarge_factor
    return center, scale


def cs2box(center, scale, pixel_std=PIXEL_STD, pattern="xywh"):
    """(center, scale) -> bbox in 'xywh' or 'xyxy' (ref: utils/bbox.py:34-55)."""
    w = scale[0] * pixel_std
    h = scale[1] * pixel_std
    if pattern == "xyxy":
        return [center[0] - w * 0.5, center[1] - h * 0.5,
                center[0] + w * 0.5, center[1] + h * 0.5]
    return [center[0] - w * 0.5, center[1] - h * 0.5, w, h]


def half_body_center_scale(joints, joints_vis, num_joints, upper_body_ids,
                           aspect_ratio, pixel_std=PIXEL_STD, rng=None):
    """Half-body augmentation center/scale (ref: utils/transform.py:20-56)."""
    rng = rng or np.random
    upper_joints, lower_joints = [], []
    for joint_id in range(num_joints):
        if joints_vis[joint_id][0] > 0:
            (upper_joints if joint_id in upper_body_ids else lower_joints).append(joints[joint_id])

    if rng.randn() < 0.5 and len(upper_joints) > 2:
        selected = upper_joints
    else:
        selected = lower_joints if len(lower_joints) > 2 else upper_joints
    if len(selected) < 2:
        return None, None

    selected = np.array(selected, dtype=np.float32)
    center = selected.mean(axis=0)[:2]
    left_top = np.amin(selected, axis=0)
    right_bottom = np.amax(selected, axis=0)
    w = right_bottom[0] - left_top[0]
    h = right_bottom[1] - left_top[1]
    if w > aspect_ratio * h:
        h = w * 1.0 / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w * 1.0 / pixel_std, h * 1.0 / pixel_std], dtype=np.float32) * 1.5
    return center, scale
