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
