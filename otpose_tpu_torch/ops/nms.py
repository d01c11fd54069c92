"""1-D segment NMS / SoftNMS (counterpart of ``otpose_tpu/ops/nms.py``).

ref: thirdparty/utils/csrc/nms_cpu.cpp:19-182 + thirdparty/utils/nms.py
(vendored ActionFormer op; not used by the OTPose train/eval path — kept for
package-API parity).  ``nms_1d`` and ``softnms_1d`` are the JAX package's
numpy host functions, copied; ``nms_1d_device`` is the fixed-size masked
greedy NMS in torch on the inputs' device.
"""

from __future__ import annotations

import numpy as np
import torch


def nms_1d(segs: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy 1-D NMS; returns kept indices sorted by descending score
    (ref: nms_cpu.cpp:19-58)."""
    segs = np.asarray(segs, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    if segs.size == 0:
        return np.zeros(0, dtype=np.int64)
    x1, x2 = segs[:, 0], segs[:, 1]
    areas = x2 - x1 + 1e-6
    order = np.argsort(-scores, kind="stable")
    keep = np.ones(len(segs), dtype=bool)
    for _i in range(len(order)):
        if not keep[_i]:
            continue
        i = order[_i]
        xx1 = np.maximum(x1[i], x1[order[_i + 1:]])
        xx2 = np.minimum(x2[i], x2[order[_i + 1:]])
        inter = np.maximum(0.0, xx2 - xx1)
        ovr = inter / (areas[i] + areas[order[_i + 1:]] - inter)
        keep[_i + 1:] &= ~(ovr >= iou_threshold)
    return order[keep]


def softnms_1d(segs: np.ndarray, scores: np.ndarray, *, iou_threshold: float = 0.5,
               sigma: float = 0.5, min_score: float = 0.001, method: int = 2):
    """SoftNMS with hard (0), linear (1) or gaussian (2) decay
    (ref: nms_cpu.cpp:67-160).  Returns (sorted_segs, sorted_scores,
    original_indices)."""
    x1 = np.asarray(segs, dtype=np.float64)[:, 0].copy()
    x2 = np.asarray(segs, dtype=np.float64)[:, 1].copy()
    sc = np.asarray(scores, dtype=np.float64).copy()
    areas = x2 - x1 + 1e-6
    inds = np.arange(len(sc))
    n = len(sc)
    out = []
    i = 0
    while i < n:
        max_pos = i + int(np.argmax(sc[i:n]))
        for arr in (x1, x2, sc, areas, inds):
            arr[i], arr[max_pos] = arr[max_pos], arr[i]
        out.append((x1[i], x2[i], sc[i], inds[i]))
        xx1 = np.maximum(x1[i], x1[i + 1:n])
        xx2 = np.minimum(x2[i], x2[i + 1:n])
        inter = np.maximum(0.0, xx2 - xx1)
        ovr = inter / (areas[i] + areas[i + 1:n] - inter)
        if method == 0:
            weight = np.where(ovr >= iou_threshold, 0.0, 1.0)
        elif method == 1:
            weight = np.where(ovr >= iou_threshold, 1.0 - ovr, 1.0)
        else:
            weight = np.exp(-(ovr * ovr) / sigma)
        sc[i + 1:n] *= weight
        # compact out segments that fell below min_score
        j = i + 1
        while j < n:
            if sc[j] < min_score:
                for arr in (x1, x2, sc, areas, inds):
                    arr[j] = arr[n - 1]
                n -= 1
            else:
                j += 1
        i += 1
    out = np.asarray(out, dtype=np.float64).reshape(-1, 4)
    return out[:, :2], out[:, 2], out[:, 3].astype(np.int64)


def nms_1d_device(segs: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                  max_keep: int = 0) -> torch.Tensor:
    """Fixed-size greedy NMS on the inputs' device: a bool keep mask over
    the inputs (static shapes, no data-dependent output).  ``max_keep`` > 0
    keeps at most that many of the highest-scoring survivors."""
    n = segs.shape[0]
    dev = segs.device
    x1, x2 = segs[:, 0], segs[:, 1]
    areas = x2 - x1 + 1e-6
    order = torch.argsort(-scores, stable=True)
    # the pairwise overlaps in score order, computed once
    sx1, sx2, sa = x1[order], x2[order], areas[order]
    inter = (torch.minimum(sx2[:, None], sx2[None, :])
             - torch.maximum(sx1[:, None], sx1[None, :])).clamp_min(0.0)
    ovr = inter / (sa[:, None] + sa[None, :] - inter)
    later = torch.arange(n, device=dev)[None, :] > torch.arange(n, device=dev)[:, None]
    suppress = (ovr >= iou_threshold) & later
    keep_sorted = torch.ones(n, dtype=torch.bool, device=dev)
    for i in range(n):
        keep_sorted = torch.where(keep_sorted[i], keep_sorted & ~suppress[i], keep_sorted)
    if max_keep:
        # keep_sorted runs in descending score order, so a running count
        # masks every survivor past the cap
        keep_sorted &= torch.cumsum(keep_sorted.to(torch.int64), 0) <= max_keep
    keep = torch.zeros(n, dtype=torch.bool, device=dev)
    keep[order] = keep_sorted
    return keep
