"""Training-time PCK accuracy meter.

ref: utils/evaluate.py:352-415.  Decodes argmax keypoints from predicted and
GT heatmaps, normalizes distances by (h, w)/10 and reports the fraction of
joints within 0.5 normalized units, ignoring joints whose GT peak sits at
coordinates <= 1 (invisible).  Vectorized numpy (the reference loops).
The port's copy of ``otpose_tpu/evaluate/pck.py``: the numpy meter and
``accuracy_device``, the train step's on-device meter.
"""

from __future__ import annotations

import numpy as np
import torch

from otpose_tpu_torch.ops.heatmap import get_max_preds, get_max_preds_device
from otpose_tpu_torch.parallel import distributed


def calc_dists(preds: np.ndarray, target: np.ndarray, normalize: np.ndarray) -> np.ndarray:
    """(B, J, 2) preds/targets -> (J, B) distances, -1 for invisible."""
    preds = preds.astype(np.float32)
    target = target.astype(np.float32)
    visible = (target[..., 0] > 1) & (target[..., 1] > 1)       # (B, J)
    d = np.linalg.norm((preds - target) / normalize[:, None, :], axis=-1)  # (B, J)
    return np.where(visible, d, -1.0).T


def dist_acc(dists: np.ndarray, thr: float = 0.5):
    """Fraction below threshold, ignoring -1 entries."""
    valid = dists != -1
    n = valid.sum()
    if n == 0:
        return -1
    return float(np.less(dists[valid], thr).sum()) / n


def accuracy(output: np.ndarray, target: np.ndarray, hm_type: str = "gaussian",
             thr: float = 0.5):
    """PCK on heatmaps (B, J, H, W).  Returns (acc[J+1], avg_acc, cnt, preds)."""
    num_joints = output.shape[1]
    pred, _ = get_max_preds(output)
    gt, _ = get_max_preds(target)
    h, w = output.shape[2], output.shape[3]
    norm = np.ones((pred.shape[0], 2)) * np.array([h, w]) / 10
    dists = calc_dists(pred, gt, norm)

    acc = np.zeros(num_joints + 1)
    avg_acc = 0.0
    cnt = 0
    for i in range(num_joints):
        acc[i + 1] = dist_acc(dists[i], thr)
        if acc[i + 1] >= 0:
            avg_acc += acc[i + 1]
            cnt += 1
    avg_acc = avg_acc / cnt if cnt != 0 else 0
    if cnt != 0:
        acc[0] = avg_acc
    return acc, avg_acc, cnt, pred


def accuracy_device(pred_hm: torch.Tensor, target_hm: torch.Tensor, thr: float = 0.5):
    """PCK on the device, with ``accuracy``'s semantics: per-joint fraction
    of visible joints within ``thr``, averaged over the joints that have a
    visible instance.  NHWC heatmaps in; returns (avg_acc, cnt) as 0-d
    tensors.  Under a multi-process launch the counts are summed across the
    ranks first, so every rank gets the global batch's meter."""
    pred = pred_hm.permute(0, 3, 1, 2)
    gt = target_hm.permute(0, 3, 1, 2)
    h, w = pred.shape[2], pred.shape[3]
    p, _ = get_max_preds_device(pred)     # (B, J, 2)
    g, _ = get_max_preds_device(gt)
    visible = (g[..., 0] > 1) & (g[..., 1] > 1)                  # (B, J)
    norm = torch.tensor([h / 10.0, w / 10.0], device=p.device)
    d = torch.linalg.norm((p - g) / norm, dim=-1)                 # (B, J)
    hit = (d < thr) & visible
    n_vis = visible.sum(dim=0)                                   # (J,)
    hits = hit.sum(dim=0)
    if distributed.active():     # the ratio of the global batch's counts
        hits, n_vis = distributed.all_reduce_(torch.stack([hits, n_vis]))
    acc_j = hits / n_vis.clamp(min=1)
    has_vis = n_vis > 0
    cnt = has_vis.sum()
    avg = torch.where(cnt > 0, (acc_j * has_vis).sum() / cnt.clamp(min=1),
                      torch.zeros((), device=p.device))
    return avg, cnt
