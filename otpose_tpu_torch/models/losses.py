"""Training losses (counterpart of ``otpose_tpu/models/losses.py``).

ref: model/loss.py.  Heatmaps are NHWC (B, H, W, J), the JAX package's
layout at its public functions; ``target_weight`` is (B, J, 1).

- ``st_ohkw_mse_loss`` (ref: loss.py:5-92): per joint, the labelled or
  unlabelled branch is decided by whether the *batch-global* max of that
  joint's GT heatmap equals 1.0 (gaussian targets peak at exactly 1.0 when
  visible); unlabelled joints add a student-vs-teacher consistency term.
  OHKM keeps the top-k hardest joints per sample.  final = ohkm + summed
  per-joint MSE.  Under a multi-process launch the batch is every rank's
  rows: the max is a MAX across the ranks (``parallel/distributed.py``).
- ``joints_mse_ohkm_loss`` (ref: loss.py:95-148)
- ``joint_mse_loss`` (ref: loss.py:151-182)
"""

from __future__ import annotations

import torch

from otpose_tpu_torch.parallel import distributed


def _flatten(hm: torch.Tensor) -> torch.Tensor:
    """(B, H, W, J) -> (B, J, HW)."""
    b, h, w, j = hm.shape
    return hm.permute(0, 3, 1, 2).reshape(b, j, h * w)


def _ohkm(per_joint_loss: torch.Tensor, topk: int) -> torch.Tensor:
    """Top-k hardest joints per sample, averaged (ref: loss.py:13-23)."""
    vals = torch.topk(per_joint_loss, topk, dim=1).values     # (B, topk)
    return (vals.sum(dim=1) / topk).mean()


def st_ohkw_mse_loss(output_s, output_t, target, target_weight, *, topk: int = 8,
                     use_target_weight: bool = True, effective_num_joints: int | None = None):
    """Student-teacher OHKM MSE (ref: loss.py:25-92)."""
    ps, pt, gt = _flatten(output_s), _flatten(output_t), _flatten(target)
    j = ps.shape[1]
    if effective_num_joints is None:
        effective_num_joints = j
    if use_target_weight:
        w = target_weight[:, :, :1]                            # (B, J, 1)
        ps_w, pt_w, gt_w = ps * w, pt * w, gt * w
        # (J,) batch-global decision: across the data groups' rows under a launch
        labeled = distributed.all_reduce_(gt.amax(dim=(0, 2)), "max") == 1.0
        unl = (~labeled).to(ps_w.dtype)
        base = (ps_w - gt_w) ** 2                              # (B, J, HW)
        consist = (ps_w - pt_w) ** 2
        elem = 0.5 * (base + consist * unl[None, :, None])
        ohkm_loss = _ohkm(elem.mean(dim=2), topk)
        mse_per_joint = base.mean(dim=(0, 2)) + consist.mean(dim=(0, 2)) * unl
        mse_loss = mse_per_joint.sum()
    else:
        # the reference's no-weight branch only accumulates teacher MSE and
        # produces an empty ohkm list; the JAX package keeps the meaningful part
        base = (pt - gt) ** 2
        ohkm_loss = _ohkm((0.5 * base).mean(dim=2), topk)
        mse_loss = base.mean(dim=(0, 2)).sum()
    return {"ohkm_loss_s": ohkm_loss,
            "mse_loss_s": mse_loss / effective_num_joints,
            "final_loss": ohkm_loss + mse_loss}


def joints_mse_ohkm_loss(output, target, target_weight, *, topk: int = 8,
                         use_target_weight: bool = True, effective_num_joints: int | None = None):
    """OHKM + MSE without the student/teacher split (ref: loss.py:95-148)."""
    p, gt = _flatten(output), _flatten(target)
    if effective_num_joints is None:
        effective_num_joints = p.shape[1]
    if use_target_weight:
        w = target_weight[:, :, :1]
        p, gt = p * w, gt * w
    base = (p - gt) ** 2
    ohkm_loss = _ohkm((0.5 * base).mean(dim=2), topk)
    mse_loss = base.mean(dim=(0, 2)).sum()
    return {"ohkm_loss": ohkm_loss,
            "mse_loss": mse_loss / effective_num_joints,
            "final_loss": ohkm_loss + mse_loss}


def joint_mse_loss(output, target, target_weight, *, use_target_weight: bool = True,
                   effective_num_joints: int | None = None):
    """Plain per-joint MSE (ref: loss.py:151-182)."""
    p, gt = _flatten(output), _flatten(target)
    if effective_num_joints is None:
        effective_num_joints = p.shape[1]
    if use_target_weight:
        w = target_weight[:, :, :1]
        p, gt = p * w, gt * w
    return ((p - gt) ** 2).mean(dim=(0, 2)).sum() / effective_num_joints


def build_loss(cfg):
    """Loss factory by ``cfg.LOSS.NAME`` (ref: loss.py:185-189): a function
    of (output_s, output_t, target, target_weight)."""
    name, use_w, topk = cfg.LOSS.NAME, cfg.LOSS.USE_TARGET_WEIGHT, cfg.LOSS.TOPK
    if name == "ST_OHKW_MSELoss":
        def fn(output_s, output_t, target, target_weight):
            return st_ohkw_mse_loss(output_s, output_t, target, target_weight,
                                    topk=topk, use_target_weight=use_w)
        return fn
    if name == "MSELOSS_OHKM":
        def fn(output_s, output_t, target, target_weight):
            return joints_mse_ohkm_loss(output_s, target, target_weight,
                                        topk=topk, use_target_weight=use_w)
        return fn
    raise ValueError(f"Unsupported loss: {name}")
