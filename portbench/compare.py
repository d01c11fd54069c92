"""The numbers that decide ``correct``: what the timed path produced against
the float32 reference, each to be held under the cell's limit.

Decoded eval (per clip and joint, ``scale`` the reference heatmap's range):

- ``peak_gap``: how far below the reference's maximum the reference heatmap
  lies at the program's argmax (where the program reports no positive
  maximum, how far the reference's maximum lies above 0);
- ``maxval_gap``: the program's maximum against the reference's;
- ``shift_gap``: where the program's quarter-pixel shift disagrees with the
  sign of the reference's neighbour difference at the program's argmax,
  that difference (1 where the shift is not one the decode can give);
- ``peak_gap_mean`` and ``maxval_gap_mean``: the first two's means over the
  batch's clips and joints, steady where the worst one swings.

A near-tie moves the argmax on rounding alone; it then costs a gap of the
size of the tie, so the numbers stay small for sound runs and grow with
the error.

Training (three steps from the same weights, batches and dropout seeds):

- ``loss_gap``: the worst step's loss against the reference's, relative;
- ``grad_gap``: by the worst leaf, the norm of the first gradient as AdamW
  got it (its first moment after one step) against the reference's;
- ``change_gap``: by the worst leaf, the norm of the parameters' change
  over the three steps against the reference's;
- ``grad_gap_median`` and ``change_gap_median``: the same by the median
  leaf, steady where one small leaf's norm swings on rounding.

A leaf's gap of norms is measured against the larger of the reference's
norm of that leaf and of the median leaf.  Leaves whose reference gradient
is under a thousandth of the median leaf's move by round-off alone and
are left out of both.
"""

from __future__ import annotations

import math

import torch

NEGLIGIBLE = 1e-3          # a leaf's gradient under this share of the median's


def eval_numbers(ref_heat, coords, maxvals, raw) -> dict:
    """The eval numbers of one batch: ``ref_heat`` (B, J, H, W) f32,
    the program's outputs (B, J, 2), (B, J, 1), (B, J, 2)."""
    ref_heat = ref_heat.float()
    coords, maxvals, raw = (torch.as_tensor(t).float().to(ref_heat.device)
                            for t in (coords, maxvals, raw))
    b, j, h, w = ref_heat.shape
    flat = ref_heat.reshape(b, j, h * w)
    ref_max, ref_min = flat.amax(dim=2), flat.amin(dim=2)
    scale = (ref_max - ref_min).clamp(min=1e-30)
    if not (torch.isfinite(coords).all() and torch.isfinite(maxvals).all()
            and torch.isfinite(raw).all()):
        return dict.fromkeys(("peak_gap", "maxval_gap", "shift_gap", "peak_gap_mean",
                              "maxval_gap_mean"), math.inf)
    px = raw[..., 0].round().long().clamp(0, w - 1)
    py = raw[..., 1].round().long().clamp(0, h - 1)

    def at(yy, xx):
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        return torch.gather(flat, 2, idx[..., None])[..., 0]

    positive = maxvals[..., 0] > 0
    peak = torch.where(positive, ref_max - at(py, px), ref_max.clamp(min=0)) / scale
    maxval = (maxvals[..., 0] - ref_max).abs() / scale
    inner = positive & (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    shift = coords - raw
    worst = torch.zeros_like(ref_max)
    for axis, diff in ((0, at(py, px + 1) - at(py, px - 1)), (1, at(py + 1, px) - at(py - 1, px))):
        want = torch.where(inner, torch.sign(diff) * 0.25, torch.zeros_like(diff))
        got = shift[..., axis]
        allowed = (got == 0) | (inner & (got.abs() == 0.25))
        gap = torch.where(got == want, torch.zeros_like(diff), diff.abs() / scale)
        worst = torch.maximum(worst, torch.where(allowed, gap, torch.ones_like(gap)))
    return {"peak_gap": float(peak.max()), "maxval_gap": float(maxval.max()),
            "shift_gap": float(worst.max()), "peak_gap_mean": float(peak.mean()),
            "maxval_gap_mean": float(maxval.mean())}


def leaf_gaps(got: dict, want: dict, keep) -> list:
    """Each leaf's gap of norms, ascending: ``got`` and ``want`` {name:
    norm}, over the names in ``keep``."""
    median = sorted(want[n] for n in keep)[len(keep) // 2]
    return sorted(abs(got[n] - want[n]) / max(want[n], median, 1e-30)
                  if math.isfinite(got[n]) else math.inf for n in keep)


def kept_leaves(ref_grad: dict) -> list:
    """The leaves whose reference gradient norm is at least ``NEGLIGIBLE``
    of the median leaf's."""
    norms = sorted(ref_grad.values())
    median = norms[len(norms) // 2]
    return [n for n, v in ref_grad.items() if v >= NEGLIGIBLE * median]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [3 floats], "grad": {name: norm},
    "change": {name: norm}}."""
    losses = [abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p) else math.inf
              for p, r in zip(prog["losses"], ref["losses"])]
    keep = kept_leaves(ref["grad"])
    out = {"loss_gap": max(losses)}
    for key in ("grad", "change"):
        gaps = leaf_gaps(prog[key], ref[key], keep)
        out[f"{key}_gap"] = gaps[-1]
        out[f"{key}_gap_median"] = gaps[len(gaps) // 2]
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the cell's limits: every
    limited number at or under its limit (a missing one fails)."""
    rows = [(k, numbers.get(k, math.inf), limits[k]) for k in sorted(limits)]
    return all(v <= lim for _, v, lim in rows), rows
