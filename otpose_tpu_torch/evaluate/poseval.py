"""PoseTrack evaluation (poseval-compatible AP + MOT metrics), numpy-native.

ref: utils/evaluate.py:18-920 (vendored poseval).  Same algorithm, array-
vectorized per frame instead of per-joint python loops:

- greedy PCKh-style pose assignment: per-frame distances normalized by
  0.6*head-diagonal, match threshold 0.5, each prediction keeps only its best
  GT (by PCK), each GT takes the argmax prediction (ref: 467-682)
- AP via the VOC recall/precision construction (ref: 686-751)
- frame cleanup: drop GT-empty frames, rects without points, points inside
  ignore regions (pure-numpy point-in-polygon instead of shapely)
  (ref: 22-101)
- MOT metrics (MOTA/MOTP/prec/rec per joint) from the same assignment,
  replicating the py-motmetrics accumulator semantics the reference feeds
  (ref: 923-1119)

Frames are annolist dicts exactly as the reference reads/writes them, so the
on-disk JSON surface is byte-compatible.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from typing import List

import numpy as np

logger = logging.getLogger(__name__)

MIN_SCORE = -9999
MAX_TRACK_ID = 10000
N_JOINTS = 15

JOINT_NAMES = ["right_ankle", "right_knee", "right_hip", "left_hip", "left_knee",
               "left_ankle", "right_wrist", "right_elbow", "right_shoulder",
               "left_shoulder", "left_elbow", "left_wrist", "neck", "nose",
               "head_top"]

# grouping for the summary table (ref: evaluate.py:136-160)
_GROUPS = [("Head", [14, 12, 13]), ("Shou", [8, 9]), ("Elb", [7, 10]),
           ("Wri", [6, 11]), ("Hip", [2, 3]), ("Knee", [1, 4]), ("Ankl", [0, 5])]


def get_head_size(x1, y1, x2, y2) -> float:
    """ref: evaluate.py:462-464."""
    return 0.6 * np.linalg.norm(np.subtract([x2, y2], [x1, y1]))


# ---------------------------------------------------------------------------
# frame parsing
# ---------------------------------------------------------------------------

def _frame_arrays(rects, want_scores: bool):
    """annorect list -> (xy (R, 15, 2), has (R, 15), scores (R, 15), tracks (R,))."""
    r = len(rects)
    xy = np.zeros((r, N_JOINTS, 2))
    has = np.zeros((r, N_JOINTS), dtype=bool)
    scores = np.full((r, N_JOINTS), np.nan)
    tracks = np.zeros(r, dtype=np.int64)
    warned = [False]
    for ridx, rect in enumerate(rects):
        if "track_id" in rect:
            tracks[ridx] = rect["track_id"][0]
        pts = rect["annopoints"][0]["point"] if rect.get("annopoints") else []
        for p in pts:
            if p.get("id") is None:
                continue
            i = p["id"][0]
            if i < 0 or i >= N_JOINTS:
                continue
            if has[ridx, i]:
                # duplicate joint id in one rect: keep the FIRST occurrence
                # (ref: evaluate.py:452-459 get_point_gt_by_id breaks on the
                # first match; caught by test_poseval_differential)
                continue
            xy[ridx, i] = (p["x"][0], p["y"][0])
            has[ridx, i] = True
            if want_scores:
                if "score" in p:
                    scores[ridx, i] = p["score"][0]
                else:
                    if not warned[0]:
                        warned[0] = True
                        # ref: evaluate.py:548-550 prints this per miss; once
                        # per frame is enough diagnostics for a malformed json
                        logger.warning(
                            "prediction score is missing; substituting %s",
                            MIN_SCORE)
                    scores[ridx, i] = MIN_SCORE
    return xy, has, scores, tracks


def _head_sizes(rects) -> np.ndarray:
    return np.array([get_head_size(r["x1"][0], r["y1"][0], r["x2"][0], r["y2"][0])
                     for r in rects])


# ---------------------------------------------------------------------------
# assignment (ref: evaluate.py:467-682)
# ---------------------------------------------------------------------------

def assign_gt_multi(gt_frames: List[dict], pr_frames: List[dict],
                    dist_thresh: float = 0.5):
    assert len(gt_frames) == len(pr_frames)
    n_imgs = len(gt_frames)
    scores_all = {i: {} for i in range(N_JOINTS)}
    labels_all = {i: {} for i in range(N_JOINTS)}
    n_gt_all = np.zeros((N_JOINTS, n_imgs))
    mot_all = {}

    for imgidx in range(n_imgs):
        # predictions must have annopoints (ref: 510-514)
        pr_rects = [r for r in pr_frames[imgidx]["annorect"]
                    if r.get("annopoints") and "point" in r["annopoints"][0]]
        pr_frames[imgidx]["annorect"] = pr_rects
        gt_rects = gt_frames[imgidx]["annorect"]

        gt_xy, has_gt, _, gt_tracks = _frame_arrays(gt_rects, want_scores=False)
        pr_xy, has_pr, score, pr_tracks = _frame_arrays(pr_rects, want_scores=True)
        n_pr, n_gt = len(pr_rects), len(gt_rects)

        if n_pr and n_gt:
            head = _head_sizes(gt_rects)                        # (G,)
            diff = pr_xy[:, None] - gt_xy[None]                 # (P, G, 15, 2)
            dist = np.linalg.norm(diff, axis=-1) / head[None, :, None]
            both = has_pr[:, None, :] & has_gt[None, :, :]
            dist = np.where(both, dist, np.inf)
            match = dist <= dist_thresh                          # (P, G, 15)

            n_gt_joints = has_gt.sum(axis=1)                     # (G,)
            pck = match.sum(axis=2).astype(np.float64)           # (P, G)
            nz = n_gt_joints > 0
            pck[:, nz] = pck[:, nz] / n_gt_joints[nz]

            # each prediction keeps only its best GT
            best_gt = np.argmax(pck, axis=1)                     # (P,)
            keep = np.zeros_like(pck)
            keep[np.arange(n_pr), best_gt] = pck[np.arange(n_pr), best_gt]
            pr_to_gt = np.argmax(keep, axis=0)                   # (G,)
            pr_to_gt[np.max(keep, axis=0) == 0] = -1

            # MOT info (ref: 609-626)
            mot = {}
            for i in range(N_JOINTS):
                ridxs_gt = np.flatnonzero(has_gt[:, i])
                ridxs_pr = np.flatnonzero(has_pr[:, i])
                d = np.full((len(ridxs_gt), len(ridxs_pr)), np.nan)
                for ip, rp in enumerate(ridxs_pr):
                    for ig, rg in enumerate(ridxs_gt):
                        if match[rp, rg, i]:
                            d[ig, ip] = dist[rp, rg, i]
                mot[i] = {"trackidxGT": gt_tracks[ridxs_gt].tolist(),
                          "trackidxPr": pr_tracks[ridxs_pr].tolist(),
                          "ridxsGT": ridxs_gt, "ridxsPr": ridxs_pr, "dist": d}

            matched_preds = set(pr_to_gt[pr_to_gt >= 0].tolist())
            for ridx_pr in range(n_pr):
                if ridx_pr in matched_preds:
                    ridx_gt = int(np.flatnonzero(pr_to_gt == ridx_pr)[0])
                    m = match[ridx_pr, ridx_gt]
                else:
                    m = np.zeros(N_JOINTS, dtype=bool)
                for i in range(N_JOINTS):
                    if has_pr[ridx_pr, i]:
                        scores_all[i][imgidx] = np.append(
                            scores_all[i].get(imgidx, np.zeros(0)), score[ridx_pr, i])
                        labels_all[i][imgidx] = np.append(
                            labels_all[i].get(imgidx, np.zeros(0, np.int8)), m[i])
        else:
            if n_gt == 0:
                # all predictions are false positives (ref: 655-663)
                for ridx_pr in range(n_pr):
                    for i in range(N_JOINTS):
                        if has_pr[ridx_pr, i]:
                            scores_all[i][imgidx] = np.append(
                                scores_all[i].get(imgidx, np.zeros(0)),
                                score[ridx_pr, i])
                            labels_all[i][imgidx] = np.append(
                                labels_all[i].get(imgidx, np.zeros(0, np.int8)), 0)
            mot = {i: {"trackidxGT": [0], "trackidxPr": [0],
                       "ridxsGT": np.array([0]), "ridxsPr": np.array([0]),
                       "dist": np.full((1, 1), np.nan)} for i in range(N_JOINTS)}

        for i in range(N_JOINTS):
            scores_all[i].setdefault(imgidx, np.zeros(0))
            labels_all[i].setdefault(imgidx, np.zeros(0, np.int8))
        n_gt_all[:, imgidx] += has_gt.sum(axis=0)
        mot_all[imgidx] = mot

    return scores_all, labels_all, n_gt_all, mot_all


# ---------------------------------------------------------------------------
# AP (ref: evaluate.py:686-763)
# ---------------------------------------------------------------------------

def compute_rpc(scores: np.ndarray, labels: np.ndarray, total_pos: float):
    order = np.asarray(scores).argsort()[::-1]
    labels_sorted = np.asarray(labels)[order]
    tp = np.cumsum(labels_sorted == 1)
    n = np.arange(1, len(order) + 1)
    # total_pos == 0 with predictions present must produce NaN recall -> NaN
    # AP, which compute_metrics then EXCLUDES from the mean (ref: 700-707,
    # 725-727).  Clamping to 0 instead would wrongly deflate the mean AP —
    # caught by tests/test_poseval_differential.py.
    with np.errstate(divide="ignore", invalid="ignore"):
        recall = np.asarray(tp, np.float64) / float(total_pos)
    precision = tp / n
    return precision, recall, order


def vocap(rec: np.ndarray, prec: np.ndarray) -> float:
    mpre = np.concatenate([[0.0], prec, [0.0]])
    mrec = np.concatenate([[0.0], rec, [1.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.flatnonzero(mrec[1:] != mrec[:-1]) + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def compute_metrics(scores_all, labels_all, n_gt_all):
    n_joints, n_imgs = n_gt_all.shape
    ap = np.zeros((n_joints + 1, 1))
    rec = np.zeros((n_joints + 1, 1))
    pre = np.zeros((n_joints + 1, 1))
    for j in range(n_joints):
        scores = np.concatenate([scores_all[j][i] for i in range(n_imgs)]) \
            if n_imgs else np.zeros(0)
        labels = np.concatenate([labels_all[j][i] for i in range(n_imgs)]) \
            if n_imgs else np.zeros(0)
        n_gt = n_gt_all[j].sum()
        precision, recall, _ = compute_rpc(scores, labels, n_gt)
        if len(precision) > 0:
            ap[j] = vocap(recall, precision) * 100
            pre[j] = precision[-1] * 100
            rec[j] = recall[-1] * 100
    for arr in (ap, pre, rec):
        valid = ~np.isnan(arr[:n_joints, 0])
        arr[n_joints] = arr[:n_joints, 0][valid].mean() if valid.any() else np.nan
    return ap, pre, rec


def evaluate_ap(gt_frames: List[dict], pr_frames: List[dict],
                dist_thresh: float = 0.5):
    scores_all, labels_all, n_gt_all, _ = assign_gt_multi(gt_frames, pr_frames,
                                                          dist_thresh)
    return compute_metrics(scores_all, labels_all, n_gt_all)


def get_cum(vals: np.ndarray) -> List[float]:
    """Per-part summary row (ref: evaluate.py:136-160)."""
    cum = [float(vals[idxs, 0].mean()) for _, idxs in _GROUPS]
    for i in range(N_JOINTS, len(vals)):
        cum.append(float(vals[i, 0]))
    return cum


# ---------------------------------------------------------------------------
# data cleanup (ref: evaluate.py:22-101)
# ---------------------------------------------------------------------------

def _points_in_polygon(px: np.ndarray, py: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Ray-casting point-in-polygon; poly (V, 2)."""
    inside = np.zeros(px.shape, dtype=bool)
    n = len(poly)
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        crosses = ((yi > py) != (yj > py)) & \
            (px < (xj - xi) * (py - yi) / (yj - yi + 1e-12) + xi)
        inside ^= crosses
        j = i
    return inside


def _remove_ignored_points_rects(rects, polys):
    out = []
    for rect in rects:
        points = rect["annopoints"][0]["point"]
        keep = []
        for p in points:
            px = np.array([p["x"][0]], dtype=np.float64)
            py = np.array([p["y"][0]], dtype=np.float64)
            if not any(_points_in_polygon(px, py, poly)[0] for poly in polys):
                keep.append(p)
        if keep:
            rect["annopoints"][0]["point"] = keep
            out.append(rect)
    return out


def remove_ignored_points(gt_frames, pr_frames):
    for imgidx in range(len(gt_frames)):
        regions = gt_frames[imgidx].get("ignore_regions") or []
        if not regions:
            continue
        polys = []
        for region in regions:
            pts = region["point"]
            polys.append(np.array([[p["x"][0], p["y"][0]] for p in pts],
                                  dtype=np.float64))
        pr_frames[imgidx]["annorect"] = _remove_ignored_points_rects(
            pr_frames[imgidx]["annorect"], polys)
        gt_frames[imgidx]["annorect"] = _remove_ignored_points_rects(
            gt_frames[imgidx]["annorect"], polys)
    return gt_frames, pr_frames


def _rect_has_points(rect) -> bool:
    return bool(rect.get("annopoints")) and bool(rect["annopoints"][0]) \
        and "point" in rect["annopoints"][0]


def cleanup_data(gt_frames, pr_frames):
    keep = [i for i in range(len(gt_frames)) if gt_frames[i]["annorect"]]
    gt_frames = [gt_frames[i] for i in keep]
    pr_frames = [pr_frames[i] for i in keep]
    for i in range(len(gt_frames)):
        gt_frames[i]["annorect"] = [r for r in gt_frames[i]["annorect"]
                                    if _rect_has_points(r)]
        pr_frames[i]["annorect"] = [r for r in pr_frames[i]["annorect"]
                                    if _rect_has_points(r)]
    return gt_frames, pr_frames


# ---------------------------------------------------------------------------
# loading + top-level (ref: evaluate.py:820-920)
# ---------------------------------------------------------------------------

def load_data_dir(gt_dir: str, pred_dir: str):
    from otpose_tpu_torch.evaluate.converters import convert_videos

    filenames = sorted(glob.glob(os.path.join(gt_dir, "*.json")))
    gt_all, pr_all = [], []
    for i, fname in enumerate(filenames):
        with open(fname) as f:
            data = json.load(f)
        if "annolist" not in data:
            data = convert_videos(data)[0]
        gt = data["annolist"]
        for frame in gt:
            frame["seq_id"] = i
            frame["seq_name"] = os.path.basename(fname).split(".")[0]
            for rect in frame["annorect"]:
                if "track_id" in rect:
                    assert rect["track_id"][0] < MAX_TRACK_ID
                    rect["track_id"][0] += i * MAX_TRACK_ID
        gt_all += gt

        pred_file = os.path.join(pred_dir, os.path.basename(fname))
        if not os.path.exists(pred_file):
            raise IOError(f"Prediction file {pred_file} does not exist")
        with open(pred_file) as f:
            data = json.load(f)
        if "annolist" not in data:
            data = convert_videos(data)[0]
        pr = data["annolist"]
        if len(pr) != len(gt):
            raise ValueError(f"# prediction frames {len(pr)} != # GT frames "
                             f"{len(gt)} for {pred_file}")
        for frame in pr:
            for rect in frame["annorect"]:
                if "track_id" in rect:
                    assert rect["track_id"][0] < MAX_TRACK_ID
                    rect["track_id"][0] += i * MAX_TRACK_ID
        pr_all += pr

    gt_all, pr_all = cleanup_data(gt_all, pr_all)
    gt_all, pr_all = remove_ignored_points(gt_all, pr_all)
    return gt_all, pr_all


def evaluate(gtdir: str, preddir: str, eval_pose: bool = True,
             eval_track: bool = True, eval_upper_bound: bool = False):
    """Top-level (ref: evaluate.py:883-920).  Returns (cum, track_cum):
    cum = [Head, Shou, Elb, Wri, Hip, Knee, Ankl, Total] AP."""
    gt_frames, pr_frames = load_data_dir(gtdir, preddir)
    logger.info("# gt frames  : %d", len(gt_frames))
    logger.info("# pred frames: %d", len(pr_frames))

    cum = None
    track_cum = None
    if eval_pose:
        ap, pre, rec = evaluate_ap(gt_frames, pr_frames)
        cum = get_cum(ap)
        logger.info("AP: %s", cum)
    if eval_track:
        from otpose_tpu_torch.evaluate.tracking import evaluate_tracking

        metrics_all = evaluate_tracking(gt_frames, pr_frames,
                                        eval_upper_bound=eval_upper_bound)
        metrics = np.full((N_JOINTS + 4, 1), np.nan)
        for i in range(N_JOINTS + 1):
            metrics[i, 0] = metrics_all["mota"][0, i]
        metrics[N_JOINTS + 1, 0] = metrics_all["motp"][0, N_JOINTS]
        metrics[N_JOINTS + 2, 0] = metrics_all["pre"][0, N_JOINTS]
        metrics[N_JOINTS + 3, 0] = metrics_all["rec"][0, N_JOINTS]
        track_cum = get_cum(metrics)
        logger.info("MOT: %s", track_cum)
    return cum, track_cum
