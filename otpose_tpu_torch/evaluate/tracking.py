"""Multi-object tracking metrics (MOTA/MOTP/precision/recall per joint).

ref: utils/evaluate.py:923-1119, which feeds per-joint distance matrices into
py-motmetrics MOTAccumulators.  The port does not depend on py-motmetrics:
``MotAccumulator`` re-implements the exact accumulator semantics consumed
there: per-frame correspondence persistence, Hungarian assignment on the
remaining pairs (NaN = forbidden), SWITCH counted when a GT track changes
hypothesis, and distance sums for MOTP.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

N_JOINTS = 15


class MotAccumulator:
    """Minimal py-motmetrics-compatible accumulator."""

    def __init__(self):
        self.last_match: Dict[int, int] = {}   # oid -> hid across frames
        self.num_misses = 0
        self.num_switches = 0
        self.num_false_positives = 0
        self.num_objects = 0
        self.num_detections = 0
        self.sum_d = 0.0

    def update(self, oids: List[int], hids: List[int], dists: np.ndarray):
        oids = list(oids)
        hids = list(hids)
        dists = np.asarray(dists, dtype=np.float64).reshape(len(oids), len(hids))
        self.num_objects += len(oids)

        matched_o: Dict[int, int] = {}
        used_h = set()

        # 1. persist previous correspondences where still valid.  motmetrics
        # masks hids[j] after each persisted match, so a hypothesis can host
        # at most ONE persisted object and a duplicate hid falls through to
        # its next unconsumed occurrence — mirror both via the used_h filter
        for i, o in enumerate(oids):
            h_prev = self.last_match.get(o)
            if h_prev is None:
                continue
            js = [j for j, h in enumerate(hids)
                  if h == h_prev and j not in used_h]
            if js and not np.isnan(dists[i, js[0]]):
                matched_o[i] = js[0]
                used_h.add(js[0])

        # 2. Hungarian on the rest (NaN forbidden)
        rem_i = [i for i in range(len(oids)) if i not in matched_o]
        rem_j = [j for j in range(len(hids)) if j not in used_h]
        if rem_i and rem_j:
            sub = dists[np.ix_(rem_i, rem_j)]
            cost = np.where(np.isnan(sub), 1e9, sub)
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if np.isnan(sub[r, c]):
                    continue
                matched_o[rem_i[r]] = rem_j[c]
                used_h.add(rem_j[c])

        # 3. classify events
        for i, j in matched_o.items():
            o, h = oids[i], hids[j]
            if o in self.last_match and self.last_match[o] != h:
                self.num_switches += 1
            self.num_detections += 1
            self.sum_d += dists[i, j]
            self.last_match[o] = h
        self.num_misses += len(oids) - len(matched_o)
        self.num_false_positives += len(hids) - len(used_h)


def evaluate_tracking(gt_frames: List[dict], pr_frames: List[dict],
                      eval_upper_bound: bool = False):
    """ref: utils/evaluate.py:232-241 + computeMetrics 923-1119.

    ``eval_upper_bound=True`` scores tracking with an ID oracle: every
    prediction that keypoint-matches a GT inherits that GT's track id, so ID
    switches measure only the matching, not the tracker — the MOTA upper
    bound.  (The reference accepts this flag at evaluate.py:884 but plumbs it
    into ``evaluate_tracking``'s *outputDir* positional at :908 vs :232, so
    upstream it silently did nothing; this is the intended semantics.)
    """
    from otpose_tpu_torch.evaluate.poseval import assign_gt_multi

    _, _, _, mot_all = assign_gt_multi(gt_frames, pr_frames, 0.5)

    if eval_upper_bound:
        for mot in mot_all.values():
            for m in mot.values():
                d = np.asarray(m["dist"], dtype=np.float64)   # (G, P)
                if d.size == 0:
                    continue
                pr_ids = list(m["trackidxPr"])
                for jcol in range(d.shape[1]):
                    col = d[:, jcol]
                    if np.any(np.isfinite(col)):
                        gi = int(np.nanargmin(np.where(np.isfinite(col), col,
                                                       np.inf)))
                        pr_ids[jcol] = m["trackidxGT"][gi]
                m["trackidxPr"] = pr_ids

    seqidxs = np.array([f["seq_id"] for f in gt_frames])
    uniq = np.unique(seqidxs)

    mid = {name: np.zeros((1, N_JOINTS)) for name in
           ("num_misses", "num_switches", "num_false_positives",
            "num_objects", "num_detections", "sumD")}

    for si in uniq:
        imgidxs = np.argwhere(seqidxs == si)
        imgidxs = imgidxs[:-1]  # reference drops the last frame (ref: 982)
        accs = [MotAccumulator() for _ in range(N_JOINTS)]
        for row in imgidxs:
            imgidx = int(row[0])
            for i in range(N_JOINTS):
                m = mot_all[imgidx][i]
                accs[i].update(m["trackidxGT"], m["trackidxPr"], m["dist"])
        for i in range(N_JOINTS):
            mid["num_misses"][0, i] += accs[i].num_misses
            mid["num_switches"][0, i] += accs[i].num_switches
            mid["num_false_positives"][0, i] += accs[i].num_false_positives
            mid["num_objects"][0, i] += accs[i].num_objects
            mid["num_detections"][0, i] += accs[i].num_detections
            s = accs[i].sum_d
            mid["sumD"][0, i] += 0 if np.isnan(s) else s

    fin = {name: np.zeros((1, N_JOINTS + 1)) for name in
           ("mota", "motp", "pre", "rec")}
    for i in range(N_JOINTS):
        num_obj = mid["num_objects"][0, i] or np.nan
        num_fp = mid["num_false_positives"][0, i]
        fin["mota"][0, i] = 100 * (1.0 - (mid["num_misses"][0, i]
                                          + mid["num_switches"][0, i]
                                          + num_fp) / num_obj)
        num_det = mid["num_detections"][0, i]
        s = mid["sumD"][0, i]
        fin["motp"][0, i] = 0.0 if (num_det == 0 or np.isnan(s)) \
            else 100 * (1.0 - s / num_det)
        total_det = (num_fp + num_det) or np.nan
        fin["pre"][0, i] = 100 * num_det / total_det
        fin["rec"][0, i] = 100 * num_det / num_obj

    for name in fin:
        vals = fin[name][0, :N_JOINTS]
        valid = ~np.isnan(vals)
        fin[name][0, N_JOINTS] = vals[valid].mean() if valid.any() else np.nan
    return fin
