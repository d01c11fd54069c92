"""Keypoint format conversion: PoseTrack-COCO-17 -> PoseTrack-official-15.

ref: utils/keypoints.py:7-135, configs/constants.py:2-56.  The model's 17
joints use the PoseTrack-COCO ordering (indices 1/2 are head_bottom/head_top,
replacing plain-COCO's eyes), so the official-15 conversion is a pure
reorder; the neck/head_top synthesis branches of the reference only fire for
orderings that lack those names.
"""

from __future__ import annotations

from typing import List

import numpy as np

POSETRACK_OFFICIAL_15 = [
    "right_ankle", "right_knee", "right_hip", "left_hip", "left_knee",
    "left_ankle", "right_wrist", "right_elbow", "right_shoulder",
    "left_shoulder", "left_elbow", "left_wrist", "head_bottom", "nose",
    "head_top",
]

POSETRACK_COCO_17 = [
    "nose", "head_bottom", "head_top", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
]

# official index -> coco index
PT15_FROM_COCO17 = [POSETRACK_COCO_17.index(n) for n in POSETRACK_OFFICIAL_15]


def coco2posetrack_ord(preds: np.ndarray, global_score: float = 1.0) -> List[dict]:
    """(4, 17) [x; y; score; score] -> 15 poseval point dicts
    (ref: utils/keypoints.py:7-66)."""
    global_score = float(global_score)
    data = []
    for k, src in enumerate(PT15_FROM_COCO17):
        local_score = (float(preds[2, src]) + float(preds[2, src])) / 2.0
        data.append({
            "id": [k],
            "x": [float(preds[0, src])],
            "y": [float(preds[1, src])],
            "score": [local_score * global_score],
        })
    return data


def coco2posetrack_points(pose_xyc: np.ndarray, global_score: float = 1.0) -> np.ndarray:
    """(17, 3) [x, y, conf] -> (15, 3) official ordering with combined score
    (inference variant, ref: utils/keypoints.py:69-135)."""
    pose = np.asarray(pose_xyc, dtype=np.float64)
    out = pose[PT15_FROM_COCO17].copy()
    out[:, 2] = out[:, 2] * float(global_score)
    return out


def convert_data_to_annorect_struct(poses, tracks, boxes, *,
                                    eval_tracking: bool = False,
                                    tracking_threshold: float = 0.0) -> List[dict]:
    """Per-frame predictions -> poseval annorect list (ref: evaluate.py:766-797).

    poses: list of (4, 17) arrays; tracks: track ids; boxes: list of (1, 6)
    arrays whose column 5 is the box score.
    """
    annorect = []
    for j in range(len(poses)):
        score = boxes[j][0, 5]
        if eval_tracking and score > tracking_threshold:
            continue
        point = coco2posetrack_ord(poses[j], global_score=score)
        annorect.append({"annopoints": [{"point": point}],
                         "score": [float(score)],
                         "track_id": [tracks[j]]})
    if len(poses) == 0:
        annorect.append({
            "annopoints": [{"point": [{"id": [0], "x": [0], "y": [0],
                                       "score": [-100.0]}]}],
            "score": [0], "track_id": [0]})
    return annorect
