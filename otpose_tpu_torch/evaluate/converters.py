"""PoseTrack17 (annolist) <-> PoseTrack18 (COCO-style) format conversion.

Functional re-implementation of the reference's Person/Image/Video conversion
stack (ref: utils/setup.py:274-783).  Used by the evaluator to normalize GT /
prediction jsons (ref: utils/evaluate.py:833,862), and exposed as a public
converter utility.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, List, Tuple

import numpy as np

PT18_LM_NAMES_COCO_ORDER = [
    "nose", "head_bottom", "head_top", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
]
PT18_LM_NAMES = [
    "right_ankle", "right_knee", "right_hip", "left_hip", "left_knee",
    "left_ankle", "right_wrist", "right_elbow", "right_shoulder",
    "left_shoulder", "left_elbow", "left_wrist", "head_bottom", "nose",
    "head_top",
]

_SEQTYPE_IDX = {"mpii": 1, "bonn": 2, "mpiinew": 3}


def posetrack18_fname2id(seq_name: str, frame_idx: int) -> int:
    """ref: utils/setup.py:287-299."""
    tok = osp.basename(seq_name).split("_")
    seqidx = int(tok[0])
    seqtype_idx = _SEQTYPE_IDX[tok[1]]
    assert 0 <= frame_idx < 1e4
    return seqtype_idx * 10000000000 + seqidx * 10000 + frame_idx


# ---------------------------------------------------------------------------
# PT18 (COCO-style) -> PT17 (annolist)
# ---------------------------------------------------------------------------

def _person_new_to_old(ann: dict, conversion_table: List[int | None]) -> dict:
    """ref: utils/setup.py:470-519 (from_new) + 374-404 (to_old)."""
    kpts = np.asarray(ann["keypoints"], dtype=np.float64).reshape(
        len(conversion_table), 3)
    scores = ann.get("scores")
    points = []
    for lm_idx, (x, y, vis) in enumerate(kpts):
        can = conversion_table[lm_idx]
        if can is None:
            continue
        if x == 0 and y == 0 and vis == 0:
            continue  # unannotated in the new format
        point = {"id": [can], "x": [float(x)], "y": [float(y)],
                 "is_visible": [int(vis)]}
        if scores:
            point["score"] = [scores[lm_idx]]
        points.append(point)
    rect = {"track_id": [ann["track_id"]],
            "annopoints": [{"point": points}]}
    if "bbox_head" in ann:
        bx = ann["bbox_head"]
        rect["x1"], rect["y1"] = [bx[0]], [bx[1]]
        rect["x2"], rect["y2"] = [bx[0] + bx[2]], [bx[1] + bx[3]]
    if "score" in ann:
        rect["score"] = [ann["score"]]
    return rect


def _conversion_table(categories: List[dict]) -> List[int | None]:
    assert len(categories) == 1 and categories[0]["name"] == "person"
    names = categories[0]["keypoints"]
    assert len(names) in (15, 17)
    table = [PT18_LM_NAMES.index(n) if n in PT18_LM_NAMES else None for n in names]
    for lm_idx in range(len(PT18_LM_NAMES)):
        assert lm_idx in table, f"Landmark {PT18_LM_NAMES[lm_idx]} not found"
    return table


def new_to_old(track_data: dict) -> List[dict]:
    """PT18 COCO-style blob -> list of {'annolist': [...]} per video
    (ref: utils/setup.py:731-783 from_new + 690-708 to_old)."""
    table = _conversion_table(track_data["categories"])
    anns_by_image: Dict[int, List[dict]] = {}
    for ann in track_data.get("annotations", []):
        anns_by_image.setdefault(ann["image_id"], []).append(ann)

    videos: Dict[str, dict] = {}
    order: List[str] = []
    for im in track_data["images"]:
        fname = im["file_name"]
        vid = osp.basename(osp.dirname(fname)).split("_")[0]
        if vid not in videos:
            videos[vid] = {"annolist": []}
            order.append(vid)
        elem: dict = {"image": [{"name": fname}]}
        elem["imgnum"] = [int(osp.basename(fname).split(".")[0]) + 1]
        if "ignore_regions_x" in im and "ignore_regions_y" in im:
            ir_list = []
            for xs, ys in zip(im["ignore_regions_x"], im["ignore_regions_y"]):
                ir_list.append({"point": [{"x": [x], "y": [y]}
                                          for x, y in zip(xs, ys)]})
            elem["ignore_regions"] = ir_list
        rects = [_person_new_to_old(a, table) for a in anns_by_image.get(im["id"], [])]
        elem["annorect"] = rects
        elem["is_labeled"] = [1 if rects else 0]
        videos[vid]["annolist"].append(elem)
    return [videos[v] for v in order]


# ---------------------------------------------------------------------------
# PT17 (annolist) -> PT18 (COCO-style)
# ---------------------------------------------------------------------------

def _person_old_to_new(rect: dict) -> dict:
    """ref: utils/setup.py:405-468 (from_old) + 320-374 (to_new)."""
    lms = {}
    scores_present = False
    points = (rect.get("annopoints") or [{}])[0].get("point", [])
    for p in points:
        lm = {"x": p["x"][0], "y": p["y"][0], "id": p["id"][0]}
        if "score" in p:
            lm["score"] = p["score"][0]
            scores_present = True
        if "is_visible" in p:
            lm["is_visible"] = p["is_visible"][0]
        # keep-FIRST on duplicate point ids: the reference indexes
        # ``[lm for lm in landmarks if lm.id == id][0]`` (ref:
        # utils/setup.py:338), same as poseval._frame_arrays
        lms.setdefault(p["id"][0], lm)

    keypoints, scores = [], []
    for name in PT18_LM_NAMES_COCO_ORDER:
        lm_id = PT18_LM_NAMES.index(name) if name in PT18_LM_NAMES else -1
        lm = lms.get(lm_id)
        if lm is None:
            keypoints.extend([0, 0, 0])
            if scores_present:
                scores.append(0.0)
            continue
        keypoints.extend([lm["x"], lm["y"], lm.get("is_visible", 1)])
        if scores_present:
            scores.append(lm.get("score", 0.0))

    ret = {"track_id": rect["track_id"][0], "category_id": 1,
           "keypoints": keypoints, "scores": scores}
    if points:
        # the reference synthesizes the person box from the landmark extents,
        # padded 1.3x around the center (ref: utils/setup.py:456-467); the
        # rect-level "score" is parsed but deliberately NOT re-emitted
        # (ref: to_new, utils/setup.py:350-370)
        xs = np.array([p["x"][0] for p in points])
        ys = np.array([p["y"][0] for p in points])
        xc, yc = (xs.max() + xs.min()) / 2., (ys.max() + ys.min()) / 2.
        xe, ye = xs.max() - xs.min(), ys.max() - ys.min()
        x1, x2 = xc - 0.65 * xe, xc + 0.65 * xe
        y1, y2 = yc - 0.65 * ye, yc + 0.65 * ye
        # width/height as corner differences, bit-matching the reference
        ret["bbox"] = [x1, y1, x2 - x1, y2 - y1]
    if all(k in rect for k in ("x1", "x2", "y1", "y2")):
        ret["bbox_head"] = [rect["x1"][0], rect["y1"][0],
                            rect["x2"][0] - rect["x1"][0],
                            rect["y2"][0] - rect["y1"][0]]
    return ret


def old_to_new(track_data: dict) -> List[dict]:
    """{'annolist': [...]} -> one PT18 COCO-style blob per video
    (ref: utils/setup.py:711-729 from_old + 643-688 to_new)."""
    frames = track_data["annolist"]
    images, annotations = [], []
    vid_id = None
    nframes = len(frames)
    for elem in frames:
        fname = elem["image"][0]["name"]
        seq = osp.basename(osp.dirname(fname))
        vid_id = seq.split("_")[0]
        frame_base = osp.basename(fname).split(".")[0]
        if "_" in frame_base:
            frame_base = frame_base.split("_")[0]
        frame_id = posetrack18_fname2id(seq, int(frame_base))
        rects = elem.get("annorect") or []
        im = {"file_name": fname, "has_no_densepose": True,
              "is_labeled": len(rects) > 0, "frame_id": frame_id,
              "vid_id": vid_id, "nframes": nframes, "id": int(frame_id)}
        if "ignore_regions" in elem:
            im["ignore_regions_x"] = [[p["x"][0] for p in r["point"]]
                                      for r in elem["ignore_regions"]]
            im["ignore_regions_y"] = [[p["y"][0] for p in r["point"]]
                                      for r in elem["ignore_regions"]]
        images.append(im)
        for pidx, rect in enumerate(rects):
            ann = _person_old_to_new(rect)
            ann["image_id"] = int(frame_id)
            ann["id"] = int(frame_id) * 100 + pidx
            annotations.append(ann)
    return [{
        "images": images,
        "annotations": annotations,
        "categories": [{"supercategory": "person", "name": "person", "id": 1,
                        "keypoints": PT18_LM_NAMES_COCO_ORDER,
                        "skeleton": [[16, 14], [14, 12], [17, 15], [15, 13],
                                     [12, 13], [6, 12], [7, 13], [6, 7], [6, 8],
                                     [7, 9], [8, 10], [9, 11], [2, 3], [1, 2],
                                     [1, 3], [2, 4], [3, 5], [4, 6], [5, 7]]}],
    }]


def convert_videos(track_data: dict) -> List[dict]:
    """Auto-detect direction (ref: utils/setup.py:767-783)."""
    if "annolist" in track_data:
        return old_to_new(track_data)
    assert "images" in track_data, "Unknown image format"
    return new_to_old(track_data)


def video2filenames(annot_dir: str) -> Tuple[Dict[str, str], Dict[str, int]]:
    """Map video dir ('images/<split>/<seq>') -> annotation filename, and
    video dir -> frame count (ref: utils/setup.py:227-271)."""
    json_files = [f for f in os.listdir(annot_dir)
                  if osp.isfile(osp.join(annot_dir, f)) and f.endswith(".json")]
    mat_files = [f for f in os.listdir(annot_dir)
                 if osp.isfile(osp.join(annot_dir, f)) and f.endswith(".mat")]
    use_json = len(json_files) > 1 or (json_files and not mat_files)
    output: Dict[str, str] = {}
    lengths: Dict[str, int] = {}
    files = json_files if use_json else mat_files
    for fname in files:
        if use_json:
            with open(osp.join(annot_dir, fname)) as f:
                data = json.load(f)
            if "annolist" in data:
                first_name = data["annolist"][0]["image"][0]["name"]
                num_frames = len(data["annolist"])
            else:
                first_name = data["images"][0]["file_name"]
                num_frames = data["images"][0].get("nframes", len(data["images"]))
            out_fname = fname
        else:
            import scipy.io as sio

            data = sio.loadmat(osp.join(annot_dir, fname), squeeze_me=True,
                               struct_as_record=False)
            first_name = data["annolist"][0].image.name
            data2 = sio.loadmat(osp.join(annot_dir, fname))
            num_frames = len(data2["annolist"][0])
            out_fname = fname.replace(".mat", ".json")
        video_dir = osp.dirname(first_name)
        output[video_dir] = out_fname
        lengths[video_dir] = num_frames
    return output, lengths
