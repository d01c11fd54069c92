"""A synthetic PoseTrack-format fixture that needs no cv2: a generator of
the tree (jsons, and frames as arrays) and the dataset that reads it."""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
import torch

from otpose_tpu_torch.data.posetrack import PoseTrackDataset
from otpose_tpu_torch.evaluate.keypoints import PT15_FROM_COCO17
from otpose_tpu_torch.ops.affine import invert_affine, warp_affine


def make_synthetic_posetrack(root: str, *, num_videos: int = 2, frames_per_video: int = 5,
                             people_per_frame: int = 2, img_w: int = 128, img_h: int = 96,
                             is_2018: bool = False, seed: int = 0):
    """A PoseTrack-format tree under ``root``, drawn from ``seed`` with
    numpy: ``json/posetrack_{train,val}.json`` (COCO style), one poseval
    annolist json a video under ``annot/``, and the frames under
    ``images/train/<video>/`` as uint8 RGB arrays in ``<frame>.npy`` beside
    the ``<frame>.jpg`` name that the jsons carry (``ArrayFramesDataset``
    reads them).  Frames are numbered like PT17 (8 digits from 1) or PT18
    (6 digits from 0).  A frame is noise with a white disc for each person;
    the 17 joints scatter around the disc's centre, so no model can score
    well on it.  Returns (json_dir, img_dir, annot_dir)."""
    rng = np.random.RandomState(seed)
    img_dir, json_dir, annot_dir = (osp.join(root, d) for d in ("images", "json", "annot"))
    os.makedirs(json_dir, exist_ok=True)
    os.makedirs(annot_dir, exist_ok=True)
    zero_fill, start = (6, 0) if is_2018 else (8, 1)
    yy, xx = np.mgrid[:img_h, :img_w]
    images, annotations = [], []
    for v in range(num_videos):
        vname = f"{v:06d}_bonn_train" if is_2018 else f"{v:05d}_bonn"
        vdir = osp.join(img_dir, "train", vname)
        os.makedirs(vdir, exist_ok=True)
        annolist = []
        for f in range(frames_per_video):
            frame_num = start + f
            rel = osp.join("train", vname, str(frame_num).zfill(zero_fill) + ".jpg")
            img = rng.randint(0, 255, (img_h, img_w, 3)).astype(np.uint8)
            img_id = 1000 + len(images)
            images.append({"id": img_id, "file_name": rel, "width": img_w, "height": img_h,
                           "nframes": frames_per_video, "frame_id": frame_num,
                           "is_labeled": True})
            annorects = []
            for track_id in range(people_per_frame):
                cx = int(rng.randint(25, img_w - 25))
                cy = int(rng.randint(20, img_h - 20))
                img[(xx - cx) ** 2 + (yy - cy) ** 2 <= 64] = 255
                joints = np.stack([np.clip(cx + rng.randn(17) * 4, 0, img_w - 1),
                                   np.clip(cy + rng.randn(17) * 4, 0, img_h - 1)], axis=1)
                x0, y0 = max(0.0, cx - 20.0), max(0.0, cy - 16.0)
                bw, bh = min(img_w - 1 - x0, 40.0), min(img_h - 1 - y0, 32.0)
                annotations.append({
                    "id": len(annotations) + 1, "image_id": img_id, "category_id": 1,
                    "bbox": [x0, y0, bw, bh], "area": bw * bh, "iscrowd": 0,
                    "keypoints": [float(c) for x, y in joints for c in (x, y, 1)],
                    "num_keypoints": 17, "track_id": track_id})
                points = [{"id": [k], "x": [float(joints[src, 0])], "y": [float(joints[src, 1])],
                           "score": [1.0], "is_visible": [1]}
                          for k, src in enumerate(PT15_FROM_COCO17)]
                # the head box spans head_bottom (1) to head_top (2), padded by 6
                annorects.append({
                    "track_id": [track_id], "annopoints": [{"point": points}],
                    "x1": [float(joints[1, 0]) - 6], "y1": [float(joints[1, 1]) - 6],
                    "x2": [float(joints[2, 0]) + 6], "y2": [float(joints[2, 1]) + 6],
                    "score": [1.0]})
            np.save(osp.join(img_dir, rel[:-4] + ".npy"), img)
            annolist.append({"image": [{"name": "images/" + rel.replace(os.sep, "/")}],
                             "annorect": annorects, "imgnum": [frame_num],
                             "is_labeled": [1]})
        with open(osp.join(annot_dir, vname + ".json"), "w") as fh:
            json.dump({"annolist": annolist}, fh)
    blob = {"images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "person"}]}
    for name in ("posetrack_train.json", "posetrack_val.json"):
        with open(osp.join(json_dir, name), "w") as fh:
            json.dump(blob, fh)
    return json_dir, img_dir, annot_dir


class ArrayFramesDataset(PoseTrackDataset):
    """``PoseTrackDataset`` over frames stored as ``<frame>.npy`` arrays
    beside their ``<frame>.jpg`` names (``make_synthetic_posetrack``), for a
    machine without cv2: the frame is loaded with numpy and cropped by the
    port's torch ``warp_affine`` on the CPU, rounded to uint8 as
    ``cv2.warpAffine`` returns it."""

    @staticmethod
    def _array_path(path: str) -> str:
        return osp.splitext(path)[0] + ".npy"

    def frame_exists(self, path: str) -> bool:
        return osp.exists(self._array_path(path))

    def read_frame(self, path: str) -> np.ndarray:
        return np.load(self._array_path(path))

    def warp_frame(self, im: np.ndarray, trans: np.ndarray, w: int, h: int) -> np.ndarray:
        # a train sample's flip hands over a view with a negative stride
        crop = warp_affine(torch.from_numpy(np.ascontiguousarray(im)).float()[None],
                           invert_affine(trans)[None], h, w)
        return crop[0].round().clamp(0, 255).to(torch.uint8).numpy()
