"""Minimal COCO-format json index (pycocotools-free).

The reference uses pycocotools.COCO (ref: dataset/PoseTrackDataset.py:5,67-78);
the port does not depend on pycocotools: all it needs is image/annotation
indexing over PoseTrack's COCO-style jsons.  The port's copy of
``otpose_tpu/data/coco_json.py``.
"""

from __future__ import annotations

import json
from typing import Dict, List


class CocoIndex:
    def __init__(self, json_path: str):
        with open(json_path, "r") as f:
            blob = json.load(f)
        self.dataset = blob
        self.imgs: Dict[int, dict] = {im["id"]: im for im in blob.get("images", [])}
        self.cats: Dict[int, dict] = {c["id"]: c for c in blob.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = {im_id: [] for im_id in self.imgs}
        for ann in blob.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def load_img(self, img_id: int) -> dict:
        return self.imgs[img_id]

    def load_anns(self, img_id: int, iscrowd: bool | None = None) -> List[dict]:
        anns = self.img_to_anns.get(img_id, [])
        if iscrowd is not None:
            anns = [a for a in anns if bool(a.get("iscrowd", 0)) == iscrowd]
        return anns

    def cat_names(self) -> List[str]:
        return [c["name"] for c in self.cats.values()]

    def get_cat_ids(self) -> List[int]:
        return list(self.cats.keys())
