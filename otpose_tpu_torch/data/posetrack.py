"""PoseTrack video dataset.

ref: dataset/PoseTrackDataset.py, dataset/Base.py.  Produces per-person-box
samples with a 5-frame temporal window (current, prev, next, pprev, nnext).

The port's copy of ``otpose_tpu/data/posetrack.py``'s host path: the host
indexes records, picks the temporal window, reads the five frames, draws the
augmentation parameters, warps, normalises and generates the gaussian
targets.  Device preprocessing and the C++ batch kernels of the JAX package
are not ported yet.  cv2 is needed only where a frame file is decoded,
warped or blurred: ``read_frame``, ``warp_frame`` and the train-time blur
import it when called, and a subclass may override ``frame_exists``,
``read_frame`` and ``warp_frame`` to supply frames without it
(``data/synthetic.py::ArrayFramesDataset`` does).

Reference behavioral quirks preserved because they shape the trained model /
mAP (SURVEY.md "quirks"): ``nnext_delta`` equals ``next_delta`` when two
next-frames exist (ref: PoseTrackDataset.py:292) so the 'nnext' frame usually
duplicates 'next' while pprev is genuinely two back; file-existence fallback
covers prev/next only (ref: 307-318); PT17 vs PT18 frame indexing inferred
from filename zero-fill (ref: 237-244).
"""

from __future__ import annotations

import copy
import logging
import os.path as osp
from typing import List, Optional

import numpy as np

from otpose_tpu_torch.data.coco_json import CocoIndex
from otpose_tpu_torch.ops.bbox import box2cs, half_body_center_scale
from otpose_tpu_torch.ops.affine import fliplr_joints, get_affine_transform, exec_affine_transform
from otpose_tpu_torch.ops.heatmap import generate_heatmaps

logger = logging.getLogger(__name__)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

FLIP_PAIRS = [[3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]]
JOINTS_WEIGHT = np.array(
    [1., 1., 1., 1., 1., 1., 1., 1.2, 1.2, 1.5, 1.5, 1., 1., 1.2, 1.2, 1.5, 1.5],
    dtype=np.float32).reshape((17, 1))
UPPER_BODY_IDS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)


class PoseTrackDataset:
    """Per-person-box video pose dataset (ref: PoseTrackDataset.py:24-451)."""

    def __init__(self, cfg, phase: str):
        self.cfg = cfg
        self.phase = phase
        self.train = phase == "train"
        self.is_posetrack18 = cfg.DATASET.IS_2018

        self.num_joints = cfg.MODEL.NUM_JOINTS
        self.image_size = np.array(cfg.MODEL.IMAGE_SIZE)      # (w, h)
        self.heatmap_size = np.array(cfg.MODEL.HEATMAP_SIZE)  # (w, h)
        self.aspect_ratio = self.image_size[0] / self.image_size[1]
        self.sigma = cfg.MODEL.SIGMA
        self.pixel_std = 200

        self.scale_factor = cfg.TRAIN.SCALE_FACTOR
        self.rotation_factor = cfg.TRAIN.ROT_FACTOR
        self.flip = cfg.TRAIN.FLIP
        self.prob_half_body = cfg.TRAIN.PROB_HALF_BODY
        self.num_joints_half_body = cfg.TRAIN.NUM_JOINTS_HALF_BODY
        self.use_different_joints_weight = cfg.LOSS.USE_DIFFERENT_JOINTS_WEIGHT
        self.color_rgb = cfg.DATASET.COLOR_RGB

        self.distance = cfg.DISTANCE
        self.random_aux_frame = cfg.DATASET.RANDOM_AUX_FRAME
        self.bbox_enlarge_factor = cfg.DATASET.BBOX_ENLARGE_FACTOR

        self.img_dir = cfg.DATASET.IMG_DIR
        self.json_dir = cfg.DATASET.JSON_DIR

        if phase != "train":
            self.img_dir = cfg.DATASET.TEST_IMG_DIR
            sub = cfg.VAL if phase == "validate" else cfg.TEST
            self.nms_thre = sub.NMS_THRE
            self.image_thre = sub.IMAGE_THRE
            self.soft_nms = sub.SOFT_NMS
            self.oks_thre = sub.OKS_THRE
            self.in_vis_thre = sub.IN_VIS_THRE
            self.bbox_file = sub.COCO_BBOX_FILE
            self.use_gt_bbox = sub.USE_GT_BBOX
            self.annotation_dir = sub.ANNOT_DIR

        json_name = "posetrack_train.json" if self.train else "posetrack_val.json"
        self.coco = CocoIndex(osp.join(self.json_dir, json_name))
        self.data = self._list_data()
        logger.info("PoseTrack%s %s: %d boxes from %d images",
                    "18" if self.is_posetrack18 else "17", phase,
                    len(self.data), len(self.coco.imgs))

    def __len__(self) -> int:
        return len(self.data)

    # ------------------------------------------------------------------ index

    def _list_data(self) -> List[dict]:
        # validate ALWAYS uses GT boxes — detection boxes are a test-phase
        # -only path in the reference too (ref: PoseTrackDataset.py:93-99;
        # VAL.USE_GT_BBOX=False alone deliberately changes nothing)
        if self.phase != "test" or self.use_gt_bbox:
            return self._load_gt_boxes()
        return self._load_detection_boxes()

    def _load_gt_boxes(self) -> List[dict]:
        """GT-annotation boxes (ref: PoseTrackDataset.py:101-174)."""
        person_cat_ids = {cid for cid, c in self.coco.cats.items()
                          if c.get("name") == "person"} or set(self.coco.get_cat_ids())
        records = []
        for img_id in self.coco.get_img_ids():
            im = self.coco.load_img(img_id)
            width, height = im["width"], im["height"]
            for obj in self.coco.load_anns(img_id, iscrowd=False):
                if obj.get("category_id") not in person_cat_ids:
                    continue
                kpts = obj.get("keypoints", [])
                if not kpts or max(kpts) == 0:
                    continue
                x, y, w, h = obj["bbox"]
                x1, y1 = max(0, x), max(0, y)
                x2 = min(width - 1, x1 + max(0, w - 1))
                y2 = min(height - 1, y1 + max(0, h - 1))
                if obj.get("area", 0) <= 0 or x2 < x1 or y2 < y1:
                    continue
                clean = [x1, y1, x2 - x1, y2 - y1]

                joints = np.zeros((self.num_joints, 3))
                joints_vis = np.zeros((self.num_joints, 3))
                for j in range(self.num_joints):
                    joints[j, 0] = kpts[j * 3 + 0]
                    joints[j, 1] = kpts[j * 3 + 1]
                    vis = min(kpts[j * 3 + 2], 1)
                    joints_vis[j, :2] = vis
                center, scale = box2cs(clean, self.aspect_ratio,
                                       self.bbox_enlarge_factor)
                records.append({
                    "image": osp.join(self.img_dir, im["file_name"]),
                    "center": center, "scale": scale, "box": clean,
                    "joints_3d": joints, "joints_3d_vis": joints_vis,
                    "filename": "", "imgnum": 0,
                    "nframes": int(im["nframes"]),
                    "frame_id": int(im["frame_id"]),
                })
        return records

    def _load_detection_boxes(self) -> List[dict]:
        """Precomputed detector boxes (ref: PoseTrackDataset.py:176-226)."""
        import json as _json

        with open(self.bbox_file) as f:
            all_boxes = _json.load(f)
        records = []
        for det in all_boxes:
            if det.get("category_id") != 1:
                continue
            if det["score"] < self.image_thre:
                continue
            center, scale = box2cs(det["bbox"], self.aspect_ratio,
                                   self.bbox_enlarge_factor)
            records.append({
                "image": osp.join(self.img_dir, det["image_name"]),
                "center": center, "scale": scale, "score": det["score"],
                "joints_3d": np.zeros((self.num_joints, 3)),
                "joints_3d_vis": np.ones((self.num_joints, 3)),
                "filename": "", "imgnum": 0,
                "nframes": int(det["nframes"]),
                "frame_id": int(det["frame_id"]),
            })
        return records

    # --------------------------------------------------------------- sampling

    def select_window(self, image_path: str, nframes: int) -> dict:
        """Temporal window selection (ref: PoseTrackDataset.py:237-318)."""
        base = osp.basename(image_path).replace(".jpg", "")
        zero_fill = len(base)
        is_pt18 = zero_fill == 6
        current = int(base)
        far = self.distance

        prev_range = list(range(1, min((current + 1) if is_pt18 else current, far + 1)))
        next_range = list(range(1, min((nframes - current) if is_pt18
                                       else (nframes - current + 1), far + 1)))

        if not prev_range:
            prev_delta = pprev_delta = margin_left = margin_lleft = 0
        elif len(prev_range) == 1:
            prev_delta, margin_left = prev_range[0], prev_range[0]
            pprev_delta = margin_lleft = 0
        else:
            prev_delta, margin_left = prev_range[0], prev_range[0]
            pprev_delta, margin_lleft = prev_range[1], prev_range[1]

        if not next_range:
            next_delta = nnext_delta = margin_right = margin_rright = 0
        elif len(next_range) == 1:
            next_delta, margin_right = next_range[-1], next_range[-1]
            nnext_delta = margin_rright = 0
        else:
            # reference quirk (PoseTrackDataset.py:290-293): nnext uses
            # next_range[0], so nnext usually duplicates next
            next_delta, margin_right = next_range[0], next_range[0]
            nnext_delta, margin_rright = next_range[0], next_range[0]

        d = osp.dirname(image_path)

        def frame_file(idx):
            return osp.join(d, str(idx).zfill(zero_fill) + ".jpg")

        prev_file = frame_file(current - prev_delta)
        next_file = frame_file(current + next_delta)
        pprev_file = frame_file(current - pprev_delta)
        nnext_file = frame_file(current + nnext_delta)

        # existence fallback: prev/next only (ref: 307-318)
        if not self.frame_exists(prev_file):
            prev_file, margin_left = image_path, 0
        if not self.frame_exists(next_file):
            next_file, margin_right = image_path, 0
        # (divergence, documented: the reference would crash on missing
        # pprev/nnext; we fall back to the current frame for robustness)
        if not self.frame_exists(pprev_file):
            pprev_file = image_path
        if not self.frame_exists(nnext_file):
            nnext_file = image_path

        return {
            "files": [image_path, prev_file, next_file, pprev_file, nnext_file],
            "margins": [margin_left, margin_right, margin_lleft, margin_rright],
        }

    def sample_augmentation(self, record: dict, rng: Optional[np.random.RandomState] = None) -> dict:
        """Draw train-time augmentation parameters (ref: PoseTrackDataset.py:347-386).
        Returns center/scale/rot/do_flip/do_blur plus (possibly flipped) joints.
        """
        rng = rng or np.random
        joints = record["joints_3d"].copy()
        joints_vis = record["joints_3d_vis"].copy()
        center = np.asarray(record["center"], np.float32).copy()
        scale = np.asarray(record["scale"], np.float32).copy()
        r = 0.0
        do_flip = False
        do_blur = False
        blur_sigma = 0.0

        if self.train:
            if (np.sum(joints_vis[:, 0]) > self.num_joints_half_body
                    and rng.rand() < self.prob_half_body):
                c_h, s_h = half_body_center_scale(joints, joints_vis, self.num_joints,
                                                  UPPER_BODY_IDS, self.aspect_ratio,
                                                  self.pixel_std, rng=rng)
                if c_h is not None:
                    center, scale = c_h, s_h

            sf = self.scale_factor
            if isinstance(sf, (list, tuple)):
                sf = sf[0]
            rf = self.rotation_factor
            scale = scale * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
            r = float(np.clip(rng.randn() * rf, -rf * 2, rf * 2)) \
                if rng.rand() <= 0.6 else 0.0
            do_flip = bool(self.flip and rng.rand() <= 0.5)
            do_blur = bool(rng.rand() <= 0.5)
            blur_sigma = float(rng.uniform(0.1, 5.0))

        return {"joints": joints, "joints_vis": joints_vis, "center": center,
                "scale": scale, "rotation": r, "do_flip": do_flip,
                "do_blur": do_blur, "blur_sigma": blur_sigma}

    # ---------------------------------------------------------------- frames

    def frame_exists(self, path: str) -> bool:
        """Whether the frame file behind ``path`` can be read."""
        return osp.exists(path)

    def read_frame(self, path: str) -> np.ndarray:
        """The frame at ``path`` as (H, W, 3) uint8, RGB when
        ``DATASET.COLOR_RGB`` (else cv2's BGR)."""
        import cv2

        im = cv2.imread(path)
        if im is None:
            raise ValueError(f"Fail to read {path}")
        if self.color_rgb:
            im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
        return im

    def warp_frame(self, im: np.ndarray, trans: np.ndarray, w: int, h: int) -> np.ndarray:
        """The (h, w, 3) uint8 crop of ``im`` under the 2x3 matrix ``trans``
        (bilinear, zeros outside the frame)."""
        import cv2

        return cv2.warpAffine(im, np.float64(trans), (w, h), flags=cv2.INTER_LINEAR)

    # ------------------------------------------------------------- host path

    def get_sample_host(self, item_idx: int,
                        rng: Optional[np.random.RandomState] = None) -> dict:
        """Full host-side sample (5 warped frames + targets + meta), matching
        the reference __getitem__ (ref: PoseTrackDataset.py:228-451)."""
        record = copy.deepcopy(self.data[item_idx])
        window = self.select_window(record["image"], record["nframes"])
        imgs = [self.read_frame(f) for f in window["files"]]

        aug = self.sample_augmentation(record, rng)
        joints, joints_vis = aug["joints"], aug["joints_vis"]
        center, scale, r = aug["center"], aug["scale"], aug["rotation"]

        if aug["do_flip"]:
            imgs = [im[:, ::-1, :] for im in imgs]
            joints, joints_vis = fliplr_joints(joints, joints_vis,
                                               imgs[0].shape[1], FLIP_PAIRS)
            center[0] = imgs[0].shape[1] - center[0] - 1

        if aug["do_blur"]:
            # Intentional divergence (ref: PoseTrackDataset.py:374-386): the
            # reference draws a fresh sigma per frame and applies torchvision
            # GaussianBlur(kernel=(9,5)) to an HWC *tensor*, which treats H as
            # the channel axis and so blurs only the W/C planes — a quirk with
            # no semantic intent.  We apply a proper 2-D spatial blur with one
            # sigma shared by all 5 frames (the frames form one temporal
            # window; consistent blur matches the shared affine-warp design).
            import cv2

            s = aug["blur_sigma"]
            imgs = [cv2.GaussianBlur(im, (9, 5), s) for im in imgs]

        trans = get_affine_transform(center, scale, r, self.image_size)
        w, h = int(self.image_size[0]), int(self.image_size[1])
        warped = [self.warp_frame(im, trans, w, h) for im in imgs]
        frames = [((im.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD
                  for im in warped]

        for i in range(self.num_joints):
            if joints_vis[i, 0] > 0.0:
                joints[i, 0:2] = exec_affine_transform(joints[i, 0:2], trans)
        for i, (x, y, _) in enumerate(joints):
            if x < 0 or y < 0 or x > self.image_size[0] or y > self.image_size[1]:
                joints_vis[i] = [0, 0, 0]

        target, target_weight = generate_heatmaps(
            joints, joints_vis, self.sigma, self.image_size, self.heatmap_size,
            self.num_joints,
            use_different_joints_weight=self.use_different_joints_weight,
            joints_weight=JOINTS_WEIGHT)

        meta = {
            "image": record["image"],
            "sup_images": window["files"][1:],
            "joints": joints, "joints_vis": joints_vis,
            "center": center, "scale": scale, "rotation": r,
            "score": record.get("score", 1),
            "margin_left": window["margins"][0],
            "margin_right": window["margins"][1],
            "margin_lleft": window["margins"][2],
            "margin_rright": window["margins"][3],
        }
        # stacked (H, W, 15) in reference channel order (cur, prev, next, pprev, nnext)
        inputs = np.concatenate(frames, axis=-1)
        target = np.transpose(target, (1, 2, 0))  # (Hh, Hw, J) NHWC
        return {"inputs": inputs, "target": target,
                "target_weight": target_weight,
                "margin": np.asarray(window["margins"], np.float32),
                "meta": meta}

    # ------------------------------------------------------------- evaluation

    def evaluate(self, cfg, preds, output_dir, boxes, filenames_map, *args,
                 **kwargs):
        """Write per-video poseval jsons and compute PoseTrack AP
        (ref: PoseTrackDataset.py:453-608).

        preds: (N, 17, 3) decoded keypoints in original-image coords;
        boxes: (N, 6) [center_x, center_y, scale_x, scale_y, area, score];
        filenames_map: image path -> list of row indices into preds/boxes.
        """
        import os
        from collections import OrderedDict

        from otpose_tpu_torch.evaluate.converters import video2filenames
        from otpose_tpu_torch.evaluate.keypoints import convert_data_to_annorect_struct
        from otpose_tpu_torch.evaluate.poseval import evaluate as poseval_evaluate

        output_dir = osp.join(output_dir,
                              "val_set_json_results" if self.phase == "validate"
                              else "test_set_json_results")
        os.makedirs(output_dir, exist_ok=True)

        video_map = {}
        vid2frame_map = {}
        vid2name_map = {}
        all_preds, all_boxes = [], []
        cc = 0
        for key in filenames_map:
            temp = key.split("/")
            video_name = temp[-3] + "/" + temp[-2]
            img_sfx = temp[-3] + "/" + temp[-2] + "/" + temp[-1]
            frame_num = int(temp[-1].replace(".jpg", ""))
            video_map.setdefault(video_name, []).append(cc)
            vid2frame_map.setdefault(video_name, []).append(frame_num)
            vid2name_map.setdefault(video_name, []).append(img_sfx)

            pose_list, box_list = [], []
            for idx in filenames_map[key]:
                pose = np.zeros((4, 17))
                pose[0, :] = preds[idx, :, 0]
                pose[1, :] = preds[idx, :, 1]
                pose[2, :] = preds[idx, :, 2]
                pose[3, :] = preds[idx, :, 2]
                pose_list.append(pose)
                box = np.zeros((1, 6))
                box[0, :] = boxes[idx, :]
                box_list.append(box)
            all_preds.append(pose_list)
            all_boxes.append(box_list)
            cc += 1

        annot_dir = self.annotation_dir
        out_filenames, lengths = video2filenames(annot_dir)
        out_data = {}
        for vid, idx_list in video_map.items():
            key = "images/" + vid
            if key not in lengths:
                continue
            cur_length = lengths[key]
            temp_kps_map = {}
            temp_box_map = {}
            for c, idx in enumerate(idx_list):
                frame_num = vid2frame_map[vid][c]
                temp_kps_map[frame_num] = (vid2name_map[vid][c], all_preds[idx])
                temp_box_map[frame_num] = all_boxes[idx]

            sid, fid = (0, cur_length) if self.is_posetrack18 \
                else (1, cur_length + 1)
            for frame_num in range(sid, fid):
                if frame_num in temp_kps_map:
                    img_sfx, kps = temp_kps_map[frame_num]
                    bboxs = temp_box_map[frame_num]
                    tracks = list(range(len(kps)))
                else:
                    arr = vid2name_map[vid][0].split("/")
                    zfill = 6 if self.is_posetrack18 else 8
                    img_sfx = arr[0] + "/" + arr[1] + "/" + \
                        str(frame_num).zfill(zfill) + ".jpg"
                    kps, tracks, bboxs = [], [], []
                data_el = {
                    "image": {"name": img_sfx},
                    "imgnum": [frame_num],
                    "annorect": convert_data_to_annorect_struct(kps, tracks, bboxs),
                }
                out_data.setdefault(vid, []).append(data_el)

        import json as _json

        for vname, vdata in out_data.items():
            outfpath = osp.join(output_dir, out_filenames[osp.join("images", vname)])
            with open(outfpath, "w") as f:
                _json.dump({"annolist": vdata}, f)

        eval_track = bool(getattr(cfg, "EVAL_TRACKING", False))
        ap, mota = poseval_evaluate(annot_dir, output_dir, eval_track=eval_track)
        name_value = OrderedDict([
            ("Head", ap[0]), ("Shoulder", ap[1]), ("Elbow", ap[2]),
            ("Wrist", ap[3]), ("Hip", ap[4]), ("Knee", ap[5]),
            ("Ankle", ap[6]), ("Mean", ap[7]),
        ])
        return name_value, name_value["Mean"]
