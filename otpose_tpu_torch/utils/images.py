"""Image and visualization utilities (counterpart of
``otpose_tpu/utils/images.py``).

ref: utils/images.py:14-174, utils/evaluate.py:244-338 (result-image dumps),
configs/constants.py (skeleton pairs/colors).  Arrays are numpy (the eval
loops hand over host arrays); cv2 is imported inside each function that
draws, reads or writes an image, so importing this module needs no cv2.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np

from otpose_tpu_torch.data.posetrack import IMAGENET_MEAN, IMAGENET_STD

# PoseTrack-COCO-17 skeleton (ref: configs/constants.py:59-78)
KEYPOINT_PAIRS = [
    (2, 1), (1, 6), (1, 5), (6, 8), (8, 10), (5, 7), (7, 9),
    (6, 12), (5, 11), (12, 14), (14, 16), (11, 13), (13, 15),
]
_COLORS = [
    (228, 63, 118), (255, 255, 0), (255, 255, 0), (0, 0, 255), (0, 0, 255),
    (0, 255, 0), (0, 255, 0), (128, 0, 128), (135, 206, 235), (128, 0, 128),
    (128, 0, 128), (135, 206, 235), (135, 206, 235),
]


def tensor2im(t: np.ndarray) -> np.ndarray:
    """Normalized (H, W, 3) or (3, H, W) float tensor -> uint8 BGR image
    (ref: utils/images.py:14-37, utils/transform.py:129-143)."""
    t = np.asarray(t)
    if t.ndim == 3 and t.shape[0] == 3:
        t = np.transpose(t, (1, 2, 0))
    img = (t * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., ::-1]  # RGB -> BGR


def draw_skeleton(image: np.ndarray, pose: np.ndarray,
                  conf: Optional[np.ndarray] = None, vis_thre: float = 0.0,
                  thickness: int = 2) -> np.ndarray:
    """Draw the 17-joint skeleton on a BGR image (ref: utils/images.py:40-110)."""
    import cv2

    img = image.copy()
    for (a, b), color in zip(KEYPOINT_PAIRS, _COLORS):
        if conf is not None and (conf[a] < vis_thre or conf[b] < vis_thre):
            continue
        pa = (int(pose[a, 0]), int(pose[a, 1]))
        pb = (int(pose[b, 0]), int(pose[b, 1]))
        cv2.line(img, pa, pb, color, thickness, cv2.LINE_AA)
    for j in range(len(pose)):
        if conf is not None and conf[j] < vis_thre:
            continue
        cv2.circle(img, (int(pose[j, 0]), int(pose[j, 1])), 3, (0, 165, 255), -1)
    return img


def draw_bbox(image: np.ndarray, bbox, color=(0, 255, 0),
              label: Optional[str] = None,
              thickness: Optional[int] = None) -> np.ndarray:
    """Draw an xyxy box (+ optional label) on a BGR image
    (ref: utils/bbox.py:58-94 add_bbox_in_image)."""
    import cv2

    x1, y1, x2, y2 = map(int, bbox)
    if thickness is None:
        thickness = round(0.002 * (image.shape[0] + image.shape[1]) / 2) + 1
    out = cv2.rectangle(image, (x1, y1), (x2, y2), color,
                        thickness=thickness, lineType=cv2.LINE_AA)
    if label:
        ft = max(thickness - 1, 1)
        cv2.putText(out, label, (x1, max(y1 - 2, 0)), 0, ft / 3,
                    (225, 255, 255), thickness=ft, lineType=cv2.LINE_AA)
    return out


def draw_skeleton_in_origin_image(image_paths: Sequence[str],
                                  batch_coords, batch_bboxes,
                                  save_dir: str, *, vis_skeleton: bool = True,
                                  vis_bbox: bool = True,
                                  sure_threshold: float = 0.2) -> list:
    """Accumulate per-person skeleton/bbox overlays onto the ORIGINAL frames
    (ref: utils/images.py:40-88): each call re-reads the frame previously
    written under ``save_dir`` (if any) so every person lands on one image.

    ``batch_coords``: (N, J, 3) keypoints in origin-image coordinates with
    confidence; ``batch_bboxes``: xyxy per person.  Output subdir mirrors the
    reference naming: skeleton/ bbox/ SkeletonAndBbox/.
    """
    import cv2

    sub = ("SkeletonAndBbox" if (vis_skeleton and vis_bbox)
           else "bbox" if vis_bbox else "skeleton")
    written = []
    for path, coords, box in zip(image_paths, batch_coords, batch_bboxes):
        coords = np.asarray(coords)
        # keep the frame's path structure below the dataset's images/ root
        # (reference slices after "images/"; fall back to the basename)
        marker = "images" + os.sep
        rel = path.split(marker, 1)[1] if marker in path else osp.basename(path)
        out_path = osp.join(save_dir, sub, rel)
        os.makedirs(osp.dirname(out_path), exist_ok=True)
        img = cv2.imread(out_path) if osp.exists(out_path) else cv2.imread(path)
        if img is None:
            continue
        if vis_skeleton:
            img = draw_skeleton(img, coords[:, :2], coords[:, 2],
                                vis_thre=sure_threshold)
        if vis_bbox:
            img = draw_bbox(img, box)
        cv2.imwrite(out_path, img)
        written.append(out_path)
    return written


def heatmaps_overlay(image: np.ndarray, heatmaps: np.ndarray) -> np.ndarray:
    """Sum-of-heatmaps jet overlay for debugging dumps
    (ref: utils/evaluate.py:244-338).  ``heatmaps`` is CHW ``(J, h, w)`` —
    explicitly, not guessed: a layout heuristic mis-fires whenever the
    spatial size drops below the joint count (tiny debug models)."""
    import cv2

    hm = np.asarray(heatmaps)
    summed = np.clip(hm.sum(axis=0), 0, 1)
    summed = cv2.resize((summed * 255).astype(np.uint8),
                        (image.shape[1], image.shape[0]))
    color = cv2.applyColorMap(summed, cv2.COLORMAP_JET)
    return cv2.addWeighted(image, 0.6, color, 0.4, 0)


def save_result_images(out_dir: str, img, pose, conf, heatmaps=None,
                       name: str = "") -> str:
    """Dump skeleton + heatmap overlays (ref: utils/evaluate.py:244-338).
    ``heatmaps``, when given, is CHW ``(J, h, w)``."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    if img.dtype != np.uint8:
        img = tensor2im(img)
    vis = draw_skeleton(img, pose, conf)
    if heatmaps is not None:
        vis = heatmaps_overlay(vis, heatmaps)
    path = osp.join(out_dir, f"{name}result.jpg")
    cv2.imwrite(path, vis)
    return path


def video2images(video_path: str, out_dir: str) -> int:
    """Split a video into numbered jpgs (ref: utils/images.py:136-155)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        cv2.imwrite(osp.join(out_dir, f"{n:08d}.jpg"), frame)
        n += 1
    cap.release()
    return n


def images2video(image_paths: Sequence[str], out_path: str, fps: int = 25):
    """Join frames into a video (ref: utils/images.py:158-174)."""
    import cv2

    first = cv2.imread(image_paths[0])
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for p in image_paths:
        writer.write(cv2.imread(p))
    writer.release()
    return out_path


def image2video(image_dir: str, name: str, fps: int = 25,
                out_dir: str = "output") -> str:
    """Reference-surface wrapper: all .jpg frames of a directory, sorted, to
    ``<out_dir>/<name>.mp4`` (ref: utils/images.py:161-174 writes DIVX to
    ./output; mp4v is the portable equivalent)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = sorted(osp.join(image_dir, f) for f in os.listdir(image_dir)
                   if f.endswith(".jpg"))
    if not paths:
        raise FileNotFoundError(f"no .jpg frames in {image_dir}")
    return images2video(paths, osp.join(out_dir, f"{name}.mp4"), fps)


def save_fusion_images(out_dir: str, img: np.ndarray, name: str = "", *,
                       heatmaps: np.ndarray) -> list:
    """Per-joint heatmap-fusion overlays, one png per keypoint
    (ref: utils/evaluate.py:244-256: min-max normalized image, BONE colormap,
    0.3*img + 0.7*heatmap blend, files ``{name}{joint}_img_heatmap.png``)."""
    import cv2

    from otpose_tpu_torch.evaluate.keypoints import POSETRACK_COCO_17

    os.makedirs(out_dir, exist_ok=True)
    img = np.asarray(img, np.float64)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-12) * 255
    paths = []
    for i, joint_name in enumerate(POSETRACK_COCO_17):
        hm = np.clip(heatmaps[i] * 255, 0, 255).astype(np.uint8)
        colored = cv2.applyColorMap(hm, cv2.COLORMAP_BONE)
        colored = cv2.resize(colored, (img.shape[1], img.shape[0]))
        blend = img * 0.3 + colored * 0.7
        path = osp.join(out_dir, f"{name}{joint_name}_img_heatmap.png")
        cv2.imwrite(path, blend)
        paths.append(path)
    return paths
