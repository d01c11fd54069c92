"""Single-clip inference API (counterpart of ``otpose_tpu/cli/inference.py``).

ref: utils/inference.py:58-110 (``inference_PE``): (5 frames, bbox) -> 17
keypoints.  The five frames are warped to the model's crop on the device,
normalised with the ImageNet mean and std, run through ``otpose_forward``
(the port's CUDA kernels on a GPU) and decoded by ``get_final_preds``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from otpose_tpu_torch.data.posetrack import IMAGENET_MEAN, IMAGENET_STD
from otpose_tpu_torch.models.otpose import OTPose, otpose_forward
from otpose_tpu_torch.ops.affine import get_affine_transform, invert_affine, warp_affine
from otpose_tpu_torch.ops.bbox import box2cs
from otpose_tpu_torch.ops.heatmap import get_final_preds
from otpose_tpu_torch.utils.device import resolve_device, resolve_dtype


class PoseEstimator:
    """Serving wrapper: build once, call per clip (a batch of one).

    ``model`` is the port's ``OTPose`` (from ``build_model`` or loaded
    through ``jax_bridge``); it is moved to ``device`` (``cuda`` unless the
    caller asks for ``cpu``) and used as it is, so weights cast by
    ``prepare_eval_params`` stay cast."""

    def __init__(self, cfg, model: OTPose, compute_dtype=torch.bfloat16, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.image_size = np.array(cfg.MODEL.IMAGE_SIZE)  # (w, h)
        self.aspect_ratio = self.image_size[0] / self.image_size[1]
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=self.device)

    def preprocess(self, images: Sequence[np.ndarray], bbox) -> tuple:
        """5 frames (in the checkpoint's training channel order, see
        DATASET.COLOR_RGB) + xywh bbox -> (1, H, W, 15) f32 tensor on the
        device + center/scale (ref: utils/inference.py:58-82)."""
        w, h = int(self.image_size[0]), int(self.image_size[1])
        center, scale = box2cs(bbox, self.aspect_ratio)
        inv = invert_affine(get_affine_transform(center, scale, 0, self.image_size))
        stack = torch.from_numpy(np.stack(images)).to(self.device).float()  # (5, H, W, 3)
        crops = warp_affine(stack, np.repeat(inv[None], len(images), 0), h, w)
        crops = (crops / 255.0 - self._mean) / self._std
        x = crops.permute(1, 2, 0, 3).reshape(1, h, w, 3 * len(images))
        return x, center, scale

    @torch.inference_mode()
    def forward(self, x: torch.Tensor, margin) -> torch.Tensor:
        """(1, H, W, 15) clip -> output heatmaps (1, J, Hh, Hw), f32, on the device."""
        m = torch.as_tensor([list(margin)], dtype=torch.float32, device=self.device)
        heat = otpose_forward(self.model, x, m, compute_dtype=self.compute_dtype)[0]
        return heat.permute(0, 3, 1, 2)

    def __call__(self, image_paths: Sequence[str], bbox,
                 margin=(1, 1, 2, 2)) -> np.ndarray:
        """(5 image paths ordered cur/prev/next/pprev/nnext, xywh box) ->
        (17, 3) keypoints in original image coords (ref: inference.py:84-110)."""
        import cv2

        images = []
        for p in image_paths:
            im = cv2.imread(p)
            if im is None:
                raise ValueError(f"Fail to read {p}")
            # the channel order the checkpoint was trained on: the data
            # pipeline converts under the same DATASET.COLOR_RGB flag, whose
            # default is False (BGR)
            if self.cfg.DATASET.COLOR_RGB:
                im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
            images.append(im)
        return self.infer_images(images, bbox, margin)

    def infer_images(self, images: Sequence[np.ndarray], bbox,
                     margin=(1, 1, 2, 2)) -> np.ndarray:
        """Five decoded uint8 (H, W, 3) frames + xywh box -> (17, 3)
        keypoints (x, y, maxval) in original image coords."""
        x, center, scale = self.preprocess(images, bbox)
        heat = self.forward(x, margin)
        preds, maxvals = get_final_preds(heat, center[None], scale[None])
        return np.concatenate([preds[0], maxvals[0]], axis=1)


def inference_PE(model: PoseEstimator, image_path: str, prev_image_path: str,
                 next_image_path: str, pprev_image_path: str,
                 nnext_image_path: str, bbox) -> np.ndarray:
    """Functional form matching the reference name (ref: inference.py:84)."""
    return model([image_path, prev_image_path, next_image_path,
                  pprev_image_path, nnext_image_path], bbox)
