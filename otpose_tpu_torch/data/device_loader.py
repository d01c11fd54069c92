"""Device-preprocessing loader: the host decodes, the device does the rest
(counterpart of ``otpose_tpu/data/device_loader.py``).

Replaces the reference's CPU hot loop (5x cv2.warpAffine + normalize +
gaussian targets per box inside worker processes, ref:
PoseTrackDataset.py:388-425) with batched torch ops on the run's device.
Two modes:

- ``mode="crops"`` (the default, and what ``auto`` takes on a GPU): host
  threads read the 5 frames and warp them to crop size with the dataset's
  ``warp_frame`` (cv2, or a subclass's own), and ship **uint8 crops**; the
  device does normalize, the 15-channel temporal assembly and the gaussian
  targets (``pipeline.preprocess_crops_batch``).  Pixels equal the host
  path's (the same warp).
- ``mode="full"``: raw frames are staged into a fixed (max_h, max_w) uint8
  buffer and the 5-frame warp runs on the device as a separable tent product
  (``pipeline.preprocess_batch``); rotated train samples are pre-warped on
  the host (the separable warp takes axis-aligned maps only).  A frame
  larger than the buffer raises and names ``max_frame_hw`` (silent cropping
  would corrupt geometry).

Decoders (``decoder``, chosen when the loader is made by
``data/decoders.py::choose_decoder`` for a dataset whose frames are JPEG
files, ``reads_jpeg_files``):

- ``"nvjpeg"``: on a CUDA device in ``full`` mode; the loader raises when
  ``data/nvjpeg.py`` cannot build there.  The host reads the files' bytes
  and each frame's size from its header; the card decodes the batch's
  frames into the staging tensor.  A flip runs on the card; a train sample
  that blurs or rotates copies its decoded frames to the host for cv2's
  blur and the dataset's warp, as the host decode path does there.  A failure raises with the file's name and is
  never retried on the host.
- ``"native"``: the native IO library (``data/native.py``) decodes the
  window on the host threads straight into the sample's staging array, as
  the JAX package does whenever its library loads; a decode failure raises,
  naming the files and ``max_frame_hw``.
- ``"read_frame"``: the dataset's ``read_frame`` (cv2, or a subclass's own,
  as ``data/synthetic.py::ArrayFramesDataset`` has for a machine without
  cv2).

The native library and nvJPEG emit RGB; ``DATASET.COLOR_RGB`` false flips
the channels to BGR, as ``read_frame`` gives it.  ``crops`` mode decodes on
the host (its warp runs there).  The train-time blur needs cv2, as on the
host path.
"""

from __future__ import annotations

import copy
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from otpose_tpu_torch.data import native as native_io
from otpose_tpu_torch.data import nvjpeg
from otpose_tpu_torch.data.decoders import choose_decoder
from otpose_tpu_torch.data.loader import Loader
from otpose_tpu_torch.data.pipeline import preprocess_batch, preprocess_crops_batch
from otpose_tpu_torch.data.posetrack import FLIP_PAIRS, JOINTS_WEIGHT
from otpose_tpu_torch.ops.affine import (apply_affine_to_points, fliplr_joints,
                                         get_affine_transform, invert_affine)


_IDENTITY = np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)


class DeviceLoader(Loader):
    """``Loader`` whose batches are dicts of tensors on ``device``:
    inputs (B, H, W, 15), target (B, Hh, Hw, J), target_weight (B, J, 1) and
    margin (B, 4), all f32, with the host metas."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 8888, drop_last: bool = False,
                 prefetch: int = 2, max_frame_hw: Tuple[int, int] = (1088, 1920),
                 mode: str = "crops", device_prefetch: int = 2, device="cuda",
                 process_index: int = 0, process_count: int = 1, accum_steps: int = 1):
        super().__init__(dataset, batch_size, shuffle=shuffle, num_workers=num_workers,
                         seed=seed, drop_last=drop_last, prefetch=prefetch,
                         process_index=process_index, process_count=process_count,
                         accum_steps=accum_steps)
        self.max_h, self.max_w = max_frame_hw
        if mode not in ("crops", "full"):
            raise ValueError(f"DeviceLoader mode must be crops/full, got {mode!r}")
        self.mode = mode
        # > 0: a mover thread runs _to_device, so batch N + k's copy and
        # preprocessing are launched while the model steps on batch N;
        # 0 = move synchronously in the consumer
        self.device_prefetch = device_prefetch
        self.device = torch.device(device)
        # decoder_detail: the decoder with its backend or reason, for a run's log
        if getattr(self.dataset, "reads_jpeg_files", False):
            self.decoder, self.decoder_detail = choose_decoder(self.device, mode)
        else:
            self.decoder = self.decoder_detail = "read_frame"

    # ---------------------------------------------------------------- host

    def _load_raw_sample(self, idx: int, rng: np.random.RandomState):
        """Window select + read + host-side flip/blur + joint warp."""
        ds = self.dataset
        record = copy.deepcopy(ds.data[idx])
        window = ds.select_window(record["image"], record["nframes"])
        files = window["files"]
        if self.decoder == "nvjpeg":
            # the card decodes in _to_device; the host needs only the sizes
            data = nvjpeg.read_bytes(files)
            h, w = nvjpeg.jpeg_size(data[0])
            self._check_size(files[0], h, w)
            frames = None
        elif self.decoder == "native":
            frames, hs, ws, fails = native_io.decode_jpeg_batch(files, self.max_h, self.max_w)
            if fails:
                raise ValueError(
                    f"decode failure in {files} (a corrupt file, or a frame larger than "
                    f"the ({self.max_h}, {self.max_w}) staging buffer: raise DeviceLoader "
                    f"max_frame_hw)")
            h, w = int(hs[0]), int(ws[0])
            if not ds.color_rgb:
                frames = np.ascontiguousarray(frames[..., ::-1])
            if self.mode == "crops":
                frames = np.ascontiguousarray(frames[:, :h, :w])
        else:
            imgs = [ds.read_frame(f) for f in files]
            h, w = imgs[0].shape[:2]
            self._check_size(files[0], h, w)
            if self.mode == "full":
                frames = np.zeros((5, self.max_h, self.max_w, 3), np.uint8)
                for i, im in enumerate(imgs):
                    frames[i, :im.shape[0], :im.shape[1]] = im
            else:   # only the (h, w) region of the staging buffer is ever read
                frames = np.zeros((5, h, w, 3), np.uint8)
                for i, im in enumerate(imgs):
                    part = im[:h, :w]
                    frames[i, :part.shape[0], :part.shape[1]] = part

        aug = ds.sample_augmentation(record, rng)
        joints, joints_vis = aug["joints"], aug["joints_vis"]
        center, scale, r = aug["center"], aug["scale"], aug["rotation"]
        if aug["do_flip"]:
            joints, joints_vis = fliplr_joints(joints, joints_vis, w, FLIP_PAIRS)
            center[0] = w - center[0] - 1
        blur = aug["blur_sigma"] if aug["do_blur"] else None
        trans = get_affine_transform(center, scale, r, ds.image_size)
        if frames is None:
            # nvJPEG: _to_device decodes, flips on the card, and brings a
            # sample that blurs or rotates to the host for _host_pixels
            frames = {"files": files, "data": data, "hw": (h, w), "flip": aug["do_flip"],
                      "blur": blur, "trans": trans, "rotated": r != 0}
            inv = _IDENTITY if r != 0 else invert_affine(trans)
        else:
            frames, inv = self._host_pixels(frames, h, w, aug["do_flip"], blur, trans, r != 0)
        joints_crop = joints[:, :2].copy()
        vis_mask = joints_vis[:, 0] > 0
        joints_crop[vis_mask] = apply_affine_to_points(joints[vis_mask, :2], trans)
        oob = ((joints_crop[:, 0] < 0) | (joints_crop[:, 1] < 0)
               | (joints_crop[:, 0] > ds.image_size[0])
               | (joints_crop[:, 1] > ds.image_size[1]))
        vis = np.where(vis_mask & ~oob, joints_vis[:, 0], 0.0).astype(np.float32)

        meta = {
            "image": record["image"],
            "sup_images": window["files"][1:],
            "center": center, "scale": scale, "rotation": r,
            "score": record.get("score", 1),
            "margin_left": window["margins"][0],
            "margin_right": window["margins"][1],
            "margin_lleft": window["margins"][2],
            "margin_rright": window["margins"][3],
        }
        return {"frames": frames, "inv": inv, "joints": joints_crop.astype(np.float32),
                "vis": vis, "margin": np.asarray(window["margins"], np.float32),
                "meta": meta}

    def _check_size(self, path: str, h: int, w: int) -> None:
        if h > self.max_h or w > self.max_w:
            raise ValueError(
                f"frame {path} is ({h}, {w}) but the staging buffer is "
                f"({self.max_h}, {self.max_w}); raise DeviceLoader max_frame_hw")

    def _host_pixels(self, frames: np.ndarray, h: int, w: int, flip: bool, blur, trans,
                     rotated: bool):
        """A window's host pixel work on its (5, >= h, >= w, 3) uint8 frames:
        flip, blur, then in crops mode the warp to crops (no matrix left for
        the device) and in full mode a rotated sample's warp to the crop at
        the top left (an identity matrix left: the separable device warp
        takes axis-aligned maps only).  Returns (frames, inverse matrix)."""
        if flip:
            frames[:, :h, :w] = frames[:, :h, :w][:, :, ::-1]
        if blur is not None:
            import cv2

            for i in range(5):
                frames[i, :h, :w] = cv2.GaussianBlur(frames[i, :h, :w], (9, 5), blur)
        ds = self.dataset
        ow, oh = int(ds.image_size[0]), int(ds.image_size[1])
        if self.mode == "crops":
            return np.stack([ds.warp_frame(np.ascontiguousarray(frames[i, :h, :w]), trans,
                                           ow, oh) for i in range(5)]), None
        if rotated:
            warped = np.zeros_like(frames)
            for i in range(5):
                warped[i, :oh, :ow] = ds.warp_frame(np.ascontiguousarray(frames[i, :h, :w]),
                                                    trans, ow, oh)
            return warped, _IDENTITY
        return frames, invert_affine(trans)

    # -------------------------------------------------------------- device

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the loader's device (through pinned memory, without
        blocking the host, for a GPU)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _decode_on_device(self, samples) -> torch.Tensor:
        """nvJPEG: the batch's windows decoded on the card into a zeroed
        (B, 5, max_h, max_w, 3) uint8 staging tensor, then each sample's
        flip on the card and its blur or rotation on the host."""
        ds = self.dataset
        b = len(samples)
        staging = torch.zeros((b * 5, self.max_h, self.max_w, 3), dtype=torch.uint8,
                              device=self.device)
        files = [f for s in samples for f in s["frames"]["files"]]
        data = [d for s in samples for d in s["frames"]["data"]]
        nvjpeg.decode_jpeg_batch_device(files, self.max_h, self.max_w, self.device,
                                        out=staging, data=data)
        staging = staging.view(b, 5, self.max_h, self.max_w, 3)
        if not ds.color_rgb:
            staging = staging.flip(-1)
        for i, s in enumerate(samples):
            f = s["frames"]
            h, w = f["hw"]
            if f["flip"]:
                staging[i, :, :h, :w] = staging[i, :, :h, :w].flip(2)
            if f["blur"] is not None or f["rotated"]:
                host = staging[i].cpu().numpy()
                host, _ = self._host_pixels(host, h, w, False, f["blur"], f["trans"],
                                            f["rotated"])
                staging[i] = torch.from_numpy(host).to(self.device)
        return staging

    def _to_device(self, samples):
        ds = self.dataset
        if self.decoder == "nvjpeg":
            frames = self._decode_on_device(samples)
        else:
            frames = self._tensor(np.stack([s["frames"] for s in samples]))
        joints = self._tensor(np.stack([s["joints"] for s in samples]))
        vis = self._tensor(np.stack([s["vis"] for s in samples]))
        sigma = torch.tensor(float(ds.sigma), dtype=torch.float32, device=self.device)
        hm = dict(hm_h=int(ds.heatmap_size[1]), hm_w=int(ds.heatmap_size[0]),
                  num_joints=ds.num_joints)
        if self.mode == "crops":
            out = preprocess_crops_batch(frames, joints, vis, sigma, **hm)
        else:
            inv = self._tensor(np.stack([s["inv"] for s in samples]))
            out = preprocess_batch(frames, inv, joints, vis, sigma,
                                   out_h=int(ds.image_size[1]), out_w=int(ds.image_size[0]),
                                   **hm)
        batch = dict(out)
        if ds.use_different_joints_weight:
            batch["target_weight"] = out["target_weight"] * torch.from_numpy(
                JOINTS_WEIGHT).to(self.device)[None]
        batch["margin"] = self._tensor(np.stack([s["margin"] for s in samples]))
        metas = [s["meta"] for s in samples]
        return batch, metas

    def __iter__(self) -> Iterator:
        batches = self._index_batches()
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_sample(idx):
            rng = np.random.RandomState(
                (self.seed + self.epoch * 1_000_003 + idx) % (2 ** 31))
            return self._load_raw_sample(int(idx), rng)

        def producer():
            # failures go to the consumer; never end without a sentinel
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for batch_idxs in batches:
                        if stop.is_set():
                            break
                        out_q.put(list(pool.map(load_sample, batch_idxs)))
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        threads = [thread]
        final_q = out_q
        # the pipeline's shape is fixed when iteration starts
        device_prefetch = self.device_prefetch
        if device_prefetch > 0:
            # second stage: host samples -> device batches, at most
            # device_prefetch of them in flight
            dev_q: queue.Queue = queue.Queue(maxsize=device_prefetch)

            def mover():
                # the only consumer of out_q: drains it to the producer's
                # sentinel whatever happens (a _to_device failure is passed on
                # and draining goes on), so the producer can always finish and
                # the shutdown below never races this thread for the sentinel
                while True:
                    item = out_q.get()
                    if item is None or isinstance(item, BaseException):
                        dev_q.put(item)
                        if item is None:
                            return
                        continue
                    if stop.is_set():
                        continue
                    try:
                        moved = self._to_device(item)
                    except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                        stop.set()
                        dev_q.put(e)
                        continue
                    dev_q.put(moved)

            mv = threading.Thread(target=mover, daemon=True)
            mv.start()
            threads.append(mv)
            final_q = dev_q
        try:
            while True:
                item = final_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item if device_prefetch > 0 else self._to_device(item)
        finally:
            stop.set()
            # unblock stages parked on a full queue until every thread exits;
            # drain only final_q (the mover alone drains out_q, to its sentinel)
            while any(t.is_alive() for t in threads):
                try:
                    final_q.get(timeout=0.05)
                except queue.Empty:
                    pass
