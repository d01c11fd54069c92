"""Offline person-box generation for PoseTrack detection-mode evaluation
(counterpart of ``tools/generate_boxes.py``).

    python -m otpose_tpu_torch.tools.generate_boxes --json_dir <dir> --img_dir <dir> \\
        [--weights yolov3.weights] --out test_boxes.json [--device cpu]

Writes the boxes json that ``PoseTrackDataset._load_detection_boxes`` reads
(entries ``image_name``, ``bbox``, ``score``, ``category_id``, ``nframes``,
``frame_id``; ref: PoseTrackDataset.py:176-226), from ``YoloV3Detector``
(``detector/yolov3.py``) run on every frame of ``--split``, one frame a
call, on the card unless ``--device cpu`` is given.

Frames come through the port's decoders (``frame_reader``, chosen by
``data/decoders.py::choose_decoder``): nvJPEG into the card's memory on a
CUDA device (it raises when nvJPEG cannot build there), else the native IO
library, else cv2 (RGB); a frame whose ``.jpg`` is absent but whose ``.npy``
is there (``data/synthetic.py``'s tree) is loaded with numpy.  A missing
frame is skipped, as the JAX tool skips an unreadable one; an nvJPEG
failure raises.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import time


def frame_reader(device):
    """(read, name): ``read(path)`` gives the frame at ``path`` as (H, W, 3)
    uint8 RGB (a CUDA tensor from nvJPEG, else a numpy array) or None when
    the file cannot be read; ``name`` is the decoder's, with its backend or
    reason."""
    import numpy as np

    from otpose_tpu_torch.data import native as native_io
    from otpose_tpu_torch.data import nvjpeg
    from otpose_tpu_torch.data.decoders import choose_decoder
    from otpose_tpu_torch.data.nvjpeg import jpeg_size

    decoder, name = choose_decoder(device)
    if decoder == "nvjpeg":

        def decode(path):
            data = nvjpeg.read_bytes([path])
            h, w = jpeg_size(data[0])
            return nvjpeg.decode_jpeg_batch_device([path], h, w, device, data=data).out[0]
    elif decoder == "native":

        def decode(path):
            with open(path, "rb") as fh:
                data = fh.read()
            try:
                h, w = jpeg_size(data)
            except ValueError:
                return None
            out, hs, ws, fails = native_io.decode_jpeg_batch([path], h, w)
            return None if fails else out[0]
    else:
        name = name.replace("read_frame", "cv2", 1)

        def decode(path):
            import cv2

            im = cv2.imread(path)
            return None if im is None else cv2.cvtColor(im, cv2.COLOR_BGR2RGB)

    def read(path):
        if osp.exists(path):
            return decode(path)
        array = osp.splitext(path)[0] + ".npy"
        return np.load(array) if osp.exists(array) else None

    return read, name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json_dir", required=True,
                    help="dir with posetrack_val.json (for the frame list)")
    ap.add_argument("--img_dir", required=True)
    ap.add_argument("--weights", default="", help="darknet yolov3.weights")
    ap.add_argument("--out", required=True)
    ap.add_argument("--conf_thres", type=float, default=0.4)  # reference default (detector_yolov3.py:21)
    ap.add_argument("--nms_thres", type=float, default=0.4)
    ap.add_argument("--split", default="posetrack_val.json")
    ap.add_argument("--variant", default="yolov3", choices=["yolov3", "yolov3-tiny"])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from otpose_tpu_torch.data.coco_json import CocoIndex
    from otpose_tpu_torch.detector import yolov3
    from otpose_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    det = yolov3.YoloV3Detector(args.weights or None, conf_thres=args.conf_thres,
                                nms_thres=args.nms_thres, variant=args.variant, device=device)
    read, decoder = frame_reader(device)
    print(f"generate_boxes: {args.variant} on {device}, frames decoded by {decoder}")
    coco = CocoIndex(osp.join(args.json_dir, args.split))
    out = []
    t0 = time.perf_counter()
    frames = 0
    for i, img_id in enumerate(coco.get_img_ids()):
        im = coco.load_img(img_id)
        path = osp.join(args.img_dir, im["file_name"])
        frame = read(path)
        if frame is None:
            print(f"skip unreadable {path}")
            continue
        frames += 1
        for x, y, w, h, score in det.detect_persons(frame):
            out.append({
                "image_name": im["file_name"],
                "bbox": [x, y, w, h],
                "score": score,
                "category_id": 1,
                # hard-index: a json without these fields would write a
                # boxes file whose nframes=0 silently degenerates every
                # temporal window downstream
                "nframes": im["nframes"],
                "frame_id": im["frame_id"],
            })
        if i % 100 == 0:
            print(f"{i}/{len(coco.imgs)} images, {len(out)} boxes")
    seconds = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(out, f)
    rate = frames / seconds if seconds > 0 else float("nan")
    print(f"wrote {len(out)} boxes to {args.out} ({frames} frames in {seconds:.3f} s, "
          f"{rate:.2f} frames/s on {device})")
    return {"boxes": len(out), "frames": frames, "seconds": seconds, "decoder": decoder}


if __name__ == "__main__":
    main()
