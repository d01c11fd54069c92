"""Input-pipeline throughput by decode path and thread count (counterpart
of ``tools/bench_input_pipeline.py``).

    python -m otpose_tpu_torch.tools.bench_input_pipeline [--samples 96] [--batch 16]
        [--workers 1,2,4] [--videos 3] [--frames 10] [--device cpu] [--fixture]

Times the port's loaders end to end (the 5-frame window's decode, warp,
normalisation, targets and collation) at flagship geometry: 1280x720 source
jpgs, 384x288 crops, over a PoseTrack-format tree in a temporary directory
(``data/synthetic.py``'s jsons, four people a frame).  The frames are drawn
from a seed and written with cv2 where cv2 is present; with ``--fixture``
or without cv2 they are the five 1280x720 frames of the committed fixture
(``tests/fixtures/jpeg/``), repeated.  Paths, each for the train and the
validate split and each thread count:

- ``native``: the host ``Loader`` with ``native_host`` (cv2's decode, the
  native library's warp and targets), where the library builds;
- ``cv2``: the host ``Loader`` on the cv2 path;
- ``nvjpeg``: ``DeviceLoader`` in ``full`` mode on the card, frames decoded
  by nvJPEG, warp and targets on the card (a CUDA device only);
- ``full+read_frame``: the same loader with the frames decoded by cv2 on the
  host and copied to the card, for comparison (a CUDA device only).

Prints one row a measurement (samples/s, unrounded) and the device's name.
A path the machine cannot run is listed with its reason.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import tempfile
import time

import numpy as np

FIXTURE = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))),
                   "tests", "fixtures", "jpeg")


def _have_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def build_tree(root: str, videos: int, frames: int, use_fixture: bool):
    """A jpg tree at 1280x720; returns (json_dir, img_dir, annot_dir)."""
    from otpose_tpu_torch.data.synthetic import make_synthetic_posetrack

    json_dir, img_dir, annot_dir = make_synthetic_posetrack(
        root, num_videos=videos, frames_per_video=frames, people_per_frame=4,
        img_w=1280, img_h=720)
    arrays = sorted(osp.join(d, f) for d, _, fs in os.walk(img_dir) for f in fs
                    if f.endswith(".npy"))
    if use_fixture:
        sources = [osp.join(FIXTURE, f"frame_{i:03d}.jpg") for i in range(5)]
        for k, path in enumerate(arrays):
            shutil.copyfile(sources[k % len(sources)], path[:-4] + ".jpg")
    else:
        import cv2

        rng = np.random.RandomState(0)
        yy, xx = np.mgrid[:720, :1280]
        for path in arrays:
            # the tree's frame (noise and discs) smoothed, so it compresses as
            # a video frame does
            img = np.load(path).astype(np.float32)
            img = cv2.GaussianBlur(img, (0, 0), 3) + 40 * np.sin(xx / 97.0 + rng.rand())[..., None]
            cv2.imwrite(path[:-4] + ".jpg", np.clip(img, 0, 255).astype(np.uint8)[..., ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, 90])
    for path in arrays:
        os.remove(path)
    return json_dir, img_dir, annot_dir


def make_datasets(dirs):
    from otpose_tpu_torch.data.posetrack import PoseTrackDataset
    from otpose_tpu_torch.utils.testing import flagship_otpose_cfg

    json_dir, img_dir, annot_dir = dirs
    cfg = flagship_otpose_cfg()
    cfg.DATASET.JSON_DIR = json_dir
    cfg.DATASET.IMG_DIR = img_dir
    cfg.DATASET.TEST_IMG_DIR = img_dir
    cfg.DATASET.COLOR_RGB = True
    cfg.TRAIN.PROB_HALF_BODY = 0.0
    cfg.VAL.ANNOT_DIR = annot_dir
    cfg.VAL.USE_GT_BBOX = True
    return {"train": PoseTrackDataset(cfg, "train"),
            "validate": PoseTrackDataset(cfg, "validate")}


def make_loader_for(path: str, ds, batch: int, workers: int, device):
    from otpose_tpu_torch.data import native as native_io
    from otpose_tpu_torch.data import nvjpeg
    from otpose_tpu_torch.data.device_loader import DeviceLoader
    from otpose_tpu_torch.data.loader import Loader

    kw = dict(shuffle=True, num_workers=workers, drop_last=True, prefetch=4)
    if path in ("native", "cv2"):
        if path == "native" and not native_io.is_available():
            return None, "native library unavailable: " + native_io.reason().splitlines()[0]
        if not _have_cv2():
            return None, "no cv2 (the host loader decodes with cv2)"
        return Loader(ds, batch, native_host=path == "native", **kw), None
    if device.type != "cuda":
        return None, "needs a CUDA device"
    if not nvjpeg.is_available():
        # full mode on a CUDA device decodes with nvJPEG, or raises
        return None, f"nvJPEG unavailable: {nvjpeg.reason()}"
    loader = DeviceLoader(ds, batch, mode="full", device=device, **kw)
    if path == "full+read_frame":
        if not _have_cv2():
            return None, "no cv2"
        loader.decoder = loader.decoder_detail = "read_frame"
    if path == "nvjpeg" and loader.decoder != "nvjpeg":
        return None, f"the loader chose {loader.decoder}"
    return loader, None


def measure(loader, n_samples: int, device) -> float:
    """Samples/s over at least ``n_samples`` after one warm-up batch."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    it = iter(loader)
    next(it)
    sync()
    done, epoch = 0, 0
    t0 = time.perf_counter()
    while done < n_samples:
        for _ in it:
            done += loader.batch_size
            if done >= n_samples:
                break
        else:
            epoch += 1
            loader.set_epoch(epoch)
            it = iter(loader)
    sync()
    dt = time.perf_counter() - t0
    if hasattr(it, "close"):
        it.close()
    return done / dt


PATHS = ("native", "cv2", "nvjpeg", "full+read_frame")


def run(samples: int = 96, batch: int = 16, workers=(1, 2, 4), videos: int = 3,
        frames: int = 10, device="cuda", use_fixture: bool = False, log=print) -> list:
    """The table as a list of dicts (split, path, workers, samples/s or the
    reason a path was skipped)."""
    import torch

    from otpose_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "no GPU"
    use_fixture = use_fixture or not _have_cv2()
    root = tempfile.mkdtemp(prefix="otpose_iobench_")
    rows = []
    try:
        datasets = make_datasets(build_tree(root, videos, frames, use_fixture))
        log(f"bench_input_pipeline: host cores {os.cpu_count()}, device {device} ({card}); "
            f"{len(datasets['train'])} train / {len(datasets['validate'])} val samples, "
            f"batch {batch}, frames {'from the fixture' if use_fixture else 'written by cv2'}")
        log(f"{'split':9s} {'path':16s} {'workers':>7s} {'samples/s':>12s}")
        for split, ds in datasets.items():
            for path in PATHS:
                for w in workers:
                    loader, why = make_loader_for(path, ds, batch, w, device)
                    if loader is None:
                        rows.append({"split": split, "path": path, "workers": w,
                                     "skipped": why})
                        log(f"{split:9s} {path:16s} {w:7d} {'-':>12s}  ({why})")
                        break
                    sps = measure(loader, samples, device)
                    rows.append({"split": split, "path": path, "workers": w,
                                 "samples_per_s": sps, "decoder": getattr(loader, "decoder", "")})
                    log(f"{split:9s} {path:16s} {w:7d} {sps:12.4f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=96)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--workers", type=str, default="1,2,4")
    ap.add_argument("--videos", type=int, default=3)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--fixture", action="store_true",
                    help="use the committed fixture's frames instead of writing them")
    args = ap.parse_args(argv)
    run(args.samples, args.batch, tuple(int(w) for w in args.workers.split(",")),
        args.videos, args.frames, args.device, args.fixture)


if __name__ == "__main__":
    main()
