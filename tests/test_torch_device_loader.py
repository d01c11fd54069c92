"""The port's device preprocessing vs the JAX package's, on the CPU.

The same numpy-seeded inputs go through the JAX function and its port:
``generate_heatmaps_device`` (joints out of bounds and invisible among them)
to 1e-6; ``warp_affine_separable`` (under ``jax.jit``, as the JAX package
runs it) to 1e-5 of 255 at the synthetic fixture's geometry and at the
flagship 384x288 crop; ``preprocess_batch`` and
``preprocess_crops_batch`` to 1e-6.  The port's ``DeviceLoader`` is held to
the JAX one in both modes, eval and train (flip, blur, scale and rotation:
the rotated samples pre-warped on the host), batch by batch: inputs to 1e-6
(crops: the same cv2 warp, then the normalisation) or 1e-5 (full: the
products' f32 sums), targets to 1e-6, weights, margins and metas exactly.
The JAX loader is run with its C++ library reported absent, which puts it on
the cv2 path that the port's loader has.  Then the loader's own cases, as
``tests/test_device_loader.py`` has them for JAX, and ``make_loader``'s
choice for each mode and device.
"""

import copy
import threading
import time

import jax
import numpy as np
import pytest
import torch

from otpose_tpu.data import native as jax_native
from otpose_tpu.data.device_loader import DeviceLoader as JaxDeviceLoader
from otpose_tpu.data.pipeline import preprocess_batch as jax_preprocess_batch
from otpose_tpu.data.pipeline import preprocess_crops_batch as jax_preprocess_crops_batch
from otpose_tpu.data.posetrack import PoseTrackDataset as JaxDataset
from otpose_tpu.ops.affine import warp_affine_separable as jax_warp_affine_separable
from otpose_tpu.ops.heatmap import generate_heatmaps_device as jax_generate_heatmaps_device
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.data import make_loader, resolve_device_preprocess
from otpose_tpu_torch.data.device_loader import DeviceLoader
from otpose_tpu_torch.data.loader import Loader
from otpose_tpu_torch.data.pipeline import preprocess_batch, preprocess_crops_batch
from otpose_tpu_torch.data.posetrack import PoseTrackDataset
from otpose_tpu_torch.data.synthetic import ArrayFramesDataset
from otpose_tpu_torch.data.synthetic import make_synthetic_posetrack as make_array_posetrack
from otpose_tpu_torch.ops.affine import get_affine_transform, invert_affine, warp_affine_separable
from otpose_tpu_torch.ops.heatmap import generate_heatmaps_device
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.synthetic_data import make_synthetic_posetrack as make_jpg_posetrack
from tests.helpers.torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
# (crop w, crop h, heatmap w, heatmap h, sigma): the fixtures' and the flagship's
GEOMETRIES = {"synthetic": (72, 96, 18, 24, 2.0), "flagship": (288, 384, 72, 96, 3.0)}


def _np(t):
    return np.asarray(t.float().cpu().numpy() if isinstance(t, torch.Tensor) else t)


def _joints(rng, b, j, w, h):
    """Crop-space joints, some far outside the crop, some invisible."""
    joints = np.stack([rng.uniform(-0.4 * w, 1.4 * w, (b, j)),
                       rng.uniform(-0.4 * h, 1.4 * h, (b, j))], -1).astype(np.float32)
    vis = (rng.rand(b, j) > 0.3).astype(np.float32)
    return joints, vis


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_generate_heatmaps_device_matches_jax(geometry):
    ow, oh, hw, hh, sigma = GEOMETRIES[geometry]
    rng = np.random.RandomState(0)
    joints, vis = _joints(rng, 4, 17, ow, oh)
    stride = np.asarray([ow / hw, oh / hh], np.float32)
    want_t, want_w = jax_generate_heatmaps_device(joints, vis, np.float32(sigma), stride,
                                                  hw, hh, 17)
    got_t, got_w = generate_heatmaps_device(torch.from_numpy(joints), torch.from_numpy(vis),
                                            sigma, torch.from_numpy(stride), hw, hh, 17)
    assert got_t.shape == (4, 17, hh, hw) and got_w.shape == (4, 17, 1)
    np.testing.assert_allclose(_np(got_t), np.asarray(want_t), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(got_w), np.asarray(want_w))
    # the draw reaches every case: in bounds and visible, out of bounds, invisible
    w = np.asarray(want_w)[..., 0]
    assert (w > 0).any() and ((w == 0) & (vis > 0)).any() and (vis == 0).any()


@pytest.mark.parametrize("geometry,frame_hw", [("synthetic", (96, 128)),
                                               ("flagship", (480, 640))])
def test_warp_affine_separable_matches_jax(geometry, frame_hw):
    ow, oh = GEOMETRIES[geometry][:2]
    rng = np.random.RandomState(1)
    b, (h, w) = 3, frame_hw
    images = rng.randint(0, 256, (b, h, w, 3)).astype(np.float32)
    inv = np.stack([invert_affine(get_affine_transform(
        np.asarray([rng.uniform(0, w), rng.uniform(0, h)], np.float32),
        np.asarray([rng.uniform(0.1, 2.0), rng.uniform(0.1, 2.0)], np.float32), 0,
        (ow, oh))) for _ in range(b)]).astype(np.float32)
    # under jit, as the JAX package calls it (XLA fuses a * i + t into one FMA)
    want = np.asarray(jax.jit(jax_warp_affine_separable, static_argnums=(2, 3))(
        images, inv, oh, ow))
    got = warp_affine_separable(torch.from_numpy(images), torch.from_numpy(inv), oh, ow)
    assert got.shape == (b, oh, ow, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * 255)
    assert want.std() > 10   # crops of the image, not of its zero border


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_preprocess_batch_and_crops_batch_match_jax(geometry):
    ow, oh, hw, hh, sigma = GEOMETRIES[geometry]
    rng = np.random.RandomState(2)
    b, (h, w) = 2, (oh + 40, ow + 56)
    frames = rng.randint(0, 256, (b, 5, h, w, 3)).astype(np.uint8)
    inv = np.stack([invert_affine(get_affine_transform(
        np.asarray([w / 2 + 3.3, h / 2 - 1.7], np.float32),
        np.asarray([ow / 200 * 1.1, oh / 200 * 1.1], np.float32), 0, (ow, oh)))
        for _ in range(b)]).astype(np.float32)
    joints, vis = _joints(rng, b, 17, ow, oh)
    crops = rng.randint(0, 256, (b, 5, oh, ow, 3)).astype(np.uint8)
    hm = dict(hm_h=hh, hm_w=hw, num_joints=17)
    t = torch.from_numpy
    for want, got in (
            (jax_preprocess_batch(frames, inv, joints, vis, np.float32(sigma), out_h=oh,
                                  out_w=ow, **hm),
             preprocess_batch(t(frames), t(inv), t(joints), t(vis), sigma, out_h=oh, out_w=ow,
                              **hm)),
            (jax_preprocess_crops_batch(crops, joints, vis, np.float32(sigma), **hm),
             preprocess_crops_batch(t(crops), t(joints), t(vis), sigma, **hm))):
        assert got.keys() == want.keys()
        assert got["inputs"].shape == (b, oh, ow, 15)
        assert got["target"].shape == (b, hh, hw, 17)
        for k in want:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=0, atol=1e-6,
                                       err_msg=k)


# ---------------------------------------------------------------- the loader

def _fill(cfg, dirs, train=False):
    json_dir, img_dir, annot_dir = dirs
    cfg.DATASET.NAME = "PoseTrack"
    cfg.DATASET.JSON_DIR = json_dir
    cfg.DATASET.IMG_DIR = img_dir
    cfg.DATASET.TEST_IMG_DIR = img_dir
    cfg.DATASET.COLOR_RGB = True
    cfg.VAL.ANNOT_DIR = annot_dir
    cfg.VAL.USE_GT_BBOX = True
    cfg.MODEL.IMAGE_SIZE = [72, 96]
    cfg.MODEL.HEATMAP_SIZE = [18, 24]
    cfg.MODEL.SIGMA = 2
    cfg.TRAIN.PROB_HALF_BODY = 0.0
    cfg.LOSS.USE_DIFFERENT_JOINTS_WEIGHT = True
    if train:
        cfg.TRAIN.FLIP = True
        cfg.TRAIN.ROT_FACTOR = 30
        cfg.TRAIN.SCALE_FACTOR = [0.25, 0.25]
    return cfg


@pytest.fixture(scope="module")
def jpg_tree(tmp_path_factory):
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("device_loader")
    return make_jpg_posetrack(str(root), num_videos=2, frames_per_video=4, people_per_frame=2,
                              img_w=128, img_h=96)


@pytest.fixture(scope="module")
def ds(jpg_tree):
    return PoseTrackDataset(_fill(tiny_otpose_cfg(), jpg_tree), "validate")


def _loader_kwargs(mode):
    return dict(shuffle=False, num_workers=2, seed=7, max_frame_hw=(128, 160), mode=mode)


@pytest.mark.parametrize("mode", ["crops", "full"])
@pytest.mark.parametrize("phase", ["validate", "train"])
def test_device_loader_matches_jax(jpg_tree, mode, phase):
    train = phase == "train"
    want_ds = JaxDataset(_fill(jax_tiny_cfg(), jpg_tree, train), phase)
    got_ds = PoseTrackDataset(_fill(tiny_otpose_cfg(), jpg_tree, train), phase)
    want_l = JaxDeviceLoader(want_ds, 4, **_loader_kwargs(mode))
    got_l = DeviceLoader(got_ds, 4, device="cpu", **_loader_kwargs(mode))
    for loader in (want_l, got_l):
        loader.set_epoch(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "is_available", lambda: False)
        want = list(want_l)
    got = list(got_l)
    assert len(got) == len(want) == len(got_l) > 1
    rotated = 0
    for (wb, wm), (gb, gm) in zip(want, got):
        assert gb.keys() == wb.keys() == {"inputs", "target", "target_weight", "margin"}
        assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
                   for v in gb.values())
        tol = 1e-6 if mode == "crops" else 1e-5
        np.testing.assert_allclose(_np(gb["inputs"]), np.asarray(wb["inputs"]), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(_np(gb["target"]), np.asarray(wb["target"]), rtol=0,
                                   atol=1e-6)
        for k in ("target_weight", "margin"):
            np.testing.assert_array_equal(_np(gb[k]), np.asarray(wb[k]), err_msg=k)
        assert len(gm) == len(wm)
        for a, b in zip(gm, wm):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        rotated += sum(m["rotation"] != 0 for m in gm)
    assert (rotated > 0) == train   # the train draw reaches the rotated-sample path


def test_device_loader_crops_equal_the_host_loader_without_cv2(tmp_path):
    """Over the cv2-free fixture (frames as arrays, warped by the dataset's
    own ``warp_frame``) the crops mode's batches equal the host loader's."""
    dirs = make_array_posetrack(str(tmp_path), num_videos=1, frames_per_video=4,
                                people_per_frame=2, img_w=128, img_h=96)
    ds = ArrayFramesDataset(_fill(tiny_otpose_cfg(), dirs), "validate")
    host = list(Loader(ds, 3, shuffle=False, num_workers=2))
    dev = list(DeviceLoader(ds, 3, device="cpu", **_loader_kwargs("crops")))
    assert len(host) == len(dev) > 1
    for (hb, hm), (db, dm) in zip(host, dev):
        for k in hb:
            np.testing.assert_allclose(_np(db[k]), hb[k], rtol=0, atol=1e-6, err_msg=k)
        assert [m["image"] for m in dm] == [m["image"] for m in hm]


def test_device_loader_propagates_producer_errors(ds):
    class BrokenData:
        def __getitem__(self, idx):
            raise OSError("disk gone (synthetic)")

    broken = copy.copy(ds)
    broken.data = BrokenData()
    loader = DeviceLoader(broken, 2, device="cpu", **_loader_kwargs("crops"))
    loader._index_batches = lambda: [np.arange(2), np.arange(2, 4)]
    with pytest.raises(OSError, match="disk gone"):
        for _ in loader:
            pass


def test_device_loader_bgr_when_color_rgb_false(ds):
    """``DATASET.COLOR_RGB`` false gives BGR frames, as on the host path."""
    bgr = copy.copy(ds)
    bgr.color_rgb = False
    (hb, _), (db, _) = (next(iter(Loader(bgr, 2, shuffle=False, num_workers=2, native_host=False))),
                        next(iter(DeviceLoader(bgr, 2, device="cpu",
                                               **_loader_kwargs("crops")))))
    np.testing.assert_allclose(_np(db["inputs"]), hb["inputs"], rtol=0, atol=1e-6)
    rgb = next(iter(DeviceLoader(ds, 2, device="cpu", **_loader_kwargs("crops"))))[0]
    assert not torch.equal(rgb["inputs"], db["inputs"])


def test_device_loader_is_deterministic(ds):
    loader = DeviceLoader(ds, 4, device="cpu", **dict(_loader_kwargs("full"), shuffle=True))
    loader.set_epoch(3)
    first, second = next(iter(loader))[0], next(iter(loader))[0]
    for k in first:
        assert torch.equal(first[k], second[k]), k


def test_device_prefetch_matches_synchronous(ds):
    """device_prefetch > 0 moves ``_to_device`` into a mover thread: every
    batch and meta as the synchronous path's, in order, over an epoch."""
    kw = _loader_kwargs("crops")
    sync = list(DeviceLoader(ds, 3, device="cpu", device_prefetch=0, **kw))
    pipe = list(DeviceLoader(ds, 3, device="cpu", device_prefetch=2, **kw))
    assert len(sync) == len(pipe) > 1
    for (sb, sm), (pb, pm) in zip(sync, pipe):
        assert sb.keys() == pb.keys()
        for k in sb:
            assert torch.equal(sb[k], pb[k]), k
        assert [m["image"] for m in sm] == [m["image"] for m in pm]


def test_device_prefetch_early_break_then_reiterate(ds):
    loader = DeviceLoader(ds, 2, device="cpu", device_prefetch=2, **_loader_kwargs("crops"))
    it = iter(loader)
    first, _ = next(it)
    del it   # the generator's finally shuts the threads down
    full = list(loader)
    assert len(full) == len(loader)
    assert torch.equal(first["inputs"], full[0][0]["inputs"])


def test_device_prefetch_propagates_mover_errors(ds):
    loader = DeviceLoader(ds, 2, device="cpu", device_prefetch=2, **_loader_kwargs("crops"))

    def broken(samples):
        raise RuntimeError("device OOM (synthetic)")

    loader._to_device = broken
    with pytest.raises(RuntimeError, match="device OOM"):
        for _ in loader:
            pass


def test_device_prefetch_abandoned_iterator_shuts_down(ds):
    """Closing a pipelined iterator mid-epoch, after the pipeline has settled
    (producer done, sentinel queued, mover parked), finishes promptly."""
    loader = DeviceLoader(ds, 2, device="cpu", device_prefetch=2, **_loader_kwargs("crops"))

    def run():
        it = iter(loader)
        next(it)
        time.sleep(1.0)
        it.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "pipelined loader shutdown deadlocked"


@pytest.mark.parametrize("mode", ["crops", "full"])
def test_device_loader_refuses_frames_larger_than_its_buffer(ds, mode):
    kw = dict(_loader_kwargs(mode), max_frame_hw=(64, 160))   # the frames are 96 high
    with pytest.raises(ValueError, match="max_frame_hw"):
        next(iter(DeviceLoader(ds, 2, device="cpu", **kw)))
    with pytest.raises(ValueError, match="crops/full"):
        DeviceLoader(ds, 2, device="cpu", **dict(kw, mode="off"))


@pytest.mark.parametrize("setting,device,mode", [
    ("auto", "cpu", "off"), ("auto", "cuda", "crops"), ("auto", "cuda:0", "crops"),
    ("off", "cuda", "off"), ("crops", "cpu", "crops"), ("on", "cpu", "crops"),
    ("full", "cpu", "full"), ("full", "cuda", "full"), ("False", "cuda", "off"),
])
def test_make_loader_picks_the_loader_for_each_mode_and_device(setting, device, mode):
    """As the JAX package resolves ``TPU.DEVICE_PREPROCESS``: ``auto`` is
    ``crops`` on a GPU and ``off`` on the CPU; the device loader gets the
    run's device, the config's buffer and prefetch depth.  Building a loader
    touches no device."""
    cfg = tiny_otpose_cfg()
    cfg.TPU.DEVICE_PREPROCESS = setting
    assert resolve_device_preprocess(cfg, device) == mode
    loader = make_loader(cfg, [], 4, shuffle=False, device=device)
    if mode == "off":
        assert type(loader) is Loader
    else:
        assert isinstance(loader, DeviceLoader) and loader.mode == mode
        assert loader.device == torch.device(device)
        assert (loader.max_h, loader.max_w) == tuple(cfg.TPU.MAX_FRAME_HW)
        assert loader.device_prefetch == cfg.TPU.PREFETCH_DEPTH
    cfg.TPU.DEVICE_PREPROCESS = "sometimes"
    with pytest.raises(ValueError, match="auto/off/crops/full"):
        make_loader(cfg, [], 4, shuffle=False, device=device)
