"""The port's PoseTrack dataset, loader and host geometry vs the JAX package's.

Both read one synthetic tree (tests/helpers/synthetic_data.py) in PT17 and
PT18 naming, with every frame labeled and with every second one, through GT
boxes and through a detection-box file.  Everything here is host code in
numpy and cv2, so the port's output must equal the JAX package's exactly:
records, temporal windows, eval samples (inputs, target, target_weight,
margin, meta), a train sample drawn from the same ``RandomState``, the
loader's batches, and the geometry helpers on random inputs.  The port's own
cv2-free fixture (``data/synthetic.py``) is held to the same dataset code.
"""

import json
import os.path as osp

import numpy as np
import pytest

from otpose_tpu.data.loader import Loader as JaxLoader
from otpose_tpu.data.posetrack import PoseTrackDataset as JaxDataset
from otpose_tpu.ops import affine as jax_affine
from otpose_tpu.ops import bbox as jax_bbox
from otpose_tpu.ops import heatmap as jax_heatmap
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.data import make_loader
from otpose_tpu_torch.data.loader import Loader
from otpose_tpu_torch.data.posetrack import PoseTrackDataset
from otpose_tpu_torch.data.synthetic import ArrayFramesDataset, make_synthetic_posetrack
from otpose_tpu_torch.ops import affine, bbox, heatmap
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.synthetic_data import make_synthetic_posetrack as make_jpg_posetrack
from tests.helpers.torch_port import one_torch_thread  # noqa: F401  (fixture)

pytest.importorskip("cv2")
pytestmark = pytest.mark.usefixtures("one_torch_thread")
CASES = {"pt17": (False, 1), "pt18": (True, 1), "pt17_every2": (False, 2),
         "pt18_every2": (True, 2)}


def _fill(cfg, dirs, is_2018, bbox_file=""):
    json_dir, img_dir, annot_dir = dirs
    cfg.DATASET.NAME = "PoseTrack"
    cfg.DATASET.IS_2018 = is_2018
    cfg.DATASET.JSON_DIR = json_dir
    cfg.DATASET.IMG_DIR = img_dir
    cfg.DATASET.TEST_IMG_DIR = img_dir
    cfg.DATASET.COLOR_RGB = True
    for sub in (cfg.VAL, cfg.TEST):
        sub.ANNOT_DIR = annot_dir
        sub.USE_GT_BBOX = not bbox_file
        sub.COCO_BBOX_FILE = bbox_file
        sub.IMAGE_THRE = 0.1
    cfg.LOSS.USE_DIFFERENT_JOINTS_WEIGHT = True
    return cfg


@pytest.fixture(scope="module", params=sorted(CASES))
def tree(request, tmp_path_factory):
    is_2018, every = CASES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    dirs = make_jpg_posetrack(str(root), num_videos=2, frames_per_video=5, people_per_frame=2,
                              img_w=128, img_h=96, is_2018=is_2018, labeled_every=every)
    return root, dirs, is_2018


def _pair(tree, phase, bbox_file=""):
    _, dirs, is_2018 = tree
    want = JaxDataset(_fill(jax_tiny_cfg(), dirs, is_2018, bbox_file), phase)
    got = PoseTrackDataset(_fill(tiny_otpose_cfg(), dirs, is_2018, bbox_file), phase)
    return want, got


def _assert_same(a, b, what=""):
    """Equal, recursively, with arrays compared exactly."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (what, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.fixture(scope="module")
def detection_file(tree):
    root, dirs, _ = tree
    val = json.load(open(osp.join(dirs[0], "posetrack_val.json")))
    rng = np.random.RandomState(7)
    by_img = {}
    for a in val["annotations"]:
        by_img.setdefault(a["image_id"], []).append(a)
    boxes = []
    for im in val["images"]:
        common = {"image_name": im["file_name"], "nframes": im["nframes"],
                  "frame_id": im["frame_id"]}
        for a in by_img.get(im["id"], []):
            x, y, w, h = (float(v) for v in a["bbox"])
            j = rng.uniform(-2.0, 2.0, size=4)
            boxes.append(dict(common, bbox=[x + j[0], y + j[1], max(w + j[2], 8.0),
                                            max(h + j[3], 8.0)],
                              score=float(rng.uniform(0.5, 0.99)), category_id=1))
        boxes.append(dict(common, bbox=[1, 1, 10, 10], score=0.01, category_id=1))
        boxes.append(dict(common, bbox=[2, 2, 12, 12], score=0.9, category_id=3))
    path = str(root / "det_boxes.json")
    json.dump(boxes, open(path, "w"))
    return path


@pytest.mark.parametrize("phase", ["train", "validate", "test"])
def test_gt_records_and_windows_are_equal(tree, phase):
    want, got = _pair(tree, phase)
    assert len(got) == len(want) > 0
    _assert_same(want.data, got.data, "data")
    for rec in want.data:
        _assert_same(want.select_window(rec["image"], rec["nframes"]),
                     got.select_window(rec["image"], rec["nframes"]), rec["image"])


def test_detection_records_are_equal(tree, detection_file):
    want, got = _pair(tree, "test", detection_file)
    assert len(got) == len(want) > 0
    _assert_same(want.data, got.data, "data")
    _assert_same(want.get_sample_host(1), got.get_sample_host(1), "sample")


def test_eval_samples_are_equal(tree):
    want, got = _pair(tree, "validate")
    margins = set()
    for i in range(len(want)):
        a, b = want.get_sample_host(i), got.get_sample_host(i)
        _assert_same(a, b, f"sample {i}")
        margins.add(tuple(b["margin"].tolist()))
    assert b["inputs"].shape == (64, 64, 15) and b["target"].shape == (16, 16, 17)
    assert len(margins) > 1          # clip ends and middles both occur


def test_train_sample_with_a_fixed_random_state_is_equal(tree):
    """Flip, blur, half-body, scale and rotation all draw from the stream."""
    _, dirs, is_2018 = tree
    cfgs = [_fill(c, dirs, is_2018) for c in (jax_tiny_cfg(), tiny_otpose_cfg())]
    for cfg in cfgs:
        cfg.TRAIN.PROB_HALF_BODY = 0.5
        cfg.TRAIN.NUM_JOINTS_HALF_BODY = 3
        cfg.TRAIN.FLIP = True
    want, got = JaxDataset(cfgs[0], "train"), PoseTrackDataset(cfgs[1], "train")
    seen = set()
    for seed in range(6):
        a = want.get_sample_host(seed % len(want), rng=np.random.RandomState(seed))
        b = got.get_sample_host(seed % len(got), rng=np.random.RandomState(seed))
        _assert_same(a, b, f"seed {seed}")
        _assert_same(want.sample_augmentation(want.data[0], np.random.RandomState(seed)),
                     got.sample_augmentation(got.data[0], np.random.RandomState(seed)))
        seen.add(b["meta"]["rotation"] != 0.0)
    assert seen == {True, False}


def test_loader_batches_are_equal(tree):
    want_ds, got_ds = _pair(tree, "validate")
    want = list(JaxLoader(want_ds, 3, num_workers=2, native_host=False))
    got_loader = Loader(got_ds, 3, num_workers=2)
    got = list(got_loader)
    assert len(got) == len(want) == len(got_loader)
    for (wb, wm), (gb, gm) in zip(want, got):
        _assert_same(wb, gb, "batch")
        _assert_same(wm, gm, "metas")
    shuffled = Loader(got_ds, 3, num_workers=2, shuffle=True, drop_last=True, seed=5)
    want_shuffled = JaxLoader(want_ds, 3, num_workers=2, shuffle=True, drop_last=True, seed=5,
                              native_host=False)
    assert [m["image"] for _, ms in shuffled for m in ms] == \
           [m["image"] for _, ms in want_shuffled for m in ms]
    assert len(shuffled) == len(got_ds) // 3


def test_loader_forwards_a_failed_sample(tree):
    _, got_ds = _pair(tree, "validate")
    got_ds.data[2]["image"] = got_ds.data[2]["image"].replace("0000", "0099")
    with pytest.raises(ValueError, match="Fail to read"):
        list(Loader(got_ds, 2, num_workers=2))


def test_make_loader_takes_the_host_path_only(tree):
    _, got_ds = _pair(tree, "validate")
    cfg = got_ds.cfg
    cfg.TPU.DEVICE_PREPROCESS = "off"
    loader = make_loader(cfg, got_ds, 4, shuffle=False, device="cuda")
    assert isinstance(loader, Loader) and loader.num_workers == cfg.WORKERS
    cfg.TPU.DEVICE_PREPROCESS = "auto"
    assert isinstance(make_loader(cfg, got_ds, 4, shuffle=False, device="cpu"), Loader)
    for mode, device in (("auto", "cuda"), ("crops", "cpu"), ("full", "cpu"), ("on", "cuda")):
        cfg.TPU.DEVICE_PREPROCESS = mode
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            make_loader(cfg, got_ds, 4, shuffle=False, device=device)
    cfg.TPU.DEVICE_PREPROCESS = "sometimes"
    with pytest.raises(ValueError, match="DEVICE_PREPROCESS"):
        make_loader(cfg, got_ds, 4, shuffle=False, device="cpu")


def test_host_geometry_equals_the_jax_package():
    rng = np.random.RandomState(3)
    for _ in range(20):
        joints = rng.uniform(-5, 70, (17, 3))
        vis = (rng.rand(17, 1) > 0.3).astype(np.float64).repeat(3, 1)
        _assert_same(jax_affine.fliplr_joints(joints, vis, 64, [[3, 4], [5, 6], [15, 16]]),
                     affine.fliplr_joints(joints, vis, 64, [[3, 4], [5, 6], [15, 16]]))
        kw = dict(use_different_joints_weight=True, joints_weight=rng.rand(17, 1))
        _assert_same(jax_heatmap.generate_heatmaps(joints, vis, 2, [64, 64], [16, 16], 17, **kw),
                     heatmap.generate_heatmaps(joints, vis, 2, [64, 64], [16, 16], 17, **kw))
        seed = int(rng.randint(1 << 30))
        _assert_same(
            jax_bbox.half_body_center_scale(joints, vis, 17, tuple(range(11)), 0.75,
                                            rng=np.random.RandomState(seed)),
            bbox.half_body_center_scale(joints, vis, 17, tuple(range(11)), 0.75,
                                        rng=np.random.RandomState(seed)))


@pytest.mark.parametrize("is_2018", [False, True], ids=["pt17", "pt18"])
def test_array_frames_fixture_runs_the_same_dataset_code(tmp_path, is_2018):
    """The port's cv2-free tree: frames as arrays, crops by the torch warp
    (within one uint8 step of cv2's fixed-point warp), everything else the
    dataset's own code."""
    import cv2

    dirs = make_synthetic_posetrack(str(tmp_path), num_videos=2, frames_per_video=4,
                                    people_per_frame=2, is_2018=is_2018, seed=3)
    cfg = _fill(tiny_otpose_cfg(), dirs, is_2018)
    ds = ArrayFramesDataset(cfg, "validate")
    assert len(ds) == 16
    # the same frames as jpg-free arrays written where cv2 can read them
    for rec in ds.data:
        cv2.imwrite(rec["image"].replace(".jpg", ".png"),
                    ds.read_frame(rec["image"])[:, :, ::-1])

    class PngDataset(PoseTrackDataset):
        def frame_exists(self, path):
            return osp.exists(path.replace(".jpg", ".png"))

        def read_frame(self, path):
            return super().read_frame(path.replace(".jpg", ".png"))

    ref = PngDataset(cfg, "validate")
    for i in (0, 5, 15):
        a, b = ref.get_sample_host(i), ds.get_sample_host(i)
        step = 1.0 / 255 / 0.224
        assert np.abs(a["inputs"] - b["inputs"]).max() <= 1.01 * step
        for k in ("target", "target_weight", "margin"):
            np.testing.assert_array_equal(a[k], b[k])
        _assert_same(a["meta"], b["meta"])
    assert len({tuple(ds.get_sample_host(i)["margin"]) for i in range(16)}) > 1
