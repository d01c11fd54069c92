"""``otpose_tpu_torch/detector/yolov3.py`` and ``tools/generate_boxes.py``
against the JAX package's detector and tool, on the CPU.

Inputs are made from a seed with numpy and given to both packages.  The
forward is compared at He-scaled weights with BN's statistics calibrated on
a batch (the JAX package's own 0.01-std init vanishes through 75 convs, so
every head gives its bias and a comparison there proves nothing): full
``yolov3`` at 96 px and ``yolov3-tiny`` at 416, each to 1e-4 of the
output's peak (both f32; the convolutions' sums run in other orders).
The darknet reader round-trips the file and refuses a short or long one;
``_decode_head`` matches at zero and at random features (1e-5 of the peak);
NMS is the same numpy code (exact on crafted inputs and on the forward's
outputs); ``preprocess_image`` is within one uint8 step of the JAX
package's cv2 preprocessing on each of cv2's INTER_AREA routes, with the
share of pixels that differ bounded; ``generate_boxes`` writes the JAX
tool's json with the same stub detector, and the detection-mode dataset
reads it.
"""

import json
import os.path as osp
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.detector import yolov3 as J
from otpose_tpu_torch.data.posetrack import PoseTrackDataset
from otpose_tpu_torch.detector import yolov3 as P

from tests.helpers.synthetic_data import make_synthetic_posetrack
from tests.helpers.torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
FIXTURE = osp.join(osp.dirname(osp.abspath(__file__)), "fixtures", "jpeg")
VARIANTS = ("yolov3", "yolov3-tiny")


@pytest.mark.parametrize("variant", VARIANTS)
def test_programs_specs_and_anchors_equal_the_jax_package_s(variant):
    def plain(program):
        return [tuple(vars(x) if hasattr(x, "out_ch") else x for x in op) for op in program]

    assert plain(P._program(variant)) == plain(J._program(variant))
    assert [(c, vars(s)) for c, s in P._conv_specs_in_order(variant)] == \
           [(c, vars(s)) for c, s in J._conv_specs_in_order(variant)]
    assert P._VARIANT_ANCHORS[variant] == J._VARIANT_ANCHORS[variant]
    with pytest.raises(ValueError, match="unknown YOLO variant"):
        P._program("yolov4")


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_random_weights_equal_the_jax_package_s(variant):
    got, want = P.init_random_weights(3, variant), J.init_random_weights(3, variant)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("variant", VARIANTS)
def test_darknet_file_round_trips_through_both_readers(tmp_path, variant):
    weights = P.init_he_weights(1, variant)
    path = str(tmp_path / f"{variant}.weights")
    P.save_darknet_weights(path, weights, variant)
    for reader in (P.load_darknet_weights, J.load_darknet_weights):
        loaded = reader(path, variant)
        assert len(loaded) == len(weights)
        for a, b in zip(loaded, weights):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("cut", ["truncated", "padded", "other_variant"])
def test_darknet_reader_refuses_a_file_of_the_wrong_size(tmp_path, cut):
    path = str(tmp_path / "w.weights")
    P.save_darknet_weights(path, P.init_random_weights(0, "yolov3-tiny"), "yolov3-tiny")
    blob = open(path, "rb").read()
    if cut == "truncated":
        open(path, "wb").write(blob[:-8])
    elif cut == "padded":
        open(path, "wb").write(blob + b"\x00" * 16)
    variant = "yolov3" if cut == "other_variant" else "yolov3-tiny"
    with pytest.raises(ValueError, match="weight file mismatch"):
        P.load_darknet_weights(path, variant)


@pytest.mark.parametrize("variant", VARIANTS)
def test_params_cross_into_the_module_as_oihw(variant):
    weights = P.init_he_weights(2, variant)
    model = P.build_yolo(weights, variant, "cpu")
    i = 4 if variant == "yolov3" else 3
    np.testing.assert_array_equal(model.convs[i].weight.detach().numpy(),
                                  weights[i]["weight"].transpose(3, 2, 0, 1))
    back = model.darknet_params()
    for a, b in zip(back, weights):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    bad = [dict(p) for p in weights]
    bad[0]["weight"] = bad[0]["weight"][..., :-1]
    with pytest.raises(ValueError, match="kernel"):
        P.yolo_params_from_jax(bad, variant)


@pytest.mark.parametrize("head_idx,img_size", [(0, 64), (1, 64), (2, 416)])
def test_decode_head_matches_jax(head_idx, img_size):
    g = img_size // (32 // 2 ** head_idx)
    zeros = np.zeros((1, g, g, 255), np.float32)
    got = P._decode_head(torch.from_numpy(zeros), head_idx, img_size).numpy()
    want = np.asarray(J._decode_head(jnp.asarray(zeros), head_idx, img_size))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    stride = img_size // g
    for a, (aw, ah) in enumerate(P.ANCHORS[head_idx]):
        np.testing.assert_allclose(got[0, a, :5], [0.5 * stride, 0.5 * stride, aw, ah, 0.5],
                                   rtol=1e-6)
    feat = np.random.RandomState(head_idx).randn(2, g, g, 255).astype(np.float32)
    got = P._decode_head(torch.from_numpy(feat), head_idx, img_size).numpy()
    want = np.asarray(J._decode_head(jnp.asarray(feat), head_idx, img_size))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _calibrated(variant, size, seed=0, **kw):
    """He-scaled weights with BN statistics calibrated on a batch of 2."""
    model = P.build_yolo(P.init_he_weights(seed, variant, **kw), variant, "cpu")
    x = np.random.RandomState(seed + 10).rand(2, 3, size, size).astype(np.float32)
    model.calibrate_bn_(torch.from_numpy(x))
    return model


@pytest.mark.parametrize("variant,size", [("yolov3", 96), ("yolov3-tiny", 416)])
def test_forward_matches_jax(variant, size):
    model = _calibrated(variant, size)
    x = np.random.RandomState(5).rand(1, size, size, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    want = np.asarray(J.yolo_forward(model.darknet_params(), jnp.asarray(x), img_size=size,
                                     variant=variant))
    cells = sum((size // s) ** 2 for s in ((32, 16, 8) if variant == "yolov3" else (32, 16)))
    assert got.shape == want.shape == (1, cells * 3, 85)
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * peak
    assert np.abs(got[..., 4:] - want[..., 4:]).max() <= 1e-4
    # not degenerate: the objectness varies from cell to cell
    assert want[..., 4].std() > 0.05
    # NMS on the forward's outputs: the same numpy code, the same kept rows
    np.testing.assert_array_equal(P.non_max_suppression(want[0], 0.55, 0.4),
                                  J.non_max_suppression(want[0], 0.55, 0.4))


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_at_the_jax_init_gives_finite_probabilities(variant):
    model = P.build_yolo(P.init_random_weights(0, variant), variant, "cpu")
    with torch.no_grad():
        out = model(torch.zeros(1, 3, 64, 64)).numpy()
    assert np.isfinite(out).all() and ((out[..., 4] >= 0) & (out[..., 4] <= 1)).all()


def test_tiny_stride1_maxpool_keeps_size():
    model = P.build_yolo(P.init_he_weights(0, "yolov3-tiny"), "yolov3-tiny", "cpu")
    sizes = []
    handle = model.convs[6].register_forward_hook(lambda m, i, o: sizes.append(i[0].shape))
    with torch.no_grad():
        model(torch.zeros(1, 3, 416, 416))
    handle.remove()
    # the conv after the stride-1 pool sees the 13x13 grid of the one before
    assert sizes[0][-2:] == (13, 13)


def test_nms_crafted_matches_jax():
    def det(cx, cy, w, h, obj, cls_idx, cls_score):
        d = np.zeros(85, np.float32)
        d[:4] = [cx, cy, w, h]
        d[4] = obj
        d[5 + cls_idx] = cls_score
        return d

    dets = np.stack([det(100, 100, 40, 40, 0.9, 0, 0.9), det(102, 101, 40, 40, 0.85, 0, 0.9),
                     det(200, 200, 30, 30, 0.9, 16, 0.8), det(50, 50, 20, 20, 0.2, 0, 0.9),
                     det(101, 99, 42, 38, 0.88, 3, 0.95)])
    got = P.non_max_suppression(dets, conf_thres=0.8, nms_thres=0.4)
    np.testing.assert_array_equal(got, J.non_max_suppression(dets, conf_thres=0.8,
                                                             nms_thres=0.4))
    assert sorted(got[:, 6].astype(int)) == [0, 3, 16]
    assert got[got[:, 6] == 0][0, 0] == pytest.approx((0.9 * 80 + 0.85 * 82) / 1.75)
    assert P.non_max_suppression(dets, conf_thres=0.99).shape == (0, 7)


# the four INTER_AREA routes: non-integer downscales (1280x720 and
# 1920x1080 frames), an exact integer factor (3x: 1248 -> 416; 2x has its
# own rounding), an upscale (128 -> 416)
ROUTES = {"1280x720": (720, 1280), "1920x1080": (1080, 1920), "int3x": (700, 1248),
          "int2x": (832, 500), "upscale": (96, 128)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_preprocess_within_one_step_of_cv2(route):
    pytest.importorskip("cv2")
    h, w = ROUTES[route]
    rng = np.random.RandomState(len(route))
    smooth = np.clip(np.cumsum(rng.randint(-3, 4, (h, w, 3)), axis=1) % 256, 0, 255)
    for img in (smooth.astype(np.uint8), rng.randint(0, 256, (h, w, 3)).astype(np.uint8)):
        got, (pad, side) = P.preprocess_image(img, 416)
        want, (jpad, jside) = J.preprocess_image(img, 416)
        assert pad == jpad and side == jside and got.shape == (416, 416, 3)
        d = np.abs(np.round(got.numpy() * 255) - np.round(want * 255))
        assert d.max() <= 1
        if route not in ("1280x720", "1920x1080"):
            np.testing.assert_array_equal(got.numpy(), want)
        # exact routes are exact; the area weights' sums round the other way
        # only within f32 rounding of a half
        assert (d > 0).mean() <= (0.0 if route != "1280x720" and route != "1920x1080"
                                  else 1e-3)


def test_resize_area_refuses_mixed_scales():
    with pytest.raises(ValueError, match="downscale on one axis"):
        P.resize_area(torch.zeros(100, 500, 3, dtype=torch.uint8), 416, 416)


def test_detector_on_a_fixture_frame_matches_the_jax_pipeline():
    """``YoloV3Detector.detect_persons`` against the JAX package's forward,
    NMS and rescaling on the port's preprocessed frame (the two
    preprocessings differ by a uint8 step in a few pixels)."""
    ref = np.load(osp.join(FIXTURE, "decoded.npz"))
    frame = ref["frame_003"]
    model = P.build_yolo(P.init_he_weights(0, "yolov3-tiny", obj_bias=-1.0, person_bias=1.0),
                         "yolov3-tiny", "cpu")
    x = torch.stack([P.preprocess_image(ref[f"frame_00{i}"])[0] for i in range(2)])
    model.calibrate_bn_(x.permute(0, 3, 1, 2).contiguous())
    weights = model.darknet_params()
    det = P.YoloV3Detector(weights=weights, variant="yolov3-tiny", device="cpu")
    got = det.detect_persons(frame)
    tensor, (pad, side) = P.preprocess_image(frame)
    dets = np.asarray(J.yolo_forward(weights, jnp.asarray(tensor.numpy()[None]), 416,
                                     "yolov3-tiny"))[0]
    kept = J.non_max_suppression(dets, 0.4, 0.4)
    scale = side / 416
    want = [[x1 * scale - pad[1][0], y1 * scale - pad[0][0], (x2 - x1) * scale,
             (y2 - y1) * scale, obj * cls_s]
            for x1, y1, x2, y2, obj, cls_s, cls_i in kept if int(cls_i) == 0]
    assert 3 <= len(got) == len(want)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-2)


def _cfg(cfg, json_dir, img_dir, annot_dir):
    cfg.MODEL.NUM_JOINTS = 17
    cfg.MODEL.IMAGE_SIZE = [72, 96]
    cfg.MODEL.HEATMAP_SIZE = [18, 24]
    cfg.MODEL.SIGMA = 2
    cfg.DATASET.JSON_DIR = json_dir
    cfg.DATASET.IMG_DIR = img_dir
    cfg.DATASET.TEST_IMG_DIR = img_dir
    cfg.DATASET.COLOR_RGB = True
    cfg.DATASET.NAME = "PoseTrack"
    cfg.VAL.ANNOT_DIR = annot_dir
    cfg.VAL.USE_GT_BBOX = True
    cfg.TRAIN.PROB_HALF_BODY = 0.0
    return cfg


def test_generate_boxes_writes_the_jax_tool_s_json(tmp_path, monkeypatch):
    """Both tools with the same stub detector (each frame's GT boxes) give
    the same json; the port's detection-mode dataset reads it, and perfect
    keypoints on its boxes score AP 100."""
    cv2 = pytest.importorskip("cv2")
    import otpose_tpu.detector.yolov3 as jax_ymod
    import tools.generate_boxes as jax_gb
    from otpose_tpu.config import get_cfg as jax_get_cfg
    from otpose_tpu_torch.config import get_cfg
    from otpose_tpu_torch.tools import generate_boxes as gb

    dirs = make_synthetic_posetrack(str(tmp_path), num_videos=1, frames_per_video=4,
                                    people_per_frame=2)
    json_dir, img_dir, annot_dir = dirs
    gt = PoseTrackDataset(_cfg(get_cfg(), *dirs), "validate")
    by_image = {}
    for rec in gt.data:
        by_image.setdefault(rec["image"], []).append(rec)

    class StubDetector:
        def __init__(self, *a, **k):
            self.seen = []

        def detect_persons(self, img_rgb):
            recs = by_image.get(self.path, [])
            self.seen.append(np.asarray(img_rgb).shape)
            return [list(map(float, r["box"])) + [0.97] for r in recs]

    stub = StubDetector()
    monkeypatch.setattr(jax_ymod, "YoloV3Detector", lambda *a, **k: stub)
    monkeypatch.setattr(P, "YoloV3Detector", lambda *a, **k: stub)

    real_imread = cv2.imread

    def imread(path, *a):
        stub.path = path
        return real_imread(path, *a)

    monkeypatch.setattr(cv2, "imread", imread)
    want_json = str(tmp_path / "jax_boxes.json")
    monkeypatch.setattr(sys, "argv", ["generate_boxes.py", "--json_dir", json_dir,
                                      "--img_dir", img_dir, "--out", want_json])
    jax_gb.main()

    read, name = gb.frame_reader("cpu")
    assert name == "native"

    def reader(device):
        def tracked(path):
            stub.path = path
            return read(path)
        return tracked, name

    monkeypatch.setattr(gb, "frame_reader", reader)
    got_json = str(tmp_path / "torch_boxes.json")
    result = gb.main(["--json_dir", json_dir, "--img_dir", img_dir, "--out", got_json,
                      "--device", "cpu"])
    assert result["frames"] == 4 and result["decoder"] == "native"
    got, want = json.load(open(got_json)), json.load(open(want_json))
    assert got == want and len(got) == 8
    assert stub.seen[:4] == stub.seen[4:] == [(96, 128, 3)] * 4

    cfg = _cfg(get_cfg(), *dirs)
    cfg.TEST.USE_GT_BBOX = False
    cfg.TEST.COCO_BBOX_FILE = got_json
    cfg.TEST.ANNOT_DIR = annot_dir
    cfg.TEST.IMAGE_THRE = 0.1
    ds = PoseTrackDataset(cfg, "test")
    jcfg = _cfg(jax_get_cfg(), *dirs)
    jcfg.TEST.USE_GT_BBOX = False
    jcfg.TEST.COCO_BBOX_FILE = got_json
    jcfg.TEST.ANNOT_DIR = annot_dir
    jcfg.TEST.IMAGE_THRE = 0.1
    from otpose_tpu.data.posetrack import PoseTrackDataset as JaxDataset

    jds = JaxDataset(jcfg, "test")
    assert len(ds) == len(jds) == len(got)
    for a, b in zip(ds.data, jds.data):
        for k in ("image", "score", "nframes", "frame_id"):
            assert a[k] == b[k]
        np.testing.assert_array_equal(a["center"], b["center"])
        np.testing.assert_array_equal(a["scale"], b["scale"])
    n = len(ds)
    preds, boxes, filenames_map = np.zeros((n, 17, 3)), np.zeros((n, 6)), {}
    for i, det in enumerate(ds.data):
        cands = by_image[det["image"]]
        src = cands[int(np.argmin([np.linalg.norm(det["center"] - c["center"])
                                   for c in cands]))]
        preds[i, :, :2] = src["joints_3d"][:, :2]
        preds[i, :, 2] = 0.95
        boxes[i, :2], boxes[i, 2:4] = det["center"], det["scale"]
        boxes[i, 4], boxes[i, 5] = np.prod(det["scale"] * 200), det["score"]
        filenames_map.setdefault(det["image"], []).append(i)
    _, mean_ap = ds.evaluate(cfg, preds, str(tmp_path / "out"), boxes, filenames_map)
    assert mean_ap == pytest.approx(100.0)


def test_generate_boxes_frame_reader_paths(tmp_path):
    """The native decode gives libjpeg's frame; a frame with only its
    ``.npy`` is loaded; a missing one is None; the default device is the
    card."""
    from otpose_tpu_torch.tools import generate_boxes as gb

    read, name = gb.frame_reader("cpu")
    ref = np.load(osp.join(FIXTURE, "decoded.npz"))
    np.testing.assert_array_equal(read(osp.join(FIXTURE, "odd_444.jpg")), ref["odd_444"])
    np.save(tmp_path / "00000001.npy", ref["grey"])
    np.testing.assert_array_equal(read(str(tmp_path / "00000001.jpg")), ref["grey"])
    assert read(str(tmp_path / "00000002.jpg")) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            gb.main(["--json_dir", str(tmp_path), "--img_dir", str(tmp_path),
                     "--out", str(tmp_path / "b.json")])
        with pytest.raises(RuntimeError, match="CUDA"):
            P.YoloV3Detector()
