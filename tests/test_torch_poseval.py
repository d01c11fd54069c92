"""The port's poseval, converters, keypoint structs, tracking metrics and
PCK meter vs the JAX package's, on the same random predictions.

All of it is host code in numpy, copied into the port, so outputs must agree
to 1e-12 (they are the same operations in the same order; the tolerance only
allows for a different numpy reduction path).  Ground truth is the synthetic
tree's poseval annotation jsons; predictions are the ground truth's joints
plus noise, with some people dropped and some invented, so that matches,
misses, false positives and identity switches all occur.
"""

import copy
import json
import os

import numpy as np
import pytest

from otpose_tpu.data.posetrack import PoseTrackDataset as JaxDataset
from otpose_tpu.evaluate import converters as jax_converters
from otpose_tpu.evaluate import keypoints as jax_keypoints
from otpose_tpu.evaluate import pck as jax_pck
from otpose_tpu.evaluate import poseval as jax_poseval
from otpose_tpu.evaluate.tracking import evaluate_tracking as jax_evaluate_tracking
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.data.posetrack import PoseTrackDataset
from otpose_tpu_torch.engine.runner import _print_name_value
from otpose_tpu_torch.evaluate import converters, keypoints, pck, poseval
from otpose_tpu_torch.evaluate.tracking import evaluate_tracking
from otpose_tpu_torch.utils.table import pipe_table
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.synthetic_data import make_synthetic_posetrack

pytest.importorskip("cv2")
ATOL = 1e-12


@pytest.fixture(scope="module", params=[False, True], ids=["pt17", "pt18"])
def tree(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("poseval")
    dirs = make_synthetic_posetrack(str(root), num_videos=3, frames_per_video=5,
                                    people_per_frame=3, img_w=128, img_h=96,
                                    is_2018=request.param)
    return root, dirs, request.param


def _noisy_predictions(annot_dir, pred_dir, seed):
    """Per-video prediction jsons in the annolist format."""
    rng = np.random.RandomState(seed)
    os.makedirs(pred_dir, exist_ok=True)
    for name in sorted(os.listdir(annot_dir)):
        gt = json.load(open(os.path.join(annot_dir, name)))
        frames = []
        for fr in gt["annolist"]:
            rects = []
            for rect in fr["annorect"]:
                if rng.rand() < 0.2:
                    continue                                   # a miss
                pts = [{"id": p["id"], "x": [p["x"][0] + rng.randn() * 3],
                        "y": [p["y"][0] + rng.randn() * 3], "score": [float(rng.rand())]}
                       for p in rect["annopoints"][0]["point"] if rng.rand() < 0.9]
                track = rect["track_id"][0] if rng.rand() < 0.8 else int(rng.randint(5))
                rects.append({"annopoints": [{"point": pts}], "score": [float(rng.rand())],
                              "track_id": [track]})
            if rng.rand() < 0.3:                               # a false positive
                pts = [{"id": [k], "x": [float(rng.uniform(0, 128))],
                        "y": [float(rng.uniform(0, 96))], "score": [float(rng.rand())]}
                       for k in range(15)]
                rects.append({"annopoints": [{"point": pts}], "score": [0.5], "track_id": [7]})
            frames.append({"image": fr["image"], "imgnum": fr["imgnum"], "annorect": rects})
        json.dump({"annolist": frames}, open(os.path.join(pred_dir, name), "w"))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_ap_and_tracking_are_equal(tree, seed):
    root, (_, _, annot_dir), _ = tree
    pred_dir = str(root / f"pred{seed}")
    _noisy_predictions(annot_dir, pred_dir, seed)
    want = jax_poseval.evaluate(annot_dir, pred_dir, eval_track=True)
    got = poseval.evaluate(annot_dir, pred_dir, eval_track=True)
    assert len(got[0]) == len(want[0]) == 8 and len(got[1]) == len(want[1])
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert 0.0 < got[0][7] < 99.0
    want_upper = jax_poseval.evaluate(annot_dir, pred_dir, eval_pose=False, eval_upper_bound=True)
    got_upper = poseval.evaluate(annot_dir, pred_dir, eval_pose=False, eval_upper_bound=True)
    assert got_upper[0] is None and want_upper[0] is None
    _close(got_upper[1], want_upper[1])


def test_evaluate_tracking_tables_are_equal(tree):
    root, (_, _, annot_dir), _ = tree
    pred_dir = str(root / "pred_track")
    _noisy_predictions(annot_dir, pred_dir, 5)
    frames = [m.load_data_dir(annot_dir, pred_dir) for m in (jax_poseval, poseval)]
    assert frames[0] == frames[1]
    want = jax_evaluate_tracking(*copy.deepcopy(frames[0]))
    got = evaluate_tracking(*copy.deepcopy(frames[1]))
    assert got.keys() == want.keys() == {"mota", "motp", "pre", "rec"}
    for k in want:
        _close(got[k], want[k])
    ap_want = jax_poseval.evaluate_ap(*copy.deepcopy(frames[0]))
    ap_got = poseval.evaluate_ap(*copy.deepcopy(frames[1]))
    for g, w in zip(ap_got, ap_want):
        _close(g, w)


def test_converters_are_equal(tree):
    _, (json_dir, _, annot_dir), _ = tree
    assert converters.video2filenames(annot_dir) == jax_converters.video2filenames(annot_dir)
    for name in sorted(os.listdir(annot_dir)):
        old = json.load(open(os.path.join(annot_dir, name)))
        new = converters.convert_videos(copy.deepcopy(old))
        assert new == jax_converters.convert_videos(copy.deepcopy(old))
        back = converters.convert_videos(copy.deepcopy(new[0]))
        assert back == jax_converters.convert_videos(copy.deepcopy(new[0]))
        assert len(back[0]["annolist"]) == len(old["annolist"])


def test_annorect_structs_and_keypoint_orders_are_equal():
    rng = np.random.RandomState(2)
    assert keypoints.PT15_FROM_COCO17 == jax_keypoints.PT15_FROM_COCO17
    for n in (0, 1, 3):
        poses = [rng.rand(4, 17) * 100 for _ in range(n)]
        boxes = [rng.rand(1, 6) for _ in range(n)]
        tracks = list(range(n))
        for kw in ({}, {"eval_tracking": True, "tracking_threshold": 0.5}):
            assert keypoints.convert_data_to_annorect_struct(poses, tracks, boxes, **kw) == \
                jax_keypoints.convert_data_to_annorect_struct(poses, tracks, boxes, **kw)
    pose = rng.rand(17, 3)
    _close(keypoints.coco2posetrack_points(pose, 0.7),
           jax_keypoints.coco2posetrack_points(pose, 0.7))


def test_dataset_evaluate_writes_the_same_files_and_table(tree):
    root, dirs, is_2018 = tree
    cfgs = []
    for cfg in (jax_tiny_cfg(), tiny_otpose_cfg()):
        cfg.DATASET.IS_2018 = is_2018
        cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR, cfg.VAL.ANNOT_DIR = dirs
        cfg.DATASET.TEST_IMG_DIR = dirs[1]
        cfgs.append(cfg)
    want_ds, got_ds = JaxDataset(cfgs[0], "validate"), PoseTrackDataset(cfgs[1], "validate")
    rng = np.random.RandomState(4)
    n = len(got_ds)
    preds = np.zeros((n, 17, 3))
    boxes = np.zeros((n, 6))
    filenames_map = {}
    for i, rec in enumerate(got_ds.data):
        preds[i, :, :2] = rec["joints_3d"][:, :2] + rng.randn(17, 2) * 3
        preds[i, :, 2] = rng.rand(17)
        boxes[i] = [*rec["center"], *rec["scale"], np.prod(rec["scale"] * 200), 1.0]
        filenames_map.setdefault(rec["image"], []).append(i)
    want = want_ds.evaluate(cfgs[0], preds, str(root / "want"), boxes, filenames_map)
    got = got_ds.evaluate(cfgs[1], preds, str(root / "got"), boxes, filenames_map)
    assert list(got[0]) == list(want[0]) and len(got[0]) == 8
    _close(list(got[0].values()), list(want[0].values()))
    _close(got[1], want[1])
    assert 0.0 < got[1] < 99.0
    for name in sorted(os.listdir(root / "want" / "val_set_json_results")):
        assert json.load(open(root / "want" / "val_set_json_results" / name)) == \
            json.load(open(root / "got" / "val_set_json_results" / name))
    assert len(os.listdir(root / "got" / "val_set_json_results")) == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pck_accuracy_is_equal(seed):
    rng = np.random.RandomState(seed)
    out = rng.rand(4, 17, 16, 12).astype(np.float32)
    tgt = np.zeros_like(out)
    for b in range(4):
        for j in range(17):
            if rng.rand() < 0.8:
                y, x = rng.randint(16), rng.randint(12)
                tgt[b, j, y, x] = 1.0
                if rng.rand() < 0.5:
                    out[b, j, y, x] = 2.0           # a hit
    want, got = jax_pck.accuracy(out, tgt), pck.accuracy(out, tgt)
    for g, w in zip(got, want):
        _close(g, w)
    assert 0 < got[1] < 1 and got[2] > 0
    p, t = rng.rand(4, 17, 2) * 10, rng.rand(4, 17, 2) * 10
    _close(pck.calc_dists(p, t, np.ones((4, 2))), jax_pck.calc_dists(p, t, np.ones((4, 2))))
    assert pck.dist_acc(np.full(5, -1.0)) == jax_pck.dist_acc(np.full(5, -1.0)) == -1


def test_pipe_table_prints_what_tabulate_prints(caplog):
    tabulate = pytest.importorskip("tabulate").tabulate
    rows = [["Phase", "validate"], ["Log File", "/a/b/validate-2026.log"], ["N", "x" * 40]]
    assert pipe_table(rows, ["Key", "Value"]) == tabulate(
        rows, tablefmt="pipe", headers=["Key", "Value"], numalign="left")
    values = {"Head": 12.34, "Shoulder": 0.0, "Elbow": 100.0, "Wrist": 87.654321,
              "Hip": 100.12345, "Knee": float("nan"), "Ankle": 3.2e-05, "Mean": 45.67891}
    want = tabulate([["OTPose"] + ["{:.4f}".format(v) for v in values.values()]],
                    tablefmt="pipe", headers=["Model"] + list(values), numalign="left")
    with caplog.at_level("INFO"):
        _print_name_value(values, "OTPose")
    assert caplog.records[-1].getMessage() == "=> Result Table: \n" + want
