"""The port's eval CLI vs the JAX package's, end to end on the CPU.

One synthetic PoseTrack-format tree (tests/helpers/synthetic_data.py: jpg
frames, COCO-style json, poseval annotation jsons), one reference-layout
``.pth`` holding O(1) weights (tests/helpers/torch_port.py), the tiny config
at 64x64 -> 16x16 in f32.  ``otpose_tpu.cli.eval.Eval(...).eval()`` and
``otpose_tpu_torch.cli.eval.Eval(..., device="cpu").eval()`` each run their
whole pipeline: dataset, loader, forward, device decode, back-projection,
json writing, poseval AP.

- AP tables equal to 1e-9 (NaN where both are NaN), neither empty nor
  perfect, with and without the flip test;
- the same set of per-video json files;
- back-projected keypoints within 1e-3 pixels wherever the heatmap's top-two
  gap exceeds 1e-3 (a near-tie may decode to another cell in either package).

The JAX package's loader crops through its C++ library when that is built,
whose float bilinear warp differs from cv2's by up to one uint8 step; the
port's host path is cv2's, so the JAX run here is made with the library
reported as absent, which puts it on its own cv2 path.
"""

import os

import numpy as np
import pytest
import torch

from otpose_tpu.cli.eval import Eval as JaxEval
from otpose_tpu.config import default_parse_args as jax_parse_args
from otpose_tpu.data import native as jax_native
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.cli.eval import Eval
from otpose_tpu_torch.config import default_parse_args
from otpose_tpu_torch.engine.runner import (AverageMeter, _pipelined_forward, evaluate_epoch,
                                            make_flip_eval_step)
from otpose_tpu_torch.engine.trainer import make_eval_step
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import load_jax_weights
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.synthetic_data import make_synthetic_posetrack
from tests.helpers.torch_port import numpy_weights, one_torch_thread  # noqa: F401  (fixture)

pytest.importorskip("cv2")
pytestmark = pytest.mark.usefixtures("one_torch_thread")
AP_KEYS = ("Head", "Shoulder", "Elbow", "Wrist", "Hip", "Knee", "Ankle", "Mean")


def _fill(cfg, root, json_dir, img_dir, annot_dir, pth, name, flip):
    cfg.EXPERIMENT_NAME = name
    cfg.OUTPUT_DIR = str(root / "output")
    cfg.DATASET.NAME = "PoseTrack"
    cfg.DATASET.JSON_DIR = json_dir
    cfg.DATASET.IMG_DIR = img_dir
    cfg.DATASET.TEST_IMG_DIR = img_dir
    cfg.DATASET.COLOR_RGB = True
    cfg.VAL.ANNOT_DIR = annot_dir
    cfg.VAL.USE_GT_BBOX = True
    cfg.VAL.BATCH_SIZE_PER_GPU = 1
    cfg.VAL.FLIP_VAL = flip
    cfg.VAL.MODEL_FILE = pth
    cfg.WORKERS = 2
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.PARAM_DTYPE = "float32"
    cfg.TPU.DEVICE_PREPROCESS = "off"
    path = root / f"{name}.yaml"
    path.write_text(cfg.dump())
    return str(path)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eval_cli")
    dirs = make_synthetic_posetrack(str(root), num_videos=2, frames_per_video=4,
                                    people_per_frame=2, img_w=96, img_h=96)
    jcfg = jax_tiny_cfg(image_size=64, heatmap_size=16, width0=8)
    params, state = numpy_weights(_init_otpose_impl, JaxSpec.from_cfg(jcfg))
    # at those scales the refinement's features reach the thousands, so every
    # DCN sample would leave the image and the heatmaps would be flat: bring
    # the offsets to a few pixels and the masks to O(1)
    for name in params:
        if name.endswith(".weight") and name.startswith(("offsets_list", "masks_list")):
            params[name] = params[name] * np.float32(3e-4)
    _, model = build_model(tiny_otpose_cfg(image_size=64, heatmap_size=16, width0=8),
                           device="cpu")
    load_jax_weights(model, params, state)
    pth = str(root / "shared_weights.pth")
    torch.save({"state_dict": model.state_dict()}, pth)
    return root, dirs, pth, model


def _run(ev):
    """``ev.eval()`` with the keypoints it hands to ``dataset.evaluate``."""
    seen = {}
    inner = ev.dataset.evaluate

    def spy(cfg, preds, *args, **kwargs):
        seen["preds"] = np.array(preds)
        return inner(cfg, preds, *args, **kwargs)

    ev.dataset.evaluate = spy
    results = ev.eval()
    assert len(results) == 1
    _, name_values, mean_ap = results[0]
    out_dir = os.path.join(ev.cfg.OUTPUT_DIR, "val_set_json_results")
    return (np.asarray([name_values[k] for k in AP_KEYS], np.float64), float(mean_ap),
            seen["preds"], sorted(os.listdir(out_dir)))


@pytest.fixture(scope="module", params=[False, True], ids=["noflip", "flip"])
def both(request, workspace):
    root, dirs, pth, _ = workspace
    flip = request.param
    tag = "flip" if flip else "noflip"
    jyaml = _fill(jax_tiny_cfg(image_size=64, heatmap_size=16, width0=8), root, *dirs, pth,
                  f"jax_{tag}", flip)
    tyaml = _fill(tiny_otpose_cfg(image_size=64, heatmap_size=16, width0=8), root, *dirs, pth,
                  f"torch_{tag}", flip)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "is_available", lambda: False)
        want = _run(JaxEval("validate",
                            jax_parse_args(["--cfg", jyaml, "--root_dir", str(root)])))
    ev = Eval("validate", default_parse_args(["--cfg", tyaml, "--root_dir", str(root)]),
              device="cpu")
    return want, _run(ev), ev


def test_ap_tables_are_equal(both):
    want, got, _ = both
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-9, equal_nan=True)
    assert got[1] == pytest.approx(want[1], abs=1e-9)
    # not trivially equal: the table is neither empty nor perfect
    finite = want[0][np.isfinite(want[0])]
    assert finite.size > 0
    assert np.nanmin(want[0]) < 99.0, want[0]


def test_the_same_json_files_are_written(both):
    want, got, _ = both
    assert got[3] == want[3] and len(got[3]) == 2


def test_keypoints_agree_on_clear_peaks(both, workspace):
    want, got, ev = both
    model = workspace[3]
    step = make_flip_eval_step(model) if ev.flip else make_eval_step(model)
    heat = []
    for i in range(len(ev.dataset)):
        s = ev.dataset.get_sample_host(i)
        h = step(torch.from_numpy(s["inputs"])[None], torch.from_numpy(s["margin"])[None])[0]
        heat.append(h[0].permute(2, 0, 1).reshape(17, -1).numpy())
    top = np.sort(np.stack(heat), axis=-1)
    clear = (top[..., -1] - top[..., -2]) > 1e-3
    assert clear.mean() > 0.5
    assert got[2].shape == want[2].shape == (16, 17, 3)
    np.testing.assert_allclose(got[2][..., :2][clear], want[2][..., :2][clear], rtol=0, atol=1e-3)
    peak = np.abs(want[2][..., 2]).max()
    np.testing.assert_allclose(got[2][..., 2] / peak, want[2][..., 2] / peak, rtol=0, atol=1e-3)


def test_heatmap_path_gives_the_decoded_path_s_table(both, workspace):
    """``evaluate_epoch`` (heatmaps to the host, numpy decode) against
    ``evaluate_epoch_decoded`` (decode on the device), as the JAX package
    holds its own two loops to each other."""
    _, got, ev = both
    model = workspace[3]
    step = make_flip_eval_step(model) if ev.flip else make_eval_step(model)
    name_values, mean_ap = evaluate_epoch(step, ev.loader, ev.dataset, ev.cfg,
                                          str(workspace[0] / f"heatmap_path_{ev.flip}"),
                                          device="cpu")
    table = np.asarray([name_values[k] for k in AP_KEYS], np.float64)
    np.testing.assert_allclose(table, got[0], rtol=0, atol=1e-6, equal_nan=True)
    assert mean_ap == pytest.approx(got[1], abs=1e-6)


def test_pipelined_forward_keeps_one_batch_in_flight():
    """Batch i + 1 is launched before batch i is fetched, every batch comes
    out once and in order, and the last one is flushed."""
    log = []
    batches = [({"inputs": np.full((1, 2), i, np.float32), "margin": np.zeros((1, 4), np.float32)},
                [{"i": i}]) for i in range(4)]

    def run(inputs, margin):
        log.append(("run", int(inputs[0, 0])))
        return inputs

    def fetch(outs):
        log.append(("fetch", int(outs[0, 0])))
        return outs.numpy()

    seen = [(int(out[0, 0]), metas[0]["i"])
            for out, _, metas in _pipelined_forward(batches, run, fetch, "cpu")]
    assert seen == [(i, i) for i in range(4)]
    assert log == [("run", 0), ("run", 1), ("fetch", 0), ("run", 2), ("fetch", 1),
                   ("run", 3), ("fetch", 2), ("fetch", 3)]
    assert list(_pipelined_forward([], run, fetch, "cpu")) == []
    meter = AverageMeter()
    meter.update(2.0, 3)
    meter.update(4.0)
    assert (meter.val, meter.count, meter.avg) == (4.0, 4, 2.5)


def test_cli_refuses_what_is_not_ported(workspace):
    root, dirs, pth, _ = workspace
    cfg = tiny_otpose_cfg(image_size=64, heatmap_size=16, width0=8)
    yaml = _fill(cfg, root, *dirs, pth, "torch_refuse", False)
    args = lambda *opts: default_parse_args(  # noqa: E731
        ["--cfg", yaml, "--root_dir", str(root), *opts])
    with pytest.raises(NotImplementedError, match="item 10"):
        Eval("validate", args("DEBUG.VIS_SKELETON", "True"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        Eval("validate", args("TPU.DEVICE_PREPROCESS", "crops"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Eval("validate", args())
        with pytest.raises(NotImplementedError, match="item 6"):   # auto on a GPU: crops
            from otpose_tpu_torch.data import make_loader
            cfg.TPU.DEVICE_PREPROCESS = "auto"
            make_loader(cfg, None, 1, shuffle=False, device="cuda")
