"""The port's drawing path against the JAX package's.

- every function of ``utils/images.py`` on the same arrays as JAX's: the
  images they return or write pixel-equal (``tensor2im``, ``draw_skeleton``,
  ``draw_bbox``, ``draw_skeleton_in_origin_image`` with its accumulation and
  sub-folders, ``heatmaps_overlay``, ``save_result_images``,
  ``save_fusion_images``), and the video round trip (``image2video``,
  ``images2video``, ``video2images``) giving the JAX one's frames;
- the runner's drawing branches (``_dump_vis``, ``_tb_image_grids``,
  ``_vis_origin_images``) writing or handing over the JAX ones' pixels, also
  from tensors;
- both eval CLIs with ``DEBUG.VIS_SKELETON`` on over
  tests/helpers/synthetic_data.py's jpg tree (the port on its heatmap path,
  with and without the flip): equal AP tables (1e-9) and the same image
  files written, one a frame and a dump every ``PRINT_FREQ`` batches.  The
  JAX run has ``otpose_tpu.data.native.is_available`` patched to False (its
  C++ crop differs from cv2's by a uint8 step), and so has the port's.
"""

import os
import os.path as osp

import numpy as np
import pytest
import torch

from otpose_tpu.cli.eval import Eval as JaxEval
from otpose_tpu.config import default_parse_args as jax_parse_args
from otpose_tpu.config import get_cfg as jax_get_cfg
from otpose_tpu.data import native as jax_native
from otpose_tpu.engine import runner as jax_runner
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl
from otpose_tpu.utils import images as jax_images
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.cli.eval import Eval
from otpose_tpu_torch.config import default_parse_args, get_cfg
from otpose_tpu_torch.data import native as port_native
from otpose_tpu_torch.engine import runner
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import load_jax_weights
from otpose_tpu_torch.utils import images
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.synthetic_data import make_synthetic_posetrack
from tests.helpers.torch_port import numpy_weights, one_torch_thread  # noqa: F401  (fixture)

cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.usefixtures("one_torch_thread")
AP_KEYS = ("Head", "Shoulder", "Elbow", "Wrist", "Hip", "Knee", "Ankle", "Mean")


def _files(root):
    return sorted(osp.relpath(osp.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)


def _same_images(a_root, b_root):
    names = _files(a_root)
    assert names == _files(b_root) and names
    for n in names:
        a, b = cv2.imread(osp.join(a_root, n)), cv2.imread(osp.join(b_root, n))
        assert a is not None and np.array_equal(a, b), n
    return names


def _skeleton(rng, n=1, size=60):
    coords = np.zeros((n, 17, 3))
    coords[..., :2] = rng.uniform(2, size, (n, 17, 2))
    coords[..., 2] = rng.uniform(0, 1, (n, 17))
    return coords


def test_tensor2im_draw_and_overlay_equal_jax():
    rng = np.random.RandomState(0)
    t = rng.randn(3, 40, 30).astype(np.float32)
    np.testing.assert_array_equal(images.tensor2im(t), jax_images.tensor2im(t))
    np.testing.assert_array_equal(images.tensor2im(t.transpose(1, 2, 0)),
                                  jax_images.tensor2im(t.transpose(1, 2, 0)))
    img = rng.randint(0, 255, (64, 64, 3), np.uint8)
    c = _skeleton(rng)[0]
    for thre in (0.0, 0.5):
        np.testing.assert_array_equal(
            images.draw_skeleton(img, c[:, :2], c[:, 2], vis_thre=thre),
            jax_images.draw_skeleton(img, c[:, :2], c[:, 2], vis_thre=thre))
    np.testing.assert_array_equal(images.draw_skeleton(img, c[:, :2]),
                                  jax_images.draw_skeleton(img, c[:, :2]))
    np.testing.assert_array_equal(images.draw_bbox(img.copy(), (4, 5, 40, 50), label="p1"),
                                  jax_images.draw_bbox(img.copy(), (4, 5, 40, 50), label="p1"))
    hm = rng.rand(17, 16, 12).astype(np.float32)
    np.testing.assert_array_equal(images.heatmaps_overlay(img, hm),
                                  jax_images.heatmaps_overlay(img, hm))


def test_result_and_fusion_images_equal_jax(tmp_path):
    rng = np.random.RandomState(1)
    img = rng.rand(64, 48, 3).astype(np.float32)
    heat = rng.rand(17, 24, 18).astype(np.float32)
    pose, conf = rng.uniform(0, 40, (17, 2)), rng.rand(17)
    for mod, sub in ((images, "port"), (jax_images, "jax")):
        out = str(tmp_path / sub)
        path = mod.save_result_images(out, img, pose, conf, heatmaps=heat, name="r_")
        assert osp.basename(path) == "r_result.jpg"
        paths = mod.save_fusion_images(out, img, "s0_", heatmaps=heat)
        assert len(paths) == 17 and osp.basename(paths[0]) == "s0_nose_img_heatmap.png"
    assert len(_same_images(str(tmp_path / "port"), str(tmp_path / "jax"))) == 18


def test_origin_image_accumulation_equals_jax(tmp_path):
    img_root = tmp_path / "data" / "images" / "val" / "v001"
    os.makedirs(img_root)
    frame = str(img_root / "00000001.jpg")
    cv2.imwrite(frame, np.full((64, 64, 3), 255, np.uint8))
    rng = np.random.RandomState(2)
    calls = [(_skeleton(rng), [(4, 4, 30, 30)], {}),
             (_skeleton(rng), [(30, 30, 60, 60)], {}),
             (_skeleton(rng), [(0, 0, 1, 1)], {"vis_bbox": False}),
             (_skeleton(rng), [(2, 3, 9, 9)], {"vis_skeleton": False})]
    for mod, sub in ((images, "port"), (jax_images, "jax")):
        for coords, boxes, kw in calls:
            written = mod.draw_skeleton_in_origin_image([frame], coords, boxes,
                                                        str(tmp_path / sub), **kw)
            assert len(written) == 1
    names = _same_images(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert names == [osp.join(s, "val", "v001", "00000001.jpg")
                     for s in ("SkeletonAndBbox", "bbox", "skeleton")]


def test_video_round_trip_equals_jax(tmp_path):
    frames_dir = tmp_path / "frames"
    os.makedirs(frames_dir)
    rng = np.random.RandomState(3)
    for i in range(6):
        cv2.imwrite(str(frames_dir / f"{i:08d}.jpg"), rng.randint(0, 255, (48, 64, 3), np.uint8))
    got = {}
    for mod, sub in ((images, "port"), (jax_images, "jax")):
        out = mod.image2video(str(frames_dir), "clip", fps=5, out_dir=str(tmp_path / sub))
        assert osp.getsize(out) > 0
        assert mod.video2images(out, str(tmp_path / sub / "back")) == 6
        again = mod.images2video(sorted(str(p) for p in frames_dir.iterdir()),
                                 str(tmp_path / sub / "again.mp4"), fps=5)
        assert mod.video2images(again, str(tmp_path / sub / "back2")) == 6
        got[sub] = [str(tmp_path / sub / b) for b in ("back", "back2")]
    for a, b in zip(got["port"], got["jax"]):
        _same_images(a, b)
    with pytest.raises(FileNotFoundError):
        images.image2video(str(tmp_path / "port" / "back" / ".."), "none",
                           out_dir=str(tmp_path / "nothing"))


def _vis_cfgs():
    cfgs = (get_cfg(), jax_get_cfg())
    for cfg in cfgs:
        cfg.DEBUG.VIS_SKELETON = True
        cfg.DEBUG.VIS_BBOX = True
    return cfgs


class FakeTB:
    def __init__(self):
        self.calls = []

    def add_images(self, tag, imgs, step, dataformats=None):
        self.calls.append((tag, np.asarray(imgs), step, dataformats))


def test_runner_drawing_branches_equal_jax(tmp_path):
    rng = np.random.RandomState(4)
    b, j = 2, 17
    batch = {"inputs": rng.randn(b, 32, 32, 15).astype(np.float32),
             "target": rng.rand(b, 8, 8, j).astype(np.float32)}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    img_root = tmp_path / "images" / "val" / "v002"
    os.makedirs(img_root)
    frames = []
    for i in range(2):
        frames.append(str(img_root / f"0000000{i}.jpg"))
        cv2.imwrite(frames[-1], rng.randint(0, 255, (48, 48, 3), np.uint8))
    metas = [{"center": np.array([24.0, 20.0]), "scale": np.array([0.2, 0.15]),
              "image": frames[i], "score": 1.0} for i in range(b)]
    preds = rng.rand(b, 8, 8, j).astype(np.float32)
    coords, maxvals = rng.rand(b, j, 3) * 40, rng.rand(b, j, 1)
    cfg, jcfg = _vis_cfgs()
    runner._dump_vis(cfg, str(tmp_path / "port"), "validate", 3, tbatch, metas, preds)
    jax_runner._dump_vis(jcfg, str(tmp_path / "jax"), "validate", 3, batch, metas, preds)
    runner._vis_origin_images(cfg, str(tmp_path / "port"), "validate", metas, coords, maxvals)
    jax_runner._vis_origin_images(jcfg, str(tmp_path / "jax"), "validate", metas, coords,
                                  maxvals)
    names = _same_images(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert osp.join("validate_vis", "3_pred_result.jpg") in names and len(names) == 3
    tb, jtb = FakeTB(), FakeTB()
    runner._tb_image_grids(tb, tbatch, 7)
    jax_runner._tb_image_grids(jtb, batch, 7)
    assert [c[0] for c in tb.calls] == ["train/input_images", "train/gt_heatmaps"]
    for got, want in zip(tb.calls, jtb.calls):
        assert got[0] == want[0] and got[2:] == want[2:]
        np.testing.assert_array_equal(got[1], want[1])


def _fill(cfg, root, json_dir, img_dir, annot_dir, pth, name, flip, batch):
    cfg.EXPERIMENT_NAME = name
    cfg.OUTPUT_DIR = str(root / name)
    cfg.PRINT_FREQ = 1
    cfg.DATASET.NAME = "PoseTrack"
    cfg.DATASET.JSON_DIR = json_dir
    cfg.DATASET.IMG_DIR = img_dir
    cfg.DATASET.TEST_IMG_DIR = img_dir
    cfg.DATASET.COLOR_RGB = True
    cfg.VAL.ANNOT_DIR = annot_dir
    cfg.VAL.USE_GT_BBOX = True
    cfg.VAL.BATCH_SIZE_PER_GPU = batch
    cfg.VAL.FLIP_VAL = flip
    cfg.VAL.MODEL_FILE = pth
    cfg.WORKERS = 2
    cfg.DEBUG.VIS_SKELETON = True
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.PARAM_DTYPE = "float32"
    cfg.TPU.DEVICE_PREPROCESS = "off"
    path = root / f"{name}.yaml"
    path.write_text(cfg.dump())
    return str(path)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_vis_cli")
    dirs = make_synthetic_posetrack(str(root), num_videos=2, frames_per_video=3,
                                    people_per_frame=2, img_w=96, img_h=96)
    params, state = numpy_weights(_init_otpose_impl,
                                  JaxSpec.from_cfg(jax_tiny_cfg(64, 16, 8)))
    for name in params:     # offsets of a few pixels, O(1) masks (test_torch_eval_cli.py)
        if name.endswith(".weight") and name.startswith(("offsets_list", "masks_list")):
            params[name] = params[name] * np.float32(3e-4)
    _, model = build_model(tiny_otpose_cfg(64, 16, 8), device="cpu")
    load_jax_weights(model, params, state)
    pth = str(root / "shared_weights.pth")
    torch.save({"state_dict": model.state_dict()}, pth)
    return root, dirs, pth


def _table(results):
    (_, name_values, _), = results
    return np.asarray([name_values[k] for k in AP_KEYS], np.float64)


@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
def test_eval_clis_draw_the_same_files(workspace, flip):
    """The JAX CLI's batch is ``BATCH_SIZE_PER_GPU`` times its device count
    (eight CPU devices under tests/conftest.py); the port's is given the same
    batch, so both dump after the same iterations."""
    import jax

    root, dirs, pth = workspace
    tag = "flip" if flip else "noflip"
    jyaml = _fill(jax_tiny_cfg(64, 16, 8), root, *dirs, pth, f"jax_vis_{tag}", flip, 1)
    tyaml = _fill(tiny_otpose_cfg(64, 16, 8), root, *dirs, pth, f"torch_vis_{tag}", flip,
                  len(jax.devices()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "is_available", lambda: False)
        mp.setattr(port_native, "is_available", lambda: False)
        jev = JaxEval("validate", jax_parse_args(["--cfg", jyaml, "--root_dir", str(root)]))
        want = _table(jev.eval())
        ev = Eval("validate", default_parse_args(["--cfg", tyaml, "--root_dir", str(root)]),
                  device="cpu")
        assert not ev.use_decoded and not jev.use_decoded and ev.batch == jev.batch
        got = _table(ev.eval())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9, equal_nan=True)
    names = _files(osp.join(ev.cfg.OUTPUT_DIR, "validate_vis"))
    assert names == _files(osp.join(jev.cfg.OUTPUT_DIR, "validate_vis"))
    drawn = [n for n in names if n.startswith("skeleton" + os.sep)]
    dumps = [n for n in names if n.endswith("_pred_result.jpg")]
    assert len(dumps) == len(ev.loader) > 1         # one a batch at PRINT_FREQ 1
    assert len(drawn) == 6                          # one a frame: 2 videos x 3 frames
