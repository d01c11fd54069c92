"""The port's single-clip inference path vs the JAX package, on the CPU.

- the host geometry copies (``ops/bbox.py``, ``ops/affine.py``) equal the
  JAX package's exactly;
- ``warp_affine`` (plain torch ops) matches JAX's to 1e-5, with a rotated
  matrix and a crop that leaves the image;
- ``get_final_preds`` matches JAX's to 1e-6 on random heatmaps, and the
  host ``get_max_preds`` equals JAX's;
- ``PoseEstimator.infer_images`` matches the JAX ``PoseEstimator`` on
  ``tiny_otpose_cfg(image_size=32, heatmap_size=8)`` with the same weights
  in f32: keypoints to 1e-4 where the heatmap's top-two gap exceeds 1e-3,
  maxvals to 1e-3 of the peak;
- ``inference_PE`` from image paths, and the unreadable-path error (these
  need cv2 and skip without it, as the JAX package's test does).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.cli.inference import PoseEstimator as JaxPoseEstimator
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl
from otpose_tpu.ops import affine as jax_affine
from otpose_tpu.ops import bbox as jax_bbox
from otpose_tpu.ops.heatmap import get_final_preds as jax_get_final_preds
from otpose_tpu.ops.heatmap import get_max_preds as jax_get_max_preds
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.cli.inference import PoseEstimator, inference_PE
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import load_jax_weights
from otpose_tpu_torch.ops import affine, bbox
from otpose_tpu_torch.ops.heatmap import get_final_preds, get_max_preds
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import numpy_weights, one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CFG = dict(image_size=32, heatmap_size=8)


@pytest.fixture(scope="module")
def estimators():
    """Both estimators on one set of weights.  The offset convs' weights are
    scaled by 0.1: at full scale every deformable sample of these frames
    falls outside the 8x8 heatmap and the output is the DCN bias alone, a
    constant map with no peak to compare."""
    jspec = JaxSpec.from_cfg(jax_tiny_cfg(**CFG))
    params, state = numpy_weights(_init_otpose_impl, jspec)
    params = {k: v * 0.1 if k.startswith("offsets_list") else v for k, v in params.items()}
    jax_est = JaxPoseEstimator(jax_tiny_cfg(**CFG), params, state, compute_dtype=jnp.float32)
    cfg = tiny_otpose_cfg(**CFG)
    _, model = build_model(cfg, device="cpu")
    load_jax_weights(model, params, state)
    return jax_est, PoseEstimator(cfg, model, compute_dtype=torch.float32, device="cpu")


def _frames(seed, shape=(60, 80, 3)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, shape, dtype=np.uint8) for _ in range(5)]


@pytest.mark.parametrize("box", [[10, 10, 40, 40], [5, 20, 60, 15], [-4, 3, 12.5, 30]])
def test_bbox_and_affine_copies_equal_jax(box):
    c, s = bbox.box2cs(box, 0.75)
    jc, js = jax_bbox.box2cs(box, 0.75)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(s, js)
    assert bbox.cs2box(c, s, pattern="xyxy") == jax_bbox.cs2box(jc, js, pattern="xyxy")
    for rot, inv in ((0, 0), (17, 0), (0, 1)):
        t = affine.get_affine_transform(c, s, rot, [24, 32], inv=inv)
        np.testing.assert_array_equal(t, jax_affine.get_affine_transform(c, s, rot, [24, 32],
                                                                         inv=inv))
    pts = np.random.RandomState(0).rand(5, 2) * 8
    np.testing.assert_array_equal(affine.apply_affine_to_points(pts, t),
                                  jax_affine.apply_affine_to_points(pts, t))
    np.testing.assert_array_equal(affine.invert_affine(t), jax_affine.invert_affine(t))


def test_warp_affine_matches_jax():
    rng = np.random.RandomState(0)
    images = (rng.rand(3, 40, 50, 3) * 255).astype(np.float32)
    mats = [
        affine.get_affine_transform(np.array([25, 20]), np.array([0.2, 0.25]), 0, [12, 16]),
        affine.get_affine_transform(np.array([22, 18]), np.array([0.15, 0.2]), 30, [12, 16]),
        # the crop leaves the image on the left and the bottom
        affine.get_affine_transform(np.array([2, 38]), np.array([0.3, 0.4]), -15, [12, 16]),
    ]
    inv = np.stack([affine.invert_affine(m) for m in mats])
    want = np.asarray(jax_affine.warp_affine(jnp.asarray(images), jnp.asarray(inv), 16, 12))
    got = affine.warp_affine(torch.from_numpy(images), inv, 16, 12)
    assert got.shape == (3, 16, 12, 3)
    assert (want[2] == 0).any()                 # some samples fall outside the image
    np.testing.assert_allclose(got.numpy() / 255, want / 255, atol=1e-5, rtol=0)


def test_get_final_preds_matches_jax():
    rng = np.random.RandomState(1)
    heat = rng.randn(3, 17, 8, 6).astype(np.float32)
    heat[1, :4] = -np.abs(heat[1, :4])           # maps whose max is <= 0
    center = rng.rand(3, 2).astype(np.float32) * 100
    scale = (rng.rand(3, 2).astype(np.float32) + 0.5)
    want_p, want_m = jax_get_final_preds(heat, center, scale)
    got_p, got_m = get_final_preds(torch.from_numpy(heat), center, scale)
    assert got_p.dtype == want_p.dtype and got_p.shape == (3, 17, 2)
    np.testing.assert_allclose(got_p, want_p, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_m, want_m, atol=1e-6, rtol=0)


def test_host_get_max_preds_equals_jax():
    heat = np.random.RandomState(3).randn(2, 17, 6, 5).astype(np.float32)
    heat[0, :3] = -np.abs(heat[0, :3])
    want = jax_get_max_preds(heat)
    got = get_max_preds(heat)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="4-ndim"):
        get_max_preds(heat[0])


def test_infer_images_matches_jax(estimators):
    jax_est, est = estimators
    imgs, box = _frames(0), [10, 10, 40, 40]
    want = jax_est.infer_images(imgs, bbox=box)
    got = est.infer_images(imgs, bbox=box)
    assert got.shape == want.shape == (17, 3) and np.isfinite(got).all()
    x, _, _ = est.preprocess(imgs, box)
    heat = est.forward(x, (1, 1, 2, 2))[0].reshape(17, -1).sort(dim=-1).values.numpy()
    clear = (heat[:, -1] - heat[:, -2]) > 1e-3
    assert clear.mean() > 0.5
    np.testing.assert_allclose(got[clear, :2], want[clear, :2], atol=1e-4, rtol=0)
    peak = np.abs(want[:, 2]).max()
    np.testing.assert_allclose(got[:, 2] / peak, want[:, 2] / peak, atol=1e-3, rtol=0)


def test_preprocess_matches_jax(estimators):
    jax_est, est = estimators
    imgs, box = _frames(2), [5, 20, 60, 15]
    want, wc, ws = jax_est.preprocess(imgs, box)
    got, c, s = est.preprocess(imgs, box)
    np.testing.assert_array_equal(c, wc)
    np.testing.assert_array_equal(s, ws)
    assert got.shape == (1, 32, 32, 15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_inference_pe_from_paths(estimators, tmp_path):
    cv2 = pytest.importorskip("cv2")
    jax_est, est = estimators
    paths = []
    for i, img in enumerate(_frames(1)):
        paths.append(str(tmp_path / f"{i}.png"))       # lossless, so both read the same
        cv2.imwrite(paths[-1], img)
    out = inference_PE(est, *paths, bbox=[5, 5, 50, 50])
    assert out.shape == (17, 3) and np.isfinite(out).all()
    want = jax_est(paths, bbox=[5, 5, 50, 50])
    np.testing.assert_allclose(out[:, 2], want[:, 2], atol=1e-3 * np.abs(want[:, 2]).max())


def test_unreadable_path_raises(estimators, tmp_path):
    pytest.importorskip("cv2")
    with pytest.raises(ValueError, match="Fail to read"):
        estimators[1]([str(tmp_path / "missing.jpg")] * 5, bbox=[0, 0, 10, 10])
