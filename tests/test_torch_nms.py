"""``otpose_tpu_torch/ops/nms.py`` against ``otpose_tpu/ops/nms.py`` on the
CPU: the host functions exactly (the same numpy code on the same f64
inputs), the device NMS's keep mask exactly (the same f32 formulas, under
``jax.jit`` on the JAX side), on segments drawn from a seed with numpy:
clustered, so that suppression engages, with tied scores among them."""

import numpy as np
import pytest
import torch

from otpose_tpu.ops import nms as jax_nms
from otpose_tpu_torch.ops import nms


def _segments(seed: int, n: int = 40):
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0, 100, 6)[rng.randint(0, 6, n)] + rng.randn(n) * 3
    widths = rng.uniform(2, 15, n)
    segs = np.stack([centres - widths / 2, centres + widths / 2], axis=1)
    scores = rng.uniform(0, 1, n)
    scores[::7] = scores[1]               # ties: the stable order decides
    return segs, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou", [0.3, 0.5, 0.7])
def test_nms_1d_matches_jax(seed, iou):
    segs, scores = _segments(seed)
    got = nms.nms_1d(segs, scores, iou)
    want = jax_nms.nms_1d(segs, scores, iou)
    np.testing.assert_array_equal(got, want)
    assert 1 < len(got) < len(segs)


def test_nms_1d_empty():
    assert nms.nms_1d(np.zeros((0, 2)), np.zeros(0), 0.5).shape == (0,)


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 3])
def test_softnms_1d_matches_jax(method, seed):
    segs, scores = _segments(seed)
    kw = dict(iou_threshold=0.4, sigma=0.5, min_score=0.05, method=method)
    got = nms.softnms_1d(segs, scores, **kw)
    want = jax_nms.softnms_1d(segs, scores, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[2]) > 0


@pytest.mark.parametrize("max_keep", [0, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_1d_device_matches_jax(seed, max_keep):
    segs, scores = _segments(seed)
    segs32, scores32 = segs.astype(np.float32), scores.astype(np.float32)
    got = nms.nms_1d_device(torch.from_numpy(segs32), torch.from_numpy(scores32), 0.5,
                            max_keep=max_keep)
    want = np.asarray(jax_nms.nms_1d_device(segs32, scores32, 0.5, max_keep=max_keep))
    assert got.dtype == torch.bool and got.shape == (len(segs),)
    np.testing.assert_array_equal(got.numpy(), want)
    if max_keep:
        assert int(got.sum()) == max_keep
    else:
        # the masked greedy pass keeps the host NMS's set
        assert set(np.flatnonzero(got.numpy())) == set(nms.nms_1d(segs32, scores32, 0.5))
