"""The port's training losses and PCK meter vs the JAX package's.

``otpose_tpu_torch/models/losses.py`` against ``otpose_tpu/models/losses.py``
on the same numpy inputs (NHWC heatmaps), with joints all labelled, none
labelled and mixed (the batch-global ``max == 1.0`` test), for both
``use_target_weight`` values, to 1e-6 relative; ``build_loss`` for both
names; ``evaluate/pck.py::accuracy_device`` exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.config import get_cfg as jax_get_cfg
from otpose_tpu.evaluate.pck import accuracy_device as jax_accuracy_device
from otpose_tpu.models import losses as jlosses
from otpose_tpu_torch.config import get_cfg
from otpose_tpu_torch.evaluate.pck import accuracy_device
from otpose_tpu_torch.models import losses

from tests.helpers.torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
B, H, W, J = 3, 8, 6, 17


def _heatmaps(seed, labelled):
    """(output_s, output_t, target, target_weight): targets peak at exactly
    1.0 in some sample for the joints in ``labelled`` and below 1 elsewhere."""
    rng = np.random.RandomState(seed)
    out_s = rng.rand(B, H, W, J).astype(np.float32)
    out_t = rng.rand(B, H, W, J).astype(np.float32)
    target = (0.9 * rng.rand(B, H, W, J)).astype(np.float32)
    for j in labelled:
        b, y, x = rng.randint(B), rng.randint(H), rng.randint(W)
        target[b, y, x, j] = 1.0
    weight = (rng.rand(B, J, 1) > 0.3).astype(np.float32)
    return out_s, out_t, target, weight


LABELLED = {"all": range(J), "none": (), "mixed": (0, 3, 4, 9, 16)}


def _close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("use_w", [True, False])
@pytest.mark.parametrize("labelled", list(LABELLED))
def test_st_ohkw_mse_loss_matches_jax(labelled, use_w):
    args = _heatmaps(0, LABELLED[labelled])
    want = jlosses.st_ohkw_mse_loss(*(jnp.asarray(a) for a in args), topk=8,
                                    use_target_weight=use_w)
    got = losses.st_ohkw_mse_loss(*(torch.from_numpy(a) for a in args), topk=8,
                                  use_target_weight=use_w)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("use_w", [True, False])
@pytest.mark.parametrize("labelled", list(LABELLED))
def test_joints_mse_ohkm_and_joint_mse_match_jax(labelled, use_w):
    out_s, _, target, weight = _heatmaps(1, LABELLED[labelled])
    j_args = [jnp.asarray(a) for a in (out_s, target, weight)]
    t_args = [torch.from_numpy(a) for a in (out_s, target, weight)]
    want = jlosses.joints_mse_ohkm_loss(*j_args, topk=8, use_target_weight=use_w)
    got = losses.joints_mse_ohkm_loss(*t_args, topk=8, use_target_weight=use_w)
    for k in want:
        _close(got[k], want[k])
    _close(losses.joint_mse_loss(*t_args, use_target_weight=use_w),
           jlosses.joint_mse_loss(*j_args, use_target_weight=use_w))


def test_labelled_branch_follows_the_batch_global_peak():
    """A joint whose target reaches 1.0 in one sample counts as labelled for
    the whole batch: the consistency term then vanishes for it."""
    out_s, out_t, target, weight = (torch.from_numpy(a) for a in _heatmaps(2, (5,)))
    base = losses.st_ohkw_mse_loss(out_s, out_t, target, weight)["mse_loss_s"]
    out_t2 = out_t.clone()
    out_t2[..., 5] += 1.0          # the teacher of the labelled joint only
    assert float(losses.st_ohkw_mse_loss(out_s, out_t2, target, weight)["mse_loss_s"]) == \
        pytest.approx(float(base), rel=1e-7)
    out_t2[..., 6] += 1.0          # an unlabelled joint's teacher counts
    assert float(losses.st_ohkw_mse_loss(out_s, out_t2, target, weight)["mse_loss_s"]) > \
        float(base) * 1.01


@pytest.mark.parametrize("name", ["ST_OHKW_MSELoss", "MSELOSS_OHKM"])
def test_build_loss_matches_jax(name):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.LOSS.NAME = jcfg.LOSS.NAME = name
    args = _heatmaps(3, LABELLED["mixed"])
    want = jlosses.build_loss(jcfg)(*(jnp.asarray(a) for a in args))
    got = losses.build_loss(cfg)(*(torch.from_numpy(a) for a in args))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])


def test_build_loss_refuses_other_names():
    cfg = get_cfg()
    cfg.LOSS.NAME = "L1"
    with pytest.raises(ValueError, match="Unsupported loss"):
        losses.build_loss(cfg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accuracy_device_matches_jax(seed):
    """Peaked predictions near the targets' peaks, some joints invisible
    (peak at a coordinate <= 1) and one joint invisible in every sample."""
    rng = np.random.RandomState(seed)
    pred = rng.rand(4, 16, 12, J).astype(np.float32)
    target = np.zeros((4, 16, 12, J), np.float32)
    for b in range(4):
        for j in range(J - 1):
            y, x = rng.randint(16), rng.randint(12)
            target[b, y, x, j] = 1.0
            dy, dx = rng.randint(-3, 4), rng.randint(-3, 4)
            pred[b, min(max(y + dy, 0), 15), min(max(x + dx, 0), 11), j] = 2.0
    want = jax_accuracy_device(jnp.asarray(pred), jnp.asarray(target))
    got = accuracy_device(torch.from_numpy(pred), torch.from_numpy(target))
    assert float(got[0]) == float(want[0])
    assert int(got[1]) == int(want[1])
