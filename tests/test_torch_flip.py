"""The port's flip-test eval vs the JAX package on ``tiny_otpose_cfg``.

The weights of tests/test_torch_otpose.py (JAX init's keys and shapes with
numpy values, the refinement calibrated by ``calibrate_refinement``, carried
across by ``jax_bridge``), in f32; JAX runs ``fused=False``.

- ``make_flip_eval_step``'s averaged heatmaps and teacher agree to 1e-3 of
  their peaks;
- ``make_decoded_eval_step(flip=True)``: coords equal wherever the averaged
  heatmap's top-two gap exceeds 1e-3, maxvals to 1e-3 of the peak;
- one flip step calls the kernel wrappers 8 (attention), 12 (MLP) and 2
  (DCN) times, twice the forward's, and launches nothing on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.engine.runner import make_flip_eval_step as jax_flip_step
from otpose_tpu.engine.trainer import make_decoded_eval_step as jax_decoded_step
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.engine.runner import flip_permutation, make_flip_eval_step
from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import load_jax_weights
from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import (calibrate_refinement, numpy_weights,  # noqa: F401
                                      one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def case():
    jspec = JaxSpec.from_cfg(jax_tiny_cfg())
    params, state = numpy_weights(_init_otpose_impl, jspec)
    _, model = build_model(tiny_otpose_cfg(), device="cpu")
    load_jax_weights(model, params, state)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 15).astype(np.float32)
    margin = np.array([[1, 1, 2, 2], [1, 0, 2, 0]], np.float32)
    inside = calibrate_refinement(params, state, x, margin)
    load_jax_weights(model, params, state)
    batch = {"inputs": jnp.asarray(x), "margin": jnp.asarray(margin), "inside": inside}
    return jspec, params, state, model, x, margin, batch


@pytest.fixture(scope="module")
def flip_heat(case):
    jspec, params, state, model, x, margin, batch = case
    batch = {k: batch[k] for k in ("inputs", "margin")}
    want = [np.asarray(a) for a in jax_flip_step(jspec, fused=False)(params, state, batch)]
    got = [a.numpy() for a in make_flip_eval_step(model)(torch.from_numpy(x),
                                                          torch.from_numpy(margin))]
    return want, got


def test_flip_permutation_swaps_each_pair_once():
    perm = flip_permutation(17)
    assert sorted(perm) == list(range(17))
    assert perm[:3] == [0, 1, 2] and perm[3:7] == [4, 3, 6, 5] and perm[15:] == [16, 15]


@pytest.mark.parametrize("which", ["heatmaps", "teacher"])
def test_flip_eval_step_matches_jax(case, flip_heat, which):
    assert case[-1]["inside"] > 0.5
    want, got = flip_heat
    i = ("heatmaps", "teacher").index(which)
    assert got[i].shape == want[i].shape == (2, 16, 16, 17)
    peak = np.abs(want[i]).max()
    np.testing.assert_allclose(got[i] / peak, want[i] / peak, atol=1e-3, rtol=0)


def test_flip_shift_duplicates_column_zero(case, flip_heat):
    """The flipped pass's unflipped heatmaps move right by one column and
    column 0 repeats (not a zero fill), so in heat_f = 2 * heat - direct
    columns 0 and 1 are equal up to the rounding of that difference."""
    _, _, _, model, x, margin, _ = case
    heat = torch.from_numpy(flip_heat[1][0])
    with torch.no_grad():
        direct = model(torch.from_numpy(x), torch.from_numpy(margin))[0]
    heat_f = (2 * heat - direct)[:, :, :2]
    tol = 1e-6 * max(1.0, direct[:, :, :2].abs().max().item())
    assert heat_f[:, :, 0].abs().max() > 1e3 * tol
    torch.testing.assert_close(heat_f[:, :, 0], heat_f[:, :, 1], rtol=0, atol=tol)


def test_decoded_flip_step_matches_jax(case, flip_heat):
    jspec, params, state, model, x, margin, batch = case
    assert batch["inside"] > 0.5
    batch = {k: batch[k] for k in ("inputs", "margin")}
    want = [np.asarray(a) for a in jax_decoded_step(jspec, flip=True, fused=False)(
        params, state, batch)]
    got = [a.numpy() for a in make_decoded_eval_step(model, flip=True)(
        torch.from_numpy(x), torch.from_numpy(margin))]
    heat = flip_heat[1][0].transpose(0, 3, 1, 2).reshape(2, 17, -1)
    top = np.sort(heat, axis=-1)
    clear = (top[..., -1] - top[..., -2]) > 1e-3
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[0][clear], want[0][clear])
    np.testing.assert_array_equal(got[2][clear], want[2][clear])
    peak = np.abs(want[1]).max()
    np.testing.assert_allclose(got[1] / peak, want[1] / peak, rtol=0, atol=1e-3)


def test_flip_step_calls_each_kernel_twice_per_forward(case):
    _, _, _, model, x, margin, _ = case
    for mod in (fused_attn, fused_mlp, deform_conv):
        mod.calls = mod.launches = 0
    coords, _, _ = make_decoded_eval_step(model, flip=True)(torch.from_numpy(x),
                                                            torch.from_numpy(margin))
    assert coords.shape == (2, 17, 2)
    assert (fused_attn.calls, fused_mlp.calls, deform_conv.calls) == (8, 12, 2)
    assert (fused_attn.launches, fused_mlp.launches, deform_conv.launches) == (0, 0, 0)
