"""The PyTorch port's slice vs the JAX package on ``tiny_otpose_cfg``.

One model: JAX init's keys and shapes with numpy values
(tests/helpers/torch_port.py), the offset and mask convs scaled so that most
of the DCN's samples fall inside the image (``calibrate_refinement``),
carried to the port by ``jax_bridge``.  The
tiny temporal encoders have C = 136, so they take the kernel dispatch (the
plain versions, on the CPU); JAX runs ``fused=False``.  All in f32.

- the bridge round-trips through ``convert_state_dict`` exactly;
- all seven outputs of ``otpose_forward`` agree to 1e-3 of each output's peak;
- the decoded keypoints of ``make_decoded_eval_step`` agree: coords equal
  wherever a heatmap's top-two gap exceeds 1e-3, maxvals to 1e-3;
- the kernel wrappers are called 4 (attention), 6 (MLP) and 1 (DCN) times
  per forward at arch (0, 2, 1), and launch nothing on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.engine.trainer import make_decoded_eval_step as jax_decoded_step
from otpose_tpu.models.core import Ctx
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl, otpose_forward as jax_forward
from otpose_tpu.models.torch2jax import convert_state_dict
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import load_jax_weights
from otpose_tpu_torch.models.otpose import prepare_eval_params
from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import calibrate_refinement, numpy_weights


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
    return jspec, params, state, model, x, margin, inside


def test_bridge_round_trip_is_exact(case):
    _, params, state, model, _, _, _ = case
    p2, s2 = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    assert p2.keys() == params.keys() and s2.keys() == state.keys()
    for k in params:
        np.testing.assert_array_equal(p2[k], params[k], err_msg=k)
    for k in state:
        np.testing.assert_array_equal(s2[k], state[k], err_msg=k)


def test_seven_outputs_match_jax(case):
    jspec, params, state, model, x, margin, inside = case
    assert inside > 0.5
    want = jax.jit(lambda p, s, x, m: jax_forward(Ctx(p, s, train=False, fused=False),
                                                  x, m, jspec))(params, state, x, margin)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(margin))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.isfinite(w).all()
        peak = np.abs(w).max()
        np.testing.assert_allclose(g.numpy() / peak, w / peak, rtol=0, atol=1e-3)


def test_decoded_eval_step_matches_jax(case):
    jspec, params, state, model, x, margin, inside = case
    assert inside > 0.5
    want = jax_decoded_step(jspec, fused=False)(
        params, state, {"inputs": jnp.asarray(x), "margin": jnp.asarray(margin)})
    coords, maxvals, raw = (np.asarray(a) for a in want)
    step = make_decoded_eval_step(model)
    got = [a.numpy() for a in step(torch.from_numpy(x), torch.from_numpy(margin))]
    with torch.no_grad():
        heat = model(torch.from_numpy(x), torch.from_numpy(margin))[0].numpy()
    flat = np.sort(heat.transpose(0, 3, 1, 2).reshape(*maxvals.shape[:2], -1), axis=-1)
    clear = (flat[..., -1] - flat[..., -2]) > 1e-3
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[0][clear], coords[clear])
    np.testing.assert_array_equal(got[2][clear], raw[clear])
    peak = np.abs(maxvals).max()
    np.testing.assert_allclose(got[1] / peak, maxvals / peak, rtol=0, atol=1e-3)


def test_launch_counters_follow_the_dispatch(case):
    _, _, _, model, x, margin, _ = case
    for mod in (fused_attn, fused_mlp, deform_conv):
        mod.calls = mod.launches = 0
    with torch.no_grad():
        model(torch.from_numpy(x), torch.from_numpy(margin))
    assert (fused_attn.calls, fused_mlp.calls, deform_conv.calls) == (4, 6, 1)
    assert (fused_attn.launches, fused_mlp.launches, deform_conv.launches) == (0, 0, 0)
    with torch.no_grad():
        model(torch.from_numpy(x), torch.from_numpy(margin), fused=False)
    assert (fused_attn.calls, fused_mlp.calls, deform_conv.calls) == (4, 6, 2)


def test_prepare_eval_params_casts_jax_style_weights_only():
    _, model = build_model(tiny_otpose_cfg(), device="cpu")
    prepare_eval_params(model, torch.bfloat16)
    dtypes = {k: p.dtype for k, p in model.named_parameters()}
    assert dtypes["rough_pose_estimation_net.conv1.weight"] == torch.bfloat16
    assert dtypes["temporal_encoder1.stem.0.attn.query_conv.weight"] == torch.bfloat16
    assert dtypes["temporal_encoder1.stem.0.mlp.0.weight"] == torch.bfloat16
    for k in ("temporal_encoder1.stem.0.ln1.weight", "temporal_encoder1.stem.0.attn.query_norm.bias",
              "temporal_encoder1.stem.0.drop_path_mlp.scale", "rough_pose_estimation_net.bn1.weight",
              "final_layer1.bias"):
        assert dtypes[k] == torch.float32, k
    assert model.temporal_encoder1.pos_embd.dtype == torch.float32
    x = torch.randn(1, 64, 64, 15)
    coords, maxvals, raw = make_decoded_eval_step(model, compute_dtype="bfloat16")(
        x, torch.zeros(1, 4))
    assert coords.shape == (1, 17, 2) and torch.isfinite(maxvals).all()
