"""The port's fused-sampling DCN vs the TPU experiment it replaces.

``ops/cuda/deform_conv_fused.py``'s plain version (what the wrapper runs
for a CPU tensor) against ``tools/exp_deform_pallas3.py::make_pallas3`` in
Pallas interpret mode, and against the shipped DCN's plain version.  The
CUDA kernel is held against the same plain version on the card by
chip_smoke.py and tests/test_torch_cuda_kernels.py.
"""

import contextlib
import importlib.util
import io
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu_torch.ops.cuda import deform_conv, deform_conv_fused
from otpose_tpu_torch.tools import exp_deform_fused
from otpose_tpu_torch.utils import profiling

from tests.helpers.torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ROOT = pathlib.Path(__file__).resolve().parents[1]
B, H, W, G, PT, DILS = 2, 8, 6, 3, 24, (1, 2)


@pytest.fixture(scope="module")
def pallas3():
    spec = importlib.util.spec_from_file_location(
        "exp_deform_pallas3_tpu", ROOT / "tools" / "exp_deform_pallas3.py")
    mod = importlib.util.module_from_spec(spec)
    with contextlib.redirect_stdout(io.StringIO()):
        spec.loader.exec_module(mod)
    return mod.make_pallas3(H, W, G, G, 3, DILS, PT, interpret=True)


def _inputs(seed, offset_scale=2.0):
    """JAX layouts: x (B, H, W, G), offsets (B, H, W, 18G) in (group, tap,
    y/x) order, raw masks (B, H, W, 9G), weights (D, 3, 3, G, O)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, G).astype(np.float32)
    offs = [(rng.randn(B, H, W, 18 * G) * offset_scale).astype(np.float32) for _ in DILS]
    msks = [rng.randn(B, H, W, 9 * G).astype(np.float32) for _ in DILS]
    weights = (rng.randn(len(DILS), 3, 3, G, G) * 0.3).astype(np.float32)
    biases = (rng.randn(len(DILS), G) * 0.1).astype(np.float32)
    return x, offs, msks, weights, biases


def _port_args(x, offs, msks, weights, biases, dtype):
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).to(dtype)  # noqa: E731
    return (nchw(x), [nchw(a) for a in offs], [nchw(a) for a in msks],
            torch.from_numpy(weights.transpose(0, 4, 3, 1, 2).copy()),
            torch.from_numpy(biases), DILS)


def _bf16(a):
    """Round an f32 array to bf16 values, kept as f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("seed,offset_scale", [(0, 2.0), (1, 6.0)])
def test_plain_matches_make_pallas3(pallas3, seed, offset_scale):
    x, offs, msks, weights, biases = _inputs(seed, offset_scale)
    want = np.asarray(pallas3(jnp.asarray(x), [jnp.asarray(a) for a in offs],
                              [jnp.asarray(a) for a in msks], jnp.asarray(weights),
                              jnp.asarray(biases))).transpose(0, 3, 1, 2)
    got = deform_conv_fused.deform_conv_fused(
        *_port_args(x, offs, msks, weights, biases, torch.float32))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_plain_matches_make_pallas3_in_bf16(pallas3):
    """bf16: the y tent weights, each sample and each masked sample are
    rounded where make_pallas3's kernel body rounds them.  XLA drops an
    f32 -> bf16 -> f32 round trip by default (``xla_allow_excess_precision``),
    which skips the rounding of sample * mask, so the oracle is compiled
    with it off.  Both outputs are bf16 and their max difference cannot
    tell rounding schemes apart (row 3's stays within one ulp of the peak),
    so the test counts the outputs that differ: none did when this was
    written, against about half for row 3's plain version on the same
    inputs.  Offsets are rounded to bf16 for both sides (the port's wrapper
    takes them in x's dtype)."""
    x, offs, msks, weights, biases = _inputs(2)
    offs = [_bf16(a) for a in offs]
    jargs = (jnp.asarray(x, jnp.bfloat16), [jnp.asarray(a) for a in offs],
             [jnp.asarray(a, jnp.bfloat16) for a in msks], jnp.asarray(weights),
             jnp.asarray(biases))
    oracle = pallas3.lower(*jargs).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(oracle(*jargs)).astype(np.float32).transpose(0, 3, 1, 2)
    args = _port_args(x, offs, msks, weights, biases, torch.bfloat16)
    got = deform_conv_fused.deform_conv_fused(*args).float().numpy()
    row3 = deform_conv.modulated_deform_conv_multi_plain(*args).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)   # bf16 ulp of the peak
    assert np.abs(got - want).max() <= ulp
    assert (got != want).mean() <= 0.01
    assert (row3 != want).mean() >= 0.2


def test_plain_matches_the_shipped_dcn_in_f32():
    args = _port_args(*_inputs(3), torch.float32)
    got = deform_conv_fused.deform_conv_fused_plain(*args)
    want = deform_conv.modulated_deform_conv_multi_plain(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_cpu_tensor_counts_a_call_but_no_launch():
    args = _port_args(*_inputs(4), torch.float32)
    before = profiling.counters()
    deform_conv_fused.deform_conv_fused(*args)
    grown = profiling.since(before)
    assert (grown["deform_conv_fused.calls"], grown["deform_conv_fused.launches"]) == (1, 0)


def test_tool_check_compares_the_plain_versions_on_the_cpu():
    lines = []
    result = exp_deform_fused.run(batch=1, dtype=torch.float32, device="cpu", check=True,
                                  out=lines.append)
    assert lines[-1] == "check OK"
    assert result["maxdiff"] <= 1e-5 * result["scale"]
