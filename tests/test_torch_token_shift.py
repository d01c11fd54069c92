"""The port's token-shift kernel vs the TPU probe kernels it replaces.

Each mode's plain version (what ``ops/cuda/token_shift.py`` runs for a CPU
tensor) against the matching kernel of ``tools/probe_shift.py``, run with
``pl.pallas_call(..., interpret=True)`` on the probe's own (16, 256) bf16
input and on ragged ones (L not a multiple of a 16-byte vector, L odd, L
shorter than a vector): exact, since both copy values.  The probe module runs its TPU
probes when it is imported; on the CPU they fail and print, so it is
imported with its output captured.  The CUDA kernel is held against the
plain version on the card by chip_smoke.py and
tests/test_torch_cuda_kernels.py.
"""

import contextlib
import importlib.util
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from otpose_tpu_torch.ops.cuda import token_shift
from otpose_tpu_torch.tools import probe_shift

from tests.helpers.torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ROOT = pathlib.Path(__file__).resolve().parents[1]
PROBES = {   # probe kernel -> the mode it computes in interpret mode
    "k_concat": "right", "k_slice_pad": "right", "k_f32_roll": "right",
    "k_scratch_store": "right", "k_unaligned_load": "right",
    "k_bitcast_roll": "rotate", "k_concat_left": "left", "k_masked_sum_col": "handoff",
}


@pytest.fixture(scope="module")
def probes():
    spec = importlib.util.spec_from_file_location("probe_shift_tpu",
                                                  ROOT / "tools" / "probe_shift.py")
    mod = importlib.util.module_from_spec(spec)
    with contextlib.redirect_stdout(io.StringIO()):
        spec.loader.exec_module(mod)
    return mod


def _run_probe(mod, name):
    out_shape = jax.ShapeDtypeStruct(mod.x.shape, jnp.bfloat16)
    y = pl.pallas_call(getattr(mod, name), out_shape=out_shape, interpret=True)(mod.x)
    return torch.from_numpy(np.asarray(y).astype(np.float32)).to(torch.bfloat16)


def _torch_input(mod):
    return torch.from_numpy(np.asarray(mod.x).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("name", sorted(PROBES))
def test_plain_equals_the_probe_kernel(probes, name):
    got = token_shift.token_shift(_torch_input(probes), PROBES[name])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _run_probe(probes, name))


def test_the_right_shift_probes_agree_with_each_other(probes):
    outs = [_run_probe(probes, n) for n, mode in sorted(PROBES.items()) if mode == "right"]
    assert len(outs) == 5
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("shape", [(5, 1), (1, 7), (1, 1), (3, 2), (1, 250), (3, 6911)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_sizes_match_numpy(shape, dtype):
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(np.float32)).to(dtype)
    for mode in token_shift.MODES:
        got = token_shift.token_shift(x, mode).float().numpy()
        np.testing.assert_array_equal(got, probe_shift.numpy_target(x.float().numpy(), mode))


def _run_probe_on(mod, name, x):
    """A probe kernel on another bf16 array: most read the module's shape
    constants, so those are set for the call and put back."""
    old = mod.x, mod.C, mod.L
    mod.x, mod.C, mod.L = x, x.shape[0], x.shape[1]
    try:
        return _run_probe(mod, name)
    finally:
        mod.x, mod.C, mod.L = old


# the shapes that stress the vectorised kernel's edges: L not a multiple of
# 8, L odd, L shorter than one 16-byte vector (rows in pairs: the rotate
# probe packs two bf16 rows into one of int32; R = 1 is held to numpy above)
RAGGED = [(16, 250), (4, 691), (6, 129), (2, 2), (2, 7), (2, 1000)]


@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", sorted(PROBES))
def test_plain_equals_the_probe_kernel_at_ragged_shapes(probes, name, shape):
    x = jnp.asarray(np.random.RandomState(shape[1]).randn(*shape), jnp.bfloat16)
    want = _run_probe_on(probes, name, x)
    xt = torch.from_numpy(np.asarray(x).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(token_shift.token_shift(xt, PROBES[name]), want)


def test_wrapper_refuses_bad_modes_and_shapes():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="mode"):
        token_shift.token_shift(x, "up")
    with pytest.raises(ValueError, match=r"\(R, L\)"):
        token_shift.token_shift(torch.zeros(2, 3, 4), "right")
    with pytest.raises(ValueError, match=r"\(R, L\)"):
        token_shift.token_shift(torch.zeros(2, 0), "right")


def test_cpu_tensor_counts_a_call_but_no_launch():
    calls, launches = token_shift.calls, token_shift.launches
    token_shift.token_shift(torch.zeros(2, 3), "left")
    assert (token_shift.calls, token_shift.launches) == (calls + 1, launches)


def test_the_tool_reports_every_mode_ok_on_the_cpu():
    lines = []
    assert probe_shift.probe("cpu", out=lines.append) == {m: True for m in token_shift.MODES}
    assert lines == [f"{m}: OK" for m in token_shift.MODES]
