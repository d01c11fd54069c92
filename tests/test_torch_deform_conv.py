"""The port's multi-dilation deformable conv vs the JAX package.

``ops/cuda/deform_conv.py``'s plain version (what the wrapper runs for a CPU
tensor: direct bilinear sampling) against the JAX tent-matmul
``modulated_deform_conv_multi``, with one channel per deformable group as
OTPose uses it, atol 1e-4.  The CUDA kernel itself is held against the same
plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.ops.deform_conv import modulated_deform_conv_multi as jax_dcn_multi
from otpose_tpu_torch.ops.cuda import deform_conv


def _inputs(rng, b, c, o, h, w, dilations, offset_scale):
    d = len(dilations)
    x = rng.randn(b, c, h, w).astype(np.float32)
    offs = [(rng.randn(b, 18 * c, h, w) * offset_scale).astype(np.float32) for _ in range(d)]
    masks = [rng.randn(b, 9 * c, h, w).astype(np.float32) for _ in range(d)]  # raw, signed
    weights = rng.randn(d, o, c, 3, 3).astype(np.float32)
    biases = rng.randn(d, o).astype(np.float32)
    return x, offs, masks, weights, biases


def _jax(x, offs, masks, weights, biases, dilations):
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    y = jax_dcn_multi(nhwc(x), [nhwc(a) for a in offs], [nhwc(a) for a in masks],
                      jnp.asarray(weights.transpose(0, 3, 4, 2, 1)), jnp.asarray(biases),
                      kernel=3, stride=1, padding_list=tuple(dilations),
                      dilation_list=tuple(dilations), deformable_groups=x.shape[1])
    return np.asarray(y).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("b,c,o,h,w,dilations,offset_scale", [
    (2, 4, 4, 8, 9, (1,), 2.0),
    (2, 5, 3, 9, 7, (3, 6), 3.0),          # samples far outside: zero padding
    (1, 17, 17, 12, 10, (3, 6, 9), 1.0),   # OTPose's channel count
])
def test_plain_matches_jax(b, c, o, h, w, dilations, offset_scale):
    args = _inputs(np.random.RandomState(0), b, c, o, h, w, dilations, offset_scale)
    want = _jax(*args, dilations)
    x, offs, masks, weights, biases = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else [torch.from_numpy(t) for t in a]
        for a in args)
    got = deform_conv.modulated_deform_conv_multi(x, offs, masks, weights, biases, dilations)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_integer_offsets_hit_pixels_exactly():
    """Offsets that cancel the tap displacement sample the centre pixel:
    with identity weights the output is mask * x plus the mean bias."""
    b, c, h, w, dil = 1, 3, 6, 5, 2
    x = torch.randn(b, c, h, w)
    off = torch.zeros(b, c, 9, 2, h, w)
    for k in range(9):
        off[:, :, k, 0] = -float((k // 3) * dil - dil)
        off[:, :, k, 1] = -float((k % 3) * dil - dil)
    mask = torch.zeros(b, c, 9, h, w)
    mask[:, :, 4] = 0.5
    weight = torch.zeros(1, c, c, 3, 3)
    weight[0, torch.arange(c), torch.arange(c), 1, 1] = 1.0
    bias = torch.arange(c, dtype=torch.float32)[None]
    got = deform_conv.modulated_deform_conv_multi(
        x, [off.reshape(b, 18 * c, h, w)], [mask.reshape(b, 9 * c, h, w)], weight, bias, (dil,))
    torch.testing.assert_close(got, 0.5 * x + bias[0][:, None, None])


def test_cpu_tensor_counts_a_call_but_no_launch():
    args = _inputs(np.random.RandomState(1), 1, 2, 2, 4, 4, (1,), 1.0)
    x, offs, masks, weights, biases = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else [torch.from_numpy(t) for t in a]
        for a in args)
    calls, launches = deform_conv.calls, deform_conv.launches
    deform_conv.modulated_deform_conv_multi(x, offs, masks, weights, biases, (1,))
    assert (deform_conv.calls, deform_conv.launches) == (calls + 1, launches)
