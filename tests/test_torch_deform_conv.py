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
from otpose_tpu_torch.utils import profiling


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
    before = profiling.counters()
    deform_conv.modulated_deform_conv_multi(x, offs, masks, weights, biases, (1,))
    grown = profiling.since(before)
    assert (grown["deform_conv.calls"], grown["deform_conv.launches"]) == (1, 0)


def test_plain_weight_gradients_match_jax():
    """The plain version, which the model's DCN call runs on the CPU when
    autograd needs the DCN parameters, differentiates as the JAX function
    does: the gradients of a weighted sum of the output with respect to the
    weights and biases."""
    import jax

    dilations = (1, 3)
    args = _inputs(np.random.RandomState(2), 2, 3, 4, 7, 6, dilations, 2.0)
    x, offs, masks, weights, biases = args
    r = np.random.RandomState(3).randn(2, 4, 7, 6).astype(np.float32)

    def loss(w, bias):
        y = jax_dcn_multi(*(jnp.asarray(a.transpose(0, 2, 3, 1)) if isinstance(a, np.ndarray)
                            else [jnp.asarray(t.transpose(0, 2, 3, 1)) for t in a]
                            for a in (x, offs, masks)),
                          w, bias, kernel=3, stride=1, padding_list=dilations,
                          dilation_list=dilations, deformable_groups=3)
        return (y * jnp.asarray(r.transpose(0, 2, 3, 1))).sum()

    gw, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(weights.transpose(0, 3, 4, 2, 1)),
                                            jnp.asarray(biases))
    tw = torch.from_numpy(weights).requires_grad_()
    tb = torch.from_numpy(biases).requires_grad_()
    got = deform_conv.modulated_deform_conv_multi(
        torch.from_numpy(x), [torch.from_numpy(t) for t in offs],
        [torch.from_numpy(t) for t in masks], tw, tb, dilations)
    (got * torch.from_numpy(r)).sum().backward()
    want_w = np.asarray(gw).transpose(0, 4, 3, 1, 2)
    np.testing.assert_allclose(tw.grad.numpy(), want_w, rtol=1e-4,
                               atol=1e-4 * np.abs(want_w).max())
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,tiles,sms,stages,split", [
    (1, 14, 132, 85, 19),    # the flagship at B = 1 on 132 SMs: two blocks a SM
    (16, 14, 132, 85, 1),    # the flagship at B = 16: 224 blocks already
    (9, 14, 132, 85, 3),     # 126 blocks leave 6 SMs idle
    (10, 14, 132, 85, 1),    # 140 blocks
    (1, 1, 132, 6, 6),       # at most one block a stage
])
def test_stage_split(b, tiles, sms, stages, split):
    """The wrapper splits the (channel, dilation) stages over blocks only
    when the (item, tile) blocks leave SMs without one."""
    assert deform_conv.stage_split(b, tiles, sms, stages) == split


@pytest.mark.parametrize("b,c,o,h,w,dilations", [
    (2, 3, 4, 9, 8, (1, 2)),
    (1, 17, 17, 12, 10, (1, 2, 3)),     # OTPose's channel count
])
def test_plain_gradients_match_jax(b, c, o, h, w, dilations):
    """All five gradients of the plain version (x, offsets, masks, weights,
    biases) against ``jax.grad`` of the JAX function, to 1e-4 of each
    gradient's peak, at calibrated offsets: most samples inside the image
    and every fractional part in [0.05, 0.95], where the tent function's
    derivative equals the bilinear corners'."""
    import jax

    from otpose_tpu_torch.utils.testing import dcn_case, dcn_gradients, dcn_inside_share

    args = dcn_case(b, c, o, h, w, dilations, torch.float32, torch.Generator().manual_seed(5),
                    device="cpu", reach=2)
    x, offs, masks, weights, biases, _ = args
    assert dcn_inside_share(args) >= 0.5
    frac = torch.cat([t.flatten() for t in offs]).frac().abs()
    assert 0.05 <= float(frac.min()) and float(frac.max()) <= 0.95
    g = np.random.RandomState(6).randn(b, o, h, w).astype(np.float32)
    got = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, torch.from_numpy(g))

    nhwc = lambda a: jnp.asarray(a.numpy().transpose(0, 2, 3, 1))  # noqa: E731

    def loss(xj, oj, mj, wj, bj):
        y = jax_dcn_multi(xj, oj, mj, wj, bj, kernel=3, stride=1, padding_list=dilations,
                          dilation_list=dilations, deformable_groups=c)
        return (y * jnp.asarray(g.transpose(0, 2, 3, 1))).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        nhwc(x), [nhwc(t) for t in offs], [nhwc(t) for t in masks],
        jnp.asarray(weights.numpy().transpose(0, 3, 4, 2, 1)), jnp.asarray(biases.numpy()))
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    d = len(dilations)
    pairs = [("x", got[0], nchw(want[0])),
             ("offsets", torch.stack(got[1:1 + d]), np.stack([nchw(a) for a in want[1]])),
             ("masks", torch.stack(got[1 + d:1 + 2 * d]), np.stack([nchw(a) for a in want[2]])),
             ("weights", got[-2], np.asarray(want[3]).transpose(0, 4, 3, 1, 2)),
             ("biases", got[-1], np.asarray(want[4]))]
    for name, gp, gj in pairs:
        peak = np.abs(gj).max()
        assert peak > 0, name
        np.testing.assert_allclose(gp.numpy(), gj, rtol=0, atol=1e-4 * peak, err_msg=name)
