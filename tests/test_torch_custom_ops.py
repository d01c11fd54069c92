"""The kernels as registered ``torch.library`` ops (``otpose::*``), on the
CPU: ``torch.library.opcheck`` on each op (schema and aliasing, the fake
implementation against the real one, the DCN's autograd registration, and
an AOT trace with dynamic shapes), and the DCN op's CPU gradient equal bit
for bit to the plain version's autograd.  Inputs are small and seeded with
numpy."""

import math

import numpy as np
import pytest
import torch

from otpose_tpu_torch.ops.cuda import (deform_conv, deform_conv_fused, fused_attn, fused_mlp,
                                       registry, token_shift)
from otpose_tpu_torch.utils.testing import dcn_gradients

from tests.helpers.torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
BF16 = torch.bfloat16


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))


def _attn_pack(c, dtype, seed):
    rng = np.random.RandomState(seed)
    ln = (1 + 0.1 * _t(rng, c), 0.1 * _t(rng, c))
    dws = [_t(rng, c, 1, 3, scale=0.5) for _ in range(3)]
    norms = [(1 + 0.1 * _t(rng, c), 0.1 * _t(rng, c)) for _ in range(3)]
    projs = [(_t(rng, c, c, 1, scale=1 / math.sqrt(c)), 0.1 * _t(rng, c)) for _ in range(3)]
    return fused_attn.pack_attn_weights(*ln, *dws, *norms[0], *norms[1], *norms[2],
                                        *projs[0], *projs[1], *projs[2], dtype)


def _mlp_pack(c, dtype, seed):
    rng = np.random.RandomState(seed)
    return fused_mlp.pack_mlp_weights(1 + 0.1 * _t(rng, c), 0.1 * _t(rng, c),
                                      _t(rng, 4 * c, c, 1, scale=1 / math.sqrt(c)),
                                      0.1 * _t(rng, 4 * c),
                                      _t(rng, c, 4 * c, 1, scale=1 / math.sqrt(4 * c)),
                                      0.1 * _t(rng, c), dtype)


def _dcn_case(seed, b=1, c=3, o=4, h=5, w=6, dil=(1, 2)):
    rng = np.random.RandomState(seed)
    x = _t(rng, b, c, h, w)
    offs = [_t(rng, b, 18 * c, h, w, scale=1.5) for _ in dil]
    masks = [_t(rng, b, 9 * c, h, w) for _ in dil]
    weights = _t(rng, len(dil), o, c, 3, 3, scale=1 / math.sqrt(9 * c))
    biases = 0.1 * _t(rng, len(dil), o)
    return x, offs, masks, weights, biases, list(dil)


def test_every_kernel_is_a_registered_op():
    for name in registry.OPS:
        assert hasattr(torch.ops.otpose, name), name


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_opcheck_fused_attn(dtype):
    pk = _attn_pack(16, dtype, seed=0)
    x = _t(np.random.RandomState(1), 2, 16, 40).to(dtype)
    torch.library.opcheck(fused_attn.fused_attn_op,
                          (x, pk.ln1_w, pk.ln1_b, pk.dw, pk.nw, pk.nb, pk.pw, pk.pb, 2))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_opcheck_fused_mlp(dtype):
    pk = _mlp_pack(16, dtype, seed=2)
    x = _t(np.random.RandomState(3), 2, 16, 40).to(dtype)
    torch.library.opcheck(fused_mlp.fused_mlp_op,
                          (x, pk.ln_w, pk.ln_b, pk.w1, pk.b1, pk.w2, pk.b2, pk.hid))


@pytest.mark.parametrize("mode", token_shift.MODES)
def test_opcheck_token_shift(mode):
    x = _t(np.random.RandomState(4), 3, 17)
    torch.library.opcheck(token_shift.token_shift_op, (x, mode))


@pytest.mark.parametrize("raw", [True, False], ids=["raw_weights", "pack_only"])
def test_opcheck_deform_conv_with_its_autograd(raw):
    """With the raw weights (the train path: gradients for every input) and
    with the pack alone (inference under grad: gradients for the maps)."""
    x, offs, masks, weights, biases, dil = _dcn_case(5)
    pk = deform_conv.pack_dcn_weights(weights, biases)
    leaves = [t.requires_grad_() for t in (x, *offs, *masks)]
    w, b = (weights.requires_grad_(), biases.requires_grad_()) if raw else (None, None)
    args = (leaves[0], offs, masks, pk.w, pk.bias, w, b, dil, pk.o)
    torch.library.opcheck(deform_conv.deform_conv_op, args)


def test_opcheck_deform_conv_bwd():
    x, offs, masks, weights, biases, dil = _dcn_case(6)
    pk = deform_conv.pack_dcn_weights(weights, biases)
    g = _t(np.random.RandomState(7), 1, 4, 5, 6)
    for w, b in ((weights, biases), (None, None)):
        torch.library.opcheck(deform_conv.deform_conv_bwd_op,
                              (g, x, offs, masks, pk.w, pk.bias, w, b, dil, pk.o))


def test_opcheck_deform_conv_fused():
    x, offs, masks, weights, biases, dil = _dcn_case(8)
    pk = deform_conv.pack_dcn_weights(weights, biases)
    torch.library.opcheck(deform_conv_fused.deform_conv_fused_op,
                          (x, offs, masks, pk.w, pk.bias, dil, pk.o))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dcn_op_gradients_equal_the_plain_autograd(dtype):
    """Every gradient through the op's registered autograd (the CPU
    implementation of ``otpose::deform_conv_bwd``) equals the plain
    version's autograd bit for bit, in f32 and f64 (the train step's f64
    witness runs through the op)."""
    x, offs, masks, weights, biases, dil = _dcn_case(9, b=2, o=3)
    args = tuple(t.to(dtype) for t in (x,)) + ([t.to(dtype) for t in offs],
                                               [t.to(dtype) for t in masks],
                                               weights.to(dtype), biases.to(dtype), dil)
    g = _t(np.random.RandomState(10), 2, 3, 5, 6).to(dtype)
    got = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
    want = dcn_gradients(deform_conv.modulated_deform_conv_multi_plain, args, g)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == dtype and torch.equal(a, b)


def test_ops_raise_on_other_devices():
    x = torch.empty(2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        token_shift.token_shift(x, "right")
