"""The split TF32 arithmetic of the f32 fused kernels, emulated on the CPU
(``otpose_tpu_torch/ops/cuda/tf32.py``): the split's bits and error, the
three-pass product against an f64 product at the kernels' sum lengths, the
fused MLP's f32 pack order (W2's hidden columns permuted inside each group of
8 so that the first product's C fragment is the second's A fragment), and the
whole MLP tail in split TF32 against f64 at the flagship width.
"""

import math

import numpy as np
import pytest
import torch

from otpose_tpu_torch.ops import ct
from otpose_tpu_torch.ops.cuda import fused_mlp, tf32


def _values(seed, n=4096):
    """f32 values of both signs over exponents from 2^-60 to 2^60."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n) * np.exp2(rng.uniform(-60, 60, n))
    return torch.from_numpy(x.astype(np.float32))


def test_round_tf32_keeps_ten_mantissa_bits_rounding_to_nearest():
    x = _values(0)
    hi = tf32.round_tf32(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()          # 13 low bits clear
    rel = ((hi.double() - x.double()).abs() / x.double().abs())
    assert rel.max().item() <= 2.0 ** -11                       # half a TF32 ulp
    # ties go away from zero: 1 + 2^-11 lies halfway between 1 and 1 + 2^-10
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12], dtype=torch.float32)
    assert tf32.round_tf32(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0]
    special = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan])
    out = tf32.round_tf32(special)
    assert out[:4].tolist() == [0.0, -0.0, math.inf, -math.inf] and math.isnan(out[4])


def test_split_error_is_within_2_to_the_minus_21():
    x = _values(1)
    hi, lo = tf32.split_tf32(x)
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    # one TF32 value alone misses by up to 2^-11
    assert ((x.double() - hi.double()).abs() / x.double().abs()).max().item() > 2.0 ** -13


@pytest.mark.parametrize("k", [136, 544, 6912])
def test_three_passes_are_f32_accurate_and_beat_one_by_10x(k):
    """K = 136 (the projections, the MLP's first product), 544 (its second),
    6912 (the attention's scores, summed over T)."""
    rng = np.random.RandomState(k)
    a = torch.from_numpy(rng.randn(24, k).astype(np.float32))
    b = torch.from_numpy(rng.randn(k, 40).astype(np.float32))
    want = a.double() @ b.double()
    scale = max(1.0, want.abs().max().item())        # the cuda tests' scale
    err3 = (tf32.matmul_3xtf32(a, b).double() - want).abs().max().item()
    err1 = (tf32.matmul_tf32(a, b).double() - want).abs().max().item()
    assert err3 <= 1e-4 * scale, (err3, scale)
    assert err1 >= 10 * err3, (err1, err3)


def test_hidden_order_is_a_permutation_the_plain_version_undoes():
    order = fused_mlp.HIDDEN_ORDER
    assert sorted(order) == list(range(8))
    # lane (g, q) holds hidden 2q and 2q + 1 of a C fragment; the A fragment
    # wants them at k positions q and q + 4
    assert all(order[q] == 2 * q and order[q + 4] == 2 * q + 1 for q in range(4))
    w = torch.arange(3 * 32, dtype=torch.float32).reshape(3, 32)
    p = fused_mlp.permute_hidden(w)
    assert not torch.equal(p, w) and torch.equal(fused_mlp.unpermute_hidden(p), w)
    for s in range(4):                                 # each group of 8 stays in place
        assert torch.equal(p[:, 8 * s:8 * s + 8].sort(dim=1).values, w[:, 8 * s:8 * s + 8])


@pytest.mark.parametrize("c", [136, 40, 37])
def test_packed_w2_consumes_the_gelu_tile_where_it_was_computed(c):
    """The second product as the kernel runs it: the GELU tile h (tokens x
    hidden) read in C-fragment order (A[:, k] = h[:, 8 s + order[k]]) against
    the packed W2 equals h @ W2^T; and the wrapper on the CPU, from the pack,
    equals the plain version from the raw weights, bit for bit."""
    rng = np.random.RandomState(c)
    hid = 4 * c
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    ln_w, ln_b, w1, b1 = 1 + 0.1 * f(c), 0.1 * f(c), f(hid, c, 1) / c ** 0.5, 0.1 * f(hid)
    w2, b2 = f(c, hid, 1) / hid ** 0.5, 0.1 * f(c)
    pk = fused_mlp.pack_mlp_weights(ln_w, ln_b, w1, b1, w2, b2, torch.float32)
    hp = pk.w2.shape[1]
    h = torch.zeros(16, hp, dtype=torch.float64)
    h[:, :hid] = f(16, hid).double()
    cols = [8 * s + k for s in range(hp // 8) for k in fused_mlp.HIDDEN_ORDER]
    got = h[:, cols] @ pk.w2.double().T
    assert torch.allclose(got[:, :c], h[:, :hid] @ w2[:, :, 0].double().T, rtol=0, atol=1e-12)
    x = f(2, c, 29)
    want = fused_mlp.fused_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2)
    assert torch.equal(fused_mlp.fused_mlp_residual_ct(x, packed=pk), want)
    assert torch.equal(fused_mlp.fused_mlp_residual_ct(x, ln_w, ln_b, w1, b1, w2, b2), want)


def test_mlp_tail_in_split_tf32_meets_the_f64_bar():
    """LN, both products in three TF32 passes, exact GELU and the residual at
    the flagship width (C = 136, hidden 544) against the same tail in f64,
    within 1e-4 of the scale (the bar chip_smoke.py holds the kernel to)."""
    rng = np.random.RandomState(5)
    c, hid, t = 136, 544, 96
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    x, ln_w, ln_b = f(c, t), 1 + 0.1 * f(c), 0.1 * f(c)
    w1, b1, w2, b2 = f(hid, c) / c ** 0.5, 0.1 * f(hid), f(c, hid) / hid ** 0.5, 0.1 * f(c)

    def tail(mm, x, ln_w, ln_b, w1, b1, w2, b2):
        n = ct.layer_norm_ct(x[None], ln_w, ln_b)[0]
        return x + mm(w2, ct.gelu(mm(w1, n) + b1[:, None])) + b2[:, None]

    want = tail(torch.matmul, *(a.double() for a in (x, ln_w, ln_b, w1, b1, w2, b2)))
    got = tail(tf32.matmul_3xtf32, x, ln_w, ln_b, w1, b1, w2, b2)
    one = tail(tf32.matmul_tf32, x, ln_w, ln_b, w1, b1, w2, b2)
    scale = max(1.0, want.abs().max().item())
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-4 * scale, (err, scale)
    assert (one.double() - want).abs().max().item() >= 10 * err
