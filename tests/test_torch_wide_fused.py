"""The fused attention and MLP at the widths past the narrow kernels' 160
channels, which the port's kernels take on their wide paths since the
shapes the JAX package's Pallas kernels take (C >= 32, heads that divide
C) all run fused.  On the CPU, against the JAX package, inputs from numpy
seeds:

- the port's plain ``fused_attn_ct`` and ``fused_mlp_residual_ct`` (what
  the wrappers run for a CPU tensor) against the Pallas kernels in
  interpret mode, as ``tests/test_torch_fused_attn.py`` and
  ``tests/test_torch_fused_mlp.py`` hold them: C = 168 and 208 in two
  heads, one f32 head of 144, T = 256 and a ragged 100; rtol = atol = 1e-5
  in f32, 0.05 in bf16;
- the packs at C = 168 and 1064: shapes, zero padding, values, and the op
  from the pack against the plain version from the raw weights; the f32
  pack's W2 in hidden order past 160 channels (the wide path's layout),
  permuted within them (the narrow kernel's);
- the wide paths' plans (``fused_mlp.wide_plan``, ``fused_attn.wide_plan``,
  ``fused_attn.wide_split``) at C = 168, 208, 1064 and 1152, B = 1 and 2,
  T = 1, 31, 1727 and 6912: every scratch operand's rows whole 16-byte
  units (TMA's rule), the products' tile grids covering their extents, the
  score splits whole K steps;
- the predicates: every C from 32 to 1100 with heads that divide it in both
  dtypes (the MLP to 1152 padded channels), and which path a shape takes;
- ``tiny_otpose_cfg(num_joints=21)`` (temporal encoders of 168 channels)
  against JAX's forward with ``fused=True`` (Pallas in interpret mode): the
  seven outputs to 1e-3 of each output's peak, the port's op calls equal to
  the Pallas calls JAX's gate makes.

The CUDA kernels themselves are held against the same plain versions on
the card by ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.models.core import Ctx
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl, otpose_forward as jax_forward
from otpose_tpu.ops.pallas import fused_attn as jax_attn_mod
from otpose_tpu.ops.pallas import fused_mlp as jax_mlp_mod
from otpose_tpu.ops.pallas.fused_mlp import fused_mlp_residual_ct as jax_fused_mlp
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import load_jax_weights
from otpose_tpu_torch.ops.cuda import fused_attn, fused_mlp
from otpose_tpu_torch.utils import profiling
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import (calibrate_refinement, numpy_weights,  # noqa: F401
                                      one_torch_thread)
from tests.test_torch_fused_attn import _both, _params
from tests.test_torch_fused_mlp import _make, _port_args
from tests.test_torch_kernel_packing import _attn_raw, _block, _mlp_raw

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32, BF16 = torch.float32, torch.bfloat16


def _round_up(n, m):
    return -(-n // m) * m


# ---------------------------------------------------------------- plain vs Pallas

@pytest.mark.parametrize("c,n_head,t", [(168, 2, 256), (208, 2, 256), (168, 2, 100),
                                        (144, 1, 256)])
def test_plain_attention_matches_pallas_f32(c, n_head, t):
    x = np.random.RandomState(c + t).randn(2, c, t).astype(np.float32)
    got, want = _both(_params(c, seed=c), x, n_head, 128 if t % 128 == 0 else t, jnp.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,t", [(168, 256), (208, 100)])
def test_plain_attention_matches_pallas_bf16(c, t):
    x = np.random.RandomState(c).randn(2, c, t).astype(np.float32)
    got, want = _both(_params(c, seed=c + 1), x, 2, 128 if t % 128 == 0 else t, jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


def _mlp_both(c, t, dtype, seed):
    rng = np.random.RandomState(seed)
    p = _make(rng, c)
    x = rng.randn(2, c, t).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    cast = lambda k: jnp.asarray(p[k], jdt)  # noqa: E731
    want = jax_fused_mlp(jnp.asarray(x, jdt), jnp.asarray(p["ln_w"]), jnp.asarray(p["ln_b"]),
                         cast("w1"), cast("b1"), cast("w2"), cast("b2"),
                         t_tile=128 if t % 128 == 0 else t, interpret=True)
    xt = torch.from_numpy(np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))).to(dtype)
    got = fused_mlp.fused_mlp_residual_ct(xt, *_port_args(p, dtype))
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("c,t", [(168, 256), (208, 100)])
def test_plain_mlp_matches_pallas_f32(c, t):
    got, want = _mlp_both(c, t, F32, seed=c)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,t", [(168, 256), (208, 100)])
def test_plain_mlp_matches_pallas_bf16(c, t):
    got, want = _mlp_both(c, t, BF16, seed=c + 1)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


# ---------------------------------------------------------------- packs

@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("c", [168, 1064])
def test_wide_packs_are_exact_and_zero_padded(c, dtype):
    """The packs past 160 channels: C zero-padded to the mma depth, H to 32,
    W2's hidden columns in order in both dtypes (the wide path's products
    read G and W2 with the hidden index in order).  On the CPU each op
    from its pack agrees with the plain version from the raw weights within
    the parity tolerances (the ops multiply by strided views of the padded
    packs, which the CPU's matmul may sum in another order at these
    widths)."""
    blk = _block(c, 2, seed=c)
    cp, hid = _round_up(c, fused_mlp.CHANNEL_ALIGN[dtype]), 4 * c
    hp = _round_up(hid, 32)
    ln_w, ln_b, w1, b1, w2, b2 = _mlp_raw(blk)
    pk = fused_mlp.pack_mlp_weights(ln_w, ln_b, w1, b1, w2, b2, dtype)
    assert pk.w1.shape == (hp, cp) and pk.w2.shape == (cp, hp) and pk.w1.dtype == dtype
    w2p = pk.w2
    assert torch.equal(pk.w1[:hid, :c], w1[:, :, 0].to(dtype))
    assert torch.equal(w2p[:c, :hid], w2[:, :, 0].to(dtype))
    assert not pk.w1[hid:].any() and not pk.w1[:, c:].any()
    assert not w2p[c:].any() and not w2p[:, hid:].any()
    assert not pk.b1[hid:].any() and not pk.b2[c:].any()
    x = torch.from_numpy(np.random.RandomState(c).randn(1, c, 8).astype(np.float32)).to(dtype)
    tol = 1e-5 if dtype == F32 else 5e-2
    with torch.no_grad():
        torch.testing.assert_close(fused_mlp.fused_mlp_residual_ct(x, packed=pk),
                                   fused_mlp.fused_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2),
                                   rtol=tol, atol=tol)

    raw = _attn_raw(blk)
    apk = fused_attn.pack_attn_weights(*raw, dtype)
    assert apk.pw.shape == (3, cp, cp) and apk.pb.shape == (3, cp) and apk.pw.dtype == dtype
    for p, (w, b) in enumerate(((raw[11], raw[12]), (raw[13], raw[14]), (raw[15], raw[16]))):
        assert torch.equal(apk.pw[p, :c, :c], w[:, :, 0].to(dtype))
        assert torch.equal(apk.pb[p, :c], b.to(dtype).float())
    assert not apk.pw[:, c:].any() and not apk.pw[:, :, c:].any() and not apk.pb[:, c:].any()
    with torch.no_grad():
        torch.testing.assert_close(fused_attn.fused_attn_ct(x, packed=apk, n_head=2),
                                   fused_attn.fused_attn_plain(x, *raw, 2), rtol=tol, atol=tol)


@pytest.mark.parametrize("c", [152, 160, 168, 176])
def test_f32_pack_orders_hidden_columns_by_the_path_it_feeds(c):
    """The f32 pack permutes W2's hidden columns (``HIDDEN_ORDER``) for the
    narrow kernel, C padded within 160, and keeps them in order for the
    wide path past it; the CPU op undoes whichever layout the pack took, so
    it agrees with the plain version from the raw weights on both sides of
    the boundary."""
    blk = _block(c, 2, seed=c + 3)
    ln_w, ln_b, w1, b1, w2, b2 = _mlp_raw(blk)
    pk = fused_mlp.pack_mlp_weights(ln_w, ln_b, w1, b1, w2, b2, F32)
    hid = 4 * c
    narrow = _round_up(c, 8) <= fused_mlp.MAX_CHANNELS
    w2p = fused_mlp.unpermute_hidden(pk.w2) if narrow else pk.w2
    assert torch.equal(w2p[:c, :hid], w2[:, :, 0])
    assert torch.equal(pk.w2, fused_mlp.permute_hidden(w2p)) == narrow
    x = torch.from_numpy(np.random.RandomState(c).randn(2, c, 9).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(fused_mlp.fused_mlp_residual_ct(x, packed=pk),
                                   fused_mlp.fused_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- the wide plans

WIDE_SHAPES = [(b, c, t) for c in (168, 208, 1064, 1152) for b in (1, 2)
               for t in (1, 31, 1727, 6912)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,c,t", WIDE_SHAPES)
def test_wide_mlp_plan_covers_every_token_and_channel(b, c, t, dtype):
    """``fused_mlp.wide_plan``: the LN output xn (Cp wide) and G (Hp wide)
    hold a row for each of the B T tokens, every row whole 16-byte units
    (TMA's rule for a row stride), f32 with its lo half and the weights'
    split; the two products' grids of 128 x 128 tiles cover the tokens and
    the hidden units (G) and channels (out), no tile empty."""
    el = 4 if dtype == F32 else 2
    cp = _round_up(c, fused_mlp.CHANNEL_ALIGN[dtype])
    hp = _round_up(4 * c, fused_mlp.HIDDEN_TILE)
    assert fused_mlp.supports(c, dtype) and cp > fused_mlp.MAX_CHANNELS
    plan = fused_mlp.wide_plan(b, c, t, hp, dtype)
    parts = 2 if dtype == F32 else 1
    shapes = plan["shapes"]
    assert shapes["xn"] == (parts, b * t, cp) and shapes["g"] == (parts, b * t, hp)
    assert cp * el % 16 == 0 and hp * el % 16 == 0 and b * t * cp * el % 16 == 0
    assert shapes.get("w") == ((4, hp * cp) if dtype == F32 else None)
    tile = fused_mlp.GEMM_TILE
    for (n_tiles, m_tiles), n in ((plan["grids"]["up"], hp), (plan["grids"]["down"], c)):
        assert (m_tiles - 1) * tile < b * t <= m_tiles * tile
        assert (n_tiles - 1) * tile < n <= n_tiles * tile


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,c,t", WIDE_SHAPES)
def test_wide_attention_plan_covers_every_operand(b, c, t, dtype):
    """``fused_attn.wide_plan`` with ``wide_split``'s splits: y (3, B, T,
    Cp), q and k (2, B, C, Tp) with T padded to 8, v token-major a head a
    row (B, n_head, T, kp), att (B, C, kp), f32 each with its lo half and the weights' split;
    every operand's rows whole 16-byte units and each lo half starting on
    one; the score partials (nsplit, B, C, hs); the splits whole K steps of
    both dtypes' products (64 bf16 or 32 f32 values a 128-byte row) that
    cover T."""
    n_head, el = 2, (4 if dtype == F32 else 2)
    hs = c // n_head
    align = fused_attn.CHANNEL_ALIGN[dtype]
    cp, kp = _round_up(c, align), _round_up(hs, align)
    assert fused_attn.supports(c, n_head, dtype) and not fused_attn.narrow(c, n_head, dtype)
    nsplit, kspan = fused_attn.wide_split(t, hs, b, n_head, 132)
    plan = fused_attn.wide_plan(b, c, t, n_head, nsplit, dtype)
    parts = (2,) if dtype == F32 else (1,)
    tp = plan["qk"][0][-1]
    assert t <= tp < t + 8 and tp * el % 16 == 0
    assert plan["y"] == (parts + (3, b, t, cp), dtype)
    assert plan["qk"] == (parts + (2, b, c, tp), dtype)
    assert plan["vt"] == (parts + (b, n_head, t, kp), dtype)
    assert plan["att"] == (parts + (b, c, kp), dtype)
    assert plan["s"] == ((nsplit, b, c, hs), torch.float32)
    assert plan.get("w") == (((2, 3, cp, cp), dtype) if dtype == F32 else None)
    for shape, _ in plan.values():
        assert shape[-1] * el % 16 == 0 or shape == plan["s"][0]
        assert math.prod(shape[1:]) * el % 16 == 0 or shape == plan["s"][0]
    assert kp >= hs and kspan % 64 == 0 and kspan % fused_attn.SPLIT_TOKENS == 0
    assert (nsplit - 1) * kspan < t <= nsplit * kspan


# ---------------------------------------------------------------- predicates

@pytest.mark.parametrize("dtype", [F32, BF16])
def test_the_predicates_take_every_width_jax_fuses(dtype):
    """``supports`` holds for every C from 32 to 1100 and every head count
    that divides it (JAX's gate: C >= 32, no upper limit); the MLP's stops
    at 1152 padded channels.  ``narrow`` picks the narrow kernels: C padded
    within 160, in f32 one head of at most 136 channels."""
    align = fused_attn.CHANNEL_ALIGN[dtype]
    for c in range(32, 1101):
        assert fused_mlp.supports(c, dtype)
        for n_head in (1, 2, 4, 8, 16):
            if c % n_head:
                assert not fused_attn.supports(c, n_head, dtype)
                continue
            assert fused_attn.supports(c, n_head, dtype)
            hs = c // n_head
            tiles = n_head * -(-hs // 16) * -(-hs // 8)
            assert fused_attn.narrow(c, n_head, dtype) == (
                _round_up(c, align) <= 160 and (dtype == BF16 or tiles <= 160))
    assert fused_mlp.supports(1152, dtype) and not fused_mlp.supports(1153, dtype)
    assert fused_attn.supports(4096, 2, dtype)
    assert fused_attn.narrow(136, 1, dtype) and not fused_attn.narrow(168, 2, dtype)
    assert fused_attn.narrow(144, 1, dtype) == (dtype == BF16)


def test_the_wide_score_split_covers_t_in_whole_steps():
    """``wide_split``: every token in exactly one split, splits a multiple
    of 32 tokens long, none empty."""
    for t in (1, 31, 32, 100, 257, 1728, 6912, 6913):
        for hs, bsz, n_head in ((532, 2, 2), (104, 2, 2), (144, 1, 1), (84, 16, 2)):
            nsplit, kspan = fused_attn.wide_split(t, hs, bsz, n_head, 132)
            assert kspan % fused_attn.SPLIT_TOKENS == 0 and kspan > 0
            assert (nsplit - 1) * kspan < t <= nsplit * kspan


# ---------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def tiny21():
    cfg, jcfg = tiny_otpose_cfg(num_joints=21), jax_tiny_cfg(num_joints=21)
    jspec = JaxSpec.from_cfg(jcfg)
    params, state = numpy_weights(_init_otpose_impl, jspec)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 15).astype(np.float32)
    margin = np.array([[1, 1, 2, 2], [1, 0, 2, 0]], np.float32)
    inside = calibrate_refinement(params, state, x, margin, cfg=cfg)
    _, model = build_model(cfg, device="cpu")
    load_jax_weights(model, params, state)
    return dict(jspec=jspec, params=params, state=state, model=model, x=x, margin=margin,
                inside=inside)


def test_21_joints_match_jax_with_its_pallas_kernels(tiny21):
    """The 168-channel temporal encoders run fused in both packages: JAX's
    gate calls its Pallas kernels (interpret mode here) in every eval block
    of C >= 32, the port's calls its ops in the same blocks (the flow
    encoder, 21 channels, is below 32 in both); the seven outputs agree to
    1e-3 of each output's peak."""
    case = tiny21
    assert case["inside"] > 0.5
    with mock.patch.object(jax_attn_mod, "fused_attn_block_ct",
                           wraps=jax_attn_mod.fused_attn_block_ct) as jattn, \
            mock.patch.object(jax_mlp_mod, "fused_mlp_block_ct",
                              wraps=jax_mlp_mod.fused_mlp_block_ct) as jmlp:
        want = jax.jit(lambda p, s, x, m: jax_forward(Ctx(p, s, train=False, fused=True), x,
                                                      m, case["jspec"]))(
            case["params"], case["state"], case["x"], case["margin"])
    before = profiling.counters()
    with torch.no_grad():
        got = case["model"](torch.from_numpy(case["x"]), torch.from_numpy(case["margin"]))
    grown = profiling.since(before)
    assert (jattn.call_count, jmlp.call_count) == (4, 6)
    assert (grown["fused_attn.calls"], grown["fused_mlp.calls"]) == (jattn.call_count,
                                                                   jmlp.call_count)
    assert grown["deform_conv.calls"] == 1
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.isfinite(w).all()
        peak = np.abs(w).max()
        np.testing.assert_allclose(g.numpy() / peak, w / peak, rtol=0, atol=1e-3)
