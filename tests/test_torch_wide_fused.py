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
  from the pack against the plain version from the raw weights;
- the predicates: every C from 32 to 1100 with heads that divide it in both
  dtypes (the MLP to 1152 padded channels), and which path a shape takes;
- ``tiny_otpose_cfg(num_joints=21)`` (temporal encoders of 168 channels)
  against JAX's forward with ``fused=True`` (Pallas in interpret mode): the
  seven outputs to 1e-3 of each output's peak, the port's op calls equal to
  the Pallas calls JAX's gate makes.

The CUDA kernels themselves are held against the same plain versions on
the card by ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

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
from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp
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
    """The packs past 160 channels keep the narrow layout: C zero-padded to
    the mma depth, H to 32, f32 W2 in ``HIDDEN_ORDER``.  On the CPU each op
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
    w2p = fused_mlp.unpermute_hidden(pk.w2) if dtype == F32 else pk.w2
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
    for mod in (fused_attn, fused_mlp, deform_conv):
        mod.calls = 0
    with torch.no_grad():
        got = case["model"](torch.from_numpy(case["x"]), torch.from_numpy(case["margin"]))
    assert (jattn.call_count, jmlp.call_count) == (4, 6)
    assert (fused_attn.calls, fused_mlp.calls) == (jattn.call_count, jmlp.call_count)
    assert deform_conv.calls == 1
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.isfinite(w).all()
        peak = np.abs(w).max()
        np.testing.assert_allclose(g.numpy() / peak, w / peak, rtol=0, atol=1e-3)
