"""Weight packing for the fused kernels and the blocks' cache of packs.

``pack_mlp_weights`` / ``pack_attn_weights`` put a block's weights in the
CUDA kernels' layout once (bf16, C zero-padded to a multiple of 16, biases
rounded, the drop-path scale folded in); ``blocks.mlp_pack`` /
``blocks.attn_pack`` cache the packs on the ``TransformerBlock``.  All of it
is plain torch, so it runs here on the CPU, where the wrappers run their
plain versions from a pack.
"""

import math

import numpy as np
import pytest
import torch

from otpose_tpu_torch.models import blocks
from otpose_tpu_torch.models.otpose import prepare_eval_params
from otpose_tpu_torch.ops.cuda import fused_attn, fused_mlp

BF16 = torch.bfloat16


def _randomize_(module, seed):
    """Weights of std 1/sqrt(fan_in), biases 0.1, norm weights and drop-path
    scales 1 + 0.1 N(0, 1), from numpy."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            shape, owner = tuple(p.shape), name.rsplit(".", 1)[0]
            norm = "norm" in owner or owner.startswith("ln")
            if name.endswith("scale") or (norm and name.endswith("weight")):
                arr = 1 + 0.1 * rng.randn(*shape)
            elif p.dim() >= 2:
                arr = rng.randn(*shape) / math.sqrt(p[0].numel())
            else:
                arr = 0.1 * rng.randn(*shape)
            p.copy_(torch.from_numpy(arr.astype(np.float32)))
    return module


def _block(c, n_head, seed=0):
    return _randomize_(blocks.TransformerBlock(c, n_head, 1, path_pdrop=0.1), seed)


def _mlp_raw(blk):
    return (blk.ln2.weight, blk.ln2.bias, blk.mlp["0"].weight, blk.mlp["0"].bias,
            blk.mlp["3"].weight, blk.mlp["3"].bias)


def _attn_raw(blk):
    a = blk.attn
    return (blk.ln1.weight, blk.ln1.bias, a.query_conv.weight, a.key_conv.weight,
            a.value_conv.weight, a.query_norm.weight, a.query_norm.bias, a.key_norm.weight,
            a.key_norm.bias, a.value_norm.weight, a.value_norm.bias, a.query.weight,
            a.query.bias, a.key.weight, a.key.bias, a.value.weight, a.value.bias)


@pytest.mark.parametrize("c", [32, 40, 136, 160])
def test_mlp_pack_is_exact_and_zero_padded(c):
    blk = _block(c, 2)
    ln_w, ln_b, w1, b1, w2, b2 = _mlp_raw(blk)
    pk = fused_mlp.pack_mlp_weights(ln_w, ln_b, w1, b1, w2, b2, BF16)
    cp, hid = -(-c // 16) * 16, 4 * c
    hp = -(-hid // 32) * 32
    assert (pk.c, pk.hid) == (c, hid)
    assert pk.w1.shape == (hp, cp) and pk.w1.dtype == BF16
    assert pk.w2.shape == (cp, hp) and pk.w2.dtype == BF16
    assert pk.b1.shape == (hp,) and pk.b2.shape == (cp,) and pk.b1.dtype == torch.float32
    assert torch.equal(pk.w1[:hid, :c], w1[:, :, 0].to(BF16))
    assert torch.equal(pk.w2[:c, :hid], w2[:, :, 0].to(BF16))
    assert torch.equal(pk.b1[:hid], b1.to(BF16).float())
    assert torch.equal(pk.b2[:c], b2.to(BF16).float())
    assert torch.equal(pk.ln_w, ln_w.reshape(c)) and torch.equal(pk.ln_b, ln_b.reshape(c))
    for pad in (pk.w1[hid:], pk.w1[:, c:], pk.w2[c:], pk.w2[:, hid:], pk.b1[hid:], pk.b2[c:]):
        assert not pad.any()
    f = fused_mlp.pack_mlp_weights(ln_w, ln_b, w1, b1, w2, b2, torch.float32)
    assert f.w1.shape == (hid, c) and torch.equal(f.w1, w1[:, :, 0])
    assert f.w2.shape == (c, hid) and torch.equal(f.w2, w2[:, :, 0])


@pytest.mark.parametrize("c,n_head", [(136, 2), (64, 4), (48, 1), (32, 2), (40, 1),
                                      (160, 4)])
def test_attn_pack_is_exact_and_zero_padded(c, n_head):
    blk = _block(c, n_head, seed=1)
    raw = _attn_raw(blk)
    pk = fused_attn.pack_attn_weights(*raw, BF16)
    cp = -(-c // 16) * 16
    assert pk.pw.shape == (3, cp, cp) and pk.pw.dtype == BF16 and pk.pb.shape == (3, cp)
    for p, (w, b, dw, nw, nb) in enumerate(((raw[11], raw[12], raw[2], raw[5], raw[6]),
                                           (raw[13], raw[14], raw[3], raw[7], raw[8]),
                                           (raw[15], raw[16], raw[4], raw[9], raw[10]))):
        assert torch.equal(pk.pw[p, :c, :c], w[:, :, 0].to(BF16))
        assert torch.equal(pk.pb[p, :c], b.to(BF16).float())
        assert torch.equal(pk.dw[p], dw.reshape(c, 3).to(BF16).float())
        assert torch.equal(pk.nw[p], nw.reshape(c)) and torch.equal(pk.nb[p], nb.reshape(c))
        assert not pk.pw[p, c:].any() and not pk.pw[p, :, c:].any() and not pk.pb[p, c:].any()
    # on the CPU the wrapper runs the plain version from the pack: the same
    # values as from the raw weights, bit for bit
    x = torch.from_numpy(np.random.RandomState(2).randn(2, c, 37).astype(np.float32)).to(BF16)
    want = fused_attn.fused_attn_plain(x, *raw, n_head)
    assert torch.equal(fused_attn.fused_attn_ct(x, packed=pk, n_head=n_head), want)


def test_drop_path_fold_is_f32_before_the_bf16_rounding():
    c = 136
    rng = np.random.RandomState(3)
    w2 = torch.from_numpy((rng.randn(c, 4 * c, 1) / math.sqrt(4 * c)).astype(np.float32))
    b2 = torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32))
    scale = torch.from_numpy((1 + 0.3 * rng.randn(1, c, 1)).astype(np.float32))
    w1 = torch.zeros(4 * c, c, 1)
    ones, zeros = torch.ones(c), torch.zeros(c)
    pk = fused_mlp.pack_mlp_weights(ones, zeros, w1, torch.zeros(4 * c), w2, b2, BF16,
                                    scale=scale)
    s = scale.reshape(c, 1)
    once = (w2[:, :, 0] * s).to(BF16)
    twice = (w2[:, :, 0].to(BF16).float() * s).to(BF16)
    assert not torch.equal(once, twice)          # the two orders differ on these weights
    assert torch.equal(pk.w2[:c, :4 * c], once)
    assert torch.equal(pk.b2[:c], (b2 * scale.reshape(c)).to(BF16).float())


def test_block_cache_repacks_only_when_a_source_changes():
    blk = _block(40, 2, seed=4)
    first = blocks.mlp_pack(blk, BF16)
    attn_first = blocks.attn_pack(blk, BF16)
    packs = (fused_mlp.packs, fused_attn.packs)
    assert blocks.mlp_pack(blk, BF16) is first
    assert blocks.attn_pack(blk, BF16) is attn_first
    assert (fused_mlp.packs, fused_attn.packs) == packs          # a second call packs nothing

    with torch.no_grad():                                          # in-place update
        blk.mlp["0"].weight.mul_(2)
        blk.attn.key.bias.add_(1)
    second = blocks.mlp_pack(blk, BF16)
    assert second is not first
    assert torch.equal(second.w1[:160, :40], blk.mlp["0"].weight[:, :, 0].to(BF16))
    attn_second = blocks.attn_pack(blk, BF16)
    assert attn_second is not attn_first
    assert torch.equal(attn_second.pb[1, :40], blk.attn.key.bias.to(BF16).float())

    f32 = blocks.mlp_pack(blk, torch.float32)                    # compute dtype change
    assert f32 is not second and f32.dtype == torch.float32
    assert blocks.mlp_pack(blk, BF16) is not f32

    prepare_eval_params(blk, BF16)                                # bf16 weights in place
    assert blk.mlp["0"].weight.dtype == BF16
    third = blocks.mlp_pack(blk, BF16)
    assert third is not f32 and blocks.mlp_pack(blk, BF16) is third
    assert blocks.attn_pack(blk, BF16) is not attn_second

    blk.to(torch.float64)                                         # .to() re-packs too
    assert blocks.mlp_pack(blk, BF16) is not third


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (BF16, 5e-2)])
def test_flagship_block_fused_matches_plain(dtype, tol):
    """A TransformerBlock at the flagship width (C = 136, two heads) on the
    CPU: the fused path (packs, plain versions from them) against the plain
    path, with the parity tolerances of tests/test_torch_fused_*.py."""
    blk = _block(136, 2, seed=5)
    if dtype == BF16:
        prepare_eval_params(blk, BF16)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 136, 48).astype(np.float32))
    x = x.to(dtype)
    with torch.no_grad():
        got = blk(x, fused=True)
        again = blk(x, fused=True)
        want = blk(x, fused=False)
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=tol, atol=tol)
