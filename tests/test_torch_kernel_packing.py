"""Weight packing for the fused kernels and the DCN, and the caches of packs.

``pack_mlp_weights`` / ``pack_attn_weights`` put a block's weights in the
CUDA kernels' layout once (bf16, C zero-padded to a multiple of 16, biases
rounded, the drop-path scale folded in); ``blocks.mlp_pack`` /
``blocks.attn_pack`` cache the packs on the ``TransformerBlock``.
``pack_dcn_weights`` puts the refinement's DCN weights in the DCN kernel's
layout (f32 (D, C, 9, OP), the bias mean over D), which both of its rounding
modes read; ``otpose.dcn_pack`` caches it on the model.  All of it is plain
torch, so it runs here on the CPU, where the wrappers run their plain
versions from a pack.
"""

import math

import numpy as np
import pytest
import torch

from torch import nn

from otpose_tpu_torch.models import blocks
from otpose_tpu_torch.models.otpose import (DeformConvParams, dcn_pack, dcn_weights,
                                            prepare_eval_params)
from otpose_tpu_torch.ops.cuda import deform_conv, deform_conv_fused, fused_attn, fused_mlp

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
    return _randomize_(blocks.TransformerBlock(c, n_head, 1, path_pdrop=0.1), seed).eval()


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


DCN_WRAPPERS = {"exact": deform_conv.modulated_deform_conv_multi,
                "pallas3": deform_conv_fused.deform_conv_fused}


def _dcn_weights(d, o, c, seed):
    rng = np.random.RandomState(seed)
    w = torch.from_numpy((rng.randn(d, o, c, 3, 3) / math.sqrt(9 * c)).astype(np.float32))
    return w, torch.from_numpy((0.1 * rng.randn(d, o)).astype(np.float32))


@pytest.mark.parametrize("mode", ["exact", "pallas3"])
@pytest.mark.parametrize("o,op", [(1, 8), (8, 8), (17, 20), (21, 32), (32, 32)])
def test_dcn_pack_layout(mode, o, op):
    """One layout for both rounding modes: (D, C, 9, OP) f32, row c * 9 + k
    (the mask channel order), zero past O, and the bias mean over D; each
    mode's wrapper on the CPU gives from the pack its raw-weight result."""
    d, c, dil = 2, 3, (1, 2)
    weights, biases = _dcn_weights(d, o, c, seed=o)
    pk = deform_conv.pack_dcn_weights(weights, biases)
    assert (pk.d, pk.c, pk.o) == (d, c, o)
    assert pk.w.shape == (d, c, 9, op) and pk.w.dtype == torch.float32 and pk.w.is_contiguous()
    assert pk.bias.shape == (op,) and pk.bias.dtype == torch.float32
    for dd, oo, cc, ky, kx in ((0, 0, 0, 0, 0), (1, o - 1, c - 1, 2, 1), (1, o // 2, 1, 1, 2)):
        assert pk.w[dd, cc, 3 * ky + kx, oo] == weights[dd, oo, cc, ky, kx]
    assert torch.equal(pk.w[..., :o], weights.permute(0, 2, 3, 4, 1).reshape(d, c, 9, o))
    assert torch.equal(pk.bias[:o], biases.mean(0))
    assert not pk.w[..., o:].any() and not pk.bias[o:].any()
    raw_w, raw_b = deform_conv.unpack(pk)
    assert torch.equal(raw_w, weights) and torch.equal(raw_b.mean(0), biases.mean(0))

    rng = np.random.RandomState(7)
    t = lambda *s, scale=1.0: torch.from_numpy((scale * rng.randn(*s)).astype(np.float32))  # noqa: E731
    x = t(1, c, 5, 6)
    offs = [t(1, 18 * c, 5, 6, scale=2.0) for _ in dil]
    masks = [t(1, 9 * c, 5, 6) for _ in dil]
    wrapper = DCN_WRAPPERS[mode]
    want = wrapper(x, offs, masks, weights, biases, dil)
    assert torch.equal(wrapper(x, offs, masks, dilations=dil, packed=pk), want)


def _refinement(d, c, seed):
    """A stand-in for the model with its refinement's DCN parameters."""
    holder = nn.Module()
    holder.modulated_deform_conv_list = nn.ModuleList([
        nn.ModuleDict({"deform_conv": DeformConvParams(c, c)}) for _ in range(d)])
    weights, biases = _dcn_weights(d, c, c, seed)
    with torch.no_grad():
        for i, m in enumerate(holder.modulated_deform_conv_list):
            m["deform_conv"].weight.copy_(weights[i])
            m["deform_conv"].bias.copy_(biases[i])
    return holder


def test_dcn_cache_repacks_only_when_a_parameter_changes():
    model = _refinement(3, 5, seed=8)
    dcn = [m["deform_conv"] for m in model.modulated_deform_conv_list]
    first = dcn_pack(model)
    packs = deform_conv.packs
    assert dcn_pack(model) is first and deform_conv.packs == packs   # a repeat packs nothing

    with torch.no_grad():                                             # in-place update
        dcn[1].weight.mul_(2)
        dcn[2].bias.add_(1)
    second = dcn_pack(model)
    assert second is not first and deform_conv.packs == packs + 1
    assert torch.equal(second.w[1, :, :, :5],
                       dcn[1].weight.permute(1, 2, 3, 0).reshape(5, 9, 5))
    assert torch.equal(second.bias[:5], torch.stack([m.bias for m in dcn]).mean(0))

    prepare_eval_params(model, BF16)                                  # bf16 weights in place
    assert dcn[0].weight.dtype == BF16
    third = dcn_pack(model)
    assert third is not second and dcn_pack(model) is third
    assert third.w.dtype == torch.float32
    assert torch.equal(third.w[0, :, :, :5],
                       dcn[0].weight.float().permute(1, 2, 3, 0).reshape(5, 9, 5))

    model.to(torch.float64)                                           # .to() re-packs too
    fourth = dcn_pack(model)
    assert fourth is not third and fourth.w.dtype == torch.float32


def test_dcn_weights_follow_autograd():
    """Where autograd would differentiate the DCN parameters the model's
    call takes the raw weights, so every DCN weight and bias gets a gradient
    (on the CPU, through the plain version); under no_grad, or with frozen
    parameters, it takes the cached pack."""
    d, c = 3, 4
    model = _refinement(d, c, seed=9)
    dcn = [m["deform_conv"] for m in model.modulated_deform_conv_list]
    weights, biases, packed = dcn_weights(model)
    assert packed is None and weights.requires_grad and biases.requires_grad
    rng = np.random.RandomState(10)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    dil = (1, 2, 3)
    out = deform_conv.modulated_deform_conv_multi(
        t(1, c, 5, 6), [t(1, 18 * c, 5, 6) for _ in dil], [t(1, 9 * c, 5, 6) for _ in dil],
        weights, biases, dil, packed=packed)
    (out * t(*out.shape)).sum().backward()
    for m in dcn:
        assert m.weight.grad is not None and m.weight.grad.abs().sum() > 0
        assert m.bias.grad is not None and m.bias.grad.abs().sum() > 0

    with torch.no_grad():
        assert dcn_weights(model) == (None, None, dcn_pack(model))
    model.requires_grad_(False)
    assert dcn_weights(model) == (None, None, dcn_pack(model))
