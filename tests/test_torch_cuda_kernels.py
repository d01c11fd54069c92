"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes the flagship path does not reach (tails of the T
tiles, T shorter than a tile, other widths, head counts and dilation counts).

Needs a CUDA device and nvcc; skips elsewhere.  On a machine with the card
(which need not have JAX), run without the repository's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda --noconftest
"""

import math

import pytest
import torch

from otpose_tpu_torch.ops.cuda import (deform_conv, deform_conv_fused, fused_attn, fused_mlp,
                                       token_shift)

pytestmark = pytest.mark.cuda

# max|kernel - plain| as a share of max(1, max|plain|); see chip_smoke.py
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= TOL[dtype] * scale, (err, scale)


def _attn_args(b, c, t, n_head, dtype, gen):
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device="cuda") * scale  # noqa: E731
    args = [r(b, c, t).to(dtype), 1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    args += [r(c, 1, 3, scale=0.5).to(dtype) for _ in range(3)]
    for _ in range(3):
        args += [1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    for p in range(3):
        small = p < 2            # keep |S| small: see chip_smoke.attn_case
        args += [r(c, c, 1, scale=(0.25 if small else 1.0) / math.sqrt(c)).to(dtype),
                 r(c, scale=0.01 if small else 0.1).to(dtype)]
    return args + [n_head]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,t,n_head", [
    (2, 136, 100, 2),    # ragged last chunk
    (3, 64, 31, 4),      # T shorter than one chunk
    (1, 48, 257, 1),     # one head, one token past a chunk
    (2, 136, 1728, 2),   # the flagship width at the last branch's length
])
def test_fused_attn_matches_plain(b, c, t, n_head, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = _attn_args(b, c, t, n_head, dtype, gen)
    launches = fused_attn.launches
    got = fused_attn.fused_attn_ct(*args)
    torch.cuda.synchronize()
    assert fused_attn.launches == launches + 1
    _close(got, fused_attn.fused_attn_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,t", [(2, 136, 100), (1, 32, 63), (2, 160, 130), (2, 40, 1)])
def test_fused_mlp_matches_plain(b, c, t, dtype):
    gen = torch.Generator(device="cuda").manual_seed(1)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device="cuda") * scale  # noqa: E731
    args = [r(b, c, t).to(dtype), 1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1),
            r(4 * c, c, 1, scale=1 / math.sqrt(c)).to(dtype), r(4 * c, scale=0.1).to(dtype),
            r(c, 4 * c, 1, scale=1 / math.sqrt(4 * c)).to(dtype), r(c, scale=0.1).to(dtype)]
    got = fused_mlp.fused_mlp_residual_ct(*args)
    torch.cuda.synchronize()
    _close(got, fused_mlp.fused_mlp_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,o,h,w,dilations", [
    (2, 17, 17, 13, 11, (1,)),
    (1, 5, 3, 9, 7, (3, 6, 9, 12, 15, 18, 21, 24)),   # 8 dilations, few outputs
    (1, 4, 20, 10, 12, (2, 5)),                        # more outputs than inputs
])
def test_deform_conv_matches_plain(b, c, o, h, w, dilations, dtype):
    gen = torch.Generator(device="cuda").manual_seed(2)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device="cuda") * scale  # noqa: E731
    x = r(b, c, h, w).to(dtype)
    offs = [r(b, 18 * c, h, w, scale=3.0).to(dtype) for _ in dilations]
    masks = [r(b, 9 * c, h, w).to(dtype) for _ in dilations]
    weights = r(len(dilations), o, c, 3, 3, scale=1 / math.sqrt(9 * c)).to(dtype)
    biases = r(len(dilations), o)
    args = (x, offs, masks, weights, biases, dilations)
    got = deform_conv.modulated_deform_conv_multi(*args)
    torch.cuda.synchronize()
    _close(got, deform_conv.modulated_deform_conv_multi_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,o,h,w,dilations", [
    (2, 17, 17, 13, 11, (1,)),                         # 143 pixels: a ragged last tile
    (1, 5, 3, 9, 7, (3, 6, 9, 12, 15, 18, 21, 24)),   # 8 dilations, few outputs
    (1, 4, 32, 10, 12, (2, 5)),                        # the most outputs a thread holds
])
def test_deform_conv_fused_matches_plain(b, c, o, h, w, dilations, dtype):
    gen = torch.Generator(device="cuda").manual_seed(3)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device="cuda") * scale  # noqa: E731
    x = r(b, c, h, w).to(dtype)
    offs = [r(b, 18 * c, h, w, scale=3.0).to(dtype) for _ in dilations]
    masks = [r(b, 9 * c, h, w).to(dtype) for _ in dilations]
    weights = r(len(dilations), o, c, 3, 3, scale=1 / math.sqrt(9 * c))
    biases = r(len(dilations), o)
    args = (x, offs, masks, weights, biases, dilations)
    launches = deform_conv_fused.launches
    got = deform_conv_fused.deform_conv_fused(*args)
    torch.cuda.synchronize()
    assert deform_conv_fused.launches == launches + 1
    _close(got, deform_conv_fused.deform_conv_fused_plain(*args), dtype)
    if dtype == torch.float32:      # in f32 it is the shipped kernel's function
        _close(got, deform_conv.modulated_deform_conv_multi(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1), (3, 1), (1, 7), (16, 256), (5, 1000)])
def test_token_shift_equals_plain(shape, dtype):
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    for mode in token_shift.MODES:
        got = token_shift.token_shift(x, mode)
        torch.cuda.synchronize()
        assert torch.equal(got, token_shift.token_shift_plain(x, mode)), mode


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(1, 200, 16, device="cuda")
    w = torch.randn(800, 200, 1, device="cuda")
    ln = torch.ones(200, device="cuda")
    with pytest.raises(ValueError, match="C=200"):
        fused_mlp.fused_mlp_residual_ct(x, ln, ln, w, w[:, 0, 0], w.reshape(200, 800, 1),
                                        ln)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        args = _attn_args(1, 32, 8, 2, torch.float32, torch.Generator(device="cuda"))
        fused_attn.fused_attn_ct(args[0].half(), *args[1:])
    args = _attn_args(1, 32, 8, 2, torch.float32, torch.Generator(device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        fused_attn.fused_attn_ct(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                                 *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        token_shift.token_shift(torch.zeros(8, 4, device="cuda").t(), "right")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        token_shift.token_shift(torch.zeros(4, 8, device="cuda", dtype=torch.half), "right")
