"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes the flagship path does not reach (tails of the T
tiles, T shorter than a tile, other widths, head counts and dilation counts;
for the DCN both rounding modes of its one kernel, both copy paths, both
gather paths, and the split-stage path of the flagship at B = 1).

Needs a CUDA device and nvcc; skips elsewhere.  On a machine with the card
(which need not have JAX), run without the repository's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda --noconftest
"""

import math

import pytest
import torch

from otpose_tpu_torch.ops.cuda import (build, deform_conv, deform_conv_fused, fused_attn,
                                       fused_mlp, token_shift)

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


def _mlp_args(b, c, t, dtype, gen):
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device="cuda") * scale  # noqa: E731
    return [r(b, c, t).to(dtype), 1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1),
            r(4 * c, c, 1, scale=1 / math.sqrt(c)).to(dtype), r(4 * c, scale=0.1).to(dtype),
            r(c, 4 * c, 1, scale=1 / math.sqrt(4 * c)).to(dtype), r(c, scale=0.1).to(dtype)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,t", [(2, 136, 100), (1, 32, 63), (2, 160, 130), (2, 40, 1)])
def test_fused_mlp_matches_plain(b, c, t, dtype):
    args = _mlp_args(b, c, t, dtype, torch.Generator(device="cuda").manual_seed(1))
    got = fused_mlp.fused_mlp_residual_ct(*args)
    torch.cuda.synchronize()
    _close(got, fused_mlp.fused_mlp_plain(*args), dtype)


# the bf16 tensor-core kernels: fused_mlp tiles 48 tokens a block; fused_attn
# walks 32-token chunks and writes att @ v in 64-token tiles
@pytest.mark.parametrize("b,t", [(2, 1), (2, 47), (2, 49), (3, 95), (1, 6912)])
@pytest.mark.parametrize("c", [32, 40, 64, 136, 160])
def test_fused_mlp_bf16_ragged(b, c, t):
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = _mlp_args(b, c, t, torch.bfloat16, gen)
    launches = fused_mlp.launches
    got = fused_mlp.fused_mlp_residual_ct(*args)
    torch.cuda.synchronize()
    assert fused_mlp.launches == launches + 1
    want = fused_mlp.fused_mlp_plain(*args)
    _close(got, want, torch.bfloat16)
    if got.numel() >= 10000:     # the rounding check of chip_smoke.py
        assert (got != want).float().mean().item() <= 0.05


@pytest.mark.parametrize("b,t", [(2, 1), (2, 31), (2, 33), (1, 63), (2, 65), (1, 6912)])
@pytest.mark.parametrize("c,n_head", [(32, 1), (32, 2), (40, 4), (64, 4), (136, 1), (136, 2),
                                      (160, 2), (160, 4)])
def test_fused_attn_bf16_ragged(b, c, t, n_head):
    gen = torch.Generator(device="cuda").manual_seed(6)
    args = _attn_args(b, c, t, n_head, torch.bfloat16, gen)
    got = fused_attn.fused_attn_ct(*args)
    torch.cuda.synchronize()
    _close(got, fused_attn.fused_attn_plain(*args), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_call_equals_raw_call(dtype):
    """The weights packed once give the raw-weight call's result bit for bit
    (attention at T <= 32: one chunk, so the score sum has one order)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    args = _mlp_args(2, 136, 100, dtype, gen)
    pk = fused_mlp.pack_mlp_weights(*args[1:], dtype)
    assert torch.equal(fused_mlp.fused_mlp_residual_ct(args[0], packed=pk),
                       fused_mlp.fused_mlp_residual_ct(*args))
    args = _attn_args(2, 136, 30, 2, dtype, gen)
    pk = fused_attn.pack_attn_weights(*args[1:-1], dtype)
    assert torch.equal(fused_attn.fused_attn_ct(args[0], packed=pk, n_head=2),
                       fused_attn.fused_attn_ct(*args))
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    with pytest.raises(ValueError, match="packed for"):
        fused_attn.fused_attn_ct(args[0].to(other), packed=pk, n_head=2)


# the DCN kernel's two rounding modes, each with its wrapper and plain version
DCN_MODES = {
    "exact": (deform_conv, deform_conv.modulated_deform_conv_multi,
              deform_conv.modulated_deform_conv_multi_plain),
    "pallas3": (deform_conv_fused, deform_conv_fused.deform_conv_fused,
                deform_conv_fused.deform_conv_fused_plain),
}


def _dcn_args(b, c, o, h, w, dilations, dtype, seed, off_scale=3.0, wdtype=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device="cuda") * scale  # noqa: E731
    x = r(b, c, h, w).to(dtype)
    offs = [r(b, 18 * c, h, w, scale=off_scale).to(dtype) for _ in dilations]
    masks = [r(b, 9 * c, h, w).to(dtype) for _ in dilations]
    weights = r(len(dilations), o, c, 3, 3, scale=1 / math.sqrt(9 * c)).to(wdtype or dtype)
    return (x, offs, masks, weights, r(len(dilations), o), dilations)


def _dcn_check(mode, args, dtype):
    module, kern, plain = DCN_MODES[mode]
    launches = module.launches
    got = kern(*args)
    torch.cuda.synchronize()
    assert module.launches == launches + 1
    _close(got, plain(*args), dtype)
    return got


@pytest.mark.parametrize("mode", list(DCN_MODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,o,h,w,dilations", [
    (2, 17, 17, 13, 11, (1,)),
    (1, 5, 3, 9, 7, (3, 6, 9, 12, 15, 18, 21, 24)),   # 8 dilations, few outputs
    (1, 4, 20, 10, 12, (2, 5)),                        # more outputs than inputs
])
def test_deform_conv_matches_plain(mode, b, c, o, h, w, dilations, dtype):
    _dcn_check(mode, _dcn_args(b, c, o, h, w, dilations, dtype, seed=2), dtype)


@pytest.mark.parametrize("mode", list(DCN_MODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,o,h,w,dilations", [
    (2, 17, 17, 13, 11, (1,)),                         # 143 pixels: a ragged last tile
    (1, 5, 3, 9, 7, (3, 6, 9, 12, 15, 18, 21, 24)),   # 8 dilations, few outputs
    (1, 4, 32, 10, 12, (2, 5)),                        # the most outputs a thread holds
])
def test_deform_conv_fused_matches_plain(mode, b, c, o, h, w, dilations, dtype):
    args = _dcn_args(b, c, o, h, w, dilations, dtype, seed=3, wdtype=torch.float32)
    got = _dcn_check(mode, args, dtype)
    if dtype == torch.float32:      # in f32 the two modes are one function
        other = "exact" if mode == "pallas3" else "pallas3"
        _close(got, DCN_MODES[other][1](*args), dtype)


@pytest.mark.parametrize("mode", list(DCN_MODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,o,h,w,dilations", [
    (2, 3, 5, 13, 11, (1, 2, 3)),       # P = 143, not a multiple of 8: element copies
    (1, 6, 9, 9, 7, (2,)),               # P = 63 < one tile, D = 1
    (2, 3, 1, 10, 20, (1, 2, 3)),        # O = 1; 16-byte copies in f32 only
    (2, 3, 5, 11, 24, (1, 2)),           # 16-byte copies in both dtypes, P < one tile
    (1, 2, 32, 8, 16, (1, 2, 3, 4, 5, 6, 7, 8)),   # O = 32, D = 8
    (1, 2, 3, 128, 128, (1, 2)),         # f32 x planes too large: gathers through L1
    (1, 2, 3, 208, 208, (1, 2)),         # bf16 x planes too large too: L1 in both dtypes
    (1, 17, 17, 96, 72, (3, 6, 9, 12, 15)),        # the flagship at B = 1: split stages
])
def test_deform_conv_shapes(mode, b, c, o, h, w, dilations, dtype):
    _dcn_check(mode, _dcn_args(b, c, o, h, w, dilations, dtype, seed=4), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_conv_flagship_b1_takes_the_split_path(dtype):
    """The wrapper's split on this card, from the kernel's tile: at B = 1 the
    flagship's tiles leave SMs idle, so its 85 stages split (19 blocks a
    tile on 132 SMs); at B = 16 they do not.  test_deform_conv_shapes holds
    the split result at B = 1 against the plain version."""
    lib = build.load("deform_conv", deform_conv._SIGNATURES)
    tiles = -(-96 * 72 // lib.otp_deform_tile(build.dtype_code(dtype)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert deform_conv.stage_split(1, tiles, sms, 85) > 1
    assert deform_conv.stage_split(16, tiles, sms, 85) == 1
    if sms == 132:
        assert deform_conv.stage_split(1, tiles, sms, 85) == 19


@pytest.mark.parametrize("mode", list(DCN_MODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_conv_samples_outside_the_image(mode, dtype):
    """Offsets that put every sample outside the image: the output is the
    bias mean, as in the plain version."""
    args = _dcn_args(2, 4, 6, 12, 16, (1, 3), dtype, seed=5)
    x, offs, masks, weights, biases, dil = args
    offs = [torch.where(torch.rand(t.shape, device="cuda") < 0.5, -500.0, 500.0).to(dtype)
            for t in offs]
    args = (x, offs, masks, weights, biases, dil)
    got = _dcn_check(mode, args, dtype)
    assert torch.equal(got, DCN_MODES[mode][2](*args))
    assert torch.equal(got, biases.float().mean(0)[None, :, None, None].expand_as(got).to(dtype))


@pytest.mark.parametrize("b,c,o,h,w,dilations", [
    (1, 17, 17, 96, 72, (3, 6, 9, 12, 15)), (2, 3, 5, 13, 11, (1, 2, 3))])
def test_deform_conv_modes_agree_in_f32(b, c, o, h, w, dilations):
    args = _dcn_args(b, c, o, h, w, dilations, torch.float32, seed=6)
    exact = deform_conv.modulated_deform_conv_multi(*args)
    fused = deform_conv_fused.deform_conv_fused(*args)
    scale = max(1.0, exact.abs().max().item())
    assert (exact - fused).abs().max().item() <= 1e-3 * scale


def test_both_dcn_wrappers_load_one_library():
    args = _dcn_args(1, 3, 4, 8, 8, (1, 2), torch.bfloat16, seed=7)
    deform_conv.modulated_deform_conv_multi(*args)
    deform_conv_fused.deform_conv_fused(*args)
    torch.cuda.synchronize()
    assert "deform_conv_fused" not in build.KERNELS
    assert [k for k in build._libs if "deform" in str(k)] == ["deform_conv"]


@pytest.mark.parametrize("mode", list(DCN_MODES))
def test_dcn_wrappers_refuse_what_the_kernel_does_not_take(mode):
    kern = DCN_MODES[mode][1]
    args = _dcn_args(1, 2, 33, 8, 8, (1,), torch.float32, seed=8)
    with pytest.raises(ValueError, match="O=33"):
        kern(*args)
    args = _dcn_args(1, 2, 4, 8, 8, tuple(range(1, 10)), torch.float32, seed=8)
    with pytest.raises(ValueError, match="D=9"):
        kern(*args)
    x, offs, masks, weights, biases, dil = _dcn_args(1, 2, 4, 8, 8, (1,), torch.float32, seed=8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kern(x.half(), [t.half() for t in offs], [t.half() for t in masks], weights, biases, dil)
    with pytest.raises(ValueError, match="contiguous"):
        kern(x, [offs[0].transpose(2, 3)], masks, weights, biases, dil)


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
