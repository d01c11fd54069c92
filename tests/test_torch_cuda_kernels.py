"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes the flagship path does not reach (tails of the T
tiles, T shorter than a tile, other widths, head counts and dilation counts;
for the DCN both rounding modes of its one kernel, both copy paths, both
gather paths, and the split-stage path of the flagship at B = 1; the DCN's
backward kernel against the plain version's autograd at ragged shapes (H W
not a multiple of its tile, rows of x not a multiple of 16 bytes, O other
than 17, B = 1 and 3, planes too large for shared memory, every sample
outside the image), bit-equal from call to call in every gradient, and
marking the planes that a non-finite gradient reaches; the kernels without a
backward refusing grad).

Needs a CUDA device and nvcc; skips elsewhere.  On a machine with the card
(which need not have JAX), run without the repository's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda --noconftest
"""

import math

import pytest
import torch

from otpose_tpu_torch.ops.cuda import (build, deform_conv, deform_conv_fused, fused_attn,
                                       fused_mlp, token_shift)
from otpose_tpu_torch.utils.testing import dcn_case, dcn_gradients, dcn_inside_share

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
@pytest.mark.parametrize("b,t", [(1, 6912), (3, 1000)])
def test_fused_attn_gives_the_same_bits_every_call(b, t, dtype):
    """The blocks' partial score sums are added in split order, not by
    atomics: two calls are bit-equal (B = 1 splits T over the most blocks)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    args = _attn_args(b, 136, t, 2, dtype, gen)
    first = fused_attn.fused_attn_ct(*args)
    assert all(torch.equal(fused_attn.fused_attn_ct(*args), first) for _ in range(3))


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
    assert [k for k in build._libs if "deform" in str(k) and k != "deform_conv_bwd"] == [
        "deform_conv"]


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


GRAD_NAMES = ("x", "offsets", "masks", "weights", "biases")


def _grad_groups(grads, d):
    return [grads[0], torch.cat([g.flatten() for g in grads[1:1 + d]]),
            torch.cat([g.flatten() for g in grads[1 + d:1 + 2 * d]]), grads[-2], grads[-1]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,o,h,w,dilations", [
    (1, 17, 17, 13, 11, (3, 6, 9, 12, 15)),   # B = 1, D = 5; rows of 11: not 16-byte aligned
    (3, 5, 4, 9, 7, (2,)),                      # B = 3, D = 1, O = 4, odd H and W
    (3, 17, 4, 31, 29, (1, 3, 5, 7, 9)),        # a ragged last tile
    (1, 4, 17, 96, 72, (3, 6)),                 # flagship rows
    (2, 3, 32, 8, 8, tuple(range(1, 9))),       # O = 32, D = 8
    (1, 17, 17, 96, 72, (3, 6, 9, 12, 15)),     # the flagship at B = 1: many blocks a plane
    (3, 17, 17, 96, 72, (3, 6, 9, 12, 15)),     # B = 3: planes cut between blocks
    (2, 6, 9, 40, 24, (2, 4)),                  # H W = 960, not a multiple of the tile; O = 9
    (2, 6, 17, 37, 53, (1, 5, 9)),              # ragged tile and rows of 53: element copies
    (1, 2, 5, 208, 208, (1, 2)),                # planes too large for shared memory
])
def test_deform_conv_backward_matches_plain_autograd(b, c, o, h, w, dilations, dtype):
    """The backward kernel against the plain version's autograd: each of the
    five gradients to 1e-4 (f32) or 5e-2 (bf16) of its peak, at offsets
    calibrated so that samples land near their taps (on the small images
    with dilations up to 15, a third of them inside; most at the flagship's
    96 x 72)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    args = dcn_case(b, c, o, h, w, dilations, dtype, gen)
    assert dcn_inside_share(args) > 0.25
    g = torch.randn(b, o, h, w, generator=gen, device="cuda").to(dtype)
    launches = deform_conv.bwd_launches
    got = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
    want = dcn_gradients(deform_conv.modulated_deform_conv_multi_plain, args, g)
    torch.cuda.synchronize()
    assert deform_conv.bwd_launches == launches + 1
    d = len(dilations)
    for name, gk, gp in zip(GRAD_NAMES, _grad_groups(got, d), _grad_groups(want, d)):
        assert gk.dtype == gp.dtype and gk.shape == gp.shape, name
        err = (gk.float() - gp.float()).abs().max().item()
        peak = gp.float().abs().max().item()
        assert peak > 0 and err <= TOL[dtype] * peak, (name, err, peak)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_conv_backward_samples_outside_the_image(dtype):
    """Every sample far outside the image: d x, d offsets, d masks and d W are
    zero, d bias is g's sum over D, as the plain version's autograd has it."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    x, offs, masks, weights, biases, dil = dcn_case(3, 5, 17, 33, 40, (3, 6), dtype, gen)
    offs = [(t.float() + 500.0).to(dtype) for t in offs]
    args = (x, offs, masks, weights, biases, dil)
    g = torch.randn(3, 17, 33, 40, generator=gen, device="cuda").to(dtype)
    got = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
    want = dcn_gradients(deform_conv.modulated_deform_conv_multi_plain, args, g)
    for name, gk, gp in zip(GRAD_NAMES[:4], _grad_groups(got, 2)[:4], _grad_groups(want, 2)[:4]):
        assert not gk.any() and not gp.any(), name
    _close(got[-1], want[-1], torch.float32)


@pytest.mark.parametrize("b,h,w", [(2, 96, 72), (1, 208, 208)])
def test_deform_conv_backward_weights_are_deterministic(b, h, w):
    """Every gradient is the same bits from call to call: d offset and d mask
    have one writer, d W and d bias are sums in a fixed order, and d x is an
    exact fixed-point sum (in shared memory, or in device memory for planes
    too large for it)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    args = dcn_case(b, 17, 17, h, w, (3, 6, 9, 12, 15), torch.bfloat16, gen)
    g = torch.randn(b, 17, h, w, generator=gen, device="cuda").to(torch.bfloat16)
    first = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
    second = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_deform_conv_backward_marks_planes_that_a_non_finite_gradient_reaches():
    """A NaN in the output's gradient of item 0 makes that item's d x NaN in
    the planes it reaches; item 1's gradients stay as the plain version's."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    args = dcn_case(2, 5, 17, 24, 32, (1, 2), torch.float32, gen)
    g = torch.randn(2, 17, 24, 32, generator=gen, device="cuda")
    g[0, 3, 10, 12] = float("nan")
    got = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
    want = dcn_gradients(deform_conv.modulated_deform_conv_multi_plain, args, g)
    assert torch.isnan(got[0][0]).any() and torch.isnan(want[0][0]).any()
    _close(got[0][1], want[0][1], torch.float32)
    for gk, gp in zip(got[1:3], want[1:3]):
        _close(gk[1], gp[1], torch.float32)


def test_deform_conv_under_grad_with_a_pack_returns_no_weight_gradient():
    gen = torch.Generator(device="cuda").manual_seed(13)
    x, offs, masks, weights, biases, dil = dcn_case(1, 3, 4, 9, 7, (1, 2), torch.float32, gen)
    pk = deform_conv.pack_dcn_weights(weights, biases)
    x.requires_grad_()
    out = deform_conv.modulated_deform_conv_multi(x, offs, masks, dilations=dil, packed=pk)
    out.sum().backward()
    xp = x.detach().clone().requires_grad_()
    deform_conv.modulated_deform_conv_multi_plain(xp, offs, masks, weights, biases,
                                                  dil).sum().backward()
    _close(x.grad, xp.grad, torch.float32)


def test_kernels_without_backward_refuse_grad():
    """F1: on a CUDA tensor under grad the fused attention, fused MLP and
    token shift raise (they have no backward); under no_grad they run."""
    gen = torch.Generator(device="cuda")
    args = _attn_args(1, 32, 40, 2, torch.float32, gen)
    margs = _mlp_args(1, 32, 40, torch.float32, gen)
    shift = torch.randn(4, 64, device="cuda")
    for fn, x, rest in ((fused_attn.fused_attn_ct, args[0], args[1:]),
                        (fused_mlp.fused_mlp_residual_ct, margs[0], margs[1:]),
                        (token_shift.token_shift, shift, ["right"])):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(x.clone().requires_grad_(), *rest)
        with torch.no_grad():
            fn(x.clone().requires_grad_(), *rest)
    weight = margs[3].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fused_mlp.fused_mlp_residual_ct(margs[0], *margs[1:3], weight, *margs[4:])


def test_train_mode_block_takes_the_plain_path():
    """The block gate has JAX's ``not train`` term: a train-mode block on
    the card launches neither fused kernel, and its gradients reach every
    parameter."""
    from otpose_tpu_torch.models import blocks

    blk = blocks.TransformerBlock(136, 2, 1, path_pdrop=0.1, proj_pdrop=0.1).cuda().train()
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0, 0.1)
    launches = (fused_attn.launches, fused_mlp.launches)
    blk(torch.randn(2, 136, 96, device="cuda")).sum().backward()
    assert (fused_attn.launches, fused_mlp.launches) == launches
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in blk.parameters())


# L not a multiple of a 16-byte vector, L odd (the 16-byte boundary moves from
# row to row), L shorter than one vector, R = 1, one chunk of a row and many,
# more rows than the grid's 65535, and a row longer than 65535 vectors
SHIFT_SHAPES = [(1, 1), (3, 1), (1, 2), (1, 7), (2, 7), (1, 8), (3, 9), (16, 250), (16, 256),
                (3, 6911), (5, 1000), (5, 129), (7, 4099), (1, 6912), (70000, 24), (3, 600001)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHIFT_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_token_shift_equals_plain(shape, dtype):
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    for mode in token_shift.MODES:
        got = token_shift.token_shift(x, mode)
        torch.cuda.synchronize()
        assert torch.equal(got, token_shift.token_shift_plain(x, mode)), mode


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 3, 4, 8])
def test_token_shift_on_a_view_that_starts_off_a_16_byte_boundary(offset, dtype):
    """A contiguous view whose first element is not where its output's is,
    relative to a 16-byte boundary, takes the element-wise kernel (an offset
    of 16 bytes takes the vector kernel again)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in ((5, 129), (16, 250), (2, 7), (64, 6912)):
        base = torch.randn(shape[0] * shape[1] + 16, generator=gen, device="cuda").to(dtype)
        x = base[offset:offset + shape[0] * shape[1]].view(*shape)
        assert x.is_contiguous()
        for mode in token_shift.MODES:
            got = token_shift.token_shift(x, mode)
            torch.cuda.synchronize()
            assert torch.equal(got, token_shift.token_shift_plain(x, mode)), (shape, mode)


def test_token_shift_under_a_cuda_graph_and_on_a_side_stream():
    x = torch.randn(64, 6912, device="cuda").to(torch.bfloat16)
    want = token_shift.token_shift_plain(x, "rotate")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = token_shift.token_shift(x, "rotate")
    side.synchronize()
    assert torch.equal(got, want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = token_shift.token_shift(x, "rotate")
    x.copy_(torch.randn(64, 6912, device="cuda"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, token_shift.token_shift_plain(x, "rotate"))


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


def test_registered_ops_pass_opcheck_on_the_card():
    """Each ``otpose::`` op on CUDA tensors: schema and aliasing, the fake
    implementation against the kernel, the DCN's autograd (the backward
    kernel) and an AOT trace with dynamic shapes."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16):
        a = _attn_args(2, 48, 100, 2, dtype, gen)
        pk = fused_attn.pack_attn_weights(*a[1:-1], dtype)
        torch.library.opcheck(fused_attn.fused_attn_op, (a[0], pk.ln1_w, pk.ln1_b, pk.dw, pk.nw,
                                                         pk.nb, pk.pw, pk.pb, 2))
        m = _mlp_args(2, 48, 100, dtype, gen)
        pm = fused_mlp.pack_mlp_weights(*m[1:], dtype)
        torch.library.opcheck(fused_mlp.fused_mlp_op, (m[0], pm.ln_w, pm.ln_b, pm.w1, pm.b1,
                                                       pm.w2, pm.b2, pm.hid))
        torch.library.opcheck(token_shift.token_shift_op,
                              (torch.randn(5, 129, device="cuda").to(dtype), "rotate"))
        x, offs, masks, weights, biases, dil = dcn_case(2, 17, 17, 24, 20, (3, 6), dtype, gen)
        pd = deform_conv.pack_dcn_weights(weights, biases)
        torch.library.opcheck(deform_conv_fused.deform_conv_fused_op,
                              (x, offs, masks, pd.w, pd.bias, list(dil), pd.o))
        leaves = [t.clone().requires_grad_() for t in (x, *offs, *masks)]
        d = len(dil)
        torch.library.opcheck(deform_conv.deform_conv_op,
                              (leaves[0], leaves[1:1 + d], leaves[1 + d:], pd.w, pd.bias,
                               weights.clone().requires_grad_(),
                               biases.clone().requires_grad_(), list(dil), pd.o))


def test_exported_program_on_the_card_equals_the_live_step(tmp_path):
    """The tiny decoded eval step traced on the card: loaded back it calls
    the kernels (4 / 6 / 1 launches) and equals the live step bit for bit;
    loaded on the CPU it runs the plain versions."""
    from otpose_tpu_torch.engine.export import export_eval, load_exported, save_exported
    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

    spec, model = build_model(tiny_otpose_cfg(image_size=32, heatmap_size=8))
    out = save_exported(str(tmp_path / "art"), export_eval(model, batch_size=2), spec,
                        batch_size=2, compute_dtype=torch.float32, flip=False, decoded=True)
    loaded = load_exported(out)
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn(2, 32, 32, 15, generator=gen, device="cuda")
    margin = torch.ones(2, 4, device="cuda")
    launches = (fused_attn.launches, fused_mlp.launches, deform_conv.launches)
    got = loaded(x, margin)
    torch.cuda.synchronize()
    assert (fused_attn.launches - launches[0], fused_mlp.launches - launches[1],
            deform_conv.launches - launches[2]) == (4, 6, 1)
    want = make_decoded_eval_step(model)(x, margin)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    on_cpu = load_exported(out, device="cpu")(x.cpu(), margin.cpu())
    assert all(t.device.type == "cpu" and t.shape == w.shape for t, w in zip(on_cpu, want))
