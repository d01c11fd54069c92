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
backward refusing grad).  The DCN above 32 outputs or 8 dilations, as a
group of launches, forward and backward (O = 33 and 133 and D = 9 among
them); the fused attention and MLP on their wide paths (C = 168 to 1152,
one f32 head of 144), and the tiny eval at 21 and 33 joints, whose 168- and
264-channel encoders take them, against the CPU.  Also nvJPEG's decode (``csrc/jpeg_nv.cu``) against
the fixture's libjpeg decode, into a staging buffer, its errors, the device
loader that decodes with it, and the detector on the card against the CPU.

Needs a CUDA device and nvcc; skips elsewhere.  On a machine with the card
(which need not have JAX), run without the repository's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda --noconftest
"""

import copy
import math
import os
import shutil

import numpy as np
import pytest
import torch

from otpose_tpu_torch.ops.cuda import (build, deform_conv, deform_conv_fused, fused_attn,
                                       fused_mlp, token_shift)
from otpose_tpu_torch.utils import profiling
from otpose_tpu_torch.utils.testing import dcn_case, dcn_gradients, dcn_inside_share

pytestmark = pytest.mark.cuda

# max|kernel - plain| as a share of max(1, max|plain|); see chip_smoke.py
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _count(module, what: str = "launches") -> int:
    """A kernel's counter so far, ``<module>.<what>`` in ``utils/profiling.py``'s
    registry."""
    return profiling.counters().get(f"{module.__name__.rsplit('.', 1)[-1]}.{what}", 0)


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
    (30, 136, 3072, 2),  # OTPose over ViTPose-H: 64x48 heatmaps, its eval batch
])
def test_fused_attn_matches_plain(b, c, t, n_head, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = _attn_args(b, c, t, n_head, dtype, gen)
    launches = _count(fused_attn)
    got = fused_attn.fused_attn_ct(*args)
    torch.cuda.synchronize()
    assert _count(fused_attn) == launches + 1
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
@pytest.mark.parametrize("b,c,t", [(2, 136, 100), (1, 32, 63), (2, 160, 130), (2, 40, 1),
                                   # OTPose over ViTPose-H: the stem and both branches
                                   (30, 136, 3072), (30, 136, 1536), (30, 136, 768)])
def test_fused_mlp_matches_plain(b, c, t, dtype):
    args = _mlp_args(b, c, t, dtype, torch.Generator(device="cuda").manual_seed(1))
    got = fused_mlp.fused_mlp_residual_ct(*args)
    torch.cuda.synchronize()
    _close(got, fused_mlp.fused_mlp_plain(*args), dtype)


# the tensor-core kernels (bf16, and f32 in split TF32): fused_mlp tiles 48
# tokens a block in bf16, 64 in f32; fused_attn walks 32-token chunks and
# writes att @ v in 64-token tiles.  (The names keep "bf16" from before the
# f32 kernels moved to the tensor cores.)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t", [(2, 1), (2, 47), (2, 49), (2, 63), (2, 65), (3, 95),
                                 (1, 6912)])
@pytest.mark.parametrize("c", [32, 37, 40, 64, 136, 160])
def test_fused_mlp_bf16_ragged(b, c, t, dtype):
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = _mlp_args(b, c, t, dtype, gen)
    launches = _count(fused_mlp)
    got = fused_mlp.fused_mlp_residual_ct(*args)
    torch.cuda.synchronize()
    assert _count(fused_mlp) == launches + 1
    want = fused_mlp.fused_mlp_plain(*args)
    _close(got, want, dtype)
    if dtype == torch.bfloat16 and got.numel() >= 10000:   # chip_smoke.py's rounding check
        assert (got != want).float().mean().item() <= 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t", [(2, 1), (2, 31), (2, 33), (1, 63), (2, 65), (1, 6912)])
@pytest.mark.parametrize("c,n_head", [(32, 1), (32, 2), (40, 4), (64, 4), (136, 1), (136, 2),
                                      (160, 2), (160, 4)])
def test_fused_attn_bf16_ragged(b, c, t, n_head, dtype):
    gen = torch.Generator(device="cuda").manual_seed(6)
    args = _attn_args(b, c, t, n_head, dtype, gen)
    got = fused_attn.fused_attn_ct(*args)
    torch.cuda.synchronize()
    _close(got, fused_attn.fused_attn_plain(*args), dtype)


def test_fused_f32_kernels_meet_an_f64_witness():
    """The f32 kernels at the flagship width against the plain version run
    in f64 from the same f32 inputs, within 1e-4 of the output's peak, at
    O(1) projection weights (|S| in the tens, summed over T = 6912), and
    bit-equal from call to call."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    args = _mlp_args(2, 136, 6912, torch.float32, gen)
    got = fused_mlp.fused_mlp_residual_ct(*args)
    want = fused_mlp.fused_mlp_plain(*(a.double() for a in args))
    _close(got, want, torch.float32)
    assert torch.equal(fused_mlp.fused_mlp_residual_ct(*args), got)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device="cuda") * scale  # noqa: E731
    args = _attn_args(2, 136, 6912, 2, torch.float32, gen)
    for i in (12, 14):                 # q and k projections at the scale of v's
        args[i] = r(136, 136, 1, scale=1 / math.sqrt(136))
    got = fused_attn.fused_attn_ct(*args)
    want = fused_attn.fused_attn_plain(*(a.double() if torch.is_tensor(a) else a for a in args))
    _close(got, want, torch.float32)
    assert torch.equal(fused_attn.fused_attn_ct(*args), got)


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


# the wide paths (C padded past 160; the attention's also one f32 head past
# 136): the temporal encoders at 21 (168), 25 (200), 26 (208) and 133 (1064)
# joints, one head of 144, B = 1 and 2, T ragged against the 32-token tiles
# and the 16-byte vectors, and the flagship's length; then every C of 168,
# 208, 1064 and 1152 at B = 1 and 2 and T = 1, 31, 1727 and 6912 (the
# products' 128-token tiles and 64-token score splits, T not a multiple of
# 8 in the scratch rows)
WIDE_GRID = [(b, c, t) for c in (168, 208, 1064, 1152) for b in (1, 2)
             for t in (1, 31, 1727, 6912)]
WIDE_ATTN = [(2, 168, 100, 2), (1, 200, 257, 2), (2, 208, 6912, 2), (1, 1064, 1000, 2),
             (2, 1064, 77, 2), (1, 144, 300, 1), (2, 144, 6912, 1)] + [
                 (b, c, t, 2) for b, c, t in WIDE_GRID]
WIDE_MLP = [(2, 168, 100), (1, 200, 33), (2, 208, 6912), (1, 1064, 300), (2, 1064, 65),
            (2, 1152, 40), (1, 144, 31)] + WIDE_GRID


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,t,n_head", WIDE_ATTN)
def test_wide_fused_attn_matches_plain(b, c, t, n_head, dtype):
    gen = torch.Generator(device="cuda").manual_seed(c + t)
    args = _attn_args(b, c, t, n_head, dtype, gen)
    launches = _count(fused_attn)
    got = fused_attn.fused_attn_ct(*args)
    torch.cuda.synchronize()
    assert _count(fused_attn) == launches + 1
    assert fused_attn.narrow(c, n_head, dtype) == (c == 144 and dtype == torch.bfloat16)
    _close(got, fused_attn.fused_attn_plain(*args), dtype)
    assert torch.equal(fused_attn.fused_attn_ct(*args), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,t", WIDE_MLP)
def test_wide_fused_mlp_matches_plain(b, c, t, dtype):
    gen = torch.Generator(device="cuda").manual_seed(c + t)
    args = _mlp_args(b, c, t, dtype, gen)
    launches = _count(fused_mlp)
    got = fused_mlp.fused_mlp_residual_ct(*args)
    torch.cuda.synchronize()
    assert _count(fused_mlp) == launches + 1
    want = fused_mlp.fused_mlp_plain(*args)
    _close(got, want, dtype)
    if dtype == torch.bfloat16 and got.numel() >= 10000:   # chip_smoke.py's rounding check
        assert (got != want).float().mean().item() <= 0.05
    assert torch.equal(fused_mlp.fused_mlp_residual_ct(*args), got)


def test_wide_products_run_on_wgmma_fed_by_tma():
    """The wide paths' products are the repository's own Hopper kernels:
    in each library every instantiation of ``hgemm_kernel`` (and no other
    kernel) issues ``HGMMA`` and loads by TMA (``UTMALDG``), per
    ``cuobjdump -sass`` of the built library."""
    import subprocess

    for name, mod in (("fused_mlp", fused_mlp), ("fused_attn", fused_attn)):
        lib = build.load(name, mod._SIGNATURES)
        sass = subprocess.run([os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"),
                               "-sass", lib._name], capture_output=True, text=True,
                              check=True).stdout
        funcs = {}
        for block in sass.split("Function : ")[1:]:
            funcs[block.split("\n", 1)[0].strip()] = block
        gemm = {f: body for f, body in funcs.items() if "hgemm_kernel" in f}
        assert len(gemm) >= 4, sorted(funcs)          # bf16 and f32, two epilogues at least
        for f, body in gemm.items():
            assert "HGMMA" in body and "UTMALDG" in body, f
        assert not any("HGMMA" in body for f, body in funcs.items() if f not in gemm)


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
    launches = _count(module)
    got = kern(*args)
    torch.cuda.synchronize()
    assert _count(module) == launches + 1
    _close(got, plain(*args), dtype)
    return got


@pytest.mark.parametrize("mode", list(DCN_MODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,o,h,w,dilations", [
    (2, 17, 17, 13, 11, (1,)),
    (1, 5, 3, 9, 7, (3, 6, 9, 12, 15, 18, 21, 24)),   # 8 dilations, few outputs
    (1, 4, 20, 10, 12, (2, 5)),                        # more outputs than inputs
    (30, 17, 17, 64, 48, (3, 6, 9, 12, 15)),           # OTPose over ViTPose-H, B = 30
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


# above 8 dilations a call is a group of launches, 8 dilations a launch,
# the dilation groups' partial sums in slots of their own; above 32 outputs
# the exact mode samples once for every output (a launch a group of 5
# dilations), the make_pallas3 mode launches a group of 32 outputs
GROUPED_DCN = [
    (2, 5, 33, 13, 11, tuple(range(1, 10))),      # O = 33, D = 9: two dilation groups
    (1, 6, 133, 24, 20, tuple(range(1, 10))),     # O = 133 at B = 1
    (1, 17, 65, 96, 72, (3, 6, 9, 12, 15)),       # O = 65 at the flagship's B = 1
    (16, 3, 64, 12, 16, tuple(range(1, 18))),     # D = 17: three dilation groups
]
DCN_MODE_CODES = {"exact": deform_conv.EXACT, "pallas3": deform_conv.PALLAS3}


@pytest.mark.parametrize("mode", list(DCN_MODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,o,h,w,dilations", GROUPED_DCN)
def test_grouped_deform_conv_matches_plain(mode, b, c, o, h, w, dilations, dtype):
    """Each launch counted (the exact mode one a group of 5 dilations past
    32 outputs, the make_pallas3 mode one a group of 8 dilations and of 32
    outputs), the result against the plain version, and the same bits from
    a second call."""
    module, kern, plain = DCN_MODES[mode]
    args = _dcn_args(b, c, o, h, w, dilations, dtype, seed=16)
    launches = _count(module)
    got = kern(*args)
    torch.cuda.synchronize()
    groups = deform_conv.kernel_launches(len(dilations), o, DCN_MODE_CODES[mode])
    d = len(dilations)
    assert groups == (-(-d // deform_conv.WIDE_DILATIONS) if mode == "exact"
                      else -(-d // deform_conv.MAX_DILATIONS) * (deform_conv.output_pad(o) // 32))
    assert _count(module) == launches + groups
    _close(got, plain(*args), dtype)
    assert torch.equal(kern(*args), got)


# the wide paths (the exact mode past 32 outputs): every O to 288 in one
# sampling, at ragged images (rows of 11 and 29: element copies; 24 x 20:
# 16-byte copies in f32 only; 16-pixel rows: in both dtypes)
WIDE_DCN_O = (33, 64, 133, 136, 160, 256)
WIDE_DCN_HW = ((13, 11), (24, 20), (37, 29), (12, 16))
WIDE_DCN = [(b, 3, o, *WIDE_DCN_HW[(i + b + di) % len(WIDE_DCN_HW)], tuple(range(1, d + 1)))
            for i, o in enumerate(WIDE_DCN_O) for b in (1, 2) for di, d in enumerate((5, 9, 17))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,o,h,w,dilations", WIDE_DCN)
def test_wide_deform_conv_samples_once_for_every_output(b, c, o, h, w, dilations, dtype):
    """A launch a group of 5 dilations and of 144 product columns (one at
    133 and 136 outputs), the result against the plain version (row 3's
    bars: 1e-4 of the scale in f32; in bf16 5e-2 and at most 5% of the
    outputs differing), and the same bits from a second call."""
    args = _dcn_args(b, c, o, h, w, dilations, dtype, seed=19)
    launches = _count(deform_conv)
    got = deform_conv.modulated_deform_conv_multi(*args)
    torch.cuda.synchronize()
    assert _count(deform_conv) == launches + (-(-len(dilations) // deform_conv.WIDE_DILATIONS)
                                               * -(-deform_conv.product_cols(o) // 144))
    want = deform_conv.modulated_deform_conv_multi_plain(*args)
    _close(got, want, dtype)
    if dtype == torch.bfloat16:
        assert (got != want).float().mean().item() <= 0.05
    assert torch.equal(deform_conv.modulated_deform_conv_multi(*args), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,o,h,w,dilations", WIDE_DCN)
def test_wide_deform_conv_backward_has_no_output_groups(b, c, o, h, w, dilations, dtype):
    """A launch a group of 5 dilations whatever O, each of the five
    gradients against the plain version's autograd (row 6's bars: 1e-4 of
    the peak in f32, 5e-2 in bf16), every gradient the same bits from a
    second call."""
    _wide_backward_check(b, c, o, h, w, dilations, dtype,
                         -(-len(dilations) // deform_conv.WIDE_DILATIONS))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,o,h,w,dilations", [
    (1, 3, 289, 13, 11, (1, 2, 3, 4, 5)),          # 160 + 129 outputs, rows of 11
    (2, 2, 300, 12, 16, tuple(range(1, 10))),      # 160 + 140, two dilation groups
])
def test_wide_deform_conv_backward_past_288_outputs(b, c, o, h, w, dilations, dtype):
    """Past the 288 outputs a pass holds, a pass a range of outputs
    (``backward_ranges``: two here, each on the wide kernel, in f32), held
    to the plain version's autograd at row 6's bars and to its own bits."""
    assert len(deform_conv.backward_ranges(o)) == 2
    _wide_backward_check(b, c, o, h, w, dilations, dtype,
                         2 * -(-len(dilations) // deform_conv.WIDE_DILATIONS))


def _wide_backward_check(b, c, o, h, w, dilations, dtype, launched):
    gen = torch.Generator(device="cuda").manual_seed(o + b + len(dilations))
    args = dcn_case(b, c, o, h, w, dilations, dtype, gen)
    g = torch.randn(b, o, h, w, generator=gen, device="cuda").to(dtype)
    launches = _count(deform_conv, "bwd_launches")
    got = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
    torch.cuda.synchronize()
    assert _count(deform_conv, "bwd_launches") == launches + launched
    assert deform_conv.backward_launches(len(dilations), o) == launched
    want = dcn_gradients(deform_conv.modulated_deform_conv_multi_plain, args, g)
    d = len(dilations)
    for name, gk, gp in zip(GRAD_NAMES, _grad_groups(got, d), _grad_groups(want, d)):
        assert gk.dtype == gp.dtype and gk.shape == gp.shape, name
        err = (gk.float() - gp.float()).abs().max().item()
        peak = gp.float().abs().max().item()
        assert peak > 0 and err <= TOL[dtype] * peak, (name, err, peak)
    again = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
    for name, a, b2 in zip(GRAD_NAMES, _grad_groups(got, d), _grad_groups(again, d)):
        assert torch.equal(a, b2), name


def test_wide_dcn_products_run_on_the_tensor_cores():
    """The wide paths' products run on the tensor cores: every instantiation
    of the forward's ``deform_wide_kernel`` issues ``HGMMA`` (``wgmma``),
    every one of the backward's ``dcn_bwd_wide_kernel`` ``HMMA``
    (``mma.sync``), and the narrow kernels neither, per ``cuobjdump -sass``
    of the built libraries."""
    import subprocess

    # f32 and bf16 x both copies x x planes or not
    for name, sigs, kernel, narrow, op in (
            ("deform_conv", deform_conv._SIGNATURES, "deform_wide_kernel",
             "deform_staged_kernel", "HGMMA"),
            ("deform_conv_bwd", deform_conv._BWD_SIGNATURES, "dcn_bwd_wide_kernel",
             "dcn_bwd_kernel", "HMMA")):
        lib = build.load(name, sigs)
        sass = subprocess.run([os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"),
                               "-sass", lib._name], capture_output=True, text=True,
                              check=True).stdout
        funcs = {}
        for block in sass.split("Function : ")[1:]:
            funcs[block.split("\n", 1)[0].strip()] = block
        wide = {f: body for f, body in funcs.items() if kernel in f}
        assert len(wide) == 8, sorted(funcs)
        for f, body in wide.items():
            assert op in body, f
        assert not any("HMMA" in body or "HGMMA" in body for f, body in funcs.items()
                       if narrow in f and kernel not in f)


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
    """Any O and D run (GROUPED_DCN); a dtype other than f32 and bf16 and a
    map that is not contiguous are refused."""
    kern = DCN_MODES[mode][1]
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
    launches = _count(deform_conv, "bwd_launches")
    got = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
    want = dcn_gradients(deform_conv.modulated_deform_conv_multi_plain, args, g)
    torch.cuda.synchronize()
    assert _count(deform_conv, "bwd_launches") == launches + 1
    d = len(dilations)
    for name, gk, gp in zip(GRAD_NAMES, _grad_groups(got, d), _grad_groups(want, d)):
        assert gk.dtype == gp.dtype and gk.shape == gp.shape, name
        err = (gk.float() - gp.float()).abs().max().item()
        peak = gp.float().abs().max().item()
        assert peak > 0 and err <= TOL[dtype] * peak, (name, err, peak)


GROUPED_DCN_BWD = [
    (2, 5, 33, 13, 11, tuple(range(1, 10))),      # O = 33, D = 9: two dilation groups
    (1, 6, 133, 24, 20, tuple(range(1, 10))),     # O = 133 at B = 1, D = 9
    (2, 4, 64, 37, 53, (1, 5, 9)),                # O = 64; rows of 53: element copies
    (1, 2, 40, 208, 208, tuple(range(1, 10))),    # planes too large for shared memory, D = 9
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,o,h,w,dilations", GROUPED_DCN_BWD)
def test_grouped_deform_conv_backward_matches_plain_autograd(b, c, o, h, w, dilations, dtype):
    """Above 8 dilations the backward is a group of launches, one a group
    of 8 dilations (past 32 outputs the wide kernel, a launch a group of 5,
    no O groups): each counted, each of the five gradients against the plain
    version's autograd as in the test above, and every gradient the same
    bits from a second call."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    args = dcn_case(b, c, o, h, w, dilations, dtype, gen)
    assert dcn_inside_share(args) > 0.25
    g = torch.randn(b, o, h, w, generator=gen, device="cuda").to(dtype)
    launches = _count(deform_conv, "bwd_launches")
    got = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
    torch.cuda.synchronize()
    groups = deform_conv.backward_launches(len(dilations), o)
    assert groups == -(-len(dilations) // (deform_conv.WIDE_DILATIONS if o > 32
                                            else deform_conv.MAX_DILATIONS))
    assert _count(deform_conv, "bwd_launches") == launches + groups
    want = dcn_gradients(deform_conv.modulated_deform_conv_multi_plain, args, g)
    d = len(dilations)
    for name, gk, gp in zip(GRAD_NAMES, _grad_groups(got, d), _grad_groups(want, d)):
        assert gk.dtype == gp.dtype and gk.shape == gp.shape, name
        err = (gk.float() - gp.float()).abs().max().item()
        peak = gp.float().abs().max().item()
        assert peak > 0 and err <= TOL[dtype] * peak, (name, err, peak)
    again = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
    for name, a, b2 in zip(GRAD_NAMES, _grad_groups(got, d), _grad_groups(again, d)):
        assert torch.equal(a, b2), name


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


@pytest.mark.parametrize("joints,fused", [(17, (4, 6)), (21, (4, 6)), (33, (6, 8))])
def test_tiny_eval_on_the_card_equals_the_cpu(joints, fused):
    """F7: the temporal encoders are 8 x joints channels wide, so from 21
    joints (168) the fused kernels take them on their wide paths; at 33
    joints the flow encoder (C = 33, one head) takes both kernels as well
    and the DCN's 33 outputs are two groups of launches.  The forward's
    launches (fused attention, fused MLP, DCN) and its seven outputs against
    the CPU's plain versions to 1e-3 of each peak, TF32 off."""
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.models.otpose import otpose_forward
    from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

    _, model = build_model(tiny_otpose_cfg(num_joints=joints), seed=2)
    cpu = copy.deepcopy(model).cpu()
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 64, 64, 15, generator=gen)
    margin = torch.tensor([[1.0, 1, 2, 2], [1, 0, 2, 0]])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = (_count(fused_attn), _count(fused_mlp), _count(deform_conv))
        with torch.no_grad():
            got = otpose_forward(model, x.cuda(), margin.cuda())
            torch.cuda.synchronize()
            after = (_count(fused_attn), _count(fused_mlp), _count(deform_conv))
            want = otpose_forward(cpu, x, margin)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    groups = deform_conv.kernel_launches(2, joints)
    assert tuple(a - b for a, b in zip(after, before)) == fused + (groups,)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        peak = max(1e-6, w.abs().max().item())
        assert (g.cpu() - w).abs().max().item() <= 1e-3 * peak


def test_train_mode_block_takes_the_plain_path():
    """The block gate has JAX's ``not train`` term: a train-mode block on
    the card launches neither fused kernel, and its gradients reach every
    parameter."""
    from otpose_tpu_torch.models import blocks

    blk = blocks.TransformerBlock(136, 2, 1, path_pdrop=0.1, proj_pdrop=0.1).cuda().train()
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0, 0.1)
    launches = (_count(fused_attn), _count(fused_mlp))
    blk(torch.randn(2, 136, 96, device="cuda")).sum().backward()
    assert (_count(fused_attn), _count(fused_mlp)) == launches
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
    # the MLP past 1152 padded channels (its wide kernel's accumulators):
    # supports is False and the wrapper raises before any launch
    x = torch.randn(1, 1160, 16, device="cuda")
    w = torch.randn(4640, 1160, 1, device="cuda")
    ln = torch.ones(1160, device="cuda")
    assert not fused_mlp.supports(1160, torch.float32)
    launches = _count(fused_mlp)
    with pytest.raises(ValueError, match="C=1160"):
        fused_mlp.fused_mlp_residual_ct(x, ln, ln, w, w[:, 0, 0], w.reshape(1160, 4640, 1),
                                        ln)
    assert _count(fused_mlp) == launches
    for dtype in (torch.float32, torch.bfloat16):      # heads that do not divide C
        args = _attn_args(1, 200, 8, 2, dtype, torch.Generator(device="cuda"))
        args[-1] = 3
        with pytest.raises(ValueError, match="C=200 not divisible"):
            fused_attn.fused_attn_ct(*args)
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
    launches = (_count(fused_attn), _count(fused_mlp), _count(deform_conv))
    got = loaded(x, margin)
    torch.cuda.synchronize()
    assert (_count(fused_attn) - launches[0], _count(fused_mlp) - launches[1],
            _count(deform_conv) - launches[2]) == (4, 6, 1)
    want = make_decoded_eval_step(model)(x, margin)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    on_cpu = load_exported(out, device="cpu")(x.cpu(), margin.cpu())
    assert all(t.device.type == "cpu" and t.shape == w.shape for t, w in zip(on_cpu, want))


# ---------------------------------------------------------------------------
# nvJPEG (csrc/jpeg_nv.cu, data/nvjpeg.py): no TPU kernel's port, but built
# and launched the same way; bars as chip_smoke.py's phase 17
# ---------------------------------------------------------------------------

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "jpeg")
JPEG_NAMES = tuple(f"frame_{i:03d}" for i in range(5)) + ("odd_444", "grey", "odd_422")


def _jpeg_paths(names=JPEG_NAMES):
    return [os.path.join(FIXTURE, n + ".jpg") for n in names]


@pytest.mark.parametrize("backend", ["auto", "default"])
def test_nvjpeg_decodes_the_fixture_close_to_libjpeg(backend):
    from otpose_tpu_torch.data import nvjpeg

    ref = np.load(os.path.join(FIXTURE, "decoded.npz"))
    ref_planes = np.load(os.path.join(FIXTURE, "planes.npz"))
    for name, path in zip(JPEG_NAMES, _jpeg_paths()):
        h, w = ref[name].shape[:2]
        dec = nvjpeg.decode_jpeg_batch_device([path], h, w, "cuda", backend=backend,
                                              keep_planes=True)
        assert (dec.hs[0], dec.ws[0]) == (h, w)
        assert backend == "auto" or dec.backends == ["default"]
        # the conversion kernel equals its plain version on nvJPEG's planes
        assert torch.equal(nvjpeg.ycc_to_rgb(*dec.planes[0]), dec.out[0])
        d = np.abs(dec.out[0].cpu().numpy().astype(np.int16) - ref[name].astype(np.int16))
        assert d.max() <= 6 and d.mean() <= 0.1, (name, dec.backends, d.max(), d.mean())
        for k, plane in zip(("y", "cb", "cr"), dec.planes[0]):
            if plane is not None and f"{name}_{k}" in ref_planes:
                want = ref_planes[f"{name}_{k}"].astype(np.int16)
                assert np.abs(plane.cpu().numpy().astype(np.int16) - want).max() <= 2, (name, k)


def test_nvjpeg_writes_each_frame_at_the_top_left_of_its_buffer_row():
    from otpose_tpu_torch.data import nvjpeg

    paths = _jpeg_paths()
    big = torch.zeros((len(paths), 1088, 1920, 3), dtype=torch.uint8, device="cuda")
    dec = nvjpeg.decode_jpeg_batch_device(paths, 1088, 1920, out=big)
    hs, ws = dec.hs, dec.ws
    for i, path in enumerate(paths):
        alone = nvjpeg.decode_jpeg_batch_device(
            [path], hs[i], ws[i], backend="default" if dec.backends[i] == "default"
            else "auto").out
        assert torch.equal(big[i, :hs[i], :ws[i]], alone[0])
        assert not big[i, hs[i]:].any() and not big[i, :, ws[i]:].any()


def test_nvjpeg_raises_naming_the_file(tmp_path):
    from otpose_tpu_torch.data import nvjpeg

    path = _jpeg_paths()[0]
    with pytest.raises(ValueError, match="max_frame_hw") as err:
        nvjpeg.decode_jpeg_batch_device([_jpeg_paths()[5], path], 720, 1000)
    assert path in str(err.value)
    # a truncated file decodes, its missing rows filled, as libjpeg (the
    # native library) decodes it; a corrupt header raises, naming the file
    short = tmp_path / "truncated.jpg"
    short.write_bytes(open(path, "rb").read()[:2000])
    assert nvjpeg.decode_jpeg_batch_device([str(short)], 720, 1280).hs == [720]
    bad = tmp_path / "corrupt.jpg"
    bad.write_bytes(b"\xff\xd8garbage")
    with pytest.raises((RuntimeError, ValueError)) as err:
        nvjpeg.decode_jpeg_batch_device([str(bad)], 720, 1280)
    assert "corrupt.jpg" in str(err.value)
    # 4:4:0 chroma: no conversion of libjpeg's for it on the card, so refused
    s440 = os.path.join(FIXTURE, "small_440.jpg")
    with pytest.raises(ValueError, match="chroma sampling") as err:
        nvjpeg.decode_jpeg_batch_device([path, s440], 720, 1280)
    assert s440 in str(err.value)


def test_device_loader_full_decodes_on_the_card(tmp_path):
    """``DeviceLoader`` in full mode on the card takes nvJPEG; its batches
    against the same loader with the frames read by cv2 on the host: the
    inputs within the decoders' difference, targets and metas equal."""
    pytest.importorskip("cv2")
    from otpose_tpu_torch.data.device_loader import DeviceLoader
    from otpose_tpu_torch.data.posetrack import PoseTrackDataset
    from otpose_tpu_torch.data.synthetic import make_synthetic_posetrack
    from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

    json_dir, img_dir, annot_dir = make_synthetic_posetrack(
        str(tmp_path), num_videos=1, frames_per_video=5, people_per_frame=2, img_w=1280,
        img_h=720)
    arrays = sorted(os.path.join(d, f) for d, _, fs in os.walk(img_dir) for f in fs
                    if f.endswith(".npy"))
    for src, path in zip(_jpeg_paths(JPEG_NAMES[:5]), arrays):
        shutil.copyfile(src, path[:-4] + ".jpg")
        os.remove(path)
    for phase in ("validate", "train"):
        cfg = tiny_otpose_cfg()
        cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR, cfg.DATASET.TEST_IMG_DIR = (
            json_dir, img_dir, img_dir)
        cfg.VAL.ANNOT_DIR = annot_dir
        cfg.TRAIN.PROB_HALF_BODY = 0.0
        ds = PoseTrackDataset(cfg, phase)
        kw = dict(shuffle=False, num_workers=2, mode="full", device="cuda", device_prefetch=0)
        card = DeviceLoader(ds, 4, **kw)
        host = DeviceLoader(ds, 4, **kw)
        assert card.decoder == "nvjpeg"
        host.decoder = "read_frame"
        for (a, am), (b, bm) in zip(card, host):
            d = (a["inputs"] - b["inputs"]).abs()
            assert d.mean().item() < 0.05 and a["inputs"].is_cuda
            for k in ("target", "target_weight", "margin"):
                assert torch.equal(a[k], b[k]), (phase, k)
            assert [m["image"] for m in am] == [m["image"] for m in bm]


@pytest.mark.parametrize("variant", ["yolov3", "yolov3-tiny"])
def test_detector_on_the_card_matches_the_cpu(variant):
    from otpose_tpu_torch.detector import yolov3 as Y

    rng = np.random.RandomState(0)
    cpu = Y.build_yolo(Y.init_he_weights(0, variant, obj_bias=-1.0), variant, "cpu")
    cpu.calibrate_bn_(torch.from_numpy(rng.rand(2, 3, 416, 416).astype(np.float32)))
    gpu = Y.build_yolo(cpu.darknet_params(), variant, "cuda")
    x = torch.from_numpy(rng.rand(1, 3, 416, 416).astype(np.float32))
    with torch.no_grad():
        want, got = cpu(x)[0].numpy(), gpu(x.cuda())[0].cpu().numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert torch.backends.cudnn.allow_tf32      # restored after the forward
