"""Fused transformer MLP (counterpart of ``otpose_tpu/ops/pallas/fused_mlp.py``).

``fused_mlp_residual_ct`` computes ``x + W2 @ gelu(W1 @ LN_C(x) + b1) + b2``
on (B, C, T), the ln2 + mlp + residual tail of an eval transformer block.
The wrapper calls the registered op ``otpose::fused_mlp``: on a CUDA tensor
it launches ``csrc/fused_mlp.cu`` (bf16 on the tensor cores, f32 on them in
split TF32; past ``MAX_CHANNELS`` its wide kernels), on a CPU tensor it runs
``fused_mlp_plain``, the same function in plain PyTorch, from the pack.  It
has no backward: on a CUDA tensor under grad the wrapper raises.

``pack_mlp_weights`` puts the weights in the kernel's layout once
(``models/blocks.py`` caches the result on each block); the wrapper takes
either the raw weights, which it packs on every call, or such a pack.

``supports`` says, from the shape alone, whether the kernel takes a block:
the wrapper raises on a CUDA call it refuses, and the blocks' gate
(``models/blocks.py::transformer_block_ct``) sends such a block to the
plain path before any launch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from otpose_tpu_torch.ops import ct
from otpose_tpu_torch.ops.cuda import build
from otpose_tpu_torch.utils import profiling


CHANNEL_ALIGN = {torch.bfloat16: 16, torch.float32: 8}   # C padded to the mma depth
HIDDEN_TILE = 32      # the kernels stream W1/W2 in tiles of 32 hidden rows
MAX_CHANNELS = 160    # the narrow kernels' limit (kMaxCp); past it the wide path
# the wide path's limit (kWideMaxCp), the gate's (its products themselves
# take any C)
WIDE_MAX_CHANNELS = 1152
# the wide path's products (``csrc/hopper_gemm.cuh``): output tiles of
# GEMM_TILE tokens x GEMM_TILE hidden units or channels
GEMM_TILE = 128
# The narrow f32 pack's order of W2's hidden columns inside each group of 8:
# column k holds hidden HIDDEN_ORDER[k].  The first product's C fragment
# gives a lane hidden 2q and 2q + 1; the second product's A fragment wants k
# positions q and q + 4 (``csrc/fused_mlp.cu``).  The wide pack keeps them in
# order.
HIDDEN_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
_INVERSE_ORDER = tuple(HIDDEN_ORDER.index(k) for k in range(8))

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "otp_fused_mlp_f32": (_I, [_P] * 8 + [_I] * 5 + [_P]),
    "otp_fused_mlp_tc": (_I, [_P] * 8 + [_I] * 5 + [_P]),
    "otp_fused_mlp_wide": (_I, [_P] * 11 + [_I] * 6 + [_P]),
}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def supports(c: int, dtype) -> bool:
    """Whether ``csrc/fused_mlp.cu`` takes ``c`` channels in ``dtype``: f32 or
    bf16, C padded to the mma depth within ``WIDE_MAX_CHANNELS`` (1152: the
    narrow kernels to ``MAX_CHANNELS``, the wide ones past it)."""
    return (dtype in CHANNEL_ALIGN
            and 1 <= _round_up(c, CHANNEL_ALIGN[dtype]) <= WIDE_MAX_CHANNELS)


def wide_plan(bsz: int, c: int, t: int, hp: int, dtype) -> dict:
    """The wide path's scratch and launches for x of (bsz, c, t) in
    ``dtype`` and a pack of ``hp`` hidden rows: ``shapes`` of the scratch
    tensors the wrapper allocates in ``dtype`` (``xn``, the LN output, and
    ``g``, the GELU output, token-major with B T rows; f32 keeps each
    operand's hi and lo halves, and ``w`` holds the weights' split: W1 hi,
    W1 lo, W2 hi, W2 lo); ``grids`` of the two products, (tiles along N,
    tiles along M)."""
    cp = _round_up(c, CHANNEL_ALIGN[dtype])
    parts = 2 if dtype == torch.float32 else 1
    rows = bsz * t
    shapes = {"xn": (parts, rows, cp), "g": (parts, rows, hp)}
    if dtype == torch.float32:
        shapes["w"] = (4, hp * cp)
    tiles = lambda n: -(-n // GEMM_TILE)  # noqa: E731
    return {"shapes": shapes, "grids": {"up": (tiles(hp), tiles(rows)),
                                        "down": (tiles(c), tiles(rows))}}


def permute_hidden(w2: torch.Tensor, order=HIDDEN_ORDER) -> torch.Tensor:
    """(C, H) with H a multiple of 8 -> its columns in ``order`` inside each
    group of 8 (column 8 s + k holds 8 s + order[k])."""
    c, h = w2.shape
    return w2.reshape(c, h // 8, 8)[:, :, list(order)].reshape(c, h)


def unpermute_hidden(w2: torch.Tensor) -> torch.Tensor:
    """The inverse of ``permute_hidden``: an f32 pack's W2 in hidden order."""
    return permute_hidden(w2, _INVERSE_ORDER)


@dataclass(frozen=True)
class MlpPack:
    """Weights in the kernel's layout for compute dtype ``dtype``: ``w1``
    (Hp, Cp) and ``w2`` (Cp, Hp) in ``dtype``, zero-padded (Cp: C rounded up
    to ``CHANNEL_ALIGN[dtype]``, Hp: H to ``HIDDEN_TILE``); in f32 within
    ``MAX_CHANNELS`` (the narrow kernel's) ``w2``'s hidden columns are in
    ``HIDDEN_ORDER`` inside each group of 8.  Biases
    f32 holding values of ``dtype`` (zero-padded like the weights), the LN
    affine f32 (C,); the drop-path scale is in w2/b2."""
    dtype: torch.dtype
    c: int
    hid: int
    ln_w: torch.Tensor
    ln_b: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


@torch.no_grad()
def pack_mlp_weights(ln_w, ln_b, w1, b1, w2, b2, dtype, scale=None, device=None) -> MlpPack:
    """The weights of ``fused_mlp_residual_ct`` in the kernel's layout for
    compute dtype ``dtype``.  ``scale`` (C values), the drop-path scale, is
    folded into W2 and b2 in f32, before they are rounded to ``dtype``."""
    build.dtype_code(dtype)
    hid, c = w1.shape[:2]
    if w1.numel() != hid * c or w2.numel() != c * hid or tuple(w2.shape[:2]) != (c, hid):
        raise ValueError(f"fused_mlp: weights {tuple(w1.shape)}, {tuple(w2.shape)} do not "
                         "make an (H, C) / (C, H) pair")
    device = w1.device if device is None else device
    f32 = lambda a, n, what: build.f32_vector(a, n, f"fused_mlp {what}", device)  # noqa: E731
    w1f = w1.reshape(hid, c).to(device=device, dtype=torch.float32)
    w2f = w2.reshape(c, hid).to(device=device, dtype=torch.float32)
    b1f, b2f = f32(b1, hid, "b1"), f32(b2, c, "b2")
    if scale is not None:
        s = f32(scale, c, "drop-path scale")
        w2f, b2f = w2f * s[:, None], b2f * s
    rounded = lambda a: a.to(dtype).float()  # noqa: E731
    cp, hp = _round_up(c, CHANNEL_ALIGN[dtype]), _round_up(hid, HIDDEN_TILE)
    w1p = torch.zeros(hp, cp, device=device, dtype=dtype)
    w2p = torch.zeros(cp, hp, device=device, dtype=dtype)
    w1p[:hid, :c], w2p[:c, :hid] = w1f, w2f
    b1p = torch.zeros(hp, device=device)
    b2p = torch.zeros(cp, device=device)
    b1p[:hid], b2p[:c] = rounded(b1f), rounded(b2f)
    if dtype == torch.float32 and cp <= MAX_CHANNELS:
        w2p = permute_hidden(w2p).contiguous()
    profiling.count("fused_mlp.packs")
    return MlpPack(dtype, c, hid, f32(ln_w, c, "ln weight"), f32(ln_b, c, "ln bias"),
                   w1p, b1p, w2p, b2p)


def fused_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    h = ct.layer_norm_ct(x, ln_w, ln_b)
    h = ct.gelu(ct.dense_1x1_ct(h, w1, b1))
    return x + ct.dense_1x1_ct(h, w2, b2)


@torch.library.custom_op("otpose::fused_mlp", mutates_args=(), device_types="cpu")
def fused_mlp_op(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, hid: int) -> torch.Tensor:
    """The tensors of an ``MlpPack`` and its H.  CPU: the plain version."""
    profiling.count("fused_mlp.calls")
    c = ln_w.numel()
    if w1.dtype == torch.float32 and w2.shape[0] <= MAX_CHANNELS:
        w2 = unpermute_hidden(w2)
    return fused_mlp_plain(x, ln_w, ln_b, w1[:hid, :c, None], b1[:hid], w2[:c, :hid, None],
                           b2[:c])


@fused_mlp_op.register_kernel("cuda")
def _fused_mlp_cuda(x, ln_w, ln_b, w1, b1, w2, b2, hid):
    profiling.count("fused_mlp.calls")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_mlp_residual_ct: x must be a contiguous (B, C, T) tensor")
    bsz, c, t = x.shape
    code = build.dtype_code(x.dtype)
    if not supports(c, x.dtype):
        raise ValueError(f"fused_mlp_residual_ct: C={c} is above the kernels' "
                         f"{WIDE_MAX_CHANNELS}")
    if ln_w.numel() != c or w1.device != x.device:
        raise ValueError(f"fused_mlp_residual_ct: weights packed for C={ln_w.numel()} on "
                         f"{w1.device}, x has C={c} on {x.device}")
    out = torch.empty_like(x)
    ptrs = [a.data_ptr() for a in (x, out, ln_w, ln_b, w1, b1, w2, b2)]
    lib = build.load("fused_mlp", _SIGNATURES)
    cp, hp, stream = w2.shape[0], w1.shape[0], build.stream_ptr(x.device)
    if cp <= MAX_CHANNELS:
        launch = lib.otp_fused_mlp_tc if code == 1 else lib.otp_fused_mlp_f32
        err = launch(*ptrs, bsz, c, cp, hp, t, stream)
    else:
        scratch = {k: torch.empty(s, device=x.device, dtype=x.dtype)
                   for k, s in wide_plan(bsz, c, t, hp, x.dtype)["shapes"].items()}
        w = scratch.get("w", scratch["g"])      # bf16: no split weights
        err = lib.otp_fused_mlp_wide(*ptrs, scratch["xn"].data_ptr(), scratch["g"].data_ptr(),
                                     w.data_ptr(), bsz, c, cp, hp, t, code, stream)
    build.check(lib, err, "fused_mlp_residual_ct")
    profiling.count("fused_mlp.launches")
    if cp > MAX_CHANNELS:
        profiling.count("fused_mlp.wide_launches")
    return out


@fused_mlp_op.register_fake
def _fused_mlp_fake(x, ln_w, ln_b, w1, b1, w2, b2, hid):
    return torch.empty_like(x)


def fused_mlp_residual_ct(x, ln_w=None, ln_b=None, w1=None, b1=None, w2=None, b2=None, *,
                          packed: MlpPack | None = None) -> torch.Tensor:
    """x: (B, C, T).  ``w1`` (4C, C, 1) and ``w2`` (C, 4C, 1) are the conv1d
    kernels with biases (4C,) and (C,); ``ln_w``/``ln_b`` the f32 LN affine,
    (1, C, 1) or (C,).  Or, in place of the weights, ``packed`` from
    ``pack_mlp_weights`` for ``x.dtype``."""
    if packed is not None and packed.dtype != x.dtype:
        raise ValueError(f"fused_mlp_residual_ct: weights packed for {packed.dtype}, "
                         f"x is {x.dtype}")
    build.check_device("fused_mlp_residual_ct", x)
    build.refuse_grad("fused_mlp_residual_ct", x, ln_w, ln_b, w1, b1, w2, b2,
                      *(vars(packed).values() if packed is not None else ()))
    if packed is None:
        packed = pack_mlp_weights(ln_w, ln_b, w1, b1, w2, b2, x.dtype, device=x.device)
    pk = packed
    return fused_mlp_op(x, pk.ln_w, pk.ln_b, pk.w1, pk.b1, pk.w2, pk.b2, pk.hid)
