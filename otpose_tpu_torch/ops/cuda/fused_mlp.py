"""Fused transformer MLP (counterpart of ``otpose_tpu/ops/pallas/fused_mlp.py``).

``fused_mlp_residual_ct`` computes ``x + W2 @ gelu(W1 @ LN_C(x) + b1) + b2``
on (B, C, T), the ln2 + mlp + residual tail of an eval transformer block.
The wrapper calls the registered op ``otpose::fused_mlp``: on a CUDA tensor
it launches ``csrc/fused_mlp.cu`` (bf16 on the tensor cores, f32 as FMA
loops), on a CPU tensor it runs ``fused_mlp_plain``, the same function in
plain PyTorch, from the pack.  It has no backward: on a CUDA tensor under
grad the wrapper raises.

``pack_mlp_weights`` puts the weights in the kernel's layout once
(``models/blocks.py`` caches the result on each block); the wrapper takes
either the raw weights, which it packs on every call, or such a pack.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from otpose_tpu_torch.ops import ct
from otpose_tpu_torch.ops.cuda import build

# op calls (either device), kernel launches (CUDA only) and packs made
calls = 0
launches = 0
packs = 0

CHANNEL_ALIGN = 16    # C is zero-padded to the mma depth in the bf16 pack
HIDDEN_TILE = 32      # the bf16 kernel streams W1/W2 in tiles of 32 hidden rows
MAX_CHANNELS = 160    # the limit of both kernels

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "otp_fused_mlp_f32": (_I, [_P] * 8 + [_I] * 4 + [_P]),
    "otp_fused_mlp_tc": (_I, [_P] * 8 + [_I] * 5 + [_P]),
}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class MlpPack:
    """Weights in the kernel's layout for compute dtype ``dtype``.  bf16:
    ``w1`` (Hp, Cp) and ``w2`` (Cp, Hp) bf16, zero-padded; f32: (H, C) and
    (C, H).  Biases f32 holding values of ``dtype`` (zero-padded like the
    weights), the LN affine f32 (C,); the drop-path scale is in w2/b2."""
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
    global packs
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
    if dtype == torch.bfloat16:
        cp, hp = _round_up(c, CHANNEL_ALIGN), _round_up(hid, HIDDEN_TILE)
        w1p = torch.zeros(hp, cp, device=device, dtype=dtype)
        w2p = torch.zeros(cp, hp, device=device, dtype=dtype)
        w1p[:hid, :c], w2p[:c, :hid] = w1f, w2f
        b1p = torch.zeros(hp, device=device)
        b2p = torch.zeros(cp, device=device)
        b1p[:hid], b2p[:c] = rounded(b1f), rounded(b2f)
    else:
        w1p, w2p = w1f.contiguous(), w2f.contiguous()
        b1p, b2p = b1f, b2f
    packs += 1
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
    global calls
    calls += 1
    c = ln_w.numel()
    return fused_mlp_plain(x, ln_w, ln_b, w1[:hid, :c, None], b1[:hid], w2[:c, :hid, None],
                           b2[:c])


@fused_mlp_op.register_kernel("cuda")
def _fused_mlp_cuda(x, ln_w, ln_b, w1, b1, w2, b2, hid):
    global calls, launches
    calls += 1
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_mlp_residual_ct: x must be a contiguous (B, C, T) tensor")
    bsz, c, t = x.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"fused_mlp_residual_ct: C={c} is above the kernel's {MAX_CHANNELS}")
    code = build.dtype_code(x.dtype)
    if ln_w.numel() != c or w1.device != x.device:
        raise ValueError(f"fused_mlp_residual_ct: weights packed for C={ln_w.numel()} on "
                         f"{w1.device}, x has C={c} on {x.device}")
    out = torch.empty_like(x)
    ptrs = (a.data_ptr() for a in (x, out, ln_w, ln_b, w1, b1, w2, b2))
    lib = build.load("fused_mlp", _SIGNATURES)
    if code == 1:
        err = lib.otp_fused_mlp_tc(*ptrs, bsz, c, w2.shape[0], w1.shape[0], t,
                                   build.stream_ptr(x.device))
    else:
        err = lib.otp_fused_mlp_f32(*ptrs, bsz, c, hid, t, build.stream_ptr(x.device))
    build.check(lib, err, "fused_mlp_residual_ct")
    launches += 1
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
