"""Fused channel attention (counterpart of ``otpose_tpu/ops/pallas/fused_attn.py``).

``fused_attn_ct`` computes, for a stride-1 MaskedMHCA block on (B, C, T),
ln1 + the depthwise q/k/v convs + their channel LayerNorms + the 1x1
projections + the per-head channel attention, and returns the
pre-scramble ``att @ v`` (B, C, T).  The reference's scramble, the output
projection and the residual stay outside (``blocks.transformer_block_ct``).

The wrapper calls the registered op ``otpose::fused_attn``: on a CUDA
tensor it launches ``csrc/fused_attn.cu`` (bf16 on the tensor cores, f32 on
them in split TF32), on a CPU tensor it runs ``fused_attn_plain``, the same
function in plain PyTorch, from the pack.  It has no backward: on a CUDA
tensor under grad the wrapper raises.

``pack_attn_weights`` puts the weights in the kernel's layout once
(``models/blocks.py`` caches the result on each block); the wrapper takes
either the raw weights, which it packs on every call, or such a pack.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from otpose_tpu_torch.ops import ct
from otpose_tpu_torch.ops.cuda import build

# op calls (either device), kernel launches (CUDA only) and packs made
calls = 0
launches = 0
packs = 0

CHANNEL_ALIGN = {torch.bfloat16: 16, torch.float32: 8}   # C padded to the mma depth

_SMEM_LIMIT = 232448   # bytes of shared memory one H100 block may use
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "otp_fused_attn_f32": (_I, [_P] * 12 + [_I] * 5 + [ctypes.c_float, _I, _P]),
    "otp_fused_attn_tc": (_I, [_P] * 12 + [_I] * 5 + [ctypes.c_float, _I, _P]),
    "otp_fused_attn_smem": (ctypes.c_size_t, [_I, _I, _I]),
}


def channel_attention_ct(q, k, v, n_head: int, drop=None, reduce=None) -> torch.Tensor:
    """Per-head attention over the channel axis of projected (B, C, T)
    q/k/v (the MaskedMHCA quirk), returned as the contiguous (B, C, T) view
    of (B, nh, hs, T), before the scramble.  Scores are summed over T and
    rounded to the compute dtype, then softmaxed in f32; ``drop`` (train
    mode's attention dropout) is applied to the rounded weights.  With
    ``reduce`` (sequence parallelism: q/k/v hold a slice of T) each rank's
    partial scores are summed in f32 by ``reduce`` and rounded once."""
    b, c, t = q.shape
    hs = c // n_head
    scale = q.new_tensor(1.0 / math.sqrt(hs))     # rounded like the activations
    qh = q.reshape(b, n_head, hs, t)
    kh = k.reshape(b, n_head, hs, t)
    vh = v.reshape(b, n_head, hs, t)
    if reduce is None:
        att = torch.matmul(qh * scale, kh.transpose(-1, -2)).float()
    else:
        att = reduce(torch.matmul((qh * scale).float(), kh.transpose(-1, -2).float()))
        att = att.to(q.dtype).float()
    att = torch.softmax(att, dim=-1).to(q.dtype)
    if drop is not None:
        att = drop(att)
    return torch.matmul(att, vh).reshape(b, c, t)


def fused_attn_plain(x, ln1_w, ln1_b, dw_q, dw_k, dw_v, nq_w, nq_b, nk_w, nk_b,
                     nv_w, nv_b, wq, bq, wk, bk, wv, bv, n_head: int) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    normed = ct.layer_norm_ct(x, ln1_w, ln1_b)
    q, k, v = (ct.dense_1x1_ct(
        ct.layer_norm_ct(ct.depthwise_conv1d_k3_ct(normed, dw), nw, nb), w, b)
        for dw, nw, nb, w, b in ((dw_q, nq_w, nq_b, wq, bq),
                                 (dw_k, nk_w, nk_b, wk, bk),
                                 (dw_v, nv_w, nv_b, wv, bv)))
    return channel_attention_ct(q, k, v, n_head)


@dataclass(frozen=True)
class AttnPack:
    """Weights in the kernel's layout for compute dtype ``dtype``: ``pw``
    (3, Cp, Cp) in ``dtype`` and ``pb`` f32 (3, Cp) holding values of
    ``dtype``, zero-padded (Cp: C rounded up to ``CHANNEL_ALIGN[dtype]``);
    ``dw`` (3, C, 3) f32 holding values of ``dtype``; the LayerNorm affines
    f32: ``ln1_w``/``ln1_b`` (C,), ``nw``/``nb`` (3, C).  Index 0, 1, 2 is
    q, k, v."""
    dtype: torch.dtype
    c: int
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    dw: torch.Tensor
    nw: torch.Tensor
    nb: torch.Tensor
    pw: torch.Tensor
    pb: torch.Tensor


@torch.no_grad()
def pack_attn_weights(ln1_w, ln1_b, dw_q, dw_k, dw_v, nq_w, nq_b, nk_w, nk_b, nv_w, nv_b,
                      wq, bq, wk, bk, wv, bv, dtype, device=None) -> AttnPack:
    """The weights of ``fused_attn_ct`` (same order) in the kernel's layout
    for compute dtype ``dtype``."""
    global packs
    build.dtype_code(dtype)
    c = wq.shape[0]
    device = wq.device if device is None else device

    def vec(a, n, what, rounded=False):
        # rounded: a weight the model applies in the compute dtype
        return build.f32_vector(a.to(dtype) if rounded else a, n, f"fused_attn {what}",
                                device)

    dw = torch.stack([vec(w, 3 * c, "depthwise weight", True) for w in (dw_q, dw_k, dw_v)])
    nw = torch.stack([vec(w, c, "norm weight") for w in (nq_w, nk_w, nv_w)])
    nb = torch.stack([vec(w, c, "norm bias") for w in (nq_b, nk_b, nv_b)])
    pw = torch.stack([vec(w, c * c, "projection weight", True) for w in (wq, wk, wv)])
    pb = torch.stack([vec(w, c, "projection bias", True) for w in (bq, bk, bv)])
    cp = -(-c // CHANNEL_ALIGN[dtype]) * CHANNEL_ALIGN[dtype]
    pwp = torch.zeros(3, cp, cp, device=device, dtype=dtype)
    pbp = torch.zeros(3, cp, device=device)
    pwp[:, :c, :c], pbp[:, :c] = pw.reshape(3, c, c), pb
    packs += 1
    return AttnPack(dtype, c, vec(ln1_w, c, "ln1.weight"), vec(ln1_b, c, "ln1.bias"),
                    dw.reshape(3, c, 3), nw, nb, pwp, pbp)


@functools.lru_cache(maxsize=None)
def _scale(hs: int, dtype) -> float:
    """1/sqrt(hs) rounded to the compute dtype, as the plain version has it."""
    return float(torch.tensor(1.0 / math.sqrt(hs)).to(dtype))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@torch.library.custom_op("otpose::fused_attn", mutates_args=(), device_types="cpu")
def fused_attn_op(x: torch.Tensor, ln1_w: torch.Tensor, ln1_b: torch.Tensor, dw: torch.Tensor,
                  nw: torch.Tensor, nb: torch.Tensor, pw: torch.Tensor, pb: torch.Tensor,
                  n_head: int) -> torch.Tensor:
    """The tensors of an ``AttnPack``.  CPU: the plain version."""
    global calls
    calls += 1
    c = ln1_w.numel()
    q, k, v = ((dw[p].reshape(c, 1, 3), nw[p], nb[p], pw[p, :c, :c, None], pb[p, :c])
               for p in range(3))
    return fused_attn_plain(x, ln1_w, ln1_b, q[0], k[0], v[0], q[1], q[2], k[1], k[2],
                            v[1], v[2], q[3], q[4], k[3], k[4], v[3], v[4], n_head)


@fused_attn_op.register_kernel("cuda")
def _fused_attn_cuda(x, ln1_w, ln1_b, dw, nw, nb, pw, pb, n_head):
    global calls, launches
    calls += 1
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_attn_ct: x must be a contiguous (B, C, T) tensor")
    bsz, c, t = x.shape
    if c % n_head:
        raise ValueError(f"fused_attn_ct: C={c} not divisible by n_head={n_head}")
    code = build.dtype_code(x.dtype)
    lib = build.load("fused_attn", _SIGNATURES)
    if lib.otp_fused_attn_smem(c, n_head, code) > _SMEM_LIMIT:
        raise ValueError(f"fused_attn_ct: C={c}, n_head={n_head} is not a shape the "
                         f"{x.dtype} kernel takes (shared memory, C above 160, or in f32 "
                         "more than 160 same-head score tiles: hs above 136 with one head)")
    if ln1_w.numel() != c or pw.device != x.device:
        raise ValueError(f"fused_attn_ct: weights packed for C={ln1_w.numel()} on "
                         f"{pw.device}, x has C={c} on {x.device}")
    dev = x.device
    hs = c // n_head
    chunks = -(-t // 32)
    # about one block a SM: each holds projection weights for all its chunks
    nsplit = max(1, min(chunks, _sm_count(dev.index or 0) // bsz))
    kp = -(-hs // CHANNEL_ALIGN[x.dtype]) * CHANNEL_ALIGN[x.dtype]
    att_scr = torch.empty(bsz, c, kp, device=dev, dtype=x.dtype)
    v_scr = torch.empty_like(x)
    # each split's partial score sums, added in split order by the kernel
    s_scr = torch.empty(nsplit, bsz, c, hs, device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    ptrs = [a.data_ptr() for a in (x, ln1_w, ln1_b, dw, nw, nb, pw, pb, v_scr, s_scr, att_scr,
                                   out)]
    launch = lib.otp_fused_attn_tc if code == 1 else lib.otp_fused_attn_f32
    err = launch(*ptrs, bsz, c, pw.shape[1], t, n_head, _scale(hs, x.dtype), nsplit,
                 build.stream_ptr(dev))
    build.check(lib, err, "fused_attn_ct")
    launches += 1
    return out


@fused_attn_op.register_fake
def _fused_attn_fake(x, ln1_w, ln1_b, dw, nw, nb, pw, pb, n_head):
    return torch.empty_like(x)


def fused_attn_ct(x, ln1_w=None, ln1_b=None, dw_q=None, dw_k=None, dw_v=None, nq_w=None,
                  nq_b=None, nk_w=None, nk_b=None, nv_w=None, nv_b=None, wq=None, bq=None,
                  wk=None, bk=None, wv=None, bv=None, n_head: int | None = None, *,
                  packed: AttnPack | None = None) -> torch.Tensor:
    """x: (B, C, T) -> pre-scramble attention output (B, C, T).

    ``dw_*`` are the (C, 1, 3) depthwise kernels, ``w*`` the (C, C, 1)
    projection kernels with (C,) biases ``b*``; the LayerNorm affines are
    (1, C, 1) or (C,) and stay f32.  Or, in place of the weights, ``packed``
    from ``pack_attn_weights`` for ``x.dtype``."""
    raw = (ln1_w, ln1_b, dw_q, dw_k, dw_v, nq_w, nq_b, nk_w, nk_b, nv_w, nv_b,
           wq, bq, wk, bk, wv, bv)
    if n_head is None:
        raise ValueError("fused_attn_ct: n_head is required")
    if packed is not None and packed.dtype != x.dtype:
        raise ValueError(f"fused_attn_ct: weights packed for {packed.dtype}, x is {x.dtype}")
    build.check_device("fused_attn_ct", x)
    build.refuse_grad("fused_attn_ct", x, *raw,
                      *(vars(packed).values() if packed is not None else ()))
    if packed is None:
        packed = pack_attn_weights(*raw, x.dtype, device=x.device)
    pk = packed
    return fused_attn_op(x, pk.ln1_w, pk.ln1_b, pk.dw, pk.nw, pk.nb, pk.pw, pk.pb, n_head)
