"""Fused channel attention (counterpart of ``otpose_tpu/ops/pallas/fused_attn.py``).

``fused_attn_ct`` computes, for a stride-1 MaskedMHCA block on (B, C, T),
ln1 + the depthwise q/k/v convs + their channel LayerNorms + the 1x1
projections + the per-head channel attention, and returns the
pre-scramble ``att @ v`` (B, C, T).  The reference's scramble, the output
projection and the residual stay outside (``blocks.transformer_block_ct``).

The wrapper calls the registered op ``otpose::fused_attn``: on a CUDA
tensor it launches ``csrc/fused_attn.cu`` (bf16 on the tensor cores, f32 on
them in split TF32): its narrow kernels where ``narrow`` takes the shape
(C padded within 160, in f32 one head within 136 channels), else its wide
path (``wgmma`` products fed by TMA through scratch in device memory that
``wide_plan`` lays out); on a CPU tensor it
runs ``fused_attn_plain``, the same function in plain PyTorch, from the
pack.  It has no backward: on a CUDA tensor under grad the wrapper raises.

``pack_attn_weights`` puts the weights in the kernel's layout once
(``models/blocks.py`` caches the result on each block); the wrapper takes
either the raw weights, which it packs on every call, or such a pack.

``supports`` says, from the shape alone, whether the kernel takes a block
(every C whose heads divide it, in f32 and bf16): the wrapper raises on a
CUDA call it refuses, and the blocks' gate
(``models/blocks.py::transformer_block_ct``) sends such a block to the
plain path before any launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from otpose_tpu_torch.ops import ct
from otpose_tpu_torch.ops.cuda import build
from otpose_tpu_torch.utils import profiling


CHANNEL_ALIGN = {torch.bfloat16: 16, torch.float32: 8}   # C padded to the mma depth
MAX_CHANNELS = 160     # kMaxCp: the padded C the narrow kernels hold
# the narrow f32 score kernel's tiles of one head's (hs x hs) scores: 16
# warps of at most 10 (kF32MaxSlots) tiles of 16 x 8
F32_SCORE_TILES = 16 * 10
GEMM_TILE = 128        # the wide path's products: output tiles of 128 rows
SPLIT_TOKENS = 64      # its score sum splits T in whole K steps of a product

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "otp_fused_attn_f32": (_I, [_P] * 12 + [_I] * 5 + [ctypes.c_float, _I, _P]),
    "otp_fused_attn_tc": (_I, [_P] * 12 + [_I] * 5 + [ctypes.c_float, _I, _P]),
    "otp_fused_attn_wide": (_I, [_P] * 15 + [_I] * 5 + [ctypes.c_float, _I, _I, _I, _P]),
    "otp_fused_attn_smem": (ctypes.c_size_t, [_I, _I, _I]),
    "otp_fused_attn_narrow": (_I, [_I, _I, _I]),
}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def supports(c: int, n_head: int, dtype) -> bool:
    """Whether ``csrc/fused_attn.cu`` takes a block of ``c`` channels in
    ``n_head`` heads in ``dtype``: f32 or bf16 and heads that divide C, at
    any C (the shapes ``narrow`` refuses take the wide path, which keeps
    nothing per C on chip).  Plain Python on the shape; the library's
    ``otp_fused_attn_smem`` gives the shared memory of the path it takes."""
    return dtype in CHANNEL_ALIGN and c >= 1 and n_head >= 1 and c % n_head == 0


def narrow(c: int, n_head: int, dtype) -> bool:
    """Whether a shape ``supports`` takes runs the narrow kernels: C padded
    to the mma depth within ``MAX_CHANNELS``, and in f32 at most
    ``F32_SCORE_TILES`` tiles of one head's scores (one head of hs above
    136 has more); the same conditions as the library's
    ``otp_fused_attn_narrow``."""
    if _round_up(c, CHANNEL_ALIGN[dtype]) > MAX_CHANNELS:
        return False
    hs = c // n_head
    return not (dtype == torch.float32 and n_head * -(-hs // 16) * -(-hs // 8) > F32_SCORE_TILES)


def wide_split(t: int, hs: int, bsz: int, n_head: int, sms: int) -> tuple:
    """(nsplit, kspan): how the wide path splits the score sum over T.  About
    two blocks an SM over the (hs x hs) score tiles of every item and head,
    each split at least 256 tokens; kspan, the tokens of a split, a multiple
    of ``SPLIT_TOKENS``; no split empty."""
    tiles = (-(-hs // GEMM_TILE)) ** 2 * bsz * n_head
    nsplit = max(1, min(-(-2 * sms // tiles), -(-t // 256)))
    kspan = max(SPLIT_TOKENS, _round_up(-(-t // nsplit), SPLIT_TOKENS))
    return max(1, -(-t // kspan)), kspan


def wide_plan(bsz: int, c: int, t: int, n_head: int, nsplit: int, dtype) -> dict:
    """The wide path's scratch for x of (bsz, c, t) in ``dtype``: name ->
    (shape, dtype).  The products' operands, each K-major: ``y`` the conv
    LNs' outputs (3, B, T, Cp), ``qk`` q and k (2, B, C, Tp; T padded to 8
    so that a row is whole 16-byte units), ``vt`` v token-major, a head's
    channels a row (B, n_head, T, kp: a TMA box starts on a 16-byte
    boundary), ``att`` (B, C, kp), in f32 each with its hi and lo halves (a
    leading 2), and f32 ``w`` the projection weights' split (2, 3, Cp, Cp);
    ``s`` the scores' f32 partials (nsplit, B, C, hs)."""
    align = CHANNEL_ALIGN[dtype]
    cp, hs = _round_up(c, align), c // n_head
    kp, tp = _round_up(hs, align), _round_up(t, 8)
    parts = (2,) if dtype == torch.float32 else (1,)
    plan = {"y": (parts + (3, bsz, t, cp), dtype), "qk": (parts + (2, bsz, c, tp), dtype),
            "vt": (parts + (bsz, n_head, t, kp), dtype), "att": (parts + (bsz, c, kp), dtype),
            "s": ((nsplit, bsz, c, hs), torch.float32)}
    if dtype == torch.float32:
        plan["w"] = ((2, 3, cp, cp), dtype)
    return plan


@functools.lru_cache(maxsize=None)
def attention_scale(hs: int, dtype: torch.dtype) -> float:
    """1 / sqrt(hs) rounded to ``dtype``, as a Python float: the value a 0-d
    tensor of ``dtype`` would hold (exact in ``dtype``, so a product with it
    rounds as one with that tensor), made on the host, with no copy to the
    card and so no wait on it."""
    return torch.tensor(1.0 / math.sqrt(hs), dtype=dtype).item()


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
    scale = attention_scale(hs, q.dtype)         # rounded like the activations
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
    profiling.count("fused_attn.packs")
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
    profiling.count("fused_attn.calls")
    c = ln1_w.numel()
    q, k, v = ((dw[p].reshape(c, 1, 3), nw[p], nb[p], pw[p, :c, :c, None], pb[p, :c])
               for p in range(3))
    return fused_attn_plain(x, ln1_w, ln1_b, q[0], k[0], v[0], q[1], q[2], k[1], k[2],
                            v[1], v[2], q[3], q[4], k[3], k[4], v[3], v[4], n_head)


@fused_attn_op.register_kernel("cuda")
def _fused_attn_cuda(x, ln1_w, ln1_b, dw, nw, nb, pw, pb, n_head):
    profiling.count("fused_attn.calls")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_attn_ct: x must be a contiguous (B, C, T) tensor")
    bsz, c, t = x.shape
    if c % n_head:
        raise ValueError(f"fused_attn_ct: C={c} not divisible by n_head={n_head}")
    code = build.dtype_code(x.dtype)
    if not supports(c, n_head, x.dtype):
        raise ValueError(f"fused_attn_ct: C={c}, n_head={n_head} is not a shape the "
                         f"{x.dtype} kernel takes")
    lib = build.load("fused_attn", _SIGNATURES)
    if ln1_w.numel() != c or pw.device != x.device:
        raise ValueError(f"fused_attn_ct: weights packed for C={ln1_w.numel()} on "
                         f"{pw.device}, x has C={c} on {x.device}")
    dev = x.device
    hs = c // n_head
    out = torch.empty_like(x)
    scale = _scale(hs, x.dtype)
    is_narrow = narrow(c, n_head, x.dtype)
    if is_narrow:
        att_scr = torch.empty(bsz, c, _round_up(hs, CHANNEL_ALIGN[x.dtype]), device=dev,
                              dtype=x.dtype)
        # about one block a SM: each holds projection weights for all its chunks
        nsplit = max(1, min(-(-t // 32), _sm_count(dev.index or 0) // bsz))
        v_scr = torch.empty_like(x)
        # each split's partial score sums, added in split order by the kernel
        s_scr = torch.empty(nsplit, bsz, c, hs, device=dev, dtype=torch.float32)
        ptrs = [a.data_ptr() for a in (x, ln1_w, ln1_b, dw, nw, nb, pw, pb, v_scr, s_scr,
                                       att_scr, out)]
        launch = lib.otp_fused_attn_tc if code == 1 else lib.otp_fused_attn_f32
        err = launch(*ptrs, bsz, c, pw.shape[1], t, n_head, scale, nsplit,
                     build.stream_ptr(dev))
    else:
        nsplit, kspan = wide_split(t, hs, bsz, n_head, _sm_count(dev.index or 0))
        scr = {k: torch.empty(shape, device=dev, dtype=dt)
               for k, (shape, dt) in wide_plan(bsz, c, t, n_head, nsplit, x.dtype).items()}
        scr.setdefault("w", scr["att"])      # bf16: the weights need no split
        ptrs = [a.data_ptr() for a in (x, ln1_w, ln1_b, dw, nw, nb, pw, pb, *(
            scr[k] for k in ("y", "qk", "vt", "s", "att", "w")), out)]
        err = lib.otp_fused_attn_wide(*ptrs, bsz, c, pw.shape[1], t, n_head, scale, nsplit,
                                      kspan, code, build.stream_ptr(dev))
    build.check(lib, err, "fused_attn_ct")
    profiling.count("fused_attn.launches")
    if not is_narrow:
        profiling.count("fused_attn.wide_launches")
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
