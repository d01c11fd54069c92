"""Fused channel attention (counterpart of ``otpose_tpu/ops/pallas/fused_attn.py``).

``fused_attn_ct`` computes, for a stride-1 MaskedMHCA block on (B, C, T),
ln1 + the depthwise q/k/v convs + their channel LayerNorms + the 1x1
projections + the per-head channel attention, and returns the
pre-scramble ``att @ v`` (B, C, T).  The reference's scramble, the output
projection and the residual stay outside (``blocks.transformer_block_ct``).

On a CUDA tensor it launches ``csrc/fused_attn.cu``; on a CPU tensor it runs
``fused_attn_plain``, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from otpose_tpu_torch.models import core
from otpose_tpu_torch.ops.cuda import build

# wrapper calls (either path) and kernel launches (CUDA path only)
calls = 0
launches = 0

_SMEM_LIMIT = 232448   # bytes of shared memory one H100 block may use
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "otp_fused_attn": (_I, [_P] * 12 + [_I] * 4 + [ctypes.c_float, _I, _I, _P]),
    "otp_fused_attn_smem": (ctypes.c_size_t, [_I, _I]),
}


def channel_attention_ct(q, k, v, n_head: int) -> torch.Tensor:
    """Per-head attention over the channel axis of projected (B, C, T)
    q/k/v (the MaskedMHCA quirk), returned as the contiguous (B, C, T) view
    of (B, nh, hs, T), before the scramble.  Scores are summed over T and
    rounded to the compute dtype, then softmaxed in f32."""
    b, c, t = q.shape
    hs = c // n_head
    scale = q.new_tensor(1.0 / math.sqrt(hs))     # rounded like the activations
    qh = q.reshape(b, n_head, hs, t)
    kh = k.reshape(b, n_head, hs, t)
    vh = v.reshape(b, n_head, hs, t)
    att = torch.matmul(qh * scale, kh.transpose(-1, -2)).float()
    att = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.matmul(att, vh).reshape(b, c, t)


def fused_attn_plain(x, ln1_w, ln1_b, dw_q, dw_k, dw_v, nq_w, nq_b, nk_w, nk_b,
                     nv_w, nv_b, wq, bq, wk, bk, wv, bv, n_head: int) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    normed = core.layer_norm_ct(x, ln1_w, ln1_b)
    q, k, v = (core.dense_1x1_ct(
        core.layer_norm_ct(core.depthwise_conv1d_k3_ct(normed, dw), nw, nb), w, b)
        for dw, nw, nb, w, b in ((dw_q, nq_w, nq_b, wq, bq),
                                 (dw_k, nk_w, nk_b, wk, bk),
                                 (dw_v, nv_w, nv_b, wv, bv)))
    return channel_attention_ct(q, k, v, n_head)


def fused_attn_ct(x, ln1_w, ln1_b, dw_q, dw_k, dw_v, nq_w, nq_b, nk_w, nk_b,
                  nv_w, nv_b, wq, bq, wk, bk, wv, bv, n_head: int) -> torch.Tensor:
    """x: (B, C, T) -> pre-scramble attention output (B, C, T).

    ``dw_*`` are the (C, 1, 3) depthwise kernels, ``w*`` the (C, C, 1)
    projection kernels with (C,) biases ``b*``; the LayerNorm affines are
    (1, C, 1) or (C,) and stay f32."""
    global calls, launches
    calls += 1
    if x.device.type == "cpu":
        return fused_attn_plain(x, ln1_w, ln1_b, dw_q, dw_k, dw_v, nq_w, nq_b,
                                nk_w, nk_b, nv_w, nv_b, wq, bq, wk, bk, wv, bv,
                                n_head)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attn_ct: unsupported device {x.device}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_attn_ct: x must be a contiguous (B, C, T) tensor")
    bsz, c, t = x.shape
    if c % n_head:
        raise ValueError(f"fused_attn_ct: C={c} not divisible by n_head={n_head}")
    code = build.dtype_code(x.dtype)
    lib = build.load("fused_attn", _SIGNATURES)
    if lib.otp_fused_attn_smem(c, n_head) > _SMEM_LIMIT:
        raise ValueError(f"fused_attn_ct: C={c}, n_head={n_head} needs more "
                         "shared memory than one block has")
    dt, dev = x.dtype, x.device

    def vec(a, n, what, rounded=False):
        # rounded: a weight the model applies in the compute dtype
        return build.f32_vector(a.to(dt) if rounded else a, n, f"fused_attn_ct {what}", dev)

    ln1w, ln1b = vec(ln1_w, c, "ln1.weight"), vec(ln1_b, c, "ln1.bias")
    dw = torch.stack([vec(w, 3 * c, "depthwise weight", True) for w in (dw_q, dw_k, dw_v)])
    nw = torch.stack([vec(w, c, "norm weight") for w in (nq_w, nk_w, nv_w)])
    nb = torch.stack([vec(w, c, "norm bias") for w in (nq_b, nk_b, nv_b)])
    pw = torch.stack([vec(w, c * c, "projection weight", True) for w in (wq, wk, wv)])
    pb = torch.stack([vec(w, c, "projection bias", True) for w in (bq, bk, bv)])
    hs = c // n_head
    scale = float(torch.tensor(1.0 / math.sqrt(hs)).to(dt))
    v_scr = torch.empty_like(x)
    s_scr = torch.empty(bsz, c, hs, device=dev, dtype=torch.float32)
    att_scr = torch.empty_like(s_scr)
    out = torch.empty_like(x)
    nsplit = max(1, min((t + 31) // 32, 512 // bsz))   # about 512 blocks in flight
    err = lib.otp_fused_attn(
        *(a.data_ptr() for a in (x, ln1w, ln1b, dw, nw, nb, pw, pb, v_scr, s_scr,
                                 att_scr, out)),
        bsz, c, t, n_head, scale, nsplit, code, build.stream_ptr(dev))
    build.check(lib, err, "fused_attn_ct")
    launches += 1
    return out
