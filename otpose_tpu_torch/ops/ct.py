"""The token-map ops that the fused kernels' plain versions share with the
model: channel LayerNorm, the k = 3 depthwise conv, the 1x1 conv and the
exact GELU on (B, C, T).  ``models/core.py`` re-exports them.  They live
outside ``models`` so that the modules that register the kernels' ops, and a
process that only loads an exported program, import no model code.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


def layer_norm_ct(x, weight, bias, eps: float = LN_EPS) -> torch.Tensor:
    """Channel LayerNorm over axis 1 of (B, C, T), biased variance, f32
    statistics and affine, rounded once to ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=1, keepdim=True)
    res = xf - mu
    sigma = (res * res).mean(dim=1, keepdim=True)
    out = res / torch.sqrt(sigma + eps)
    w = weight.float().reshape(1, -1, 1)
    b = bias.float().reshape(1, -1, 1)
    return (out * w + b).to(x.dtype)


def depthwise_conv1d_k3_ct(x, w, b=None, *, stride: int = 1, padded: bool = False) -> torch.Tensor:
    """Depthwise conv1d, kernel 3, zero padding 1, on (B, C, T) with a
    (C, 1, 3) kernel, as three shifted multiply-adds in ``x.dtype``.
    ``padded``: ``x`` already carries its padding (a sequence-parallel
    slice with its neighbours' tokens), and none is added."""
    xp = x if padded else F.pad(x, (1, 1))
    n = xp.shape[-1]
    w = w.to(x.dtype)
    w0, w1, w2 = w[:, 0, 0, None], w[:, 0, 1, None], w[:, 0, 2, None]
    if stride == 1:
        y = xp[..., 0:n - 2] * w0 + xp[..., 1:n - 1] * w1 + xp[..., 2:n] * w2
    else:
        to = (n - 3) // stride + 1
        end = (to - 1) * stride + 1
        y = (xp[..., 0:end:stride][..., :to] * w0
             + xp[..., 1:end + 1:stride][..., :to] * w1
             + xp[..., 2:end + 2:stride][..., :to] * w2)
    if b is not None:
        y = y + b.to(y.dtype)[:, None]
    return y


def dense_1x1_ct(x, w, b=None) -> torch.Tensor:
    """1x1 conv1d on (B, C, T) with an (O, I, 1) kernel: a channel matmul in
    ``x.dtype`` with f32 accumulation; the bias is added after rounding."""
    y = torch.matmul(w[:, :, 0].to(x.dtype), x)
    return y + b.to(y.dtype)[:, None] if b is not None else y


def gelu(x) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)
