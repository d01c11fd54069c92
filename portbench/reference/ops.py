"""Plain PyTorch operations of the reference, in float32.

Every matrix product and convolution takes its operands through
``operand``: the identity in the reference's own precision, and a per-tensor
scaled round trip through float8 (e4m3) when the control runs
(``lowered("fp8")``), the step below the bfloat16 that the configurations
state.  The round trip is straight-through under autograd: the control's
forward products are fp8, its gradients flow as float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
LN_EPS = 1e-5
FP8_MAX = 448.0           # the largest finite float8_e4m3fn

_precision = "f32"
_generator: torch.Generator | None = None


@contextlib.contextmanager
def lowered(precision: str):
    """Run the reference's products in ``precision`` ("f32" or "fp8")."""
    global _precision
    if precision not in ("f32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    prev, _precision = _precision, precision
    try:
        yield
    finally:
        _precision = prev


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, on the card and off it."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a per-tensor scale (its largest
    magnitude maps to 448), returned in float32."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (t.float() * scale).to(torch.float8_e4m3fn).float() / scale


def operand(t: torch.Tensor) -> torch.Tensor:
    if _precision == "f32":
        return t
    return t + (fp8_round(t) - t).detach()


@contextlib.contextmanager
def use_generator(gen: torch.Generator | None):
    """Dropout and drop-path draw from ``gen``."""
    global _generator
    prev, _generator = _generator, gen
    try:
        yield
    finally:
        _generator = prev


def _uniform(shape, like) -> torch.Tensor:
    return torch.rand(shape, generator=_generator, device=like.device)


def conv2d(x, w, b=None, *, stride=1, padding=0, dilation=1):
    y = F.conv2d(operand(x), operand(w), None, stride=stride, padding=padding,
                 dilation=dilation)
    return y if b is None else y + b[:, None, None]


def matmul(a, b):
    return torch.matmul(operand(a), operand(b))


def batch_norm_eval(x, weight, bias, mean, var):
    inv = torch.rsqrt(var + BN_EPS)
    scale = weight * inv
    shift = bias - mean * scale
    return x * scale[:, None, None] + shift[:, None, None]


def batch_norm_train(x, weight, bias, running_mean, running_var):
    """(y, new running mean, new running var): biased batch variance to
    normalise, the unbiased one for the running statistic."""
    n = x.numel() // x.shape[1]
    mean = x.mean(dim=(0, 2, 3))
    var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1 - BN_MOMENTUM) * running_mean + BN_MOMENTUM * mean
        new_var = (1 - BN_MOMENTUM) * running_var + BN_MOMENTUM * unbiased
    c = (slice(None), None, None)
    y = (x - mean[c]) * (torch.rsqrt(var + BN_EPS) * weight)[c] + bias[c]
    return y, new_mean, new_var


def layer_norm_ct(x, weight, bias):
    """Channel LayerNorm over axis 1 of (B, C, T)."""
    mu = x.mean(dim=1, keepdim=True)
    res = x - mu
    sigma = (res * res).mean(dim=1, keepdim=True)
    return res / torch.sqrt(sigma + LN_EPS) * weight.reshape(1, -1, 1) + bias.reshape(1, -1, 1)


def depthwise_conv1d_k3_ct(x, w, *, stride=1):
    """Depthwise conv1d, kernel 3, zero padding 1, on (B, C, T)."""
    xp = F.pad(x, (1, 1))
    n = xp.shape[-1]
    w0, w1, w2 = w[:, 0, 0, None], w[:, 0, 1, None], w[:, 0, 2, None]
    if stride == 1:
        return xp[..., 0:n - 2] * w0 + xp[..., 1:n - 1] * w1 + xp[..., 2:n] * w2
    to = (n - 3) // stride + 1
    end = (to - 1) * stride + 1
    return (xp[..., 0:end:stride][..., :to] * w0 + xp[..., 1:end + 1:stride][..., :to] * w1
            + xp[..., 2:end + 2:stride][..., :to] * w2)


def dense_1x1_ct(x, w, b=None):
    y = matmul(w[:, :, 0], x)
    return y if b is None else y + b[:, None]


def upsample_linear_1d_ct(x, out_t: int):
    """Linear resampling of (B, C, T) to ``out_t`` (align_corners=False,
    edges clamped)."""
    b, c, t = x.shape
    if out_t == t:
        return x
    dst = torch.arange(out_t, dtype=torch.float32, device=x.device)
    src = ((dst + 0.5) * (t / out_t) - 0.5).clamp(0.0, t - 1)
    i0 = torch.floor(src).long()
    i1 = torch.clamp(i0 + 1, max=t - 1)
    w1 = src - i0.float()
    return x[..., i0] * (1 - w1) + x[..., i1] * w1


def upsample_nearest(x, factor: int):
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def dropout(x, rate: float, training: bool):
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(_uniform(x.shape, x) < keep, x / keep, 0.0)


def drop_path(x, rate: float, training: bool):
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.floor(keep + _uniform((x.shape[0],) + (1,) * (x.dim() - 1), x))
    return x / keep * mask


def sinusoid_table(n_position: int, d_hid: int) -> torch.Tensor:
    """(1, C, T) sinusoid position table."""
    import numpy as np

    pos = np.arange(n_position, dtype=np.float64)[:, None]
    j = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000, 2 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.from_numpy(table.astype(np.float32).T.copy())[None]


def channel_attention_ct(q, k, v, n_head: int, drop=None):
    """Per-head attention over the channel axis of (B, C, T), the
    MaskedMHCA form: (hs x hs) scores summed over T, softmax, times v."""
    b, c, t = q.shape
    hs = c // n_head
    qh = q.reshape(b, n_head, hs, t) / math.sqrt(hs)
    kh = k.reshape(b, n_head, hs, t)
    vh = v.reshape(b, n_head, hs, t)
    att = torch.softmax(matmul(qh, kh.transpose(-1, -2)), dim=-1)
    if drop is not None:
        att = drop(att)
    return matmul(att, vh).reshape(b, c, t)


def scramble(x, n_head: int):
    """The MaskedMHCA output reassembly: each head's (hs, T) read as (T, hs)."""
    b, c, t = x.shape
    return x.reshape(b, n_head, c // n_head, t).transpose(2, 3).reshape(b, c, t)


def _bilinear(xf, sy, sx, h: int, w: int):
    """Zero-padded bilinear samples of xf (B, C, H*W) at (B, C, P)."""
    valid = (sy > -1) & (sy < h) & (sx > -1) & (sx < w)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    ly, lx = sy - y0, sx - x0
    out = torch.zeros_like(sy)
    for dy, wy in ((0, 1 - ly), (1, ly)):
        for dx, wx in ((0, 1 - lx), (1, lx)):
            yy, xx = y0 + dy, x0 + dx
            ok = valid & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            v = torch.gather(xf, 2, idx)
            out = out + torch.where(ok, wy * wx * v, torch.zeros_like(v))
    return out


def modulated_deform_conv_multi(x, offsets, masks, weights, biases, dilations):
    """The multi-dilation modulated deformable conv, averaged over the
    dilations: x (B, C, H, W), offsets [(B, 18 C, H, W)], masks
    [(B, 9 C, H, W)], weights (D, O, C, 3, 3), biases (D, O)."""
    b, c, h, w = x.shape
    p = h * w
    xf = x.reshape(b, c, p)
    py = torch.arange(h, device=x.device, dtype=torch.float32)[:, None].expand(h, w).reshape(p)
    px = torch.arange(w, device=x.device, dtype=torch.float32)[None, :].expand(h, w).reshape(p)
    acc = x.new_zeros(b, weights.shape[1], p)
    for off, msk, wd, dil in zip(offsets, masks, weights, dilations):
        off = off.reshape(b, c, 9, 2, p)
        msk = msk.reshape(b, c, 9, p)
        for k in range(9):
            sy = (py + float((k // 3) * dil - dil)) + off[:, :, k, 0]
            sx = (px + float((k % 3) * dil - dil)) + off[:, :, k, 1]
            val = _bilinear(xf, sy, sx, h, w) * msk[:, :, k]
            acc = acc + matmul(wd[:, :, k // 3, k % 3], val)
    out = acc / len(dilations) + biases.mean(0)[:, None]
    return out.reshape(b, -1, h, w)
