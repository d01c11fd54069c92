"""Deformable convolutions in plain PyTorch (counterpart of
``otpose_tpu/ops/deform_conv.py``'s DCN variants).

The package-API surface of the reference's CUDA op (ref: thirdparty/
deform_conv/src/deform_conv_cuda.cpp:148-551): DCNv2 (``modulated_deform_conv``,
with weight ``groups``; ``modulated_deform_conv_gather``), DCNv1
(``deform_conv``) and the identity weight init.  OTPose itself runs only the
five-dilation refinement, whose kernel is ``ops/cuda/deform_conv.py``; these
are XLA in the JAX package and plain PyTorch here, on either device.

Layouts are the port's: x (B, C, H, W); weight (O, C / groups, k, k); offsets
(B, dg * 2 * k * k, Ho, Wo) in (deformable group, tap, dy / dx) order; masks
(B, dg * k * k, Ho, Wo), raw (no sigmoid, ref: model/OTPose.py:381-385);
the output is (B, O, Ho, Wo) with Ho, Wo those of the offsets.  Tap
``i * k + j`` of output (y, x) samples x at
``(y * stride - padding + i * dilation + dy, x * stride - padding + j * dilation + dx)``
bilinearly: a sample with h in (-1, H) and w in (-1, W) takes its in-bounds
corners, anything else is zero.
"""

from __future__ import annotations

import torch


def _sampled(x, offsets, mask, kernel: int, stride: int, padding: int, dilation: int,
             dg: int) -> torch.Tensor:
    """Each tap's bilinear sample times its mask, (B, dg, C / dg, k * k, Ho,
    Wo) in ``x.dtype``; coordinates in f32."""
    b, c, h, w = x.shape
    k2 = kernel * kernel
    ho, wo = offsets.shape[-2:]
    dev = x.device
    ys = (torch.arange(ho, device=dev, dtype=torch.float32) * stride - padding)
    xs = (torch.arange(wo, device=dev, dtype=torch.float32) * stride - padding)
    ki = torch.arange(k2, device=dev, dtype=torch.float32)
    tap_y = torch.floor(ki / kernel) * dilation
    tap_x = (ki % kernel) * dilation
    off = offsets.float().reshape(b, dg, k2, 2, ho, wo)
    sy = ys[:, None] + tap_y[:, None, None] + off[:, :, :, 0]          # (B, dg, K2, Ho, Wo)
    sx = xs[None, :] + tap_x[:, None, None] + off[:, :, :, 1]
    valid = (sy > -1) & (sy < h) & (sx > -1) & (sx < w)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0).to(x.dtype), (sx - x0).to(x.dtype)
    y0i, x0i = y0.long(), x0.long()
    cpg = c // dg
    xg = x.reshape(b, dg, cpg, h * w)

    def corner(yi, xi):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, dg, 1, -1)
        vals = torch.gather(xg, 3, idx.expand(b, dg, cpg, idx.shape[-1]))
        return vals.reshape(b, dg, cpg, k2, ho, wo) * ok[:, :, None].to(x.dtype)

    wyt, wxt = wy[:, :, None], wx[:, :, None]
    top = corner(y0i, x0i) * (1 - wxt) + corner(y0i, x0i + 1) * wxt
    bot = corner(y0i + 1, x0i) * (1 - wxt) + corner(y0i + 1, x0i + 1) * wxt
    sampled = (top * (1 - wyt) + bot * wyt) * valid[:, :, None].to(x.dtype)
    m = mask.reshape(b, dg, 1, k2, ho, wo).to(x.dtype)
    return sampled * m


def _contract(sampled, weight, dg: int) -> torch.Tensor:
    """out[b, o] = sum over (group, channel, tap) of sampled * weight, in f32."""
    o, cin, kh, kw = weight.shape
    wk = weight.float().reshape(o, dg, cin // dg, kh * kw)
    return torch.einsum("bgckhw,ogck->bohw", sampled.float(), wk)


def modulated_deform_conv_gather(x, offsets, mask, weight, bias=None, *, kernel: int = 3,
                                 stride: int = 1, padding: int = 1, dilation: int = 1,
                                 deformable_groups: int = 1) -> torch.Tensor:
    """DCNv2 by gathers: samples and their bilinear blend in ``x.dtype``, the
    weight contraction summed in f32 and rounded to ``x.dtype``, then the
    bias in ``x.dtype``."""
    s = _sampled(x, offsets, mask, kernel, stride, padding, dilation, deformable_groups)
    out = _contract(s, weight, deformable_groups).to(x.dtype)
    return out if bias is None else out + bias.to(out.dtype)[:, None, None]


def identity_filler_weight(channels: int, kernel: int = 3) -> torch.Tensor:
    """The reference ModulatedDeformConv's identity init: 1 at the kernel's
    centre on the diagonal (ref: model/OTPose.py:462-469), (C, C, k, k)."""
    w = torch.zeros(channels, channels, kernel, kernel)
    diag = torch.arange(channels)
    w[diag, diag, kernel // 2, kernel // 2] = 1.0
    return w


def modulated_deform_conv(x, offsets, mask, weight, bias=None, *, kernel: int = 3,
                          stride: int = 1, padding: int = 1, dilation: int = 1,
                          deformable_groups: int = 1, groups: int = 1) -> torch.Tensor:
    """DCNv2 with every product and sum in f32, the bias added in f32 and the
    result rounded once to ``x.dtype`` (the JAX function's tent form).

    ``groups`` is the weight-group count of the reference ModulatedDeformConv:
    weight (O, C / groups, k, k), each group convolving its channel slice
    with its share of the deformable groups, which must divide evenly
    (``deformable_groups % groups == 0``, else ``ValueError``).  The groups'
    outputs are concatenated and the bias is added once after."""
    if groups > 1:
        if deformable_groups % groups:
            raise ValueError("deformable_groups must be divisible by groups")
        b, c = x.shape[:2]
        ho, wo = offsets.shape[-2:]
        cin_g, cout_g = c // groups, weight.shape[0] // groups
        dg_g = deformable_groups // groups
        off = offsets.reshape(b, groups, -1, ho, wo)
        msk = mask.reshape(b, groups, -1, ho, wo)
        out = torch.cat([
            modulated_deform_conv(x[:, g * cin_g:(g + 1) * cin_g], off[:, g], msk[:, g],
                                  weight[g * cout_g:(g + 1) * cout_g], None, kernel=kernel,
                                  stride=stride, padding=padding, dilation=dilation,
                                  deformable_groups=dg_g)
            for g in range(groups)], dim=1)
        return out if bias is None else out + bias.to(out.dtype)[:, None, None]
    s = _sampled(x.float(), offsets, mask.float(), kernel, stride, padding, dilation,
                 deformable_groups)
    out = _contract(s, weight, deformable_groups)
    if bias is not None:
        out = out + bias.float()[:, None, None]
    return out.to(x.dtype)


def deform_conv(x, offsets, weight, bias=None, *, kernel: int = 3, stride: int = 1,
                padding: int = 1, dilation: int = 1, deformable_groups: int = 1,
                groups: int = 1) -> torch.Tensor:
    """DCNv1 (unmodulated): DCNv2 with an all-ones mask in ``x.dtype``
    (ref: thirdparty/deform_conv/functions/deform_conv.py::deform_conv)."""
    b = x.shape[0]
    ho, wo = offsets.shape[-2:]
    ones = torch.ones(b, deformable_groups * kernel * kernel, ho, wo, dtype=x.dtype,
                      device=x.device)
    return modulated_deform_conv(x, offsets, ones, weight, bias, kernel=kernel, stride=stride,
                                 padding=padding, dilation=dilation,
                                 deformable_groups=deformable_groups, groups=groups)
