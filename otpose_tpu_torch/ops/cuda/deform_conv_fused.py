"""Fused-sampling multi-dilation DCN (counterpart of
``tools/exp_deform_pallas3.py::make_pallas3``).

The same function as ``deform_conv.modulated_deform_conv_multi`` (mean over
D dilations of a 3x3 DCNv2, one channel per deformable group, raw masks),
with the same arguments and NCHW layouts, computed with the rounding points
of the TPU experiment: the separable tent weights of the y axis are rounded
to the compute dtype while the x weights stay f32, each sample is rounded,
multiplied by its mask in the compute dtype and rounded again, and the
weight contraction is f32 with f32 weights.  In f32 it equals
``modulated_deform_conv_multi``.

The wrapper calls the registered op ``otpose::deform_conv_fused``: on a
CUDA tensor it launches ``csrc/deform_conv.cu``, the model's DCN kernel, in
its make_pallas3 rounding mode; on a CPU tensor it runs
``deform_conv_fused_plain``, the same function in plain PyTorch, from the
pack's weights.  It has no backward.
"""

from __future__ import annotations

import torch

from otpose_tpu_torch.ops.cuda import build
from otpose_tpu_torch.ops.cuda.deform_conv import (PALLAS3, DcnPack, kernel_launches, launch,
                                                   pack_dcn_weights, pack_of, unpack)
from otpose_tpu_torch.utils import profiling


def _tent_sample(xf, sy, sx, h: int, w: int, rnd):
    """make_pallas3's separable tent sample of xf (B, C, H*W) at f32
    positions (B, C, P), at the two integer neighbours on each axis: the y
    weights ``max(0, 1 - |sy - y|)`` rounded by ``rnd``, the x weights f32,
    rows summed per column first; zero outside the image."""
    y0, x0 = torch.floor(sy), torch.floor(sx)
    cols = []
    for xx in (x0, x0 + 1):
        col = torch.zeros_like(sy)
        for yy in (y0, y0 + 1):
            wy = rnd(torch.clamp(1 - (sy - yy).abs(), min=0))
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            v = torch.gather(xf, 2, idx)
            col = col + torch.where(ok, v * wy, torch.zeros_like(v))
        cols.append(col * torch.clamp(1 - (sx - xx).abs(), min=0))
    return cols[0] + cols[1]


def deform_conv_fused_plain(x, offsets_list, masks_list, weights, biases,
                            dilations) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    b, c, h, w = x.shape
    p = h * w
    cd = x.dtype

    def rnd(t):
        return t.to(cd).float()

    xf = x.float().reshape(b, c, p)
    py = torch.arange(h, device=x.device, dtype=torch.float32)[:, None].expand(h, w).reshape(p)
    px = torch.arange(w, device=x.device, dtype=torch.float32)[None, :].expand(h, w).reshape(p)
    acc = torch.zeros(b, weights.shape[1], p, device=x.device, dtype=torch.float32)
    for off, msk, wd, dil in zip(offsets_list, masks_list, weights, dilations):
        off = off.float().reshape(b, c, 9, 2, p)
        msk = msk.float().reshape(b, c, 9, p)
        wd = wd.float()
        for k in range(9):
            sy = (off[:, :, k, 0] + float((k // 3) * dil - dil)) + py
            sx = (off[:, :, k, 1] + float((k % 3) * dil - dil)) + px
            val = rnd(rnd(_tent_sample(xf, sy, sx, h, w, rnd)) * msk[:, :, k])
            acc = acc + torch.einsum("oc,bcp->bop", wd[:, :, k // 3, k % 3], val)
    out = acc / len(dilations) + biases.float().mean(0)[:, None]
    return out.reshape(b, -1, h, w).to(cd)


@torch.library.custom_op("otpose::deform_conv_fused", mutates_args=(), device_types="cpu")
def deform_conv_fused_op(x: torch.Tensor, offsets: list[torch.Tensor],
                         masks: list[torch.Tensor], pack_w: torch.Tensor,
                         pack_bias: torch.Tensor, dilations: list[int], o: int) -> torch.Tensor:
    """CPU: the plain version from the pack (``pack_w``, ``pack_bias`` and O
    of a ``DcnPack``)."""
    profiling.count("deform_conv_fused.calls")
    return deform_conv_fused_plain(x, offsets, masks, *unpack(pack_of(pack_w, pack_bias, o)),
                                   dilations)


@deform_conv_fused_op.register_kernel("cuda")
def _deform_conv_fused_cuda(x, offsets, masks, pack_w, pack_bias, dilations, o):
    profiling.count("deform_conv_fused.calls")
    out = launch(PALLAS3, "deform_conv_fused", x, offsets, masks, None, None, dilations,
                 pack_of(pack_w, pack_bias, o))
    profiling.count("deform_conv_fused.launches", kernel_launches(len(dilations), o, PALLAS3))
    return out


@deform_conv_fused_op.register_fake
def _deform_conv_fused_fake(x, offsets, masks, pack_w, pack_bias, dilations, o):
    return x.new_empty(x.shape[0], o, x.shape[2], x.shape[3])


def deform_conv_fused(x, offsets_list, masks_list, weights=None, biases=None, dilations=(), *,
                      packed: DcnPack | None = None) -> torch.Tensor:
    """x: (B, C, H, W) -> (B, O, H, W); the arguments of
    ``deform_conv.modulated_deform_conv_multi``."""
    build.check_device("deform_conv_fused", x)
    if packed is None:
        packed = pack_dcn_weights(weights, biases, device=x.device)
    return deform_conv_fused_op(x, list(offsets_list), list(masks_list), packed.w, packed.bias,
                                [int(v) for v in dilations], packed.o)
