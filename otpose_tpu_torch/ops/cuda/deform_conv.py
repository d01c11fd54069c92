"""Multi-dilation modulated deformable conv (counterpart of
``otpose_tpu/ops/deform_conv.py::modulated_deform_conv_multi``).

The mean over D dilations of a 3x3 DCNv2 with padding equal to the
dilation, stride 1 and one channel per deformable group (the OTPose
refinement, ref: model/OTPose.py:381-394).  Layouts are NCHW: offsets
(B, 2*9*C, H, W) in (group, tap, y/x) channel order, raw masks
(B, 9*C, H, W), weights (D, O, C, 3, 3), biases (D, O).  Sample positions,
bilinear weights and sums are f32 whatever the input dtype; the result is
rounded once to ``x.dtype``.

On a CUDA tensor it launches ``csrc/deform_conv.cu`` in its exact mode; on a
CPU tensor it runs ``modulated_deform_conv_multi_plain``, the same function
in plain PyTorch.  The same kernel, in its other mode, serves
``deform_conv_fused.deform_conv_fused`` through ``launch``.  A CUDA call
goes through ``DeformConvFn``, whose backward launches
``csrc/deform_conv_bwd.cu`` (every gradient: x, offsets, masks, weights,
biases); on the CPU the plain version's autograd is the plain backward.

``pack_dcn_weights`` puts the weights in the kernel's layout once
(``models/otpose.py::dcn_pack`` caches the result on the model); the
wrappers take either the raw weights, which they pack on every call, or
such a pack.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from otpose_tpu_torch.ops.cuda import build

# wrapper calls (either path), kernel launches (CUDA path only; the forward's
# and the backward's) and packs made
calls = 0
launches = 0
bwd_launches = 0
packs = 0

EXACT, PALLAS3 = 0, 1          # the kernel's rounding modes
OUTPUT_PADS = (8, 20, 32)      # O is zero-padded to the first of these that holds it

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "otp_deform": (_I, [_P, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I),
                        _P, _P, _P, _P] + [_I] * 11 + [_P]),
    "otp_deform_max_groups": (_I, []),
    "otp_deform_tile": (_I, [_I]),
}
_BWD_SIGNATURES = {
    "otp_deform_bwd": (_I, [_P, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I)]
                       + [_P] * 8 + [_I] * 8 + [_P]),
    "otp_deform_bwd_tile": (_I, []),
}


@dataclass(frozen=True)
class DcnPack:
    """The DCN weights in the kernel's layout: ``w`` (D, C, 9, OP) f32 with
    row c * 9 + k the weights of group c, tap k = 3 * ky + kx (the mask
    channel order), zero past O; ``bias`` (OP,) f32, the mean over D of the
    biases, zero past O."""
    d: int
    c: int
    o: int
    w: torch.Tensor
    bias: torch.Tensor


@torch.no_grad()
def pack_dcn_weights(weights, biases, device=None) -> DcnPack:
    """Weights (D, O, C, 3, 3) and biases (D, O) in the kernel's layout."""
    global packs
    d, o, c = weights.shape[:3]
    if tuple(weights.shape) != (d, o, c, 3, 3) or tuple(biases.shape) != (d, o):
        raise ValueError("deform conv: weights must be (D, O, C, 3, 3) and biases (D, O)")
    if o > OUTPUT_PADS[-1]:
        raise ValueError(f"deform conv: O={o} is above the kernel's {OUTPUT_PADS[-1]}")
    op = next(p for p in OUTPUT_PADS if p >= o)
    device = weights.device if device is None else device
    w = torch.zeros(d, c, 9, op, device=device)
    w[..., :o] = weights.to(device=device, dtype=torch.float32).permute(0, 2, 3, 4, 1).reshape(
        d, c, 9, o)
    bias = torch.zeros(op, device=device)
    bias[:o] = biases.to(device=device, dtype=torch.float32).mean(0)
    packs += 1
    return DcnPack(d, c, o, w, bias)


def unpack(pk: DcnPack):
    """(weights (D, O, C, 3, 3), biases (1, O)) with the pack's values: the
    plain versions' arguments (the mean over one row of biases is the row)."""
    w = pk.w[..., :pk.o].reshape(pk.d, pk.c, 3, 3, pk.o).permute(0, 4, 1, 2, 3)
    return w, pk.bias[None, :pk.o]


def _bilinear(xf, sy, sx, h: int, w: int):
    """Zero-padded bilinear samples of xf (B, C, H*W) at f32 positions
    (B, C, P); a sample contributes when -1 < y < H and -1 < x < W."""
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


def modulated_deform_conv_multi_plain(x, offsets_list, masks_list, weights,
                                      biases, dilations) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    b, c, h, w = x.shape
    p = h * w
    xf = x.float().reshape(b, c, p)
    py = torch.arange(h, device=x.device, dtype=torch.float32)[:, None].expand(h, w).reshape(p)
    px = torch.arange(w, device=x.device, dtype=torch.float32)[None, :].expand(h, w).reshape(p)
    acc = torch.zeros(b, weights.shape[1], p, device=x.device, dtype=torch.float32)
    for off, msk, wd, dil in zip(offsets_list, masks_list, weights, dilations):
        off = off.float().reshape(b, c, 9, 2, p)
        msk = msk.float().reshape(b, c, 9, p)
        wd = wd.float()
        for k in range(9):
            sy = (py + float((k // 3) * dil - dil)) + off[:, :, k, 0]
            sx = (px + float((k % 3) * dil - dil)) + off[:, :, k, 1]
            val = _bilinear(xf, sy, sx, h, w) * msk[:, :, k]
            acc = acc + torch.einsum("oc,bcp->bop", wd[:, :, k // 3, k % 3], val)
    out = acc / len(dilations) + biases.float().mean(0)[:, None]
    return out.reshape(b, -1, h, w).to(x.dtype)


def plain_args(weights, biases, packed):
    """The raw weights and biases a plain version takes: as given, or
    unpacked from ``packed``."""
    return (weights, biases) if packed is None else unpack(packed)


def _check_maps(what: str, x, offsets_list, masks_list, pk: DcnPack, dilations):
    """Raise unless the maps have the layouts above, all contiguous and in
    x's dtype and device, and match the pack's D and C."""
    b, c, h, w = x.shape
    d = len(dilations)
    if (pk.d, pk.c) != (d, c) or pk.w.device != x.device:
        raise ValueError(f"{what}: weights packed for D={pk.d}, C={pk.c} on {pk.w.device}; "
                         f"the call has D={d}, C={c} on {x.device}")
    if len(offsets_list) != d or len(masks_list) != d:
        raise ValueError(f"{what}: one offset and mask map per dilation")
    for t, ch in [(x, c)] + [(t, 18 * c) for t in offsets_list] + [(t, 9 * c) for t in masks_list]:
        if (t.dtype != x.dtype or t.device != x.device or not t.is_contiguous()
                or tuple(t.shape) != (b, ch, h, w)):
            raise ValueError(f"{what}: inputs must be contiguous NCHW tensors of x's dtype "
                             f"and device; got {tuple(t.shape)}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def stage_split(b: int, tiles: int, sms: int, stages: int) -> int:
    """Blocks over which each of the ``b * tiles`` (item, pixel tile) blocks'
    ``stages`` (channel, dilation) stages are split: 1 when those blocks
    give every SM one, else enough for two a SM (B = 1 at the flagship
    shape on 132 SMs: 14 tiles, 19 blocks a tile), at most one a stage."""
    return 1 if tiles * b >= sms else min(stages, -(-2 * sms // (tiles * b)))


def launch(mode: int, what: str, x, offsets_list, masks_list, weights, biases, dilations,
           packed: DcnPack | None) -> torch.Tensor:
    """Run ``csrc/deform_conv.cu`` in ``mode`` (EXACT or PALLAS3) on CUDA
    tensors; raises on what the kernel does not take.  When B x tiles leaves
    SMs without a block (B = 1), the (channel, dilation) stages are split
    (``stage_split``); the blocks write f32 partial sums, which a second
    kernel adds in a fixed order."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    code = build.dtype_code(x.dtype)
    if packed is None:
        packed = pack_dcn_weights(weights, biases, device=x.device)
    _check_maps(what, x, offsets_list, masks_list, packed, dilations)
    lib = build.load("deform_conv", _SIGNATURES)
    b, c, h, w = x.shape
    d, o, op = packed.d, packed.o, packed.w.shape[-1]
    if d > lib.otp_deform_max_groups():
        raise ValueError(f"{what}: D={d} is above the kernel's {lib.otp_deform_max_groups()}")
    tiles = -(-h * w // lib.otp_deform_tile(code))
    sms = _sm_count(x.device.index if x.device.index is not None
                    else torch.cuda.current_device())
    split = stage_split(b, tiles, sms, c * d)
    # 16-byte copies of the offset and mask rows and of the x plane's image
    # rows need 16-byte aligned rows
    maps = [x, *offsets_list, *masks_list]
    wide = (w * x.element_size()) % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in maps)
    out = torch.empty(b, o, h, w, device=x.device, dtype=x.dtype)
    partial = (torch.empty(split, b, o, h * w, device=x.device, dtype=torch.float32)
               if split > 1 else None)
    offs = (ctypes.c_void_p * d)(*[t.data_ptr() for t in offsets_list])
    msks = (ctypes.c_void_p * d)(*[t.data_ptr() for t in masks_list])
    dils = (ctypes.c_int * d)(*[int(v) for v in dilations])
    err = lib.otp_deform(
        x.data_ptr(), offs, msks, dils, packed.w.data_ptr(), packed.bias.data_ptr(),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        b, c, o, op, h, w, d, split, mode, int(wide), code,
        build.stream_ptr(x.device))
    build.check(lib, err, what)
    return out


def launch_backward(g, x, offsets_list, masks_list, packed: DcnPack, dilations):
    """Run ``csrc/deform_conv_bwd.cu`` on CUDA tensors: the gradients of the
    exact mode's output with respect to x, each offset and mask map, the
    weights (D, O, C, 3, 3) and the biases (D, O), from the output's
    gradient ``g`` (B, O, H, W).  d x, d W and d bias are computed in f32;
    d x is returned in x's dtype, d W and d bias in f32."""
    global bwd_launches
    what = "modulated_deform_conv_multi backward"
    code = build.dtype_code(x.dtype)
    _check_maps(what, x, offsets_list, masks_list, packed, dilations)
    b, c, h, w = x.shape
    d, o, op = packed.d, packed.o, packed.w.shape[-1]
    g = g.to(x.dtype).contiguous()
    if tuple(g.shape) != (b, o, h, w):
        raise ValueError(f"{what}: the output's gradient has shape {tuple(g.shape)}")
    lib = build.load("deform_conv_bwd", _BWD_SIGNATURES)
    tiles = -(-h * w // lib.otp_deform_bwd_tile())
    dev = x.device
    d_off = torch.empty(d, b, 18 * c, h, w, device=dev, dtype=x.dtype)
    d_mask = torch.empty(d, b, 9 * c, h, w, device=dev, dtype=x.dtype)
    dx = torch.zeros(b, c, h, w, device=dev, dtype=torch.float32)
    partial = torch.empty(b * tiles, c, d * 9 + 1, o, device=dev, dtype=torch.float32)
    dw = torch.empty(d, o, c, 3, 3, device=dev, dtype=torch.float32)
    dbias = torch.empty(d, o, device=dev, dtype=torch.float32)
    offs = (ctypes.c_void_p * d)(*[t.data_ptr() for t in offsets_list])
    msks = (ctypes.c_void_p * d)(*[t.data_ptr() for t in masks_list])
    dils = (ctypes.c_int * d)(*[int(v) for v in dilations])
    err = lib.otp_deform_bwd(x.data_ptr(), offs, msks, dils, packed.w.data_ptr(), g.data_ptr(),
                             d_off.data_ptr(), d_mask.data_ptr(), dx.data_ptr(),
                             partial.data_ptr(), dw.data_ptr(), dbias.data_ptr(),
                             b, c, o, op, h, w, d, code, build.stream_ptr(dev))
    build.check(lib, err, what)
    bwd_launches += 1
    return dx.to(x.dtype), list(d_off.unbind(0)), list(d_mask.unbind(0)), dw, dbias


class DeformConvFn(torch.autograd.Function):
    """The exact-mode kernel with its backward kernel.  Arguments: x, the
    raw weights and biases (or None, with ``packed``), the pack (or None:
    the raw weights are packed once a call, without grad), the dilations,
    then the D offset maps and the D mask maps."""

    @staticmethod
    def forward(ctx, x, weights, biases, packed, dilations, *maps):
        global launches
        d = len(dilations)
        offsets_list, masks_list = list(maps[:d]), list(maps[d:])
        if packed is None:
            packed = pack_dcn_weights(weights, biases, device=x.device)
        out = launch(EXACT, "modulated_deform_conv_multi", x, offsets_list, masks_list, None,
                     None, dilations, packed)
        launches += 1
        ctx.save_for_backward(x, *maps)
        ctx.packed, ctx.dilations = packed, dilations
        ctx.wdtype = None if weights is None else (weights.dtype, biases.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, *maps = ctx.saved_tensors
        d = len(ctx.dilations)
        dx, d_off, d_mask, dw, dbias = launch_backward(g, x, maps[:d], maps[d:], ctx.packed,
                                                       ctx.dilations)
        if ctx.wdtype is None:
            dw = dbias = None
        else:
            dw, dbias = dw.to(ctx.wdtype[0]), dbias.to(ctx.wdtype[1])
        return (dx, dw, dbias, None, None, *d_off, *d_mask)


def modulated_deform_conv_multi(x, offsets_list, masks_list, weights=None, biases=None,
                                dilations=(), *, packed: DcnPack | None = None) -> torch.Tensor:
    """x: (B, C, H, W) -> (B, O, H, W); see the module docstring.  Or, in
    place of ``weights`` and ``biases``, ``packed`` from ``pack_dcn_weights``."""
    global calls
    calls += 1
    if x.device.type == "cpu":
        return modulated_deform_conv_multi_plain(x, offsets_list, masks_list,
                                                 *plain_args(weights, biases, packed), dilations)
    return DeformConvFn.apply(x, weights, biases, packed, tuple(dilations), *offsets_list,
                              *masks_list)
