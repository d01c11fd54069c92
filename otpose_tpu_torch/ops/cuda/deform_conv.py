"""Multi-dilation modulated deformable conv (counterpart of
``otpose_tpu/ops/deform_conv.py::modulated_deform_conv_multi``).

The mean over D dilations of a 3x3 DCNv2 with padding equal to the
dilation, stride 1 and one channel per deformable group (the OTPose
refinement, ref: model/OTPose.py:381-394).  Layouts are NCHW: offsets
(B, 2*9*C, H, W) in (group, tap, y/x) channel order, raw masks
(B, 9*C, H, W), weights (D, O, C, 3, 3), biases (D, O).  Sample positions,
bilinear weights and sums are f32 whatever the input dtype; the result is
rounded once to ``x.dtype``.

On a CUDA tensor it launches ``csrc/deform_conv.cu``; on a CPU tensor it runs
``modulated_deform_conv_multi_plain``, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from otpose_tpu_torch.ops.cuda import build

# wrapper calls (either path) and kernel launches (CUDA path only)
calls = 0
launches = 0

_SMEM_LIMIT = 232448   # bytes of shared memory one H100 block may use
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "otp_deform_multi": (_I, [_P, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I),
                              _P, _P, _P] + [_I] * 7 + [_P]),
    "otp_deform_max_groups": (_I, []),
}


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


def check_args(what: str, x, offsets_list, masks_list, weights, biases, dilations):
    """Raise unless the arguments have the layouts above, all maps contiguous
    and in x's dtype and device; returns (B, C, O, H, W, D)."""
    b, c, h, w = x.shape
    d = len(dilations)
    o = weights.shape[1]
    if tuple(weights.shape) != (d, o, c, 3, 3) or tuple(biases.shape) != (d, o):
        raise ValueError(f"{what}: weights must be (D, O, C, 3, 3) and biases (D, O)")
    if len(offsets_list) != d or len(masks_list) != d:
        raise ValueError(f"{what}: one offset and mask map per dilation")
    for t, ch in [(x, c)] + [(t, 18 * c) for t in offsets_list] + [(t, 9 * c) for t in masks_list]:
        if (t.dtype != x.dtype or t.device != x.device or not t.is_contiguous()
                or tuple(t.shape) != (b, ch, h, w)):
            raise ValueError(f"{what}: inputs must be contiguous NCHW tensors of x's dtype "
                             f"and device; got {tuple(t.shape)}")
    return b, c, o, h, w, d


def modulated_deform_conv_multi(x, offsets_list, masks_list, weights, biases,
                                dilations) -> torch.Tensor:
    """x: (B, C, H, W) -> (B, O, H, W); see the module docstring."""
    global calls, launches
    calls += 1
    if x.device.type == "cpu":
        return modulated_deform_conv_multi_plain(x, offsets_list, masks_list,
                                                 weights, biases, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"modulated_deform_conv_multi: unsupported device {x.device}")
    b, c, o, h, w, d = check_args("modulated_deform_conv_multi", x, offsets_list, masks_list,
                                  weights, biases, dilations)
    code = build.dtype_code(x.dtype)
    lib = build.load("deform_conv", _SIGNATURES)
    if d > lib.otp_deform_max_groups() or o > 32 or 4 * d * 9 * c * o > _SMEM_LIMIT:
        raise ValueError(f"modulated_deform_conv_multi: D={d}, C={c}, O={o} is "
                         "beyond the kernel's limits")
    wk = weights.float().permute(0, 3, 4, 2, 1).contiguous()     # (D, 3, 3, C, O)
    bias_mean = biases.float().mean(0).contiguous()
    out = torch.empty(b, o, h, w, device=x.device, dtype=x.dtype)
    offs = (ctypes.c_void_p * d)(*[t.data_ptr() for t in offsets_list])
    msks = (ctypes.c_void_p * d)(*[t.data_ptr() for t in masks_list])
    dils = (ctypes.c_int * d)(*[int(v) for v in dilations])
    err = lib.otp_deform_multi(
        x.data_ptr(), offs, msks, dils, wk.data_ptr(), bias_mean.data_ptr(),
        out.data_ptr(), b, c, o, h, w, d, code, build.stream_ptr(x.device))
    build.check(lib, err, "modulated_deform_conv_multi")
    launches += 1
    return out
