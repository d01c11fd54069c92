"""Fused transformer MLP (counterpart of ``otpose_tpu/ops/pallas/fused_mlp.py``).

``fused_mlp_residual_ct`` computes ``x + W2 @ gelu(W1 @ LN_C(x) + b1) + b2``
on (B, C, T), the ln2 + mlp + residual tail of an eval transformer block.
On a CUDA tensor it launches ``csrc/fused_mlp.cu``; on a CPU tensor it runs
``fused_mlp_plain``, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from otpose_tpu_torch.models import core
from otpose_tpu_torch.ops.cuda import build

# wrapper calls (either path) and kernel launches (CUDA path only)
calls = 0
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "otp_fused_mlp": (_I, [_P] * 8 + [_I] * 5 + [_P]),
    "otp_fused_mlp_max_channels": (_I, []),
}


def fused_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    h = core.layer_norm_ct(x, ln_w, ln_b)
    h = core.gelu(core.dense_1x1_ct(h, w1, b1))
    return x + core.dense_1x1_ct(h, w2, b2)


def fused_mlp_residual_ct(x, ln_w, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """x: (B, C, T).  ``w1`` (4C, C, 1) and ``w2`` (C, 4C, 1) are the conv1d
    kernels with biases (4C,) and (C,); ``ln_w``/``ln_b`` the f32 LN affine,
    (1, C, 1) or (C,)."""
    global calls, launches
    calls += 1
    if x.device.type == "cpu":
        return fused_mlp_plain(x, ln_w, ln_b, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_residual_ct: unsupported device {x.device}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_mlp_residual_ct: x must be a contiguous (B, C, T) tensor")
    bsz, c, t = x.shape
    hid = w1.shape[0]
    if w1.shape[:2] != (hid, c) or w2.shape[:2] != (c, hid):
        raise ValueError(f"fused_mlp_residual_ct: weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not match C={c}")
    code = build.dtype_code(x.dtype)
    lib = build.load("fused_mlp", _SIGNATURES)
    if c > lib.otp_fused_mlp_max_channels():
        raise ValueError(f"fused_mlp_residual_ct: C={c} is above the kernel's "
                         f"{lib.otp_fused_mlp_max_channels()}")
    dt, dev = x.dtype, x.device

    def vec(a, n, what, rounded=True):
        # rounded: a weight the model applies in the compute dtype
        return build.f32_vector(a.to(dt) if rounded else a, n,
                                f"fused_mlp_residual_ct {what}", dev)

    lnw, lnb = vec(ln_w, c, "ln weight", False), vec(ln_b, c, "ln bias", False)
    w1f, b1f = vec(w1, hid * c, "w1"), vec(b1, hid, "b1")
    w2f, b2f = vec(w2, c * hid, "w2"), vec(b2, c, "b2")
    out = torch.empty_like(x)
    err = lib.otp_fused_mlp(
        *(a.data_ptr() for a in (x, out, lnw, lnb, w1f, b1f, w2f, b2f)),
        bsz, c, hid, t, code, build.stream_ptr(dev))
    build.check(lib, err, "fused_mlp_residual_ct")
    launches += 1
    return out
