"""One-token shifts along the last axis (counterpart of the probe kernels of
``tools/probe_shift.py``).

``token_shift(x, mode)`` on a contiguous (R, L) bf16 or f32 tensor:

- ``right``: ``out[:, j] = x[:, j - 1]``, column 0 zero;
- ``left``: ``out[:, j] = x[:, j + 1]``, column L - 1 zero;
- ``rotate``: right rotation, column 0 takes column L - 1;
- ``handoff``: column 0 takes column L - 1, zeros elsewhere.

The wrapper calls the registered op ``otpose::token_shift``: on a CUDA
tensor it launches ``csrc/token_shift.cu`` (16-byte loads and stores with
the one-element displacement made in registers; a contiguous view that does
not start where its output does, relative to a 16-byte boundary, takes that
source's element-wise kernel), on a CPU tensor it runs
``token_shift_plain``, the same function as slices and ``torch.cat``.  Both
copy values exactly.  It has no backward: on a CUDA tensor under grad the
wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from otpose_tpu_torch.ops.cuda import build

MODES = ("right", "left", "rotate", "handoff")

# op calls (either device) and kernel launches (CUDA only)
calls = 0
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "otp_token_shift": (_I, [_P, _P, ctypes.c_longlong, _I, _I, _I, _P]),
}


def token_shift_plain(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    zero = torch.zeros_like(x[:, :1])
    if mode == "right":
        return torch.cat([zero, x[:, :-1]], dim=1)
    if mode == "left":
        return torch.cat([x[:, 1:], zero], dim=1)
    if mode == "rotate":
        return torch.cat([x[:, -1:], x[:, :-1]], dim=1)
    if mode == "handoff":
        return torch.cat([x[:, -1:], torch.zeros_like(x[:, 1:])], dim=1)
    raise ValueError(f"token_shift: mode {mode!r} is not one of {MODES}")


@torch.library.custom_op("otpose::token_shift", mutates_args=(), device_types="cpu")
def token_shift_op(x: torch.Tensor, mode: str) -> torch.Tensor:
    """CPU: the plain version."""
    global calls
    calls += 1
    return token_shift_plain(x, mode)


@token_shift_op.register_kernel("cuda")
def _token_shift_cuda(x, mode):
    global calls, launches
    calls += 1
    if not x.is_contiguous():
        raise ValueError("token_shift: x must be contiguous")
    build.dtype_code(x.dtype)             # raises unless float32 or bfloat16
    lib = build.load("token_shift", _SIGNATURES)
    out = torch.empty_like(x)
    err = lib.otp_token_shift(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                              x.element_size(), MODES.index(mode), build.stream_ptr(x.device))
    build.check(lib, err, "token_shift")
    launches += 1
    return out


@token_shift_op.register_fake
def _token_shift_fake(x, mode):
    return torch.empty_like(x)


def token_shift(x: torch.Tensor, mode: str) -> torch.Tensor:
    """x: contiguous (R, L), R, L >= 1 -> (R, L); see the module docstring."""
    if mode not in MODES:
        raise ValueError(f"token_shift: mode {mode!r} is not one of {MODES}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"token_shift: x must be (R, L) with R, L >= 1, got {tuple(x.shape)}")
    build.check_device("token_shift", x)
    build.refuse_grad("token_shift", x)
    return token_shift_op(x, mode)
