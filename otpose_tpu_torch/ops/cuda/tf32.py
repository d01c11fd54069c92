"""A plain PyTorch emulation of the split TF32 arithmetic of the f32 kernels
(``csrc/mma.cuh``), for the tests: the kernels and wrappers never call it.

``round_tf32`` rounds f32 values to TF32 (10 explicit mantissa bits) to
nearest, ties away from zero, on the bits, as ``cvt.rna.tf32.f32`` does;
``split_tf32`` gives the kernels' (hi, lo); ``matmul_tf32`` is one TF32 pass
(operands rounded, each product exact in f32, f32 sums) and
``matmul_3xtf32`` the kernels' three passes, lo hi + hi lo + hi hi.
"""

from __future__ import annotations

import torch

_HALF = 0x1000            # half of the 13 bits TF32 drops
_KEEP = 0xFFFFE000        # the 19 bits it keeps


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (an f32 tensor whose low 13 bits are 0);
    infinities and NaNs pass through."""
    x = x.float().contiguous()
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = torch.where(torch.isfinite(x), (bits + _HALF) & _KEEP, bits)
    return (r - ((r >> 31) << 32)).to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = x rounded to TF32, lo = (x - hi) rounded to TF32."""
    hi = round_tf32(x)
    return hi, round_tf32(x.float() - hi)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass."""
    return round_tf32(a) @ round_tf32(b)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in three TF32 passes, small terms first."""
    (ahi, alo), (bhi, blo) = split_tf32(a), split_tf32(b)
    return (alo @ bhi + ahi @ blo) + ahi @ bhi
