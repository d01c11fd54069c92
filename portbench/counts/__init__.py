"""The benchmark's arithmetic: the H100's peaks, each kernel's bytes and
operations from its shapes, and the least time they allow.

Peaks are NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s bf16, 495 TF32,
67 float32 outside the tensor cores, 3.35 TB/s of HBM.  A product runs at
the tensor-core rate of its dtype; in float32 as three TF32 passes (the
split that keeps float32 accuracy on the tensor cores).  A kernel's least
time is the longest of its bytes at the memory rate and each kind of its
operations at its own rate.  Each input byte is counted read once and each
output byte written once, weights included.
"""

from __future__ import annotations

import dataclasses

PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def product_peak(dtype: str) -> float:
    return PEAK_BF16 if dtype == "bfloat16" else PEAK_TF32 / 3


@dataclasses.dataclass(frozen=True)
class Work:
    """A call's bytes moved, its operations at the product rate and at the
    scalar float32 rate, and the dtype of its products."""
    bytes: float
    product_ops: float
    scalar_ops: float
    dtype: str

    def least_s(self) -> float:
        return max(self.bytes / PEAK_BYTES, self.product_ops / product_peak(self.dtype),
                   self.scalar_ops / PEAK_F32)


def fused_attn(b: int, c: int, t: int, n_head: int, dtype: str) -> Work:
    """LN, three depthwise convs and LNs, the q, k, v projections (C x C
    each) and the per-head channel attention ((hs x hs) scores over T, then
    times v): x read, the pre-scramble output written, the projections in
    ``dtype``, the norm and conv parameters in float32."""
    es = ITEMSIZE[dtype]
    hs = c // n_head
    weights = 3 * c * c * es + (3 * c + 3 * 3 * c + 2 * 3 * c + 2 * c) * 4
    ops = 3 * 2 * c * c * t * b + 2 * (2 * c * hs * t * b)
    return Work(2 * b * c * t * es + weights, ops, 0, dtype)


def fused_mlp(b: int, c: int, t: int, dtype: str) -> Work:
    """LN, the 1x1 products C -> 4C -> C, GELU and the residual: x read,
    the output written, W1 and W2 in ``dtype``, biases and LN in float32."""
    es = ITEMSIZE[dtype]
    hid = 4 * c
    weights = 2 * hid * c * es + (hid + c + 2 * c) * 4
    return Work(2 * b * c * t * es + weights, 2 * 2 * c * hid * t * b, 0, dtype)


def deform_conv(b: int, c: int, h: int, w: int, d: int, o: int, dtype: str) -> Work:
    """The multi-dilation modulated deformable conv: x, D offset maps (18 C
    channels) and D mask maps (9 C) read, the weights (D O C 9, float32),
    the output (O channels) written.  Per sample (D 9 C B H W of them) the
    bilinear weights, four corners and the mask are scalar float32 work
    (~12 operations); the contraction over O is a product of 2 O."""
    es = ITEMSIZE[dtype]
    p = b * h * w
    moved = (c + d * 27 * c + o) * p * es + d * o * (c * 9 + 1) * 4
    samples = d * 9 * c * p
    return Work(moved, samples * 2 * o, samples * 12, dtype)


def deform_conv_bwd(b: int, c: int, h: int, w: int, d: int, o: int, dtype: str) -> Work:
    """Its backward: g, x, the offsets and masks read, d x, d offsets and
    d masks written (d W and d bias are kilobytes).  Per sample the products
    G = W^T g and d W += g (m s)^T (4 O), and scalar work: the sample and
    its two derivatives, the three gradients and four d x corners (~32)."""
    es = ITEMSIZE[dtype]
    p = b * h * w
    moved = (2 * d * 27 * c + 2 * c + o) * p * es
    samples = d * 9 * c * p
    return Work(moved, samples * 4 * o, samples * 32, dtype)
