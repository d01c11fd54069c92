"""YOLOv3 person detector for offline box generation (counterpart of
``otpose_tpu/detector/yolov3.py``).

ref: object_detector/YOLOv3/ (models.py:14-354, detector_utils.py:12-365,
detector_yolov3.py:17-98).  The standard YOLOv3 graph (Darknet-53 and three
heads) and yolov3-tiny as ordered layer programs in the official cfg's layer
order, so a darknet ``.weights`` file loads sequentially; the forward is the
``nn.Module`` ``YoloV3`` in NCHW f32, on the caller's device.  Convolutions
and the rest are plain torch ops (the JAX package runs them as XLA
convolutions: no TPU kernel to port); on a GPU the module's convolutions run
in full f32 with cuDNN's TF32 off, as the JAX detector asks for f32.

``preprocess_image`` pads to a square and resizes with cv2's INTER_AREA
written in torch (``resize_area``), so the detector needs no cv2.
``non_max_suppression`` is the JAX package's numpy function, copied.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the standard YOLOv3 anchor set (official cfg ordering: head1 = stride 32)
ANCHORS = {
    0: [(116, 90), (156, 198), (373, 326)],
    1: [(30, 61), (62, 45), (59, 119)],
    2: [(10, 13), (16, 30), (33, 23)],
}

# yolov3-tiny masks: head1 = 3,4,5; head2 = 1,2,3 (the official cfg reuses
# anchor 3 — a darknet quirk, reproduced; ref: config/yolov3-tiny.cfg:150,199)
TINY_ANCHORS = {
    0: [(81, 82), (135, 169), (344, 319)],
    1: [(23, 27), (37, 58), (81, 82)],
}

_VARIANT_ANCHORS = {"yolov3": ANCHORS, "yolov3-tiny": TINY_ANCHORS}
BN_EPS = 1e-5
LEAKY = 0.1


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    out_ch: int
    kernel: int
    stride: int = 1
    bn: bool = True       # batchnorm + leaky; False => linear conv with bias


# ('conv', ConvSpec) | ('res', n_blocks, mid, out) | ('route', [tap names])
# | ('up',) | ('save', name) | ('yolo', head_idx) | ('max', size, stride)
def _program(variant: str = "yolov3") -> List[tuple]:
    if variant == "yolov3-tiny":
        return _program_tiny()
    if variant != "yolov3":
        raise ValueError(f"unknown YOLO variant {variant!r}")
    p: List[tuple] = [
        ("conv", ConvSpec(32, 3)),
        ("conv", ConvSpec(64, 3, 2)), ("res", 1, 32, 64),
        ("conv", ConvSpec(128, 3, 2)), ("res", 2, 64, 128),
        ("conv", ConvSpec(256, 3, 2)), ("res", 8, 128, 256), ("save", "r36"),
        ("conv", ConvSpec(512, 3, 2)), ("res", 8, 256, 512), ("save", "r61"),
        ("conv", ConvSpec(1024, 3, 2)), ("res", 4, 512, 1024),
    ]
    # detection head 1 (stride 32)
    p += [("conv", ConvSpec(512, 1)), ("conv", ConvSpec(1024, 3)),
          ("conv", ConvSpec(512, 1)), ("conv", ConvSpec(1024, 3)),
          ("conv", ConvSpec(512, 1)), ("save", "h1"),
          ("conv", ConvSpec(1024, 3)), ("conv", ConvSpec(255, 1, bn=False)),
          ("yolo", 0),
          ("route", ["h1"]), ("conv", ConvSpec(256, 1)), ("up",),
          ("route_cat", "r61")]
    # head 2 (stride 16)
    p += [("conv", ConvSpec(256, 1)), ("conv", ConvSpec(512, 3)),
          ("conv", ConvSpec(256, 1)), ("conv", ConvSpec(512, 3)),
          ("conv", ConvSpec(256, 1)), ("save", "h2"),
          ("conv", ConvSpec(512, 3)), ("conv", ConvSpec(255, 1, bn=False)),
          ("yolo", 1),
          ("route", ["h2"]), ("conv", ConvSpec(128, 1)), ("up",),
          ("route_cat", "r36")]
    # head 3 (stride 8)
    p += [("conv", ConvSpec(128, 1)), ("conv", ConvSpec(256, 3)),
          ("conv", ConvSpec(128, 1)), ("conv", ConvSpec(256, 3)),
          ("conv", ConvSpec(128, 1)),
          ("conv", ConvSpec(256, 3)), ("conv", ConvSpec(255, 1, bn=False)),
          ("yolo", 2)]
    return p


def _program_tiny() -> List[tuple]:
    """yolov3-tiny: 13 convs, 6 maxpools, 2 heads
    (ref: config/yolov3-tiny.cfg; layer numbering per darknet cfg order)."""
    return [
        ("conv", ConvSpec(16, 3)), ("max", 2, 2),
        ("conv", ConvSpec(32, 3)), ("max", 2, 2),
        ("conv", ConvSpec(64, 3)), ("max", 2, 2),
        ("conv", ConvSpec(128, 3)), ("max", 2, 2),
        ("conv", ConvSpec(256, 3)), ("save", "l8"),   # cfg layer 8
        ("max", 2, 2),
        ("conv", ConvSpec(512, 3)),
        ("max", 2, 1),                                 # stride-1 pool, same-size
        ("conv", ConvSpec(1024, 3)),
        ("conv", ConvSpec(256, 1)), ("save", "l13"),  # route -4 target
        ("conv", ConvSpec(512, 3)),
        ("conv", ConvSpec(255, 1, bn=False)),
        ("yolo", 0),
        ("route", ["l13"]), ("conv", ConvSpec(128, 1)), ("up",),
        ("route_cat", "l8"),
        ("conv", ConvSpec(256, 3)),
        ("conv", ConvSpec(255, 1, bn=False)),
        ("yolo", 1),
    ]


def _conv_specs_in_order(variant: str = "yolov3") -> List[Tuple[int, ConvSpec]]:
    """All convs in darknet weight-file order with their input channels."""
    specs = []
    ch = 3
    saves: Dict[str, int] = {}
    for op in _program(variant):
        if op[0] == "conv":
            specs.append((ch, op[1]))
            ch = op[1].out_ch
        elif op[0] == "res":
            _, n, mid, out = op
            for _ in range(n):
                specs.append((ch, ConvSpec(mid, 1)))
                specs.append((mid, ConvSpec(out, 3)))
                ch = out
        elif op[0] == "save":
            saves[op[1]] = ch
        elif op[0] == "route":
            ch = saves[op[1][0]]
        elif op[0] == "route_cat":
            ch = ch + saves[op[1]]
    return specs


def load_darknet_weights(path: str, variant: str = "yolov3") -> List[dict]:
    """Official .weights binary -> per-conv param dicts in program order
    (layout per conv: [bn_bias, bn_scale, bn_mean, bn_var] or [bias], then
    the OIHW kernel — ref: models.py:286-331), kernels as HWIO like the JAX
    package's.  A file with fewer or more values than the variant needs is
    refused."""
    with open(path, "rb") as f:
        np.fromfile(f, dtype=np.int32, count=5)     # the header
        buf = np.fromfile(f, dtype=np.float32)
    specs = _conv_specs_in_order(variant)
    need = sum(s.out_ch * ((4 if s.bn else 1) + cin * s.kernel * s.kernel)
               for cin, s in specs)
    if need != len(buf):
        raise ValueError(f"weight file mismatch: {variant} needs {need} values after the "
                         f"header, {path} holds {len(buf)}")
    ptr = 0
    out = []
    for cin, spec in specs:
        p: dict = {}
        co = spec.out_ch
        names = ("bn_bias", "bn_scale", "bn_mean", "bn_var") if spec.bn else ("bias",)
        for name in names:
            p[name] = buf[ptr:ptr + co]
            ptr += co
        n_w = co * cin * spec.kernel * spec.kernel
        w = buf[ptr:ptr + n_w].reshape(co, cin, spec.kernel, spec.kernel)
        ptr += n_w
        p["weight"] = np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO
        out.append(p)
    return out


def save_darknet_weights(path: str, weights: List[dict], variant: str = "yolov3") -> None:
    """Write per-conv param dicts (kernels HWIO) as a darknet .weights file:
    a five-int32 header, then each conv's [bn_bias, bn_scale, bn_mean,
    bn_var] or [bias] and its OIHW kernel (the inverse of
    ``load_darknet_weights``)."""
    specs = _conv_specs_in_order(variant)
    if len(weights) != len(specs):
        raise ValueError(f"{variant} has {len(specs)} convs, got {len(weights)} weight dicts")
    chunks = [np.asarray([0, 2, 0, 0, 0], np.int32).tobytes()]
    for (_, spec), p in zip(specs, weights):
        names = ("bn_bias", "bn_scale", "bn_mean", "bn_var") if spec.bn else ("bias",)
        chunks += [np.asarray(p[n], np.float32).tobytes() for n in names]
        chunks.append(np.ascontiguousarray(
            np.asarray(p["weight"], np.float32).transpose(3, 2, 0, 1)).tobytes())
    with open(path, "wb") as fh:
        fh.write(b"".join(chunks))


def init_random_weights(seed: int = 0, variant: str = "yolov3") -> List[dict]:
    """Random weights with the same structure, as the JAX package draws them
    (std 0.01, identity BN): through 75 convolutions the activations vanish
    and every head gives its bias, so they check shapes, not numerics."""
    rng = np.random.RandomState(seed)
    out = []
    for cin, spec in _conv_specs_in_order(variant):
        co, k = spec.out_ch, spec.kernel
        p = {"weight": (rng.randn(k, k, cin, co) * 0.01).astype(np.float32)}
        if spec.bn:
            p["bn_bias"] = np.zeros(co, np.float32)
            p["bn_scale"] = np.ones(co, np.float32)
            p["bn_mean"] = np.zeros(co, np.float32)
            p["bn_var"] = np.ones(co, np.float32)
        else:
            p["bias"] = np.zeros(co, np.float32)
        out.append(p)
    return out


def init_he_weights(seed: int = 0, variant: str = "yolov3", head_scale: float = 0.25,
                    obj_bias: float = 0.0, person_bias: float = 0.0) -> List[dict]:
    """Random weights for numerical checks: He-scaled kernels, BN scales
    near 1 and small biases, the three (or two) 255-channel head convs
    scaled by ``head_scale`` so that ``exp(w, h)`` stays finite, their
    objectness biases at ``obj_bias`` (a negative bias keeps few candidates
    above a confidence threshold, as a real detector's are) and the person
    class's raised by ``person_bias``.  BN's
    running statistics are left at (0, 1): ``YoloV3.calibrate_bn_`` sets
    them from a batch, so that no layer explodes or vanishes."""
    rng = np.random.RandomState(seed)
    out = []
    for cin, spec in _conv_specs_in_order(variant):
        co, k = spec.out_ch, spec.kernel
        std = np.sqrt(2.0 / (cin * k * k))
        p = {"weight": (rng.randn(k, k, cin, co) * std).astype(np.float32)}
        if spec.bn:
            p["bn_bias"] = (0.1 * rng.randn(co)).astype(np.float32)
            p["bn_scale"] = (1.0 + 0.1 * rng.randn(co)).astype(np.float32)
            p["bn_mean"] = np.zeros(co, np.float32)
            p["bn_var"] = np.ones(co, np.float32)
        else:
            p["weight"] *= np.float32(head_scale)
            p["bias"] = (0.1 * rng.randn(co)).astype(np.float32)
            p["bias"][4::85] += np.float32(obj_bias)
            p["bias"][5::85] += np.float32(person_bias)
        out.append(p)
    return out


class DarknetConv(nn.Module):
    """A darknet convolutional layer: conv, then BN as an affine of its
    running statistics and leaky ReLU 0.1, or a linear conv with a bias."""

    def __init__(self, cin: int, spec: ConvSpec):
        super().__init__()
        self.spec = spec
        co, k = spec.out_ch, spec.kernel
        self.weight = nn.Parameter(torch.zeros(co, cin, k, k))
        if spec.bn:
            for name in ("bn_bias", "bn_scale", "bn_mean", "bn_var"):
                self.register_buffer(name, torch.zeros(co))
        else:
            self.bias = nn.Parameter(torch.zeros(co))
        self.calibrate = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # stride 2 pads 1 on each side, as darknet (and the JAX package's
        # explicit pad before a VALID conv) does
        y = F.conv2d(x, self.weight, None, self.spec.stride, self.spec.kernel // 2)
        if not self.spec.bn:
            return y + self.bias[None, :, None, None]
        if self.calibrate:
            self.bn_mean.copy_(y.mean(dim=(0, 2, 3)))
            self.bn_var.copy_(y.var(dim=(0, 2, 3), unbiased=False))
        inv = torch.rsqrt(self.bn_var + BN_EPS) * self.bn_scale
        y = (y - self.bn_mean[None, :, None, None]) * inv[None, :, None, None] \
            + self.bn_bias[None, :, None, None]
        return torch.where(y > 0, y, LEAKY * y)


def _decode_head(feat: torch.Tensor, head_idx: int, img_size: int,
                 variant: str = "yolov3") -> torch.Tensor:
    """(B, g, g, 255) raw head (NHWC, as the JAX function takes it) ->
    (B, g*g*3, 85) [cx, cy, w, h, obj, cls...] in grid-major order (y, x,
    anchor) (ref: models.py:112-235 YOLOLayer)."""
    b, gh, gw, _ = feat.shape
    stride = img_size // gh
    feat = feat.reshape(b, gh, gw, 3, 85)
    dev = feat.device
    gy, gx = torch.meshgrid(torch.arange(gh, dtype=torch.float32, device=dev),
                            torch.arange(gw, dtype=torch.float32, device=dev), indexing="ij")
    anchors = torch.tensor(_VARIANT_ANCHORS[variant][head_idx], dtype=torch.float32,
                           device=dev) / stride
    cx = (torch.sigmoid(feat[..., 0]) + gx[None, :, :, None]) * stride
    cy = (torch.sigmoid(feat[..., 1]) + gy[None, :, :, None]) * stride
    ww = torch.exp(feat[..., 2]) * anchors[None, None, None, :, 0] * stride
    hh = torch.exp(feat[..., 3]) * anchors[None, None, None, :, 1] * stride
    obj = torch.sigmoid(feat[..., 4])
    cls = torch.sigmoid(feat[..., 5:])
    out = torch.cat([cx[..., None], cy[..., None], ww[..., None], hh[..., None],
                     obj[..., None], cls], dim=-1)
    return out.reshape(b, gh * gw * 3, 85)


class YoloV3(nn.Module):
    """The darknet graph of ``variant`` ("yolov3" or "yolov3-tiny"):
    (B, 3, S, S) f32 in [0, 1] -> (B, N, 85) decoded detections, the heads in
    order of stride 32, 16 (and 8), each grid-major as ``_decode_head``
    gives it (counterpart of ``yolo_forward``)."""

    def __init__(self, variant: str = "yolov3"):
        super().__init__()
        self.variant = variant
        self.program = _program(variant)
        self.convs = nn.ModuleList(DarknetConv(cin, spec)
                                   for cin, spec in _conv_specs_in_order(variant))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        img_size = x.shape[-1]
        with _f32_convs(x):
            return self._forward(x, img_size)

    def _forward(self, x: torch.Tensor, img_size: int) -> torch.Tensor:
        convs = iter(self.convs)
        saves: Dict[str, torch.Tensor] = {}
        detections = []
        for op in self.program:
            kind = op[0]
            if kind == "conv":
                x = next(convs)(x)
            elif kind == "res":
                for _ in range(op[1]):
                    skip = x
                    x = next(convs)(x)
                    x = next(convs)(x)
                    x = x + skip
            elif kind == "save":
                saves[op[1]] = x
            elif kind == "route":
                x = saves[op[1][0]]
            elif kind == "route_cat":
                x = torch.cat([x, saves[op[1]]], dim=1)
            elif kind == "up":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            elif kind == "max":
                _, size, stride = op
                if stride == 1:
                    # darknet's same-size pool: pad right and bottom with -inf
                    x = F.pad(x, (0, size - 1, 0, size - 1), value=float("-inf"))
                x = F.max_pool2d(x, size, stride)
            elif kind == "yolo":
                detections.append(_decode_head(x.permute(0, 2, 3, 1), op[1], img_size,
                                               self.variant))
        return torch.cat(detections, dim=1)

    @torch.no_grad()
    def calibrate_bn_(self, x: torch.Tensor) -> "YoloV3":
        """Set every BN layer's running statistics to its input batch's
        (biased) statistics on ``x``, layer by layer: a momentum-1 train-mode
        pass, after which every layer's output is normalised."""
        for m in self.convs:
            m.calibrate = True
        try:
            self(x)
        finally:
            for m in self.convs:
                m.calibrate = False
        return self

    def darknet_params(self) -> List[dict]:
        """The weights as the JAX package's per-conv numpy dicts (HWIO)."""
        out = []
        for m in self.convs:
            p = {"weight": m.weight.detach().cpu().permute(2, 3, 1, 0).contiguous().numpy()}
            names = ("bn_bias", "bn_scale", "bn_mean", "bn_var") if m.spec.bn else ("bias",)
            for name in names:
                p[name] = getattr(m, name).detach().cpu().numpy().copy()
            out.append(p)
        return out


@contextlib.contextmanager
def _f32_convs(x: torch.Tensor):
    """cuDNN convolutions in full f32 (TF32 off) for a CUDA input."""
    if x.device.type != "cuda":
        yield
        return
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = saved


def yolo_params_from_jax(weights: List[dict], variant: str = "yolov3") -> dict:
    """The JAX package's per-conv numpy dicts (kernels HWIO, from
    ``load_darknet_weights`` or ``init_*_weights``) as a ``YoloV3`` state
    dict (kernels OIHW)."""
    specs = _conv_specs_in_order(variant)
    if len(weights) != len(specs):
        raise ValueError(f"{variant} has {len(specs)} convs, got {len(weights)} weight dicts")
    state = {}
    for i, ((cin, spec), p) in enumerate(zip(specs, weights)):
        w = np.asarray(p["weight"], np.float32)
        want = (spec.kernel, spec.kernel, cin, spec.out_ch)
        if w.shape != want:
            raise ValueError(f"conv {i}: kernel {w.shape}, expected HWIO {want}")
        state[f"convs.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(
            w.transpose(3, 2, 0, 1)))
        names = ("bn_bias", "bn_scale", "bn_mean", "bn_var") if spec.bn else ("bias",)
        for name in names:
            state[f"convs.{i}.{name}"] = torch.from_numpy(np.asarray(p[name], np.float32).copy())
    return state


def build_yolo(weights: List[dict], variant: str = "yolov3", device=None) -> YoloV3:
    """A ``YoloV3`` in eval mode on ``device`` (``None``: the card, as
    ``utils/device.py::resolve_device`` rules) holding ``weights``."""
    from otpose_tpu_torch.utils.device import resolve_device

    model = YoloV3(variant)
    model.load_state_dict(yolo_params_from_jax(weights, variant))
    return model.eval().to(resolve_device(device))


# ---------------------------------------------------------------------------
# preprocessing: pad to a square, then cv2's INTER_AREA resize in torch
# ---------------------------------------------------------------------------

def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) weights of cv2's area resize for a downscale
    (``computeResizeAreaTab``: each output cell averages the source cells it
    covers, partial cells by their covered share; weights as float32)."""
    scale = 1.0 / (dsize / ssize)
    w = np.zeros((dsize, ssize), np.float32)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            w[dx, sx] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return w


def _area_taps(ssize: int, dsize: int, bits: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The area weights as taps: (dsize, K) source indices and (dsize, K)
    int64 weights in fixed point with ``bits`` fractional bits (unused taps
    weigh 0)."""
    idx, wts = _area_taps_np(ssize, dsize, bits)
    return torch.from_numpy(idx).to(device), torch.from_numpy(wts).to(device)


@functools.lru_cache(maxsize=16)
def _area_taps_np(ssize: int, dsize: int, bits: int) -> Tuple[np.ndarray, np.ndarray]:
    w = _area_weights(ssize, dsize)
    k = int((w > 0).sum(1).max())
    idx = np.zeros((dsize, k), np.int64)
    wts = np.zeros((dsize, k), np.int64)
    for d in range(dsize):
        nz = np.flatnonzero(w[d])
        idx[d, :len(nz)] = nz
        wts[d, :len(nz)] = np.rint(w[d, nz].astype(np.float64) * (1 << bits))
    return idx, wts


@functools.lru_cache(maxsize=16)
def _linear_taps(ssize: int, dsize: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2's INTER_AREA taps for an upscale: each output pixel blends two
    source pixels with 11-bit fixed-point weights (a0 + a1 = 2048); returns
    (first index, second index, (dsize, 2) int weights)."""
    inv = dsize / ssize
    scale = 1.0 / inv
    i0 = np.zeros(dsize, np.int64)
    alpha = np.zeros((dsize, 2), np.int64)
    for dx in range(dsize):
        sx = int(np.floor(dx * scale))
        fx = np.float32((dx + 1) - (sx + 1) * inv)
        fx = np.float32(0.0) if fx <= 0 else np.float32(fx - np.floor(fx))
        if sx < 0:
            sx, fx = 0, np.float32(0.0)
        if sx >= ssize - 1:
            sx, fx = ssize - 1, np.float32(0.0)
        i0[dx] = sx
        c0 = np.float32(1.0) - fx
        alpha[dx] = [int(np.rint(c0 * np.float32(2048))), int(np.rint(fx * np.float32(2048)))]
    return i0, np.minimum(i0 + 1, ssize - 1), alpha


def resize_area(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA) for an
    (H, W, C) uint8 tensor, on its device, through cv2's three routes:

    - an exact integer downscale (``resizeAreaFast``): the block's integer
      sum times 1/area rounded to nearest even, or ``(sum + 2) >> 2`` for 2x2;
    - another downscale (``resizeArea``): area weights, summed here exactly
      in fixed point (cv2 sums f32 weights in f32, so a sum within that
      rounding of a half may round the other way);
    - an upscale: two-tap linear blends with cv2's fixed-point weights and
      its vertical pass ``((h0 >> 4) * b0 >> 16) + ((h1 >> 4) * b1 >> 16) + 2) >> 2``.

    Each agrees with cv2 within one uint8 step
    (``tests/test_torch_yolov3.py``)."""
    h, w, _ = img.shape
    dev = img.device
    if (h, w) == (out_h, out_w):
        return img.clone()
    sx, sy = 1.0 / (out_w / w), 1.0 / (out_h / h)
    if sx >= 1 and sy >= 1:
        ix, iy = int(round(sx)), int(round(sy))
        if abs(sx - ix) < np.finfo(np.float64).eps and abs(sy - iy) < np.finfo(np.float64).eps:
            blocks = img.to(torch.int32).reshape(out_h, iy, out_w, ix, -1).sum(dim=(1, 3))
            if ix == 2 and iy == 2:
                return ((blocks + 2) >> 2).to(torch.uint8)
            scale = torch.tensor(1.0 / (ix * iy), dtype=torch.float32, device=dev)
            return torch.round(blocks.to(torch.float32) * scale).clamp(0, 255).to(torch.uint8)
        # integer sums (exact, so the same bits on every device) of weights
        # in fixed point, as many bits as int64 holds for this scale (24,
        # f32's mantissa, up to a 5x downscale), rounded half to even as
        # cvRound rounds
        taps = int(np.ceil(max(sx, sy))) + 1
        bits = min(24, int((62 - np.log2(taps * taps * 255.0)) // 2))
        ix_, wx = _area_taps(w, out_w, bits, dev)
        iy_, wy = _area_taps(h, out_h, bits, dev)
        src = img.to(torch.int64)
        cols = (src[:, ix_] * wx[None, :, :, None]).sum(2)             # (H, out_w, C)
        acc = (cols[iy_] * wy[:, :, None, None]).sum(1)               # (out_h, out_w, C)
        shift = 2 * bits
        q, r = acc >> shift, acc & ((1 << shift) - 1)
        half = 1 << (shift - 1)
        q = q + ((r > half) | ((r == half) & (q & 1 == 1))).to(torch.int64)
        return q.clamp(0, 255).to(torch.uint8)
    if sx >= 1 or sy >= 1:
        raise ValueError(f"resize_area: a downscale on one axis and an upscale on the "
                         f"other ({h}x{w} -> {out_h}x{out_w}) is not supported")
    x0, x1, ax = (torch.from_numpy(a).to(dev) for a in _linear_taps(w, out_w))
    y0, y1, by = (torch.from_numpy(a).to(dev) for a in _linear_taps(h, out_h))
    src = img.to(torch.int64)
    rows = src[:, x0] * ax[None, :, 0, None] + src[:, x1] * ax[None, :, 1, None]  # (H, out_w, C)
    r0, r1 = rows[y0] >> 4, rows[y1] >> 4
    out = (((r0 * by[:, 0, None, None]) >> 16) + ((r1 * by[:, 1, None, None]) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


# uint8 -> [0, 1] as numpy's true f32 division gives it (the JAX package's)
_U8_TO_UNIT = torch.from_numpy(np.arange(256, dtype=np.float32) / np.float32(255.0))


def preprocess_image(img, img_size: int = 416, device=None):
    """Pad to square + resize (ref: detector_utils.py:11-38), without cv2.
    ``img``: (H, W, 3) uint8, a numpy array or a tensor (then on its device,
    unless ``device`` is given).  Returns (tensor (S, S, 3) f32 in [0, 1],
    pad info for rescaling).

    Faithful details: pad value 127 (the reference pads with 127.5, which
    truncates to 127 on its uint8 frames) and the INTER_AREA resize — the
    reference's typical 1080p -> 416 downscale averages pixels, and
    INTER_LINEAR instead would shift borderline detections across the
    confidence threshold."""
    t = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(img))
    if device is not None:
        t = t.to(device)
    if t.dtype != torch.uint8 or t.ndim != 3:
        raise ValueError(f"preprocess_image takes an (H, W, C) uint8 image, got "
                         f"{tuple(t.shape)} {t.dtype}")
    h, w = t.shape[:2]
    dim_diff = abs(h - w)
    pad1, pad2 = dim_diff // 2, dim_diff - dim_diff // 2
    if h <= w:
        pad = ((pad1, pad2), (0, 0), (0, 0))
        padded = F.pad(t.permute(2, 0, 1), (0, 0, pad1, pad2), value=127)
    else:
        pad = ((0, 0), (pad1, pad2), (0, 0))
        padded = F.pad(t.permute(2, 0, 1), (pad1, pad2, 0, 0), value=127)
    padded = padded.permute(1, 2, 0)
    side = padded.shape[0]
    resized = resize_area(padded, img_size, img_size)
    # x / 255 through a table made on the host: a CUDA division by a scalar
    # multiplies by its reciprocal, which rounds some quotients differently
    return _U8_TO_UNIT.to(resized.device)[resized.long()], (pad, side)


# ---------------------------------------------------------------------------
# post-processing (numpy, on the host)
# ---------------------------------------------------------------------------

def _xywh_to_xyxy(b):
    return np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                     b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], axis=1)


def _iou_plus1(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one xyxy box vs many, in the reference's +1-pixel convention
    (ref: detector_utils.py:190-220 bbox_iou — widths count inclusive
    endpoints: ``x2 - x1 + 1``)."""
    xx1 = np.maximum(box[0], boxes[:, 0])
    yy1 = np.maximum(box[1], boxes[:, 1])
    xx2 = np.minimum(box[2], boxes[:, 2])
    yy2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(xx2 - xx1 + 1, 0, None) * np.clip(yy2 - yy1 + 1, 0, None)
    a1 = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    a2 = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    return inter / (a1 + a2 - inter + 1e-16)


def non_max_suppression(dets: np.ndarray, conf_thres: float = 0.5,
                        nms_thres: float = 0.4) -> np.ndarray:
    """Greedy NMS with confidence-weighted box merging on (N, 85) decoded
    detections (ref: detector_utils.py:253-292).  Returns (M, 7)
    [x1, y1, x2, y2, obj, cls_score, cls_idx].

    Faithful reference semantics: each kept detection's COORDS are the
    obj-confidence-weighted average over the whole suppressed cluster
    (itself included), not the raw top box; suppression uses the +1-pixel
    IoU and matching class labels; candidate order is obj * cls_score
    descending."""
    dets = dets[dets[:, 4] >= conf_thres]
    if len(dets) == 0:
        return np.zeros((0, 7))
    cls_score = dets[:, 5:].max(axis=1)
    cls_idx = dets[:, 5:].argmax(axis=1).astype(np.float64)
    order = np.argsort(-(dets[:, 4] * cls_score))
    boxes = _xywh_to_xyxy(dets[:, :4])[order]
    obj = dets[order, 4]
    scores = cls_score[order]
    labels = cls_idx[order]
    out = []
    while len(boxes):
        invalid = (_iou_plus1(boxes[0], boxes) > nms_thres) & \
            (labels == labels[0])
        w = obj[invalid][:, None]
        merged = (w * boxes[invalid]).sum(axis=0) / w.sum()
        out.append([*merged, obj[0], scores[0], labels[0]])
        boxes, obj, scores, labels = (boxes[~invalid], obj[~invalid],
                                      scores[~invalid], labels[~invalid])
    return np.asarray(out).reshape(-1, 7)


class YoloV3Detector:
    """Person-box detector (ref: detector_yolov3.py:17-98) on ``device``
    (``cuda`` unless the caller asks for the CPU).  ``weights`` (the per-conv
    dicts) takes precedence over ``weights_path`` (a darknet file); with
    neither, the JAX package's random init."""

    def __init__(self, weights_path: Optional[str] = None, img_size: int = 416,
                 conf_thres: float = 0.4, nms_thres: float = 0.4,
                 variant: str = "yolov3", device=None, weights: Optional[List[dict]] = None):
        from otpose_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.img_size = img_size
        self.conf_thres = conf_thres
        self.nms_thres = nms_thres
        self.variant = variant
        if weights is None:
            weights = (load_darknet_weights(weights_path, variant) if weights_path
                       else init_random_weights(variant=variant))
        self.model = build_yolo(weights, variant, self.device)

    @torch.no_grad()
    def raw_detections(self, img_rgb) -> Tuple[np.ndarray, tuple]:
        """(N, 85) decoded detections on the host and the pad info."""
        tensor, pad_info = preprocess_image(img_rgb, self.img_size, self.device)
        dets = self.model(tensor.permute(2, 0, 1)[None])[0]
        return dets.cpu().numpy(), pad_info

    def detect_persons(self, img_rgb) -> List[list]:
        """RGB image ((H, W, 3) uint8, numpy or a tensor) -> list of
        [x, y, w, h, score] person boxes in image coords
        (ref: detector_yolov3.py:58-98)."""
        dets, (pad, side) = self.raw_detections(img_rgb)
        kept = non_max_suppression(dets, self.conf_thres, self.nms_thres)
        boxes = []
        scale = side / self.img_size
        for x1, y1, x2, y2, obj, cls_s, cls_i in kept:
            if int(cls_i) != 0:  # person
                continue
            x1, y1 = x1 * scale - pad[1][0], y1 * scale - pad[0][0]
            x2, y2 = x2 * scale - pad[1][0], y2 * scale - pad[0][0]
            boxes.append([float(x1), float(y1), float(x2 - x1), float(y2 - y1),
                          float(obj * cls_s)])
        return boxes
