"""JPEG decode on the card with nvJPEG (``otpose_tpu_torch/csrc/jpeg_nv.cu``).

The host reads each file's bytes; the card decodes them to interleaved RGB
straight into a uint8 (N, max_h, max_w, 3) tensor on the card, each frame at
the top left with pitch ``max_w * 3`` (``DeviceLoader``'s ``full``-mode
staging buffer), so neither the host's decode nor the copy of raw pixels to
the card is needed.  The JAX package decodes the same frames with libjpeg on
the host (``otpose_tpu/data/device_loader.py``).

nvJPEG decodes each frame's Y, Cb and Cr planes into a scratch tensor;
the conversion kernel of ``jpeg_nv.cu`` then upsamples 4:2:0 or 4:2:2
chroma and converts to RGB with libjpeg's own integer arithmetic
(``ycc_to_rgb`` is its plain version), so the pixels differ from libjpeg's
(the JAX package's decoder) only where the two IDCTs round differently.  A
frame of any other sampling (4:4:0, 4:1:1) raises, naming the file:
nvJPEG's own RGB output upsamples its own way, tens of uint8 steps from
libjpeg at colour edges.

Backends: nvJPEG's hardware backend (the card's JPEG decode engines) where
``nvjpegCreateEx`` gives one and ``nvjpegDecodeBatchedSupported`` accepts the
file, else nvJPEG's default backend (Huffman decode on the host, the rest on
the card); ``backend="default"`` forces the latter, to compare the two on a
card that has both.  Each call reports, per frame, which ran.  The hardware
branch has not run yet: CUDA 12.9's nvJPEG refused it on the H100 (status 7,
arch mismatch), so only the default backend is verified.

The library is built at first use by ``nvcc`` (``ops/cuda/build.py``,
linked with ``-lnvjpeg``) and loaded with ctypes.  Nothing here falls back:
a file that cannot be decoded raises with its name.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

NAME = "jpeg_nv"
BACKENDS = {1: "hardware", 2: "default"}
# how a frame's RGB was made: the conversion kernel's modes
CONVERSIONS = {0: "grey", 1: "4:4:4", 2: "4:2:0", 3: "4:2:2"}
TOO_LARGE = 1000          # the C side's code for a frame larger than the buffer
UNSUPPORTED_SAMPLING = 1001   # ... for a chroma sampling the kernel lacks
CUDA_BASE = 10000         # the C side's code for a CUDA error: CUDA_BASE + the error
# calls that reached the card, frames decoded on each backend, and launches
# of the conversion kernel
calls = 0
frames = {"hardware": 0, "default": 0}
launches = 0

_lock = threading.Lock()
_ctx: Optional[int] = None
_hardware = False
_hw_status: Optional[int] = None
_reason: Optional[str] = None

_P = ctypes.c_void_p
_SIGNATURES = {
    "otp_nvjpeg_create": (ctypes.c_int, [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]),
    "otp_nvjpeg_destroy": (None, [_P]),
    "otp_nvjpeg_plan": (ctypes.c_int, [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       _P, _P, _P, _P]),
    "otp_nvjpeg_decode_batch": (ctypes.c_int, [
        _P, _P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_size_t,
        ctypes.c_int, _P, _P, _P, _P, _P, _P, _P]),
    "otp_nvjpeg_status_string": (ctypes.c_char_p, [ctypes.c_int]),
}


class Decoded(NamedTuple):
    """A batch decoded on the card: the staging tensor, each frame's height,
    width, backend and conversion, and (when asked for) its planes (Y, Cb,
    Cr views of the scratch tensor, Cb and Cr None for grey)."""
    out: torch.Tensor
    hs: List[int]
    ws: List[int]
    backends: List[str]
    conversions: List[str]
    planes: Optional[list] = None


def ycc_to_rgb(y: torch.Tensor, cb: Optional[torch.Tensor] = None,
               cr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of ``jpeg_nv.cu``'s conversion kernel: (h, w) uint8
    Y with (h, w), (h, ceil(w/2)) or (ceil(h/2), ceil(w/2)) uint8 Cb and Cr,
    or none (grey), -> (h, w, 3) uint8 RGB, with libjpeg's arithmetic: the
    h2v1 and h2v2 "fancy" triangle upsampling (3/4 nearer + 1/4 farther
    sample along each halved axis, edges repeated; biases 1 and 2 for h2v1,
    8 and 7 for h2v2) and jdcolor.c's fixed-point YCbCr -> RGB."""
    h, w = y.shape
    lum = y.to(torch.int64)
    if cb is None:
        return y[..., None].expand(h, w, 3).clone()
    if cb.shape[0] != h:
        cb, cr = (_fancy_h2v2(c.to(torch.int64), h, w) for c in (cb, cr))
    elif cb.shape[1] != w:
        cb, cr = (_fancy_h2v1(c.to(torch.int64), w) for c in (cb, cr))
    cb = cb.to(torch.int64) - 128
    cr = cr.to(torch.int64) - 128
    r = (91881 * cr + 32768) >> 16
    b = (116130 * cb + 32768) >> 16
    g = (-22554 * cb + 32768 - 46802 * cr) >> 16
    return torch.stack([lum + r, lum + g, lum + b], -1).clamp(0, 255).to(torch.uint8)


def _fancy_h2v2(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    ch, cw = c.shape
    dev = c.device
    y = torch.arange(h, device=dev)
    i = y >> 1
    j = torch.where((y & 1) == 1, (i + 1).clamp(max=ch - 1), (i - 1).clamp(min=0))
    col = 3 * c[i] + c[j]                                   # (h, cw)
    x = torch.arange(w, device=dev)
    k = x >> 1
    odd = (x & 1) == 1
    k2 = torch.where(odd, (k + 1).clamp(max=cw - 1), (k - 1).clamp(min=0))
    return (3 * col[:, k] + col[:, k2] + torch.where(odd, 7, 8)) >> 4


def _fancy_h2v1(c: torch.Tensor, w: int) -> torch.Tensor:
    cw = c.shape[1]
    x = torch.arange(w, device=c.device)
    k = x >> 1
    odd = (x & 1) == 1
    k2 = torch.where(odd, (k + 1).clamp(max=cw - 1), (k - 1).clamp(min=0))
    return (3 * c[:, k] + c[:, k2] + torch.where(odd, 2, 1)) >> 2


def jpeg_size(data: bytes) -> Tuple[int, int]:
    """(height, width) from a JPEG's start-of-frame marker; raises
    ValueError for data that is not a JPEG."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no start-of-image marker)")
    i, n = 2, len(data)
    while i + 3 < n:
        if data[i] != 0xFF:
            raise ValueError(f"corrupt JPEG marker at byte {i}")
        marker = data[i + 1]
        if marker == 0xFF:            # fill byte
            i += 1
            continue
        if marker in (0x01, *range(0xD0, 0xD8)):   # markers without a length
            i += 2
            continue
        length = int.from_bytes(data[i + 2:i + 4], "big")
        if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                      0xCD, 0xCE, 0xCF):
            if i + 9 > n:
                break
            return (int.from_bytes(data[i + 5:i + 7], "big"),
                    int.from_bytes(data[i + 7:i + 9], "big"))
        i += 2 + length
    raise ValueError("no start-of-frame marker in the JPEG")


def _lib():
    from otpose_tpu_torch.ops.cuda import build

    return build.load(NAME, _SIGNATURES)


def _context() -> int:
    global _ctx, _hardware, _hw_status
    if _ctx is not None:
        return _ctx
    with _lock:
        if _ctx is None:
            lib = _lib()
            ctx, hw, hw_st = ctypes.c_void_p(), ctypes.c_int(0), ctypes.c_int(-1)
            st = lib.otp_nvjpeg_create(1, ctypes.byref(ctx), ctypes.byref(hw),
                                       ctypes.byref(hw_st))
            if st != 0:
                raise RuntimeError(f"nvJPEG: nvjpegCreateEx failed with status {st} "
                                   f"({lib.otp_nvjpeg_status_string(st).decode()})")
            _ctx, _hardware, _hw_status = ctx.value, bool(hw.value), hw_st.value
    return _ctx


def is_available() -> bool:
    """Whether a CUDA card is present and the nvJPEG library builds, loads
    and makes a handle (``reason()`` says why not)."""
    global _reason
    if _ctx is not None:
        return True
    if not torch.cuda.is_available():
        _reason = "no CUDA device"
        return False
    try:
        _context()
    except (RuntimeError, OSError) as e:
        _reason = str(e)
        return False
    return True


def reason() -> Optional[str]:
    return _reason


def hardware_backend() -> bool:
    """Whether ``nvjpegCreateEx`` gave a hardware backend on this card."""
    _context()
    return _hardware


def hardware_status() -> str:
    """What ``nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, ...)`` returned."""
    _context()
    return f"status {_hw_status} ({_lib().otp_nvjpeg_status_string(_hw_status).decode()})"


def read_bytes(paths: Sequence[str]) -> list:
    out = []
    for p in paths:
        with open(p, "rb") as fh:
            out.append(fh.read())
    return out


def _raise(lib, st: int, failed: int, paths, hs, ws, max_h: int, max_w: int):
    where = paths[failed] if 0 <= failed < len(paths) else str(list(paths))
    if st == TOO_LARGE:
        raise ValueError(f"nvJPEG: frame {where} is ({hs[failed]}, {ws[failed]}) but the "
                         f"staging buffer is ({max_h}, {max_w}); raise DeviceLoader "
                         f"max_frame_hw")
    if st == UNSUPPORTED_SAMPLING:
        raise ValueError(f"nvJPEG: frame {where} has a chroma sampling other than 4:2:0, "
                         f"4:2:2, 4:4:4 or grey, which the card's decoder does not convert")
    what = (f"CUDA error {st - CUDA_BASE} ({lib.otp_error_string(st - CUDA_BASE).decode()})"
            if st >= CUDA_BASE else
            f"status {st} ({lib.otp_nvjpeg_status_string(st).decode()})")
    raise RuntimeError(f"nvJPEG failed on {where}: {what}")


def decode_jpeg_batch_device(paths: Sequence[str], max_h: int, max_w: int, device="cuda",
                             out: Optional[torch.Tensor] = None, backend: str = "auto",
                             data: Optional[Sequence[bytes]] = None,
                             keep_planes: bool = False) -> Decoded:
    """Decode the JPEG files ``paths`` on the card into ``out``, a zeroed
    uint8 (N, max_h, max_w, 3) CUDA tensor (made when None), each frame at
    the top left of its slot.  ``data`` gives the files' bytes when the
    caller has read them; ``keep_planes`` returns the decoded planes too.
    Raises, naming the file, when a file cannot be decoded or is larger
    than (max_h, max_w)."""
    global calls, launches
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"nvJPEG decodes on a CUDA device, not {device}")
    if backend not in ("auto", "default"):
        raise ValueError(f"backend must be auto or default, got {backend!r}")
    n = len(paths)
    if out is None:
        out = torch.zeros((n, max_h, max_w, 3), dtype=torch.uint8, device=device)
    if (out.device.type != "cuda" or out.dtype != torch.uint8 or not out.is_contiguous()
            or tuple(out.shape) != (n, max_h, max_w, 3)):
        raise ValueError(f"out must be a contiguous uint8 CUDA tensor of shape "
                         f"{(n, max_h, max_w, 3)}, got {tuple(out.shape)} {out.dtype} "
                         f"on {out.device}")
    data = list(data) if data is not None else read_bytes(paths)
    if n == 0:
        return Decoded(out, [], [], [], [], [] if keep_planes else None)
    ctx = _context()
    lib = _lib()
    bufs = (ctypes.c_char_p * n)(*data)
    lens = (ctypes.c_size_t * n)(*[len(d) for d in data])
    hs, ws = (ctypes.c_int * n)(), (ctypes.c_int * n)()
    used, conv = (ctypes.c_int * n)(), (ctypes.c_int * n)()
    failed, launched, need = ctypes.c_int(-1), ctypes.c_int(0), ctypes.c_size_t(0)
    ptrs = (ctypes.cast(bufs, _P), ctypes.cast(lens, _P))
    st = lib.otp_nvjpeg_plan(ctx, *ptrs, n, max_h, max_w, ctypes.byref(need),
                             ctypes.cast(hs, _P), ctypes.cast(ws, _P), ctypes.byref(failed))
    if st != 0:
        _raise(lib, st, failed.value, paths, hs, ws, max_h, max_w)
    scratch = torch.empty(max(1, need.value), dtype=torch.uint8, device=out.device)
    with torch.cuda.device(out.device), _lock:
        stream = torch.cuda.current_stream(out.device).cuda_stream
        st = lib.otp_nvjpeg_decode_batch(
            ctx, *ptrs, n, _P(out.data_ptr()), max_h, max_w, _P(scratch.data_ptr()),
            need.value, int(backend == "default"), ctypes.cast(hs, _P), ctypes.cast(ws, _P),
            ctypes.cast(used, _P), ctypes.cast(conv, _P), ctypes.byref(launched),
            ctypes.byref(failed), _P(stream))
        calls += 1
        launches += launched.value
    if st != 0:
        _raise(lib, st, failed.value, paths, hs, ws, max_h, max_w)
    names = [BACKENDS[u] for u in used]
    for b in names:
        frames[b] += 1
    conversions = [CONVERSIONS[c] for c in conv]
    planes = _planes(scratch, list(hs), list(ws), conversions) if keep_planes else None
    return Decoded(out, list(hs), list(ws), names, conversions, planes)


def _planes(scratch: torch.Tensor, hs, ws, conversions) -> list:
    """Each frame's planes in the scratch tensor, laid out as the C side
    lays them: Y, Cb, Cr back to back, each frame's start rounded up to 256
    bytes."""
    out, offset = [], 0
    for h, w, conv in zip(hs, ws, conversions):
        ch = (h + 1) // 2 if conv == "4:2:0" else h
        cw = (w + 1) // 2 if conv in ("4:2:0", "4:2:2") else w
        size = h * w if conv == "grey" else h * w + 2 * ch * cw
        block = scratch[offset:offset + size]
        y = block[:h * w].view(h, w)
        if conv == "grey":
            out.append((y, None, None))
        else:
            cb = block[h * w:h * w + ch * cw].view(ch, cw)
            cr = block[h * w + ch * cw:].view(ch, cw)
            out.append((y, cb, cr))
        offset += (size + 255) // 256 * 256
    return out
