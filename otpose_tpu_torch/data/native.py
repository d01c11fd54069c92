"""ctypes bindings for the port's native host IO library
(``otpose_tpu_torch/csrc/otpose_io.cpp``), the counterpart of
``otpose_tpu/data/native.py``.

The library is built at first use with ``g++`` into
``build/otpose_tpu_torch/`` (git-ignored), named by a hash of its source, its
flags and the host (``-march=native`` builds for the host's CPU), from the
port's own copy of the JAX package's source, with that
package's Makefile flags: the two give the same bits.  Where it cannot be
built (no ``g++``, no ``jpeglib.h``) ``is_available()`` is False and
``reason()`` says why; the callers then read frames through the dataset's
``read_frame``, as the JAX package does without its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "otpose_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "otpose_tpu_torch"
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-Wall", "-std=c++17")
LD_FLAGS = ("-shared", "-fopenmp", "-ljpeg")

_lock = threading.Lock()
_lib = None
_reason: Optional[str] = None


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS + (platform.node(),
                                                        platform.machine())).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libotpose_io-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path.  Raises
    RuntimeError with the compiler's first lines when it cannot be built."""
    out = _target()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native IO library builds only on a host "
                           "with a C++ compiler and libjpeg's headers")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LD_FLAGS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        first = "\n".join(proc.stderr.strip().splitlines()[:3])
        if "jpeglib.h" in proc.stderr:
            raise RuntimeError(f"jpeglib.h is not on g++'s include path ({first})")
        raise RuntimeError(f"g++ failed: {first}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _reason
    if _lib is not None or _reason is not None:
        return _lib
    with _lock:
        if _lib is not None or _reason is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _reason = str(e)
            return None
        lib.decode_jpeg_batch.restype = ctypes.c_int
        lib.decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.warp_normalize_batch.restype = None
        lib.warp_normalize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int]
        lib.generate_targets_batch.restype = None
        lib.generate_targets_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return lib


def is_available() -> bool:
    """Whether the library is built (building it first if need be) and loads."""
    return _load() is not None


def reason() -> Optional[str]:
    """Why the library is unavailable (None when it loads)."""
    _load()
    return _reason


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native IO library is unavailable: {_reason}")
    return lib


def decode_jpeg_batch(paths: Sequence[str], max_h: int, max_w: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Parallel JPEG decode -> ((N, max_h, max_w, 3) uint8 RGB, each frame at
    the top left over zeros, hs, ws, failures); a file that cannot be read or
    is larger than (max_h, max_w) counts as a failure with hs = ws = 0."""
    lib = _lib_or_raise()
    n = len(paths)
    out = np.zeros((n, max_h, max_w, 3), dtype=np.uint8)
    hs = np.zeros(n, dtype=np.int32)
    ws = np.zeros(n, dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    fails = lib.decode_jpeg_batch(arr, n, _ptr(out, ctypes.c_uint8), max_h, max_w,
                                  _ptr(hs, ctypes.c_int), _ptr(ws, ctypes.c_int))
    return out, hs, ws, int(fails)


def warp_normalize_batch(imgs: np.ndarray, hs: np.ndarray, ws: np.ndarray,
                         inv_mats: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(N, Hm, Wm, 3) uint8 with valid sizes hs / ws and (N, 2, 3) dst -> src
    matrices -> (N, out_h, out_w, 3) normalised f32 (bilinear in float, zeros
    outside the frame; cv2.warpAffine INTER_LINEAR differs by up to a uint8
    step, as it interpolates in fixed point)."""
    lib = _lib_or_raise()
    n, in_h, in_w, _ = imgs.shape
    imgs = np.ascontiguousarray(imgs)
    inv = np.ascontiguousarray(inv_mats.reshape(n, 6), dtype=np.float64)
    out = np.empty((n, out_h, out_w, 3), dtype=np.float32)
    hs = np.ascontiguousarray(hs, dtype=np.int32)
    ws = np.ascontiguousarray(ws, dtype=np.int32)
    lib.warp_normalize_batch(_ptr(imgs, ctypes.c_uint8), _ptr(hs, ctypes.c_int),
                             _ptr(ws, ctypes.c_int), n, in_h, in_w,
                             _ptr(inv, ctypes.c_double), _ptr(out, ctypes.c_float),
                             out_h, out_w)
    return out


def generate_targets_batch(joints: np.ndarray, vis: np.ndarray, sigma: float,
                           stride_x: float, stride_y: float, hm_w: int,
                           hm_h: int) -> Tuple[np.ndarray, np.ndarray]:
    """(N, J, 2) f64 joints + (N, J) visibility -> ((N, J, hm_h, hm_w) f32
    targets, (N, J) f32 weights), the reference's gaussian (truncating
    rounding, a clipped 3-sigma window, peak 1)."""
    lib = _lib_or_raise()
    n, j, _ = joints.shape
    joints = np.ascontiguousarray(joints, dtype=np.float64)
    vis = np.ascontiguousarray(vis, dtype=np.float32)
    target = np.empty((n, j, hm_h, hm_w), dtype=np.float32)
    weight = np.empty((n, j), dtype=np.float32)
    lib.generate_targets_batch(_ptr(joints, ctypes.c_double), _ptr(vis, ctypes.c_float),
                               n, j, float(sigma), float(stride_x), float(stride_y),
                               hm_w, hm_h, _ptr(target, ctypes.c_float),
                               _ptr(weight, ctypes.c_float))
    return target, weight
