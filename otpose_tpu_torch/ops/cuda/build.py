"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds).  Libraries go to
``build/otpose_tpu_torch/`` at the repository root, named by a hash of their
sources and flags, so an edited source is rebuilt.  ``build_all`` starts one
``nvcc`` per source at once.  Kernels are built only from the sources in
``csrc/``.  A build with extra preprocessor ``defines`` (the phase clocks of
``tools/kernel_phases.py``) is a library of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

KERNELS = ("fused_attn", "fused_mlp", "deform_conv", "token_shift")
CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "otpose_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
# ptxas report (registers, shared memory, spills) of each build in this process
ptxas_report: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _target(name: str, defines=()) -> Path:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=KERNELS, defines=()) -> dict:
    """Compile every missing library in parallel; returns {name: seconds}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        ptxas_report[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str, signatures: dict, defines=()) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    ``restype`` and ``argtypes`` set from ``{function: (restype, argtypes)}``.
    The wrappers load the build without ``defines``, which ``_libs[name]``
    holds."""
    key = (name, *defines) if defines else name
    lib = _libs.get(key)
    if lib is None:
        path = _target(name, defines)
        if not path.exists():
            build_all((name,), defines)
        lib = ctypes.CDLL(str(path))
        sigs = dict(signatures, otp_error_string=(ctypes.c_char_p, [ctypes.c_int]))
        for fn, (restype, argtypes) in sigs.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[key] = lib
    return lib


def f32_vector(a, n: int, what: str, device):
    """A parameter as a contiguous f32 vector of length ``n`` on ``device``;
    raises if it holds another number of values."""
    if a.numel() != n:
        raise ValueError(f"{what}: expected {n} values, got shape {tuple(a.shape)}")
    return a.reshape(n).to(device=device, dtype=torch.float32).contiguous()


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.otp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]
