"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds).  Each wrapper registers
its kernel as a ``torch.library`` custom op (``otpose::<name>``) whose CPU
implementation is the plain version and whose CUDA implementation makes the
``ctypes`` call, so ``torch.export`` sees each kernel as one opaque op.
Libraries go to ``build/otpose_tpu_torch/`` at the repository root, named by
a hash of their sources and flags, so an edited source is rebuilt.  ``build_all`` starts one
``nvcc`` per source at once.  Kernels are built only from the sources in
``csrc/``.  A build with extra preprocessor ``defines`` (the phase clocks of
``tools/kernel_phases.py``) is a library of its own.  ``jpeg_nv`` (nvJPEG
decode for ``data/nvjpeg.py``) is built the same way, linked with
``-lnvjpeg``; it ports no TPU kernel, so it is not one of ``KERNELS``.
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

KERNELS = ("fused_attn", "fused_mlp", "deform_conv", "deform_conv_bwd", "token_shift")
CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "otpose_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# libraries a source links beyond the CUDA runtime (found at run time through
# the toolkit's library directory, written into the library's rpath)
LINK = {"jpeg_nv": ("-lnvjpeg",)}

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


def _link(name: str) -> tuple:
    if name not in LINK:
        return ()
    lib_dir = os.path.join(os.path.dirname(os.path.dirname(nvcc_path())), "lib64")
    return LINK[name] + ("-Xlinker", f"-rpath={lib_dir}")


def _target(name: str, defines=()) -> Path:
    h = hashlib.sha256(" ".join(_flags(defines) + LINK.get(name, ())).encode())
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
        cmd = [nvcc_path(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *_link(name)]
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


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would need a gradient through a CUDA kernel that
    has no backward: grad mode is on and one of ``tensors`` (other
    arguments are ignored) lies on the card and requires grad.  (On the CPU
    the op runs its plain version, and a backward through it raises where
    it is reached: the op registers no autograd.)"""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.is_cuda
                                       and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward; call it under "
                           "torch.no_grad() or on tensors that do not require grad (the "
                           "model takes the plain path in train mode)")


def check_device(what: str, x) -> None:
    """Raise unless ``x`` lies on the CPU (the plain version) or the card
    (the kernel)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]
