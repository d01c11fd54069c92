"""Which decoder reads a run's JPEG frames: one rule for ``DeviceLoader``
and ``tools/generate_boxes.py``.

- On a CUDA device, for frames decoded whole (``DeviceLoader``'s ``full``
  mode, the detector's frames): nvJPEG (``data/nvjpeg.py``), into the
  card's memory.  When it cannot build, load or make its handle, this
  raises with nvJPEG's reason: it never falls back quietly to the host.
- Otherwise (a CPU device, or ``crops`` mode, whose warp runs on the host):
  the native IO library (``data/native.py``) when it loads, as the JAX
  package decodes, else the dataset's ``read_frame`` (cv2).
"""

from __future__ import annotations

from typing import Tuple

import torch

from otpose_tpu_torch.data import native as native_io
from otpose_tpu_torch.data import nvjpeg


def choose_decoder(device, mode: str = "full") -> Tuple[str, str]:
    """(decoder, detail): the decoder's name (``"nvjpeg"``, ``"native"`` or
    ``"read_frame"``) and the same with nvJPEG's backend or the reason the
    native library is off, for a run's log.  Raises RuntimeError on a CUDA device in ``full`` mode when
    nvJPEG is unavailable."""
    if mode not in ("full", "crops"):
        raise ValueError(f"mode must be full or crops, got {mode!r}")
    device = torch.device(device)
    if device.type == "cuda" and mode == "full":
        if not nvjpeg.is_available():
            raise RuntimeError(
                f"nvJPEG is unavailable, so JPEG frames cannot be decoded on {device}: "
                f"{nvjpeg.reason()} (to decode on the host, ask for device cpu, or for "
                f"DeviceLoader mode crops)")
        backend = ("hardware backend" if nvjpeg.hardware_backend()
                   else "default backend: no hardware decoder")
        return "nvjpeg", f"nvjpeg ({backend})"
    if native_io.is_available():
        return "native", "native"
    why = native_io.reason()
    return "read_frame", "read_frame" + (
        f" (native library unavailable: {why.splitlines()[0]})" if why else "")
