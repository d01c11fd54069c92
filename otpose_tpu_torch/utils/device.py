"""Device and dtype resolution for the port's entry points."""

from __future__ import annotations

import os

import torch

from otpose_tpu_torch.parallel.distributed import launch_from_env

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None, env=os.environ) -> torch.device:
    """``None`` means ``cuda``; under a multi-process launch (``env``, see
    ``parallel/distributed.py``) the rank's card, ``cuda:{local_rank %
    device_count}``.  A CUDA request without a visible GPU raises: the port
    never moves work to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "otpose_tpu_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch path")
    launch = launch_from_env(env)
    if device is None and launch is not None:
        dev = torch.device("cuda", launch.local_rank % torch.cuda.device_count())
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """A torch dtype, or its name as the config spells it."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]
