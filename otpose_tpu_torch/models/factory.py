"""Model factory (counterpart of ``otpose_tpu/models/factory.py``)."""

from __future__ import annotations

import torch

from otpose_tpu_torch.models.otpose import OTPose, OTPoseSpec, init_otpose_
from otpose_tpu_torch.utils.device import resolve_device


def build_model(cfg, seed: int = 0, device=None):
    """``cfg.MODEL.NAME == "OTPose"`` -> (spec, model): the reference init
    drawn from ``torch.Generator().manual_seed(seed)``, in eval mode, on
    ``device`` (``cuda`` unless the caller asks for ``cpu``)."""
    if cfg.MODEL.NAME != "OTPose":
        raise KeyError(f"otpose_tpu_torch builds OTPose only, not {cfg.MODEL.NAME!r}")
    dev = resolve_device(device)
    spec = OTPoseSpec.from_cfg(cfg)
    model = init_otpose_(OTPose(spec), torch.Generator().manual_seed(seed))
    return spec, model.to(dev).eval()
