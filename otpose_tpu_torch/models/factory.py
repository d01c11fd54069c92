"""Model and dataset factories over the registries of ``utils/io.py``
(counterpart of ``otpose_tpu/models/factory.py``).

The reference declares detectron2-style registries and never fills them
(ref: utils/registry.py:9-74); here ``build_model(cfg)`` dispatches on
``cfg.MODEL.NAME`` (``OTPose``, ``pose_hrnet``) and ``build_dataset(cfg,
phase)`` on ``cfg.DATASET.NAME`` (``PoseTrack``).
"""

from __future__ import annotations

import torch

from otpose_tpu_torch.utils.device import resolve_device
from otpose_tpu_torch.utils.io import DATASET_REGISTRY, MODEL_REGISTRY


@MODEL_REGISTRY.register(name="OTPose")
def _build_otpose(cfg, seed: int = 0):
    from otpose_tpu_torch.models.otpose import OTPose, OTPoseSpec, init_otpose_

    spec = OTPoseSpec.from_cfg(cfg)
    return spec, init_otpose_(OTPose(spec), torch.Generator().manual_seed(seed))


@MODEL_REGISTRY.register(name="pose_hrnet")
def _build_hrnet(cfg, seed: int = 0):
    from otpose_tpu_torch.models.hrnet import HRNet, HRNetSpec, init_hrnet_

    spec = HRNetSpec.from_cfg(cfg)
    return spec, init_hrnet_(HRNet(spec), torch.Generator().manual_seed(seed))


@DATASET_REGISTRY.register(name="PoseTrack")
def _build_posetrack(cfg, phase: str):
    from otpose_tpu_torch.data.posetrack import PoseTrackDataset

    return PoseTrackDataset(cfg, phase)


def build_model(cfg, seed: int = 0, device=None):
    """``cfg.MODEL.NAME``'s model -> (spec, model): the reference init drawn
    from ``torch.Generator().manual_seed(seed)``, in eval mode, on ``device``
    (``cuda`` unless the caller asks for ``cpu``)."""
    dev = resolve_device(device)
    spec, model = MODEL_REGISTRY.get(cfg.MODEL.NAME)(cfg, seed)
    return spec, model.to(dev).eval()


def build_dataset(cfg, phase: str):
    """``cfg.DATASET.NAME``'s dataset for ``phase`` (``train``, ``validate``
    or ``test``)."""
    return DATASET_REGISTRY.get(cfg.DATASET.NAME)(cfg, phase)
