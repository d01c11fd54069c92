"""A step's model FLOPs, from the configuration's shapes: the reference
model's convolutions and products (``torch.utils.flop_counter``, which
counts a multiply-add as two operations) traced on the meta device, so
nothing is computed and no memory is taken.  The same count holds whatever
implements the work; elementwise work (norms, activations, the deformable
conv's sampling) is not counted.  Eval counts the forward; train the
forward, the losses and the backward."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import model as ref_model
from portbench.reference import train as ref_train


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def hrnet_flops(cfg: dict, frames: int = 1) -> int:
    """HRNet's forward on ``frames`` frames of the configuration's size."""
    w, h = cfg["MODEL"]["IMAGE_SIZE"]
    with torch.device("meta"):
        net = ref_model.HRNet(ref_model.Spec.from_config(cfg)).eval()
        x = torch.empty(frames, 3, h, w)
    with torch.no_grad():
        return _counted(lambda: net(x))


@functools.lru_cache(maxsize=8)
def _step_flops(cfg_json: str, batch: int, train: bool) -> int:
    cfg = json.loads(cfg_json)
    m = cfg["MODEL"]
    (w, h), (hw, hh), j = m["IMAGE_SIZE"], m["HEATMAP_SIZE"], m["NUM_JOINTS"]
    with torch.device("meta"):
        model = ref_model.OTPose(ref_model.Spec.from_config(cfg))
        batch_t = {"inputs": torch.empty(batch, h, w, 15), "margin": torch.empty(batch, 4),
                   "target": torch.empty(batch, hh, hw, j),
                   "target_weight": torch.empty(batch, j, 1)}
    if not train:
        model.eval()
        with torch.no_grad():
            return _counted(lambda: ref_model.forward(model, batch_t["inputs"],
                                                      batch_t["margin"]))
    model.train()
    topk = cfg["LOSS"]["TOPK"]
    return _counted(lambda: ref_train.loss(model, batch_t, topk).backward())


def step_flops(cfg: dict, batch: int, train: bool) -> int:
    """The model FLOPs of one eval batch (``train=False``) or train step of
    ``batch`` clips."""
    return _step_flops(json.dumps(cfg, sort_keys=True), batch, train)
