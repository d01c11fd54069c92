"""Optimizer and LR schedule (counterpart of ``otpose_tpu/engine/optim.py``).

The JAX package's optax chain, applied in this order:

  clip_by_global_norm(1.0) -> adam -> (+ wd * param, masked) -> -lr(t) * group_scale

here as a global-norm clip done the way optax does it (scale by
``max_norm / norm`` only when ``norm > max_norm``) followed by
``torch.optim.AdamW`` (or ``SGD``: coupled weight decay, plain momentum) over
three param groups whose lr is set to ``lr(t) * group_scale`` before each
step.  AdamW's decoupled decay ``p *= 1 - lr * wd`` is the chain's
``-lr * (adam + wd * p)``.  Groups (ref: train_utils.py:68-101), by
parameter name, which equals the JAX key:
  - ``pretrained``: HRNet params (``rough_pose_estimation_net.*`` /
    ``teacher*``): lr / 100, weight-decayed; scale 0 under
    ``MODEL.FREEZE_HRNET_WEIGHTS`` (bit-identical params)
  - ``no_decay``: biases, channel-LayerNorm weights, drop-path scales,
    rel-PE tables
  - ``decay``: everything else
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

_LN_SUFFIXES = ("ln1", "ln2", "query_norm", "key_norm", "value_norm")
GROUPS = ("decay", "no_decay", "pretrained")


def classify_param(name: str) -> str:
    """-> 'pretrained' | 'no_decay' | 'decay' (ref: train_utils.py:77-101)."""
    if name.startswith("rough_pose_estimation_net.") or name.startswith("teacher"):
        return "pretrained"
    if name.endswith(".bias"):
        return "no_decay"
    if name.endswith(".scale") or name.endswith("rel_pe"):
        return "no_decay"
    if name.endswith(".weight"):
        # the owning LayerNorm module anywhere in the path (ModuleList-held
        # norms: "temporal_encoder1.embd_norm.0.weight")
        parts = name.split(".")
        if any(p in _LN_SUFFIXES or p == "embd_norm" for p in parts[:-1]):
            return "no_decay"
    return "decay"


def _f32(v) -> float:
    return float(np.float32(v))


def linear_warmup_cosine_schedule(base_lr: float, warmup_steps: int, max_steps: int,
                                  warmup_start_lr: float = 0.0,
                                  eta_min: float = 1e-8) -> Callable[[int], float]:
    """Closed-form per-iteration schedule (ref: lr_schedulers.py:108-124),
    evaluated in f32 as the JAX package evaluates it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        t = f32(step)
        if step < warmup_steps:
            return _f32(f32(warmup_start_lr)
                        + t * f32(base_lr - warmup_start_lr) / f32(max(warmup_steps - 1, 1)))
        prog = (t - f32(warmup_steps)) / f32(max(max_steps - warmup_steps, 1))
        cos = np.cos(f32(math.pi) * prog)
        return _f32(f32(eta_min) + f32(0.5 * (base_lr - eta_min)) * (f32(1) + cos))

    return schedule


def linear_warmup_multistep_schedule(base_lr: float, warmup_steps: int, milestones,
                                     gamma: float,
                                     warmup_start_lr: float = 0.0) -> Callable[[int], float]:
    """ref: lr_schedulers.py:127-212 (``make_schedule`` always passes an
    empty milestone list, ref: train_utils.py:169-177); f32 as in JAX."""
    milestones = sorted(milestones)
    f32 = np.float32

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return _f32(f32(warmup_start_lr) + f32(step) * f32(base_lr - warmup_start_lr)
                        / f32(max(warmup_steps - 1, 1)))
        return _f32(base_lr * gamma ** sum(step >= m for m in milestones))

    return schedule


def make_schedule(cfg, num_iters_per_epoch: int) -> Callable[[int], float]:
    """ref: train_utils.py:142-205."""
    if cfg.TRAIN.WARMUP:
        max_steps = (cfg.TRAIN.END_EPOCH + cfg.TRAIN.WARMUP_EPOCHS) * num_iters_per_epoch
        warmup_steps = cfg.TRAIN.WARMUP_EPOCHS * num_iters_per_epoch
        if cfg.TRAIN.LR_SCHEDULER == "CosineAnnealingLR":
            return linear_warmup_cosine_schedule(cfg.TRAIN.LR, warmup_steps, max_steps)
        if cfg.TRAIN.LR_SCHEDULER == "MultiStepLR":
            return linear_warmup_multistep_schedule(cfg.TRAIN.LR, warmup_steps, [],
                                                    cfg.TRAIN.GAMMA)
        raise ValueError(f"Unsupported scheduler {cfg.TRAIN.LR_SCHEDULER}")
    max_steps = cfg.TRAIN.EPOCHS * num_iters_per_epoch
    if cfg.TRAIN.LR_SCHEDULER == "CosineAnnealingLR":
        return linear_warmup_cosine_schedule(cfg.TRAIN.LR, 0, max_steps, eta_min=0.0)
    if cfg.TRAIN.LR_SCHEDULER == "MultiStepLR":
        return linear_warmup_multistep_schedule(cfg.TRAIN.LR, 0, [], cfg.TRAIN.GAMMA)
    raise ValueError(f"Unsupported scheduler {cfg.TRAIN.LR_SCHEDULER}")


class Optimizer:
    """The chain above over ``model``'s parameters.  ``step()`` clips the
    gradients, sets each group's lr from ``schedule(count)`` and steps;
    ``count`` is the number of updates made.  A parameter whose ``.grad`` is
    None (a frozen submodule) counts as a zero gradient in the norm and is
    not updated."""

    def __init__(self, model: torch.nn.Module, cfg, schedule: Callable[[int], float],
                 clip_grad_norm: float = 1.0):
        self.schedule, self.clip_grad_norm, self.count = schedule, clip_grad_norm, 0
        named: Dict[str, list] = {g: [] for g in GROUPS}
        for name, p in model.named_parameters():
            named[classify_param(name)].append(p)
        wd = cfg.TRAIN.WD
        self.scales = {"decay": 1.0, "no_decay": 1.0,
                       "pretrained": 0.0 if cfg.MODEL.FREEZE_HRNET_WEIGHTS else 0.01}
        groups = [dict(params=named[g], weight_decay=0.0 if g == "no_decay" else wd, name=g)
                  for g in GROUPS if named[g]]
        self.params = [p for g in groups for p in g["params"]]
        if cfg.TRAIN.OPTIMIZER == "AdamW":
            self.opt = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        elif cfg.TRAIN.OPTIMIZER == "SGD":
            # coupled weight decay and plain momentum: the reference factory
            # never passes nesterov (TRAIN.NESTEROV is parsed and ignored)
            self.opt = torch.optim.SGD(groups, lr=0.0, momentum=cfg.TRAIN.MOMENTUM)
        else:
            raise ValueError(f"Unsupported optimizer {cfg.TRAIN.OPTIMIZER}")

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """The torch optimizer's state (moments or momentum buffers, by
        parameter index) and the update count, which sets the next lr."""
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update; returns the global norm of the unclipped gradients."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.nn.utils.get_total_norm(grads)
        if self.clip_grad_norm and self.clip_grad_norm > 0:
            # optax.clip_by_global_norm: g / norm * max_norm where norm > max_norm
            factor = torch.where(norm < self.clip_grad_norm, torch.ones_like(norm),
                                 self.clip_grad_norm / norm)
            torch._foreach_mul_(grads, factor)
        lr = self.schedule(self.count)
        for g in self.opt.param_groups:
            g["lr"] = lr * self.scales[g["name"]]
        self.opt.step()
        self.count += 1
        return norm


def make_optimizer(model: torch.nn.Module, cfg, schedule: Callable[[int], float],
                   clip_grad_norm: float = 1.0) -> Optimizer:
    """ref: train_utils.py:62-137; grad clip 1.0 per ref: script/Common.py:138-142."""
    return Optimizer(model, cfg, schedule, clip_grad_norm)


class ModelEma:
    """Exponential moving average of parameters
    (ref: thirdparty/utils/train_utils.py:240-262)."""

    def __init__(self, model: torch.nn.Module, decay: float = 0.999):
        self.decay = decay
        self.params = {n: p.detach().clone() for n, p in model.named_parameters()}

    @torch.no_grad()
    def update(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        for n, p in model.named_parameters():
            e = self.params[n]
            e.copy_(self.decay * e + (1.0 - self.decay) * p)
        return self.params
