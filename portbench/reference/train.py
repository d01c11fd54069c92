"""The reference's train step and decode, float32: the student/teacher OHKM
loss with its occlusion term, backward, the global-norm clip at 1.0 and
AdamW over three parameter groups (HRNet at a hundredth of the rate, no
decay on biases, LayerNorm weights and block scales), as OTPose's
``script/Common.py`` and ``train_utils.py`` define them."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import model as ref_model
from portbench.reference import ops

_LN_OWNERS = ("ln1", "ln2", "query_norm", "key_norm", "value_norm", "embd_norm")


def param_group(name: str) -> str:
    if name.startswith("rough_pose_estimation_net."):
        return "pretrained"
    if name.endswith((".bias", ".scale")):
        return "no_decay"
    if name.endswith(".weight") and any(p in _LN_OWNERS for p in name.split(".")[:-1]):
        return "no_decay"
    return "decay"


def cosine_warmup_lr(cfg: dict, iters_per_epoch: int, step: int) -> float:
    """The linear warm-up and cosine schedule, evaluated in float32."""
    t = cfg["TRAIN"]
    f32 = np.float32
    base = t["LR"]
    warm = t["WARMUP_EPOCHS"] * iters_per_epoch
    total = (t["END_EPOCH"] + t["WARMUP_EPOCHS"]) * iters_per_epoch
    if step < warm:
        return float(f32(step) * f32(base) / f32(max(warm - 1, 1)))
    prog = (f32(step) - f32(warm)) / f32(max(total - warm, 1))
    eta_min = 1e-8
    return float(f32(eta_min) + f32(0.5 * (base - eta_min)) * (f32(1) + np.cos(f32(math.pi) * prog)))


def _flatten(hm):
    b, j, h, w = hm.shape
    return hm.reshape(b, j, h * w)


def st_ohkw_mse_loss(out_s, out_t, target, weight, topk: int):
    """The student/teacher OHKM MSE on NCHW heatmaps: a joint is labelled
    where the batch's target peaks at 1.0."""
    ps, pt, gt = _flatten(out_s), _flatten(out_t), _flatten(target)
    w = weight[:, :, :1]
    ps_w, pt_w, gt_w = ps * w, pt * w, gt * w
    unl = (~(gt.amax(dim=(0, 2)) == 1.0)).float()
    base = (ps_w - gt_w) ** 2
    consist = (ps_w - pt_w) ** 2
    elem = 0.5 * (base + consist * unl[None, :, None])
    vals = torch.topk(elem.mean(dim=2), topk, dim=1).values
    ohkm = (vals.sum(dim=1) / topk).mean()
    mse = (base.mean(dim=(0, 2)) + consist.mean(dim=(0, 2)) * unl).sum()
    return ohkm + mse


def loss(model, batch, topk: int):
    """The total loss of one forward on ``batch`` (NHWC targets)."""
    out, rough, intersection, context = ref_model.forward(model, batch["inputs"], batch["margin"])
    b = batch["inputs"].shape[0]
    target = batch["target"].permute(0, 3, 1, 2)
    w = batch["target_weight"]
    main = st_ohkw_mse_loss(out, rough[:b], target, w, topk)
    aux = st_ohkw_mse_loss(context, context, (target + intersection) / 2, w, topk)
    return main + aux


class Trainer:
    """The train state of the reference: the model, AdamW and the count of
    updates, whose learning rate follows ``cosine_warmup_lr`` from
    ``start_step``."""

    def __init__(self, model, cfg: dict, iters_per_epoch: int, start_step: int):
        t = cfg["TRAIN"]
        if (t["OPTIMIZER"], t["LR_SCHEDULER"], t["WARMUP"]) != ("AdamW", "CosineAnnealingLR", True) \
                or cfg["MODEL"]["FREEZE_HRNET_WEIGHTS"]:
            raise ValueError("the reference trains with AdamW on the warm-up cosine schedule, "
                             "HRNet not frozen")
        self.model, self.cfg = model, cfg
        self.iters_per_epoch, self.count = iters_per_epoch, start_step
        wd = cfg["TRAIN"]["WD"]
        named = {"decay": [], "no_decay": [], "pretrained": []}
        for name, p in model.named_parameters():
            named[param_group(name)].append(p)
        self.scales = {"decay": 1.0, "no_decay": 1.0, "pretrained": 0.01}
        groups = [dict(params=ps, weight_decay=0.0 if g == "no_decay" else wd, name=g)
                  for g, ps in named.items() if ps]
        self.params = [p for g in groups for p in g["params"]]
        self.opt = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                     foreach=False)

    def step(self, batch, gen: torch.Generator, topk: int) -> float:
        """One update on ``batch`` with dropout drawn from ``gen``; returns
        the loss."""
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        with ops.use_generator(gen):
            total = loss(self.model, batch, topk)
        total.backward()
        ref_model.commit_bn_stats(self.model)
        with torch.no_grad():
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                         for g in grads]))
            factor = torch.where(norm < 1.0, torch.ones_like(norm), 1.0 / norm)
            for g in grads:
                g.mul_(factor)
        lr = cosine_warmup_lr(self.cfg, self.iters_per_epoch, self.count)
        for g in self.opt.param_groups:
            g["lr"] = lr * self.scales[g["name"]]
        self.opt.step()
        self.count += 1
        return float(total.detach())

    def first_moments(self) -> dict:
        """{name: AdamW's first moment} after the updates made."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        return {names[id(p)]: self.opt.state[p]["exp_avg"] for p in self.params
                if p in self.opt.state}


def decode(heat):
    """(B, J, H, W) -> (coords (B, J, 2) with the quarter-pixel shift,
    maxvals (B, J, 1), raw argmax coords (B, J, 2)); ties to the first
    maximum, coords zeroed where the maximum is <= 0."""
    b, j, h, w = heat.shape
    flat = heat.reshape(b, j, h * w)
    idx = torch.argmax(flat, dim=2)
    maxvals = torch.amax(flat, dim=2)[..., None]
    px, py = idx % w, idx // w
    raw = torch.stack([px, py], dim=-1).float() * (maxvals > 0.0).float()

    def sample(yy, xx):
        return torch.gather(flat, 2, (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))[..., None])[..., 0]

    pxr, pyr = raw[..., 0].long(), raw[..., 1].long()
    dx = sample(pyr, pxr + 1) - sample(pyr, pxr - 1)
    dy = sample(pyr + 1, pxr) - sample(pyr - 1, pxr)
    inner = (pxr > 1) & (pxr < w - 1) & (pyr > 1) & (pyr < h - 1)
    shift = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25
    return raw + shift * inner[..., None].float(), maxvals, raw
