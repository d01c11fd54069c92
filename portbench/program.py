"""The system under test: ``otpose_tpu_torch`` through its normal entry
points.  Models come from ``models/factory.py::build_model`` with the
configuration's own fields; eval runs ``engine/trainer.py::
make_decoded_eval_step``, train ``make_train_step`` over
``engine/optim.py::Optimizer``.  The benchmark's weights reach the model
by ``load_state_dict``; everything the program derives from them (its bf16
copies, its kernels' weight packs, its optimizer state) stays the
program's."""

from __future__ import annotations

import numpy as np
import torch


def make_cfg(config: dict):
    """The port's config node: its defaults with the configuration's
    ``cfg`` merged over them."""
    from otpose_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_other_cfg(config["cfg"])
    return cfg


def build(config: dict, state: dict, device):
    """The port's model of ``config`` on ``device`` holding ``state``."""
    from otpose_tpu_torch.models.factory import build_model

    _, model = build_model(make_cfg(config), seed=0, device=device)
    model.load_state_dict(state, strict=True)
    return model


def eval_step(model, dtype: str):
    """The decoded eval step in ``dtype``; in bf16 the weights are cast as
    the eval CLI casts them (``prepare_eval_params``)."""
    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
    from otpose_tpu_torch.models.otpose import prepare_eval_params

    if dtype == "bfloat16":
        prepare_eval_params(model, torch.bfloat16)
    return make_decoded_eval_step(model, compute_dtype=dtype)


def train_step(model, config: dict, dtype: str, iters_per_epoch: int, start_step: int,
               generator: torch.Generator):
    """(step, optimizer): the train step of ``model`` with AdamW on the
    configuration's schedule, resumed at update ``start_step`` as a
    checkpoint resume sets it."""
    from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
    from otpose_tpu_torch.engine.trainer import make_train_step

    cfg = make_cfg(config)
    opt = make_optimizer(model, cfg, make_schedule(cfg, iters_per_epoch))
    opt.load_state_dict({"opt": opt.opt.state_dict(), "count": start_step})
    step = make_train_step(model, opt, compute_dtype=dtype, topk=cfg.LOSS.TOPK,
                           use_target_weight=cfg.LOSS.USE_TARGET_WEIGHT,
                           accum_steps=cfg.TPU.ACCUM_STEPS, remat=cfg.TPU.REMAT,
                           generator=generator)
    return step, opt


def first_moments(opt, model) -> dict:
    """{parameter name: AdamW's first moment} of the program's optimizer."""
    names = {id(p): n for n, p in model.named_parameters()}
    state = opt.opt.state
    return {names[id(p)]: state[p]["exp_avg"] for p in opt.params if p in state}


def step_seed(seed: int, epoch: int, global_steps: int) -> int:
    """A train step's dropout seed, as ``engine/runner.py::step_seed`` keys
    it: a hash of (seed, epoch, global step)."""
    return int(np.random.SeedSequence([seed % 2 ** 64, epoch, global_steps])
               .generate_state(1, np.uint64)[0])


def sync(device) -> None:
    """Wait for ``device``'s queued work (a no-op off the card)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
