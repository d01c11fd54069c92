"""Checkpoint reading with the reference's naming (counterpart of the read
side of ``otpose_tpu/engine/checkpoints.py``).

ref: model/checkpoints.py:6-74, utils/setup.py:135-224.  Checkpoints are
named ``epoch_{N}_state`` and ``best_mAP_{value}_state``; the listing
functions find them as the JAX package does.  A reference ``.pth`` /
``.pth.tar`` is read natively with ``torch.load``: the port's modules carry
the reference's ``state_dict`` names and its tensor layouts (conv kernels
OIHW, conv1d (O, I, K), channel-LayerNorm and drop-path params (1, C, 1),
``pos_embd`` (1, C, T)), which is what the JAX package's
``convert_state_dict`` followed by ``models/jax_bridge.py::from_jax`` arrives
at, so the name map is: drop a DataParallel ``module.`` prefix, drop
``num_batches_tracked``, and file BN running stats and ``pos_embd`` under
``model_state``.  The JAX package's own checkpoints are orbax directories,
which cannot be read without the JAX stack: ``restore_checkpoint`` raises
for one.  Saving, resume and preemption are not ported yet (ROADMAP Queue 1
item 5).
"""

from __future__ import annotations

import math
import os
import os.path as osp
import re
from typing import Dict, Optional

import torch

_STATE_SUFFIXES = ("running_mean", "running_var", "pos_embd")


def resolve_model_file(path: str, cfg, checkpoints_folder: str) -> str:
    """Root a configured VAL/TEST ``MODEL_FILE`` the reference way
    (ref: eval.py:66-72): ``'.'``-prefixed paths resolve against the
    experiment's checkpoints folder, anything else joins ``cfg.ROOT_DIR``
    (absolute paths pass through ``osp.join`` unchanged)."""
    if path.startswith("."):
        return osp.abspath(osp.join(checkpoints_folder, path))
    return osp.join(cfg.ROOT_DIR, path)


def _parse_epoch(name: str) -> Optional[int]:
    m = re.fullmatch(r"epoch_(\d+)_state", name)
    return int(m.group(1)) if m else None


def _parse_best(name: str) -> Optional[float]:
    m = re.fullmatch(r"best_mAP_(.+?)_state", name)
    if m is None:
        return None
    try:
        # float() rather than a decimal regex: a tiny early-training mAP
        # reprs in scientific notation ("best_mAP_3.2e-05_state")
        v = float(m.group(1))
    except ValueError:
        return None
    # a best_mAP_nan_state would make every "mAP > best" comparison false
    # forever: treat non-finite like unparsable
    return v if math.isfinite(v) else None


def get_latest_checkpoint(folder: str) -> Optional[str]:
    """Latest by epoch number (ref: utils/setup.py:135-151)."""
    if not osp.isdir(folder):
        return None
    best = None
    best_epoch = -1
    for name in os.listdir(folder):
        e = _parse_epoch(name)
        if e is not None and e > best_epoch:
            best_epoch, best = e, osp.join(folder, name)
    return best


def get_best_checkpoint(folder: str) -> Optional[str]:
    """Highest-mAP best checkpoint (ref: utils/setup.py:154-171)."""
    if not osp.isdir(folder):
        return None
    best = None
    best_map = -1.0
    for name in os.listdir(folder):
        v = _parse_best(name)
        if v is not None and v > best_map:
            best_map, best = v, osp.join(folder, name)
    return best


def get_all_checkpoints(folder: str):
    """All epoch checkpoints, naturally sorted (ref: utils/setup.py:198-224)."""
    if not osp.isdir(folder):
        return []
    out = [(e, osp.join(folder, n)) for n in os.listdir(folder)
           if (e := _parse_epoch(n)) is not None]
    return [p for _, p in sorted(out)]


def split_state_dict(sd) -> tuple:
    """A reference ``state_dict`` -> (params, model_state) under the port's
    names, tensors untouched (see the module docstring)."""
    params: Dict[str, torch.Tensor] = {}
    state: Dict[str, torch.Tensor] = {}
    for name, tensor in sd.items():
        if name.startswith("module."):
            name = name[len("module."):]
        if name.endswith("num_batches_tracked"):
            continue
        (state if name.endswith(_STATE_SUFFIXES) else params)[name] = tensor
    return params, state


def restore_checkpoint(path: str) -> dict:
    """Read a reference ``.pth`` / ``.pth.tar`` (weights on the CPU).

    Returns a dict with ``params`` and ``model_state`` (name -> tensor), and
    ``begin_epoch`` / ``tensorboard_global_steps`` when the file has them."""
    if path.endswith(".pth") or path.endswith(".pth.tar"):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
        params, state = split_state_dict(sd)
        out = {"params": params, "model_state": state}
        if isinstance(blob, dict):
            for k in ("begin_epoch", "tensorboard_global_steps"):
                if k in blob:
                    out[k] = blob[k]
        return out
    if osp.isdir(path):
        raise NotImplementedError(
            f"{path} is a checkpoint directory (orbax, written by the JAX package): it "
            "cannot be read without the JAX stack, and the port's own checkpoint "
            "writing is not there yet (ROADMAP Queue 1 item 5); export the weights as "
            "a reference-layout .pth")
    raise ValueError(f"{path}: not a .pth / .pth.tar checkpoint")


@torch.no_grad()
def merge_checkpoint(blob: dict, model: torch.nn.Module) -> int:
    """Copy a restored checkpoint into ``model`` key by key with a shape
    gate (tolerates partial and legacy checkpoints the way the reference's
    ``load_state_dict(strict=False)`` does).  Returns the number of
    parameter tensors that matched; a caller that reports results must treat
    0 as an error."""
    own = model.state_dict()
    n = 0
    for part in ("params", "model_state"):
        for k, v in blob.get(part, {}).items():
            if k in own and tuple(own[k].shape) == tuple(v.shape):
                own[k].copy_(v)
                n += part == "params"
    return n
