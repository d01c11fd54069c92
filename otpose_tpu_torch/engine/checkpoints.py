"""Checkpoints with the reference's naming and resume rule (counterpart of
``otpose_tpu/engine/checkpoints.py``).

ref: model/checkpoints.py:6-74, utils/setup.py:135-224.  Checkpoints are
directories ``epoch_{N}_state`` and ``best_mAP_{value}_state``; the listing
functions find them as the JAX package does.

The port's own format: the directory holds one ``torch.save`` file,
``state.pt``, a dict with

- ``state_dict``: the model's ``state_dict`` under its reference names;
- ``optimizer`` (epoch checkpoints): ``Optimizer.state_dict()``, the torch
  optimizer's state and the update count;
- ``meta`` (epoch checkpoints): ``begin_epoch``, ``tensorboard_global_steps``
  and ``iteration``.  ``iteration > 0`` marks a mid-epoch (preemption)
  checkpoint: ``begin_epoch`` is then the interrupted epoch and resume skips
  its first ``iteration`` batches; otherwise the epoch is complete and
  ``begin_epoch`` is the next one.

A save writes the directory under a temporary name and renames it into
place, so a crash mid-write leaves no ``epoch_{N}_state``.  An asynchronous
save copies every tensor to the host before it returns and serialises in a
background thread; each save first waits for the one before it, and
``wait_for_saves`` waits for the last.

Under a multi-process launch (``parallel/distributed.py``) rank 0 alone
writes and removes, and every rank waits at a barrier until it is done, so
the folder (on a filesystem the ranks share) is complete when any rank goes
on; asynchronous saves are for a single process.  Every rank resumes from
the same directory.

A reference ``.pth`` / ``.pth.tar`` is read natively with ``torch.load``: the
port's modules carry the reference's ``state_dict`` names and its tensor
layouts (conv kernels OIHW, conv1d (O, I, K), channel-LayerNorm and drop-path
params (1, C, 1), ``pos_embd`` (1, C, T)), which is what the JAX package's
``convert_state_dict`` followed by ``models/jax_bridge.py::from_jax`` arrives
at, so the name map is: drop a DataParallel ``module.`` prefix, drop
``num_batches_tracked``, and file BN running stats and ``pos_embd`` under
``model_state``.  The JAX package's own checkpoints are orbax directories,
which cannot be read without the JAX stack: ``restore_checkpoint`` raises
for one.
"""

from __future__ import annotations

import logging
import math
import os
import os.path as osp
import re
import shutil
import tempfile
import threading
from typing import Dict, Optional

import torch

from otpose_tpu_torch.parallel.distributed import barrier, is_primary, process_info

logger = logging.getLogger(__name__)

_STATE_SUFFIXES = ("running_mean", "running_var", "pos_embd")
STATE_FILE = "state.pt"
# the roots of the OTPose modules; any other root is a bare HRNet key
_OTPOSE_ROOTS = frozenset((
    "rough_pose_estimation_net", "temporal_encoder1", "temporal_encoder2", "flow_encoder",
    "final_layer1", "final_layer2", "offset_mask_combine_conv", "def_fuse", "offsets_list",
    "masks_list", "modulated_deform_conv_list"))


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


def filter_pretrained_for_otpose(params: Dict[str, torch.Tensor],
                                 pretrained_layers=("*",)) -> Dict[str, torch.Tensor]:
    """The reference's remapping of a pretrained HRNet's keys (ref:
    model/OTPose.py:483-494), as ``otpose_tpu/models/torch2jax.py``'s
    ``filter_pretrained_for_otpose``: a key under one of the OTPose roots
    passes through, a bare HRNet key gets the prefix
    ``rough_pose_estimation_net.``; a key whose root is neither an OTPose
    root nor in ``pretrained_layers`` (``"*"``: every root) is dropped."""
    out = {}
    for name, tensor in params.items():
        root = name.split(".")[0]
        if not (root in pretrained_layers or "*" in pretrained_layers or root in _OTPOSE_ROOTS):
            continue
        out[name if root in _OTPOSE_ROOTS else f"rough_pose_estimation_net.{name}"] = tensor
    return out


def restore_checkpoint(path: str) -> dict:
    """Read a checkpoint of the port (a directory) or a reference ``.pth`` /
    ``.pth.tar``, tensors on the CPU.

    Returns a dict with ``params`` and ``model_state`` (name -> tensor); from
    a ``.pth``, ``begin_epoch`` / ``tensorboard_global_steps`` where the file
    has them; from an epoch checkpoint, ``optimizer`` and ``meta``."""
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
        blob = _load_state_file(path)
        params, state = split_state_dict(blob["state_dict"])
        out = {"params": params, "model_state": state}
        for k in ("optimizer", "meta"):
            if k in blob:
                out[k] = blob[k]
        return out
    raise ValueError(f"{path}: not a .pth / .pth.tar checkpoint")


def _load_state_file(path: str) -> dict:
    """The ``state.pt`` of the checkpoint directory ``path``, after any
    pending save has committed."""
    wait_for_saves()
    file = osp.join(path, STATE_FILE)
    if not osp.isfile(file):
        raise NotImplementedError(
            f"{path} holds no {STATE_FILE}, so it was not written by otpose_tpu_torch: an "
            "orbax directory written by the JAX package cannot be read without the JAX "
            "stack; export its weights as a reference-layout .pth")
    return torch.load(file, map_location="cpu", weights_only=True)


def _to_host(obj):
    """``obj`` with every tensor copied to the host (a copy even where the
    tensor is on the CPU already, so later in-place updates do not reach
    it)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _commit(path: str, payload: dict) -> None:
    """Write ``payload`` as ``path/state.pt``: into a temporary directory
    beside ``path``, renamed into place when complete (replacing an earlier
    ``path``).  A failure leaves no trace of the new directory."""
    parent, name = osp.split(path)
    tmp = tempfile.mkdtemp(prefix=f".{name}.", dir=parent)
    try:
        torch.save(payload, osp.join(tmp, STATE_FILE))
        if osp.isdir(path):
            old = osp.join(parent, f".{name}.replaced")
            shutil.rmtree(old, ignore_errors=True)
            os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


class _Writer:
    """The process's checkpoint writes, one at a time: a save waits for the
    pending one; an asynchronous save runs ``_commit`` in a thread, whose
    error the next wait raises."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        error, self._error = self._error, None
        if error is not None:
            raise error

    def write(self, path: str, payload: dict, async_save: bool) -> None:
        if not async_save:
            _commit(path, payload)
            return

        def run():
            try:
                _commit(path, payload)
            except BaseException as e:  # noqa: BLE001 — raised by the next wait
                self._error = e

        # not a daemon: the interpreter waits for a save in flight at exit
        self._thread = threading.Thread(target=run, name="checkpoint-writer")
        self._thread.start()


_WRITER = _Writer()


def wait_for_saves() -> None:
    """Block until every pending asynchronous save has committed; raises
    the error of one that failed."""
    _WRITER.wait()


def save_checkpoint(folder: str, epoch: int, train_state, *,
                    tensorboard_global_steps: int = 0, iteration: int = 0,
                    async_save: bool = False) -> str:
    """``{folder}/epoch_{N}_state`` from ``train_state`` (an
    ``engine/trainer.py::TrainState``): weights, BN statistics, optimizer
    state and meta (see the module docstring).  ``async_save`` returns once
    the tensors are on the host and serialises in the background (the train
    CLI overlaps it with validation); call ``wait_for_saves`` before reading
    the directory or exiting.  Returns the directory's path."""
    path = osp.abspath(osp.join(folder, f"epoch_{epoch}_state"))
    if process_info()[1] > 1:
        if async_save:
            raise ValueError("asynchronous checkpoint saves are for a single process: the "
                             "other ranks go on once rank 0 has written")
        if not is_primary():
            barrier()
            return path
    _WRITER.wait()
    os.makedirs(folder, exist_ok=True)
    payload = {
        "state_dict": _to_host(train_state.model.state_dict()),
        "optimizer": _to_host(train_state.optimizer.state_dict()),
        "meta": {"begin_epoch": int(epoch if iteration else epoch + 1),
                 "tensorboard_global_steps": int(tensorboard_global_steps),
                 "iteration": int(iteration)},
    }
    _WRITER.write(path, payload, async_save)
    barrier()
    return path


def save_best_checkpoint(folder: str, train_state, mAP: float) -> Optional[str]:
    """``{folder}/best_mAP_{mAP}_state`` with the weights only (ref:
    model/checkpoints.py:47-74).  Returns None, and writes nothing, when a
    prior best is not lower; otherwise writes the new best and then removes
    every prior one (all lower).  A non-finite mAP raises: its directory
    would never be compared again.  Under a multi-process launch rank 0
    decides and writes; the other ranks wait for it and return None."""
    if not math.isfinite(mAP):
        raise ValueError(f"best checkpoint for a non-finite mAP {mAP}")
    if not is_primary():
        barrier()
        return None
    path = _save_best(folder, train_state, mAP)
    barrier()
    return path


def _save_best(folder: str, train_state, mAP: float) -> Optional[str]:
    _WRITER.wait()
    os.makedirs(folder, exist_ok=True)
    priors = [(v, name) for name in os.listdir(folder)
              if (v := _parse_best(name)) is not None]
    if any(v >= mAP for v, _ in priors):
        return None
    path = osp.abspath(osp.join(folder, f"best_mAP_{mAP}_state"))
    _WRITER.write(path, {"state_dict": _to_host(train_state.model.state_dict())}, False)
    for _, name in priors:
        shutil.rmtree(osp.join(folder, name), ignore_errors=True)
    return path


def resume(folder: str, train_state):
    """Resume from the latest epoch checkpoint in ``folder`` (ref:
    model/checkpoints.py:6-25, train.py:101-110), in place: the model's
    weights and BN statistics and the optimizer's state and count.
    Returns (train_state, begin_epoch, tensorboard_global_steps,
    start_iteration); ``start_iteration > 0`` means ``begin_epoch`` was
    interrupted and its first ``start_iteration`` batches are already in
    the state.  Without a checkpoint: (train_state, 0, 0, 0)."""
    latest = get_latest_checkpoint(folder)
    if latest is None:
        return train_state, 0, 0, 0
    blob = _load_state_file(latest)
    train_state.model.load_state_dict(blob["state_dict"], strict=True)
    train_state.optimizer.load_state_dict(blob["optimizer"])
    meta = blob["meta"]
    return (train_state, int(meta["begin_epoch"]), int(meta["tensorboard_global_steps"]),
            int(meta["iteration"]))


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
