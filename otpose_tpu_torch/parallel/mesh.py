"""The data axis over the ranks (counterpart of ``otpose_tpu/parallel/mesh.py``).

JAX shards the batch over the ``data`` axis of a device mesh and replicates
the weights.  Here the mesh is the ranks of the launch, one device each
(``parallel/distributed.py``): ``shard_batch`` gives a rank its row block
of a global batch on its device, ``replicate`` gives every rank rank 0's
weights and buffers, and ``make_eval_shard_fn`` places eval batches.  The
JAX package's mesh-context helpers manage JAX thread-locals and have no
counterpart.  A ``seq`` axis (sequence parallelism, ``Ctx.seq_axis``) is
not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from otpose_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the launch as one ``data`` axis of ``size`` devices."""
    size: int


def make_mesh(cfg=None) -> Mesh:
    """The mesh of ``cfg.TPU.MESH_AXES`` / ``MESH_SHAPE`` (-1: every rank)
    over the launch's ranks.  Only a ``data`` axis is supported."""
    axes = list(cfg.TPU.MESH_AXES) if cfg is not None else ["data"]
    shape = list(cfg.TPU.MESH_SHAPE) if cfg is not None else [-1]
    if "seq" in axes:
        raise NotImplementedError("a 'seq' mesh axis (sequence parallelism, Ctx.seq_axis) is not "
                                  "ported (ROADMAP Queue 1 item 7)")
    world = distributed.process_info()[1]
    if axes != ["data"] or shape not in ([-1], [world]):
        raise ValueError(f"mesh axes {axes} of shape {shape}: the port shards the batch over "
                         f"one 'data' axis of all {world} ranks (MESH_SHAPE [-1])")
    return Mesh(world)


def place(v, device: torch.device) -> torch.Tensor:
    """A batch entry on ``device``: a tensor already there as it is (a
    tensor on another device type raises), a host array staged in pinned
    memory and copied without blocking to a CUDA device."""
    if isinstance(v, torch.Tensor):
        if v.device.type != device.type:
            raise ValueError(f"a batch entry is on {v.device}, the run on {device}")
        return v
    t = torch.from_numpy(np.ascontiguousarray(v))
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def shard_batch(batch: dict, device) -> dict:
    """This rank's row block (``local_row_block``) of the global ``batch``
    (a dict of host arrays or tensors), on ``device``."""
    lo, hi = distributed.local_row_block(len(next(iter(batch.values()))))
    return {k: place(v[lo:hi], torch.device(device)) for k, v in batch.items()}


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """``module``'s parameters and buffers overwritten with rank 0's (one
    broadcast a dtype); the module as it is without a launch."""
    with torch.no_grad():
        distributed.broadcast_([t.data for t in module.parameters()] + list(module.buffers()))
    return module


def make_eval_shard_fn(mesh: Mesh):
    """``shard_fn(batch, device) -> (rows on device, sharded)`` for the eval
    loops, whose loaders keep full batches on every rank (the host's
    bookkeeping needs every row).  A batch that divides the ``data`` axis
    is split into row blocks (``sharded``: the caller gathers the outputs
    with ``distributed.fetch``); any other (the loader's last batch) runs
    whole on every rank, as the JAX package replicates it."""
    def shard_fn(batch, device):
        if len(next(iter(batch.values()))) % mesh.size == 0:
            return shard_batch(batch, device), True
        return {k: place(v, torch.device(device)) for k, v in batch.items()}, False

    return shard_fn
