"""The ``data`` and ``seq`` axes over the ranks (counterpart of
``otpose_tpu/parallel/mesh.py``).

JAX shards the batch over the ``data`` axis of a device mesh, the
conv-transformer's tokens over an optional ``seq`` axis, and replicates
the weights.  Here the mesh is the ranks of the launch, one device each
(``parallel/distributed.py``), laid out row-major as JAX reshapes its
devices: rank r at data index r // S and seq index r % S.  ``make_mesh``
reads ``cfg.TPU.MESH_AXES`` / ``MESH_SHAPE`` and forms the groups,
``seq_group`` gives the forward its ``parallel/sequence.py::SeqGroup``,
``shard_batch`` gives a rank its data group's row block of a global batch
on its device, ``replicate`` gives every rank rank 0's weights and buffers,
and ``make_eval_shard_fn`` places eval batches.  The JAX package's
mesh-context helpers manage JAX thread-locals and have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from otpose_tpu_torch.parallel import distributed, sequence


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the launch as ``data`` x ``seq`` devices; ``seq`` None
    without a ``seq`` axis (one at size 1 still takes the sharded path, as
    JAX's ``seq_axis`` does)."""
    data: int
    seq: Optional[int] = None


def make_mesh(cfg=None) -> Mesh:
    """The mesh of ``cfg.TPU.MESH_AXES`` / ``MESH_SHAPE`` over the launch's
    ranks (-1: every rank left, as JAX's ``make_mesh`` reads it), its groups
    formed (``distributed.form_mesh``).  The axes are ``["data"]`` or
    ``["data", "seq"]``; a shape that does not multiply to the number of
    ranks raises."""
    axes = list(cfg.TPU.MESH_AXES) if cfg is not None else ["data"]
    shape = [int(n) for n in cfg.TPU.MESH_SHAPE] if cfg is not None else [-1]
    world = distributed.process_info()[1]
    if axes not in (["data"], ["data", "seq"]) or len(shape) != len(axes):
        raise ValueError(f"mesh axes {axes} of shape {shape}: the port's meshes are ['data'] "
                         f"and ['data', 'seq'], with one size each")
    if shape.count(-1) > 1 or any(n == 0 or n < -1 for n in shape):
        raise ValueError(f"mesh shape {shape}: sizes are positive, or one -1")
    known = int(np.prod([n for n in shape if n != -1]))
    if -1 in shape:
        if world % known:
            raise ValueError(f"mesh shape {shape} over {world} ranks: {world} is not a "
                             f"multiple of {known}")
        shape[shape.index(-1)] = world // known
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} over {world} ranks: the sizes multiply to "
                         f"{int(np.prod(shape))}")
    mesh = Mesh(*shape)
    distributed.form_mesh(mesh.data, mesh.seq or 0)
    return mesh


def seq_group(mesh: Mesh) -> Optional[sequence.SeqGroup]:
    """This rank's place on ``mesh``'s ``seq`` axis, for the forward; None
    without one."""
    if mesh.seq is None:
        return None
    index, size = distributed.seq_info()
    return sequence.SeqGroup(size=mesh.seq, index=index if size else 0)


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
    """This rank's row block (``local_row_block``: its data group's) of the
    global ``batch`` (a dict of host arrays or tensors), on ``device``."""
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
    is split into row blocks, one a data group (``sharded``: the caller
    gathers the outputs with ``distributed.fetch``); any other (the
    loader's last batch) runs whole on every data group, as the JAX package
    replicates it."""
    def shard_fn(batch, device):
        if len(next(iter(batch.values()))) % mesh.data == 0:
            return shard_batch(batch, device), True
        return {k: place(v, torch.device(device)) for k, v in batch.items()}, False

    return shard_fn
