"""Data and sequence parallelism across processes, one GPU each
(counterpart of ``otpose_tpu/parallel/distributed.py``).

The JAX package runs one program over a mesh of every device, and XLA
reduces whatever the step reduces over the batch over the *global* batch.
Here each process (a rank) runs the step on its own rows, so each place
where the JAX step decides over the batch needs a collective:

- train BN statistics (``models/core.py::batch_norm_train``): one
  differentiable all-reduce of ``[mean, E[x^2]]`` a layer;
- the loss's ``labeled`` test (``models/losses.py``): a MAX across ranks;
- the PCK meter (``evaluate/pck.py::accuracy_device``): hits and visible
  joints summed before the ratio;
- the gradients and metrics (``engine/trainer.py::make_train_step``):
  averaged once a step, before the optimizer.

Launch contract, read by ``maybe_initialize``: the JAX package's
``OTPOSE_COORDINATOR=host:port``, ``OTPOSE_NUM_PROCESSES=N`` and
``OTPOSE_PROCESS_ID=i``; failing those, ``torchrun``'s ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` (and ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``).  Without either, nothing is initialised, no
collective runs and every function here is the single-process identity.

Two process groups:

- the *device group* carries the weights' broadcast and, without a ``seq``
  axis, BN statistics, the loss's and meter's decisions and the gradients:
  NCCL when every rank on the host has a card of its own, else ``gloo``
  (the CPU, or ranks sharing a card, which NCCL refuses); ``transport`` is
  the rule, and the choice is logged;
- the *host group* (``gloo``, CPU tensors) carries ``fetch``,
  ``broadcast_scalar``, ``barrier`` and the preemption agreement.

Under a ``data x seq`` mesh (``parallel/mesh.py::make_mesh``, which calls
``form_mesh``) rank r sits at data index r // S and seq index r % S, and two
more groups of each rank carry the device collectives:

- its *data group* (the ranks of its seq index, one a data index): BN
  statistics, the loss's and meter's decisions, the gradients' and the
  metrics' average;
- its *seq group* (the S ranks of its data index, which hold the same rows
  and split the conv-transformer's tokens): the halo exchanges, the partial
  scores and the gathers of ``parallel/sequence.py``, and the encoders'
  gradient sum.

Every rank makes every one of those groups in the same order, with the
device group's transport.  Without a ``seq`` axis the data group is the
device group and there is no seq group.

Once a group exists the collectives run even at world size 1, so a
one-rank run exercises them.  ``COUNTS`` counts the collectives each group
has run (``device``: the device group and the data groups).  Only rank 0
(``is_primary``) writes checkpoints, TensorBoard and the poseval files; a
scalar it computes reaches the others through ``broadcast_scalar``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# collectives run on each group since the process started
COUNTS = {"device": 0, "seq": 0, "host": 0}


@dataclasses.dataclass(frozen=True)
class Launch:
    """Where this process sits in a launch: how it meets the others
    (``init_method``: the JAX package's coordinator as ``tcp://host:port``,
    or ``env://`` under ``torchrun``, whose agent may already serve the
    rendezvous), its rank among ``world_size`` and among the
    ``local_world_size`` ranks of its host."""
    init_method: str
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int


@dataclasses.dataclass
class _Groups:
    host: "dist.ProcessGroup"
    device: "dist.ProcessGroup"
    transport: str
    reason: str
    # the data x seq layout (``form_mesh``): this rank's groups, and each
    # formed layout's by (data, seq), made once
    data: Optional["dist.ProcessGroup"] = None
    seq: Optional["dist.ProcessGroup"] = None
    seq_size: int = 0          # 0: no seq axis
    formed: dict = dataclasses.field(default_factory=dict)


_GROUPS: Optional[_Groups] = None


def launch_from_env(env=os.environ) -> Optional[Launch]:
    """The launch ``env`` describes, or None for a single-process run."""
    if env.get("OTPOSE_COORDINATOR"):
        world, rank = int(env["OTPOSE_NUM_PROCESSES"]), int(env["OTPOSE_PROCESS_ID"])
        init_method = f"tcp://{env['OTPOSE_COORDINATOR']}"
    elif "RANK" in env and "WORLD_SIZE" in env:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        init_method = "env://"      # MASTER_ADDR and MASTER_PORT
    else:
        return None
    if not 0 <= rank < world:
        raise ValueError(f"process {rank} of {world}: the rank must lie in [0, {world})")
    return Launch(init_method, rank, world, int(env.get("LOCAL_RANK", rank)),
                  int(env.get("LOCAL_WORLD_SIZE", world)))


def transport(device_type: str, local_world_size: int, cards: int) -> tuple:
    """(backend of the device group, why).  NCCL needs a card per rank."""
    if device_type != "cuda":
        return "gloo", f"the ranks run on the {device_type}"
    if local_world_size > cards:
        return "gloo", (f"{local_world_size} ranks share {cards} card(s) and NCCL refuses two "
                        f"ranks on one GPU")
    return "nccl", f"each of the {local_world_size} ranks on this host has a card of its own"


def maybe_initialize(cfg=None, env=os.environ, device=None) -> tuple:
    """Join the launch that ``env`` describes (see the module docstring) and
    make the two groups; a no-op without one, or when already joined.
    ``device`` is this rank's device (``utils/device.py::resolve_device``
    of None by default: the rank's card).  Returns ``(rank, world_size)``."""
    global _GROUPS
    if _GROUPS is not None:
        return process_info()
    launch = launch_from_env(env)
    if launch is None:
        flagged = env.get("OTPOSE_MULTIHOST", "") not in ("", "0", "false") or (
            cfg is not None and bool(cfg.TPU.MULTIHOST))
        if flagged:
            raise ValueError("TPU.MULTIHOST / OTPOSE_MULTIHOST ask for a TPU pod's auto-detection; "
                             "launch with torchrun or set OTPOSE_COORDINATOR, "
                             "OTPOSE_NUM_PROCESSES and OTPOSE_PROCESS_ID")
        return 0, 1
    from otpose_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend, reason = transport(dev.type, launch.local_world_size, cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None else torch.cuda.current_device())
    dist.init_process_group("gloo", init_method=launch.init_method, rank=launch.rank,
                            world_size=launch.world_size)
    host = dist.group.WORLD
    device_group = dist.new_group(backend="nccl") if backend == "nccl" else host
    _GROUPS = _Groups(host, device_group, backend, reason)
    logger.info("=> rank %d of %d via %s on %s; device group %s (%s), host group gloo",
                launch.rank, launch.world_size, launch.init_method, dev, backend, reason)
    return launch.rank, launch.world_size


def shutdown() -> None:
    """Leave the launch (destroy the groups); a no-op without one."""
    global _GROUPS
    if _GROUPS is not None:
        _GROUPS = None
        dist.destroy_process_group()


def active() -> bool:
    """Whether this process has joined a launch (the collectives run)."""
    return _GROUPS is not None


def device_transport() -> Optional[tuple]:
    """(backend, why) of the device group, or None without a launch."""
    return None if _GROUPS is None else (_GROUPS.transport, _GROUPS.reason)


def process_info() -> tuple:
    """``(rank, world_size)``; ``(0, 1)`` without a launch."""
    if _GROUPS is None:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    return process_info()[0] == 0


def form_mesh(data: int, seq: int) -> None:
    """Lay the launch's ranks out as ``data x seq`` (rank r at data index
    r // seq, seq index r % seq) and make every seq and data group, each
    rank the same ones in the same order; ``seq = 0`` is the plain data
    axis (the device group).  A layout is formed once and can be formed
    again to switch to it.  Without a launch only ``1 x seq`` (seq 0 or 1)
    exists and nothing is made."""
    world = process_info()[1]
    if data * max(seq, 1) != world:
        raise ValueError(f"a {data} x {max(seq, 1)} mesh needs {data * max(seq, 1)} ranks, "
                         f"the launch has {world}")
    if _GROUPS is None:
        return
    if seq == 0:
        _GROUPS.data, _GROUPS.seq, _GROUPS.seq_size = _GROUPS.device, None, 0
        return
    if (data, seq) not in _GROUPS.formed:
        rank = dist.get_rank()
        backend = _GROUPS.transport
        mine = {}
        for d in range(data):
            ranks = list(range(d * seq, (d + 1) * seq))
            group = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                mine["seq"] = group
        for s in range(seq):
            ranks = list(range(s, world, seq))
            group = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                mine["data"] = group
        _GROUPS.formed[(data, seq)] = mine
        logger.info("=> rank %d: a %d x %d data x seq mesh (%s groups)", rank, data, seq,
                    backend)
    mine = _GROUPS.formed[(data, seq)]
    _GROUPS.data, _GROUPS.seq, _GROUPS.seq_size = mine["data"], mine["seq"], seq


def seq_info() -> tuple:
    """``(seq index, seq size)`` of this rank; ``(0, 0)`` without a seq axis."""
    if _GROUPS is None or not _GROUPS.seq_size:
        return 0, 0
    return dist.get_rank() % _GROUPS.seq_size, _GROUPS.seq_size


def data_info() -> tuple:
    """``(data index, data size)`` of this rank: ``(rank, world)`` without a
    seq axis, ``(0, 1)`` without a launch."""
    rank, world = process_info()
    s = max(seq_info()[1], 1)
    return rank // s, world // s


def local_row_block(global_batch: int) -> tuple:
    """This rank's contiguous ``[lo, hi)`` row block of a global batch, in
    data-index order (JAX's process-major layout of the ``data`` axis); the
    ranks of one seq group get the same block."""
    index, size = data_info()
    if global_batch % size:
        raise ValueError(f"global batch {global_batch} not divisible by the {size} data groups")
    per = global_batch // size
    return index * per, (index + 1) * per


def local_rows(global_batch: int, accum_steps: int = 1, rank: Optional[int] = None,
               world: Optional[int] = None) -> np.ndarray:
    """The rows of a global train batch that data index ``rank`` of
    ``world`` (default: this rank's data index and the data size) loads, in
    order, so that its ``i``-th of ``accum_steps`` micro-batches
    is its share of the JAX step's global micro-batch ``i``, rows
    ``[i B / K, (i + 1) B / K)``: the concatenation over ``i`` of the
    rank's 1/N of micro-batch ``i``.  At ``accum_steps = 1`` this is
    ``local_row_block``."""
    if rank is None or world is None:
        rank, world = data_info()
    if global_batch % (accum_steps * world):
        raise ValueError(f"global batch {global_batch} not divisible by accum_steps "
                         f"{accum_steps} x {world} data groups (TRAIN.BATCH_SIZE_PER_GPU must "
                         f"divide by TPU.ACCUM_STEPS)")
    micro = global_batch // accum_steps
    per = micro // world
    return np.concatenate([np.arange(i * micro + rank * per, i * micro + (rank + 1) * per)
                           for i in range(accum_steps)])


# ---------------------------------------------------------------------------
# the device group: on the ranks' devices
# ---------------------------------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _group(name: str):
    """(process group, its ``COUNTS`` key) of ``name``: "data" (this rank's
    data group, the device group without a seq axis), "seq" (None without
    one) or "device"."""
    if name == "seq":
        return _GROUPS.seq, "seq"
    if name == "data":
        return _GROUPS.data or _GROUPS.device, "device"
    if name == "device":
        return _GROUPS.device, "device"
    raise ValueError(f"no {name!r} group: data, seq or device")


def group_size(group: str = "data") -> int:
    """The number of ranks of ``group`` (1 without a launch or the group)."""
    if _GROUPS is None:
        return 1
    pg, _ = _group(group)
    return 1 if pg is None else dist.get_world_size(pg)


def all_reduce_(t: torch.Tensor, op: str = "sum", group: str = "data") -> torch.Tensor:
    """``t`` reduced in place across the ranks of ``group`` (no gradient);
    ``t`` as it is without a launch or the group."""
    if _GROUPS is not None:
        pg, key = _group(group)
        if pg is not None:
            COUNTS[key] += 1
            dist.all_reduce(t, op=_OPS[op], group=pg)
    return t


def all_gather(t: torch.Tensor, group: str = "seq") -> list:
    """Every rank's ``t`` (one shape) across ``group``, in rank order (no
    gradient); ``[t]`` without a launch or the group."""
    pg, key = (None, None) if _GROUPS is None else _group(group)
    if pg is None:
        return [t]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(pg))]
    COUNTS[key] += 1
    dist.all_gather(parts, t, group=pg)
    return parts


class _AllReduceSum(torch.autograd.Function):
    """The sum across a group's ranks; its gradient is the sum of the ranks'
    gradients (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group=group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), group=ctx.group), None


def all_reduce_sum(t: torch.Tensor, group: str = "data") -> torch.Tensor:
    """A differentiable sum of ``t`` across the ranks of ``group`` (a new
    tensor); ``t`` itself without a launch."""
    return t if _GROUPS is None else _AllReduceSum.apply(t, group)


def average_(tensors, group: str = "data") -> None:
    """Replace each tensor of ``tensors`` (one dtype) by its mean across the
    ranks of ``group``, in one collective; nothing without a launch."""
    _reduce_flat(tensors, group, mean=True)


def sum_(tensors, group: str = "seq") -> None:
    """Replace each tensor of ``tensors`` (one dtype) by its sum across the
    ranks of ``group``, in one collective; nothing without a launch."""
    _reduce_flat(tensors, group, mean=False)


def _reduce_flat(tensors, group: str, mean: bool) -> None:
    tensors = list(tensors)
    if _GROUPS is None or not tensors or _group(group)[0] is None:
        return
    flat = all_reduce_(torch._utils._flatten_dense_tensors(tensors), group=group)
    if mean:
        flat.div_(group_size(group))
    for t, v in zip(tensors, torch._utils._unflatten_dense_tensors(flat, tensors)):
        t.copy_(v)


def broadcast_(tensors) -> None:
    """Overwrite each tensor of ``tensors`` with rank 0's, one collective a
    dtype; nothing without a launch."""
    if _GROUPS is None:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch._utils._flatten_dense_tensors(group)
        COUNTS["device"] += 1
        dist.broadcast(flat, src=0, group=_GROUPS.device)
        for t, v in zip(group, torch._utils._unflatten_dense_tensors(flat, group)):
            t.copy_(v)


# ---------------------------------------------------------------------------
# the host group: CPU tensors over gloo
# ---------------------------------------------------------------------------

def _host_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def fetch(x) -> np.ndarray:
    """``x`` (a tensor on any device, or an array) on the host, with every
    data group's rows: an all-gather over the host group, concatenated in
    data-index order from one rank of each data group (each rank passes its
    rows, all of one shape; the ranks of a seq group pass the same rows).
    Without a launch, ``x`` as a numpy array."""
    host = _host_numpy(x)
    if _GROUPS is None:
        return host
    t = torch.from_numpy(np.ascontiguousarray(host))
    parts = [torch.empty_like(t) for _ in range(process_info()[1])]
    COUNTS["host"] += 1
    dist.all_gather(parts, t, group=_GROUPS.host)
    return torch.cat(parts[::max(seq_info()[1], 1)]).numpy()


def barrier() -> None:
    """Wait for every rank; a no-op without a launch."""
    if _GROUPS is not None:
        COUNTS["host"] += 1
        dist.barrier(group=_GROUPS.host)


def broadcast_scalar(value: Optional[float]) -> Optional[float]:
    """Rank 0's ``value`` on every rank (None travels as NaN), so control
    flow that depends on it (the best checkpoint) stays the same on all."""
    if _GROUPS is None:
        return value
    t = torch.tensor([np.nan if value is None else float(value)], dtype=torch.float64)
    COUNTS["host"] += 1
    dist.broadcast(t, src=0, group=_GROUPS.host)
    out = float(t[0])
    return None if np.isnan(out) else out


def reached_preemption_sync_point(step_id: int, signalled: bool) -> bool:
    """The preemption agreement: True on every rank at the same
    ``step_id`` once any rank was ``signalled`` (a MAX across the ranks).
    Each rank calls it once an iteration with the same ``step_id``; a rank
    that calls it with another one raises.  False without a launch (the
    single-process guard reads its own flag)."""
    if _GROUPS is None:
        return False
    t = torch.tensor([int(signalled), step_id, -step_id], dtype=torch.int64)
    COUNTS["host"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_GROUPS.host)
    if int(t[1]) != -int(t[2]):
        raise RuntimeError(f"the ranks reached the preemption check at different steps "
                           f"({-int(t[2])} to {int(t[1])}): a rank skipped a check")
    return bool(t[0])
