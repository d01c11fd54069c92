"""The port's ``parallel/`` in one process (counterpart of the unit tier of
``tests/test_distributed.py``).

- without a launch every helper is the single-process identity and no
  collective runs: ``local_row_block``, ``process_info``, ``fetch``,
  ``broadcast_scalar``, ``barrier``, the device-group reductions;
- the port's ``Loader`` and ``DeviceLoader`` give each rank the rows the JAX
  ``Loader`` gives it (``process_index`` / ``process_count`` at 2 and 4),
  and with ``accum_steps`` 2 each rank's share of each global micro-batch;
- ``make_loader(process_shard=True)`` shards train loaders only;
- ``maybe_initialize`` is a no-op without the launch's environment, which
  is parsed in both spellings (the JAX package's and ``torchrun``'s);
- the device group's transport rule; ``make_mesh`` refuses a ``seq`` axis;
- on a one-rank ``gloo`` group: the collectives run and count, the
  ``ClusterPreemptionGuard`` agrees on a signal, a train step is bit-equal
  to the same step without a group, and an export equals one made outside
  the group (the counterpart of
  ``tests/test_export.py::test_export_and_serve_under_global_mesh``).
"""

import contextlib
import copy
import os
import signal
import socket

import numpy as np
import pytest
import torch

from otpose_tpu.data.loader import Loader as JaxLoader
from otpose_tpu_torch.config import get_cfg
from otpose_tpu_torch.data import make_loader
from otpose_tpu_torch.data.device_loader import DeviceLoader
from otpose_tpu_torch.data.loader import Loader
from otpose_tpu_torch.engine.export import export_eval
from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
from otpose_tpu_torch.engine.preempt import (ClusterPreemptionGuard, PreemptionGuard,
                                             make_preemption_guard)
from otpose_tpu_torch.engine.trainer import make_train_step
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.ops.heatmap import generate_heatmaps
from otpose_tpu_torch.parallel import distributed
from otpose_tpu_torch.parallel.mesh import (Mesh, make_eval_shard_fn, make_mesh, replicate,
                                            shard_batch)
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def one_rank_group():
    """This process as the only rank of a ``gloo`` launch."""
    env = {"OTPOSE_COORDINATOR": f"127.0.0.1:{_free_port()}", "OTPOSE_NUM_PROCESSES": "1",
           "OTPOSE_PROCESS_ID": "0"}
    assert distributed.maybe_initialize(env=env, device="cpu") == (0, 1)
    try:
        yield
    finally:
        distributed.shutdown()
    assert not distributed.active()


class Idents:
    def __len__(self):
        return 17       # not divisible: drop_last trims the tail batch

    def get_sample_host(self, idx, rng=None, native_ok=True):
        return idx


# ---------------------------------------------------------------- no launch

def test_helpers_are_the_identity_without_a_launch():
    assert not distributed.active() and distributed.device_transport() is None
    assert distributed.process_info() == (0, 1) and distributed.is_primary()
    assert distributed.local_row_block(8) == (0, 8)
    np.testing.assert_array_equal(distributed.local_rows(8, 2), np.arange(8))
    before = dict(distributed.COUNTS)
    assert distributed.broadcast_scalar(1.5) == 1.5
    assert distributed.broadcast_scalar(None) is None
    assert np.all(distributed.fetch(np.arange(3)) == np.arange(3))
    assert distributed.fetch(torch.ones(2, dtype=torch.bfloat16)).dtype == np.float32
    distributed.barrier()
    assert distributed.reached_preemption_sync_point(3, True) is False
    t = torch.arange(4.0)
    assert distributed.all_reduce_(t, "max") is t
    assert distributed.all_reduce_sum(t) is t
    distributed.average_([t])
    distributed.broadcast_([t])
    assert torch.equal(t, torch.arange(4.0))
    assert distributed.COUNTS == before
    assert isinstance(make_preemption_guard(), PreemptionGuard)


def test_maybe_initialize_is_a_noop_without_a_launch():
    cfg = get_cfg()
    assert distributed.maybe_initialize(cfg, env={}, device="cpu") == (0, 1)
    assert not distributed.active() and not torch.distributed.is_initialized()
    cfg.TPU.MULTIHOST = True
    with pytest.raises(ValueError, match="torchrun"):
        distributed.maybe_initialize(cfg, env={}, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        distributed.maybe_initialize(env={"OTPOSE_MULTIHOST": "1"}, device="cpu")


def test_the_launch_environment_is_parsed():
    assert distributed.launch_from_env({}) is None
    jax_style = {"OTPOSE_COORDINATOR": "10.0.0.1:1234", "OTPOSE_NUM_PROCESSES": "4",
                 "OTPOSE_PROCESS_ID": "3"}
    assert distributed.launch_from_env(jax_style) == distributed.Launch(
        "tcp://10.0.0.1:1234", 3, 4, 3, 4)
    torchrun = {"RANK": "5", "WORLD_SIZE": "8", "MASTER_ADDR": "node0", "MASTER_PORT": "29500",
                "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}
    assert distributed.launch_from_env(torchrun) == distributed.Launch("env://", 5, 8, 1, 4)
    # the JAX package's contract comes first
    assert distributed.launch_from_env({**torchrun, **jax_style}).rank == 3
    with pytest.raises(ValueError, match="rank"):
        distributed.launch_from_env({**jax_style, "OTPOSE_PROCESS_ID": "4"})


def test_transport_rule():
    assert distributed.transport("cpu", 2, 0)[0] == "gloo"
    assert distributed.transport("cuda", 1, 1)[0] == "nccl"
    assert distributed.transport("cuda", 2, 2)[0] == "nccl"
    backend, why = distributed.transport("cuda", 2, 1)
    assert backend == "gloo" and "share" in why


def test_make_mesh_is_one_data_axis_and_refuses_seq():
    cfg = get_cfg()
    assert make_mesh(cfg) == make_mesh() == Mesh(1)
    cfg.TPU.MESH_AXES, cfg.TPU.MESH_SHAPE = ["data", "seq"], [-1, 2]
    with pytest.raises(NotImplementedError, match="item 7"):
        make_mesh(cfg)
    cfg.TPU.MESH_AXES, cfg.TPU.MESH_SHAPE = ["data"], [4]
    with pytest.raises(ValueError, match="data"):
        make_mesh(cfg)


def test_eval_shard_fn_without_a_launch_keeps_the_batch():
    batch = {"inputs": np.arange(10.0).reshape(5, 2), "margin": np.zeros((5, 4))}
    rows, sharded = make_eval_shard_fn(Mesh(1))(batch, "cpu")
    assert sharded and torch.equal(rows["inputs"], torch.from_numpy(batch["inputs"]))
    margin = shard_batch(batch, "cpu")["margin"]
    assert torch.equal(margin, torch.zeros(5, 4, dtype=torch.float64))


# ---------------------------------------------------------------- loaders

@pytest.mark.parametrize("cls", [Loader, DeviceLoader])
@pytest.mark.parametrize("count, batch", [(2, 4), (4, 8)])
def test_loader_rows_equal_the_jax_loader_s(cls, count, batch):
    kw = dict(shuffle=True, seed=3, drop_last=True, num_workers=1)
    if cls is DeviceLoader:
        kw["device"] = "cpu"
    full = JaxLoader(Idents(), batch, shuffle=True, seed=3, drop_last=True, num_workers=1)
    full.set_epoch(5)
    views = []
    for pid in range(count):
        want = JaxLoader(Idents(), batch, shuffle=True, seed=3, drop_last=True, num_workers=1,
                         process_index=pid, process_count=count)
        got = cls(Idents(), batch, process_index=pid, process_count=count, **kw)
        for ld in (want, got):
            ld.set_epoch(5)
        assert len(got) == len(want) == 17 // batch
        got_b, want_b = got._index_batches(), want._index_batches()
        for g, w in zip(got_b, want_b):
            np.testing.assert_array_equal(g, w)
        views.append(got_b)
    for i, fb in enumerate(full._index_batches()):
        np.testing.assert_array_equal(np.concatenate([v[i] for v in views]), fb)


def test_accumulation_interleaves_the_ranks_rows():
    """With ``accum_steps`` K each rank's micro-batch i is its 1/N of the
    JAX step's global micro-batch i (rows [i B/K, (i + 1) B/K))."""
    assert distributed.local_rows(8, 2, 0, 2).tolist() == [0, 1, 4, 5]
    assert distributed.local_rows(8, 2, 1, 2).tolist() == [2, 3, 6, 7]
    assert distributed.local_rows(8, 1, 1, 2).tolist() == [4, 5, 6, 7]
    full = Loader(Idents(), 8, shuffle=True, seed=1, drop_last=True)
    ranks = [Loader(Idents(), 8, shuffle=True, seed=1, drop_last=True, process_index=r,
                    process_count=2, accum_steps=2) for r in range(2)]
    for i, fb in enumerate(full._index_batches()):
        rows = [ld._index_batches()[i] for ld in ranks]
        for k in range(2):                    # the global micro-batch k
            np.testing.assert_array_equal(np.concatenate([r[2 * k:2 * k + 2] for r in rows]),
                                          fb[4 * k:4 * k + 4])
    with pytest.raises(ValueError, match="ACCUM_STEPS"):
        distributed.local_rows(6, 2, 0, 2)
    with pytest.raises(ValueError, match="drop_last"):
        Loader(Idents(), 4, drop_last=False, process_index=0, process_count=2)


def test_make_loader_shards_train_loaders_only(monkeypatch):
    monkeypatch.setattr(distributed, "process_info", lambda: (1, 2))
    cfg = get_cfg()
    cfg.TPU.DEVICE_PREPROCESS = "off"
    cfg.TPU.ACCUM_STEPS = 2
    train = make_loader(cfg, Idents(), 8, shuffle=False, drop_last=True, process_shard=True,
                        device="cpu")
    assert (train.process_index, train.process_count) == (1, 2)
    assert train._index_batches()[0].tolist() == [2, 3, 6, 7]
    evaluation = make_loader(cfg, Idents(), 8, shuffle=False, device="cpu")
    assert (evaluation.process_index, evaluation.process_count) == (0, 1)
    cfg.TPU.DEVICE_PREPROCESS = "crops"
    dev = make_loader(cfg, Idents(), 8, shuffle=False, drop_last=True, process_shard=True,
                      device="cpu")
    assert isinstance(dev, DeviceLoader) and dev.process_count == 2


# ---------------------------------------------------------------- one rank

def test_a_one_rank_group_runs_and_counts_its_collectives():
    with one_rank_group():
        assert distributed.active()
        assert distributed.device_transport()[0] == "gloo"
        before = dict(distributed.COUNTS)
        assert distributed.broadcast_scalar(2.5) == 2.5
        assert distributed.broadcast_scalar(None) is None
        np.testing.assert_array_equal(distributed.fetch(torch.arange(3.0)), [0.0, 1.0, 2.0])
        distributed.barrier()
        t = torch.tensor([1.0, 3.0], requires_grad=True)
        y = distributed.all_reduce_sum(t)
        y.sum().backward()
        assert torch.equal(y.detach(), t.detach()) and torch.equal(t.grad, torch.ones(2))
        assert distributed.COUNTS["host"] - before["host"] == 4
        assert distributed.COUNTS["device"] - before["device"] == 2
        rows, sharded = make_eval_shard_fn(make_mesh())({"inputs": np.ones((3, 2))}, "cpu")
        assert sharded and rows["inputs"].shape == (3, 2)
        assert isinstance(make_preemption_guard(), PreemptionGuard)


def test_cluster_preemption_guard_agrees_on_a_signal():
    with one_rank_group():
        guard = ClusterPreemptionGuard(start_step=7, signals=(signal.SIGUSR1,)).install()
        try:
            assert guard.check() is False and not guard.requested
            os.kill(os.getpid(), signal.SIGUSR1)
            assert guard.signalled and not guard.requested
            assert guard.check() is True and guard.requested
            assert guard.check() is True
            assert guard._next_step == 9       # the agreed check consumed its id
        finally:
            guard.uninstall()


def _train_batch(b, seed):
    rng = np.random.RandomState(seed)
    targets, weights = [], []
    for _ in range(b):
        joints = np.zeros((17, 3))
        joints[:, :2] = rng.uniform(6, 58, (17, 2))
        vis = np.zeros((17, 3))
        vis[:10, 0] = 1.0
        t, w = generate_heatmaps(joints, vis, 2, (64, 64), (16, 16), 17)
        targets.append(t.transpose(1, 2, 0))
        weights.append(w)
    return {"inputs": torch.from_numpy(rng.randn(b, 64, 64, 15).astype(np.float32)),
            "margin": torch.from_numpy(rng.randint(0, 3, (b, 4)).astype(np.float32)),
            "target": torch.from_numpy(np.stack(targets).astype(np.float32)),
            "target_weight": torch.from_numpy(np.stack(weights).astype(np.float32))}


def test_one_rank_group_step_is_bit_equal_to_no_group():
    """Two steps at ``accum_steps`` 2 with dropout: the collectives of one
    rank change no bit of the metrics, the weights or the BN statistics."""
    cfg = tiny_otpose_cfg()
    _, model = build_model(cfg, seed=2, device="cpu")
    batch = _train_batch(4, 0)

    def run():
        m = copy.deepcopy(model)
        replicate(m)
        step = make_train_step(m, make_optimizer(m, cfg, make_schedule(cfg, 1)), accum_steps=2,
                               generator=torch.Generator().manual_seed(0))
        return [step(batch) for _ in range(2)], m.state_dict()

    plain = run()
    with one_rank_group():
        before = distributed.COUNTS["device"]
        grouped = run()
        assert distributed.COUNTS["device"] - before > 200
    for a, b in zip(plain[0], grouped[0]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k, v in plain[1].items():
        assert torch.equal(v, grouped[1][k]), k


def test_export_inside_a_one_rank_group_equals_one_outside():
    _, model = build_model(tiny_otpose_cfg(image_size=32, heatmap_size=8), seed=1, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 32, 15).astype(np.float32))
    margin = torch.ones(2, 4)
    outside = export_eval(model, batch_size=2, device="cpu")
    with one_rank_group():
        inside = export_eval(model, batch_size=2, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(inside.program.module()(x, margin),
                                                    outside.program.module()(x, margin)))
    assert all(torch.equal(a, b) for a, b in zip(inside.program.module()(x, margin),
                                                outside.program.module()(x, margin)))
