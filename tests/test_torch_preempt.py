"""The port's training harness below the CLI, against the JAX package's.

- ``engine/preempt.py``: the guard's flag, the previous handler restored on
  uninstall and on a second signal, the context manager, ``check`` and
  ``make_preemption_guard``, as ``tests/test_preempt.py`` holds the JAX
  guard;
- ``set_start_iteration``: exactly the tail of a full pass, once, for the
  host ``Loader`` and for the ``DeviceLoader`` in crops mode on the CPU;
- ``adjust_sigma`` equal to the JAX function;
- ``utils/profiling.py::maybe_trace``: one trace over the window, a resumed
  run that enters it midway stops only what it started;
- ``train_epoch`` against JAX's ``train_epoch``: one synthetic jpg tree
  (tests/helpers/synthetic_data.py), each package's own host loader over it
  (the JAX one with its C++ library reported absent, so both crop with cv2),
  the tiny spec at 64x64 in f32, the same weights (numpy values with JAX
  init's keys, the refinement calibrated, conditioned for gradients:
  ``utils/testing.py::condition_for_gradients_``), SGD with momentum and no
  warm-up, dropout rates 0, four steps: the losses of every step to 1e-5
  relative (its gradient norm and PCK to 1e-3), every weight to 1e-3 of its
  tensor's peak, every update (after minus before) to 1e-2 of the update's
  peak plus an ulp of the weight (the offset convs', whose gradient differs
  by design at integer sample positions, only non-zero), the BN running
  stats to 1e-4 of their peak.  HRNet's final conv holds most of the
  gradients' norm on this fixture, so the clip leaves many updates near an
  ulp: those pass on the ulp, and at least 100 tensors move by more;
- an iteration-exact resume of the port on the CPU, dropout on and AdamW:
  preempted after two iterations, checkpointed, resumed in a fresh state
  and loader, bit-equal to the uninterrupted two epochs in every weight, BN
  statistic, optimizer moment, the update count and the step count, as
  ``tests/test_preempt.py`` holds the JAX package's.
"""

import copy
import dataclasses
import os
import signal

import jax
import numpy as np
import pytest
import torch

from otpose_tpu.data import native as jax_native
from otpose_tpu.data.loader import Loader as JaxLoader
from otpose_tpu.data.posetrack import PoseTrackDataset as JaxDataset
from otpose_tpu.engine.optim import make_optimizer as jax_make_optimizer
from otpose_tpu.engine.optim import make_schedule as jax_make_schedule
from otpose_tpu.engine.runner import train_epoch as jax_train_epoch
from otpose_tpu.engine.trainer import init_train_state as jax_init_train_state
from otpose_tpu.engine.trainer import make_train_step as jax_make_train_step
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl
from otpose_tpu.ops.heatmap import adjust_sigma as jax_adjust_sigma
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.data import native as port_native
from otpose_tpu_torch.data.device_loader import DeviceLoader
from otpose_tpu_torch.data.loader import Loader
from otpose_tpu_torch.data.posetrack import PoseTrackDataset
from otpose_tpu_torch.engine import checkpoints as ckpt
from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
from otpose_tpu_torch.engine.preempt import PreemptionGuard, make_preemption_guard
from otpose_tpu_torch.engine.runner import step_seed, train_epoch
from otpose_tpu_torch.engine.trainer import init_train_state, make_train_step
from otpose_tpu_torch.models.blocks import set_drop_rates
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import load_jax_weights, to_jax
from otpose_tpu_torch.ops.heatmap import adjust_sigma
from otpose_tpu_torch.utils import profiling
from otpose_tpu_torch.utils.profiling import maybe_trace
from otpose_tpu_torch.utils.testing import condition_for_gradients_, tiny_otpose_cfg

from tests.helpers.synthetic_data import make_synthetic_posetrack
from tests.helpers.torch_port import (calibrate_refinement, numpy_weights,  # noqa: F401
                                      one_torch_thread)

pytest.importorskip("cv2")
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module", autouse=True)
def _port_native_off():
    """The port's native IO library reported absent too, as the JAX
    package's is below: both packages read, crop and draw targets on the
    cv2 path (the native warp differs from cv2's by a uint8 step)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_native, "is_available", lambda: False)
        yield
METRICS = ("final_loss", "ohkm_loss_s", "mse_loss_s", "occ_final_loss", "pck_acc", "grad_norm")


# --------------------------------------------------------------------- guard

def test_guard_flag_and_restore():
    guard = PreemptionGuard((signal.SIGUSR1,)).install()
    try:
        assert not guard.requested
        signal.raise_signal(signal.SIGUSR1)
        assert guard.requested
    finally:
        guard.uninstall()
    hits = []
    prev = signal.signal(signal.SIGUSR1, lambda *_: hits.append(1))
    try:
        signal.raise_signal(signal.SIGUSR1)
        assert hits == [1]
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_second_signal_restores_the_previous_handler_and_raises_again():
    hits = []
    prev = signal.signal(signal.SIGUSR2, lambda *_: hits.append(1))
    try:
        guard = PreemptionGuard((signal.SIGUSR2,)).install()
        signal.raise_signal(signal.SIGUSR2)
        assert guard.requested and hits == []
        signal.raise_signal(signal.SIGUSR2)
        assert hits == [1]
        assert signal.getsignal(signal.SIGUSR2) is not guard._handle
    finally:
        signal.signal(signal.SIGUSR2, prev)


def test_guard_context_manager():
    before = signal.getsignal(signal.SIGUSR2)
    with PreemptionGuard((signal.SIGUSR2,)) as guard:
        assert not guard.requested
        signal.raise_signal(signal.SIGUSR2)
        assert guard.requested
    assert signal.getsignal(signal.SIGUSR2) is before


def test_guard_check_mirrors_requested():
    guard = PreemptionGuard((signal.SIGUSR1,)).install()
    try:
        assert guard.check() is False
        signal.raise_signal(signal.SIGUSR1)
        assert guard.check() is True
    finally:
        guard.uninstall()


def test_make_preemption_guard_takes_sigterm():
    before = signal.getsignal(signal.SIGTERM)
    guard = make_preemption_guard(start_step=7)
    try:
        assert isinstance(guard, PreemptionGuard)
        assert signal.getsignal(signal.SIGTERM) == guard._handle
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.check()
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before


# ------------------------------------------------------ small host functions

@pytest.mark.parametrize("schedule", [[], [1], [2, 4], [0, 1, 2, 3, 4, 5]])
def test_adjust_sigma_matches_jax(schedule):
    for epoch in range(7):
        for sigma in (1, 2, 3, 2.5):
            assert adjust_sigma(epoch, sigma, schedule) == \
                jax_adjust_sigma(epoch, sigma, schedule)


def test_step_seed_is_keyed_by_its_indices():
    seeds = {step_seed(s, e, g) for s in (0, 8888) for e in range(3) for g in range(5)}
    assert len(seeds) == 30
    assert step_seed(8888, 2, 4) == step_seed(8888, 2, 4)
    assert all(0 <= s < 2 ** 64 for s in seeds)


def test_maybe_trace_writes_one_trace_over_the_window(tmp_path):
    with maybe_trace("", step=10):
        pass
    d = str(tmp_path / "prof")
    for step in range(16):
        with maybe_trace(d, step=step, first_step=10, num_steps=5):
            torch.ones(4).sum()
        assert (profiling._active["prof"] is not None) == (10 <= step < 14)
    assert os.listdir(d) == ["trace_steps_10-14.json"]


def test_maybe_trace_resumed_midwindow_stops_what_it_started(tmp_path):
    d = str(tmp_path / "prof")
    for step in (12, 13, 14, 15):
        with maybe_trace(d, step=step, first_step=10, num_steps=5):
            pass
    assert profiling._active["prof"] is None
    assert os.listdir(d) == ["trace_steps_12-14.json"]
    for step in (15, 16):          # past the window: nothing starts
        with maybe_trace(d, step=step, first_step=10, num_steps=5):
            pass
    assert profiling._active["prof"] is None and len(os.listdir(d)) == 1


# ------------------------------------------------------------------- loaders

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_preempt")
    json_dir, img_dir, _ = make_synthetic_posetrack(
        str(root), num_videos=1, frames_per_video=4, people_per_frame=2, img_w=96, img_h=96)

    def fill(cfg):
        cfg.DATASET.JSON_DIR = json_dir
        cfg.DATASET.IMG_DIR = img_dir
        cfg.DATASET.COLOR_RGB = True
        cfg.TRAIN.PROB_HALF_BODY = 0.0
        cfg.PRINT_FREQ = 1
        cfg.TPU.COMPUTE_DTYPE = "float32"
        return cfg

    return fill


@pytest.mark.parametrize("kind", ["host", "device_crops"])
def test_start_iteration_gives_the_tail_of_a_full_pass_once(tree, kind):
    ds = PoseTrackDataset(tree(tiny_otpose_cfg()), "train")
    if kind == "host":
        loader = Loader(ds, 2, shuffle=True, num_workers=2, seed=9, drop_last=True)
    else:
        loader = DeviceLoader(ds, 2, shuffle=True, num_workers=2, seed=9, drop_last=True,
                              mode="crops", device="cpu")
    loader.set_epoch(3)
    full = [(np.asarray(b["inputs"]), np.asarray(b["target"]), [m["image"] for m in metas])
            for b, metas in loader]
    assert len(full) == len(loader) == 4
    loader.set_epoch(3)
    loader.set_start_iteration(2)
    tail = [(np.asarray(b["inputs"]), np.asarray(b["target"]), [m["image"] for m in metas])
            for b, metas in loader]
    assert len(tail) == 2
    for (x, t, names), (y, u, names2) in zip(full[2:], tail):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(t, u)
        assert names == names2
    loader.set_epoch(3)
    assert len([1 for _ in loader]) == len(full)       # one-shot


# --------------------------------------------------------- train_epoch vs JAX

class Scalars:
    """A TensorBoard writer that keeps what it is given."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))

    def by_step(self):
        out = {}
        for tag, value, step in self.rows:
            out.setdefault(step, {})[tag.split("/", 1)[1]] = value
        return out


def _first_batch(loader):
    it = iter(loader)
    try:
        return next(it)[0]
    finally:
        it.close()


@pytest.fixture(scope="module")
def sgd_case(tree):
    """Both packages' configs (SGD, momentum 0.9, no weight decay, lr 1e-3
    from the first step), datasets over one tree, and one set of weights:
    JAX init's keys with numpy values, conditioned on the first batch."""
    cfg, jcfg = tree(tiny_otpose_cfg()), tree(jax_tiny_cfg())
    for c in (cfg, jcfg):
        c.TRAIN.OPTIMIZER, c.TRAIN.WD, c.TRAIN.WARMUP, c.TRAIN.LR = "SGD", 0.0, False, 1e-3
    ds, jds = PoseTrackDataset(cfg, "train"), JaxDataset(jcfg, "train")
    raw, state = numpy_weights(_init_otpose_impl, JaxSpec.from_cfg(jcfg))
    first = _first_batch(Loader(ds, 2, shuffle=True, num_workers=2, seed=123, drop_last=True))
    x, margin = (torch.from_numpy(first[k]) for k in ("inputs", "margin"))
    _, model = build_model(cfg, device="cpu")
    load_jax_weights(model, raw, state)
    set_drop_rates(model)
    condition_for_gradients_(model, x, margin)
    params, state = to_jax(model)
    inside = calibrate_refinement(params, state, first["inputs"], first["margin"])
    load_jax_weights(model, params, state)
    return dict(cfg=cfg, jcfg=jcfg, ds=ds, jds=jds, params=params, state=state, model=model,
                inside=inside)


def test_train_epoch_matches_jax(sgd_case):
    case = sgd_case
    assert case["inside"] > 0.5
    jspec0 = dataclasses.replace(JaxSpec.from_cfg(case["jcfg"]), proj_pdrop=0.0, path_pdrop=0.0)
    opt = jax_make_optimizer(case["params"], case["jcfg"], jax_make_schedule(case["jcfg"], 4))
    jts = jax_init_train_state(case["params"], case["state"], opt)
    jstep = jax_make_train_step(jspec0, opt, donate=False)
    jrec = Scalars()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "is_available", lambda: False)
        jloader = JaxLoader(case["jds"], 2, shuffle=True, num_workers=2, seed=123,
                            drop_last=True)
        jloader.set_epoch(0)
        jts, jsteps, jdone = jax_train_epoch(jstep, jts, jloader, 0, case["jcfg"],
                                             rng=jax.random.PRNGKey(0), tb_writer=jrec)

    model = copy.deepcopy(case["model"])
    opt = make_optimizer(model, case["cfg"], make_schedule(case["cfg"], 4))
    gen = torch.Generator()
    step = make_train_step(model, opt, generator=gen)
    loader = Loader(case["ds"], 2, shuffle=True, num_workers=2, seed=123, drop_last=True)
    loader.set_epoch(0)
    rec = Scalars()
    state, steps, done = train_epoch(step, init_train_state(model, opt), loader, 0,
                                     case["cfg"], seed=0, generator=gen, tb_writer=rec)
    assert (steps, done) == (jsteps, jdone) == (4, 4) and state.step == 4 == int(jts.step)

    got, want = rec.by_step(), jrec.by_step()
    assert sorted(got) == sorted(want) == [1, 2, 3, 4]
    for s in want:
        assert set(got[s]) == set(want[s]) == set(METRICS)
        for k in METRICS:
            # the losses to 1e-5; the gradients' global norm to 1e-3: JAX's
            # f32 norm reads 2e-4 from the port's, which stays within 1e-4
            # of JAX's f64 (tests/test_torch_train_step.py)
            rel = 1e-3 if k in ("pck_acc", "grad_norm") else 1e-5
            assert got[s][k] == pytest.approx(want[s][k], rel=rel, abs=1e-7), (s, k)
    assert len({round(got[s]["final_loss"], 6) for s in got}) == 4    # four batches

    params, stats = to_jax(model)
    moved = 0
    for k, w in jts.params.items():
        w, init = np.asarray(w), case["params"][k]
        np.testing.assert_allclose(params[k], w, rtol=0, atol=1e-3 * np.abs(w).max(), err_msg=k)
        upd, jupd = params[k] - init, w - init
        if k.startswith("offsets_list."):
            assert np.abs(upd).max() > 0, k
            continue
        ulp = np.spacing((np.abs(init) + np.abs(jupd)).astype(np.float32))
        assert (np.abs(upd - jupd) <= 1e-2 * np.abs(jupd).max() + ulp).all(), (
            k, np.abs(upd - jupd).max() / max(np.abs(jupd).max(), 1e-30))
        moved += bool((np.abs(jupd) > ulp).any())
    assert moved >= 100, moved
    for k, w in jts.model_state.items():
        if "running" in k:
            w = np.asarray(w)
            np.testing.assert_allclose(stats[k], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)


# -------------------------------------------------------------- exact resume

def _snapshot(state):
    """Every number a resumed run must reproduce, as host tensors."""
    opt = state.optimizer.opt
    moments = [{k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in s.items()}
               for s in (opt.state[p] for p in state.optimizer.params)]
    return ({n: t.detach().clone() for n, t in state.model.state_dict().items()}, moments,
            state.step)


def test_iteration_exact_resume_is_bit_equal(tree, tmp_path):
    cfg = tree(tiny_otpose_cfg())
    cfg.TRAIN.LR, cfg.TRAIN.WARMUP = 1e-3, False
    assert cfg.TRAIN.OPTIMIZER == "AdamW"
    ds = PoseTrackDataset(cfg, "train")
    raw, stats = numpy_weights(_init_otpose_impl, JaxSpec.from_cfg(jax_tiny_cfg()))

    def fresh(seed=11):
        _, model = build_model(cfg, device="cpu")
        load_jax_weights(model, raw, stats)
        set_drop_rates(model, attn=0.1, proj=0.1, path=0.1)
        opt = make_optimizer(model, cfg, make_schedule(cfg, 4))
        gen = torch.Generator()
        loader = Loader(ds, 2, shuffle=True, num_workers=2, seed=123, drop_last=True)
        return init_train_state(model, opt), make_train_step(model, opt, generator=gen), gen, \
            loader, seed

    def run(state, step, gen, loader, seed, epochs, tb=0, start=0, should_stop=None):
        for epoch in epochs:
            loader.set_epoch(epoch)
            state, tb, done = train_epoch(step, state, loader, epoch, cfg, seed=seed,
                                          generator=gen, global_steps=tb,
                                          start_iteration=start if epoch == epochs[0] else 0,
                                          should_stop=should_stop)
        return state, tb, done

    # A: two uninterrupted epochs
    ts_a, tb_a, _ = run(*fresh(), epochs=[0, 1])
    assert tb_a == 8 and ts_a.step == 8

    # B: stopped after two iterations of epoch 0, checkpointed asynchronously
    calls = []
    ts_b, tb_b, done = run(*fresh(), epochs=[0],
                           should_stop=lambda: calls.append(1) or len(calls) >= 2)
    assert (tb_b, done, ts_b.step) == (2, 2, 2)
    folder = str(tmp_path / "ck")
    ckpt.save_checkpoint(folder, 0, ts_b, tensorboard_global_steps=tb_b, iteration=done,
                         async_save=True)
    ckpt.wait_for_saves()

    # C: a new state and loader, resumed from the checkpoint
    ts_c, step, gen, loader, seed = fresh()
    ts_c, begin, tb_c, start = ckpt.resume(folder, ts_c)
    assert (begin, tb_c, start, ts_c.step) == (0, 2, 2, 2)
    ts_c, tb_c, _ = run(ts_c, step, gen, loader, seed, epochs=[0, 1], tb=tb_c, start=start)
    assert tb_c == tb_a

    (sd_a, mom_a, n_a), (sd_c, mom_c, n_c) = _snapshot(ts_a), _snapshot(ts_c)
    assert n_a == n_c == 8
    for k, v in sd_a.items():
        assert torch.equal(v, sd_c[k]), k
    assert len(mom_a) == len(mom_c) == len(ts_a.optimizer.params)
    for a, c in zip(mom_a, mom_c):
        assert a.keys() == c.keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k in a:
            assert torch.equal(a[k], c[k]), k

    # the dropout is live: another seed gives another run
    ts_d, tb_d, _ = run(*fresh(seed=12), epochs=[0])
    assert not torch.equal(ts_d.model.state_dict()["final_layer1.weight"],
                           run(*fresh(), epochs=[0])[0].model.state_dict()["final_layer1.weight"])
