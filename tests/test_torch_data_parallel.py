"""The port's data parallelism with two ``gloo`` processes on the CPU.

Each rank is ``tests/helpers/torch_dist_worker.py`` (torch and the port
only, one thread, a free port, killed after 120 s); this process computes
the JAX package's side.  Tiny spec, f32, dropout 0 where JAX is compared.

- **The train step**: two ranks, each on its rows of a global batch of 4,
  two SGD steps, against JAX's ``make_train_step`` on one device on the
  global batch, run in f64 (the bars of ``tests/test_torch_train_step.py``:
  the metrics to 1e-4, every update to 1e-3 of its peak plus an ulp, the
  running stats to 1e-4), and against the port's own step in one process
  (see ``test_two_ranks_equal_the_port_s_one_process_step``), at
  ``accum_steps`` 1 and 2.  The batch's rows label different joints (an
  unlabelled joint keeps weight 1 and a zero target: the teacher-consistency
  case the loss's labelled test exists for) and the model's own peaks are
  hit in some rows and missed in others, so that the ranks' halves, and at
  ``accum_steps`` 2 the ranks' shares of a micro-batch, decide the labelled
  test and the PCK meter differently from the global batch: a rank that
  decided alone would fail the metrics.  The two ranks' weights and BN
  statistics are bit-equal.
- **Decoded evaluation** over ``data/synthetic.py``'s tree, 9 boxes at a
  global batch of 4 (the last batch of 1 runs whole on both ranks): rank 0's
  AP table equals the one-process run's and the JAX package's to 1e-9; the
  mean AP reaches both ranks.
- **The train CLI** with two ranks: rank 0 alone writes the checkpoints, a
  SIGTERM to rank 1 alone stops both ranks after the same step, and a
  two-rank resume ends bit-equal to an uninterrupted two-rank run.
"""

import copy
import dataclasses
import json
import os
import socket
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.data.posetrack import PoseTrackDataset as JaxPoseTrackDataset
from otpose_tpu.engine.optim import make_optimizer as jax_make_optimizer
from otpose_tpu.engine.optim import make_schedule as jax_make_schedule
from otpose_tpu.engine.runner import evaluate_epoch_decoded as jax_evaluate_decoded
from otpose_tpu.engine.trainer import init_train_state as jax_init_train_state
from otpose_tpu.engine.trainer import make_decoded_eval_step as jax_decoded_step
from otpose_tpu.engine.trainer import make_train_step as jax_make_train_step
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.data import make_loader
from otpose_tpu_torch.data.synthetic import ArrayFramesDataset, make_synthetic_posetrack
from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
from otpose_tpu_torch.engine.runner import evaluate_epoch_decoded
from otpose_tpu_torch.engine.trainer import make_decoded_eval_step, make_train_step
from otpose_tpu_torch.models.blocks import set_drop_rates
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import load_jax_weights, to_jax
from otpose_tpu_torch.models.otpose import otpose_forward
from otpose_tpu_torch.ops.heatmap import generate_heatmaps
from otpose_tpu_torch.utils.testing import condition_for_gradients_, tiny_otpose_cfg

from tests.helpers.torch_port import (calibrate_refinement, numpy_weights,  # noqa: F401
                                      one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "helpers", "torch_dist_worker.py")
METRICS = ("final_loss", "ohkm_loss_s", "mse_loss_s", "occ_final_loss", "pck_acc", "grad_norm")
AP_KEYS = ("Head", "Shoulder", "Elbow", "Wrist", "Hip", "Knee", "Ankle", "Mean")
# the joints each row of the global batch labels, and whether the model's
# peak is hit there: the halves and the micro-batch shares all differ
LABELLED = (range(0, 6), range(6, 12), range(12, 17), range(0, 6))
HIT = ({0, 1, 2, 3, 4, 5}, {6, 7, 8}, {12, 13}, set())


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(task: str, spec: dict, path: str, world: int = 2) -> list:
    """Start ``world`` ranks of ``task`` on a free port, ``spec`` written to
    ``path``."""
    with open(path, "w") as fh:
        json.dump(spec, fh)
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    base.update(OMP_NUM_THREADS="1", OTPOSE_COORDINATOR=f"127.0.0.1:{port}",
                OTPOSE_NUM_PROCESSES=str(world))
    return [subprocess.Popen([sys.executable, WORKER, task, path], cwd=REPO,
                             env=dict(base, OTPOSE_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _wait(procs, timeout: int = 120) -> None:
    """Every rank's exit, each within ``timeout`` seconds; on any failure
    every rank is killed and the logs are shown."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0 and "WORKER_OK" in log, log[-4000:]


# ---------------------------------------------------------------- train step

def _jax_f64(fn, *args):
    """``fn(*args)`` jitted with x64 on and the JAX package's f32 casts made
    f64 (as tests/test_torch_train_step.py runs it)."""
    with jax.enable_x64(True), mock.patch.object(jnp, "float32", jnp.float64):
        args = jax.tree.map(lambda a: np.asarray(a, np.float64), args)
        return jax.tree.map(np.asarray, jax.jit(fn)(*args))


def _global_batch(model, inputs, margin):
    """The clips with targets at the model's own train-mode peaks: row r
    labels the joints ``LABELLED[r]`` (a Gaussian at the model's peak where
    ``HIT[r]`` says so, 8 pixels off it elsewhere), every joint weighs 1."""
    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        heat = otpose_forward(probe, torch.from_numpy(inputs), torch.from_numpy(margin))[0]
    flat = heat.permute(0, 3, 1, 2).reshape(4, 17, -1).argmax(-1).numpy()
    peak = np.stack([flat % 16, flat // 16], -1)                     # (B, J, x y)
    targets = []
    for r in range(4):
        joints, vis = np.zeros((17, 3)), np.zeros((17, 3))
        for j in LABELLED[r]:
            px = peak[r, j] if j in HIT[r] else np.clip((peak[r, j] + 8) % 16, 2, 13)
            joints[j, :2] = px * 4              # image pixels: 64 / 16 a heatmap pixel
            vis[j, 0] = 1.0
        t, _ = generate_heatmaps(joints, vis, 2, (64, 64), (16, 16), 17)
        targets.append(t.transpose(1, 2, 0))
    return {"inputs": inputs, "margin": margin, "target": np.stack(targets).astype(np.float32),
            "target_weight": np.ones((4, 17, 1), np.float32)}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The two-rank steps (started first), the JAX f64 steps and the port's
    one-process steps, at ``accum_steps`` 1 and 2, from one set of weights
    conditioned for gradients (tests/test_torch_train_step.py's ``smooth``:
    ReLU inputs off the kink, the refinement calibrated, the offset convs
    zero)."""
    folder = tmp_path_factory.mktemp("torch_dp")
    jspec = JaxSpec.from_cfg(jax_tiny_cfg())
    raw, state = numpy_weights(_init_otpose_impl, jspec, seed=1)
    cfg = tiny_otpose_cfg()
    jcfg = jax_tiny_cfg()
    for c in (jcfg, cfg):
        c.TRAIN.OPTIMIZER, c.TRAIN.WD, c.TRAIN.WARMUP = "SGD", 0.0, False
    _, model = build_model(cfg, device="cpu")
    set_drop_rates(load_jax_weights(model, raw, state))
    rng = np.random.RandomState(2)
    clips = (rng.randn(4, 64, 64, 15).astype(np.float32),
             rng.randint(0, 3, (4, 4)).astype(np.float32))
    condition_for_gradients_(model, *map(torch.from_numpy, clips))
    params, _ = to_jax(model)
    calibrate_refinement(params, state, *clips)
    params = {k: np.zeros_like(v) if k.startswith("offsets_list.") else v
              for k, v in params.items()}
    load_jax_weights(model, params, state)
    batch = _global_batch(model, *clips)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    cfg_path = str(folder / "cfg.yaml")
    with open(cfg_path, "w") as fh:
        fh.write(cfg.dump())
    torch.save({"state_dict": model.state_dict(), "batch": tbatch}, str(folder / "inputs.pt"))
    procs = _launch("steps", {"cfg": cfg_path, "inputs": str(folder / "inputs.pt"),
                              "accum": [1, 2], "out": str(folder / "steps_%d.pt")},
                    str(folder / "steps.json"))

    jspec0 = dataclasses.replace(JaxSpec.from_cfg(jcfg), proj_pdrop=0.0, path_pdrop=0.0)
    want, port = {}, {}
    for accum in (1, 2):
        def jax_steps(p, s, b, accum=accum):
            opt = jax_make_optimizer(p, jcfg, jax_make_schedule(jcfg, 1))
            ts = jax_init_train_state(p, s, opt)
            step = jax_make_train_step(jspec0, opt, compute_dtype=jnp.float64, donate=False,
                                       accum_steps=accum)
            metrics = []
            for i in range(2):
                ts, m = step(ts, b, jax.random.PRNGKey(i))
                metrics.append(m)
            return ts, metrics

        want[accum] = _jax_f64(jax_steps, params, state, batch)
        # the rows in their order and in another order inside each rank's
        # share of each micro-batch: the second run measures the f32 spread
        for order in ([0, 1, 2, 3], [1, 0, 3, 2]):
            own = copy.deepcopy(model)
            step = make_train_step(own, make_optimizer(own, cfg, make_schedule(cfg, 1)),
                                   accum_steps=accum, generator=torch.Generator().manual_seed(0))
            rows = {k: v[order] for k, v in tbatch.items()}
            port.setdefault(accum, []).append(
                ([{k: float(v) for k, v in step(rows).items()} for _ in range(2)],
                 own.state_dict()))
    _wait(procs)
    ranks = [torch.load(str(folder / f"steps_{r}.pt"), weights_only=False) for r in range(2)]
    return dict(params=params, state=state, before=model.state_dict(), want=want, port=port,
                ranks=ranks)


@pytest.mark.parametrize("accum", [1, 2])
def test_each_rank_loads_its_share_of_every_micro_batch(dp, accum):
    rows = [dp["ranks"][r]["results"][accum]["rows"] for r in range(2)]
    assert rows == ([[0, 1], [2, 3]] if accum == 1 else [[0, 2], [1, 3]])
    assert all(dp["ranks"][r]["world"] == 2 for r in range(2))


@pytest.mark.parametrize("accum", [1, 2])
def test_two_ranks_equal_jax_on_the_global_batch(dp, accum):
    """The metrics of both steps to 1e-4, every update after two steps to
    1e-3 of its peak plus an ulp (the offset convs only for moving: their
    gradient at integer positions differs by design), the running stats to
    1e-4 of each stat's peak."""
    ts, jms = dp["want"][accum]
    got = dp["ranks"][0]["results"][accum]
    for i, jm in enumerate(jms):
        for k in METRICS:
            assert got["metrics"][i][k] == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-7), (i, k)
    assert jms[0]["pck_acc"] > 0
    _, model = build_model(tiny_otpose_cfg(), device="cpu")
    model.load_state_dict(got["state"])
    params, stats = to_jax(model)
    initial = dp["params"]
    moved = 0
    for k, want in ts.params.items():
        want, upd = want - initial[k], params[k] - initial[k]
        if k.startswith("offsets_list."):
            assert np.abs(upd).max() > 0, k
            continue
        ulp = np.spacing((np.abs(initial[k]) + np.abs(want)).astype(np.float32))
        assert (np.abs(upd - want) <= 1e-3 * np.abs(want).max() + ulp).all(), k
        moved += bool((np.abs(want) > ulp).any())
    assert moved >= 100, moved
    for k, want in ts.model_state.items():
        if "running" in k:
            np.testing.assert_allclose(stats[k], want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                       err_msg=k)


@pytest.mark.parametrize("accum", [1, 2])
def test_two_ranks_equal_the_port_s_one_process_step(dp, accum):
    """Every metric of both steps, and every update and running stat after
    them, as close to the one-process run's as 1e-5 of its peak or four
    times the distance of the one-process run with its rows reordered
    inside each rank's share, whichever is larger (plus an ulp).  The
    fixture's f32 sums are that sensitive: reordering four rows moves the
    gradient norm and the DCN's offset convs' updates by about 1e-4 of
    their peak (BN's ``E[x^2] - E[x]^2`` cancels on its conditioned
    inputs)."""
    (metrics, sd), (perm_metrics, perm_sd) = dp["port"][accum]
    got = dp["ranks"][0]["results"][accum]
    for i in range(2):
        for k in METRICS:
            spread = abs(perm_metrics[i][k] - metrics[i][k])
            assert abs(got["metrics"][i][k] - metrics[i][k]) <= max(
                1e-5 * abs(metrics[i][k]), 4 * spread) + 1e-8, (i, k)
    eps = torch.finfo(torch.float32).eps
    for k, want in sd.items():
        before = 0 if "running" in k else dp["before"][k]
        ref = want - before
        ulp = eps * (dp["before"][k].abs() + want.abs())

        def dist(t):
            return ((t - before - ref).abs() - ulp).clamp(min=0).max().item()

        assert dist(got["state"][k]) <= max(1e-5 * ref.abs().max().item(),
                                            4 * dist(perm_sd[k])), k


@pytest.mark.parametrize("accum", [1, 2])
def test_ranks_hold_bit_equal_weights_and_bn_statistics(dp, accum):
    a, b = (dp["ranks"][r]["results"][accum] for r in range(2))
    assert a["metrics"] == b["metrics"]
    assert a["state"].keys() == b["state"].keys()
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k
    assert any("running_mean" in k for k in a["state"])


def test_collectives_a_step(dp):
    """One BN all-reduce a layer forward and backward, the loss's two
    labelled tests, the meter, the gradients and the metrics; twice the BN
    and loss share at two micro-batches."""
    one, two = (dp["ranks"][0]["results"][k]["collectives"] for k in (1, 2))
    assert one["host"] == two["host"] == 0
    per_step = one["device"] // 2
    assert one["device"] % 2 == 0 and per_step > 100
    # the gradients and the metrics: two collectives a step at any accum
    assert two["device"] // 2 == 2 * (per_step - 2) + 2


# ---------------------------------------------------------------- evaluation

@pytest.fixture(scope="module")
def evaluation(tmp_path_factory):
    """Rank 0's and rank 1's results of the two-rank decoded evaluation, the
    one-process run's and the JAX package's, over 9 boxes at a global
    batch of 4."""
    root = tmp_path_factory.mktemp("torch_dp_eval")
    json_dir, img_dir, annot_dir = make_synthetic_posetrack(
        str(root), num_videos=1, frames_per_video=3, people_per_frame=3, img_w=96, img_h=96,
        seed=4)
    cfgs = {}
    for name, cfg in (("torch", tiny_otpose_cfg(image_size=64, heatmap_size=16, width0=8)),
                      ("jax", jax_tiny_cfg(image_size=64, heatmap_size=16, width0=8))):
        cfg.DATASET.NAME = "PoseTrack"
        cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR = json_dir, img_dir
        cfg.DATASET.TEST_IMG_DIR = img_dir
        cfg.DATASET.COLOR_RGB = True
        cfg.VAL.ANNOT_DIR = annot_dir
        cfg.VAL.USE_GT_BBOX = True
        cfg.VAL.BATCH_SIZE_PER_GPU = 2
        cfg.WORKERS = 2
        cfg.TPU.DEVICE_PREPROCESS = "off"
        cfgs[name] = cfg
    cfg_path = str(root / "eval.yaml")
    with open(cfg_path, "w") as fh:
        fh.write(cfgs["torch"].dump())
    jspec = JaxSpec.from_cfg(cfgs["jax"])
    params, state = numpy_weights(_init_otpose_impl, jspec, seed=3)
    # the refinement's offsets to a few pixels and its masks to O(1), as
    # tests/test_torch_eval_cli.py scales them
    for k in params:
        if k.endswith(".weight") and k.startswith(("offsets_list", "masks_list")):
            params[k] = params[k] * np.float32(3e-4)
    _, model = build_model(cfgs["torch"], device="cpu")
    load_jax_weights(model, params, state)
    torch.save(model.state_dict(), str(root / "weights.pt"))
    procs = _launch("evaluate", {"cfg": cfg_path, "weights": str(root / "weights.pt"),
                                 "output_dir": str(root / "two_ranks"),
                                 "out": str(root / "eval_%d.json")}, str(root / "eval.json"))

    ds = ArrayFramesDataset(cfgs["torch"], "validate")
    loader = make_loader(cfgs["torch"], ds, 4, shuffle=False, device="cpu")
    one = evaluate_epoch_decoded(make_decoded_eval_step(model), loader, ds, cfgs["torch"],
                                 str(root / "one_rank"), device="cpu")
    numpy_batches = [({k: np.asarray(v) for k, v in b.items()}, m) for b, m in loader]
    jax_ds = JaxPoseTrackDataset(cfgs["jax"], "validate")
    jax_result = jax_evaluate_decoded(jax_decoded_step(jspec), params, state, numpy_batches,
                                      jax_ds, cfgs["jax"], str(root / "jax"))
    _wait(procs)
    ranks = []
    for r in range(2):
        with open(str(root / f"eval_{r}.json")) as fh:
            ranks.append(json.load(fh))
    return dict(ranks=ranks, one=one, jax=jax_result,
                batches=[len(b["inputs"]) for b, _ in numpy_batches])


def _table(name_values):
    return np.asarray([name_values[k] for k in AP_KEYS], np.float64)


def test_rank0_table_equals_one_process_and_jax(evaluation):
    assert evaluation["batches"] == [4, 4, 1]
    got = _table(evaluation["ranks"][0]["name_values"])
    for want in (evaluation["one"], evaluation["jax"]):
        np.testing.assert_allclose(got, _table(want[0]), rtol=0, atol=1e-9, equal_nan=True)
        assert evaluation["ranks"][0]["mean_ap"] == pytest.approx(want[1], abs=1e-9)
    finite = got[np.isfinite(got)]
    assert finite.size > 0 and finite.min() < 99.0, got


def test_mean_ap_reaches_every_rank(evaluation):
    r0, r1 = evaluation["ranks"]
    assert r1["name_values"] == {} and r1["rank"] == 1
    assert r1["mean_ap"] == r0["mean_ap"] is not None


# ---------------------------------------------------------------- train CLI

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Three two-rank runs of the train CLI (the tiny spec, a global batch
    of 4, one epoch of 4 steps with validation): uninterrupted, one in which
    rank 1 alone sends itself SIGTERM after 2 steps, and the resume of the
    latter.  The first two run at once."""
    root = tmp_path_factory.mktemp("torch_dp_cli")
    json_dir, img_dir, annot_dir = make_synthetic_posetrack(
        str(root), num_videos=1, frames_per_video=8, people_per_frame=2, img_w=96, img_h=96,
        seed=5)

    def spec(name, tag, **kw):
        cfg = tiny_otpose_cfg(image_size=32, heatmap_size=8)
        cfg.EXPERIMENT_NAME = name
        cfg.OUTPUT_DIR = str(root / "output")
        cfg.DATASET.NAME = "PoseTrack"
        cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR = json_dir, img_dir
        cfg.DATASET.TEST_IMG_DIR = img_dir
        cfg.DATASET.COLOR_RGB = True
        cfg.MODEL.PRETRAINED = ""
        cfg.VAL.ANNOT_DIR = annot_dir
        cfg.VAL.USE_GT_BBOX = True
        cfg.VAL.BATCH_SIZE_PER_GPU = 2
        cfg.TRAIN.BATCH_SIZE_PER_GPU = 2
        cfg.TRAIN.END_EPOCH = 1
        cfg.TRAIN.SAVE_MODEL_PER_EPOCH = 1
        cfg.TRAIN.PROB_HALF_BODY = 0.0
        cfg.TRAIN.WARMUP = False
        cfg.WORKERS = 2
        cfg.PRINT_FREQ = 1
        cfg.TPU.COMPUTE_DTYPE = "float32"
        path = str(root / f"{tag}.yaml")
        with open(path, "w") as fh:
            fh.write(cfg.dump())
        return dict(cfg=path, root=str(root), out=str(root / f"{tag}_%d.pt"), **kw)

    def launch(tag, spec):
        return _launch("train_cli", spec, str(root / f"{tag}.json"))

    first = [launch("whole", spec("whole", "whole")),
             launch("preempted", spec("preempted", "preempted", sigterm_rank=1,
                                      sigterm_after=2))]
    for procs in first:
        _wait(procs)
    _wait(launch("resumed", spec("preempted", "resumed")))
    return {tag: [torch.load(str(root / f"{tag}_{r}.pt"), weights_only=False)
                  for r in range(2)] for tag in ("whole", "preempted", "resumed")}


def test_rank0_alone_writes_the_checkpoints(cli_runs):
    whole = cli_runs["whole"]
    files = whole[0]["files"]
    assert files == whole[1]["files"]
    assert "epoch_0_state" in files and not any(f.startswith(".") for f in files)
    best = [f for f in files if f.startswith("best_mAP_")]
    assert len(best) == 1
    assert sorted(whole[0]["writes"]) == sorted(["epoch_0_state"] + best)
    assert whole[1]["writes"] == []
    assert len(whole[0]["losses"]) == len(whole[1]["losses"]) == 4
    assert whole[0]["losses"] == whole[1]["losses"]


def test_sigterm_to_one_rank_stops_both_at_the_same_iteration(cli_runs):
    pre = cli_runs["preempted"]
    assert len(pre[0]["losses"]) == len(pre[1]["losses"]) == 2
    assert pre[0]["files"] == pre[1]["files"] == ["epoch_0_state"]
    assert pre[0]["writes"] == ["epoch_0_state"] and pre[1]["writes"] == []


def test_two_rank_resume_is_bit_equal_to_the_uninterrupted_run(cli_runs):
    whole, pre, res = (cli_runs[k] for k in ("whole", "preempted", "resumed"))
    for r in range(2):
        assert pre[r]["losses"] + res[r]["losses"] == whole[r]["losses"]
        assert res[r]["count"] == whole[r]["count"] == 4
        for k, v in whole[r]["state_dict"].items():
            assert torch.equal(v, res[r]["state_dict"][k]), (r, k)
        for a, b in zip(whole[r]["moments"], res[r]["moments"]):
            for k in a:
                assert torch.equal(a[k], b[k]), (r, k)
    for k, v in whole[0]["state_dict"].items():
        assert torch.equal(v, whole[1]["state_dict"][k]), k
    assert res[0]["files"] == whole[0]["files"]
