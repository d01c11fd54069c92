"""The port's sequence-parallel train step with four ``gloo`` processes on the
CPU, and three more at once (tests/helpers/torch_dist_worker.py
``seq_train``; this process computes the references meanwhile).  Tiny
spec, f32, SGD, the weights of ``tests/test_torch_data_parallel.py``
conditioned for gradients, dropout
on at 0.1 at every site (the attention weights, the projections and the
MLP, drop-path).

- ``data = 2 x seq = 2``: one step against the same ranks' step without
  the ``seq`` axis (the data-parallel step of two data groups, whose dropout
  masks are the same, since the sequence-parallel masks are drawn whole and
  sliced);
- ``data = 1 x seq = 4`` with ``accum_steps`` 2 and ``remat``: one step
  against the port's one-process step on the global batch with the same
  generator seed;
- ``data = 1 x seq = 3`` (T = 256 in slices of 86, 86 and 84 tokens): one
  step against the one-process step with the same seed, the dropout masks
  the one-rank masks sliced unevenly;

each with every BN running statistic to 1e-5 of its peak, every update
(an ulp of the weights allowed) and every (clipped) gradient to 1e-4 of its
tensor's peak and the metrics to 1e-4; the ranks of a seq group end
bit-equal, and the collectives a step are counted.  The gradients' bar is
f32's on this fixture: the channel attention's scores are sums over T of
O(1) products, so the other summation order moves them by about 1e-5 in
absolute terms, which the softmax passes on as a relative change (the
encoders' and, through them, HRNet's gradients move by up to 6e-5 of their
peak); a fault of the sharding (a halo's gradient not returned, the
encoders' gradients not summed, a mask sliced at the wrong place) moves
the gradients it touches by 1e-2 of their peak or more.

Then the train CLI at ``data 2 x seq 2`` over ``data/synthetic.py``'s tree
(one epoch of 4 steps at a global batch of 4, validation included): rank 0
alone writes, and every rank's losses and final weights are the same bits.
A JAX oracle, marked slow as ``tests/test_trainer.py``'s sequence-parallel
train step is, holds the ``2 x 2`` step with dropout off to JAX's
one-device step run in f64.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.engine.optim import make_optimizer as jax_make_optimizer
from otpose_tpu.engine.optim import make_schedule as jax_make_schedule
from otpose_tpu.engine.trainer import init_train_state as jax_init_train_state
from otpose_tpu.engine.trainer import make_train_step as jax_make_train_step
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.data.synthetic import make_synthetic_posetrack
from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
from otpose_tpu_torch.engine.trainer import make_train_step
from otpose_tpu_torch.models.blocks import set_drop_rates
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import load_jax_weights, to_jax
from otpose_tpu_torch.utils.testing import condition_for_gradients_, tiny_otpose_cfg

from tests.helpers.torch_port import (calibrate_refinement, numpy_weights,  # noqa: F401
                                      one_torch_thread)
from tests.test_torch_data_parallel import METRICS, _global_batch, _jax_f64, _launch, _wait

pytestmark = pytest.mark.usefixtures("one_torch_thread")
DROP = 0.1
SEED = 5
CASES = ({"layout": [2, 2], "accum": 1, "no_seq": True},
         {"layout": [1, 4], "accum": 2, "remat": True})
# T = 256 over three seq ranks: slices of 86, 86 and 84 tokens (43, 43, 42
# after the branch), every dropout mask the one-rank mask sliced unevenly
UNEVEN = {"layout": [1, 3], "accum": 1}


def _weights(folder):
    """The data-parallel tests' conditioned weights, the global batch of 4
    and the config, saved for the workers."""
    jspec = JaxSpec.from_cfg(jax_tiny_cfg())
    raw, state = numpy_weights(_init_otpose_impl, jspec, seed=1)
    cfg = tiny_otpose_cfg()
    cfg.TRAIN.OPTIMIZER, cfg.TRAIN.WD, cfg.TRAIN.WARMUP = "SGD", 0.0, False
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
    cfg_path = str(folder / "cfg.yaml")
    with open(cfg_path, "w") as fh:
        fh.write(cfg.dump())
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    torch.save({"state_dict": model.state_dict(), "batch": tbatch}, str(folder / "inputs.pt"))
    return cfg, cfg_path, model, params, state, batch, tbatch


def _train_cli_spec(folder) -> dict:
    """The train CLI's yaml on a ``data 2 x seq 2`` mesh (tiny spec at 32 x
    32, a global batch of 4) over a synthetic tree of 16 boxes."""
    json_dir, img_dir, annot_dir = make_synthetic_posetrack(
        str(folder / "tree"), num_videos=1, frames_per_video=8, people_per_frame=2,
        img_w=96, img_h=96, seed=5)
    cfg = tiny_otpose_cfg(image_size=32, heatmap_size=8)
    cfg.EXPERIMENT_NAME, cfg.OUTPUT_DIR = "cli", str(folder / "output")
    cfg.DATASET.NAME = "PoseTrack"
    cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR = json_dir, img_dir
    cfg.DATASET.TEST_IMG_DIR = img_dir
    cfg.DATASET.COLOR_RGB = True
    cfg.MODEL.PRETRAINED = ""
    cfg.VAL.ANNOT_DIR = annot_dir
    cfg.VAL.USE_GT_BBOX = True
    cfg.VAL.BATCH_SIZE_PER_GPU = 1
    cfg.TRAIN.BATCH_SIZE_PER_GPU = 1
    cfg.TRAIN.END_EPOCH = 1
    cfg.TRAIN.SAVE_MODEL_PER_EPOCH = 1
    cfg.TRAIN.PROB_HALF_BODY = 0.0
    cfg.TRAIN.WARMUP = False
    cfg.WORKERS = 1
    cfg.PRINT_FREQ = 1
    cfg.TPU.MESH_AXES, cfg.TPU.MESH_SHAPE = ["data", "seq"], [2, 2]
    path = folder / "cli.yaml"
    path.write_text(cfg.dump())
    return dict(cfg=str(path), root=str(folder), out=str(folder / "cli_%d.pt"))


def _run(folder, cfg_path, drop, cases, tag, cli=None, world=4):
    spec = {"cfg": cfg_path, "inputs": str(folder / "inputs.pt"), "drop": drop, "seed": SEED,
            "cases": list(cases), "out": str(folder / f"{tag}_%d.pt")}
    if cli is not None:
        spec["cli"] = cli
    return _launch("seq_train", spec, str(folder / f"{tag}.json"), world=world)


def _load(folder, tag, world=4):
    return [torch.load(str(folder / f"{tag}_{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    folder = tmp_path_factory.mktemp("torch_sp_train")
    cfg, cfg_path, model, _, _, _, tbatch = _weights(folder)
    procs = _run(folder, cfg_path, DROP, CASES, "seq_train", _train_cli_spec(folder))
    uneven = _run(folder, cfg_path, DROP, [UNEVEN], "seq_train_uneven", world=3)
    # the port's one-process step on the global batch, for the 1 x 4 case
    # with dropout and without, and for the 1 x 3 case
    one = {}
    for name, drop, accum in (("drop", DROP, CASES[1]["accum"]),
                              ("no_drop", 0.0, CASES[1]["accum"]),
                              ("uneven", DROP, UNEVEN["accum"])):
        own = set_drop_rates(copy.deepcopy(model), attn=drop, proj=drop, path=drop)
        step = make_train_step(own, make_optimizer(own, cfg, make_schedule(cfg, 1)),
                               accum_steps=accum,
                               generator=torch.Generator().manual_seed(SEED))
        one[name] = dict(metrics={k: float(v) for k, v in step(tbatch).items()},
                         state=own.state_dict(),
                         grads={k: p.grad for k, p in own.named_parameters()
                                if p.grad is not None})
    _wait(procs, timeout=300)
    _wait(uneven, timeout=300)
    return dict(model=model, before=model.state_dict(), one=one,
                ranks=_load(folder, "seq_train"), cli=_load(folder, "cli"),
                uneven=_load(folder, "seq_train_uneven", world=3))


def _assert_step_equal(got, want, before):
    """Metrics to 1e-4; every update (the change a step made) to 1e-4 of its
    peak and every running statistic to 1e-5 of its peak, an ulp of the
    values allowed; every gradient to 1e-4 of its peak, or 1e-6 of the
    largest gradient's peak where a gradient is zero but for rounding (a
    conv's bias before a BN)."""
    for k in METRICS:
        assert got["metrics"][k] == pytest.approx(want["metrics"][k], rel=1e-4, abs=1e-8), k
    assert got["grads"].keys() == want["grads"].keys()
    floor = 1e-6 * max(float(g.abs().max()) for g in want["grads"].values())
    for k, g in want["grads"].items():
        atol = max(1e-4 * float(g.abs().max()), floor)
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(), rtol=0, atol=atol,
                                   err_msg=k)
    eps = torch.finfo(torch.float32).eps
    moved = 0
    for k, w in want["state"].items():
        base = torch.zeros_like(w) if "running" in k else before[k]
        ref, upd = w - base, got["state"][k] - base
        ulp = eps * (before[k].abs() + w.abs())
        dist = ((upd - ref).abs() - ulp).clamp(min=0).max().item()
        bar = 1e-5 if "running" in k else 1e-4
        assert dist <= bar * ref.abs().max().item(), (k, dist, ref.abs().max().item())
        moved += bool((ref.abs() > ulp).any()) and "running" not in k
    assert moved >= 50, moved          # updates above an ulp: the comparison bites


def test_seq_step_equals_the_data_parallel_step_with_the_same_masks(sp):
    for r in range(4):
        res = sp["ranks"][r]["results"][0]
        assert res["case"]["layout"] == [2, 2] and res["data"] == (r // 2, 2)
        assert res["rows"] == ([0, 1] if r < 2 else [2, 3])
        _assert_step_equal(res["sp"], res["no_seq"], sp["before"])


def test_seq_step_with_accumulation_and_remat_equals_the_one_process_step(sp):
    for r in range(4):
        res = sp["ranks"][r]["results"][1]
        assert res["rows"] == [0, 1, 2, 3] and res["data"] == (0, 1)
        _assert_step_equal(res["sp"], sp["one"]["drop"], sp["before"])


def test_the_masks_move_the_step(sp):
    """The dropout the sequence-parallel step matches is live: without it
    the encoders' updates differ by percents of their peak."""
    got = sp["ranks"][0]["results"][1]["sp"]["state"]
    off = sp["one"]["no_drop"]["state"]
    for k in ("temporal_encoder1.stem.0.mlp.0.weight", "flow_encoder.stem.1.attn.proj.weight"):
        ref = off[k] - sp["before"][k]
        assert (got[k] - off[k]).abs().max() > 1e-2 * ref.abs().max(), k


def _collectives_a_step(spec) -> tuple:
    """(forward, backward) seq collectives of a micro-batch."""
    encoders = (spec.flow_scale_arch, spec.scale_arch, spec.scale_arch)
    fwd = sum(3 * a[1] + 4 * a[2] + 1 + a[2] for a in encoders)
    return fwd, fwd - sum(1 + a[2] for a in encoders) + len(encoders)


def test_uneven_seq_step_equals_the_one_process_step(sp):
    """``1 x 3``: unequal slices, dropout on at every site; each rank's step
    against the one-process step on the global batch with the same
    generator seed, as the ``1 x 4`` step is held; the ranks end bit-equal
    and the step runs as many seq collectives as on equal slices."""
    fwd, bwd = _collectives_a_step(sp["model"].spec)
    ref = sp["uneven"][0]["results"][0]["sp"]
    for r in range(3):
        res = sp["uneven"][r]["results"][0]
        assert res["case"]["layout"] == [1, 3] and res["data"] == (0, 1)
        assert res["rows"] == [0, 1, 2, 3]
        _assert_step_equal(res["sp"], sp["one"]["uneven"], sp["before"])
        assert res["sp"]["collectives"]["seq"] == fwd + bwd + 1
        assert res["sp"]["metrics"] == ref["metrics"]
        for k, v in ref["state"].items():
            assert torch.equal(v, res["sp"]["state"][k]), (r, k)


@pytest.mark.parametrize("case", [0, 1])
def test_a_seq_group_ends_bit_equal(sp, case):
    for d in range(4 // CASES[case]["layout"][1]):
        s = CASES[case]["layout"][1]
        ref = sp["ranks"][d * s]["results"][case]["sp"]
        for r in range(d * s + 1, (d + 1) * s):
            got = sp["ranks"][r]["results"][case]["sp"]
            assert got["metrics"] == ref["metrics"]
            for k, v in ref["state"].items():
                assert torch.equal(v, got["state"][k]), (r, k)


def test_collectives_a_step(sp):
    """A forward's seq collectives (a stem block's halo, score sum and
    scramble, a branch block's and its skip's halo, a gather an encoder
    output), their backward (a gather's is local, a shard's gathers), and
    one sum of the encoders' gradients; the data group's as the
    data-parallel step's."""
    fwd, bwd = _collectives_a_step(sp["model"].spec)
    res = sp["ranks"][0]["results"][0]
    assert res["sp"]["collectives"]["seq"] == fwd + bwd + 1
    assert res["no_seq"]["collectives"]["seq"] == 0
    assert res["sp"]["collectives"]["device"] == res["no_seq"]["collectives"]["device"]
    assert res["sp"]["collectives"]["host"] == 0


def test_train_cli_on_a_seq_mesh(sp):
    runs = sp["cli"]
    files = runs[0]["files"]
    assert "epoch_0_state" in files and any(f.startswith("best_mAP_") for f in files)
    assert sorted(runs[0]["writes"]) == sorted(f for f in files if not f.startswith("."))
    assert [r["seq"] for r in runs] == [(0, 2), (1, 2), (0, 2), (1, 2)]
    assert len(runs[0]["losses"]) == runs[0]["count"] == 4
    assert all(np.isfinite(runs[0]["losses"]))
    for r in runs[1:]:
        assert r["writes"] == [] and r["losses"] == runs[0]["losses"]
        for k, v in runs[0]["state_dict"].items():
            assert torch.equal(v, r["state_dict"][k]), (r["rank"], k)


@pytest.mark.slow
def test_seq_step_equals_jax_on_the_global_batch(tmp_path):
    """Dropout off: the ``2 x 2`` step against JAX's one-device step in f64
    with the data-parallel tests' bars (metrics to 1e-4, every update to
    1e-3 of its peak plus an ulp, the offset convs only for moving, the
    running stats to 1e-4), as ``tests/test_trainer.py`` holds JAX's own
    sequence-parallel step to its one-device step."""
    cfg, cfg_path, model, params, state, batch, _ = _weights(tmp_path)
    procs = _run(tmp_path, cfg_path, 0.0, [{"layout": [2, 2], "accum": 1}], "oracle")
    jcfg = jax_tiny_cfg()
    jcfg.TRAIN.OPTIMIZER, jcfg.TRAIN.WD, jcfg.TRAIN.WARMUP = "SGD", 0.0, False
    jspec = dataclasses.replace(JaxSpec.from_cfg(jcfg), proj_pdrop=0.0, path_pdrop=0.0)

    def jax_step(p, s, b):
        opt = jax_make_optimizer(p, jcfg, jax_make_schedule(jcfg, 1))
        step = jax_make_train_step(jspec, opt, compute_dtype=jnp.float64, donate=False)
        return step(jax_init_train_state(p, s, opt), b, jax.random.PRNGKey(0))

    ts, jm = _jax_f64(jax_step, params, state, batch)
    _wait(procs, timeout=300)
    got = _load(tmp_path, "oracle")[0]["results"][0]["sp"]
    for k in METRICS:
        assert got["metrics"][k] == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-7), k
    _, port = build_model(cfg, device="cpu")
    port.load_state_dict(got["state"])
    new, stats = to_jax(port)
    for k, want in ts.params.items():
        want, upd = want - params[k], new[k] - params[k]
        if k.startswith("offsets_list."):
            assert np.abs(upd).max() > 0, k
            continue
        ulp = np.spacing((np.abs(params[k]) + np.abs(want)).astype(np.float32))
        assert (np.abs(upd - want) <= 1e-3 * np.abs(want).max() + ulp).all(), k
    for k, want in ts.model_state.items():
        if "running" in k:
            np.testing.assert_allclose(stats[k], want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                       err_msg=k)
