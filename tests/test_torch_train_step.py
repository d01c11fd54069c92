"""The port's train step vs the JAX package's on ``tiny_otpose_cfg``, f32.

JAX init's keys and shapes with numpy values, carried to the port by
``jax_bridge``, and one synthetic batch with some joints labelled (a target
peak of 1.0) and some not; the refinement calibrated so that most of the
DCN's samples fall inside the image (tests/helpers/torch_port.py).  Two
models (see ``case``): one with HRNet's final conv scaled, for the forward
cases, and one conditioned for gradients
(``utils/testing.py::condition_for_gradients_``: ReLU inputs away from the
kink), for the gradient and two-step cases.  The parity cases run with the
dropout rates at 0 on both sides: JAX with ``dataclasses.replace(spec,
proj_pdrop=0, path_pdrop=0)`` and the params of the original spec, the port
through ``set_drop_rates``, both keeping the drop-path scales.

- the train-mode 7-tuple to 1e-3 of each output's peak, the BN running
  stats after one forward to 1e-5 of each stat's peak;
- every parameter's gradient against ``jax.value_and_grad`` of the loss run
  in f64: the port's f32 gradients to 1e-3 of each tensor's peak, its f64
  ones to 1e-9;
- two steps of ``make_train_step`` (SGD, lr > 0 from the first step)
  against JAX's run in f64: the metrics to 1e-4, the first step's clipped
  gradients to 1e-3 of each peak, every update to 1e-3 of its peak plus an
  ulp, the running stats to 1e-4;
- ``accum_steps = 2`` against a loop of micro-steps, ``remat`` against no
  remat, ``freeze_hrnet`` (HRNet bit-identical), dropout and drop-path;
- with the rates above 0 a CPU step gives every parameter a gradient;
- an eval step after a train step equals one on a fresh eval model;
- bf16: the port's plain path against the JAX bf16 path, decoded keypoints.
"""

import copy
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.engine.optim import make_optimizer as jax_make_optimizer
from otpose_tpu.engine.optim import make_schedule as jax_make_schedule
from otpose_tpu.engine.trainer import compute_losses as jax_compute_losses
from otpose_tpu.engine.trainer import init_train_state as jax_init_train_state
from otpose_tpu.engine.trainer import make_train_step as jax_make_train_step
from otpose_tpu.models.core import Ctx
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl, otpose_forward as jax_forward
from otpose_tpu.ops.heatmap import get_max_preds_device as jax_max_preds
from otpose_tpu.ops.heatmap import refine_coords_device as jax_refine
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
from otpose_tpu_torch.engine.trainer import (compute_losses, init_train_state,
                                             make_decoded_eval_step, make_train_step)
from otpose_tpu_torch.models import core
from otpose_tpu_torch.models.blocks import set_drop_rates
from otpose_tpu_torch.models.core import BatchNorm, commit_bn_stats
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import jax_layout, load_jax_weights, to_jax
from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp
from otpose_tpu_torch.ops.heatmap import generate_heatmaps
from otpose_tpu_torch.utils.testing import (condition_for_gradients_, loss_gradients,
                                            tiny_otpose_cfg)

from tests.helpers.torch_port import (calibrate_refinement, numpy_weights,  # noqa: F401
                                      one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
METRICS = ("final_loss", "ohkm_loss_s", "mse_loss_s", "occ_final_loss", "pck_acc", "grad_norm")


def _batch(b, seed):
    """Numpy batch: clips, margins and Gaussian targets; joints 0-9 visible
    (labelled: peak 1.0), 10-16 invisible in every clip."""
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
    return {"inputs": rng.randn(b, 64, 64, 15).astype(np.float32),
            "margin": rng.randint(0, 3, (b, 4)).astype(np.float32),
            "target": np.stack(targets).astype(np.float32),
            "target_weight": np.stack(weights).astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_f64(fn, *args):
    """``fn(*args)``, jitted, with x64 on and the JAX package's f32 casts
    (its norm statistics, the DCN's positions) made f64: the exact-arithmetic
    witness.  Arguments are cast to f64, results come back as numpy."""
    with jax.enable_x64(True), mock.patch.object(jnp, "float32", jnp.float64):
        args = jax.tree.map(lambda a: np.asarray(a, np.float64), args)
        return jax.tree.map(np.asarray, jax.jit(fn)(*args))


@pytest.fixture(scope="module")
def case():
    """Two models from one set of numpy weights: ``model`` (HRNet's final
    conv scaled so the losses stay O(1): at O(1) heatmaps the occlusion
    target is ~1e5) for the forward, stats, accumulation, remat, freeze,
    dropout and bf16 cases, and ``steady`` (``condition_for_gradients_``)
    for the gradient and two-step cases, with ``smooth`` its copy whose
    offset convs are zero.  Both have the refinement calibrated."""
    jcfg = jax_tiny_cfg()
    jspec = JaxSpec.from_cfg(jcfg)
    raw, state = numpy_weights(_init_otpose_impl, jspec)
    batch = _batch(2, 0)
    cfg = tiny_otpose_cfg()

    def port(params):
        _, m = build_model(cfg, device="cpu")
        load_jax_weights(m, params, state)
        set_drop_rates(m)
        return m

    params = dict(raw)
    for k in ("weight", "bias"):
        params[f"rough_pose_estimation_net.final_layer.{k}"] *= np.float32(0.05)
    inside = calibrate_refinement(params, state, batch["inputs"], batch["margin"])
    steady_model = port(raw)
    condition_for_gradients_(steady_model, torch.from_numpy(batch["inputs"]),
                             torch.from_numpy(batch["margin"]))
    steady, _ = to_jax(steady_model)
    steady_inside = calibrate_refinement(steady, state, batch["inputs"], batch["margin"])
    smooth = {k: np.zeros_like(v) if k.startswith("offsets_list.") else v
              for k, v in steady.items()}
    return dict(jcfg=jcfg, jspec0=dataclasses.replace(jspec, proj_pdrop=0.0, path_pdrop=0.0),
                cfg=cfg, state=state, batch=batch, params=params, model=port(params),
                inside=inside, steady=steady, steady_model=port(steady),
                steady_inside=steady_inside, smooth=smooth, smooth_model=port(smooth))


@pytest.fixture(scope="module")
def jax_grads(case):
    """JAX's train-mode 7-tuple and new state (f32) of ``model``, and its
    loss, metrics and gradients in f64 for ``smooth`` and ``steady``."""
    jspec0, state, batch = case["jspec0"], case["state"], case["batch"]

    def loss_fn(p, s, b):
        ctx = Ctx(p, s, train=True, compute_dtype=jnp.float64)
        total, (metrics, _) = jax_compute_losses(ctx, b, jspec0)
        return total, metrics

    def forward(p):
        ctx = Ctx(p, state, train=True)
        return jax_forward(ctx, batch["inputs"], batch["margin"], jspec0), ctx.finalize_state()

    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    (loss, metrics), grads = _jax_f64(grad_fn, case["smooth"], state, batch)
    _, grads_steady = _jax_f64(grad_fn, case["steady"], state, batch)
    out, new_state = jax.jit(forward)(case["params"])
    return dict(loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
                grads=grads, grads_steady=grads_steady,
                out=[np.asarray(o) for o in out],
                state={k: np.asarray(v) for k, v in new_state.items()})


def test_train_forward_matches_jax(case, jax_grads):
    assert case["inside"] > 0.5
    model = copy.deepcopy(case["model"]).train()
    with torch.no_grad():
        got = model(torch.from_numpy(case["batch"]["inputs"]),
                    torch.from_numpy(case["batch"]["margin"]))
    assert len(got) == 7
    for g, w in zip(got, jax_grads["out"]):
        peak = np.abs(w).max()
        assert g.shape == w.shape and peak > 0
        np.testing.assert_allclose(g.numpy() / peak, w / peak, rtol=0, atol=1e-3)


def test_running_stats_after_one_forward_match_jax(case, jax_grads):
    model = copy.deepcopy(case["model"]).train()
    with torch.no_grad():
        model(torch.from_numpy(case["batch"]["inputs"]),
              torch.from_numpy(case["batch"]["margin"]))
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert commit_bn_stats(model) == n_bn
    _, state = to_jax(model)
    for k, want in jax_grads["state"].items():
        if "running" in k:
            np.testing.assert_allclose(state[k], want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                       err_msg=k)
            assert not np.array_equal(want, case["state"][k]), k


def _exact_zeros(grads):
    """Names of the gradients that are zero in exact arithmetic: an f64
    peak under 1e-12 of the largest (a conv bias before a batch-statistics
    BN, a bias whose shift the next BN or LayerNorm removes).  Live
    gradients on this model reach down to ~1e-9 of the largest."""
    top = max(np.abs(v).max() for v in grads.values())
    return {n for n, v in grads.items() if np.abs(v).max() <= 1e-12 * top}


def test_every_gradient_matches_jax(case, jax_grads):
    """Every parameter's gradient against ``jax.value_and_grad`` of the loss
    run in f64 (``_jax_f64``), the exact-arithmetic witness:

    - the port in f64 on ``steady`` (offsets at fractional positions):
      every gradient, the offset convs' included, to 1e-9 of
      its peak;
    - the port in f32 on ``smooth`` (offset convs zero, so every DCN
      sample sits on a pixel and no rounding moves one across the bilinear
      derivative's jump, which would move single elements of the offsets'
      gradient by O(1)): every gradient but the offset convs' own to 1e-3
      of its peak.  At integer positions the tent's derivative (JAX's
      central difference) and the bilinear corners' (the port's one-sided
      one) differ by design; the f64 case holds the offset convs.

    Gradients that are zero in exact arithmetic (``_exact_zeros``) are
    held in f32 to 1e-6 of the largest gradient, in f64 to 1e-12.  (JAX's
    own f32 gradient is no witness: on the unconditioned fixture a ReLU
    input within f32 rounding of 0 flips its mask, and JAX's f32 gradients
    were up to 8% of their peak from its f64 ones;
    ``utils/testing.py::condition_for_gradients_``.)"""
    batch = _t(case["batch"])
    assert case["steady_inside"] > 0.5
    loss, metrics, got = loss_gradients(case["smooth_model"], batch)
    assert loss == pytest.approx(jax_grads["loss"], rel=1e-5)
    for k in ("final_loss", "ohkm_loss_s", "mse_loss_s", "occ_final_loss", "pck_acc"):
        assert float(metrics[k].detach()) == pytest.approx(jax_grads["metrics"][k], rel=1e-5,
                                                           abs=1e-7), k
    _, _, exact = loss_gradients(case["steady_model"], batch, torch.float64)
    for port, want, own, floor in ((got, jax_grads["grads"], 1e-3, 1e-6),
                                   (exact, jax_grads["grads_steady"], 1e-9, 1e-12)):
        assert set(port) == set(want)
        zeros = _exact_zeros(want)
        assert 20 <= len(zeros) <= 40, sorted(zeros)
        top = max(np.abs(v).max() for v in want.values())
        for n, g in port.items():
            assert g is not None and torch.isfinite(g).all(), n
            g = jax_layout(n, g)
            if n in zeros:
                assert np.abs(g).max() <= floor * top, n
            elif own == 1e-9 or not n.startswith("offsets_list."):
                peak = np.abs(want[n]).max()
                assert np.abs(g - want[n]).max() <= own * peak, (
                    n, np.abs(g - want[n]).max() / peak)


def test_two_steps_match_jax_make_train_step(case, jax_grads):
    """Two steps of SGD with momentum from ``smooth`` on both sides, lr
    1e-3 from the first step (no warm-up) and no weight decay, so each
    update is the clipped gradients' alone:

    - the metrics of each step to 1e-4;
    - after the first step, SGD's momentum buffer (the clipped gradient)
      against optax's trace, each tensor to 1e-3 of its peak, the offset
      convs' own only for being non-zero: their gradient at integer
      positions differs by design (``test_every_gradient_matches_jax``).
      The second step's buffers are not held so: its gradients are taken
      at parameters rounded to f32 on each side, and the smallest of them
      (the attention key biases', ~1e-7 of the largest) move by percents of
      their own peak under such rounding;
    - each parameter's update after the two steps (after minus before)
      against JAX's to 1e-3 of the update's peak plus one f32 ulp of the
      parameter (each side rounds p + u), and the port moved every tensor
      that JAX moved by more than an ulp;
    - the running stats to 1e-4 of each stat's peak.

    (Adam's update is about lr * sign(g); tests/test_torch_optim.py holds
    the AdamW chain, and the weight-decay coupling, on equal gradients.)"""
    jcfg, cfg = copy.deepcopy(case["jcfg"]), copy.deepcopy(case["cfg"])
    for c in (jcfg, cfg):
        c.TRAIN.OPTIMIZER, c.TRAIN.WD, c.TRAIN.WARMUP = "SGD", 0.0, False
    initial = case["smooth"]

    def jax_steps(params, model_state, batch):
        opt = jax_make_optimizer(params, jcfg, jax_make_schedule(jcfg, 1))
        ts = [jax_init_train_state(params, model_state, opt)]
        step = jax_make_train_step(case["jspec0"], opt, compute_dtype=jnp.float64, donate=False)
        metrics = []
        for i in range(2):
            t, m = step(ts[-1], batch, jax.random.PRNGKey(i))
            ts.append(t)
            metrics.append(m)
        return ts[1:], metrics

    (ts1, ts), jms = _jax_f64(jax_steps, initial, case["state"], case["batch"])
    model = copy.deepcopy(case["smooth_model"])
    assert make_schedule(cfg, 1)(0) > 0
    opt = make_optimizer(model, cfg, make_schedule(cfg, 1))
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, generator=torch.Generator().manual_seed(0))
    zeros = _exact_zeros(jax_grads["grads"])
    for i, jm in enumerate(jms):
        metrics = step(_t(case["batch"]))
        assert set(metrics) == set(METRICS) == set(jm)
        for k in METRICS:
            assert float(metrics[k]) == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-7), (i, k)
        if i:
            continue
        trace = next(s.trace for s in ts1.opt_state if hasattr(s, "trace"))
        top = max(np.abs(v).max() for v in trace.values())
        for n, p in model.named_parameters():
            got, want = jax_layout(n, opt.opt.state[p]["momentum_buffer"]), trace[n]
            if n.startswith("offsets_list."):
                assert np.isfinite(got).all() and np.abs(got).max() > 0, n
            elif n in zeros:
                assert np.abs(got).max() <= 1e-6 * top, n
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max(),
                                           err_msg=n)
    assert state.step == 2
    params, stats = to_jax(model)
    moved = 0
    for k, want in ts.params.items():
        want = want - initial[k]
        got = params[k] - initial[k]
        if k.startswith("offsets_list."):
            assert np.abs(got).max() > 0, k
            continue
        ulp = np.spacing((np.abs(initial[k]) + np.abs(want)).astype(np.float32))
        assert (np.abs(got - want) <= 1e-3 * np.abs(want).max() + ulp).all(), k
        if (np.abs(want) > ulp).any():
            assert np.abs(got).max() > 0, k
            moved += 1
    assert moved >= 100, moved
    for k, want in ts.model_state.items():
        if "running" in k:
            np.testing.assert_allclose(stats[k], want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                       err_msg=k)


def _unclipped(model, cfg):
    """An optimizer that leaves the gradients as they are and the
    parameters where they are (lr 0, no clip)."""
    return make_optimizer(model, cfg, lambda t: 0.0, clip_grad_norm=0.0)


def test_accumulation_equals_a_loop_of_micro_steps(case):
    cfg, batch = case["cfg"], _t(_batch(4, 1))
    model = copy.deepcopy(case["model"])
    metrics = make_train_step(model, _unclipped(model, cfg), accum_steps=2)(batch)
    ref = copy.deepcopy(case["model"]).train()
    sums = {}
    for i in range(2):
        mb = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        total, m, _ = compute_losses(ref, mb)
        (total / 2).backward()
        commit_bn_stats(ref)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v.detach()) / 2
    for k, v in sums.items():
        assert float(metrics[k]) == pytest.approx(v, rel=1e-6, abs=1e-8), k
    for (n, p), (_, q) in zip(model.named_parameters(), ref.named_parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-5, atol=1e-6 * q.grad.abs().max())
    for (n, a), (_, b) in zip(model.named_buffers(), ref.named_buffers()):
        assert torch.equal(a, b), n
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(model, _unclipped(model, cfg), accum_steps=3)(batch)


def test_remat_equals_no_remat(case):
    """Dropout on (the rates of the spec), the same generator seed: remat's
    recomputed forward draws the same masks, so the gradients are equal,
    and the running stats are updated once."""
    cfg, batch = case["cfg"], _t(case["batch"])
    runs = []
    for remat in (False, True):
        model = copy.deepcopy(case["model"])
        set_drop_rates(model, proj=0.1, path=0.1, attn=0.1)
        step = make_train_step(model, _unclipped(model, cfg), remat=remat,
                               generator=torch.Generator().manual_seed(3))
        runs.append((model, step(batch)))
    (m0, r0), (m1, r1) = runs
    for k in METRICS:
        assert float(r0[k]) == pytest.approx(float(r1[k]), rel=1e-6), k
    for (n, p), (_, q) in zip(m0.named_parameters(), m1.named_parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-5, atol=1e-7 * p.grad.abs().max(),
                                   msg=n)
    for (n, a), (_, b) in zip(m0.named_buffers(), m1.named_buffers()):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=n)


def test_freeze_hrnet_keeps_hrnet_bit_identical(case):
    cfg = tiny_otpose_cfg()
    cfg.MODEL.FREEZE_HRNET_WEIGHTS = True
    _, model = build_model(cfg, device="cpu")
    load_jax_weights(model, case["params"], case["state"])
    assert model.spec.freeze_hrnet
    hr = "rough_pose_estimation_net."
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model, cfg, make_schedule(cfg, 1))
    step = make_train_step(model, opt, generator=torch.Generator().manual_seed(1))
    for _ in range(2):
        step(_t(case["batch"]))
    for n, p in model.named_parameters():
        if n.startswith(hr):
            assert p.grad is None, n
    after = model.state_dict()
    for k, v in before.items():
        if k.startswith(hr):
            assert torch.equal(after[k], v), k
    assert not torch.equal(after["final_layer1.weight"], before["final_layer1.weight"])
    assert not torch.equal(after["def_fuse.layers.0.conv_bn_relu1.bn.running_mean"],
                           before["def_fuse.layers.0.conv_bn_relu1.bn.running_mean"])


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_a_binomial_share_scaled_by_one_over_keep(rate):
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(4)
    with core.use_generator(gen):
        y = core.dropout(x, rate, True)
    keep = 1 - rate
    kept = (y != 0).float().mean().item()
    n = x.numel()
    assert abs(kept - keep) <= 5 * (keep * rate / n) ** 0.5
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / keep))
    assert torch.equal(core.dropout(x, rate, False), x)
    assert torch.equal(core.dropout(x, 0.0, True), x)
    with core.use_generator(torch.Generator().manual_seed(4)):
        assert torch.equal(core.dropout(x, rate, True), y)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_drop_path_drops_whole_samples(rate):
    x = torch.ones(4000, 3, 5)
    with core.use_generator(torch.Generator().manual_seed(5)):
        y = core.drop_path(x, rate, True)
    keep = 1 - rate
    per_sample = y.reshape(4000, -1)
    assert bool(((per_sample == 0).all(1) | (per_sample == 1 / keep).all(1)).all())
    kept = (per_sample[:, 0] != 0).float().mean().item()
    assert abs(kept - keep) <= 5 * (keep * rate / 4000) ** 0.5
    assert torch.equal(core.drop_path(x, rate, False), x)
    with core.use_generator(torch.Generator().manual_seed(5)):
        assert torch.equal(core.drop_path(x, rate, True), y)


def test_train_mode_model_is_stochastic_and_eval_mode_is_not(case):
    model = copy.deepcopy(case["model"])
    set_drop_rates(model, proj=0.1, path=0.1)
    x = torch.from_numpy(case["batch"]["inputs"])
    m = torch.from_numpy(case["batch"]["margin"])
    with torch.no_grad():
        model.eval()
        assert torch.equal(model(x, m)[0], model(x, m)[0])
        model.train()
        with core.use_generator(torch.Generator().manual_seed(6)):
            a = model(x, m)[0]
        with core.use_generator(torch.Generator().manual_seed(6)):
            b = model(x, m)[0]
        with core.use_generator(torch.Generator().manual_seed(7)):
            c = model(x, m)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cpu_step_with_dropout_reaches_every_parameter(case):
    """F1's CPU half: with the spec's rates (0.1) in train mode, the blocks
    take the plain path (no fused kernel call) and every parameter gets a
    non-zero gradient, the encoders' and the DCN's included."""
    model = copy.deepcopy(case["model"])
    set_drop_rates(model, proj=0.1, path=0.1)
    calls = (fused_attn.calls, fused_mlp.calls, deform_conv.calls)
    make_train_step(model, _unclipped(model, case["cfg"]),
                    generator=torch.Generator().manual_seed(2))(_t(case["batch"]))
    assert (fused_attn.calls, fused_mlp.calls) == calls[:2]
    assert deform_conv.calls == calls[2] + 1
    for n, p in model.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), n


@pytest.mark.parametrize("flip", [False, True])
def test_eval_step_after_a_train_step_runs_in_eval_mode(case, flip):
    """A train step leaves the model in train mode; an eval step made for
    the same model afterwards still runs on running stats with no dropout
    and records no BN update: its keypoints equal those of a fresh copy in
    eval mode, and the running stats stay as the train step left them."""
    model = copy.deepcopy(case["model"])
    set_drop_rates(model, proj=0.1, path=0.1)
    make_train_step(model, _unclipped(model, case["cfg"]),
                    generator=torch.Generator().manual_seed(2))(_t(case["batch"]))
    assert model.training
    fresh = copy.deepcopy(model).eval()
    stats = {n: b.clone() for n, b in model.named_buffers()}
    x = torch.from_numpy(case["batch"]["inputs"])
    m = torch.from_numpy(case["batch"]["margin"])
    got = make_decoded_eval_step(model, flip=flip)(x, m)
    want = make_decoded_eval_step(fresh, flip=flip)(x, m)
    assert not model.training
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert commit_bn_stats(model) == 0
    for n, b in model.named_buffers():
        assert torch.equal(b, stats[n]), n


def test_bf16_decoded_keypoints_match_jax(case):
    """F4: the port's bf16 plain path against the JAX bf16 path (f32
    weights, bf16 activations; the oracle compiled with
    ``xla_allow_excess_precision`` off, so it rounds where it says it does):
    argmax coords equal where the heatmap's top-two gap exceeds 1e-2 of
    its peak, refined coords where the neighbours' differences do too,
    maxvals to 2e-2 of the peak."""
    jspec = JaxSpec.from_cfg(case["jcfg"])
    x, margin = case["batch"]["inputs"], case["batch"]["margin"]

    def fwd(p, s):
        ctx = Ctx(p, s, train=False, compute_dtype=jnp.bfloat16, fused=False)
        heat = jax_forward(ctx, x, margin, jspec)[0].transpose(0, 3, 1, 2)
        coords, maxvals = jax_refine(heat)
        return coords, maxvals, jax_max_preds(heat)[0], heat

    want = [np.asarray(a, np.float32) for a in jax.jit(
        fwd, compiler_options={"xla_allow_excess_precision": False})(case["params"],
                                                                      case["state"])]
    model = copy.deepcopy(case["model"]).eval()
    got = [a.float().numpy() for a in make_decoded_eval_step(model, compute_dtype="bfloat16")(
        torch.from_numpy(x), torch.from_numpy(margin))]
    heat = want[3]
    peak = np.abs(heat).max()
    top = np.sort(heat.reshape(2, 17, -1), axis=-1)
    clear = (top[..., -1] - top[..., -2]) > 1e-2 * peak
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[2][clear], want[2][clear])
    # the quarter-pixel shift follows the sign of the neighbours' difference:
    # equal where both differences are clear of bf16 noise too
    x, y = want[2][..., 0].astype(int), want[2][..., 1].astype(int)
    b, j = np.indices(x.shape)
    at = lambda yy, xx: heat[b, j, np.clip(yy, 0, 15), np.clip(xx, 0, 15)]  # noqa: E731
    steady = clear & (np.abs(at(y, x + 1) - at(y, x - 1)) > 1e-2 * peak) & (
        np.abs(at(y + 1, x) - at(y - 1, x)) > 1e-2 * peak)
    assert steady.mean() > 0.3
    np.testing.assert_array_equal(got[0][steady], want[0][steady])
    np.testing.assert_allclose(got[1] / peak, want[1] / peak, rtol=0, atol=2e-2)
