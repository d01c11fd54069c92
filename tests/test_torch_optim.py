"""The port's optimizer and LR schedules vs the JAX package's optax chain.

- ``classify_param`` over every name of the port's tiny ``OTPose`` equals
  the JAX package's (and the names are the JAX param keys);
- the schedules of ``make_schedule`` over 50 steps, to 1e-7 of the base lr;
- a 6-step parameter trajectory (warm-up into cosine) for AdamW and SGD,
  with and without ``FREEZE_HRNET_WEIGHTS``, fed the same gradient sequence
  on both sides: every parameter to 1e-6 of its peak, frozen HRNet params
  bit-identical, and the returned norm equal to ``optax.global_norm``;
- ``ModelEma``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from otpose_tpu.config import get_cfg as jax_get_cfg
from otpose_tpu.engine import optim as joptim
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.config import get_cfg
from otpose_tpu_torch.engine import optim
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import from_jax, load_jax_weights, to_jax
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import numpy_weights, one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def weights():
    return numpy_weights(_init_otpose_impl, JaxSpec.from_cfg(jax_tiny_cfg()))


def _model(params, state):
    _, model = build_model(tiny_otpose_cfg(), device="cpu")
    return load_jax_weights(model, params, state)


def _bag(params):
    """A module whose ``named_parameters()`` are ``params`` (JAX layout
    numpy, dotted names) in the port's layouts."""
    root = torch.nn.Module()
    for name, t in from_jax(params, {}).items():
        *path, leaf = name.split(".")
        m = root
        for part in path:
            if not hasattr(m, part):
                m.add_module(part, torch.nn.Module())
            m = getattr(m, part)
        m.register_parameter(leaf, torch.nn.Parameter(t))
    return root


def _subset(params):
    """Up to three params of each (group, layout): conv kernels, conv1d
    kernels, channel-LN and drop-path vectors, biases, BN weights, in HRNet
    and elsewhere."""
    picked, seen = {}, {}
    for name in sorted(params):
        key = (optim.classify_param(name), params[name].ndim, name.split(".")[-1])
        if seen.get(key, 0) < 3:
            seen[key] = seen.get(key, 0) + 1
            picked[name] = params[name]
    return picked


def _cfg(getter, optimizer="AdamW", freeze=False, warmup=True, scheduler="CosineAnnealingLR"):
    cfg = getter()
    cfg.TRAIN.LR, cfg.TRAIN.WD, cfg.TRAIN.OPTIMIZER = 1e-3, 0.05, optimizer
    cfg.TRAIN.WARMUP, cfg.TRAIN.WARMUP_EPOCHS, cfg.TRAIN.END_EPOCH = warmup, 1, 3
    cfg.TRAIN.EPOCHS, cfg.TRAIN.LR_SCHEDULER, cfg.TRAIN.GAMMA = 4, scheduler, 0.9
    cfg.TRAIN.MOMENTUM = 0.9
    cfg.MODEL.FREEZE_HRNET_WEIGHTS = freeze
    return cfg


def test_classify_param_matches_jax_over_every_parameter(weights):
    params, state = weights
    names = [n for n, _ in _model(params, state).named_parameters()]
    assert sorted(names) == sorted(params)
    groups = {optim.classify_param(n) for n in names}
    assert groups == {"decay", "no_decay", "pretrained"}
    for n in names:
        assert optim.classify_param(n) == joptim.classify_param(n), n


@pytest.mark.parametrize("warmup", [True, False])
@pytest.mark.parametrize("scheduler", ["CosineAnnealingLR", "MultiStepLR"])
def test_schedules_match_jax(warmup, scheduler):
    cfg = _cfg(get_cfg, warmup=warmup, scheduler=scheduler)
    jcfg = _cfg(jax_get_cfg, warmup=warmup, scheduler=scheduler)
    port, ref = optim.make_schedule(cfg, 3), joptim.make_schedule(jcfg, 3)
    got = np.array([port(t) for t in range(50)])
    want = np.array([float(ref(t)) for t in range(50)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 * cfg.TRAIN.LR)
    assert got.max() > 0


@pytest.mark.parametrize("freeze", [False, True])
@pytest.mark.parametrize("optimizer", ["AdamW", "SGD"])
def test_trajectory_matches_the_optax_chain(weights, optimizer, freeze):
    params = _subset(weights[0])
    model = _bag(params)
    cfg = _cfg(get_cfg, optimizer, freeze)
    jcfg = _cfg(jax_get_cfg, optimizer, freeze)
    opt = optim.make_optimizer(model, cfg, optim.make_schedule(cfg, 3))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = joptim.make_optimizer(jparams, jcfg, joptim.make_schedule(jcfg, 3))
    jstate = jopt.init(jparams)
    jupdate = jax.jit(lambda g, st, p: jopt.update(g, st, p))
    hrnet0 = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith("rough_pose_estimation_net.")}
    for step in range(6):
        rng = np.random.RandomState(100 + step)
        jgrads = {k: (rng.randn(*v.shape) * 0.05).astype(np.float32) for k, v in params.items()}
        tgrads = from_jax(jgrads, {})
        for n, p in model.named_parameters():
            p.grad = tgrads[n].clone()
        norm = opt.step()
        updates, jstate = jupdate({k: jnp.asarray(v) for k, v in jgrads.items()}, jstate,
                                  jparams)
        jparams = optax.apply_updates(jparams, updates)
        assert float(norm) == pytest.approx(float(optax.global_norm(jgrads)), rel=1e-6)
        got, _ = to_jax(model)
        for k, want in jparams.items():
            want = np.asarray(want)
            scale = np.abs(want).max()
            np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-6 * scale,
                                       err_msg=f"step {step} {k}")
    assert opt.count == 6
    for n, p in model.named_parameters():
        if n in hrnet0:
            assert torch.equal(p, hrnet0[n]) == freeze, n


def test_global_norm_clip_scales_only_above_the_limit(weights):
    """optax's clip: the gradients are multiplied by 1 / norm only when the
    norm exceeds 1.0 (``clip_grad_norm_`` would use 1 / (norm + 1e-6)),
    and left as they are below it."""
    model = _bag(_subset(weights[0]))
    cfg = _cfg(get_cfg, "SGD")
    opt = optim.make_optimizer(model, cfg, lambda t: 0.0)
    for scale in (1e-4, 10.0):
        grads = {n: torch.full_like(p, scale) for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        norm = float(opt.step())
        want = math.sqrt(sum(g.numel() for g in grads.values())) * scale
        assert norm == pytest.approx(want, rel=1e-4)     # an f32 sum of squares
        for n, p in model.named_parameters():
            if norm < 1.0:
                assert torch.equal(p.grad, grads[n])
            else:
                torch.testing.assert_close(p.grad, grads[n] * (1.0 / norm), rtol=1e-6, atol=0)


def test_model_ema_matches_jax(weights):
    params, state = weights
    model = _model(params, state)
    ema = optim.ModelEma(model, decay=0.9)
    jema = joptim.ModelEma({k: jnp.asarray(v) for k, v in params.items()}, decay=0.9)
    for step in range(2):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.1 * (step + 1))
        ema.update(model)
        jema.update({k: jnp.asarray(v) for k, v in to_jax(model)[0].items()})
    got = to_jax(type("M", (), {"named_parameters": lambda self: iter(ema.params.items()),
                                "named_buffers": lambda self: iter(())})())[0]
    for k, want in jema.params.items():
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=1e-6, atol=1e-7)


def test_unknown_optimizer_and_scheduler_raise(weights):
    params, state = weights
    model = _model(params, state)
    cfg = _cfg(get_cfg, "RMSprop")
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        optim.make_optimizer(model, cfg, lambda t: 1.0)
    cfg = _cfg(get_cfg, scheduler="Plateau")
    with pytest.raises(ValueError, match="Unsupported scheduler"):
        optim.make_schedule(cfg, 3)
