"""The fused MLP under autograd (``tools/exp_fused_train_mlp.py``'s
``FusedMlpBlock``) against the JAX tool's ``custom_vjp``.

The JAX side is rebuilt here from ``tools/exp_fused_train_mlp.py:90-102``:
the forward is ``ops/pallas/fused_mlp.py::fused_mlp_residual_ct`` in
interpret mode, the backward the VJP of the recomputed plain block (LN, two
1x1 products, erf GELU, residual).  The same numpy draws go to both
(``make_inputs``, the JAX tool's order); f32 on the CPU, where the port's op
runs its plain version.  A chain of three blocks, loss ``sum(x)``: the loss
and every gradient (input and each block's six weights) to 1e-5 of the
peak; on one block the fused arm's gradients equal the plain arm's (the
same recompute); the Function gives None for inputs that need no gradient;
the timing loop's result shape on a small case.  Beside it, the other timing
tool ported with it, ``tools/time_train_step``, runs its modes on the CPU
(tiny config): the step, the forward-only mode and the dropout A/B.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.models import core as jax_core
from otpose_tpu.ops.pallas.fused_mlp import fused_mlp_residual_ct as pallas_mlp
from otpose_tpu_torch.tools import exp_fused_train_mlp as k2
from otpose_tpu_torch.tools import time_train_step
from otpose_tpu_torch.utils import profiling

B, C, T, BLOCKS = 2, 8, 64, 3


def _jax_params(params):
    out = []
    for p in params:
        q = {k: jnp.asarray(v.detach().numpy()) for k, v in p.items()}
        for k in ("w1", "w2"):                     # (C_out, C_in, 1) -> (1, C_in, C_out)
            q[k] = q[k][:, :, 0].T[None]
        out.append(q)
    return out


def _jax_value_and_grad(x, params):
    def dense_ct(h, w, b):
        y = jnp.einsum("bct,cd->bdt", h, w[0].astype(h.dtype),
                       precision=jax_core._mxu_precision(h.dtype),
                       preferred_element_type=jax_core._preferred(h.dtype))
        return y + b.astype(y.dtype)[:, None]

    def plain(h, p):
        z = jax_core.layer_norm_ct(h, p["ln_w"], p["ln_b"])
        z = jax_core.gelu(dense_ct(z, p["w1"], p["b1"]))
        return h + dense_ct(z, p["w2"], p["b2"])

    @jax.custom_vjp
    def fused(h, p):
        return pallas_mlp(h, p["ln_w"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"],
                          t_tile=32, interpret=True)

    def _fwd(h, p):
        return fused(h, p), (h, p)

    def _bwd(saved, g):
        _, vjp = jax.vjp(plain, *saved)
        return vjp(g)

    fused.defvjp(_fwd, _bwd)

    def loss(h, ps):
        for p in ps:
            h = fused(h, p)
        return jnp.sum(h.astype(jnp.float32))

    return jax.value_and_grad(loss, argnums=(0, 1))(x, params)


@pytest.fixture(scope="module")
def case():
    x, params = k2.make_inputs(B, C, T, BLOCKS, torch.float32, "cpu")
    return x, params


def test_chain_matches_the_jax_custom_vjp(case):
    x, params = case
    before = profiling.counters()
    loss, grads = k2.value_and_grad(k2.mlp_block_fused, x, params)
    grown = profiling.since(before)
    assert grown["fused_mlp.calls"] == BLOCKS and grown["fused_mlp.launches"] == 0
    want_loss, (gx, gps) = _jax_value_and_grad(jnp.asarray(x.detach().numpy()),
                                               _jax_params(params))
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    want = [np.asarray(gx)]
    for gp in gps:
        for k in k2.PARAMS:
            w = np.asarray(gp[k])
            want.append(w[0].T[:, :, None] if k in ("w1", "w2") else w)
    assert len(grads) == len(want) == 1 + 6 * BLOCKS
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=str(i))


def test_one_block_gradients_equal_the_plain_arm(case):
    x, params = case
    out = k2.one_block_gradients(x, params[0])
    assert torch.equal(out["fused"][0], out["plain"][0])
    for a, b in zip(out["fused"][1], out["plain"][1]):
        assert torch.equal(a, b)


def test_inputs_without_grad_get_none():
    x, params = k2.make_inputs(1, C, 32, 1, torch.float32, "cpu")
    p = {k: v.detach() for k, v in params[0].items()}
    y = k2.mlp_block_fused(x, p)
    gx, = torch.autograd.grad(y.sum(), [x])
    want, = torch.autograd.grad(k2.mlp_block_plain(x, p).sum(), [x])
    assert torch.equal(gx, want)
    with torch.no_grad():
        assert not k2.mlp_block_fused(x, p).requires_grad


def test_run_reports_both_arms_on_the_cpu():
    res = k2.run(batch=1, channels=C, tokens=32, blocks=2, iters=1, rounds=2, device="cpu",
                 log=lambda _msg: None)
    assert len(res["plain_ms"]) == len(res["fused_ms"]) == 2
    assert res["launches"] == 0                      # the CPU runs the op's plain version
    assert all(v == 0 for v in res["one_block"].values())
    assert res["loss"]["plain"] == pytest.approx(res["loss"]["fused"], rel=1e-6)


@pytest.mark.parametrize("mode", ["step", "fwd"])
def test_time_train_step_runs_on_the_cpu(mode):
    quiet = lambda _msg: None  # noqa: E731
    res = time_train_step.run(batch=2, iters=1, mode=mode, remat=mode == "step", tiny=True,
                              device="cpu", log=quiet)
    assert res["ms"] > 0 and res["clips_per_s"] > 0
    assert set(res["launches"]) == set(time_train_step.KERNELS) | {"deform_conv_bwd"}
    assert not any(res["launches"].values())             # the CPU launches no kernel
    if mode == "fwd":
        ab = time_train_step.run(batch=2, iters=1, mode=mode, ab_dropout=True, tiny=True,
                                 device="cpu", log=quiet)
        assert len(ab["rounds"]) == 3
        assert all(set(r) == {"dropout", "no-dropout"} for r in ab["rounds"])
