"""The port's fused-MLP module vs the JAX Pallas kernel.

``ops/cuda/fused_mlp.py``'s plain version (what the wrapper runs for a CPU
tensor) against ``fused_mlp_residual_ct`` in interpret mode, on the shapes
of tests/test_fused_mlp.py: rtol = atol = 1e-5 in f32, 0.05 in bf16.  The
CUDA kernel itself is held against the same plain version on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.ops.pallas.fused_mlp import fused_mlp_residual_ct as jax_fused_mlp
from otpose_tpu_torch.models import blocks
from otpose_tpu_torch.ops.cuda import fused_mlp
from otpose_tpu_torch.utils import profiling


def _make(rng, c):
    return dict(
        ln_w=(1 + 0.1 * rng.randn(c)).astype(np.float32),
        ln_b=(0.1 * rng.randn(c)).astype(np.float32),
        w1=(rng.randn(1, c, 4 * c) / np.sqrt(c)).astype(np.float32),
        b1=(0.1 * rng.randn(4 * c)).astype(np.float32),
        w2=(rng.randn(1, 4 * c, c) / np.sqrt(4 * c)).astype(np.float32),
        b2=(0.1 * rng.randn(c)).astype(np.float32),
    )


def _port_args(p, dtype):
    """JAX (1, C_in, C_out) kernels -> the port's (C_out, C_in, 1)."""
    conv = lambda w: torch.tensor(w[0].T[:, :, None]).to(dtype)  # noqa: E731
    return (torch.tensor(p["ln_w"]), torch.tensor(p["ln_b"]),
            conv(p["w1"]), torch.tensor(p["b1"]).to(dtype),
            conv(p["w2"]), torch.tensor(p["b2"]).to(dtype))


@pytest.mark.parametrize("c,t,tile", [(8, 64, 32), (8, 200, 128), (17, 96, 128)])
def test_plain_matches_pallas_f32(c, t, tile):
    rng = np.random.RandomState(0)
    p = _make(rng, c)
    x = rng.randn(2, c, t).astype(np.float32)
    want = jax_fused_mlp(jnp.asarray(x), *(jnp.asarray(p[k]) for k in
                                           ("ln_w", "ln_b", "w1", "b1", "w2", "b2")),
                         t_tile=tile, interpret=True)
    got = fused_mlp.fused_mlp_residual_ct(torch.from_numpy(x), *_port_args(p, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_matches_pallas_bf16():
    rng = np.random.RandomState(1)
    c, t = 16, 160
    p = _make(rng, c)
    x = rng.randn(2, c, t).astype(np.float32)
    bf = lambda k: jnp.asarray(p[k], jnp.bfloat16)  # noqa: E731
    want = jax_fused_mlp(jnp.asarray(x, jnp.bfloat16), jnp.asarray(p["ln_w"]),
                         jnp.asarray(p["ln_b"]), bf("w1"), bf("b1"), bf("w2"), bf("b2"),
                         t_tile=128, interpret=True)
    # the port gets the bf16-rounded values the JAX side saw
    pr = {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
          if k not in ("ln_w", "ln_b") else v for k, v in p.items()}
    xr = torch.from_numpy(x).to(torch.bfloat16)
    got = fused_mlp.fused_mlp_residual_ct(xr, *_port_args(pr, torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0.05, atol=0.05)


def test_block_folds_drop_path_scale_like_the_unfused_tail():
    """fused_mlp_block_ct (scale folded into W2/b2) vs the plain block tail
    (scale applied after the MLP)."""
    torch.manual_seed(0)
    blk = blocks.TransformerBlock(32, 2, 1, path_pdrop=0.1)
    with torch.no_grad():
        for prm in blk.parameters():
            prm.copy_(torch.randn_like(prm) / np.sqrt(max(prm[0].numel(), 1)))
    x = torch.randn(2, 32, 48)
    with torch.no_grad():
        got = blocks.fused_mlp_block_ct(blk, x)
        h = blk.ln2(x)
        h = torch.nn.functional.gelu(blocks.core.dense_1x1_ct(h, blk.mlp["0"].weight,
                                                             blk.mlp["0"].bias))
        h = blocks.core.dense_1x1_ct(h, blk.mlp["3"].weight, blk.mlp["3"].bias)
        want = x + blk.drop_path_mlp(h)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_tensor_runs_plain_version_and_counts_no_launch():
    p = _port_args(_make(np.random.RandomState(2), 8), torch.float32)
    x = torch.randn(1, 8, 40)
    before = profiling.counters()
    assert torch.equal(fused_mlp.fused_mlp_residual_ct(x, *p), fused_mlp.fused_mlp_plain(x, *p))
    grown = profiling.since(before)
    assert (grown["fused_mlp.calls"], grown["fused_mlp.launches"]) == (1, 0)
