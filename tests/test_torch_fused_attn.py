"""The port's fused-attention module vs the JAX Pallas kernel.

``ops/cuda/fused_attn.py``'s plain version (what the wrapper runs for a CPU
tensor) against ``fused_attn_ct`` in interpret mode, on the shapes of
tests/test_fused_attn.py: rtol = atol = 1e-5 in f32, 0.05 in bf16.  The CUDA
kernel itself is held against the same plain version on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.models import blocks as jblocks
from otpose_tpu.models import core as jcore
from otpose_tpu.ops.pallas.fused_attn import fused_attn_ct as jax_fused_attn_ct
from otpose_tpu_torch.models.jax_bridge import from_jax
from otpose_tpu_torch.ops.cuda import fused_attn

from tests.helpers.torch_port import numpy_weights

_ORDER = ("ln1.weight", "ln1.bias", "attn.query_conv.weight", "attn.key_conv.weight",
          "attn.value_conv.weight", "attn.query_norm.weight", "attn.query_norm.bias",
          "attn.key_norm.weight", "attn.key_norm.bias", "attn.value_norm.weight",
          "attn.value_norm.bias", "attn.query.weight", "attn.query.bias",
          "attn.key.weight", "attn.key.bias", "attn.value.weight", "attn.value.bias")


def _params(c, seed):
    def init(key):
        params = {}
        jblocks.init_transformer_block(params, jcore.KeyGen(key), "blk", c)
        return params, {}
    params, _ = numpy_weights(init, seed=seed)
    return {k[4:]: v for k, v in params.items()}


def _both(params, x, n_head, tile, dtype):
    """(port plain, JAX interpret) outputs; ``dtype`` rounds the weights
    the models apply in the compute dtype, LN affines stay f32."""
    jp = {k: (jnp.asarray(v, dtype) if "norm" not in k and "ln1" not in k
              else jnp.asarray(v)) for k, v in params.items()}
    want = jax_fused_attn_ct(jnp.asarray(x, dtype), *(jp[k] for k in _ORDER), n_head,
                             t_tile=tile, interpret=True)
    sd = from_jax({k: np.asarray(v.astype(jnp.float32)) for k, v in jp.items()}, {})
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    xt = torch.from_numpy(np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))).to(tdt)
    got = fused_attn.fused_attn_ct(xt, *(sd[k].to(tdt) if "norm" not in k and "ln1" not in k
                                         else sd[k] for k in _ORDER), n_head)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("c,n_head,t,tile", [
    (8, 2, 96, 96),
    (8, 2, 96, 32),
    (16, 4, 256, 128),
    (12, 3, 96, 96),
])
def test_plain_matches_pallas_f32(c, n_head, t, tile):
    x = np.random.RandomState(0).randn(2, c, t).astype(np.float32)
    got, want = _both(_params(c, seed=c), x, n_head, tile, jnp.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_matches_pallas_bf16():
    x = np.random.RandomState(1).randn(2, 16, 128).astype(np.float32)
    got, want = _both(_params(16, seed=1), x, 2, 64, jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


def test_cpu_tensor_runs_plain_version_and_counts_no_launch():
    p = from_jax(_params(8, 0), {})
    x = torch.randn(1, 8, 40)
    calls, launches = fused_attn.calls, fused_attn.launches
    got = fused_attn.fused_attn_ct(x, *(p[k] for k in _ORDER), 2)
    want = fused_attn.fused_attn_plain(x, *(p[k] for k in _ORDER), 2)
    assert torch.equal(got, want)
    assert (fused_attn.calls, fused_attn.launches) == (calls + 1, launches)


def test_other_devices_raise():
    p = {k: v.to("meta") for k, v in from_jax(_params(8, 0), {}).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        fused_attn.fused_attn_ct(torch.empty(1, 8, 40, device="meta"),
                                 *(p[k] for k in _ORDER), 2)
