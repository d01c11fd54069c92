"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

Weights follow the JAX package's structure: the key set and shapes come
from the JAX ``init_*`` function (traced abstractly with ``jax.eval_shape``,
which compiles nothing), and the values are drawn with numpy at scales
that keep activations O(1), so the comparisons see real numbers rather
than the reference init's 1e-19 heatmaps.  Both sides then get the same
arrays: JAX directly, the port through ``jax_bridge``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from otpose_tpu.models import blocks


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a test module's torch ops on one thread, then restore the count.
    The suite runs in several worker processes at once; with torch's
    default of one thread per core in each, the gathers of the plain DCN
    and warp run hundreds of times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_weights(init_fn, *args, seed: int = 0):
    """(params, state) as numpy dicts with the key set and shapes of
    ``init_fn(key, *args)``."""
    p_shapes, s_shapes = jax.eval_shape(lambda key: init_fn(key, *args),
                                        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = {}
    for name in sorted(p_shapes):
        shape = p_shapes[name].shape
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            arr = rng.randn(*shape) / np.sqrt(fan_in)
        elif name.endswith(".bias"):
            arr = 0.1 * rng.randn(*shape)
        else:                                   # norm weights, drop-path scales
            arr = 1.0 + 0.1 * rng.randn(*shape)
        params[name] = arr.astype(np.float32)
    state = {}
    for name in sorted(s_shapes):
        shape = s_shapes[name].shape
        if name.endswith("running_var"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("running_mean"):
            arr = 0.1 * rng.randn(*shape)
        else:                                   # pos_embd (1, T, C)
            arr = blocks.get_sinusoid_encoding(shape[1], shape[2]) / np.sqrt(shape[2])
        state[name] = np.asarray(arr, np.float32)
    return params, state
