"""The port's window attention and embedding convs against the JAX package.

``models/blocks.py::local_masked_mhca_ct`` against JAX
``blocks.local_masked_mhca`` (window attention, projection included) at
(n_head, window) in {(2, 5), (1, 9)}, stride 1 and 2, the relative bias on
and off (the parameter is there either way: off must ignore it); a
ConvTransformer with an embedding conv (with and without its LN) and
windows (5, 3) over arch (1, 2, 2), ``use_rel_pe`` on, C = 32, through
``jax_bridge``: in eval with ``fused=True`` (the fused MLP's plain version on
the CPU, called once a window block) against JAX's plain forward, and in
train mode with dropout off.  Weights from numpy in the JAX init's shapes
(tests/helpers/torch_port.py); f32; 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.models import blocks as jax_blocks
from otpose_tpu.models import core as jax_core
from otpose_tpu.models.conv_transformer import ConvTransformerSpec as JaxSpec
from otpose_tpu.models.conv_transformer import conv_transformer_forward, init_conv_transformer
from otpose_tpu.models.core import Ctx
from otpose_tpu_torch.models import blocks
from otpose_tpu_torch.models.conv_transformer import (ConvTransformer, ConvTransformerSpec,
                                                      init_conv_transformer_)
from otpose_tpu_torch.models.jax_bridge import from_jax, load_jax_weights, to_jax
from otpose_tpu_torch.utils import profiling

from tests.helpers.torch_port import numpy_weights


def _local_block_init(key, c, n_head, window):
    params = {}
    jax_blocks.init_local_transformer_block(params, jax_core.KeyGen(key), "blk", c, n_head,
                                            window, use_rel_pe=True)
    return params, {}


@pytest.mark.parametrize("use_rel_pe", [True, False], ids=["rel_pe", "no_rel_pe"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n_head,window", [(2, 5), (1, 9)])
def test_local_masked_mhca_matches_jax(n_head, window, stride, use_rel_pe):
    c, t = 8, 40
    params, _ = numpy_weights(_local_block_init, c, n_head, window, seed=window + stride)
    attn_params = {k[len("blk.attn."):]: v for k, v in params.items()
                   if k.startswith("blk.attn.")}
    assert attn_params["rel_pe"].shape == (1, 1, n_head, window)
    x = np.random.RandomState(3).randn(2, c, t).astype(np.float32)
    ctx = Ctx({k: jnp.asarray(v) for k, v in attn_params.items()}, {}, train=False)
    want = jax_blocks.local_masked_mhca(ctx, jnp.asarray(x.transpose(0, 2, 1)), n_head,
                                        window_size=window, stride=stride,
                                        use_rel_pe=use_rel_pe)
    attn = blocks.LocalMaskedMHCA(c, n_head, window, use_rel_pe=True)
    attn.load_state_dict(from_jax(attn_params, {}), strict=True)
    with torch.no_grad():
        got = blocks.local_masked_mhca_ct(attn, torch.from_numpy(x), n_head, window,
                                          stride=stride, use_rel_pe=use_rel_pe)
    assert got.shape == (2, c, t // stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-5)


def _specs(with_ln: bool):
    kw = dict(n_in=6, n_embd=32, n_head=2, n_embd_ks=3, max_len=64, arch=(1, 2, 2),
              with_ln=with_ln, mha_win_size=(5, 3), use_rel_pe=True, attn_pdrop=0.0,
              proj_pdrop=0.0, path_pdrop=0.1)
    return JaxSpec(**kw), ConvTransformerSpec(**kw)


@pytest.fixture(scope="module", params=[True, False], ids=["with_ln", "bias"])
def encoder(request):
    jspec, spec = _specs(request.param)
    params, state = numpy_weights(init_conv_transformer, jspec, seed=7)
    model = load_jax_weights(ConvTransformer(spec), params, state)
    x = np.random.RandomState(8).randn(2, 8, 6, 6).astype(np.float32)   # (B, H, W, C_in)
    return jspec, spec, params, state, model, x


def test_window_levels_and_params_follow_win_size(encoder):
    jspec, spec, params, _, model, _ = encoder
    assert [spec.win_size(i) for i in range(4)] == [jspec.win_size(i) for i in range(4)] \
        == [5, 3, 3, 3]
    assert [b.window for b in model.stem] == [5, 5]
    assert [b.window for b in model.branch] == [3, 3]
    assert set(model.state_dict()) == set(params) | {"pos_embd"}
    assert ("embd.0.bias" in params) == (not spec.with_ln)
    assert ("embd_norm.0.weight" in params) == spec.with_ln
    back, _ = to_jax(model)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_encoder_eval_matches_jax(encoder):
    jspec, _, params, state, model, x = encoder
    want = conv_transformer_forward(Ctx(jax.tree.map(jnp.asarray, params),
                                        jax.tree.map(jnp.asarray, state), train=False,
                                        fused=False), jnp.asarray(x), jspec, out_layout="ct")
    before = profiling.counters()
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), fused=True)
    grown = profiling.since(before)
    assert grown["fused_mlp.calls"] == 4 and grown["fused_mlp.launches"] == 0   # window blocks
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_encoder_train_mode_matches_jax(encoder):
    jspec, spec, params, state, model, x = encoder
    jspec = dataclasses.replace(jspec, path_pdrop=0.0)
    want = conv_transformer_forward(Ctx(jax.tree.map(jnp.asarray, params),
                                        jax.tree.map(jnp.asarray, state), train=True,
                                        rng=jax.random.PRNGKey(0)),
                                    jnp.asarray(x), jspec, out_layout="ct")
    twin = blocks.set_drop_rates(load_jax_weights(ConvTransformer(spec), params, state))
    before = profiling.counters()
    twin.train()
    got = twin(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert profiling.since(before)["fused_mlp.calls"] == 0    # train mode runs plain
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    got[0].sum().backward()
    assert all(p.grad is not None for n, p in twin.named_parameters()
               if n.startswith(("embd", "stem")))


def test_init_draws_the_jax_distributions():
    _, spec = _specs(True)
    spec = dataclasses.replace(spec, n_embd=136, n_in=136)
    model = init_conv_transformer_(ConvTransformer(spec), torch.Generator().manual_seed(0))
    rel = torch.cat([b.attn.rel_pe.flatten() for b in list(model.stem) + list(model.branch)])
    assert abs(rel.std().item() / (2 / 136) ** 0.5 - 1) < 0.15
    assert abs(model.embd[0].weight.std().item() / 1e-3 - 1) < 0.02
    assert all((b.mlp["0"].bias == 0).all() for b in model.stem)
