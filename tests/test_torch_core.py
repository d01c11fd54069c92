"""PyTorch port vs the JAX package: core ops, decode, HRNet, transformer
blocks and the ConvTransformer, on the CPU in f32.

Inputs are made with numpy and fed to both sides; weights have the JAX
init's keys and shapes (tests/helpers/torch_port.py) and reach the port
through ``jax_bridge``.  Components are held to 1e-5, HRNet and the
ConvTransformer to 2e-4 of the output's peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.models import blocks as jblocks
from otpose_tpu.models import conv_transformer as jct
from otpose_tpu.models import core as jcore
from otpose_tpu.models import hrnet as jhrnet
from otpose_tpu.models.core import Ctx
from otpose_tpu.ops import heatmap as jheatmap
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.models import blocks, core, hrnet
from otpose_tpu_torch.models.conv_transformer import ConvTransformer, ConvTransformerSpec
from otpose_tpu_torch.models.jax_bridge import from_jax, load_jax_weights
from otpose_tpu_torch.ops import heatmap
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import numpy_weights


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_layer_norm_ct():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, 40).astype(np.float32) * 3 + 1
    w, b = rng.randn(12).astype(np.float32), rng.randn(12).astype(np.float32)
    _close(core.layer_norm_ct(_t(x), _t(w), _t(b)),
           jcore.layer_norm_ct(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), 1e-5)


@pytest.mark.parametrize("stride,t", [(1, 40), (2, 40), (2, 41)])
def test_depthwise_conv1d_k3_ct(stride, t):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, t).astype(np.float32)
    w_jax = rng.randn(3, 1, 8).astype(np.float32)          # (K, 1, C)
    w_port = np.transpose(w_jax, (2, 1, 0))                 # (C, 1, K)
    _close(core.depthwise_conv1d_k3_ct(_t(x), _t(w_port), stride=stride),
           jcore.depthwise_conv1d_k3_ct(jnp.asarray(x), jnp.asarray(w_jax), stride=stride),
           1e-5)


@pytest.mark.parametrize("t", [40, 41])
def test_max_pool1d_ct(t):
    x = np.random.RandomState(2).randn(2, 8, t).astype(np.float32)
    _close(core.max_pool1d_ct(_t(x), 3, 2, 1),
           jcore.max_pool1d_ct(jnp.asarray(x), 3, 2, 1), 0)


@pytest.mark.parametrize("t,out_t", [(20, 40), (10, 40), (20, 20), (12, 40)])
def test_upsample_linear_1d_ct(t, out_t):
    x = np.random.RandomState(3).randn(2, 5, t).astype(np.float32)
    _close(core.upsample_linear_1d_ct(_t(x), out_t),
           jcore.upsample_linear_1d_ct(jnp.asarray(x), out_t), 1e-6)


def test_gelu_bn_and_nearest_upsample():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 5, 7).astype(np.float32)
    _close(core.gelu(_t(x)), jcore.gelu(jnp.asarray(x)), 1e-6)
    w, b, m = (rng.randn(6).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.5, 2, 6).astype(np.float32)
    y_jax, _, _ = jcore.batch_norm(jnp.asarray(x.transpose(0, 2, 3, 1)), *map(jnp.asarray, (w, b, m, v)),
                                   train=False)
    _close(core.batch_norm_eval(_t(x), *map(_t, (w, b, m, v))).permute(0, 2, 3, 1), y_jax, 1e-6)
    _close(core.upsample_nearest(_t(x), 4).permute(0, 2, 3, 1),
           jcore.upsample_nearest_2x(jnp.asarray(x.transpose(0, 2, 3, 1)), 4), 0)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 3)])
def test_conv2d(stride, dilation):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 11, 9).astype(np.float32)
    w = rng.randn(3, 3, 4, 6).astype(np.float32)            # HWIO
    b = rng.randn(6).astype(np.float32)
    pad = dilation
    got = core.conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b), stride=stride,
                      padding=pad, dilation=dilation)
    want = jcore.conv2d(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w), jnp.asarray(b),
                        stride=stride, padding=pad, dilation=dilation)
    _close(got.permute(0, 2, 3, 1), want, 1e-5)


def test_sinusoid_encoding_is_the_jax_table_transposed():
    _close(blocks.get_sinusoid_encoding(50, 12),
           jblocks.get_sinusoid_encoding(50, 12).transpose(0, 2, 1), 0)


def test_decode_matches_jax():
    rng = np.random.RandomState(6)
    hm = rng.rand(3, 5, 12, 10).astype(np.float32)
    hm[0, 0] = 0.0                      # all ties and max 0: coords zeroed
    hm[0, 1, 0, 4] = 2.0                # peak on the border: no shift
    hm[0, 2, 2, 2] = 2.0                # just inside: shift
    hm[0, 3, 1, 1] = hm[0, 3, 7, 7] = 3.0   # tie: first max
    for port_fn, jax_fn in ((heatmap.get_max_preds_device, jheatmap.get_max_preds_device),
                            (heatmap.refine_coords_device, jheatmap.refine_coords_device)):
        for got, want in zip(port_fn(_t(hm)), jax_fn(jnp.asarray(hm))):
            _close(got, want, 0)


# ---------------------------------------------------------------------------
# HRNet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage2_block", ["BASIC", "BOTTLENECK"])
def test_hrnet_forward_matches_jax(stage2_block):
    """BOTTLENECK at stage 2 takes the channel-changing transition on an
    existing branch, which the JAX package rebuilt (tests/test_hrnet.py)."""
    jcfg, cfg = jax_tiny_cfg(), tiny_otpose_cfg()
    jcfg.MODEL.EXTRA.STAGE2.BLOCK = cfg.MODEL.EXTRA.STAGE2.BLOCK = stage2_block
    jspec = jhrnet.HRNetSpec.from_cfg(jcfg)
    params, state = numpy_weights(jhrnet.init_hrnet, jspec)
    model = hrnet.HRNet(hrnet.HRNetSpec.from_cfg(cfg)).eval()
    load_jax_weights(model, params, state)
    x = np.random.RandomState(7).randn(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(lambda p, s, x: jhrnet.hrnet_forward(Ctx(p, s), x, jspec))(params, state, x)
    with torch.no_grad():
        got = hrnet.hrnet_forward(model, _t(x))
    want = np.asarray(want)
    _close(got / np.abs(want).max(), want / np.abs(want).max(), 2e-4)


# ---------------------------------------------------------------------------
# transformer blocks and the ConvTransformer
# ---------------------------------------------------------------------------

def _block_init(key, c, path_pdrop):
    params = {}
    jblocks.init_transformer_block(params, jcore.KeyGen(key), "blk", c, path_pdrop)
    return params, {}


def _port_block(params, c, n_head, ds, path_pdrop):
    blk = blocks.TransformerBlock(c, n_head, ds, path_pdrop).eval()
    blk.load_state_dict(from_jax({k[4:]: v for k, v in params.items()}, {}), strict=True)
    return blk


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("c,n_head,ds,path_pdrop", [
    (32, 2, 1, 0.1),    # C >= 32: kernel dispatch when fused
    (32, 2, 2, 0.0),    # strided: plain attention, kernel MLP when fused
    (17, 1, 1, 0.1),    # flow encoder width: always the plain path
])
def test_transformer_block_ct_matches_jax(fused, c, n_head, ds, path_pdrop):
    params, _ = numpy_weights(_block_init, c, path_pdrop, seed=c + ds)
    x = np.random.RandomState(8).randn(2, c, 96).astype(np.float32)
    want = jblocks.transformer_block_ct(
        Ctx(params, {}, train=False, fused=False).sub("blk"), jnp.asarray(x), n_head,
        ds_stride=ds, path_pdrop=path_pdrop)
    blk = _port_block(params, c, n_head, ds, path_pdrop)
    with torch.no_grad():
        got = blocks.transformer_block_ct(blk, _t(x), fused=fused)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("max_len,upsample", [(96, False), (48, True)])
def test_conv_transformer_forward_matches_jax(max_len, upsample):
    kw = dict(n_in=32, n_embd=32, n_head=2, n_embd_ks=3, max_len=max_len,
              arch=(0, 2, 1), path_pdrop=0.1)
    jspec, spec = jct.ConvTransformerSpec(**kw), ConvTransformerSpec(**kw)
    params, state = numpy_weights(jct.init_conv_transformer, jspec)
    model = ConvTransformer(spec).eval()
    load_jax_weights(model, params, state)
    x = np.random.RandomState(9).randn(2, 8, 12, 32).astype(np.float32)
    want = jct.conv_transformer_forward(Ctx(params, state, train=False, fused=False),
                                        jnp.asarray(x), jspec, out_layout="ct",
                                        upsample=upsample)
    with torch.no_grad():
        got = model(_t(x).permute(0, 3, 1, 2).contiguous(), upsample=upsample)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        scale = np.abs(np.asarray(w)).max()
        _close(g / scale, np.asarray(w) / scale, 2e-4)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("yaml", ["configs/17/model_RSN.yaml", "configs/18/model_RSN.yaml"])
def test_config_copy_loads_the_yaml_files_like_the_jax_package(yaml):
    import pathlib

    from otpose_tpu.config import get_cfg as jax_get_cfg
    from otpose_tpu_torch.config import get_cfg

    path = str(pathlib.Path(__file__).resolve().parents[1] / yaml)
    port, ref = get_cfg(), jax_get_cfg()
    port.merge_from_file(path)
    ref.merge_from_file(path)
    assert port.to_dict() == ref.to_dict()
    assert tiny_otpose_cfg().to_dict() == jax_tiny_cfg().to_dict()
