"""The port's DCN variants and deformable PSRoI pooling against the JAX
package's (``otpose_tpu/ops/deform_conv.py``, ``ops/deform_pool.py``).

Same numpy inputs, f32, the port's NCHW / OIHW layouts against JAX's NHWC /
HWIO: ``modulated_deform_conv_gather``, ``modulated_deform_conv`` (weight
groups too), ``deform_conv`` (DCNv1) and ``identity_filler_weight`` over
groups, deformable groups, stride, padding and dilation, to 1e-5; the
``ValueError`` for groups that do not divide the deformable groups;
``deform_psroi_pool`` with and without part offsets (values to 1e-5, sample
counts exactly); and one gradient case of ``modulated_deform_conv`` against
``jax.grad`` with small offsets (most samples inside the image: far outside
every sample is zero and the gradients say nothing, the reason of
``tests/helpers/torch_port.py::calibrate_refinement``), each gradient to 1e-5
of its peak.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu_torch import ops

# the packages' ``ops`` re-export functions named as these modules
jdc = importlib.import_module("otpose_tpu.ops.deform_conv")
jdp = importlib.import_module("otpose_tpu.ops.deform_pool")
deform_conv = importlib.import_module("otpose_tpu_torch.ops.deform_conv")
deform_pool = importlib.import_module("otpose_tpu_torch.ops.deform_pool")

# (groups, deformable_groups, stride, padding, dilation)
CASES = [(1, 1, 1, 1, 1), (1, 2, 2, 1, 1), (2, 2, 1, 2, 2), (2, 4, 2, 2, 2), (1, 4, 1, 0, 1)]


def _inputs(groups, dg, stride, padding, dilation, seed=0, b=2, c=8, h=11, w=10, o=6, k=3):
    rng = np.random.RandomState(seed)
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    return dict(
        x=rng.randn(b, h, w, c).astype(np.float32),
        off=(1.5 * rng.randn(b, ho, wo, dg * 2 * k * k)).astype(np.float32),
        mask=rng.uniform(-0.5, 1.5, (b, ho, wo, dg * k * k)).astype(np.float32),
        weight=(rng.randn(k, k, c // groups, o) / np.sqrt(9 * c)).astype(np.float32),
        bias=(0.1 * rng.randn(o)).astype(np.float32))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("groups,dg,stride,padding,dilation", CASES)
def test_modulated_deform_conv_matches_jax(groups, dg, stride, padding, dilation):
    a = _inputs(groups, dg, stride, padding, dilation)
    kw = dict(kernel=3, stride=stride, padding=padding, dilation=dilation, deformable_groups=dg)
    want = jdc.modulated_deform_conv(*(jnp.asarray(a[k]) for k in
                                       ("x", "off", "mask", "weight", "bias")),
                                     groups=groups, **kw)
    got = deform_conv.modulated_deform_conv(_nchw(a["x"]), _nchw(a["off"]), _nchw(a["mask"]),
                                            _oihw(a["weight"]), torch.from_numpy(a["bias"]),
                                            groups=groups, **kw)
    _close(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))
    want1 = jdc.deform_conv(jnp.asarray(a["x"]), jnp.asarray(a["off"]),
                            jnp.asarray(a["weight"]), None, groups=groups, **kw)
    got1 = ops.deform_conv(_nchw(a["x"]), _nchw(a["off"]), _oihw(a["weight"]), None,
                           groups=groups, **kw)
    _close(got1.numpy(), np.asarray(want1).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("groups,dg,stride,padding,dilation",
                         [c for c in CASES if c[0] == 1])
def test_gather_form_matches_jax(groups, dg, stride, padding, dilation):
    a = _inputs(groups, dg, stride, padding, dilation, seed=1)
    kw = dict(kernel=3, stride=stride, padding=padding, dilation=dilation, deformable_groups=dg)
    want = jdc.modulated_deform_conv_gather(*(jnp.asarray(a[k]) for k in
                                              ("x", "off", "mask", "weight", "bias")), **kw)
    got = ops.modulated_deform_conv_gather(_nchw(a["x"]), _nchw(a["off"]), _nchw(a["mask"]),
                                           _oihw(a["weight"]), torch.from_numpy(a["bias"]),
                                           **kw)
    _close(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))


def test_dcnv1_mask_is_ones_in_x_dtype_and_identity_filler():
    a = _inputs(1, 2, 1, 1, 1, seed=2)
    x = _nchw(a["x"]).to(torch.bfloat16)
    off, w = _nchw(a["off"]), _oihw(a["weight"])
    ones = torch.ones(2, 18, *off.shape[-2:], dtype=torch.bfloat16)
    got = ops.deform_conv(x, off, w, deformable_groups=2)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ops.modulated_deform_conv(x, off, ones, w, deformable_groups=2))
    ident = ops.identity_filler_weight(5)
    np.testing.assert_array_equal(ident.numpy(),
                                  np.asarray(jdc.identity_filler_weight(5)).transpose(3, 2, 0, 1))
    # the identity weight with zero offsets and unit masks passes x through
    xs = torch.randn(1, 5, 7, 6)
    zero = torch.zeros(1, 18, 7, 6)
    out = ops.modulated_deform_conv(xs, zero, torch.ones(1, 9, 7, 6), ident)
    torch.testing.assert_close(out, xs, rtol=0, atol=0)


def test_groups_must_divide_the_deformable_groups():
    a = _inputs(1, 3, 1, 1, 1)
    with pytest.raises(ValueError, match="divisible by groups"):
        deform_conv.modulated_deform_conv(_nchw(a["x"])[:, :6], _nchw(a["off"]),
                                          _nchw(a["mask"]), torch.zeros(6, 3, 3, 3),
                                          deformable_groups=3, groups=2)
    with pytest.raises(ValueError, match="divisible by groups"):
        jdc.modulated_deform_conv(jnp.asarray(a["x"][..., :6]), jnp.asarray(a["off"]),
                                  jnp.asarray(a["mask"]), jnp.zeros((3, 3, 3, 6)),
                                  deformable_groups=3, groups=2)


def test_modulated_deform_conv_gradients_match_jax_grad():
    groups, dg, stride, padding, dilation = 2, 2, 1, 2, 2
    a = _inputs(groups, dg, stride, padding, dilation, seed=4)
    a["off"] *= 0.5
    g = np.random.RandomState(5).randn(2, 11, 10, 6).astype(np.float32)
    kw = dict(kernel=3, stride=stride, padding=padding, dilation=dilation,
              deformable_groups=dg, groups=groups)
    names = ("x", "off", "mask", "weight", "bias")

    def loss(*args):
        return jnp.sum(jdc.modulated_deform_conv(*args, **kw) * g)

    want = jax.grad(loss, argnums=tuple(range(5)))(*(jnp.asarray(a[k]) for k in names))
    t = [_nchw(a["x"]), _nchw(a["off"]), _nchw(a["mask"]), _oihw(a["weight"]),
         torch.from_numpy(a["bias"])]
    for v in t:
        v.requires_grad_()
    (deform_conv.modulated_deform_conv(*t, **kw) * _nchw(g)).sum().backward()
    layouts = (lambda v: v.permute(0, 2, 3, 1),) * 3 + (lambda v: v.permute(2, 3, 1, 0),
                                                          lambda v: v)
    for name, v, w, lay in zip(names, t, want, layouts):
        w = np.asarray(w)
        np.testing.assert_allclose(lay(v.grad).numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("no_trans", [True, False], ids=["no_trans", "trans"])
def test_deform_psroi_pool_matches_jax(no_trans):
    rng = np.random.RandomState(6)
    out_dim, group, ps, part = 3, 3, 3, 3
    x = rng.randn(2, 17, 19, out_dim * group * group).astype(np.float32)
    rois = np.array([[0, 2, 3, 20, 25], [1, 0, 0, 35, 30], [1, 10.4, 6.6, 14.5, 40],
                     [0, -6, -4, 8, 7]], np.float32)
    trans = rng.randn(4, 2, part, part).astype(np.float32)
    kw = dict(spatial_scale=0.5, out_size=ps, output_dim=out_dim, group_size=group,
              part_size=part, sample_per_part=4, trans_std=0.2, no_trans=no_trans)
    want_top, want_count = jdp.deform_psroi_pool(jnp.asarray(x), jnp.asarray(rois),
                                                 jnp.asarray(trans), **kw)
    top, count = deform_pool.deform_psroi_pool(_nchw(x), torch.from_numpy(rois),
                                               torch.from_numpy(trans), **kw)
    assert top.shape == count.shape == (4, out_dim, ps, ps)
    _close(top.numpy(), np.asarray(want_top).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_count).transpose(0, 3, 1, 2))
    assert 0 < count.sum() < count.numel() * 16          # some samples are skipped
    assert ops.deform_roi_pooling is deform_pool.deform_psroi_pool
