"""The shapes the JAX package runs beyond the shipped configs, against it on
the CPU, in f32: joint counts whose temporal encoders are wider than the
fused kernels' narrow paths take (C = 8 x joints: 168 at 21 joints, above
their 160; the wide paths take them), the DCN at more than 32 outputs (33
joints and up) and at more than 8 dilations.  Inputs from numpy seeds; JAX
runs ``fused=False``.

- **The whole model** at ``tiny_otpose_cfg(num_joints=21)``,
  ``(num_joints=33)`` and 17 joints with nine dilations (1 to 9), the
  refinement calibrated (``tests/helpers/torch_port.py``): the seven outputs
  of ``otpose_forward`` to 1e-3 of each output's peak (the model bar) and
  the decoded keypoints (coords equal where a heatmap's top-two gap is
  clear, max values to 1e-3 of their peak), with the op calls the gate
  gives (the fused ops in the 168- and 264-channel encoders as at 17
  joints; the flow encoder's two blocks too at 33 joints).
- **The DCN op** at O in {33, 64, 65} and D in {5, 9}: the forward against
  JAX's ``modulated_deform_conv_multi`` to 1e-5 of the peak, and its five
  gradients against ``jax.grad`` of the JAX function run in f64 (the exact
  witness) to 1e-3 of each gradient's peak, at calibrated offsets
  (``utils/testing.py::dcn_case``).
- **The DCN pack and its launches**: O padded to the first of 8, 20, 32,
  above 32 to a multiple of 32; a launch a group of 32 outputs and of 8
  dilations; the forward's partial-sum slots.
- **The exported program** (``engine/export.py``) at 33 joints and nine
  dilations: the decoded step traced on the CPU (the DCN op from its pack
  of 64 outputs) equals the live step bit for bit.
- **The fused blocks' gate**: ``fused_attn.supports`` / ``fused_mlp.supports``
  at the kernels' limits (the attention any C whose heads divide it, the
  MLP to 1152 padded channels), and the op calls of a block on either side
  of the narrow kernels' 160 (``calls`` counts on the CPU too): C = 136,
  168 and 1064 and one f32 head of 144 channels call both fused ops.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otpose_tpu.engine.trainer import make_decoded_eval_step as jax_decoded_step
from otpose_tpu.models.core import Ctx
from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
from otpose_tpu.models.otpose import _init_otpose_impl, otpose_forward as jax_forward
from otpose_tpu.ops.deform_conv import modulated_deform_conv_multi as jax_dcn_multi
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
from otpose_tpu_torch.models.blocks import TransformerBlock
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import load_jax_weights
from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp
from otpose_tpu_torch.utils import profiling
from otpose_tpu_torch.utils.testing import (dcn_case, dcn_gradients, dcn_inside_share,
                                            tiny_otpose_cfg)

from tests.helpers.torch_port import (calibrate_refinement, numpy_weights,  # noqa: F401
                                      one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NINE = list(range(1, 10))
# (joints, dilations, op calls a forward: fused attention, fused MLP, DCN)
MODELS = {"j21": (21, [3, 6], (4, 6, 1)), "j33": (33, [3, 6], (6, 8, 1)),
          "d9": (17, NINE, (4, 6, 1))}


def _cfgs(joints, dilations):
    cfgs = tiny_otpose_cfg(num_joints=joints), jax_tiny_cfg(num_joints=joints)
    for cfg in cfgs:
        cfg.MODEL.DEFORMABLE_CONV.DILATION = list(dilations)
    return cfgs


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    joints, dilations, calls = MODELS[request.param]
    cfg, jcfg = _cfgs(joints, dilations)
    jspec = JaxSpec.from_cfg(jcfg)
    params, state = numpy_weights(_init_otpose_impl, jspec)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 15).astype(np.float32)
    margin = np.array([[1, 1, 2, 2], [1, 0, 2, 0]], np.float32)
    inside = calibrate_refinement(params, state, x, margin, cfg=cfg)
    _, model = build_model(cfg, device="cpu")
    load_jax_weights(model, params, state)
    return dict(joints=joints, calls=calls, jspec=jspec, params=params, state=state,
                model=model, x=x, margin=margin, inside=inside)


def test_seven_outputs_match_jax(case):
    assert case["inside"] > 0.5
    want = jax.jit(lambda p, s, x, m: jax_forward(Ctx(p, s, train=False, fused=False), x, m,
                                                  case["jspec"]))(
        case["params"], case["state"], case["x"], case["margin"])
    before = profiling.counters()
    with torch.no_grad():
        got = case["model"](torch.from_numpy(case["x"]), torch.from_numpy(case["margin"]))
    grown = profiling.since(before)
    assert (grown["fused_attn.calls"], grown["fused_mlp.calls"],
            grown["deform_conv.calls"]) == case["calls"]
    assert len(got) == len(want) == 7
    assert got[0].shape[-1] == case["joints"]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.isfinite(w).all()
        peak = np.abs(w).max()
        np.testing.assert_allclose(g.numpy() / peak, w / peak, rtol=0, atol=1e-3)


def test_decoded_eval_step_matches_jax(case):
    x, margin = case["x"], case["margin"]
    want = jax_decoded_step(case["jspec"], fused=False)(
        case["params"], case["state"], {"inputs": jnp.asarray(x), "margin": jnp.asarray(margin)})
    coords, maxvals, raw = (np.asarray(a) for a in want)
    got = [a.numpy() for a in make_decoded_eval_step(case["model"])(torch.from_numpy(x),
                                                                     torch.from_numpy(margin))]
    with torch.no_grad():
        heat = case["model"](torch.from_numpy(x), torch.from_numpy(margin))[0].numpy()
    assert coords.shape == (2, case["joints"], 2)
    flat = np.sort(heat.transpose(0, 3, 1, 2).reshape(*maxvals.shape[:2], -1), axis=-1)
    clear = (flat[..., -1] - flat[..., -2]) > 1e-3
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[0][clear], coords[clear])
    np.testing.assert_array_equal(got[2][clear], raw[clear])
    peak = np.abs(maxvals).max()
    np.testing.assert_allclose(got[1] / peak, maxvals / peak, rtol=0, atol=1e-3)


# ---------------------------------------------------------------- the DCN

DCN_SHAPES = [(o, d) for o in (33, 64, 65) for d in (5, 9)] + [(133, 5)]   # + COCO-WholeBody


def _dilations(d):
    return tuple(range(1, d + 1))


def _nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def _jax_dcn(x, offs, masks, weights, biases, dilations):
    return jax_dcn_multi(_nhwc(x), [_nhwc(t) for t in offs], [_nhwc(t) for t in masks],
                         jnp.asarray(np.asarray(weights).transpose(0, 3, 4, 2, 1)),
                         jnp.asarray(biases), kernel=3, stride=1, padding_list=dilations,
                         dilation_list=dilations, deformable_groups=x.shape[1])


@pytest.mark.parametrize("o,d", DCN_SHAPES)
def test_dcn_forward_matches_jax(o, d):
    """The op (its plain version on the CPU, from the pack of O padded
    past 32) against JAX's function, to 1e-5 of the peak."""
    dilations = _dilations(d)
    args = dcn_case(2, 4, o, 10, 9, dilations, torch.float32, torch.Generator().manual_seed(o + d),
                    device="cpu", reach=2)
    x, offs, masks, weights, biases, _ = args
    pk = deform_conv.pack_dcn_weights(weights, biases)
    assert pk.w.shape == (d, 4, 9, deform_conv.output_pad(o))
    got = deform_conv.modulated_deform_conv_multi(x, offs, masks, dilations=dilations,
                                                  packed=pk)
    want = np.asarray(_jax_dcn(x.numpy(), [t.numpy() for t in offs],
                               [t.numpy() for t in masks], weights.numpy(), biases.numpy(),
                               dilations)).transpose(0, 3, 1, 2)
    assert got.shape == want.shape == (2, o, 10, 9)
    peak = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / peak, want / peak, rtol=0, atol=1e-5)


@pytest.mark.parametrize("o,d", DCN_SHAPES)
def test_dcn_gradients_match_jax_in_f64(o, d):
    """The five gradients of the op (x, offsets, masks, weights, biases)
    against ``jax.grad`` of JAX's function run in f64 with its f32 casts
    made f64 (the exact witness), to 1e-3 of each gradient's peak, at
    calibrated offsets: most samples inside the image, every fractional
    part in [0.05, 0.95]."""
    dilations = _dilations(d)
    b, c, h, w = 2, 3, 20, 18
    args = dcn_case(b, c, o, h, w, dilations, torch.float32,
                    torch.Generator().manual_seed(2 * o + d), device="cpu", reach=2)
    x, offs, masks, weights, biases, _ = args
    assert dcn_inside_share(args) >= 0.5
    g = np.random.RandomState(o + d).randn(b, o, h, w).astype(np.float32)
    got = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, torch.from_numpy(g))

    def loss(xj, oj, mj, wj, bj):
        y = jax_dcn_multi(xj, oj, mj, wj, bj, kernel=3, stride=1, padding_list=dilations,
                          dilation_list=dilations, deformable_groups=c)
        return (y * jnp.asarray(g.transpose(0, 2, 3, 1))).sum()

    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    with jax.enable_x64(True), mock.patch.object(jnp, "float32", jnp.float64):
        want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            _nhwc(f64(x)), [_nhwc(f64(t)) for t in offs], [_nhwc(f64(t)) for t in masks],
            jnp.asarray(f64(weights).transpose(0, 3, 4, 2, 1)), jnp.asarray(f64(biases)))
        want = jax.tree.map(np.asarray, want)
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    pairs = [("x", got[0], nchw(want[0])),
             ("offsets", torch.stack(got[1:1 + d]), np.stack([nchw(a) for a in want[1]])),
             ("masks", torch.stack(got[1 + d:1 + 2 * d]), np.stack([nchw(a) for a in want[2]])),
             ("weights", got[-2], np.asarray(want[3]).transpose(0, 4, 3, 1, 2)),
             ("biases", got[-1], np.asarray(want[4]))]
    for name, gp, gj in pairs:
        assert gj.dtype == np.float64 and gp.shape == gj.shape, name
        peak = np.abs(gj).max()
        assert peak > 0, name
        np.testing.assert_allclose(gp.numpy(), gj, rtol=0, atol=1e-3 * peak, err_msg=name)


@pytest.mark.parametrize("o,op,cols", [
    (1, 8, None), (8, 8, None), (9, 20, None), (17, 20, None), (20, 20, None), (21, 32, None),
    (32, 32, None), (33, 64, 48), (64, 64, 64), (65, 96, 80), (133, 160, 144),
    (136, 160, 144), (160, 160, 160), (176, 192, 176), (256, 256, 256), (289, 320, 304)])
def test_the_pack_pads_o_past_32_to_32_and_the_wide_product_to_16(o, op, cols):
    """The pack keeps make_pallas3's groups of 32 past 32 outputs; the exact
    mode's wide paths read its first ``product_cols`` (O rounded up to 16:
    144 at 133 and 136 joints)."""
    assert deform_conv.output_pad(o) == op
    if cols is not None:
        assert deform_conv.product_cols(o) == cols <= op
    gen = torch.Generator().manual_seed(o)
    weights, biases = torch.randn(2, o, 3, 3, 3, generator=gen), torch.randn(2, o, generator=gen)
    pk = deform_conv.pack_dcn_weights(weights, biases)
    assert pk.w.shape == (2, 3, 9, op) and pk.bias.shape == (op,)
    assert not pk.w[..., o:].any() and not pk.bias[o:].any()
    w, b = deform_conv.unpack(pk)
    assert torch.equal(w, weights) and torch.equal(b[0], biases.mean(0))


@pytest.mark.parametrize("d,o,launches,pallas3,backward", [
    (5, 17, 1, 1, 1), (8, 32, 1, 1, 1), (9, 17, 2, 2, 2), (5, 64, 1, 2, 1), (5, 133, 1, 5, 1),
    (9, 133, 2, 10, 2), (17, 32, 3, 3, 3), (17, 256, 8, 24, 4), (5, 289, 3, 10, 2),
    (8, 136, 2, 5, 2), (9, 300, 6, 20, 4)])
def test_one_sampling_for_every_output_past_32(d, o, launches, pallas3, backward):
    """The forward launches a group of 8 dilations; past 32 outputs the
    exact mode samples once for 144 of them, a launch a group of 5
    dilations and of 144 product columns, the make_pallas3 mode a launch a
    group of 8 dilations and of 32 outputs.  The backward launches a group
    of 8 dilations, of 5 past 32 outputs (no O groups), a pass a range of
    at most 288 outputs (two at 289 and 300).  The flagship's O = 17,
    D = 5 stays one launch a call; 133 joints too."""
    assert deform_conv.kernel_launches(d, o) == launches
    assert deform_conv.kernel_launches(d, o, deform_conv.EXACT) == launches
    assert deform_conv.kernel_launches(d, o, deform_conv.PALLAS3) == pallas3
    assert deform_conv.backward_launches(d, o) == backward


@pytest.mark.parametrize("o,ranges", [
    (1, [(0, 1)]), (133, [(0, 133)]), (288, [(0, 288)]), (289, [(0, 160), (160, 289)]),
    (300, [(0, 160), (160, 300)]), (576, [(0, 288), (288, 576)]),
    (577, [(0, 208), (208, 416), (416, 577)]), (1000, [(0, 256), (256, 512), (512, 768),
                                                       (768, 1000)])])
def test_the_backward_takes_outputs_past_288_in_ranges(o, ranges):
    """All O to 288 in one pass (the d W accumulators); past them as few
    ranges as hold O, each of the same whole 16-column tiles but the last,
    every one on the wide path."""
    got = deform_conv.backward_ranges(o)
    assert got == ranges
    assert got[0][0] == 0 and got[-1][1] == o and all(a[1] == b[0] for a, b in zip(got, got[1:]))
    assert len(got) == -(-o // deform_conv.MAX_BWD_OUTPUTS)
    assert all(deform_conv.product_cols(o1 - o0) <= deform_conv.MAX_BWD_OUTPUTS
               for o0, o1 in got)
    assert len({o1 - o0 for o0, o1 in got[:-1]}) <= 1
    assert all((o1 - o0) % deform_conv.PRODUCT_TILE == 0 for o0, o1 in got[:-1])
    assert len(got) == 1 or all(o1 - o0 > 32 for o0, o1 in got)


@pytest.mark.parametrize("o,dtype", [(289, torch.float32), (300, torch.float32),
                                     (289, torch.bfloat16)])
def test_the_backward_by_ranges_sums_to_the_whole(o, dtype):
    """``backward_by_ranges`` over the plain backward (the op's CPU
    implementation on each range's rows of g and columns of the pack)
    against the plain backward over all O: d W and d bias row for row, d x,
    d offset and d mask the ranges' f32 sums rounded once (1e-5 of each
    gradient's peak in f32; in bf16 one rounding of the sum, 1e-2)."""
    dilations = (1, 2)
    x, offs, masks, weights, biases, _ = dcn_case(1, 2, o, 6, 5, dilations, dtype,
                                                  torch.Generator().manual_seed(o), device="cpu",
                                                  reach=2)
    g = torch.from_numpy(np.random.RandomState(o).randn(1, o, 6, 5).astype(np.float32)).to(dtype)
    pk = deform_conv.pack_dcn_weights(weights, biases)
    runs = []

    def run(gr, xr, offr, mskr, pr, dils):
        runs.append((gr.dtype, xr.dtype, pr.o, pr.w.shape[-1]))
        return deform_conv.deform_conv_bwd_op(gr, xr, offr, mskr, pr.w, pr.bias,
                                              deform_conv.unpack(pr)[0],
                                              torch.zeros(pr.d, pr.o), list(dils), pr.o)

    got = deform_conv.backward_by_ranges(run, g, x, offs, masks, pk, dilations,
                                         deform_conv.backward_ranges(o))
    assert [r[2] for r in runs] == [b - a for a, b in deform_conv.backward_ranges(o)]
    assert all(r[:2] == (torch.float32, torch.float32) and r[3] == deform_conv.output_pad(r[2])
               for r in runs)
    want = deform_conv.deform_conv_bwd_op(g, x, offs, masks, pk.w, pk.bias, weights, biases,
                                          list(dilations), o)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, a, b in zip(("x", "offsets", "masks", "weights", "biases"), got, want):
        assert a.shape == b.shape, name
        assert a.dtype == (dtype if name in ("x", "offsets", "masks") else torch.float32), name
        peak = b.float().abs().max().item()
        assert peak > 0, name
        assert (a.float() - b.float()).abs().max().item() <= tol * peak, name


@pytest.mark.parametrize("split,c,d,slots", [
    (1, 17, 5, 0),      # one launch writes the output itself
    (19, 17, 5, 19),    # the flagship at B = 1: one slot a split
    (1, 17, 9, 2),      # two dilation groups, unsplit: a slot each
    (19, 17, 9, 36),    # 19 slots for the first group, 17 stages (17 slots) for the second
    (19, 2, 9, 18),     # 16 stages in the first group, 2 in the second
])
def test_partial_slots(split, c, d, slots):
    assert deform_conv.partial_slots(split, c, d) == slots


def test_the_exported_program_takes_33_joints_and_nine_dilations():
    from otpose_tpu_torch.engine.export import export_eval

    cfg, _ = _cfgs(33, NINE)
    cfg.MODEL.IMAGE_SIZE, cfg.MODEL.HEATMAP_SIZE = [32, 32], [8, 8]
    _, model = build_model(cfg, seed=1, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 32, 15).astype(np.float32))
    margin = torch.ones(2, 4)
    program = export_eval(model, batch_size=2, device="cpu").program.module()
    got = program(x, margin)
    want = make_decoded_eval_step(model)(x, margin)
    assert got[0].shape == (2, 33, 2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------- the gate

def test_the_predicates_mirror_the_kernels_limits():
    """The MLP: C padded to the mma depth within 1152 (both dtypes: the
    narrow kernels to 160, the wide ones past it); the attention: any C
    whose heads divide it (its wide path holds nothing per C on chip)."""
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        assert fused_mlp.supports(1152, dtype) and not fused_mlp.supports(1153, dtype)
        assert fused_mlp.supports(17, dtype) and not fused_mlp.supports(0, dtype)
        assert fused_attn.supports(160, 2, dtype) and fused_attn.supports(136, 8, dtype)
        assert fused_attn.supports(168, 8, dtype) and fused_attn.supports(1064, 8, dtype)
        assert not fused_attn.supports(136, 3, dtype)       # heads that do not divide C
    assert fused_attn.supports(136, 1, f32) and fused_attn.supports(137, 1, f32)
    assert fused_attn.supports(160, 1, bf16) and fused_attn.supports(144, 1, f32)
    assert not fused_mlp.supports(136, torch.float16)
    assert not fused_attn.supports(136, 8, torch.float16)


@pytest.mark.parametrize("c,n_head,ds,calls", [
    (136, 2, 1, (1, 1)),     # the flagship's temporal blocks: both kernels
    (168, 2, 1, (1, 1)),     # 21 joints: both, on their wide paths
    (1064, 2, 1, (1, 1)),    # 133 joints: both, on their wide paths
    (144, 1, 1, (1, 1)),     # one f32 head of 144: both, the attention's wide path
    (136, 2, 2, (0, 1)),     # a strided block: the MLP's alone, as before
    (17, 1, 1, (0, 0)),      # below 32 channels: neither, as before
])
def test_the_block_gate_follows_the_kernels(c, n_head, ds, calls):
    """The op calls of one eval block, f32, on the CPU (``calls`` counts the
    op on either device); the fused and the plain path give one result."""
    torch.manual_seed(c)
    blk = TransformerBlock(c, n_head, ds).eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0, 0.1)
    x = torch.randn(2, c, 24)
    before = profiling.counters()
    with torch.no_grad():
        got = blk(x)
    grown = profiling.since(before)
    assert (grown["fused_attn.calls"], grown["fused_mlp.calls"]) == calls
    with torch.no_grad():
        plain = blk(x, fused=False)
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-5)
