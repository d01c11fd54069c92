"""OTPose over a ViTPose estimator (``models/vit.py``) against the plain
float32 reference (``tests/helpers/plain_vitpose.py``) on the CPU at a tiny
size: width 64, depth 2, 4 heads, a 64x48 crop (4 x 3 tokens), 16x12
heatmaps, weights drawn and calibrated by the benchmark's
``kinds/eval_vitpose.py::make_reference`` (its heatmaps have peaks and the
DCN samples inside the image), f32.

Bars: each component (the backbone's tokens, the decoder's heatmaps) within
1e-5 of its peak, the 7-tuple's tensors within 1e-3 of theirs, every
gradient of one train-mode forward and backward within 1e-3 of its peak.

The ``cuda``-marked case (the ViT stage's CUDA graph replay bit-equal to its
eager run) needs a card; on one, without the repository's conftest:

    python -m pytest tests/test_torch_vitpose.py -q -m cuda --noconftest
"""

from __future__ import annotations

import copy

import pytest
import torch

from otpose_tpu_torch.models.blocks import set_drop_rates
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.otpose import OTPose, otpose_forward, prepare_eval_params
from otpose_tpu_torch.utils import profiling
from otpose_tpu_torch.utils.testing import (loss_gradients, tiny_otpose_cfg,
                                            tiny_vitpose_cfg, vitpose_extra)
from portbench import weights
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.kinds import eval_vitpose

SEED = 20240611


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _plain():
    """The plain reference module, imported where a test needs it: on a
    machine with the card the suite runs without the repository's conftest,
    where another package's ``tests`` may come first on the path."""
    from tests.helpers import plain_vitpose

    return plain_vitpose


@pytest.fixture(scope="module")
def tiny():
    """(cfg, the port's model, the plain reference, clips, margins), both
    models holding the same calibrated weights, in eval mode."""
    cfg = tiny_vitpose_cfg()
    state = eval_vitpose.make_reference(cfg.to_dict(), SEED, "cpu", center=True).state_dict()
    _, model = build_model(cfg, device="cpu")
    model.load_state_dict(state, strict=True)
    plain = _plain().PlainOTPose(cfg.to_dict())
    plain.load_state_dict(state, strict=True)
    x, margin = weights.clips(cfg.to_dict(), 2, weights.generator(SEED, "clips", "cpu"), "cpu")
    return cfg, model.eval(), plain.eval(), x, margin


def _frames(x):
    return torch.cat(torch.split(x.permute(0, 3, 1, 2), 3, dim=1), dim=0).contiguous()


def _gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _vitpose_names(depth: int) -> set:
    names = {"backbone.pos_embed", "backbone.patch_embed.proj.weight",
             "backbone.patch_embed.proj.bias", "backbone.last_norm.weight",
             "backbone.last_norm.bias", "keypoint_head.final_layer.weight",
             "keypoint_head.final_layer.bias", "keypoint_head.deconv_layers.0.weight",
             "keypoint_head.deconv_layers.3.weight"}
    for i in (1, 4):
        names |= {f"keypoint_head.deconv_layers.{i}.{k}"
                  for k in ("weight", "bias", "running_mean", "running_var")}
    for i in range(depth):
        names |= {f"backbone.blocks.{i}.{m}.{k}" for k in ("weight", "bias")
                  for m in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2")}
    return names


@pytest.mark.parametrize("size", ["tiny", "vitpose_h"])
def test_state_dict_keys_are_vitposes(size):
    cfg = tiny_vitpose_cfg()
    if size == "vitpose_h":
        cfg.MODEL.IMAGE_SIZE, cfg.MODEL.HEATMAP_SIZE = [192, 256], [48, 64]
        for key, value in vitpose_extra().items():
            cfg.MODEL.EXTRA[key] = value
    from otpose_tpu_torch.models.otpose import OTPoseSpec

    with torch.device("meta"):
        model = OTPose(OTPoseSpec.from_cfg(cfg))
    est = {k[len("rough_pose_estimation_net."):]: v.shape for k, v in model.state_dict().items()
           if k.startswith("rough_pose_estimation_net.")}
    depth = cfg.MODEL.EXTRA.VIT.DEPTH
    assert set(est) == _vitpose_names(depth)
    c = cfg.MODEL.EXTRA.VIT.EMBED_DIM
    tokens = (cfg.MODEL.IMAGE_SIZE[0] // 16) * (cfg.MODEL.IMAGE_SIZE[1] // 16)
    assert est["backbone.pos_embed"] == (1, tokens + 1, c)
    assert est["backbone.blocks.0.attn.qkv.weight"] == (3 * c, c)
    assert est["backbone.blocks.0.mlp.fc1.weight"] == (4 * c, c)
    assert est["keypoint_head.deconv_layers.0.weight"][:2] == (c, cfg.MODEL.EXTRA.VIT
                                                                .NUM_DECONV_FILTERS[0])
    if size == "vitpose_h":
        products = sum(est[f"backbone.blocks.{i}.{m}.weight"].numel() for i in range(depth)
                       for m in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"))
        assert (tokens, products) == (192, 32 * 12 * 1280 ** 2)


@pytest.mark.parametrize("part", ["backbone", "keypoint_head"])
def test_components_match_the_plain_reference(tiny, part):
    cfg, model, plain, x, _ = tiny
    port_net = model.rough_pose_estimation_net
    plain_net = plain.rough_pose_estimation_net
    frames = _frames(x)
    with torch.no_grad():
        feats = plain_net.backbone(frames)
        if part == "backbone":
            got, want = port_net.backbone(frames), feats
        else:
            got, want = port_net.keypoint_head(feats), plain_net.keypoint_head(feats)
    assert got.shape == want.shape
    assert _gap(got, want) <= 1e-5


def test_tokens_are_token_major_in_memory(tiny):
    """Every block reads (N, T, C) tokens laid out token-major: a transposed
    layout would make each LN copy its input and each residual add run
    strided (about a third of the ViT's device time on the card)."""
    _, model, _, x, _ = tiny
    seen = []
    hooks = [blk.register_forward_pre_hook(lambda _m, args: seen.append(args[0].is_contiguous()))
             for blk in model.rough_pose_estimation_net.backbone.blocks]
    try:
        with torch.no_grad():
            model.rough_pose_estimation_net(_frames(x))
    finally:
        for h in hooks:
            h.remove()
    assert seen == [True] * len(hooks)


def test_forward_seven_tuple_matches_the_plain_reference(tiny):
    _, model, plain, x, margin = tiny
    with torch.no_grad():
        got = otpose_forward(model, x, margin)
        want = _plain().forward7(plain, x, margin)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _gap(g, w) <= 1e-3


def test_decoded_eval_step_keypoints_match_the_plain_reference(tiny):
    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step

    _, model, plain, x, margin = tiny
    coords, maxvals, raw = make_decoded_eval_step(model)(x, margin)
    with torch.no_grad():
        heat = _plain().forward7(plain, x, margin)[0].permute(0, 3, 1, 2)
    want_coords, want_max, want_raw = ref_train.decode(heat)
    assert torch.equal(raw, want_raw) and torch.equal(coords, want_coords)
    assert torch.allclose(maxvals, want_max, rtol=1e-5, atol=0)


def _train_batch(cfg, x, margin):
    gen = weights.generator(SEED, "targets", "cpu")
    target, weight = weights.targets(cfg.to_dict(), x.shape[0], 0.6, gen, "cpu")
    return {"inputs": x, "margin": margin, "target": target, "target_weight": weight}


def _no_head_dropout(tiny):
    """The port's model and the plain reference at the tiny weights with the
    head's dropout off (its draws come in another order on each side); the
    ViT's drop-path stays on (the same draws in the same order)."""
    cfg, model, plain, _, _ = tiny
    port = set_drop_rates(copy.deepcopy(model))
    ref = _plain().PlainOTPose(cfg.to_dict())
    ref.load_state_dict(plain.state_dict(), strict=True)
    for m in ref.modules():
        if isinstance(m, ref_model.TransformerBlock):
            m.proj_pdrop = m.path_pdrop = 0.0
    return port, ref


def test_train_forward_and_backward_match_the_plain_autograd(tiny):
    cfg, _, _, x, margin = tiny
    port, ref = _no_head_dropout(tiny)
    batch = _train_batch(cfg, x, margin)
    torch.manual_seed(7)
    loss, _, grads = loss_gradients(port, batch)
    ref.train()
    torch.manual_seed(7)
    with _plain().exact_f32():
        want = ref_train.loss(ref, batch, cfg.LOSS.TOPK)
        want.backward()
    assert abs(loss - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
    ref_grads = {n: p.grad for n, p in ref.named_parameters()}
    assert set(grads) == set(ref_grads)
    # a conv bias in front of a train-mode BN has a gradient of exactly 0 (the
    # BN takes the mean out): both sides hold round-off there, ~1e-9, under
    # 1e-7 of the largest gradient; every other leaf is held to its peak
    largest = max(float(w.abs().max()) for w in ref_grads.values())
    compared = 0
    for name, g in grads.items():
        w = ref_grads[name]
        if float(w.abs().max()) < 1e-7 * largest:
            assert float(g.abs().max()) < 1e-7 * largest, name
            continue
        assert _gap(g, w) <= 1e-3, name
        compared += 1
    assert compared >= 0.9 * len(grads)
    # the estimator is trained: its gradients reach the patch embedding
    assert grads["rough_pose_estimation_net.backbone.patch_embed.proj.weight"].abs().max() > 0


def test_train_step_runs_over_the_vit(tiny):
    from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
    from otpose_tpu_torch.engine.trainer import make_train_step

    cfg, _, _, x, margin = tiny
    port, ref = _no_head_dropout(tiny)
    batch = _train_batch(cfg, x, margin)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = make_optimizer(port, cfg, make_schedule(cfg, 10))
    opt.load_state_dict({"opt": opt.opt.state_dict(), "count": 5})
    step = make_train_step(port, opt, generator=torch.Generator().manual_seed(3))
    metrics = step(batch)
    ref.train()
    with _plain().exact_f32(), torch.no_grad(), \
            ref_train.ops.use_generator(torch.Generator().manual_seed(3)):
        want = float(ref_train.loss(ref, batch, cfg.LOSS.TOPK))
    assert abs(float(metrics["final_loss"]) - want) <= 1e-5 * abs(want)
    moved = [n for n, p in port.named_parameters() if not torch.equal(p, before[n])]
    assert all(torch.isfinite(p).all() for p in port.parameters())
    assert "rough_pose_estimation_net.backbone.blocks.1.mlp.fc2.weight" in moved
    assert "rough_pose_estimation_net.keypoint_head.deconv_layers.3.weight" in moved


def test_bf16_eval_cast_rule(tiny):
    cfg, model, _, x, margin = tiny
    cast = prepare_eval_params(copy.deepcopy(model), torch.bfloat16)
    dtypes = {n: p.dtype for n, p in cast.named_parameters()
              if n.startswith("rough_pose_estimation_net.")}
    pre = "rough_pose_estimation_net."
    bf16 = {f"{pre}backbone.patch_embed.proj.weight", f"{pre}backbone.blocks.0.attn.qkv.weight",
            f"{pre}backbone.blocks.1.mlp.fc2.weight", f"{pre}keypoint_head.deconv_layers.0.weight",
            f"{pre}keypoint_head.final_layer.weight"}
    f32 = {f"{pre}backbone.pos_embed", f"{pre}backbone.blocks.0.norm1.weight",
           f"{pre}backbone.last_norm.bias", f"{pre}backbone.blocks.0.attn.qkv.bias",
           f"{pre}keypoint_head.deconv_layers.1.weight"}
    assert all(dtypes[n] == torch.bfloat16 for n in bf16)
    assert all(dtypes[n] == torch.float32 for n in f32)
    # every >= 2-D weight but pos_embed is cast; every 1-D one stays
    for n, p in cast.named_parameters():
        if n.startswith(pre):
            want = torch.bfloat16 if p.dim() >= 2 and not n.endswith("pos_embed") else torch.float32
            assert p.dtype == want, n
    with torch.no_grad():
        out = otpose_forward(cast, x, margin, compute_dtype=torch.bfloat16)
    assert all(torch.isfinite(t.float()).all() for t in out)


def test_eval_step_spans_and_counters(tiny):
    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step

    cfg, model, _, x, margin = tiny
    make_decoded_eval_step(model)(x, margin)
    rec = profiling.records()[-1]
    names = {s[0] for s in rec.spans}
    assert "otpose.model.vit" in names and "otpose.model.hrnet" not in names
    frames = 5 * x.shape[0]
    assert rec.counters["vit.frames"] == frames
    assert rec.counters["vit.tokens"] == frames * 4 * 3
    assert rec.counters["vit.attn.math"] == cfg.MODEL.EXTRA.VIT.DEPTH


def test_hrnet_configuration_builds_names_and_runs_as_before():
    """An HRNet configuration: the published reference's keys, HRNet's span,
    no ViT counter, and the plain reference's forward."""
    cfg = tiny_otpose_cfg()
    ref = weights.make_reference(cfg.to_dict(), SEED, "cpu")
    spec, model = build_model(cfg, device="cpu")
    assert set(model.state_dict()) == set(ref.state_dict())
    assert model.estimator_span == "otpose.model.hrnet" and model.frame_tokens == 0
    assert type(model.rough_pose_estimation_net).__name__ == "HRNet"
    model.load_state_dict(ref.state_dict(), strict=True)
    x, m = weights.clips(cfg.to_dict(), 2, weights.generator(SEED, "clips", "cpu"), "cpu")
    before = profiling.counters()
    with torch.no_grad(), profiling.step("otpose.test.step"):
        got = otpose_forward(model, x, m, fused=False)
        want = ref_model.forward(ref.eval(), x, m)
    rec = profiling.records()[-1]
    assert "otpose.model.hrnet" in {s[0] for s in rec.spans}
    assert not any(k.startswith("vit.") for k in profiling.since(before))
    for g, w in zip((got[0], got[1], got[2], got[4]), want):
        assert _gap(g.permute(0, 3, 1, 2), w) <= 1e-4


def test_cli_config_path_builds_the_tiny_variant():
    import pathlib

    from otpose_tpu_torch.config import default_parse_args, setup

    yaml = pathlib.Path(__file__).resolve().parents[1] / "configs/18/model_ViTPoseH.yaml"
    args = default_parse_args(["--cfg", str(yaml), "--device", "cpu",
                               "MODEL.IMAGE_SIZE", "[48, 64]", "MODEL.HEATMAP_SIZE", "[12, 16]",
                               "MODEL.EXTRA.VIT.EMBED_DIM", "64", "MODEL.EXTRA.VIT.DEPTH", "2",
                               "MODEL.EXTRA.VIT.NUM_HEADS", "4",
                               "MODEL.EXTRA.VIT.NUM_DECONV_FILTERS", "[32, 32]"])
    cfg = setup(args)
    assert cfg.MODEL.NAME == "OTPose" and cfg.MODEL.EXTRA.ESTIMATOR == "vitpose"
    spec, model = build_model(cfg, device="cpu")
    assert spec.estimator.grid == (4, 3) and (spec.pe_h, spec.pe_w) == (16, 12)
    # published sizes everywhere else: the ViT's MLP ratio, OTPose's encoders
    assert spec.estimator.mlp_ratio == 4 and spec.temporal_encoding_dim == 136
    x = torch.randn(1, 64, 48, 15)
    with torch.no_grad():
        out = model(x, torch.ones(1, 4))
    assert out[0].shape == (1, 16, 12, 17)


@pytest.mark.cuda
def test_vit_stage_graph_replay_is_bit_equal_to_eager():
    """At ViTPose-H's widths (two of its 32 blocks), bf16, two clips: the
    eval steps' ``BackboneGraph`` replays the ViT bit-equal to its eager run,
    on the flash backend."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused attention backends run only there")
    from otpose_tpu_torch.engine.graphs import BackboneGraph
    from otpose_tpu_torch.models.otpose import run_hrnet

    cfg = tiny_vitpose_cfg()
    cfg.MODEL.IMAGE_SIZE, cfg.MODEL.HEATMAP_SIZE = [192, 256], [48, 64]
    for key, value in vitpose_extra(depth=2).items():
        cfg.MODEL.EXTRA[key] = value
    _, model = build_model(cfg, device="cuda")
    prepare_eval_params(model, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = [torch.randn(10, 3, 256, 192, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2)]
    runner = BackboneGraph(model)
    before = profiling.counters()
    with torch.inference_mode():
        eager = [run_hrnet(model, f).clone() for f in frames]
        got = [runner(frames[0]).clone()]          # eager, warms
        got += [runner(f).clone() for f in frames]  # captures, replays
    grew = profiling.since(before)
    assert grew["hrnet_graph.captures"] == 1 and grew["hrnet_graph.replays"] == 2
    assert grew["vit.attn.flash"] > 0 and "vit.attn.math" not in grew
    assert torch.equal(got[0], eager[0])
    assert torch.equal(got[1], eager[0]) and torch.equal(got[2], eager[1])
