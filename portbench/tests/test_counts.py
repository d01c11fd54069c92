"""The benchmark's arithmetic against hand counts at tiny shapes, and the
model FLOPs against HRNet's published figure."""

from __future__ import annotations

import pytest
import torch

from portbench import counts, harness
from portbench.counts import flops


def test_fused_attn_counts_the_projections_and_the_weights():
    b, c, t, heads = 2, 8, 10, 2
    w = counts.fused_attn(b, c, t, heads, "bfloat16")
    # x in and out (2 bytes), three 8x8 projections in bf16, 3 biases, 3
    # depthwise (8 x 3), 3 LN pairs and ln1 in f32
    assert w.bytes == 2 * (2 * 8 * 10 * 2) + 3 * 64 * 2 + (24 + 72 + 48 + 16) * 4
    # projections 3 x 2 C^2 T B; scores and att @ v 2 x 2 C hs T B (hs = 4)
    assert w.product_ops == 3 * 2 * 64 * 10 * 2 + 2 * 2 * 8 * 4 * 10 * 2
    assert w.scalar_ops == 0
    assert w.least_s() == pytest.approx(max(w.bytes / 3.35e12, w.product_ops / 989e12))


def test_fused_mlp_counts_both_products_and_their_weights():
    w = counts.fused_mlp(1, 4, 3, "float32")
    assert w.bytes == 2 * 4 * 3 * 4 + 2 * 16 * 4 * 4 + (16 + 4 + 8) * 4
    assert w.product_ops == 2 * 2 * 4 * 16 * 3
    # f32 products as three TF32 passes
    assert w.least_s() == pytest.approx(max(w.bytes / 3.35e12, w.product_ops / (495e12 / 3)))


def test_deform_conv_counts():
    b, c, h, w_, d, o = 1, 2, 3, 4, 2, 5
    w = counts.deform_conv(b, c, h, w_, d, o, "bfloat16")
    p = 12
    assert w.bytes == (2 + 2 * 27 * 2 + 5) * p * 2 + 2 * 5 * (2 * 9 + 1) * 4
    samples = 2 * 9 * 2 * p
    assert (w.product_ops, w.scalar_ops) == (samples * 10, samples * 12)
    assert w.least_s() == pytest.approx(max(w.bytes / 3.35e12, w.product_ops / 989e12,
                                            w.scalar_ops / 67e12))


def test_deform_conv_bwd_counts():
    w = counts.deform_conv_bwd(1, 2, 3, 4, 2, 5, "float32")
    p = 12
    assert w.bytes == (2 * 2 * 27 * 2 + 2 * 2 + 5) * p * 4
    samples = 2 * 9 * 2 * p
    assert (w.product_ops, w.scalar_ops) == (samples * 20, samples * 32)


def test_flop_counter_counts_a_multiply_add_as_two():
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        x, wt = torch.empty(1, 3, 8, 8), torch.empty(4, 3, 3, 3)
    with FlopCounterMode(display=False) as fc:
        torch.nn.functional.conv2d(x, wt, padding=1)
    assert fc.get_total_flops() == 2 * (4 * 8 * 8) * (3 * 3 * 3)


def test_hrnet_w48_against_its_published_count():
    """HRNet-W48 at 384 x 288: 32.9 GFLOPs in Sun et al. (CVPR 2019, Table
    1), counted as multiply-adds; this count reads 35.31 G multiply-adds
    (70.61 GFLOPs at two a multiply-add), 7% above the table."""
    cfg = harness.load_json(harness.PACKAGE / "configs" / "otpose_w48_posetrack.json")["cfg"]
    macs = flops.hrnet_flops(cfg) / 2
    assert macs == pytest.approx(35.31e9, rel=1e-3)
    assert macs == pytest.approx(32.9e9, rel=0.08)


def test_step_flops_scale_with_the_batch():
    from portbench.tests.tiny import tiny_config

    cfg = tiny_config()["cfg"]
    one = flops.step_flops(cfg, 1, train=False)
    assert flops.step_flops(cfg, 3, train=False) == 3 * one
    # a train step counts the forward and a backward of about twice it
    assert 2.5 * one < flops.step_flops(cfg, 1, train=True) < 3.5 * one
