"""Residual Steps Network bottleneck blocks (counterpart of
``otpose_tpu/models/rsb.py``).

ref: model/RSB.py:10-139.  Each block expands to 4 branches of
``branch_ch = in_planes * 26 // 64`` channels, runs a cascade of 3x3 convs
with cross-branch additive connections, concatenates and projects back with
a residual.  The JAX package merges equal-depth convs into block-diagonal
pairs; the channels are independent, so here each conv runs on its own.
"""

from __future__ import annotations

import torch
from torch import nn

from otpose_tpu_torch.models.core import BatchNorm, Conv2d, relu

_CASCADE = ("2_1_1", "2_2_1", "2_2_2", "2_3_1", "2_3_2", "2_3_3",
            "2_4_1", "2_4_2", "2_4_3", "2_4_4")


class ConvBN(nn.Module):
    """conv (with bias) + BN (ref: model/RSB.py:106-139), then ReLU when
    ``has_relu``."""

    def __init__(self, cin: int, cout: int, kernel: int, has_relu: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, bias=True, padding=kernel // 2)
        self.bn = BatchNorm(cout)
        self.has_relu = has_relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return relu(y) if self.has_relu else y


class RSBBlock(nn.Module):
    """ref: model/RSB.py:77-103."""

    def __init__(self, in_planes: int, planes: int, has_downsample: bool):
        super().__init__()
        bc = self.branch_ch = in_planes * 26 // 64
        self.conv_bn_relu1 = ConvBN(in_planes, 4 * bc, 1)
        for name in _CASCADE:
            setattr(self, f"conv_bn_relu{name}", ConvBN(bc, bc, 3))
        self.conv_bn_relu3 = ConvBN(4 * bc, planes, 1, has_relu=False)
        self.downsample = ConvBN(in_planes, planes, 1, has_relu=False) if has_downsample else None

    def forward(self, x):
        out = self.conv_bn_relu1(x)
        residual = x if self.downsample is None else self.downsample(x)
        spx = torch.split(out, self.branch_ch, dim=1)
        cbr = lambda name, z: getattr(self, f"conv_bn_relu{name}")(z)  # noqa: E731
        out_1_1 = cbr("2_1_1", spx[0])
        out_2_1 = cbr("2_2_1", spx[1] + out_1_1)
        out_2_2 = cbr("2_2_2", out_2_1)
        out_3_1 = cbr("2_3_1", spx[2] + out_2_1)
        out_3_2 = cbr("2_3_2", out_3_1 + out_2_2)
        out_4_1 = cbr("2_4_1", spx[3] + out_3_1)
        out_3_3 = cbr("2_3_3", out_3_2)
        out_4_2 = cbr("2_4_2", out_4_1 + out_3_2)
        out_4_3 = cbr("2_4_3", out_4_2 + out_3_3)
        out_4_4 = cbr("2_4_4", out_4_3)
        out = self.conv_bn_relu3(torch.cat([out_1_1, out_2_2, out_3_3, out_4_4], dim=1))
        return relu(out + residual)


class RSBChain(nn.Module):
    """The JAX ``chain_rsb_blocks`` (ref: model/RSB.py:10-23): the 1x1
    downsample exists on block 0 even when in_planes == out_planes."""

    def __init__(self, in_planes: int, out_planes: int, num_blocks: int):
        super().__init__()
        self.layers = nn.ModuleList([
            RSBBlock(in_planes if i == 0 else out_planes, out_planes, i == 0)
            for i in range(num_blocks)])

    def forward(self, x):
        for blk in self.layers:
            x = blk(x)
        return x
