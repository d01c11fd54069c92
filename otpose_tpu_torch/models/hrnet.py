"""HRNet pose backbone (counterpart of ``otpose_tpu/models/hrnet.py``).

The same graph as the JAX ``hrnet_forward`` (ref: model/HRNet.py:57-250,
341-571): two stride-2 3x3 stem convs, Bottleneck x4 layer1, three
multi-branch stages with SUM fuse (nearest upsample / strided-conv
downsample) and a final conv to per-joint heatmaps at 1/4 resolution.
Module attribute names reproduce the reference ``state_dict`` keys.  The JAX
package merges convs that share an input into one wider conv; the channels
are independent, so here each conv runs on its own.  Activations are NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
from torch import nn

from otpose_tpu_torch.models.core import (BatchNorm, Conv2d, conv_bn, normal_, relu,
                                          upsample_nearest)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    num_modules: int
    num_branches: int
    block: str                      # 'BASIC' | 'BOTTLENECK'
    num_blocks: Tuple[int, ...]
    num_channels: Tuple[int, ...]   # post-expansion channels


@dataclasses.dataclass(frozen=True)
class HRNetSpec:
    stage2: StageSpec
    stage3: StageSpec
    stage4: StageSpec
    num_joints: int
    final_conv_kernel: int

    @staticmethod
    def from_cfg(cfg) -> "HRNetSpec":
        extra = cfg.MODEL.EXTRA

        def stage(node) -> StageSpec:
            expansion = 4 if node.BLOCK == "BOTTLENECK" else 1
            return StageSpec(
                num_modules=node.NUM_MODULES,
                num_branches=node.NUM_BRANCHES,
                block=node.BLOCK,
                num_blocks=tuple(node.NUM_BLOCKS),
                num_channels=tuple(c * expansion for c in node.NUM_CHANNELS),
            )

        return HRNetSpec(stage2=stage(extra.STAGE2), stage3=stage(extra.STAGE3),
                         stage4=stage(extra.STAGE4),
                         num_joints=cfg.MODEL.NUM_JOINTS,
                         final_conv_kernel=extra.FINAL_CONV_KERNEL)


class BasicBlock(nn.Module):
    """ref: model/HRNet.py:500-530."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.bn1 = BatchNorm(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.bn2 = BatchNorm(cout)
        self.downsample = conv_bn(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        out = relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x
        if self.downsample is not None:
            residual = self.downsample["1"](self.downsample["0"](x))
        return relu(out + residual)


class Bottleneck(nn.Module):
    """ref: model/HRNet.py:533-571."""

    def __init__(self, cin: int, planes: int):
        super().__init__()
        cout = planes * 4
        self.conv1 = Conv2d(cin, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, cout, 1)
        self.bn3 = BatchNorm(cout)
        self.downsample = conv_bn(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        out = relu(self.bn1(self.conv1(x)))
        out = relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x
        if self.downsample is not None:
            residual = self.downsample["1"](self.downsample["0"](x))
        return relu(out + residual)


def _branch(block: str, num_blocks: int, ch: int) -> nn.ModuleList:
    if block == "BOTTLENECK":
        return nn.ModuleList([Bottleneck(ch, ch // 4) for _ in range(num_blocks)])
    return nn.ModuleList([BasicBlock(ch, ch) for _ in range(num_blocks)])


class HRModule(nn.Module):
    """One HighResolutionModule (ref: model/HRNet.py:478-496)."""

    def __init__(self, spec: StageSpec, multi_scale_output: bool):
        super().__init__()
        nb, ch = spec.num_branches, spec.num_channels
        self.branches = nn.ModuleList([
            _branch(spec.block, spec.num_blocks[i], ch[i]) for i in range(nb)])
        self.num_out = nb if multi_scale_output else 1
        self.fuse_layers = None
        if nb == 1:
            return
        self.fuse_layers = nn.ModuleDict()
        for i in range(self.num_out):
            row = nn.ModuleDict()
            for j in range(nb):
                if j > i:
                    row[str(j)] = conv_bn(ch[j], ch[i], 1)
                elif j < i:
                    row[str(j)] = nn.ModuleDict({
                        str(k): conv_bn(ch[j], ch[i] if k == i - j - 1 else ch[j],
                                        3, stride=2, padding=1)
                        for k in range(i - j)})
            self.fuse_layers[str(i)] = row

    def forward(self, xs: List) -> List:
        xs = [self._run_branch(blocks, x) for blocks, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        out = []
        for i in range(self.num_out):
            y = None
            for j in range(len(xs)):   # the reference's accumulation order
                if j == i:
                    z = xs[j]
                elif j > i:
                    cb = self.fuse_layers[str(i)][str(j)]
                    z = upsample_nearest(cb["1"](cb["0"](xs[j])), 2 ** (j - i))
                else:
                    z = xs[j]
                    chain = self.fuse_layers[str(i)][str(j)]
                    for k in range(i - j):
                        z = chain[str(k)]["1"](chain[str(k)]["0"](z))
                        if k != i - j - 1:
                            z = relu(z)
                y = z if y is None else y + z
            out.append(relu(y))
        return out

    @staticmethod
    def _run_branch(blocks, x):
        for blk in blocks:
            x = blk(x)
        return x


def _transition(prev_ch, cur_ch) -> nn.ModuleDict:
    """Transitions feed the *last* branch into new branches (ref:
    model/HRNet.py:134-147); a channel change on an existing branch reads
    that branch, as the JAX package rebuilt it."""
    t = nn.ModuleDict()
    for i in range(len(cur_ch)):
        if i < len(prev_ch):
            if cur_ch[i] != prev_ch[i]:
                t[str(i)] = conv_bn(prev_ch[i], cur_ch[i], 3, padding=1)
        else:
            cin = prev_ch[-1]
            t[str(i)] = nn.ModuleDict({
                str(k): conv_bn(cin, cur_ch[i] if k == i - len(prev_ch) else cin,
                                3, stride=2, padding=1)
                for k in range(i + 1 - len(prev_ch))})
    return t


def _run_transition(t: nn.ModuleDict, ys: List, prev_n: int, cur_n: int) -> List:
    out = []
    for i in range(cur_n):
        if i < prev_n:
            if str(i) in t:
                out.append(relu(t[str(i)]["1"](t[str(i)]["0"](ys[i]))))
            else:
                out.append(ys[i])
        else:
            x = ys[-1]
            for k in range(len(t[str(i)])):
                cb = t[str(i)][str(k)]
                x = relu(cb["1"](cb["0"](x)))
            out.append(x)
    return out


class HRNet(nn.Module):
    """(N, 3, H, W) -> (N, num_joints, H/4, W/4) (ref: model/HRNet.py:116-152)."""

    def __init__(self, spec: HRNetSpec):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1)
        self.bn1 = BatchNorm(64)
        self.conv2 = Conv2d(64, 64, 3, stride=2, padding=1)
        self.bn2 = BatchNorm(64)
        self.layer1 = nn.ModuleList([Bottleneck(64 if b == 0 else 256, 64)
                                     for b in range(4)])
        s2, s3, s4 = spec.stage2, spec.stage3, spec.stage4
        self.transition1 = _transition([256], s2.num_channels)
        self.stage2 = nn.ModuleList([HRModule(s2, True) for _ in range(s2.num_modules)])
        self.transition2 = _transition(s2.num_channels, s3.num_channels)
        self.stage3 = nn.ModuleList([HRModule(s3, True) for _ in range(s3.num_modules)])
        self.transition3 = _transition(s3.num_channels, s4.num_channels)
        self.stage4 = nn.ModuleList([HRModule(s4, m != s4.num_modules - 1)
                                     for m in range(s4.num_modules)])
        k = spec.final_conv_kernel
        self.final_layer = Conv2d(s4.num_channels[0], spec.num_joints, k, bias=True,
                                  padding=1 if k == 3 else 0)

    def forward(self, x):
        x = relu(self.bn1(self.conv1(x)))
        x = relu(self.bn2(self.conv2(x)))
        for blk in self.layer1:
            x = blk(x)
        xs = [x]
        prev = 1
        for trans, stage in ((self.transition1, self.stage2),
                             (self.transition2, self.stage3),
                             (self.transition3, self.stage4)):
            cur = len(stage[0].branches)
            xs = _run_transition(trans, xs, prev, cur)
            for module in stage:
                xs = module(xs)
            prev = cur
        return self.final_layer(xs[0])


@torch.no_grad()
def init_hrnet_(model: HRNet, gen: torch.Generator) -> HRNet:
    """The reference init of a standalone HRNet, as the JAX ``init_hrnet``
    draws it (ref: model/OTPose.py:439-447): every conv normal std 0.001 drawn
    from ``gen`` on the CPU, ``final_layer``'s bias zero, BN 1 / 0."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            normal_(m.weight, gen, 0.001)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


def hrnet_forward(model: HRNet, x):
    """NHWC (B, H, W, 3) -> NHWC (B, H/4, W/4, J), the JAX layout."""
    return model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
