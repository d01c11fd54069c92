"""The plain reference of OTPose (arXiv 2207.09725), float32, one module
tree whose ``state_dict`` keys are the published PyTorch model's, as the
port's are.

HRNet (Sun et al., CVPR 2019) on the five frames batched together; the
occlusion sums; a flow encoder and two temporal encoders (conv
transformers over the 96 x 72 grid, channel attention, a conv MLP); two 1x1
heads; RSB blocks; per-dilation offset and mask convs and the modulated
deformable conv averaged over the dilations.  Every product goes through
``ops.operand``; no kernel, cache or batching of the program is used.

``calibrate=True`` on a forward in eval mode turns it into the benchmark's
weight calibration: each BN takes its input's statistics as its running
statistics, each encoder's block scales take half its input tokens'
deviation, each block's q and k projections are scaled to scores of
deviation ``SCORE_DEV``, HRNet's head and the deformable conv are scaled to
outputs of deviation 0.1 (with ``center``, each joint's heatmap also moved
to a mean of 0: a trained model's heatmaps vary about a background near 0,
and a decoded argmax then sees bf16 steps of the variation, not of an
offset 13 times larger), and the offset and mask convs are scaled to
deviations of 2 pixels and 1.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from portbench.reference import ops


@dataclasses.dataclass(frozen=True)
class Spec:
    """The sizes the model is built from (``from_config``)."""
    num_joints: int
    stages: Tuple[Tuple[int, int, Tuple[int, ...], Tuple[int, ...]], ...]
    final_conv_kernel: int
    pe_h: int
    pe_w: int
    dilations: Tuple[int, ...]
    def_ch: int
    rsb_blocks: int
    num_frames: int = 8
    scale_arch: Tuple[int, int, int] = (0, 6, 2)
    flow_scale_arch: Tuple[int, int, int] = (0, 6, 0)
    proj_pdrop: float = 0.1
    path_pdrop: float = 0.1

    @staticmethod
    def from_config(cfg: dict) -> "Spec":
        m = cfg["MODEL"]
        extra = m["EXTRA"]
        stages = tuple((s["NUM_MODULES"], s["NUM_BRANCHES"], tuple(s["NUM_BLOCKS"]),
                        tuple(s["NUM_CHANNELS"]))
                       for s in (extra["STAGE2"], extra["STAGE3"], extra["STAGE4"]))
        for s in (extra["STAGE2"], extra["STAGE3"], extra["STAGE4"]):
            if s["BLOCK"] != "BASIC" or s["FUSE_METHOD"] != "SUM":
                raise ValueError("the reference builds BASIC stages with SUM fusion")
        hm_w, hm_h = m["HEATMAP_SIZE"]
        return Spec(num_joints=m["NUM_JOINTS"], stages=stages,
                    final_conv_kernel=extra["FINAL_CONV_KERNEL"], pe_h=hm_h, pe_w=hm_w,
                    dilations=tuple(m["DEFORMABLE_CONV"]["DILATION"]),
                    def_ch=m["DEFORMABLE_CONV_CH"], rsb_blocks=m["OFFSET_MASK_COMBINE_CONV"],
                    scale_arch=tuple(extra.get("SCALE_ARCH", (0, 6, 2))),
                    flow_scale_arch=tuple(extra.get("FLOW_SCALE_ARCH", (0, 6, 0))))


# the deviation of the channel attention's scores after calibration: the
# program rounds the scores to its compute dtype before the softmax, where
# scores summed over 6912 tokens reach the hundreds a bf16 step moves a
# weight by e^0.5
SCORE_DEV = 1.0
# the running calibration of one forward (``calibrate=True``), else None
_calib: dict | None = None


def _rescale_(params, out, target: float, biases=()):
    """Scale ``params`` (a layer's weights and biases) so that ``out``, its
    output, has deviation ``target``, after moving each output channel's
    mean to 0 through ``biases`` (each of which adds to every output
    channel); returns the rescaled output."""
    with torch.no_grad():
        if biases:
            mean = out.mean(dim=(0, 2, 3))
            for b in biases:
                b.sub_(mean)
            out = out - mean[:, None, None]
        factor = target / out.std().clamp(min=1e-30)
        for p in params:
            p.mul_(factor)
    return out * factor


class Conv2d(nn.Module):
    def __init__(self, cin, cout, k, *, bias=False, stride=1, padding=0, dilation=1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation

    def forward(self, x):
        return ops.conv2d(x, self.weight, self.bias, stride=self.stride, padding=self.padding,
                          dilation=self.dilation)


class BatchNorm(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.pending = None

    def forward(self, x):
        if self.training:
            y, mean, var = ops.batch_norm_train(x, self.weight, self.bias, self.running_mean,
                                                self.running_var)
            self.pending = (mean, var)
            return y
        if _calib is not None:
            with torch.no_grad():
                self.running_mean.copy_(x.mean(dim=(0, 2, 3)))
                self.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))
        return ops.batch_norm_eval(x, self.weight, self.bias, self.running_mean,
                                   self.running_var)


@torch.no_grad()
def commit_bn_stats(model: nn.Module) -> None:
    for m in model.modules():
        if isinstance(m, BatchNorm) and m.pending is not None:
            m.running_mean.copy_(m.pending[0])
            m.running_var.copy_(m.pending[1])
            m.pending = None


class LayerNormCT(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(1, ch, 1))
        self.bias = nn.Parameter(torch.zeros(1, ch, 1))

    def forward(self, x):
        return ops.layer_norm_ct(x, self.weight, self.bias)


class Conv1d(nn.Module):
    def __init__(self, cin, cout, k, *, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class AffineScale(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1, ch, 1))


def conv_bn(cin, cout, k, **kw):
    return nn.ModuleDict({"0": Conv2d(cin, cout, k, **kw), "1": BatchNorm(cout)})


def _cb(cb, x):
    return cb["1"](cb["0"](x))


# --- HRNet -----------------------------------------------------------------

class BasicBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.bn1 = BatchNorm(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.bn2 = BatchNorm(cout)
        self.downsample = conv_bn(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        out = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        residual = x if self.downsample is None else _cb(self.downsample, x)
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes):
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
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else _cb(self.downsample, x)
        return torch.relu(out + residual)


class HRModule(nn.Module):
    def __init__(self, nb, blocks, ch, multi_scale_output):
        super().__init__()
        self.branches = nn.ModuleList([
            nn.ModuleList([BasicBlock(ch[i], ch[i]) for _ in range(blocks[i])])
            for i in range(nb)])
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
                        str(k): conv_bn(ch[j], ch[i] if k == i - j - 1 else ch[j], 3,
                                        stride=2, padding=1)
                        for k in range(i - j)})
            self.fuse_layers[str(i)] = row

    def forward(self, xs):
        outs = []
        for blocks, x in zip(self.branches, xs):
            for blk in blocks:
                x = blk(x)
            outs.append(x)
        if self.fuse_layers is None:
            return outs
        fused = []
        for i in range(self.num_out):
            y = None
            for j in range(len(outs)):
                if j == i:
                    z = outs[j]
                elif j > i:
                    z = ops.upsample_nearest(_cb(self.fuse_layers[str(i)][str(j)], outs[j]),
                                             2 ** (j - i))
                else:
                    z = outs[j]
                    chain = self.fuse_layers[str(i)][str(j)]
                    for k in range(i - j):
                        z = _cb(chain[str(k)], z)
                        if k != i - j - 1:
                            z = torch.relu(z)
                y = z if y is None else y + z
            fused.append(torch.relu(y))
        return fused


def _transition(prev_ch, cur_ch):
    t = nn.ModuleDict()
    for i in range(len(cur_ch)):
        if i < len(prev_ch):
            if cur_ch[i] != prev_ch[i]:
                t[str(i)] = conv_bn(prev_ch[i], cur_ch[i], 3, padding=1)
        else:
            cin = prev_ch[-1]
            t[str(i)] = nn.ModuleDict({
                str(k): conv_bn(cin, cur_ch[i] if k == i - len(prev_ch) else cin, 3,
                                stride=2, padding=1)
                for k in range(i + 1 - len(prev_ch))})
    return t


def _run_transition(t, ys, prev_n, cur_n):
    out = []
    for i in range(cur_n):
        if i < prev_n:
            out.append(torch.relu(_cb(t[str(i)], ys[i])) if str(i) in t else ys[i])
        else:
            x = ys[-1]
            for k in range(len(t[str(i)])):
                x = torch.relu(_cb(t[str(i)][str(k)], x))
            out.append(x)
    return out


class HRNet(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1)
        self.bn1 = BatchNorm(64)
        self.conv2 = Conv2d(64, 64, 3, stride=2, padding=1)
        self.bn2 = BatchNorm(64)
        self.layer1 = nn.ModuleList([Bottleneck(64 if b == 0 else 256, 64) for b in range(4)])
        (m2, n2, b2, c2), (m3, n3, b3, c3), (m4, n4, b4, c4) = spec.stages
        self.transition1 = _transition([256], c2)
        self.stage2 = nn.ModuleList([HRModule(n2, b2, c2, True) for _ in range(m2)])
        self.transition2 = _transition(c2, c3)
        self.stage3 = nn.ModuleList([HRModule(n3, b3, c3, True) for _ in range(m3)])
        self.transition3 = _transition(c3, c4)
        self.stage4 = nn.ModuleList([HRModule(n4, b4, c4, m != m4 - 1) for m in range(m4)])
        k = spec.final_conv_kernel
        self.final_layer = Conv2d(c4[0], spec.num_joints, k, bias=True,
                                  padding=1 if k == 3 else 0)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        for blk in self.layer1:
            x = blk(x)
        xs, prev = [x], 1
        for trans, stage in ((self.transition1, self.stage2), (self.transition2, self.stage3),
                             (self.transition3, self.stage4)):
            cur = len(stage[0].branches)
            xs = _run_transition(trans, xs, prev, cur)
            for module in stage:
                xs = module(xs)
            prev = cur
        out = self.final_layer(xs[0])
        if _calib is not None:
            out = _rescale_((self.final_layer.weight, self.final_layer.bias), out, 0.1,
                            (self.final_layer.bias,) if _calib["center"] else ())
        return out


# --- conv transformer --------------------------------------------------------

class MaskedMHCA(nn.Module):
    def __init__(self, c):
        super().__init__()
        for name in ("query", "key", "value"):
            setattr(self, f"{name}_conv", Conv1d(1, c, 3, bias=False))
            setattr(self, f"{name}_norm", LayerNormCT(c))
            setattr(self, name, Conv1d(c, c, 1))
        self.proj = Conv1d(c, c, 1)


class TransformerBlock(nn.Module):
    def __init__(self, c, n_head, ds_stride, path_pdrop, proj_pdrop):
        super().__init__()
        self.n_head, self.ds_stride = n_head, ds_stride
        self.path_pdrop, self.proj_pdrop = path_pdrop, proj_pdrop
        self.ln1 = LayerNormCT(c)
        self.ln2 = LayerNormCT(c)
        self.attn = MaskedMHCA(c)
        self.mlp = nn.ModuleDict({"0": Conv1d(c, 4 * c, 1), "3": Conv1d(4 * c, c, 1)})
        self.drop_path_attn = AffineScale(c) if path_pdrop > 0 else None
        self.drop_path_mlp = AffineScale(c) if path_pdrop > 0 else None

    def _path(self, scale_mod, x):
        if scale_mod is None:
            return x
        return ops.drop_path(x * scale_mod.scale, self.path_pdrop, self.training)

    @torch.no_grad()
    def _calibrate_scores(self, q, k):
        """Scale the q and k projections so that the channel attention's
        scores (summed over every token) have a deviation of
        ``SCORE_DEV``."""
        b, c, t = q.shape
        hs = c // self.n_head
        s = torch.matmul(q.reshape(b, self.n_head, hs, t), k.reshape(b, self.n_head, hs, t)
                         .transpose(-1, -2)) / hs ** 0.5
        factor = (SCORE_DEV / s.std().clamp(min=1e-30)) ** 0.5
        for lin in (self.attn.query, self.attn.key):
            lin.weight.mul_(factor)
            lin.bias.mul_(factor)
        return q * factor, k * factor

    def forward(self, x):
        ds, train = self.ds_stride, self.training
        drop = lambda t: ops.dropout(t, self.proj_pdrop, train)  # noqa: E731
        a = self.attn
        normed = self.ln1(x)
        q, k, v = (ops.dense_1x1_ct(norm(ops.depthwise_conv1d_k3_ct(normed, conv.weight,
                                                                    stride=ds)),
                                    lin.weight, lin.bias)
                   for conv, norm, lin in ((a.query_conv, a.query_norm, a.query),
                                           (a.key_conv, a.key_norm, a.key),
                                           (a.value_conv, a.value_norm, a.value)))
        if _calib is not None:
            q, k = self._calibrate_scores(q, k)
        pre = ops.channel_attention_ct(q, k, v, self.n_head)
        out = ops.dense_1x1_ct(ops.scramble(pre, self.n_head), a.proj.weight, a.proj.bias)
        skip = (torch.nn.functional.max_pool1d(x, ds + 1, ds, (ds + 1) // 2) if ds > 1 else x)
        out = skip + self._path(self.drop_path_attn, drop(out))
        h = self.ln2(out)
        h = drop(torch.nn.functional.gelu(ops.dense_1x1_ct(h, self.mlp["0"].weight,
                                                           self.mlp["0"].bias)))
        h = drop(ops.dense_1x1_ct(h, self.mlp["3"].weight, self.mlp["3"].bias))
        return out + self._path(self.drop_path_mlp, h)


class ConvTransformer(nn.Module):
    def __init__(self, n_in, n_embd, n_head, max_len, arch, proj_pdrop, path_pdrop):
        super().__init__()
        self.arch, self.max_len = arch, max_len
        self.embd = nn.ModuleList([Conv2d(n_in if i == 0 else n_embd, n_embd, 3, padding=1)
                                   for i in range(arch[0])])
        self.embd_norm = nn.ModuleList([LayerNormCT(n_embd) for _ in range(arch[0])])
        pe = ops.sinusoid_table(max_len, n_embd) / n_embd ** 0.5
        self.register_buffer("pos_embd", pe.to(torch.empty(()).device))   # the default device
        self.stem = nn.ModuleList([TransformerBlock(n_embd, n_head, 1, path_pdrop, proj_pdrop)
                                   for _ in range(arch[1])])
        self.branch = nn.ModuleList([TransformerBlock(n_embd, n_head, 2, path_pdrop,
                                                      proj_pdrop)
                                     for _ in range(arch[2])])

    def forward(self, x, upsample=True):
        b, _, h, w = x.shape
        t = h * w
        for conv, norm in zip(self.embd, self.embd_norm):
            x = torch.relu(norm(conv(x).reshape(b, -1, t)).reshape(b, -1, h, w))
        tokens = x.reshape(b, x.shape[1], t)
        pe = self.pos_embd
        if t >= self.max_len:
            pe = ops.upsample_linear_1d_ct(pe, t)
        tokens = tokens + pe
        if _calib is not None:
            with torch.no_grad():
                dev = 0.5 * tokens.std()
                for blk in list(self.stem) + list(self.branch):
                    for mod in (blk.drop_path_attn, blk.drop_path_mlp):
                        if mod is not None:
                            mod.scale.mul_(dev)
        for blk in self.stem:
            tokens = blk(tokens)
        feats = [tokens]
        for blk in self.branch:
            tokens = blk(tokens)
            feats.append(ops.upsample_linear_1d_ct(tokens, t) if upsample else tokens)
        return feats


# --- RSB ---------------------------------------------------------------------

_CASCADE = ("2_1_1", "2_2_1", "2_2_2", "2_3_1", "2_3_2", "2_3_3",
            "2_4_1", "2_4_2", "2_4_3", "2_4_4")


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, has_relu=True):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, bias=True, padding=k // 2)
        self.bn = BatchNorm(cout)
        self.has_relu = has_relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return torch.relu(y) if self.has_relu else y


class RSBBlock(nn.Module):
    def __init__(self, in_planes, planes, has_downsample):
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
        o11 = cbr("2_1_1", spx[0])
        o21 = cbr("2_2_1", spx[1] + o11)
        o22 = cbr("2_2_2", o21)
        o31 = cbr("2_3_1", spx[2] + o21)
        o32 = cbr("2_3_2", o31 + o22)
        o41 = cbr("2_4_1", spx[3] + o31)
        o33 = cbr("2_3_3", o32)
        o42 = cbr("2_4_2", o41 + o32)
        o43 = cbr("2_4_3", o42 + o33)
        o44 = cbr("2_4_4", o43)
        out = self.conv_bn_relu3(torch.cat([o11, o22, o33, o44], dim=1))
        return torch.relu(out + residual)


class RSBChain(nn.Module):
    def __init__(self, in_planes, out_planes, num_blocks):
        super().__init__()
        self.layers = nn.ModuleList([RSBBlock(in_planes if i == 0 else out_planes, out_planes,
                                              i == 0) for i in range(num_blocks)])

    def forward(self, x):
        for blk in self.layers:
            x = blk(x)
        return x


# --- OTPose ------------------------------------------------------------------

class DeformConvParams(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))


class OTPose(nn.Module):
    def __init__(self, spec: Spec):
        super().__init__()
        self.spec = spec
        j = spec.num_joints
        d = j * spec.num_frames
        t = spec.pe_h * spec.pe_w
        self.rough_pose_estimation_net = HRNet(spec)
        self.temporal_encoder1 = ConvTransformer(d, d, 2, t, spec.scale_arch, spec.proj_pdrop,
                                                 spec.path_pdrop)
        self.temporal_encoder2 = ConvTransformer(d, d, 2, t, spec.scale_arch, spec.proj_pdrop,
                                                 spec.path_pdrop)
        self.flow_encoder = ConvTransformer(j, j, 1, t, spec.flow_scale_arch, spec.proj_pdrop,
                                            spec.path_pdrop)
        k = spec.final_conv_kernel
        pad = 1 if k == 3 else 0
        self.final_layer1 = Conv2d(d * (spec.scale_arch[-1] + 1), j, k, bias=True, padding=pad)
        self.final_layer2 = Conv2d(d * (spec.scale_arch[-1] + 1), j, k, bias=True, padding=pad)
        self.def_fuse = RSBChain(j, j, spec.rsb_blocks)
        self.offset_mask_combine_conv = RSBChain(3 * j, spec.def_ch, spec.rsb_blocks)
        self.offsets_list = nn.ModuleList([
            nn.ModuleDict({"0": Conv2d(spec.def_ch, 18 * j, 3, padding=dil, dilation=dil)})
            for dil in spec.dilations])
        self.masks_list = nn.ModuleList([
            nn.ModuleDict({"0": Conv2d(spec.def_ch, 9 * j, 3, padding=dil, dilation=dil)})
            for dil in spec.dilations])
        self.modulated_deform_conv_list = nn.ModuleList([
            nn.ModuleDict({"deform_conv": DeformConvParams(j, j)}) for _ in spec.dilations])


def _head(conv: Conv2d, feats, h, w):
    """The 1x1 head over the stacked encoder scales (or a k x k conv)."""
    if conv.weight.shape[-1] != 1:
        b = feats[0].shape[0]
        stacked = torch.stack([ops.upsample_linear_1d_ct(f, h * w) for f in feats], dim=1)
        return conv(stacked.reshape(b, -1, h, w))
    wt = conv.weight[:, :, 0, 0]
    c = feats[0].shape[1]
    y = None
    for s, f in enumerate(feats):
        ys = ops.upsample_linear_1d_ct(ops.matmul(wt[:, s * c:(s + 1) * c], f), h * w)
        y = ys if y is None else y + ys
    y = y + conv.bias[:, None]
    return y.reshape(y.shape[0], -1, h, w)


def forward(model: OTPose, x, margin, calibrate: bool = False, center: bool = False):
    """x (B, H, W, 15) five RGB frames (current, prev, next, pprev, nnext),
    margin (B, 4) -> (heatmaps (B, J, h, w), rough heatmaps of the five
    frames (5B, J, h, w), intersection, context encoding), float32 NCHW."""
    global _calib
    _calib = {"center": center} if calibrate else None
    try:
        return _forward(model, x.float(), margin.float())
    finally:
        _calib = None


def _forward(model, x, margin):
    spec = model.spec
    b, j = x.shape[0], spec.num_joints
    frames = torch.cat(torch.split(x.permute(0, 3, 1, 2), 3, dim=1), dim=0).contiguous()
    rough = model.rough_pose_estimation_net(frames)
    h, w = rough.shape[2:]
    cur, prev, nxt, pprev, nnext = torch.split(rough, b, dim=0)
    total_b = cur + prev + nxt + pprev + nnext
    squeezed = total_b.sum(dim=1, keepdim=True).expand_as(total_b)
    intersection = total_b * squeezed

    def to_map(feats):
        return torch.stack(feats, dim=1).reshape(b, -1, h, w)

    context = to_map(model.flow_encoder(total_b))
    prev = prev / (margin[:, 0] + 1)[:, None, None, None]
    nxt = nxt / (margin[:, 1] + 1)[:, None, None, None]
    pprev = pprev / (margin[:, 2] + 1)[:, None, None, None]
    nnext = nnext / (margin[:, 3] + 1)[:, None, None, None]
    prev_b, next_b = cur + (prev + pprev), cur + (nxt + nnext)
    close_b, far_b = cur + (nxt + prev), cur + (nnext + pprev)

    def stack8(feats):
        return torch.stack(feats, dim=2).reshape(b, j * spec.num_frames, h, w)

    x1 = stack8([intersection, context, prev_b, far_b, close_b, prev_b * squeezed,
                 far_b * squeezed, close_b * squeezed])
    x2 = stack8([intersection, context, next_b, close_b, far_b, next_b * squeezed,
                 close_b * squeezed, far_b * squeezed])
    one = spec.final_conv_kernel == 1
    y1 = _head(model.final_layer1, model.temporal_encoder1(x1, upsample=not one), h, w)
    y2 = _head(model.final_layer2, model.temporal_encoder2(x2, upsample=not one), h, w)
    def_heatmaps = model.def_fuse(total_b)
    trans = model.offset_mask_combine_conv(torch.cat([y1, y2, def_heatmaps], dim=1))
    offsets, masks = [], []
    for key, convs, out, target in (("offsets", model.offsets_list, offsets, 2.0),
                                    ("masks", model.masks_list, masks, 1.0)):
        for m in convs:
            y = m["0"](trans)
            if _calib is not None:
                y = _rescale_((m["0"].weight,), y, target)
            out.append(y)
    dcn = [m["deform_conv"] for m in model.modulated_deform_conv_list]
    weights = torch.stack([m.weight for m in dcn])
    biases = torch.stack([m.bias for m in dcn])
    output = ops.modulated_deform_conv_multi(def_heatmaps, offsets, masks, weights, biases,
                                             spec.dilations)
    if _calib is not None:
        output = _rescale_([p for m in dcn for p in (m.weight, m.bias)], output, 0.1,
                           [m.bias for m in dcn] if _calib["center"] else ())
    return output, rough, intersection, context
