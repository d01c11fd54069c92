"""The plain reference of OTPose over ViTPose, float32: the benchmark's copy
(the tests hold it to ``tests/helpers/plain_vitpose.py``).

ViTPose (Xu et al., NeurIPS 2022, arXiv 2204.12484;
``ViTPose_huge_coco_256x192.py``) in place of HRNet; OTPose's head and
``forward`` are ``reference/model.py``'s, which call
``rough_pose_estimation_net`` on the five frames batched together.

- ``backbone.patch_embed.proj``: Conv2d(3, C, k=P, stride=P, padding=2)
  with bias; ``x + pos_embed[:, 1:] + pos_embed[:, :1]`` (no class token);
- ``backbone.blocks.<i>``: ``x + Attn(LN1(x))``, ``x + MLP(LN2(x))``, LN eps
  1e-6; ``qkv`` Linear(C, 3C), softmax(q k^T / sqrt(d)) v written out,
  ``proj``; ``fc1``, erf GELU, ``fc2``; drop-path linear over depth, in
  training only;
- ``backbone.last_norm``, the tokens as a (N, C, H / P, W / P) map;
- ``keypoint_head``: per layer ConvTranspose2d(k=4, stride=2, padding=1,
  bias=False), BN, ReLU (``deconv_layers.<3i>``, ``.<3i + 1>``), then
  ``final_layer``, a 1x1 conv with bias.

Every product takes its operands through ``ops.operand`` (fp8 in the
control).  ``kinds/eval_vitpose.py::make_reference`` draws the weights; with
``calibrate=True`` (``reference/model.py::forward``) the decoder's BNs take
their input's statistics and ``final_layer`` is scaled to outputs of
deviation 0.1 (``center``: each joint's mean moved to 0), as HRNet's head
is.  No departure from the published models beyond the
pairing, which is assumed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import model as ref_model
from portbench.reference import ops

LN_EPS = 1e-6
PATCH_PADDING = 2


class ViTSpec:
    """The ViT and decoder sizes of a configuration's ``MODEL.EXTRA.VIT``."""

    def __init__(self, cfg: dict):
        m = cfg["MODEL"]
        v = m["EXTRA"]["VIT"]
        self.image_w, self.image_h = m["IMAGE_SIZE"]
        self.patch, self.dim, self.depth = v["PATCH_SIZE"], v["EMBED_DIM"], v["DEPTH"]
        self.heads, self.mlp_ratio = v["NUM_HEADS"], v["MLP_RATIO"]
        self.qkv_bias, self.drop_path_rate = v["QKV_BIAS"], v["DROP_PATH_RATE"]
        self.filters, self.kernels = v["NUM_DECONV_FILTERS"], v["NUM_DECONV_KERNELS"]
        self.final_kernel, self.joints = v["FINAL_CONV_KERNEL"], m["NUM_JOINTS"]
        if any(k != 4 for k in self.kernels):
            raise ValueError("the reference builds 4x4 deconvs (ViTPose's)")

    @property
    def tokens(self) -> int:
        """Tokens a frame: the patch embedding's output."""
        rows = (self.image_h + 2 * PATCH_PADDING - self.patch) // self.patch + 1
        cols = (self.image_w + 2 * PATCH_PADDING - self.patch) // self.patch + 1
        return rows * cols


class LayerNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        mu = x.mean(dim=-1, keepdim=True)
        res = x - mu
        var = (res * res).mean(dim=-1, keepdim=True)
        return res / torch.sqrt(var + LN_EPS) * self.weight + self.bias


class Linear(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        y = ops.matmul(x, self.weight.t())
        return y if self.bias is None else y + self.bias


class Attention(nn.Module):
    def __init__(self, c, heads, qkv_bias):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(c, 3 * c, qkv_bias)
        self.proj = Linear(c, c)

    def forward(self, x):
        n, t, c = x.shape
        d = c // self.heads
        q, k, v = self.qkv(x).reshape(n, t, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        att = torch.softmax(ops.matmul(q, k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
        return self.proj(ops.matmul(att, v).transpose(1, 2).reshape(n, t, c))


class Mlp(nn.Module):
    def __init__(self, c, hidden):
        super().__init__()
        self.fc1 = Linear(c, hidden)
        self.fc2 = Linear(hidden, c)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, s: ViTSpec, rate: float):
        super().__init__()
        self.rate = rate
        self.norm1 = LayerNorm(s.dim)
        self.attn = Attention(s.dim, s.heads, s.qkv_bias)
        self.norm2 = LayerNorm(s.dim)
        self.mlp = Mlp(s.dim, s.dim * s.mlp_ratio)

    def forward(self, x):
        x = x + ops.drop_path(self.attn(self.norm1(x)), self.rate, self.training)
        return x + ops.drop_path(self.mlp(self.norm2(x)), self.rate, self.training)


class PatchEmbed(nn.Module):
    def __init__(self, s: ViTSpec):
        super().__init__()
        self.proj = ref_model.Conv2d(3, s.dim, s.patch, bias=True, stride=s.patch,
                                     padding=PATCH_PADDING)


class ViT(nn.Module):
    def __init__(self, s: ViTSpec):
        super().__init__()
        self.patch_embed = PatchEmbed(s)
        patches = (s.image_h // s.patch) * (s.image_w // s.patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, patches + 1, s.dim))
        rates = torch.linspace(0, s.drop_path_rate, s.depth, device="cpu").tolist()
        self.blocks = nn.ModuleList([Block(s, r) for r in rates])
        self.last_norm = LayerNorm(s.dim)

    def forward(self, x):
        x = self.patch_embed.proj(x)
        n, c, hp, wp = x.shape
        x = x.reshape(n, c, hp * wp).transpose(1, 2)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for blk in self.blocks:
            x = blk(x)
        return self.last_norm(x).transpose(1, 2).reshape(n, c, hp, wp)


class ConvTranspose2d(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 4, 4))

    def forward(self, x):
        return F.conv_transpose2d(ops.operand(x), ops.operand(self.weight), None, stride=2,
                                  padding=1)


class Head(nn.Module):
    def __init__(self, s: ViTSpec):
        super().__init__()
        layers, cin = {}, s.dim
        for i, f in enumerate(s.filters):
            layers[str(3 * i)] = ConvTranspose2d(cin, f)
            layers[str(3 * i + 1)] = ref_model.BatchNorm(f)
            cin = f
        self.deconv_layers = nn.ModuleDict(layers)
        self.final_layer = ref_model.Conv2d(cin, s.joints, s.final_kernel, bias=True,
                                            padding=(s.final_kernel - 1) // 2)

    def forward(self, x):
        layers = list(self.deconv_layers.values())
        for deconv, bn in zip(layers[0::2], layers[1::2]):
            x = torch.relu(bn(deconv(x)))
        out = self.final_layer(x)
        calib = ref_model._calib
        if calib is not None:
            f = self.final_layer
            out = ref_model._rescale_((f.weight, f.bias), out, 0.1,
                                      (f.bias,) if calib["center"] else ())
        return out


class ViTPose(nn.Module):
    def __init__(self, s: ViTSpec):
        super().__init__()
        self.backbone = ViT(s)
        self.keypoint_head = Head(s)

    def forward(self, x):
        return self.keypoint_head(self.backbone(x))


def head_spec(cfg: dict) -> ref_model.Spec:
    """``reference/model.py``'s spec of OTPose's head.  Its ``stages`` are
    the smallest HRNet's, which ``OTPose`` replaces before any weight is
    drawn."""
    m = cfg["MODEL"]
    extra = m["EXTRA"]
    hm_w, hm_h = m["HEATMAP_SIZE"]
    one = (1, 1, (1,), (1,))
    return ref_model.Spec(num_joints=m["NUM_JOINTS"], stages=(one, one, one),
                          final_conv_kernel=extra["FINAL_CONV_KERNEL"], pe_h=hm_h, pe_w=hm_w,
                          dilations=tuple(m["DEFORMABLE_CONV"]["DILATION"]),
                          def_ch=m["DEFORMABLE_CONV_CH"], rsb_blocks=m["OFFSET_MASK_COMBINE_CONV"],
                          scale_arch=tuple(extra.get("SCALE_ARCH", (0, 6, 2))),
                          flow_scale_arch=tuple(extra.get("FLOW_SCALE_ARCH", (0, 6, 0))))


class OTPose(ref_model.OTPose):
    """``reference/model.py``'s OTPose with ViTPose as its estimator."""

    def __init__(self, cfg: dict):
        super().__init__(head_spec(cfg))
        self.rough_pose_estimation_net = ViTPose(ViTSpec(cfg))
