"""The plain reference of OTPose over ViTPose, float32, for the CPU tests.

ViTPose (Xu et al., NeurIPS 2022, arXiv 2204.12484; its
``ViTPose_huge_coco_256x192.py``) written out in plain ``torch``: the ViT
backbone (Dosovitskiy et al., ICLR 2021) and the classic decoder, module
names as ViTPose's ``state_dict``:

- ``patch_embed.proj``: Conv2d(3, C, k=16, stride=16, padding=2), with bias;
- ``x + pos_embed[:, 1:] + pos_embed[:, :1]`` (no class token);
- per block ``x + Attn(LN1(x))``, ``x + MLP(LN2(x))``: LN eps 1e-6,
  ``qkv`` Linear(C, 3C), softmax(q k^T / sqrt(d)) v written out (no
  ``scaled_dot_product_attention``), ``proj``; ``fc1``, erf GELU, ``fc2``;
  drop-path 0.55 linear over depth, in training only;
- ``last_norm``, the tokens as a (N, C, H / 16, W / 16) map;
- ``keypoint_head``: twice ConvTranspose2d(k=4, stride=2, padding=1,
  output_padding=0, bias=False), BN, ReLU; a 1x1 conv with bias.

OTPose's head over it (flow and temporal encoders, RSB, offsets and masks,
the multi-dilation DCN) is the plain one of ``portbench/reference/model.py``,
whose ``forward`` calls ``rough_pose_estimation_net`` on the five frames
batched together; ``PlainOTPose`` swaps this file's ViTPose in.  Nothing of the port
or of JAX is imported.  Departures from the published models: none beyond
the pairing (no checkpoint of OTPose over ViTPose is published).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import model as ref_model
from portbench.reference import ops as ref_ops
from portbench.reference.vitpose import head_spec


@contextlib.contextmanager
def exact_f32():
    """float32 products: TF32 off for matmuls and cuDNN."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    image_h: int
    image_w: int
    embed_dim: int
    depth: int
    num_heads: int
    deconv: int
    num_joints: int
    patch: int = 16
    drop_path_rate: float = 0.55

    @staticmethod
    def from_cfg(cfg) -> "ViTSpec":
        v = cfg["MODEL"]["EXTRA"]["VIT"]
        w, h = cfg["MODEL"]["IMAGE_SIZE"]
        return ViTSpec(h, w, v["EMBED_DIM"], v["DEPTH"], v["NUM_HEADS"],
                       v["NUM_DECONV_FILTERS"][0], cfg["MODEL"]["NUM_JOINTS"],
                       v["PATCH_SIZE"], v["DROP_PATH_RATE"])


def layer_norm(x, w, b, eps=1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


class LN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class Dense(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return x @ self.weight.t() + self.bias


class Attn(nn.Module):
    def __init__(self, c, heads):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(c, 3 * c)
        self.proj = Dense(c, c)

    def forward(self, x):
        n, t, c = x.shape
        d = c // self.heads
        q, k, v = self.qkv(x).reshape(n, t, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        scores = (q * d ** -0.5) @ k.transpose(-2, -1)
        att = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        att = att / att.sum(dim=-1, keepdim=True)
        return self.proj((att @ v).transpose(1, 2).reshape(n, t, c))


class MLP(nn.Module):
    def __init__(self, c, hidden):
        super().__init__()
        self.fc1 = Dense(c, hidden)
        self.fc2 = Dense(hidden, c)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0))))


class ViTBlock(nn.Module):
    def __init__(self, c, heads, rate):
        super().__init__()
        self.rate = rate
        self.norm1, self.attn = LN(c), Attn(c, heads)
        self.norm2, self.mlp = LN(c), MLP(c, 4 * c)

    def forward(self, x):
        x = x + ref_ops.drop_path(self.attn(self.norm1(x)), self.rate, self.training)
        return x + ref_ops.drop_path(self.mlp(self.norm2(x)), self.rate, self.training)


class Backbone(nn.Module):
    def __init__(self, s: ViTSpec):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = ref_model.Conv2d(3, s.embed_dim, s.patch, bias=True,
                                                 stride=s.patch, padding=2)
        n = (s.image_h // s.patch) * (s.image_w // s.patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, s.embed_dim))
        rates = torch.linspace(0, s.drop_path_rate, s.depth, device="cpu").tolist()
        self.blocks = nn.ModuleList([ViTBlock(s.embed_dim, s.num_heads, r) for r in rates])
        self.last_norm = LN(s.embed_dim)

    def forward(self, x):
        x = self.patch_embed.proj(x)
        n, c, hp, wp = x.shape
        x = x.reshape(n, c, hp * wp).transpose(1, 2)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for blk in self.blocks:
            x = blk(x)
        return self.last_norm(x).transpose(1, 2).reshape(n, c, hp, wp)


class Deconv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 4, 4))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, None, stride=2, padding=1, output_padding=0)


class Head(nn.Module):
    def __init__(self, cin, filters, joints):
        super().__init__()
        self.deconv_layers = nn.ModuleDict({"0": Deconv(cin, filters),
                                            "1": ref_model.BatchNorm(filters),
                                            "3": Deconv(filters, filters),
                                            "4": ref_model.BatchNorm(filters)})
        self.final_layer = ref_model.Conv2d(filters, joints, 1, bias=True)

    def forward(self, x):
        d = self.deconv_layers
        x = torch.relu(d["1"](d["0"](x)))
        x = torch.relu(d["4"](d["3"](x)))
        return self.final_layer(x)


class PlainViTPose(nn.Module):
    def __init__(self, s: ViTSpec):
        super().__init__()
        self.backbone = Backbone(s)
        self.keypoint_head = Head(s.embed_dim, s.deconv, s.num_joints)

    def forward(self, x):
        with exact_f32():
            return self.keypoint_head(self.backbone(x))


class PlainOTPose(ref_model.OTPose):
    """``reference/model.py``'s OTPose (its spec from the benchmark copy's
    ``head_spec``) with ``PlainViTPose`` as its estimator."""

    def __init__(self, cfg):
        super().__init__(head_spec(cfg))
        self.rough_pose_estimation_net = PlainViTPose(ViTSpec.from_cfg(cfg))


def forward7(model: PlainOTPose, x, margin):
    """The port's 7-tuple, NHWC: (output, rough, intersection, prev_b,
    context, squeezed, total_b); the three the head does not return are
    written out from the rough heatmaps and the margin."""
    with exact_f32():
        output, rough, intersection, context = ref_model.forward(model, x, margin)
    b = x.shape[0]
    cur, prev, _nxt, pprev, _nnext = torch.split(rough, b, dim=0)
    total_b = sum(torch.split(rough, b, dim=0))
    squeezed = total_b.sum(dim=1, keepdim=True).expand_as(total_b)
    m = margin.float()
    prev_b = cur + (prev / (m[:, 0] + 1)[:, None, None, None]
                    + pprev / (m[:, 2] + 1)[:, None, None, None])
    return tuple(t.permute(0, 2, 3, 1) for t in (output, rough, intersection, prev_b, context,
                                                 squeezed, total_b))
