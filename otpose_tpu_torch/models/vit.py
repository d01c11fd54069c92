"""ViTPose as OTPose's per-frame estimator (Xu et al., "ViTPose: Simple
Vision Transformer Baselines for Human Pose Estimation", NeurIPS 2022,
arXiv 2204.12484; its ``configs/body/2d_kpt_sview_rgb_img/topdown_heatmap/
coco/ViTPose_huge_coco_256x192.py``), in place of HRNet.

The backbone is a plain ViT (Dosovitskiy et al., ICLR 2021):

- patch embedding ``Conv2d(3, C, k=P, stride=P, padding=2)`` (ViTPose's
  ``ratio`` 1): a 256x192 crop at P = 16 is 16 x 12 tokens;
- ``x + pos_embed[:, 1:] + pos_embed[:, :1]``, ``pos_embed`` (1, N + 1, C),
  no class token;
- ``depth`` pre-norm blocks, ``x = x + Attn(LN1(x))``, ``x = x + MLP(LN2(x))``:
  LN eps 1e-6; ``qkv = Linear(C, 3C)``, ``num_heads`` heads,
  softmax(q k^T / sqrt(C / heads)) v, ``proj = Linear(C, C)``; ``fc1 =
  Linear(C, ratio C)``, exact GELU, ``fc2``; drop-path linear over depth up
  to ``drop_path_rate``, in training only;
- ``last_norm``, then the tokens as a (N, C, H/P, W/P) map.

The classic decoder (``TopdownHeatmapSimpleHead``): per deconv layer
``ConvTranspose2d(k=4, stride=2, padding=1, bias=False)``, BN, ReLU; then a
``final_conv_kernel`` conv to the joints' heatmaps (64x48 at 256x192).

Module names give ViTPose's ``state_dict`` keys (``backbone.blocks.<i>.attn.
qkv.weight``, ``keypoint_head.deconv_layers.<i>``, ...).  As in the rest of
the port, each op casts its weights to the activation dtype.  Attention is
``scaled_dot_product_attention``: on a CUDA tensor under ``sdpa_kernel``
with the first fused backend that takes the call (flash, then cuDNN, as
``torch.backends.cuda.can_use_*`` say), and no fallback (a call neither
takes, such as float32, raises); off the card on the math path.  Each call
counts ``vit.attn.<backend>`` (``utils/profiling.py``).

``MODEL.EXTRA.ESTIMATOR: vitpose`` selects it in ``models/otpose.py``, with
its sizes under ``MODEL.EXTRA.VIT`` (``configs/18/model_ViTPoseH.yaml``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from otpose_tpu_torch.models.core import BatchNorm, Conv2d, drop_path, relu
from otpose_tpu_torch.utils import profiling

LN_EPS = 1e-6
PATCH_PADDING = 2                  # ViTPose's ``4 + 2 * (ratio // 2 - 1)`` at ratio 1
# the fused backends in the order they are asked, each with whether it takes a call
FUSED_BACKENDS = (
    (SDPBackend.FLASH_ATTENTION, "flash", torch.backends.cuda.can_use_flash_attention),
    (SDPBackend.CUDNN_ATTENTION, "cudnn", torch.backends.cuda.can_use_cudnn_attention),
)
# ``_get_deconv_cfg``: kernel -> (padding, output_padding)
DECONV_PADDING = {4: (1, 0), 3: (1, 1), 2: (0, 0)}


@dataclasses.dataclass(frozen=True)
class ViTPoseSpec:
    image_h: int
    image_w: int
    patch_size: int
    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: int
    qkv_bias: bool
    drop_path_rate: float
    deconv_filters: Tuple[int, ...]
    deconv_kernels: Tuple[int, ...]
    num_joints: int
    final_conv_kernel: int

    @property
    def grid(self) -> Tuple[int, int]:
        """The patch embedding's output (rows, columns)."""
        p, pad = self.patch_size, PATCH_PADDING
        return (self.image_h + 2 * pad - p) // p + 1, (self.image_w + 2 * pad - p) // p + 1

    @property
    def num_tokens(self) -> int:
        h, w = self.grid
        return h * w

    @property
    def num_patches(self) -> int:
        """ViTPose's count, which sizes ``pos_embed`` (one more row)."""
        return (self.image_h // self.patch_size) * (self.image_w // self.patch_size)

    @staticmethod
    def from_cfg(cfg) -> "ViTPoseSpec":
        """From ``MODEL.EXTRA.VIT``, every key given (``configs/18/
        model_ViTPoseH.yaml`` gives ViTPose-H's)."""
        v = cfg.MODEL.EXTRA.VIT
        w, h = cfg.MODEL.IMAGE_SIZE
        return ViTPoseSpec(image_h=h, image_w=w, patch_size=v.PATCH_SIZE,
                           embed_dim=v.EMBED_DIM, depth=v.DEPTH, num_heads=v.NUM_HEADS,
                           mlp_ratio=v.MLP_RATIO, qkv_bias=v.QKV_BIAS,
                           drop_path_rate=v.DROP_PATH_RATE,
                           deconv_filters=tuple(v.NUM_DECONV_FILTERS),
                           deconv_kernels=tuple(v.NUM_DECONV_KERNELS),
                           num_joints=cfg.MODEL.NUM_JOINTS,
                           final_conv_kernel=v.FINAL_CONV_KERNEL)


def attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v of (B, heads, N, d) tensors."""
    if not q.is_cuda:
        profiling.count("vit.attn.math")
        with sdpa_kernel(SDPBackend.MATH):
            return F.scaled_dot_product_attention(q, k, v)
    params = torch.backends.cuda.SDPAParams(q, k, v, None, 0.0, False, False)
    for backend, name, takes in FUSED_BACKENDS:
        if takes(params, False):
            profiling.count(f"vit.attn.{name}")
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v)
    raise RuntimeError(f"no fused attention backend takes {q.dtype} heads of {q.shape[-1]} "
                       f"(asked {', '.join(n for _, n, _ in FUSED_BACKENDS)}); the ViT does not "
                       "fall back to the math path on the card")


class Linear(nn.Module):
    """``nn.Linear``'s parameters: weight (out, in), optional bias (out,)."""

    def __init__(self, cin: int, cout: int, *, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-6; statistics in float32."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), LN_EPS)


class ConvTranspose2d(nn.Module):
    """A stride-2 deconv's weight (in, out, k, k), no bias."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, kernel, kernel))
        self.padding, self.output_padding = DECONV_PADDING[kernel]

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None, stride=2,
                                  padding=self.padding, output_padding=self.output_padding)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        return self.proj(attention(q, k, v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, qkv_bias: bool,
                 drop_path_rate: float):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + drop_path(self.attn(self.norm1(x)), self.drop_path_rate, self.training)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path_rate, self.training)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, bias=True, stride=patch, padding=PATCH_PADDING)


class ViT(nn.Module):
    """(N, 3, H, W) -> (N, C, H / P, W / P)."""

    def __init__(self, spec: ViTPoseSpec):
        super().__init__()
        c = spec.embed_dim
        self.patch_embed = PatchEmbed(spec.patch_size, c)
        self.pos_embed = nn.Parameter(torch.zeros(1, spec.num_patches + 1, c))
        rates = torch.linspace(0, spec.drop_path_rate, spec.depth, device="cpu").tolist()
        self.blocks = nn.ModuleList([Block(c, spec.num_heads, spec.mlp_ratio, spec.qkv_bias, r)
                                     for r in rates])
        self.last_norm = LayerNorm(c)

    def forward(self, x):
        x = self.patch_embed.proj(x)
        n, c, hp, wp = x.shape
        pos = self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        # token-major in memory: left as the conv's transposed view, every LN
        # would copy its input and every residual add would run strided
        x = (x.flatten(2).transpose(1, 2) + pos.to(x.dtype)).contiguous()
        for blk in self.blocks:
            x = blk(x)
        return self.last_norm(x).transpose(1, 2).reshape(n, c, hp, wp)


class TopdownHeatmapSimpleHead(nn.Module):
    """Deconv, BN and ReLU per layer (``deconv_layers.<3i>`` and
    ``.<3i + 1>``), then ``final_layer``."""

    def __init__(self, cin: int, filters, kernels, num_joints: int, final_kernel: int):
        super().__init__()
        layers = {}
        for i, (f, k) in enumerate(zip(filters, kernels)):
            layers[str(3 * i)] = ConvTranspose2d(cin, f, k)
            layers[str(3 * i + 1)] = BatchNorm(f)
            cin = f
        self.deconv_layers = nn.ModuleDict(layers)
        self.final_layer = Conv2d(cin, num_joints, final_kernel, bias=True,
                                  padding=(final_kernel - 1) // 2)

    def forward(self, x):
        layers = list(self.deconv_layers.values())
        for deconv, bn in zip(layers[0::2], layers[1::2]):
            x = relu(bn(deconv(x)))
        return self.final_layer(x)


class ViTPose(nn.Module):
    """(N, 3, H, W) frames -> (N, J, H / 4, W / 4) heatmaps."""

    def __init__(self, spec: ViTPoseSpec):
        super().__init__()
        self.spec = spec
        self.backbone = ViT(spec)
        self.keypoint_head = TopdownHeatmapSimpleHead(spec.embed_dim, spec.deconv_filters,
                                                      spec.deconv_kernels, spec.num_joints,
                                                      spec.final_conv_kernel)

    def forward(self, x):
        return self.keypoint_head(self.backbone(x))
