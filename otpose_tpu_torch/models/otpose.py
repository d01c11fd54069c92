"""OTPose, full model assembly (counterpart of ``otpose_tpu/models/otpose.py``).

ref: model/OTPose.py:180-503.  Forward (ref: 307-394):
  1. split the (B, H, W, 15) 5-frame stack into 5 x (B, 3, H, W), batch them
     as 5B and run the per-frame estimator once -> rough heatmaps (5B, J,
     Hh, Hw): HRNet, or with ``MODEL.EXTRA.ESTIMATOR: vitpose`` the ViTPose
     of ``models/vit.py``
  2. occlusion encoding: total_b = sum of the 5 heatmap sets; squeezed =
     channel sum broadcast back to J channels; intersection = total_b*squeezed
  3. flow encoder (ConvTransformer J->J) on total_b -> context_encoding
  4. margin penalty: aux heatmaps divided by (margin + 1)
  5. two 8-feature 136-channel stacks -> temporal encoders -> final 1x1 convs
  6. def_fuse RSB on total_b; offset_mask_combine RSB on [branches, fused];
     per-dilation offset/mask convs + the multi-dilation modulated
     deformable conv kernel, its weights packed once (``dcn_pack``); under
     autograd the raw weights go to the wrapper, whose autograd Function
     runs the backward kernel on the card

Step 1 is the span ``otpose.model.hrnet`` (``otpose.model.vit`` for the
ViT, which also counts ``vit.frames`` and ``vit.tokens`` there, outside the
eval steps' graph), steps 2-5 ``otpose.model.encoders``, the final convs
and step 6 ``otpose.model.refine`` (``utils/profiling.py``).

Train mode is the model's ``train()``; with ``freeze_hrnet`` the estimator
runs as a frozen submodule (``core.frozen``: running statistics, no update,
its output detached), as the JAX package's ``Ctx.frozen`` and
``stop_gradient`` do.

Internally NCHW; the public layouts are the JAX package's: the clip is NHWC
and the 7-tuple is NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from otpose_tpu_torch.models import core
from otpose_tpu_torch.models.blocks import cached_pack
from otpose_tpu_torch.models.conv_transformer import ConvTransformer, ConvTransformerSpec
from otpose_tpu_torch.models.core import Conv1d, Conv2d
from otpose_tpu_torch.models.hrnet import HRNet, HRNetSpec
from otpose_tpu_torch.models.jax_bridge import is_channel_param
from otpose_tpu_torch.models.rsb import RSBChain
from otpose_tpu_torch.models.vit import ConvTranspose2d, Linear, ViT, ViTPose, ViTPoseSpec
from otpose_tpu_torch.ops.cuda.deform_conv import modulated_deform_conv_multi, pack_dcn_weights
from otpose_tpu_torch.utils import profiling


def _check_aggregation(kind: str) -> str:
    if kind != "weighted_sum":
        raise ValueError(
            f"DEFORMABLE_CONV.AGGREGATION_TYPE={kind!r} is not implemented: "
            "the reference model only defines its output under "
            "'weighted_sum' (ref: model/OTPose.py:387-394)")
    return kind


@dataclasses.dataclass(frozen=True)
class OTPoseSpec:
    estimator: HRNetSpec | ViTPoseSpec
    final_conv_kernel: int
    num_joints: int
    pe_h: int
    pe_w: int
    dilations: Tuple[int, ...]
    def_ch: int
    offset_mask_combine_blocks: int
    aggregation_type: str = "weighted_sum"
    freeze_hrnet: bool = False
    num_frames: int = 8
    scale_arch: Tuple[int, int, int] = (0, 6, 2)
    flow_scale_arch: Tuple[int, int, int] = (0, 6, 0)
    proj_pdrop: float = 0.1
    path_pdrop: float = 0.1

    @property
    def temporal_encoding_dim(self) -> int:
        return self.num_joints * self.num_frames

    @property
    def num_patches(self) -> int:
        return self.pe_h * self.pe_w

    def temporal_spec(self) -> ConvTransformerSpec:
        d = self.temporal_encoding_dim
        return ConvTransformerSpec(
            n_in=d, n_embd=d, n_head=2, n_embd_ks=3, max_len=self.num_patches,
            arch=self.scale_arch, proj_pdrop=self.proj_pdrop,
            path_pdrop=self.path_pdrop)

    def flow_spec(self) -> ConvTransformerSpec:
        return ConvTransformerSpec(
            n_in=self.num_joints, n_embd=self.num_joints, n_head=1, n_embd_ks=3,
            max_len=self.num_patches, arch=self.flow_scale_arch,
            proj_pdrop=self.proj_pdrop, path_pdrop=self.path_pdrop)

    @staticmethod
    def from_cfg(cfg) -> "OTPoseSpec":
        hm_w, hm_h = cfg.MODEL.HEATMAP_SIZE
        extra = cfg.MODEL.EXTRA
        kind = extra.get("ESTIMATOR", "hrnet")
        if kind not in ESTIMATORS:
            raise ValueError(f"MODEL.EXTRA.ESTIMATOR={kind!r}: one of {sorted(ESTIMATORS)}")
        return OTPoseSpec(
            estimator=ESTIMATORS[kind].from_cfg(cfg),
            final_conv_kernel=extra.FINAL_CONV_KERNEL,
            num_joints=cfg.MODEL.NUM_JOINTS,
            pe_h=hm_h, pe_w=hm_w,
            dilations=tuple(cfg.MODEL.DEFORMABLE_CONV.DILATION),
            def_ch=cfg.MODEL.DEFORMABLE_CONV_CH,
            offset_mask_combine_blocks=cfg.MODEL.OFFSET_MASK_COMBINE_CONV,
            aggregation_type=_check_aggregation(
                cfg.MODEL.DEFORMABLE_CONV.AGGREGATION_TYPE),
            freeze_hrnet=cfg.MODEL.FREEZE_HRNET_WEIGHTS,
            scale_arch=tuple(extra.get("SCALE_ARCH", (0, 6, 2))),
            flow_scale_arch=tuple(extra.get("FLOW_SCALE_ARCH", (0, 6, 0))),
        )


# MODEL.EXTRA.ESTIMATOR -> the estimator's spec
ESTIMATORS = {"hrnet": HRNetSpec, "vitpose": ViTPoseSpec}


class DeformConvParams(nn.Module):
    """The reference ModulatedDeformConv's params: weight (O, C, 3, 3), bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))


class OTPose(nn.Module):
    def __init__(self, spec: OTPoseSpec):
        super().__init__()
        self.spec = spec
        j = spec.num_joints
        est = spec.estimator
        vit = isinstance(est, ViTPoseSpec)
        self.rough_pose_estimation_net = ViTPose(est) if vit else HRNet(est)
        self.estimator_span = "otpose.model.vit" if vit else "otpose.model.hrnet"
        self.frame_tokens = est.num_tokens if vit else 0
        self.temporal_encoder1 = ConvTransformer(spec.temporal_spec())
        self.temporal_encoder2 = ConvTransformer(spec.temporal_spec())
        self.flow_encoder = ConvTransformer(spec.flow_spec())
        d = spec.temporal_encoding_dim * (spec.scale_arch[-1] + 1)
        k = spec.final_conv_kernel
        pad = 1 if k == 3 else 0
        self.final_layer1 = Conv2d(d, j, k, bias=True, padding=pad)
        self.final_layer2 = Conv2d(d, j, k, bias=True, padding=pad)
        self.def_fuse = RSBChain(j, j, spec.offset_mask_combine_blocks)
        self.offset_mask_combine_conv = RSBChain(3 * j, spec.def_ch,
                                                 spec.offset_mask_combine_blocks)
        self.offsets_list = nn.ModuleList([
            nn.ModuleDict({"0": Conv2d(spec.def_ch, 18 * j, 3, padding=dil, dilation=dil)})
            for dil in spec.dilations])
        self.masks_list = nn.ModuleList([
            nn.ModuleDict({"0": Conv2d(spec.def_ch, 9 * j, 3, padding=dil, dilation=dil)})
            for dil in spec.dilations])
        self.modulated_deform_conv_list = nn.ModuleList([
            nn.ModuleDict({"deform_conv": DeformConvParams(j, j)}) for _ in spec.dilations])

    def forward(self, x, margin, compute_dtype=torch.float32, fused: bool = True, seq=None):
        return otpose_forward(self, x, margin, compute_dtype=compute_dtype, fused=fused,
                              seq=seq)


def dcn_pack(model: OTPose):
    """The refinement's DCN weights and biases packed for the kernel
    (``pack_dcn_weights``), cached on ``model.modulated_deform_conv_list``
    until a parameter changes storage, version, dtype or device."""
    dcn = [m["deform_conv"] for m in model.modulated_deform_conv_list]
    params = tuple(p for m in dcn for p in (m.weight, m.bias))
    return cached_pack(model.modulated_deform_conv_list, "_dcn_pack", params, torch.float32,
                       lambda: pack_dcn_weights(torch.stack([m.weight for m in dcn]),
                                                torch.stack([m.bias for m in dcn])))


def dcn_weights(model: OTPose):
    """(weights, biases, packed) for the DCN wrapper: the cached pack, or,
    where autograd would differentiate a DCN parameter, the raw stacked
    weights and biases, whose gradients the wrapper returns (the backward
    kernel on the card, the plain version's autograd on the CPU)."""
    dcn = [m["deform_conv"] for m in model.modulated_deform_conv_list]
    if torch.is_grad_enabled() and any(p.requires_grad for m in dcn for p in (m.weight, m.bias)):
        return torch.stack([m.weight for m in dcn]), torch.stack([m.bias for m in dcn]), None
    return None, None, dcn_pack(model)


def _tokens_to_map(feats, h: int, w: int):
    """Stack encoder outputs [(B, C, T)] scale-major -> (B, n*C, H, W)."""
    b = feats[0].shape[0]
    return torch.stack(feats, dim=1).reshape(b, -1, h, w)


def _final_layer_ct(conv: Conv2d, feats, h: int, w: int):
    """The 1x1 final conv over the stacked encoder scales, applied per scale
    on its native strided tokens; the J-channel results are linearly
    upsampled (conv and interpolation commute) and summed."""
    t = h * w
    wt = conv.weight[:, :, 0, 0]                     # (J, n*C)
    c = feats[0].shape[1]
    y = None
    for s, f in enumerate(feats):
        ys = torch.matmul(wt[:, s * c:(s + 1) * c].to(f.dtype), f)
        if ys.shape[-1] != t:
            ys = core.upsample_linear_1d_ct(ys, t)
        y = ys if y is None else y + ys
    y = y + conv.bias.to(y.dtype)[:, None]
    return y.reshape(y.shape[0], -1, h, w)


def run_hrnet(model: OTPose, frames):
    """The estimator (HRNet or the ViT) over the (5B, 3, H, W) frames ->
    rough heatmaps (5B, J, h, w), as a frozen submodule under
    ``freeze_hrnet``."""
    if model.spec.freeze_hrnet:
        with core.frozen(model.rough_pose_estimation_net):
            return model.rough_pose_estimation_net(frames)
    return model.rough_pose_estimation_net(frames)


def otpose_forward(model: OTPose, x, margin, compute_dtype=torch.float32,
                   fused: bool = True, seq=None, backbone=None):
    """x: (B, H, W, 15) five RGB frames (current, prev, next, pprev, nnext);
    margin: (B, 4).  Returns the reference 7-tuple, NHWC:
    (output_heatmaps f32, rough_heatmaps (5B), intersection, prev_b,
     context_encoding, squeezed, total_b).  ``seq`` (a
    ``parallel/sequence.py::SeqGroup``) runs the three encoders' blocks on
    this rank's slice of the tokens; everything else, and the result, is
    whole on every rank of the seq group.  ``backbone`` maps the frames to
    the rough heatmaps in place of ``run_hrnet`` (the eval steps'
    ``engine/graphs.py::BackboneGraph``)."""
    spec = model.spec
    b = x.shape[0]
    j = spec.num_joints
    with profiling.span(model.estimator_span):
        frames = torch.cat(torch.split(x.permute(0, 3, 1, 2), 3, dim=1), dim=0)
        frames = frames.to(compute_dtype).contiguous()
        if model.frame_tokens:
            profiling.count("vit.frames", frames.shape[0])
            profiling.count("vit.tokens", frames.shape[0] * model.frame_tokens)
        rough = run_hrnet(model, frames) if backbone is None else backbone(frames)
        h, w = rough.shape[2:]
        cur, prev, nxt, pprev, nnext = torch.split(rough, b, dim=0)

    with profiling.span("otpose.model.encoders"):
        total_b = cur + prev + nxt + pprev + nnext
        squeezed = total_b.sum(dim=1, keepdim=True).expand_as(total_b)
        intersection = total_b * squeezed

        context_encoding = _tokens_to_map(model.flow_encoder(total_b, fused=fused, seq=seq), h, w)

        margin = margin.to(device=total_b.device, dtype=total_b.dtype)
        prev = prev / (margin[:, 0] + 1)[:, None, None, None]
        nxt = nxt / (margin[:, 1] + 1)[:, None, None, None]
        pprev = pprev / (margin[:, 2] + 1)[:, None, None, None]
        nnext = nnext / (margin[:, 3] + 1)[:, None, None, None]

        prev_b = cur + (prev + pprev)
        next_b = cur + (nxt + nnext)
        close_b = cur + (nxt + prev)
        far_b = cur + (nnext + pprev)
        prev_int, next_int = prev_b * squeezed, next_b * squeezed
        close_int, far_int = close_b * squeezed, far_b * squeezed

        def stack8(feats):    # joint-major channels: j * 8 + f (ref: OTPose.py:356-359)
            return torch.stack(feats, dim=2).reshape(b, j * spec.num_frames, h, w)

        x1 = stack8([intersection, context_encoding, prev_b, far_b, close_b,
                     prev_int, far_int, close_int])
        x2 = stack8([intersection, context_encoding, next_b, close_b, far_b,
                     next_int, close_int, far_int])

        commute = spec.final_conv_kernel == 1
        x1_feats = model.temporal_encoder1(x1, upsample=not commute, fused=fused, seq=seq)
        x2_feats = model.temporal_encoder2(x2, upsample=not commute, fused=fused, seq=seq)

    with profiling.span("otpose.model.refine"):
        if commute:
            y1 = _final_layer_ct(model.final_layer1, x1_feats, h, w)
            y2 = _final_layer_ct(model.final_layer2, x2_feats, h, w)
        else:
            y1 = model.final_layer1(_tokens_to_map(x1_feats, h, w))
            y2 = model.final_layer2(_tokens_to_map(x2_feats, h, w))
        branches = torch.cat([y1, y2], dim=1)

        def_heatmaps = model.def_fuse(total_b)
        trans = model.offset_mask_combine_conv(torch.cat([branches, def_heatmaps], dim=1))
        offsets = [m["0"](trans).contiguous() for m in model.offsets_list]
        masks = [m["0"](trans).contiguous() for m in model.masks_list]
        weights, biases, packed = dcn_weights(model)
        output = modulated_deform_conv_multi(def_heatmaps.contiguous(), offsets, masks, weights,
                                             biases, spec.dilations, packed=packed).float()
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        return tuple(nhwc(t) for t in (output, rough, intersection, prev_b,
                                       context_encoding, squeezed, total_b))


@torch.no_grad()
def prepare_eval_params(model: nn.Module, param_dtype=None) -> nn.Module:
    """Cast, in place, the weights that are >= 2-D in the JAX layout (convs
    and dense kernels) to ``param_dtype``; norm, bias and drop-path params
    and the buffers stay f32.  The ViT's LayerNorms are 1-D and stay f32;
    its ``pos_embed``, which is added to the tokens as a bias is, stays f32
    too (the forward adds its two parts in f32, then casts once).  ``None``
    leaves the model as it is."""
    if param_dtype is None:
        return model
    for name, p in model.named_parameters():
        if (p.dim() >= 2 and not is_channel_param(name) and not name.endswith("pos_embed")
                and p.dtype == torch.float32):
            p.data = p.data.to(param_dtype)
    return model


@torch.no_grad()
def init_otpose_(model: OTPose, gen: torch.Generator) -> OTPose:
    """The reference init (ref: OTPose.py:431-475), as the JAX
    ``_init_otpose_impl`` draws it: conv2d normal std 0.001 with zero bias,
    BN 1/0, LN 1/0, drop-path scale 1e-4, identity-filler deform-conv
    weights, torch-default conv1d with zero bias.  A ViT estimator's
    ``pos_embed`` and dense weights are ViTPose's truncated normal 0.02
    (zero biases), its deconvs normal 0.001, as HRNet's head.  Draws come
    from ``gen`` on the CPU, a tensor at a time, in module order; move the
    model afterwards."""
    for m in model.modules():
        if isinstance(m, ViT):
            core.trunc_normal_(m.pos_embed, gen, 0.02)
        elif isinstance(m, Linear):
            core.trunc_normal_(m.weight, gen, 0.02)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, ConvTranspose2d):
            core.normal_(m.weight, gen, 0.001)
        elif isinstance(m, DeformConvParams):
            m.weight.zero_()
            idx = torch.arange(m.weight.shape[0])
            m.weight[idx, idx, 1, 1] = 1.0
            m.bias.zero_()
        elif isinstance(m, Conv2d):
            core.normal_(m.weight, gen, 0.001)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Conv1d):
            core.kaiming_uniform_(m.weight, gen)
            if m.bias is not None:
                m.bias.zero_()
    return model


def make_sine_position_embedding(pe_h: int, pe_w: int, d_model: int,
                                 temperature: float = 10000,
                                 scale: float = 2 * np.pi) -> torch.Tensor:
    """2-D sine position embedding, (1, H*W, d_model) f32, as the reference
    lays it out (ref: OTPose.py:281-305, defined there and never called;
    kept for users who enable it downstream)."""
    area = np.ones((1, pe_h, pe_w), np.float32)
    y_embed = area.cumsum(1)
    x_embed = area.cumsum(2)
    one_direction = d_model // 2
    eps = 1e-6
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = np.arange(one_direction, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / one_direction)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])],
                     axis=4).reshape(1, pe_h, pe_w, -1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])],
                     axis=4).reshape(1, pe_h, pe_w, -1)
    pos = np.concatenate([pos_y, pos_x], axis=3)
    return torch.from_numpy(pos.reshape(1, pe_h * pe_w, d_model).astype(np.float32))


def make_learnable_position_embedding(gen: torch.Generator, num_patches: int,
                                      dim: int) -> torch.Tensor:
    """The learnable position embedding's initial value, (1, num_patches,
    dim) standard normal drawn from ``gen`` (ref: OTPose.py:266-271)."""
    return torch.randn((1, num_patches, dim), generator=gen)
