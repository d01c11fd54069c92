"""ConvTransformer over the flattened heatmap grid (counterpart of
``otpose_tpu/models/conv_transformer.py``).

ref: model/ConvVideoTransformer.py:16-185.  The sequence is the row-major
flattened (H, W) grid (T = 6912 for 96x72 heatmaps) and tokens are
(B, C, T), which for an NCHW map is a free reshape.  Architecture is
(#embedding convs, #stem blocks, #branch blocks); each branch block halves T.
The sinusoid PE scaled by 1/sqrt(C) is added once in f32 and rounded back,
and is re-interpolated at eval for sequences of max_len or longer.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from torch import nn

from otpose_tpu_torch.models import core
from otpose_tpu_torch.models.blocks import TransformerBlock, get_sinusoid_encoding


@dataclasses.dataclass(frozen=True)
class ConvTransformerSpec:
    n_in: int
    n_embd: int
    n_head: int
    n_embd_ks: int
    max_len: int
    arch: Tuple[int, int, int]
    scale_factor: int = 2
    with_ln: bool = True
    attn_pdrop: float = 0.0
    proj_pdrop: float = 0.0
    path_pdrop: float = 0.0
    use_abs_pe: bool = True
    mha_win_size: tuple = ()
    use_rel_pe: bool = False


class ConvTransformer(nn.Module):
    """Embedding-free (arch[0] == 0), global-attention ConvTransformer: the
    configuration OTPose builds.  Embedding convs and local-window attention
    are not ported yet and are refused."""

    def __init__(self, spec: ConvTransformerSpec):
        super().__init__()
        if spec.arch[0] != 0 or any(w > 1 for w in spec.mha_win_size):
            raise NotImplementedError(
                "otpose_tpu_torch ConvTransformer: embedding convs and local "
                "attention are not ported")
        self.spec = spec
        if spec.use_abs_pe:
            pe = get_sinusoid_encoding(spec.max_len, spec.n_embd) / (spec.n_embd ** 0.5)
            self.register_buffer("pos_embd", pe)
        else:
            self.pos_embd = None
        rates = dict(path_pdrop=spec.path_pdrop, attn_pdrop=spec.attn_pdrop,
                     proj_pdrop=spec.proj_pdrop)
        self.stem = nn.ModuleList([
            TransformerBlock(spec.n_embd, spec.n_head, 1, **rates)
            for _ in range(spec.arch[1])])
        self.branch = nn.ModuleList([
            TransformerBlock(spec.n_embd, spec.n_head, spec.scale_factor, **rates)
            for _ in range(spec.arch[2])])

    def forward(self, x, upsample: bool = True, fused: bool = True) -> List:
        return conv_transformer_forward(self, x, upsample=upsample, fused=fused)


def conv_transformer_forward(model: ConvTransformer, x, upsample: bool = True,
                             fused: bool = True) -> List:
    """x: (B, C, H, W) map -> [stem output] + arch[2] branch outputs, each
    (B, C, T).  ``upsample=False`` leaves branch outputs at their strided
    lengths (the caller commutes its 1x1 conv with the upsampling)."""
    b, c, h, w = x.shape
    t = h * w
    tokens = x.reshape(b, c, t)
    if model.pos_embd is not None:
        pe = model.pos_embd
        if t >= model.spec.max_len:
            pe = core.upsample_linear_1d_ct(pe, t)
        tokens = (tokens.float() + pe[..., :t]).to(x.dtype)
    for blk in model.stem:
        tokens = blk(tokens, fused=fused)
    feats = [tokens]
    for blk in model.branch:
        tokens = blk(tokens, fused=fused)
        feats.append(core.upsample_linear_1d_ct(tokens, t) if upsample else tokens)
    return feats
