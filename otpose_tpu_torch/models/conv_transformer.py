"""ConvTransformer over the flattened heatmap grid (counterpart of
``otpose_tpu/models/conv_transformer.py``).

ref: model/ConvVideoTransformer.py:16-185.  The sequence is the row-major
flattened (H, W) grid (T = 6912 for 96x72 heatmaps) and tokens are
(B, C, T), which for an NCHW map is a free reshape.  Architecture is
(#embedding convs, #stem blocks, #branch blocks); each branch block halves T.
The embedding convs (2-D conv, channel LN, ReLU) come first; the sinusoid
PE scaled by 1/sqrt(C) is added once in f32 and rounded back, and is
re-interpolated at eval for sequences of max_len or longer.  A level whose
window (``ConvTransformerSpec.win_size``) is above 1 runs window attention.

Under sequence parallelism (``seq``, JAX's ``seq_axis``: ref
``otpose_tpu/models/conv_transformer.py:90-135``) the embedding convs run
replicated, the tokens are sharded after the reshape (``shard_tokens``),
each rank adds its slice of the PE interpolated at full length, the stem
and branch blocks run on the slices, and every output is gathered back
(``gather_tokens``: the stem's at T, each branch's at its strided length
before any upsampling), so the layers after the encoder run replicated.
The stem's and branches' parameters (``seq_sharded_parameters``) then get
a partial gradient on each rank, which the train step sums over the seq
group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Tuple

import torch
from torch import nn

from otpose_tpu_torch.models import core
from otpose_tpu_torch.models.blocks import (LocalMaskedMHCA, TransformerBlock,
                                            get_sinusoid_encoding)
from otpose_tpu_torch.parallel import sequence


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
    mha_win_size: tuple = ()      # per-level window sizes; empty / <= 1: global
    use_rel_pe: bool = False

    def win_size(self, level: int) -> int:
        """The attention window of pyramid level ``level`` (-1: global): the
        one source of the level -> window mapping, which the blocks' params
        and their forward share."""
        if not self.mha_win_size:
            return -1
        return self.mha_win_size[min(level, len(self.mha_win_size) - 1)]


class ConvTransformer(nn.Module):
    """``arch[0]`` embedding convs (k = ``n_embd_ks``, padding k // 2, a bias
    only without LN), then ``arch[1]`` stem blocks at level 0 and
    ``arch[2]`` strided branch blocks at levels 1, 2, ...; each level's
    window from ``spec.win_size``."""

    def __init__(self, spec: ConvTransformerSpec):
        super().__init__()
        self.spec = spec
        k = spec.n_embd_ks
        self.embd = nn.ModuleList([
            core.Conv2d(spec.n_in if i == 0 else spec.n_embd, spec.n_embd, k,
                        bias=not spec.with_ln, padding=k // 2)
            for i in range(spec.arch[0])])
        self.embd_norm = nn.ModuleList([core.LayerNormCT(spec.n_embd)
                                        for _ in range(spec.arch[0] if spec.with_ln else 0)])
        if spec.use_abs_pe:
            pe = get_sinusoid_encoding(spec.max_len, spec.n_embd) / (spec.n_embd ** 0.5)
            self.register_buffer("pos_embd", pe)
        else:
            self.pos_embd = None
        rates = dict(path_pdrop=spec.path_pdrop, attn_pdrop=spec.attn_pdrop,
                     proj_pdrop=spec.proj_pdrop)
        self.stem = nn.ModuleList([
            TransformerBlock(spec.n_embd, spec.n_head, 1, mha_win_size=spec.win_size(0),
                             use_rel_pe=spec.use_rel_pe, **rates)
            for _ in range(spec.arch[1])])
        self.branch = nn.ModuleList([
            TransformerBlock(spec.n_embd, spec.n_head, spec.scale_factor,
                             mha_win_size=spec.win_size(1 + i), use_rel_pe=spec.use_rel_pe,
                             **rates)
            for i in range(spec.arch[2])])

    def forward(self, x, upsample: bool = True, fused: bool = True, seq=None) -> List:
        return conv_transformer_forward(self, x, upsample=upsample, fused=fused, seq=seq)


def seq_sharded_parameters(model: nn.Module) -> Iterator[nn.Parameter]:
    """The parameters of every ``ConvTransformer`` in ``model`` that run on
    token slices under sequence parallelism (its stem and branch blocks)."""
    for m in model.modules():
        if isinstance(m, ConvTransformer):
            yield from m.stem.parameters()
            yield from m.branch.parameters()


def conv_transformer_forward(model: ConvTransformer, x, upsample: bool = True,
                             fused: bool = True, seq=None) -> List:
    """x: (B, C, H, W) map -> [stem output] + arch[2] branch outputs, each
    (B, C, T).  ``upsample=False`` leaves branch outputs at their strided
    lengths (the caller commutes its 1x1 conv with the upsampling).  With
    ``seq`` (a ``parallel/sequence.py::SeqGroup``) the blocks run on this
    rank's slice of T and the outputs are the whole, gathered tensors; a T
    that the seq size and the branches' strides do not divide raises."""
    b, _, h, w = x.shape
    t = h * w
    for i, conv in enumerate(model.embd):
        x = conv(x)
        if model.spec.with_ln:
            x = model.embd_norm[i](x.reshape(b, -1, t)).reshape(b, -1, h, w)
        x = core.relu(x)
    tokens = x.reshape(b, x.shape[1], t)
    lo, hi = 0, t
    if seq is not None:
        sequence.check_shardable(t, seq.size, model.spec.scale_factor ** model.spec.arch[2])
        tokens = sequence.shard_tokens(tokens, seq)
        lo, hi = seq.bounds(t)
    if model.pos_embd is not None:
        pe = model.pos_embd
        if t >= model.spec.max_len:
            pe = core.upsample_linear_1d_ct(pe, t)
        tokens = (tokens.float() + pe[..., lo:hi]).to(x.dtype)
    whole = (lambda f: f) if seq is None else (lambda f: sequence.gather_tokens(f, seq))
    for blk in model.stem:
        tokens = blk(tokens, fused=fused, seq=seq)
    feats = [whole(tokens)]
    for blk in model.branch:
        tokens = blk(tokens, fused=fused, seq=seq)
        out = whole(tokens)
        feats.append(core.upsample_linear_1d_ct(out, t) if upsample else out)
    return feats


@torch.no_grad()
def init_conv_transformer_(model: ConvTransformer, gen: torch.Generator) -> ConvTransformer:
    """The JAX ``init_conv_transformer`` distributions drawn from ``gen`` on
    the CPU: embedding convs normal std 0.001 (their bias, if any, zero),
    conv1d torch-default with zero bias, LN 1 / 0, drop-path scale 1e-4, and
    ``rel_pe`` normal with std sqrt(2 / n_embd)."""
    std = math.sqrt(2.0 / model.spec.n_embd)
    for m in model.modules():
        if isinstance(m, core.Conv2d):
            core.normal_(m.weight, gen, 0.001)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, core.Conv1d):
            core.kaiming_uniform_(m.weight, gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LocalMaskedMHCA) and m.rel_pe is not None:
            core.normal_(m.rel_pe, gen, std)
    return model
