"""Conv-transformer blocks on (B, C, T) (counterpart of
``otpose_tpu/models/blocks.py``, its ``_ct`` variants).

The reference ``MaskedMHCA`` reshapes q/k/v to (B, nh, hs, T) without a
transpose (ref: model/blocks.py:427-429), so attention runs over each head's
*channel* axis with an (hs x hs) score matrix summed over T, and the output
reshape (ref: blocks.py:447) interleaves (T, hs) on the way back to
(B, C, T).  Trained checkpoints depend on both quirks, so they stay.

Eval dispatch follows the JAX ``fused_ok`` gate: with ``fused``, in eval
mode and C >= 32, a stride-1 block's attention front goes to
``ops.cuda.fused_attn`` and every block's ln2 + MLP + residual to
``ops.cuda.fused_mlp``.  The flow encoder (C = 17), the strided branch
attention and every block in train mode take the plain PyTorch path (the
kernels have no backward, as in JAX).  Train mode adds the JAX dropout
sites: ``attn_pdrop`` on the attention weights, ``proj_pdrop`` after the
projection, the GELU and ``mlp.3``, and ``path_pdrop`` through the
drop-path scales.  The rates live on the block apart from the presence of
the ``drop_path_*`` scales, so ``set_drop_rates`` can zero them and keep the
parameter set.
The two kernels' weights are packed once per block and compute dtype
(``attn_pack`` / ``mlp_pack``) and cached on the block, keyed by each source
parameter's storage and version, so a steady forward packs nothing.  For
export, ``pin_packs`` turns each cached pack into buffers of its owner, which
a tracer sees as the program's state: an exported call makes no pack.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from otpose_tpu_torch.models import core
from otpose_tpu_torch.models.core import AffineScale, Conv1d, LayerNormCT
from otpose_tpu_torch.ops.cuda.fused_attn import (channel_attention_ct, fused_attn_ct,
                                                   pack_attn_weights)
from otpose_tpu_torch.ops.cuda.fused_mlp import fused_mlp_residual_ct, pack_mlp_weights


def get_sinusoid_encoding(n_position: int, d_hid: int) -> torch.Tensor:
    """Sinusoid PE table in the reference layout (1, C, T), f32
    (ref: blocks.py:114-125)."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    j = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000, 2 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.from_numpy(table.astype(np.float32).T.copy())[None]


class MaskedMHCA(nn.Module):
    """Params of the reference MaskedMHCA (ref: blocks.py:319-453)."""

    def __init__(self, c: int):
        super().__init__()
        self.query_conv = Conv1d(1, c, 3, bias=False)   # depthwise (C, 1, 3)
        self.key_conv = Conv1d(1, c, 3, bias=False)
        self.value_conv = Conv1d(1, c, 3, bias=False)
        self.query_norm = LayerNormCT(c)
        self.key_norm = LayerNormCT(c)
        self.value_norm = LayerNormCT(c)
        self.query = Conv1d(c, c, 1)
        self.key = Conv1d(c, c, 1)
        self.value = Conv1d(c, c, 1)
        self.proj = Conv1d(c, c, 1)


class TransformerBlock(nn.Module):
    """Pre-LN block with channel attention and a conv MLP
    (ref: blocks.py:185-280); ``mlp`` keeps the reference Sequential's
    indices 0 and 3."""

    def __init__(self, c: int, n_head: int, ds_stride: int = 1,
                 path_pdrop: float = 0.0, attn_pdrop: float = 0.0, proj_pdrop: float = 0.0):
        super().__init__()
        self.n_head, self.ds_stride = n_head, ds_stride
        self.attn_pdrop, self.proj_pdrop, self.path_pdrop = attn_pdrop, proj_pdrop, path_pdrop
        self.ln1 = LayerNormCT(c)
        self.ln2 = LayerNormCT(c)
        self.attn = MaskedMHCA(c)
        self.mlp = nn.ModuleDict({"0": Conv1d(c, 4 * c, 1), "3": Conv1d(4 * c, c, 1)})
        self.drop_path_attn = AffineScale(c) if path_pdrop > 0 else None
        self.drop_path_mlp = AffineScale(c) if path_pdrop > 0 else None

    def forward(self, x, fused: bool = True):
        return transformer_block_ct(self, x, fused=fused)


def set_drop_rates(model: nn.Module, *, attn: float = 0.0, proj: float = 0.0,
                   path: float = 0.0) -> nn.Module:
    """Set the dropout rates of every block of ``model`` (the drop-path
    scales stay)."""
    for m in model.modules():
        if isinstance(m, TransformerBlock):
            m.attn_pdrop, m.proj_pdrop, m.path_pdrop = attn, proj, path
    return model


def masked_mhca_ct(attn: MaskedMHCA, x, n_head: int, stride: int = 1, attn_drop=None):
    """Plain MaskedMHCA on normed (B, C, T) -> (B, C, T/stride), before the
    projection's dropout; ``attn_drop`` is applied to the attention weights."""
    q, k, v = (core.dense_1x1_ct(core.layer_norm_ct(
        core.depthwise_conv1d_k3_ct(x, conv.weight, stride=stride),
        norm.weight, norm.bias), lin.weight, lin.bias)
        for conv, norm, lin in ((attn.query_conv, attn.query_norm, attn.query),
                                (attn.key_conv, attn.key_norm, attn.key),
                                (attn.value_conv, attn.value_norm, attn.value)))
    return _mhca_tail_ct(attn, channel_attention_ct(q, k, v, n_head, drop=attn_drop), n_head)


def _mhca_tail_ct(attn: MaskedMHCA, pre, n_head: int):
    """The reference's scrambled reassembly (ref: blocks.py:447) of the
    pre-scramble ``att @ v`` (B, C, T), then the output projection."""
    b, c, t = pre.shape
    out = pre.reshape(b, n_head, c // n_head, t).transpose(2, 3).reshape(b, c, t)
    return core.dense_1x1_ct(out, attn.proj.weight, attn.proj.bias)


def _affine_drop_path(block: TransformerBlock, scale_mod, x):
    """JAX ``affine_drop_path_ct``: the scale, then drop-path, where the
    block has the scale."""
    if scale_mod is None:
        return x
    return core.drop_path(scale_mod(x), block.path_pdrop, block.training)


# the attributes under which modules cache their packs (``cached_pack``'s
# slots): the blocks' two and the refinement's DCN pack
PACK_SLOTS = ("_attn_pack", "_mlp_pack", "_dcn_pack")


@dataclasses.dataclass(frozen=True)
class PinnedPack:
    """A pack fixed by ``pin_packs``: its tensors are the owner's buffers
    ``<slot>_<field>``, its other fields are kept here."""
    kind: type
    slot: str
    scalars: dict
    tensors: tuple

    def pack(self, owner: nn.Module):
        return self.kind(**self.scalars,
                         **{f: getattr(owner, f"{self.slot}_{f}") for f in self.tensors})


def cached_pack(owner: nn.Module, slot: str, params, dtype, make):
    """``make()``, cached on ``owner`` under ``slot`` until one of ``params``
    changes storage, version or dtype (an in-place update,
    ``prepare_eval_params``, ``.to()``) or ``dtype`` changes.  A pinned pack
    is returned as it is."""
    hit = getattr(owner, slot, None)
    if isinstance(hit, PinnedPack):
        return hit.pack(owner)
    key = (dtype, params[0].device) + tuple((p.data_ptr(), p._version, p.dtype) for p in params)
    if hit is None or hit[0] != key:
        hit = (key, make())
        setattr(owner, slot, hit)
    return hit[1]


@torch.no_grad()
def pin_packs(model: nn.Module, run) -> int:
    """Drop every pack cached on ``model``'s modules, call ``run()`` (a
    forward, which packs what its path needs), and pin each pack it made:
    its tensors become buffers of the owner and ``cached_pack`` returns
    them from then on, whatever the parameters do.  For an exported
    program, whose state they join.  Returns the number of packs pinned."""
    for owner in model.modules():
        for slot in PACK_SLOTS:
            owner.__dict__.pop(slot, None)
    run()
    n = 0
    for owner in model.modules():
        for slot in PACK_SLOTS:
            hit = owner.__dict__.get(slot)
            if hit is None:
                continue
            fields = {f.name: getattr(hit[1], f.name) for f in dataclasses.fields(hit[1])}
            tensors = tuple(k for k, v in fields.items() if isinstance(v, torch.Tensor))
            for k in tensors:      # a copy made outside inference mode
                owner.register_buffer(f"{slot}_{k}", fields.pop(k).clone())
            setattr(owner, slot, PinnedPack(type(hit[1]), slot, fields, tensors))
            n += 1
    return n


def attn_pack(block: TransformerBlock, dtype):
    """The fused-attention weights of ``block`` packed for ``dtype``."""
    a = block.attn
    params = (block.ln1.weight, block.ln1.bias,
              a.query_conv.weight, a.key_conv.weight, a.value_conv.weight,
              a.query_norm.weight, a.query_norm.bias, a.key_norm.weight, a.key_norm.bias,
              a.value_norm.weight, a.value_norm.bias,
              a.query.weight, a.query.bias, a.key.weight, a.key.bias,
              a.value.weight, a.value.bias)
    return cached_pack(block, "_attn_pack", params, dtype,
                       lambda: pack_attn_weights(*params, dtype))


def mlp_pack(block: TransformerBlock, dtype):
    """The fused-MLP weights of ``block`` packed for ``dtype``; the
    per-channel drop-path scale commutes with the output matmul and is
    folded into W2/b2 (drop-path itself is the identity at eval)."""
    params = (block.ln2.weight, block.ln2.bias, block.mlp["0"].weight, block.mlp["0"].bias,
              block.mlp["3"].weight, block.mlp["3"].bias)
    scale = None if block.drop_path_mlp is None else block.drop_path_mlp.scale
    return cached_pack(block, "_mlp_pack", params + ((scale,) if scale is not None else ()),
                       dtype, lambda: pack_mlp_weights(*params, dtype, scale=scale))


def fused_attn_block_ct(block: TransformerBlock, x):
    """ln1 + q/k/v + channel attention of a stride-1 block through the
    fused-attention kernel; returns the pre-scramble ``att @ v``."""
    return fused_attn_ct(x, packed=attn_pack(block, x.dtype), n_head=block.n_head)


def fused_mlp_block_ct(block: TransformerBlock, x):
    """ln2 + MLP + residual through the fused-MLP kernel."""
    return fused_mlp_residual_ct(x, packed=mlp_pack(block, x.dtype))


def transformer_block_ct(block: TransformerBlock, x, fused: bool = True):
    """(B, C, T) -> (B, C, T/ds_stride), in the block's mode."""
    n_head, ds, train = block.n_head, block.ds_stride, block.training
    drop = lambda t: core.dropout(t, block.proj_pdrop, train)  # noqa: E731
    fused_ok = fused and not train and x.shape[1] >= 32
    if fused_ok and ds == 1:
        out = _mhca_tail_ct(block.attn, fused_attn_block_ct(block, x), n_head)
    else:
        out = masked_mhca_ct(block.attn, block.ln1(x), n_head, stride=ds,
                             attn_drop=lambda t: core.dropout(t, block.attn_pdrop, train))
    skip = core.max_pool1d_ct(x, ds + 1, ds, (ds + 1) // 2) if ds > 1 else x
    out = skip + _affine_drop_path(block, block.drop_path_attn, drop(out))
    if fused_ok:
        return fused_mlp_block_ct(block, out)
    h = block.ln2(out)
    h = drop(core.gelu(core.dense_1x1_ct(h, block.mlp["0"].weight, block.mlp["0"].bias)))
    h = drop(core.dense_1x1_ct(h, block.mlp["3"].weight, block.mlp["3"].bias))
    return out + _affine_drop_path(block, block.drop_path_mlp, h)
