"""Conv-transformer blocks on (B, C, T) (counterpart of
``otpose_tpu/models/blocks.py``, its ``_ct`` variants).

The reference ``MaskedMHCA`` reshapes q/k/v to (B, nh, hs, T) without a
transpose (ref: model/blocks.py:427-429), so attention runs over each head's
*channel* axis with an (hs x hs) score matrix summed over T, and the output
reshape (ref: blocks.py:447) interleaves (T, hs) on the way back to
(B, C, T).  Trained checkpoints depend on both quirks, so they stay.

A block built with ``mha_win_size > 1`` runs the reference's
``LocalMaskedMHCA`` instead (ref: blocks.py:479-833): token attention over a
window of +-(window // 2) positions, which the reference really transposes
to, as 2w + 1 shifted dot products with out-of-range positions at -inf
(``local_masked_mhca_ct``).

Eval dispatch follows the JAX ``fused_ok`` gate: with ``fused``, in eval
mode and C >= 32, a stride-1 global block's attention front goes to
``ops.cuda.fused_attn`` and every block's ln2 + MLP + residual, window
blocks' too, to ``ops.cuda.fused_mlp``, each where its kernel takes the
block's shape (``fused_attn.supports``: heads that divide C;
``fused_mlp.supports``: C up to 1152; past 160 channels both on their wide
paths), decided from the shape before any launch; JAX gates its attention
kernel alone on its own limit too.  The flow encoder at 17 joints (C =
17), the strided branch attention, the window attention, an MLP past 1152
channels and every block in train mode take the plain PyTorch path (the
kernels have no backward, as in JAX).
Train mode adds the JAX dropout sites: ``attn_pdrop`` on the attention
weights, ``proj_pdrop`` after the projection, the GELU and ``mlp.3``, and
``path_pdrop`` through the drop-path scales.  The rates live on the block apart from the presence of
the ``drop_path_*`` scales, so ``set_drop_rates`` can zero them and keep the
parameter set.
Under sequence parallelism (``seq``, a ``parallel/sequence.py::SeqGroup``
split over the block's input T; slices may be of unequal length, and the
output's split is ``seq.down(ds_stride)``) a block runs on this rank's
slice of T, as the JAX package's ``seq_axis`` does: the k = 3 depthwise
convs and the max-pool skip read one neighbour token through
``strided_halo`` (zero or -inf beyond the ends), the channel
attention's partial scores are summed over the seq group in f32 before the
softmax, the scramble is done across the slices (``scramble_across``), the
window attention's keys and values take ``w`` halo tokens with the mask and
``rel_pe`` at global positions, and each dropout mask is drawn whole and
sliced; LN, the 1x1 projections, the MLP and the residuals are local.
``fused_ok`` is off under ``seq``, as in JAX: no fused kernel runs.
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
from otpose_tpu_torch.ops.cuda import fused_attn, fused_mlp
from otpose_tpu_torch.ops.cuda.fused_attn import (channel_attention_ct, fused_attn_ct,
                                                   pack_attn_weights)
from otpose_tpu_torch.ops.cuda.fused_mlp import fused_mlp_residual_ct, pack_mlp_weights
from otpose_tpu_torch.parallel import sequence


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


class LocalMaskedMHCA(MaskedMHCA):
    """Params of the reference LocalMaskedMHCA (ref: blocks.py:479-833): the
    MaskedMHCA set, and with ``use_rel_pe`` the relative position bias
    ``rel_pe`` stored (1, 1, n_head, window) as the reference stores it."""

    def __init__(self, c: int, n_head: int, window: int, use_rel_pe: bool = False):
        super().__init__(c)
        self.rel_pe = (nn.Parameter(torch.zeros(1, 1, n_head, window)) if use_rel_pe
                       else None)


class TransformerBlock(nn.Module):
    """Pre-LN block with channel attention, or window attention when
    ``mha_win_size > 1``, and a conv MLP (ref: blocks.py:185-280); ``mlp``
    keeps the reference Sequential's indices 0 and 3."""

    def __init__(self, c: int, n_head: int, ds_stride: int = 1,
                 path_pdrop: float = 0.0, attn_pdrop: float = 0.0, proj_pdrop: float = 0.0,
                 mha_win_size: int = -1, use_rel_pe: bool = False):
        super().__init__()
        self.n_head, self.ds_stride, self.window = n_head, ds_stride, mha_win_size
        self.use_rel_pe = use_rel_pe
        self.attn_pdrop, self.proj_pdrop, self.path_pdrop = attn_pdrop, proj_pdrop, path_pdrop
        self.ln1 = LayerNormCT(c)
        self.ln2 = LayerNormCT(c)
        self.attn = (LocalMaskedMHCA(c, n_head, mha_win_size, use_rel_pe)
                     if mha_win_size > 1 else MaskedMHCA(c))
        self.mlp = nn.ModuleDict({"0": Conv1d(c, 4 * c, 1), "3": Conv1d(4 * c, c, 1)})
        self.drop_path_attn = AffineScale(c) if path_pdrop > 0 else None
        self.drop_path_mlp = AffineScale(c) if path_pdrop > 0 else None

    def forward(self, x, fused: bool = True, seq=None):
        return transformer_block_ct(self, x, fused=fused, seq=seq)


def set_drop_rates(model: nn.Module, *, attn: float = 0.0, proj: float = 0.0,
                   path: float = 0.0) -> nn.Module:
    """Set the dropout rates of every block of ``model`` (the drop-path
    scales stay)."""
    for m in model.modules():
        if isinstance(m, TransformerBlock):
            m.attn_pdrop, m.proj_pdrop, m.path_pdrop = attn, proj, path
    return model


def _qkv_ct(attn: MaskedMHCA, x, stride: int, seq=None):
    """q, k, v of normed (B, C, T): strided depthwise k = 3 conv, channel LN,
    1x1 projection each.  Under ``seq`` (the split of ``x``'s T) the convs
    read one token of each neighbouring slice (only the left one at stride
    2: output j reads inputs 2j - 1, 2j and 2j + 1, and a last slice of odd
    length reads one zero past T)."""
    if seq is not None:
        x = sequence.strided_halo(x, 1, 3, stride, seq)
    return (core.dense_1x1_ct(core.layer_norm_ct(
        core.depthwise_conv1d_k3_ct(x, conv.weight, stride=stride, padded=seq is not None),
        norm.weight, norm.bias), lin.weight, lin.bias)
        for conv, norm, lin in ((attn.query_conv, attn.query_norm, attn.query),
                                (attn.key_conv, attn.key_norm, attn.key),
                                (attn.value_conv, attn.value_norm, attn.value)))


def masked_mhca_ct(attn: MaskedMHCA, x, n_head: int, stride: int = 1, attn_drop=None,
                   seq=None):
    """Plain MaskedMHCA on normed (B, C, T) -> (B, C, T/stride), before the
    projection's dropout; ``attn_drop`` is applied to the attention weights.
    Under ``seq`` (the split of T) the scores are summed over the seq group
    and the output is reassembled across the output's slices."""
    q, k, v = _qkv_ct(attn, x, stride, seq)
    reduce = None if seq is None else sequence.all_reduce_partial
    pre = channel_attention_ct(q, k, v, n_head, drop=attn_drop, reduce=reduce)
    return _mhca_tail_ct(attn, pre, n_head, None if seq is None else seq.down(stride))


def local_masked_mhca_ct(attn: LocalMaskedMHCA, x, n_head: int, window: int,
                         stride: int = 1, attn_drop=None, use_rel_pe: bool = False,
                         seq=None):
    """LocalMaskedMHCA on normed (B, C, T) -> (B, C, T/stride), before the
    projection's dropout (JAX ``blocks.local_masked_mhca``).

    Head h's token t attends to tokens t - w .. t + w (w = window // 2):
    q (scaled by 1/sqrt(hs) first) against each of the 2w + 1 shifted keys,
    f32 scores, positions whose shifted index leaves [0, T) at -inf before
    the max-subtracted softmax, the relative bias ``rel_pe`` added where the
    block has it and ``use_rel_pe`` asks for it; ``attn_drop`` is applied to
    the weights in ``x.dtype``; each weighted shifted value is a product in
    ``x.dtype`` summed in f32.  Channel c = h * hs + j holds head h's
    feature j throughout.  In bf16 the JAX function's q scale (a numpy
    scalar) promotes the scores, the sum and the projection's output to f32;
    here the sum is rounded to ``x.dtype`` for the projection, so the block
    stays in its activation dtype.  Under ``seq`` (x a slice of T, ``seq``
    its split) the keys and values take ``w`` tokens of each neighbouring
    slice and the mask is at the output's global positions; ``attn_drop``
    then slices axis 2."""
    q, k, v = _qkv_ct(attn, x, stride, seq)
    b, c, t = q.shape
    hs = c // n_head
    w = window // 2
    qh = (q.float() * (1.0 / np.sqrt(hs))).reshape(b, n_head, hs, t)
    # zero padding stands in for the JAX package's roll: every position it
    # fills is masked to -inf in the scores and weighted 0 in the sum
    if seq is None:
        kp = torch.nn.functional.pad(k.reshape(b, n_head, hs, t), (w, w))
        vp = torch.nn.functional.pad(v.reshape(b, n_head, hs, t), (w, w))
        lo, total = 0, t
    else:
        seq = seq.down(stride)
        kp = sequence.halo(k.reshape(b, n_head, hs, t), w, w, seq)
        vp = sequence.halo(v.reshape(b, n_head, hs, t), w, w, seq)
        lo, total = seq.bounds()[0], seq.total
    idx = lo + torch.arange(t, device=x.device)
    scores = []
    for d in range(-w, w + 1):
        s = (qh * kp[..., w + d:w + d + t].float()).sum(dim=2)        # (B, nh, T)
        valid = (idx + d >= 0) & (idx + d < total)
        scores.append(torch.where(valid, s, float("-inf")))
    att = torch.stack(scores, dim=-1)                                   # (B, nh, T, 2w+1)
    if use_rel_pe and attn.rel_pe is not None:
        att = att + attn.rel_pe.float().transpose(1, 2)                 # (1, nh, 1, 2w+1)
    att = att - att.amax(dim=-1, keepdim=True)
    att = torch.exp(att)
    att = att / att.sum(dim=-1, keepdim=True)
    att = att.to(x.dtype)
    if attn_drop is not None:
        att = attn_drop(att)
    out = torch.zeros(b, n_head, hs, t, device=x.device)
    for j, d in enumerate(range(-w, w + 1)):
        out = out + (att[..., j][:, :, None, :] * vp[..., w + d:w + d + t]).float()
    return core.dense_1x1_ct(out.reshape(b, c, t).to(x.dtype), attn.proj.weight,
                             attn.proj.bias)


def _mhca_tail_ct(attn: MaskedMHCA, pre, n_head: int, seq=None):
    """The reference's scrambled reassembly (ref: blocks.py:447) of the
    pre-scramble ``att @ v`` (B, C, T), then the output projection; under
    ``seq`` the reassembly of the whole T, sliced."""
    out = (sequence.scramble(pre, n_head) if seq is None
           else sequence.scramble_across(pre, n_head, seq))
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


def _max_pool_skip(x, ds: int, seq=None):
    """The strided block's skip: max-pool of kernel ds + 1, stride ds and
    -inf padding (ds + 1) // 2; under ``seq`` (the split of ``x``'s T) the
    padding is the neighbouring slices' tokens, -inf only at the global
    ends."""
    k, pad = ds + 1, (ds + 1) // 2
    if seq is None:
        return core.max_pool1d_ct(x, k, ds, pad)
    xh = sequence.strided_halo(x, pad, k, ds, seq, fill=float("-inf"))
    if x.shape[-1] == 0:        # an empty slice: it joined the exchange, it has no output
        return xh[..., :0]
    return core.max_pool1d_ct(xh, k, ds, 0)[..., :-(-x.shape[-1] // ds)]


def transformer_block_ct(block: TransformerBlock, x, fused: bool = True, seq=None):
    """(B, C, T) -> (B, C, T/ds_stride), in the block's mode; under ``seq``
    (``SeqGroup.split`` of T) on this rank's slice of T (see the module
    docstring)."""
    n_head, ds, train = block.n_head, block.ds_stride, block.training
    out_seq = None if seq is None else seq.down(ds)
    drop = lambda t: core.dropout(t, block.proj_pdrop, train, out_seq)  # noqa: E731
    c = x.shape[1]
    fused_ok = fused and not train and seq is None and c >= 32
    attn_ok = fused_ok and ds == 1 and fused_attn.supports(c, n_head, x.dtype)
    mlp_ok = fused_ok and fused_mlp.supports(c, x.dtype)
    if block.window > 1:
        out = local_masked_mhca_ct(block.attn, block.ln1(x), n_head, block.window, stride=ds,
                                   attn_drop=lambda t: core.dropout(t, block.attn_pdrop, train,
                                                                    out_seq, dim=2),
                                   use_rel_pe=block.use_rel_pe, seq=seq)
    elif attn_ok:
        out = _mhca_tail_ct(block.attn, fused_attn_block_ct(block, x), n_head)
    else:
        out = masked_mhca_ct(block.attn, block.ln1(x), n_head, stride=ds,
                             attn_drop=lambda t: core.dropout(t, block.attn_pdrop, train),
                             seq=seq)
    skip = _max_pool_skip(x, ds, seq) if ds > 1 else x
    out = skip + _affine_drop_path(block, block.drop_path_attn, drop(out))
    if mlp_ok:
        return fused_mlp_block_ct(block, out)
    h = block.ln2(out)
    h = drop(core.gelu(core.dense_1x1_ct(h, block.mlp["0"].weight, block.mlp["0"].bias)))
    h = drop(core.dense_1x1_ct(h, block.mlp["3"].weight, block.mlp["3"].bias))
    return out + _affine_drop_path(block, block.drop_path_mlp, h)
