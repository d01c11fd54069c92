"""Sequence parallelism: the conv-transformer's token axis over the ranks of a
seq group (the counterpart of the JAX package's ``Ctx.seq_axis``).

JAX shards the token axis T = H W with two sharding constraints
(``otpose_tpu/models/conv_transformer.py:90-135``) and XLA's partitioner
writes the communication.  Here one process runs each rank, so the
communication is written out, each piece a ``torch.autograd.Function`` over
this rank's seq group (``parallel/distributed.py``):

- ``shard_tokens``: this rank's contiguous slice [lo, hi) of a replicated
  (B, C, T); its backward all-gathers the slices' gradients, so the
  replicated layers upstream get the whole gradient on every rank;
- ``gather_tokens``: the whole (B, C, T) from the slices; the layers
  downstream are replicated (every rank computes the same loss), so its
  backward is this rank's slice of the gradient, not a sum;
- ``halo``: a slice with the ``left`` tokens before it and the ``right``
  tokens after it attached (the k = 3 depthwise convs, the max-pool skip,
  the window attention's keys and values), taken from as many neighbouring
  slices as they span, and ``fill`` (the op's own padding) past T's two
  ends; the backward returns each halo's gradient to its owners;
  ``strided_halo`` is the halo a strided window reads (the k = 3 convs and
  the max-pool skip), with the op's padding past T where the last slice's
  length is not a multiple of the stride;
- ``all_reduce_partial``: a sum whose gradient is the same sum (the channel
  attention's scores, which contract over T);
- ``scramble_across``: the reference's reassembly of the attention output,
  a permutation across the whole of T (output token j of a head's row i is
  its input token (i T + j) // hs): the slices are all-gathered, scrambled,
  and this rank's slice is kept; the backward gathers the gradient's
  slices and unscrambles them.

Everything travels by ``all_gather`` and ``all_reduce``, which gloo also
runs on CUDA tensors.  Slices may be uneven, as JAX's partitioner pads a T
that the seq size does not divide: ``SeqGroup.split`` cuts T into units of
the encoder's total stride, gives each rank ``units // size`` of them and
the first ``units % size`` ranks one more, so every interior boundary
falls on a multiple of every level's stride and a strided block's output
slice stays on its rank; the last slice that holds a unit ends at T (its
last unit short when the stride does not divide T), and ``SeqGroup.down``
gives the next level's split.  Where T has fewer units than ranks, the
ranks past them hold empty slices, as JAX's partitioner pads such a T; an
empty slice joins every collective, in the same order as the others, and
its ops run at length 0.  The gathers pad each slice to the longest and
trim it by the known lengths (nothing is padded when the slices are equal),
and a halo exchanges its fixed number of tokens whatever a slice's length.
Without a seq group (one process) every function is the identity on a
whole T.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from otpose_tpu_torch.parallel import distributed


def split_lengths(t: int, size: int, stride: int = 1) -> tuple:
    """Each of ``size`` ranks' slice length of a length-``t`` axis, cut into
    units of ``stride`` tokens (the last unit short if ``stride`` does not
    divide ``t``): ``units // size`` units a rank and one more for each of
    the first ``units % size`` ranks.  With fewer units than ranks, the
    ranks past them hold none: no token at the encoder's deepest level."""
    units = -(-t // stride)
    q, r = divmod(units, size)
    lengths = [(q + (i < r)) * stride for i in range(size)]
    lengths[size - 1 if q else r - 1] -= units * stride - t   # the last unit's rank
    return tuple(lengths)


@dataclasses.dataclass(frozen=True)
class SeqGroup:
    """This rank's place on the ``seq`` axis: ``index`` of ``size``; after
    ``split``, every rank's slice length ``lengths`` of the axis at hand."""
    size: int
    index: int
    lengths: Optional[tuple] = None

    def split(self, t: int, stride: int = 1) -> "SeqGroup":
        """This group with ``split_lengths(t, size, stride)``."""
        return dataclasses.replace(self, lengths=split_lengths(t, self.size, stride))

    def down(self, stride: int) -> "SeqGroup":
        """The split of the axis a stride-``stride`` block gives (length
        ceil(T / stride)): each boundary divided by ``stride``."""
        ends = np.cumsum(self._lengths())
        if any(e % stride for e in ends[:-1] if e < ends[-1]):
            raise ValueError(f"a stride-{stride} block needs every interior slice boundary "
                             f"on a multiple of {stride}; the slices are {self.lengths}")
        return dataclasses.replace(self, lengths=tuple(np.diff(-(-ends // stride),
                                                               prepend=0).tolist()))

    @property
    def total(self) -> int:
        """The whole axis' length."""
        return sum(self._lengths())

    def bounds(self) -> tuple:
        """``[lo, hi)`` of this rank's slice."""
        lengths = self._lengths()
        lo = sum(lengths[:self.index])
        return lo, lo + lengths[self.index]

    def _lengths(self) -> tuple:
        if self.lengths is None:
            raise ValueError("a seq group's slices are known after SeqGroup.split(T, stride)")
        return self.lengths


def _own(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y``, copied where it is ``x`` itself (an autograd Function returns a
    new tensor)."""
    return y.clone() if y is x else y


def _check_slice(x: torch.Tensor, seq: SeqGroup) -> None:
    lo, hi = seq.bounds()
    if x.shape[-1] != hi - lo:
        raise ValueError(f"seq rank {seq.index}'s slice has {x.shape[-1]} tokens, its split "
                         f"{seq.lengths} gives it {hi - lo}")


def _gather_slices(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """The whole last axis from every rank's slice ``x``: each slice padded
    to the longest (all_gather moves one shape), then trimmed to its own
    length."""
    _check_slice(x, seq)
    longest = max(seq.lengths)
    n = x.shape[-1]
    parts = distributed.all_gather(x if n == longest else F.pad(x, (0, longest - n)), "seq")
    return torch.cat([p if m == longest else p[..., :m] for p, m in zip(parts, seq.lengths)],
                     dim=-1)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        lo, hi = seq.bounds()
        return _own(x[..., lo:hi].contiguous(), x)

    @staticmethod
    def backward(ctx, g):
        return _gather_slices(g, ctx.seq), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _gather_slices(x, seq)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.seq.bounds()
        return g[..., lo:hi].contiguous(), None


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, fill, seq):
        t = x.shape[-1]
        ctx.seq, ctx.left, ctx.right, ctx.t = seq, left, right, t
        # each rank sends its tail (the next ranks' left halos) and its head
        # (the previous ranks' right halos), the whole slice where it is
        # shorter: left + right tokens whatever the slice's length
        tail, head = x[..., max(0, t - left):], x[..., :right]
        parts = distributed.all_gather(torch.cat(
            [F.pad(tail, (left - tail.shape[-1], 0)), F.pad(head, (0, right - head.shape[-1]))],
            dim=-1))
        n = seq.lengths
        edge = lambda k: x.new_full(x.shape[:-1] + (k,), fill)  # noqa: E731
        # the left halo from the slices before, nearest last; the right one
        # from the slices after; fill past T's ends
        before = torch.cat([edge(left)] + [parts[j][..., left - min(left, n[j]):left]
                                           for j in range(seq.index)], dim=-1)
        after = torch.cat([parts[j][..., left:left + min(right, n[j])]
                           for j in range(seq.index + 1, seq.size)] + [edge(right)], dim=-1)
        return torch.cat([before[..., before.shape[-1] - left:], x, after[..., :right]], dim=-1)

    @staticmethod
    def backward(ctx, g):
        seq, left, right, t = ctx.seq, ctx.left, ctx.right, ctx.t
        # the halos' gradients go back to the slices they came from: the
        # next ranks' left halos hold this slice's last tokens, the previous
        # ranks' right halos its first, nearest rank first
        parts = distributed.all_gather(torch.cat([g[..., :left], g[..., left + t:]], dim=-1))
        gx = g[..., left:left + t].clone()
        ends = np.cumsum((0,) + tuple(seq.lengths)).tolist()
        lo, hi = ends[seq.index], ends[seq.index + 1]
        for j in range(seq.index + 1, seq.size):     # rank j's left halo: [ends[j] - left, ends[j])
            a, b = max(ends[j] - left, lo), min(ends[j], hi)
            if a < b:
                at = a - (ends[j] - left)
                gx[..., a - lo:b - lo] += parts[j][..., at:at + b - a]
        for j in range(seq.index - 1, -1, -1):       # rank j's right halo: [ends[j + 1], + right)
            a, b = max(ends[j + 1], lo), min(ends[j + 1] + right, hi)
            if a < b:
                at = left + a - ends[j + 1]
                gx[..., a - lo:b - lo] += parts[j][..., at:at + b - a]
        return gx, None, None, None, None


class _PartialSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return distributed.all_reduce_(x.clone(), group="seq")

    @staticmethod
    def backward(ctx, g):
        return distributed.all_reduce_(g.contiguous().clone(), group="seq")


def scramble(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """The reference's reassembly of a whole (B, C, T) (ref:
    blocks.py:447): each head's (hs, T) read as (T, hs) and back."""
    b, c, t = x.shape
    return x.reshape(b, n_head, c // n_head, t).transpose(2, 3).reshape(b, c, t)


def _unscramble(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, c, t = x.shape
    return x.reshape(b, n_head, t, c // n_head).transpose(2, 3).reshape(b, c, t)


class _ScrambleAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre, n_head, seq):
        ctx.seq, ctx.n_head = seq, n_head
        lo, hi = seq.bounds()
        return scramble(_gather_slices(pre, seq), n_head)[..., lo:hi].contiguous()

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.seq.bounds()
        return (_unscramble(_gather_slices(g, ctx.seq), ctx.n_head)[..., lo:hi].contiguous(),
                None, None)


def shard_tokens(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """This rank's slice of the last axis of a replicated ``x``."""
    return _Shard.apply(x, seq)


def gather_tokens(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """The whole last axis from every rank's slice ``x``."""
    return _Gather.apply(x, seq)


def halo(x: torch.Tensor, left: int, right: int, seq: SeqGroup,
         fill: float = 0.0) -> torch.Tensor:
    """``x`` (this rank's slice, last axis tokens) with the ``left`` tokens
    before it and the ``right`` tokens after it attached, from as many
    neighbouring slices as they span; ``fill`` past T's two ends."""
    _check_slice(x, seq)
    return _Halo.apply(x, left, right, fill, seq)


def strided_halo(x: torch.Tensor, left: int, kernel: int, stride: int, seq: SeqGroup,
                 fill: float = 0.0) -> torch.Tensor:
    """``x`` with what a window of ``kernel`` taps at ``stride``, the first
    reading ``left`` tokens before the slice, reads for the slice's
    ceil(n / stride) outputs: ``halo``'s ``left`` tokens and the
    ``kernel - left - stride`` (at least 0) that follow an interior slice,
    whose length is a multiple of ``stride``; then ``fill`` for the taps
    past T of a last slice whose length is not."""
    n = x.shape[-1]
    right = max(0, kernel - left - stride)
    y = halo(x, left, right, seq, fill)
    past = (-(-n // stride) - 1) * stride + kernel - left - n
    return F.pad(y, (0, past - right), value=fill) if past > right else y


def all_reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """The sum over the seq group of each rank's partial ``x``; its gradient
    is the sum of the ranks' gradients."""
    return _PartialSum.apply(x)


def scramble_across(pre: torch.Tensor, n_head: int, seq: SeqGroup) -> torch.Tensor:
    """This rank's slice of the reference's reassembly of the whole
    pre-scramble ``att @ v`` whose slice is ``pre`` (B, C, its slice of T)."""
    return _ScrambleAcross.apply(pre, n_head, seq)
