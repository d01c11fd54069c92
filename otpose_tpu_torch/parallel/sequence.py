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
- ``halo``: a slice with its neighbours' ``left`` and ``right`` tokens
  attached (the k = 3 depthwise convs, the max-pool skip, the window
  attention's keys and values); the first and last slices get ``fill``
  (the op's own padding), and the backward returns each halo's gradient to
  its owner;
- ``all_reduce_partial``: a sum whose gradient is the same sum (the channel
  attention's scores, which contract over T);
- ``scramble_across``: the reference's reassembly of the attention output,
  a permutation across the whole of T (output token j of a head's row i is
  its input token (i T + j) // hs): the slices are all-gathered, scrambled,
  and this rank's slice is kept; the backward gathers the gradient's
  slices and unscrambles them.

Everything travels by ``all_gather`` and ``all_reduce``, which gloo also
runs on CUDA tensors.  Slices are equal: ``check_shardable`` refuses a
length that the seq size and the encoder's strides do not divide.  Without
a seq group (one process) every function is the identity on a whole T.
"""

from __future__ import annotations

import dataclasses

import torch

from otpose_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class SeqGroup:
    """This rank's place on the ``seq`` axis: ``index`` of ``size``."""
    size: int
    index: int

    def bounds(self, t: int) -> tuple:
        """``[lo, hi)`` of this rank's slice of a length-``t`` axis."""
        n = t // self.size
        return self.index * n, (self.index + 1) * n


def check_shardable(t: int, size: int, stride: int = 1) -> None:
    """Raise unless ``t`` tokens split into ``size`` equal slices whose
    length the encoder's total ``stride`` (scale_factor ** arch[2]) divides."""
    if t % size or (t // size) % stride:
        raise ValueError(f"sequence parallelism over {size} ranks needs T / {size} to be a "
                         f"whole multiple of the encoder's stride {stride}; T = {t} is not "
                         f"(uneven shards are not supported)")


def _own(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y``, copied where it is ``x`` itself (an autograd Function returns a
    new tensor)."""
    return y.clone() if y is x else y


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        lo, hi = seq.bounds(x.shape[-1])
        return _own(x[..., lo:hi].contiguous(), x)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(distributed.all_gather(g, "seq"), dim=-1), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return torch.cat(distributed.all_gather(x, "seq"), dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.seq.bounds(g.shape[-1])
        return g[..., lo:hi].contiguous(), None


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, fill, seq):
        t = x.shape[-1]
        ctx.seq, ctx.left, ctx.right, ctx.t = seq, left, right, t
        # each rank sends its tail (the next rank's left halo) and its head
        # (the previous rank's right halo)
        parts = distributed.all_gather(torch.cat([x[..., t - left:], x[..., :right]], dim=-1))
        edge = lambda n: x.new_full(x.shape[:-1] + (n,), fill)  # noqa: E731
        prev = parts[seq.index - 1][..., :left] if seq.index > 0 else edge(left)
        nxt = parts[seq.index + 1][..., left:] if seq.index < seq.size - 1 else edge(right)
        return torch.cat([prev, x, nxt], dim=-1)

    @staticmethod
    def backward(ctx, g):
        seq, left, right, t = ctx.seq, ctx.left, ctx.right, ctx.t
        # the halos' gradients go back to the ranks they came from
        parts = distributed.all_gather(torch.cat([g[..., :left], g[..., left + t:]], dim=-1))
        gx = g[..., left:left + t].clone()
        if seq.index < seq.size - 1 and left:
            gx[..., t - left:] += parts[seq.index + 1][..., :left]
        if seq.index > 0 and right:
            gx[..., :right] += parts[seq.index - 1][..., left:]
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
        full = torch.cat(distributed.all_gather(pre, "seq"), dim=-1)
        lo, hi = seq.bounds(full.shape[-1])
        return scramble(full, n_head)[..., lo:hi].contiguous()

    @staticmethod
    def backward(ctx, g):
        full = torch.cat(distributed.all_gather(g, "seq"), dim=-1)
        lo, hi = ctx.seq.bounds(full.shape[-1])
        return _unscramble(full, ctx.n_head)[..., lo:hi].contiguous(), None, None


def shard_tokens(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """This rank's slice of the last axis of a replicated ``x``."""
    return _Shard.apply(x, seq)


def gather_tokens(x: torch.Tensor, seq: SeqGroup) -> torch.Tensor:
    """The whole last axis from every rank's slice ``x``."""
    return _Gather.apply(x, seq)


def halo(x: torch.Tensor, left: int, right: int, seq: SeqGroup,
         fill: float = 0.0) -> torch.Tensor:
    """``x`` (this rank's slice, last axis tokens) with the previous slice's
    last ``left`` and the next slice's first ``right`` tokens attached;
    ``fill`` beyond the first and last slices."""
    if left > x.shape[-1] or right > x.shape[-1]:
        raise ValueError(f"a halo of {left} + {right} tokens is wider than a slice of "
                         f"{x.shape[-1]}: use fewer seq ranks")
    return _Halo.apply(x, left, right, fill, seq)


def all_reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """The sum over the seq group of each rank's partial ``x``; its gradient
    is the sum of the ranks' gradients."""
    return _PartialSum.apply(x)


def scramble_across(pre: torch.Tensor, n_head: int, seq: SeqGroup) -> torch.Tensor:
    """This rank's slice of the reference's reassembly of the whole
    pre-scramble ``att @ v`` whose slice is ``pre`` (B, C, T / S)."""
    return _ScrambleAcross.apply(pre, n_head, seq)
