"""Core layers and ops of the port (counterpart of ``otpose_tpu/models/core.py``).

Parameters live in small ``nn.Module``s named so that a model's
``state_dict()`` keys equal the JAX package's flat param names (which are the
reference torch names, e.g. ``"stage2.0.branches.0.1.conv1.weight"``).
Tensors keep the torch layouts: conv2d weights OIHW, conv1d weights
(O, I, K), channel-LayerNorm and drop-path params (1, C, 1).

Feature maps run NCHW internally and token maps (B, C, T).  The compute
dtype is the activation dtype: every op casts its weights to ``x.dtype``,
matrix products accumulate in f32 and round to that dtype (the JAX package's
``_preferred`` / ``_mxu_precision`` rule), and norm statistics stay f32.

Train mode follows ``nn.Module.train()``: ``BatchNorm`` normalises with
batch statistics and records the running-stat update, which
``commit_bn_stats`` writes once per micro-batch (the JAX ``finalize_state``),
so a forward recomputed under ``torch.utils.checkpoint`` does not update the
stats twice; ``frozen`` runs a submodule on its running statistics with no
update and no graph (JAX ``Ctx.frozen`` plus ``stop_gradient``).  ``dropout``
and ``drop_path`` are the identity in eval and draw from the generator that
``use_generator`` installs (torch's default generator when there is none).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from otpose_tpu_torch.ops.ct import (LN_EPS, dense_1x1_ct, depthwise_conv1d_k3_ct,  # noqa: F401
                                     gelu, layer_norm_ct)
from otpose_tpu_torch.parallel import distributed

BN_EPS = 1e-5
BN_MOMENTUM = 0.1   # torch semantics: running = (1 - m) * running + m * batch

# the generator that dropout and drop-path draw from (``use_generator``)
_generator: torch.Generator | None = None


# ---------------------------------------------------------------------------
# functional ops
# ---------------------------------------------------------------------------

def conv2d(x, w, b=None, *, stride: int = 1, padding: int = 0,
           dilation: int = 1) -> torch.Tensor:
    """NCHW conv with an OIHW kernel in ``x.dtype``; the bias is added as a
    separate op after the rounding, as in the JAX package."""
    y = F.conv2d(x, w.to(x.dtype), None, stride=stride, padding=padding,
                 dilation=dilation)
    if b is not None:
        y = y + b.to(y.dtype)[:, None, None]
    return y


def batch_norm_eval(x, weight, bias, running_mean, running_var,
                    eps: float = BN_EPS) -> torch.Tensor:
    """Eval BN on NCHW as a per-channel affine computed in f32 and applied
    in the activation dtype (JAX ``core.batch_norm``, eval branch)."""
    inv = torch.rsqrt(running_var.float() + eps)
    scale = weight.float() * inv
    shift = bias.float() - running_mean.float() * scale
    return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def batch_norm_train(x, weight, bias, running_mean, running_var,
                     momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
    """Train BN on NCHW (JAX ``core.batch_norm``, train branch): batch
    statistics in f32 even for bf16 activations, ``var = E[x^2] - E[x]^2``
    (biased) to normalise, the unbiased ``var * n / (n - 1)`` for the running
    variance.  Returns (y in x's dtype, new running mean, new running var).

    Under a multi-process launch the statistics are the global batch's, as
    the JAX step's are: ``[mean, E[x^2]]`` averaged across the data group
    in one differentiable all-reduce (``parallel/distributed.py``), ``n``
    times the data group's size (the ranks of a seq group hold the same
    rows, so they count once)."""
    xf = x.float()
    n = x.numel() // x.shape[1]
    mean = xf.mean(dim=(0, 2, 3))
    mean_sq = (xf * xf).mean(dim=(0, 2, 3))
    if distributed.active():
        groups = distributed.group_size("data")
        mean, mean_sq = distributed.all_reduce_sum(torch.stack([mean, mean_sq])) / groups
        n = n * groups
    var = mean_sq - mean * mean
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    inv = torch.rsqrt(var + eps)
    c = (slice(None), None, None)
    y = (xf - mean[c]) * (inv * weight.float())[c] + bias.float()[c]
    return y.to(x.dtype), new_mean, new_var


def max_pool1d_ct(x, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """MaxPool over T of (B, C, T) with -inf padding."""
    return F.max_pool1d(x, kernel, stride, padding)


def upsample_linear_1d_ct(x, out_t: int) -> torch.Tensor:
    """Linear resampling of (B, C, T) to ``out_t`` (align_corners=False,
    edges clamped).  Integer factors use the shift-and-blend form of the JAX
    package so both round alike; other ratios gather."""
    b, c, t = x.shape
    if out_t == t:
        return x
    if out_t % t == 0:
        f = out_t // t
        left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
        right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
        phases = []
        for k in range(f):
            frac = (2 * k + 1) / (2 * f) - 0.5
            if frac < 0:
                phases.append((-frac) * left + (1 + frac) * x)
            elif frac == 0:
                phases.append(x)
            else:
                phases.append((1 - frac) * x + frac * right)
        return torch.stack(phases, dim=-1).reshape(b, c, t * f).to(x.dtype)
    dst = torch.arange(out_t, dtype=torch.float32, device=x.device)
    src = ((dst + 0.5) * (t / out_t) - 0.5).clamp(0.0, t - 1)
    i0 = torch.floor(src).long()
    i1 = torch.clamp(i0 + 1, max=t - 1)
    w1 = (src - i0.float()).to(x.dtype)
    return x[..., i0] * (1 - w1) + x[..., i1] * w1


@contextlib.contextmanager
def use_generator(gen: torch.Generator | None):
    """Dropout and drop-path inside the block draw from ``gen``."""
    global _generator
    prev, _generator = _generator, gen
    try:
        yield
    finally:
        _generator = prev


def _uniform(shape, like) -> torch.Tensor:
    return torch.rand(shape, generator=_generator, device=like.device)


def dropout(x, rate: float, training: bool, seq=None, dim: int = -1) -> torch.Tensor:
    """Elementwise dropout with ``x / keep`` on the kept elements (JAX
    ``Ctx.dropout``); the identity in eval or at rate 0.  With ``seq``
    (``parallel/sequence.py::SeqGroup``) ``x`` is this rank's slice of axis
    ``dim``: the mask is drawn whole and sliced, so it is the one-rank
    step's mask."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if seq is None:
        u = _uniform(x.shape, x)
    else:
        dim = dim % x.dim()
        n = x.shape[dim]
        whole = x.shape[:dim] + (n * seq.size,) + x.shape[dim + 1:]
        u = _uniform(whole, x).narrow(dim, seq.index * n, n)
    return torch.where(u < keep, x / keep, 0.0).to(x.dtype)


def drop_path(x, rate: float, training: bool) -> torch.Tensor:
    """Per-sample stochastic depth, scaled by ``1 / keep`` (JAX
    ``Ctx.drop_path``); the identity in eval or at rate 0."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.floor(keep + _uniform((x.shape[0],) + (1,) * (x.dim() - 1), x))
    return x / keep * mask.to(x.dtype)


def relu(x) -> torch.Tensor:
    return torch.relu(x)


def upsample_nearest(x, factor: int) -> torch.Tensor:
    """Nearest-neighbour spatial upsampling of NCHW by an integer factor."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


# ---------------------------------------------------------------------------
# parameter modules
# ---------------------------------------------------------------------------

class Conv2d(nn.Module):
    """Weight (O, I, kh, kw) and optional bias (O,)."""

    def __init__(self, cin: int, cout: int, kernel: int, *, bias: bool = False,
                 stride: int = 1, padding: int = 0, dilation: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, stride=self.stride,
                      padding=self.padding, dilation=self.dilation)


class BatchNorm(nn.Module):
    """BatchNorm2d params and running stats without ``num_batches_tracked``
    (the JAX package keeps no such buffer).  In train mode a forward keeps
    its running-stat update in ``pending`` until ``commit_bn_stats``."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.pending = None

    def forward(self, x):
        if not self.training:
            return batch_norm_eval(x, self.weight, self.bias, self.running_mean,
                                   self.running_var)
        y, mean, var = batch_norm_train(x, self.weight, self.bias, self.running_mean,
                                        self.running_var)
        self.pending = (mean, var)
        return y


@torch.no_grad()
def commit_bn_stats(model: nn.Module) -> int:
    """Write every pending train-mode BN update of ``model`` to its running
    stats; returns how many were written."""
    n = 0
    for m in model.modules():
        if isinstance(m, BatchNorm) and m.pending is not None:
            m.running_mean.copy_(m.pending[0])
            m.running_var.copy_(m.pending[1])
            m.pending = None
            n += 1
    return n


@contextlib.contextmanager
def frozen(module: nn.Module):
    """Run ``module`` as a frozen submodule: eval mode (BN on running stats,
    no update, no dropout) and no autograd graph, so its output is detached
    and none of its parameters gets a gradient; its mode is restored after."""
    was = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        for m, training in was:
            m.training = training


class LayerNormCT(nn.Module):
    """Channel LayerNorm of (B, C, T); params stored (1, C, 1)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(1, ch, 1))
        self.bias = nn.Parameter(torch.zeros(1, ch, 1))

    def forward(self, x):
        return layer_norm_ct(x, self.weight, self.bias)


class Conv1d(nn.Module):
    """conv1d params: weight (O, I, K), optional bias (O,)."""

    def __init__(self, cin: int, cout: int, kernel: int, *, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class AffineScale(nn.Module):
    """The reference AffineDropPath's per-channel scale, stored (1, C, 1)."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(1e-4 * torch.ones(1, ch, 1))

    def forward(self, x):
        return x * self.scale.to(x.dtype)


def conv_bn(cin: int, cout: int, kernel: int, **kw) -> nn.ModuleDict:
    """``{"0": conv, "1": bn}`` — the reference's Sequential(conv, BN)."""
    return nn.ModuleDict({"0": Conv2d(cin, cout, kernel, **kw),
                          "1": BatchNorm(cout)})


# ---------------------------------------------------------------------------
# initializers (the JAX package's distributions, drawn from a torch.Generator)
# ---------------------------------------------------------------------------

@torch.no_grad()
def normal_(t: torch.Tensor, gen: torch.Generator, std: float = 0.001):
    t.copy_(torch.randn(t.shape, generator=gen) * std)


@torch.no_grad()
def kaiming_uniform_(t: torch.Tensor, gen: torch.Generator, a=math.sqrt(5)):
    """torch's default conv init on an (O, I, K...) weight."""
    fan_in = t[0].numel()
    bound = math.sqrt(2.0 / (1 + a ** 2)) * math.sqrt(3.0 / fan_in)
    t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)
