"""A/B: the fused-MLP kernel in a train-mode forward (counterpart of
``tools/exp_fused_train_mlp.py``).

    python -m otpose_tpu_torch.tools.exp_fused_train_mlp [--batch 8] [--blocks 6]
        [--iters 10] [--rounds 3]
    python -m otpose_tpu_torch.tools.exp_fused_train_mlp --device cpu --tokens 256 --iters 1

The model's train step runs every block on its plain path: the fused MLP
(``otpose::fused_mlp``, ``csrc/fused_mlp.cu``) has no backward.
``FusedMlpBlock`` gives it one: its forward is the registered op on detached
inputs; its backward recomputes the block's plain version
(``ops/cuda/fused_mlp.py::fused_mlp_plain``: LN, the 1x1 C -> 4C, erf GELU,
the 1x1 4C -> C, the residual) and returns that recompute's vector-Jacobian
product, as the JAX tool's ``custom_vjp`` does.  The kernel has no dropout,
so both arms run without it.

The tool times the gradient of ``sum(x)`` after a chain of ``--blocks``
blocks with respect to the input and every weight, plain against fused, in
``--rounds`` interleaved rounds of ``--iters`` calls (B = 8, C = 136,
T = 6912, bf16 on the card; f32 on the CPU, where the op runs its plain
version), each round's ms a call by CUDA events (the host's clock on the
CPU), and prints each arm's ms and the fused arm's share of the plain one.
Before that, on one block and one upstream gradient, it prints how far the
fused arm's gradients are from the plain arm's: they come from the same
plain recompute.

The accounting that the JAX tool gives (why the fused arm may lose): the
plain forward and backward keep the GELU's input for the backward; the fused
arm runs the kernel and then the whole plain forward again in its backward,
trading the stored intermediate for a second forward's products.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from otpose_tpu_torch.ops.cuda import fused_mlp
from otpose_tpu_torch.utils import profiling

PARAMS = ("ln_w", "ln_b", "w1", "b1", "w2", "b2")


class FusedMlpBlock(torch.autograd.Function):
    """x + W2 gelu(W1 LN(x) + b1) + b2 on (B, C, T): the forward by
    ``otpose::fused_mlp``, the backward by the plain block's VJP."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2)
        with torch.no_grad():
            return fused_mlp.fused_mlp_residual_ct(
                *(t.detach() for t in (x, ln_w, ln_b, w1, b1, w2, b2)))

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = fused_mlp.fused_mlp_plain(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def mlp_block_plain(x, p: dict):
    return fused_mlp.fused_mlp_plain(x, *(p[k] for k in PARAMS))


def mlp_block_fused(x, p: dict):
    return FusedMlpBlock.apply(x, *(p[k] for k in PARAMS))


def make_inputs(batch: int, channels: int, tokens: int, blocks: int, dtype, device):
    """The JAX tool's draws (``RandomState(0)``: x, then each block's LN,
    W1, b1, W2, b2) in the port's layouts: x (B, C, T) in ``dtype``, f32
    weights (4C, C, 1) and (C, 4C, 1) that require grad."""
    rng = np.random.RandomState(0)
    c = channels
    x = torch.from_numpy(rng.randn(batch, c, tokens).astype(np.float32)).to(device, dtype)
    params = []
    for _ in range(blocks):
        raw = {"ln_w": rng.randn(c) * 0.1 + 1.0, "ln_b": rng.randn(c) * 0.1,
               "w1": rng.randn(1, c, 4 * c) * 0.05, "b1": rng.randn(4 * c) * 0.01,
               "w2": rng.randn(1, 4 * c, c) * 0.05, "b2": rng.randn(c) * 0.01}
        for k in ("w1", "w2"):                 # (1, C_in, C_out) -> (C_out, C_in, 1)
            raw[k] = raw[k][0].T[:, :, None]
        params.append({k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32,
                                       device=device).requires_grad_()
                       for k, v in raw.items()})
    return x.requires_grad_(), params


def value_and_grad(block_fn, x, params):
    """sum(chain(x)) in f32 and its gradients with respect to x and every
    weight (in ``PARAMS`` order, block by block)."""
    y = x
    for p in params:
        y = block_fn(y, p)
    loss = y.float().sum()
    leaves = [x] + [p[k] for p in params for k in PARAMS]
    return loss.detach(), torch.autograd.grad(loss, leaves)


def one_block_gradients(x, p, seed: int = 0) -> dict:
    """One block, one upstream gradient (N(0, 1) from ``seed``): each
    arm's gradients with respect to x and the weights, and its output."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    g = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    leaves = [x] + [p[k] for k in PARAMS]
    out = {}
    for arm, fn in (("plain", mlp_block_plain), ("fused", mlp_block_fused)):
        y = fn(x, p)
        out[arm] = (y.detach(), torch.autograd.grad(y, leaves, g))
    return out


def bound_ms(batch: int, channels: int, tokens: int, blocks: int, dtype) -> tuple:
    """The least time of one call on an H100 SXM (NVIDIA's dense peaks), and
    what bounds it: the gradient of the chain needs each block's forward
    products once and its backward's twice (three times 4 C^2 multiply-adds
    a token), at 989 TFLOP/s in bf16 or 495 in TF32 for f32; its bytes are x
    and the weights read once, x's gradient and the weights' written once,
    at 3.35 TB/s."""
    c, n = channels, batch * tokens
    ops = 3 * 2 * (2 * c * 4 * c) * n * blocks
    size = torch.tensor([], dtype=dtype).element_size()
    weights = blocks * (2 * 4 * c * c + 7 * c) * 4
    nbytes = 2 * n * c * size + 2 * weights
    peak = 989e12 if dtype == torch.bfloat16 else 495e12
    t_ops, t_bytes = ops / peak * 1e3, nbytes / 3.35e12 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _ms(fn, iters: int, device) -> float:
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def run(*, batch: int = 8, channels: int = 136, tokens: int = 6912, blocks: int = 6,
        iters: int = 10, rounds: int = 3, device=None, log=print) -> dict:
    """The parity lines and the timed rounds; returns {"plain_ms", "fused_ms"
    (a call, by round), "launches" (fused-MLP launches of the timed fused
    calls), "one_block" (max |fused - plain| a gradient and of the
    outputs), "loss" (each arm's)}."""
    from otpose_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    x, params = make_inputs(batch, channels, tokens, blocks, dtype, dev)
    arms = {"plain": mlp_block_plain, "fused": mlp_block_fused}
    grads = one_block_gradients(x, params[0])
    names = ["x"] + list(PARAMS)
    one = {n: (a - b).abs().max().item()
           for n, a, b in zip(names, grads["fused"][1], grads["plain"][1])}
    one["output"] = (grads["fused"][0].float() - grads["plain"][0].float()).abs().max().item()
    loss = {arm: value_and_grad(fn, x, params)[0].item() for arm, fn in arms.items()}
    log(f"one block, one upstream gradient: max |fused - plain| a gradient "
        + ", ".join(f"{k} {v:.3e}" for k, v in one.items())
        + f"; the chain's loss: plain {loss['plain']:.6e}, fused {loss['fused']:.6e}")
    plain_ms, fused_ms, launches = [], [], 0
    for rnd in range(rounds):
        tp = _ms(lambda: value_and_grad(mlp_block_plain, x, params), iters, dev)
        before = profiling.counters()
        tf = _ms(lambda: value_and_grad(mlp_block_fused, x, params), iters, dev)
        launches += profiling.since(before)["fused_mlp.launches"]
        plain_ms.append(tp)
        fused_ms.append(tf)
        log(f"round {rnd}: plain {tp:.3f} ms   fused (autograd Function) {tf:.3f} ms   "
            f"fused / plain {tf / tp:.3f} ({blocks} blocks, B={batch}, C={channels}, "
            f"T={tokens}, {str(dtype)[6:]}, forward and backward)")
    bound, by = bound_ms(batch, channels, tokens, blocks, dtype)
    log(f"bound of a call: {bound:.4f} ms ({by}; H100 SXM peaks)")
    return {"plain_ms": plain_ms, "fused_ms": fused_ms, "launches": launches,
            "one_block": one, "loss": loss, "bound_ms": bound, "bound_by": by}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--channels", type=int, default=136)
    ap.add_argument("--tokens", type=int, default=6912)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(batch=args.batch, channels=args.channels, tokens=args.tokens,
               blocks=args.blocks, iters=args.iters, rounds=args.rounds, device=args.device)


if __name__ == "__main__":
    main()
