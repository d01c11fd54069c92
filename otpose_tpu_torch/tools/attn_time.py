"""Time the fused attention and MLP kernels at the eval step's shapes.

    python -m otpose_tpu_torch.tools.attn_time

Times ``ops/cuda/fused_attn.py::fused_attn_ct`` (``csrc/fused_attn.cu``) and
``ops/cuda/fused_mlp.py::fused_mlp_residual_ct`` (``csrc/fused_mlp.cu``) with
weights packed once, as the model calls them, by CUDA events around 20 eager
calls after 2 warm-up ones, and by replaying a CUDA graph of 20 calls (the
device's time without the wrapper's host work): at the flagship shape (C =
136, T = 6912, two heads) in bf16 at B = 16 and B = 1 and in f32 at B = 16,
and at the temporal encoders' shapes at 26 and 133 joints (C = 208 and 1064,
B = 2, the kernels' wide paths) in both dtypes.  Each case draws its inputs
from a seed of its own, and reports whether two calls give the same bits
and a digest of the output's bits, so that two checkouts' outputs can be
compared.  Prints one JSON line of ms by case beside the card's name, the
device ms and launches a call of each of the call's kernels by name and
template arguments (``torch.profiler`` over 5 calls)
and the compiler's register and spill report of both libraries.  A shape
the checkout's ``supports`` refuses is reported as not taken.  To time
another checkout's kernels (the parent commit's, for a comparison in one
call), run this file by its path with that checkout first on the path:

    PYTHONPATH=<checkout> python otpose_tpu_torch/tools/attn_time.py

Needs a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import math
import subprocess
import sys

import torch

# (kernel, B, C, dtype): the flagship's eval and inference cases, then the
# wide encoders' at 26 and 133 joints
CASES = tuple((name, b, c, dtype) for name in ("fused_attn", "fused_mlp")
              for b, c, dtype in ((16, 136, torch.bfloat16), (1, 136, torch.bfloat16),
                                  (16, 136, torch.float32), (2, 208, torch.bfloat16),
                                  (2, 208, torch.float32), (2, 1064, torch.bfloat16),
                                  (2, 1064, torch.float32)))
T = 6912
N_HEAD = 2


def _attn_case(batch: int, c: int, dtype, gen):
    """x and the 17 weights of ``fused_attn_ct`` at O(1) scales, as
    ``chip_smoke.py::attn_case`` draws them (q and k's projections small in
    bf16, so that |S| stays near 10).  Kept here so the tool runs against
    another checkout's package."""
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device="cuda") * scale  # noqa: E731
    w = [1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    w += [r(c, 1, 3, scale=1 / math.sqrt(3)).to(dtype) for _ in range(3)]
    for _ in range(3):
        w += [1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    for p in range(3):
        small = dtype == torch.bfloat16 and p < 2
        w += [r(c, c, 1, scale=(0.25 if small else 1.0) / math.sqrt(c)).to(dtype),
              r(c, scale=0.01 if small else 0.1).to(dtype)]
    return r(batch, c, T).to(dtype), w


def _mlp_case(batch: int, c: int, dtype, gen):
    """x and the 6 weights of ``fused_mlp_residual_ct``, as
    ``chip_smoke.py::mlp_case`` draws them."""
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device="cuda") * scale  # noqa: E731
    return r(batch, c, T).to(dtype), [
        1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1),
        r(4 * c, c, 1, scale=1 / math.sqrt(c)).to(dtype), r(4 * c, scale=0.1).to(dtype),
        r(c, 4 * c, 1, scale=1 / math.sqrt(4 * c)).to(dtype), r(c, scale=0.1).to(dtype)]


def kernel_name(key: str) -> str:
    """A profiler event's kernel name without its namespace and argument
    list, its template arguments kept (they tell a kernel's instantiations
    apart)."""
    key = key.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(key):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return key[:i]
    return key


def device_split(fn, calls: int = 5) -> dict:
    """{kernel name: [device ms a call, launches a call]} of the kernels
    ``fn()`` launches, by ``torch.profiler`` over ``calls`` calls (kept in
    this file, which runs against another checkout's package too)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        dev = getattr(e, "self_cuda_time_total", 0) if dev is None else dev
        if dev > 0:
            ms, n = split.get(kernel_name(e.key), (0.0, 0.0))
            split[kernel_name(e.key)] = [ms + dev / 1e3 / calls, n + e.count / calls]
    return split


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("attn_time: needs a CUDA device")
    from otpose_tpu_torch.ops.cuda import build, fused_attn, fused_mlp
    from otpose_tpu_torch.utils.timing import graph_ms, time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    ms, graph, same, digest, kernels = {}, {}, {}, {}, {}
    for i, (name, batch, c, dtype) in enumerate(CASES):
        key = f"{name} {str(dtype)[6:]} B={batch} C={c}"
        gen = torch.Generator(device="cuda").manual_seed(31 + i)
        if name == "fused_attn":
            if not fused_attn.supports(c, N_HEAD, dtype):
                ms[key] = "not taken"
                continue
            x, weights = _attn_case(batch, c, dtype, gen)
            pk = fused_attn.pack_attn_weights(*weights, dtype)

            def call():
                return fused_attn.fused_attn_ct(x, packed=pk, n_head=N_HEAD)
        else:
            if not fused_mlp.supports(c, dtype):
                ms[key] = "not taken"
                continue
            x, weights = _mlp_case(batch, c, dtype, gen)
            pk = fused_mlp.pack_mlp_weights(*weights, dtype)

            def call():
                return fused_mlp.fused_mlp_residual_ct(x, packed=pk)

        with torch.no_grad():
            first = call()
            same[key] = torch.equal(call(), first)
            digest[key] = _digest(first)
            del first
            ms[key] = time_ms(call, iters=20)
            graph[key] = graph_ms(call)
            kernels[key] = device_split(call)
        del x, weights, pk
        torch.cuda.empty_cache()
    report = {name: [line.strip() for line in build.ptxas_report.get(name, "").splitlines()
                     if "registers" in line or "spill" in line or "properties for" in line]
              for name in ("fused_attn", "fused_mlp")}
    print(json.dumps({"source": fused_attn.__file__, "card": card, "ms": ms, "graph_ms": graph,
                      "two_calls_bit_equal": same, "digest": digest, "kernel_ms": kernels,
                      "ptxas": report}), flush=True)


if __name__ == "__main__":
    main()
