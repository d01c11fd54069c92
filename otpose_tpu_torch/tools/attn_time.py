"""Time the fused attention kernel at the eval step's shapes.

    python -m otpose_tpu_torch.tools.attn_time

Times ``ops/cuda/fused_attn.py::fused_attn_ct`` (``csrc/fused_attn.cu``) with
weights packed once, as the model calls it, by CUDA events around 20 eager
calls after 2 warm-up ones, and by replaying a CUDA graph of 20 calls (the
device's time without the wrapper's host work), at the flagship shape
(C = 136, T = 6912, two heads) in bf16 at B = 16 and B = 1 and in f32 at
B = 16, and whether two calls give the same bits.  Prints one JSON line of
ms by case beside the card's name, the device ms of each of the call's
kernels (``torch.profiler`` over 5 calls) and the compiler's register and
spill report of the attention's kernels.  To time another checkout's kernel (the
parent commit's, for a comparison in one call), run this file by its path
with that checkout first on the path:

    PYTHONPATH=<checkout> python otpose_tpu_torch/tools/attn_time.py

Needs a CUDA device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

import torch

CASES = ((16, torch.bfloat16), (1, torch.bfloat16), (16, torch.float32))


def _case(batch: int, dtype, gen):
    """x and the 17 weights of ``fused_attn_ct`` at O(1) scales, as
    ``chip_smoke.py::attn_case`` draws them (q and k's projections small in
    bf16, so that |S| stays near 10).  Kept here so the tool runs against
    another checkout's package."""
    c = 136
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device="cuda") * scale  # noqa: E731
    w = [1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    w += [r(c, 1, 3, scale=1 / math.sqrt(3)).to(dtype) for _ in range(3)]
    for _ in range(3):
        w += [1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    for p in range(3):
        small = dtype == torch.bfloat16 and p < 2
        w += [r(c, c, 1, scale=(0.25 if small else 1.0) / math.sqrt(c)).to(dtype),
              r(c, scale=0.01 if small else 0.1).to(dtype)]
    return r(batch, c, 6912).to(dtype), w


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("attn_time: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from otpose_tpu_torch.ops.cuda import build, fused_attn
    from otpose_tpu_torch.utils.timing import graph_ms, time_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(31)
    ms, graph, same, kernels = {}, {}, {}, {}
    for batch, dtype in CASES:
        x, weights = _case(batch, dtype, gen)
        pk = fused_attn.pack_attn_weights(*weights, dtype)

        def call():
            return fused_attn.fused_attn_ct(x, packed=pk, n_head=2)

        key = f"{str(dtype)[6:]} B={batch}"
        with torch.no_grad():
            same[key] = torch.equal(call(), call())
            ms[key] = time_ms(call, iters=20)
            graph[key] = graph_ms(call)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
        kernels[key] = {}
        for e in prof.key_averages():
            dev = getattr(e, "self_device_time_total", None)
            dev = getattr(e, "self_cuda_time_total", 0) if dev is None else dev
            if dev > 0:
                kernels[key][e.key[:60]] = dev / 5e3     # us over 5 calls -> ms a call
    report = [line.strip() for line in build.ptxas_report.get("fused_attn", "").splitlines()
              if "registers" in line or "spill" in line or "properties for" in line]
    print(json.dumps({"source": fused_attn.__file__, "card": card, "ms": ms, "graph_ms": graph,
                      "two_calls_bit_equal": same, "kernel_ms": kernels, "ptxas": report}),
          flush=True)


if __name__ == "__main__":
    main()
