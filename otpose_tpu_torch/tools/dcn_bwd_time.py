"""Time the DCN's kernels at the model's shapes: the backward, and the
forward beside it.

    python -m otpose_tpu_torch.tools.dcn_bwd_time

Times ``ops/cuda/deform_conv.py::launch_backward`` (``csrc/deform_conv_bwd.cu``)
by CUDA events around 10 eager launches after 2 warm-up ones, at the
flagship shape (17 x 96 x 72, O = 17, dilations 3-15, offsets from
``utils/testing.py::dcn_case``) in bf16 at B = 8, f32 at B = 8 and bf16 at
B = 1, and the forward (``modulated_deform_conv_multi`` through a pack,
``csrc/deform_conv.cu``) the same way in bf16 at B = 16, f32 at B = 16 and
bf16 at B = 1; then both at the 133-joint model's DCN (O = C = 133, 96 x 72,
B = 2; the wide paths past 32 outputs) in bf16 and f32 at the five
dilations 3-15 and at nine (3-27), the backward by 5 launches; then prints
one JSON line of ms by case (``ms``, ``forward_ms``; the 133-joint cases
keyed ``O=133``; ``forward_graph_ms``, each forward's device time by
CUDA-graph replay, since a B = 1 call's eager time is mostly the host's)
beside the card's name, and each kernel's registers and spills as
``ptxas`` reported them.
To time another checkout's kernels (the parent commit's, for a comparison
in one call), run this file by its path with that checkout first on the
path:

    PYTHONPATH=<checkout> python otpose_tpu_torch/tools/dcn_bwd_time.py

``--save PATH`` also writes every case's outputs (the forward's, and the
backward's five gradients) to ``PATH`` with ``torch.save``, so that two
checkouts' bits can be compared.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

import torch

CASES = ((8, torch.bfloat16), (8, torch.float32), (1, torch.bfloat16))
FORWARD_CASES = ((16, torch.bfloat16), (16, torch.float32), (1, torch.bfloat16))
# the 133-joint model's DCN (COCO-WholeBody): B = 2, both dtypes, five and nine dilations
WIDE_O, WIDE_BATCH = 133, 2
WIDE_DILATIONS = ((3, 6, 9, 12, 15), tuple(range(3, 30, 3)))


def ptxas_summary(report: str) -> dict:
    """{kernel entry: "R registers, S bytes spilled"} from an ``nvcc -Xptxas
    -v`` report."""
    out, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:   # without the anonymous namespace's hash, which differs by source
            entry = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N_", m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            out[entry] = f"{m.group(1)} bytes spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = f"{m.group(1)} registers, " + out.get(entry, "")
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--save", default=None, help="write every case's outputs here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dcn_bwd_time: needs a CUDA device")
    from otpose_tpu_torch.ops.cuda import build, deform_conv
    from otpose_tpu_torch.utils.testing import dcn_case
    from otpose_tpu_torch.utils.timing import graph_ms, time_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    build.build_all(("deform_conv", "deform_conv_bwd"))
    gen = torch.Generator(device="cuda").manual_seed(21)
    out, fwd, fwd_graph, saved = {}, {}, {}, {}
    for batch, dtype in CASES:
        x, offs, masks, weights, biases, dil = dcn_case(batch, 17, 17, 96, 72,
                                                        (3, 6, 9, 12, 15), dtype, gen)
        g = torch.randn(batch, 17, 96, 72, generator=gen, device="cuda").to(dtype)
        pk = deform_conv.pack_dcn_weights(weights, biases)
        key = f"{str(dtype)[6:]} B={batch}"
        out[key] = time_ms(lambda: deform_conv.launch_backward(g, x, offs, masks, pk, dil),
                           iters=10)
        saved[f"backward {key}"] = [t.cpu() for t in
                                    deform_conv.launch_backward(g, x, offs, masks, pk, dil)]
    for batch, dtype in FORWARD_CASES:
        x, offs, masks, weights, biases, dil = dcn_case(batch, 17, 17, 96, 72,
                                                        (3, 6, 9, 12, 15), dtype, gen)
        pk = deform_conv.pack_dcn_weights(weights, biases)
        call = lambda: deform_conv.modulated_deform_conv_multi(  # noqa: E731
            x, offs, masks, dilations=dil, packed=pk)
        key = f"{str(dtype)[6:]} B={batch}"
        fwd[key] = time_ms(call, iters=10)
        fwd_graph[key] = graph_ms(call)
        saved[f"forward {key}"] = call().cpu()
    for dilations in WIDE_DILATIONS:
        for dtype in (torch.bfloat16, torch.float32):
            x, offs, masks, weights, biases, dil = dcn_case(WIDE_BATCH, WIDE_O, WIDE_O, 96, 72,
                                                            dilations, dtype, gen)
            g = torch.randn(WIDE_BATCH, WIDE_O, 96, 72, generator=gen, device="cuda").to(dtype)
            pk = deform_conv.pack_dcn_weights(weights, biases)
            call = lambda: deform_conv.modulated_deform_conv_multi(  # noqa: E731
                x, offs, masks, dilations=dil, packed=pk)
            key = f"{str(dtype)[6:]} O={WIDE_O} D={len(dil)} B={WIDE_BATCH}"
            fwd[key] = time_ms(call, iters=10)
            fwd_graph[key] = graph_ms(call)
            out[key] = time_ms(lambda: deform_conv.launch_backward(g, x, offs, masks, pk, dil),
                               iters=5)
            del x, offs, masks, g
            torch.cuda.empty_cache()
    if args.save:
        torch.save(saved, args.save)
    print(json.dumps({"source": deform_conv.__file__, "card": card, "ms": out,
                      "forward_ms": fwd, "forward_graph_ms": fwd_graph,
                      "ptxas": {k: ptxas_summary(build.ptxas_report.get(k, ""))
                                for k in ("deform_conv", "deform_conv_bwd")}}), flush=True)


if __name__ == "__main__":
    main()
