"""Time the DCN's backward kernel at the train step's shapes.

    python -m otpose_tpu_torch.tools.dcn_bwd_time

Times ``ops/cuda/deform_conv.py::launch_backward`` (``csrc/deform_conv_bwd.cu``)
by CUDA events around 10 eager launches after 2 warm-up ones, at the
flagship shape (17 x 96 x 72, O = 17, dilations 3-15, offsets from
``utils/testing.py::dcn_case``) in bf16 at B = 8, f32 at B = 8 and bf16 at
B = 1, and prints one JSON line of ms by case beside the card's name.  To
time another checkout's kernel (the parent commit's, for a comparison in one
call), run this file by its path with that checkout first on the path:

    PYTHONPATH=<checkout> python otpose_tpu_torch/tools/dcn_bwd_time.py

Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

CASES = ((8, torch.bfloat16), (8, torch.float32), (1, torch.bfloat16))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("dcn_bwd_time: needs a CUDA device")
    from otpose_tpu_torch.ops.cuda import deform_conv
    from otpose_tpu_torch.utils.testing import dcn_case
    from otpose_tpu_torch.utils.timing import time_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(21)
    out = {}
    for batch, dtype in CASES:
        x, offs, masks, weights, biases, dil = dcn_case(batch, 17, 17, 96, 72,
                                                        (3, 6, 9, 12, 15), dtype, gen)
        g = torch.randn(batch, 17, 96, 72, generator=gen, device="cuda").to(dtype)
        pk = deform_conv.pack_dcn_weights(weights, biases)
        out[f"{str(dtype)[6:]} B={batch}"] = time_ms(
            lambda: deform_conv.launch_backward(g, x, offs, masks, pk, dil), iters=10)
    print(json.dumps({"source": deform_conv.__file__, "card": card, "ms": out}), flush=True)


if __name__ == "__main__":
    main()
