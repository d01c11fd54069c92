"""Time the export CLI's steps: the model's build, the trace and the save.

    python -m otpose_tpu_torch.tools.export_time [--batch 16] [--device cpu] [--tiny]

Does what ``cli/export.py::Export._export`` does with random reference-init
weights in place of a checkpoint: ``build_model`` on the host,
``engine/export.py::export_eval`` (a deep copy moved to the device,
``prepare_eval_params``, one call that pins the kernels' packs,
``torch.export.export``, weights baked in) and ``save_exported`` into a
temporary directory, on ``configs/17/model_RSN.yaml`` with its
``TPU.COMPUTE_DTYPE`` and bf16 weights, as ``chip_smoke.py`` phase 15
exports it (``--tiny``: ``utils/testing.py::tiny_otpose_cfg`` in bf16).  Prints one JSON
line of seconds by step and the artifact's bytes beside the card's name.
To time another checkout's code (the parent commit's, for a comparison in
one call), run this file by its path with that checkout first on the path:

    PYTHONPATH=<checkout> python otpose_tpu_torch/tools/export_time.py
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CFG = Path(__file__).resolve().parents[2] / "configs" / "17" / "model_RSN.yaml"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default=None, help="cpu to trace on the host")
    ap.add_argument("--tiny", action="store_true", help="the tiny test config in bf16")
    args = ap.parse_args(argv)

    from otpose_tpu_torch.config import get_cfg
    from otpose_tpu_torch.engine.export import export_eval, save_exported
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.utils.device import resolve_device, resolve_dtype
    from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

    device = resolve_device(args.device)
    if args.tiny:
        cfg = tiny_otpose_cfg()
        cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    else:
        cfg = get_cfg()
        cfg.merge_from_file(str(CFG))
    card = "cpu"
    if device.type == "cuda":   # the kernels built before the clock starts
        from otpose_tpu_torch.ops.cuda import build

        build.build_all()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    t0 = time.perf_counter()
    spec, model = build_model(cfg, seed=0, device="cpu")
    t1 = time.perf_counter()
    dtype = resolve_dtype(cfg.TPU.COMPUTE_DTYPE)
    exported = export_eval(model, batch_size=args.batch, compute_dtype=dtype,
                           flip=bool(cfg.VAL.FLIP_VAL), decoded=True,
                           bf16_params=True, device=device)
    t2 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="otpose_export_time_")
    try:
        save_exported(out, exported, spec, batch_size=args.batch, compute_dtype=dtype,
                      flip=bool(cfg.VAL.FLIP_VAL), decoded=True)
        t3 = time.perf_counter()
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    import otpose_tpu_torch

    print(json.dumps({"source": otpose_tpu_torch.__file__, "card": card,
                      "batch": args.batch,
                      "build_s": t1 - t0, "trace_s": t2 - t1, "save_s": t3 - t2,
                      "bytes": size}), flush=True)


if __name__ == "__main__":
    main()
