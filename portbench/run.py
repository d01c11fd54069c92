"""The port's benchmark: one run of one cell on the card.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Makes its weights and inputs from
``--seed``, sets the cell up and warms it, measures for ``--seconds``,
compares what the timed path produced with the float32 reference, and
prints as its last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, last,
``checks`` (each compared number beside its limit, also the last lines of
standard error).  Exits non-zero, printing no result, without enough CUDA
devices, when a forbidden package was loaded (``imports.py``), or when the
program is missing.
"""

from __future__ import annotations

import argparse
import os
import sys

from portbench import harness, imports

# build and kernel caches inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, str(harness.ROOT / "build" / "portbench" / _sub))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    files = harness.cell_files(harness.load_json(harness.SPEC), args.workload)
    import torch

    chips = files["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import otpose_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 2
    cell = harness.run_cell(files, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0))
    out = harness.result(cell, bool(args.trace))
    found = imports.loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
