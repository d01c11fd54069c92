"""The readings that the limits of ``workloads/<cell>.json`` are set from,
on the card at the cell's own size, several seeds in one process.

    python3 -m portbench.control --workload <name> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--out FILE]

For each seed, the program's numbers as a run compares them (eval: every
ring batch of a short window; train: the first steps), and, for the
control seeds, the same numbers of

- ``control``: the reference put in the program's place in the precision
  below the configuration's (fp8 products for bf16, ``reference/ops.py``);
- eval ``fault_answer``: the program's answers altered where they are
  produced: one clip's keypoints mirrored (``mirrored``);
- train ``fault_half_batch``: the program's step given half of each batch
  (the loss's mean then taken over the rest); a step that returns its state
  unchanged reads 1 by the change's measure and needs no run.

Each line of output is one JSON object.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from portbench import compare, harness
from portbench.kinds import eval_pipelined, train_steps


def mirrored(outputs, width: int):
    """The eval outputs with the first clip's keypoints mirrored across the
    heatmap's width, as a flip that was not undone writes them."""
    coords, maxvals, raw = (t.clone() for t in outputs)
    for t in (coords, raw):
        t[0, :, 0] = (width - 1) - t[0, :, 0]
    return coords, maxvals, raw


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def eval_seed(files, seed: int, control: bool, dev) -> dict:
    tr = files["traffic"]
    ref, step, ring = eval_pipelined.setup(files["config"], tr, seed, dev)
    ref = ref.to(dev)
    outs = eval_pipelined.pipelined(step, ring, batches=2 * len(ring))["outputs"]
    del step
    free()
    rows = {"seed": seed, "program": {}, "control": {}, "fault_answer": {}}
    for slot, (inputs, margin) in enumerate(ring):
        heat = eval_pipelined.reference_heatmaps(ref, inputs, margin, tr["reference_rows"])
        for s, (coords, maxvals, raw) in outs:
            if s == slot:
                _worst(rows["program"], compare.eval_numbers(heat, coords, maxvals, raw))
        if control:
            got = eval_pipelined.reference_decoded(ref, inputs, margin, tr["reference_rows"], "fp8")
            _worst(rows["control"], compare.eval_numbers(heat, *got))
            out = next(o for s, o in outs if s == slot)
            _worst(rows["fault_answer"], compare.eval_numbers(heat, *mirrored(out, heat.shape[-1])))
    return rows


def _worst(into: dict, numbers: dict) -> None:
    for k, v in numbers.items():
        into[k] = max(into.get(k, 0.0), v)


def _train_program(files, seed: int, dev, half: bool = False):
    st = train_steps.setup(files["config"], files["traffic"], seed, dev)
    ring = st["ring"]
    fed = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in ring] if half else ring
    got = train_steps.first_steps(st["step"], st["opt"], st["model"], fed, st["seeds"],
                                  st["generator"])
    state, seeds = st["state"], st["seeds"]
    del st
    free()
    return got, state, ring, seeds


def train_seed(files, seed: int, control: bool, dev) -> dict:
    cfg, tr = files["config"]["cfg"], files["traffic"]
    got, state, ring, seeds = _train_program(files, seed, dev)
    want = train_steps.reference_steps(state, cfg, tr, ring, seeds, dev)
    free()
    rows = {"seed": seed, "program": compare.train_numbers(got, want),
            "losses": {"program": got["losses"], "reference": want["losses"]}}
    if control:
        low = train_steps.reference_steps(state, cfg, tr, ring, seeds, dev, precision="fp8")
        free()
        rows["control"] = compare.train_numbers(low, want)
        half, *_ = _train_program(files, seed, dev, half=True)
        rows["fault_half_batch"] = compare.train_numbers(half, want)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    files = harness.cell_files(harness.load_json(harness.SPEC), args.workload)
    dev = torch.device("cuda", 0)
    kind = files["traffic"]["kind"]
    fn = {"eval_pipelined": eval_seed, "train_steps": train_seed}[kind]
    sink = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        row = dict(fn(files, seed, seed in args.control_seeds, dev), workload=args.workload,
                   card=torch.cuda.get_device_name(dev))
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
