"""One run of one cell: find its files by the names in ``BENCHMARK.json``,
run its traffic kind, read its per-layer metrics and print the result.

A cell (``workloads[]`` in ``BENCHMARK.json``) names a configuration and a
traffic mix.  The configuration is the file its entry names; the traffic
mix is ``traffic/<traffic>.json``, whose ``kind`` is the module
``kinds/<kind>.py`` that sets the cell up and drives its window; the
cell's limits on the numbers that decide ``correct`` are
``workloads/<cell>.json``; each per-layer metric is ``metrics/<name>.py``.
Adding a cell, a traffic mix or a metric adds files and entries and edits
none of these modules.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
SPEC = ROOT / "BENCHMARK.json"


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str, package: Path = PACKAGE):
    """The reader module ``metrics/<name>.py`` (names hold dots, so it is
    loaded by path)."""
    path = package / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """Everything that belongs to ``workload``: its entry, configuration,
    traffic mix, limits, end-to-end metrics and per-layer metrics, found
    under the checkout ``root``."""
    package = root / PACKAGE.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {SPEC.name}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(package / "traffic" / f"{w['traffic']}.json")
    limits = load_json(package / "workloads" / f"{workload}.json")["limits"]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]
    return {"entry": w, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": e2e, "per_layer": layer, "package": str(package)}


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


class Cell:
    """The state of one run, shared by the harness, the traffic kind and the
    metric readers."""

    def __init__(self, files: dict, seed: int, seconds: float, trace: bool, device):
        self.files = files
        self.name = files["entry"]["name"]
        self.config, self.traffic, self.limits = files["config"], files["traffic"], files["limits"]
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.end_to_end: dict = {}
        self.reading: dict = {}       # what the metric readers read
        self.numbers: dict | None = None
        self.attempted = self.failed = 0
        self.peak_bytes = 0

    def phase(self, name: str) -> None:
        """Log the process's age at the end of the set-up phase ``name``."""
        print(f"portbench: {name} done at {process_age_s():.3f} s", file=sys.stderr, flush=True)

    def window_starts(self) -> None:
        self.end_to_end["setup_s"] = process_age_s()
        self.phase("set-up")

    def report(self, **values) -> None:
        self.end_to_end.update(values)

    def memory_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)

    def check(self, numbers: dict, attempted: int, failed: int) -> None:
        self.numbers, self.attempted, self.failed = numbers, attempted, failed


def run_cell(files: dict, seed: int, seconds: float, trace: bool, device) -> Cell:
    """Set the cell up, drive its window and compare its outputs."""
    cell = Cell(files, seed, seconds, trace, device)
    kind = importlib.import_module(f"portbench.kinds.{files['traffic']['kind']}")
    kind.run(cell)
    return cell


def layer_metrics(cell: Cell) -> dict:
    out = {}
    for m in cell.files["per_layer"]:
        value = load_metric(m["name"], Path(cell.files["package"])).read(cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(cell: Cell, trace: bool) -> dict:
    """The result line's object; ``checks`` comes last."""
    from portbench import compare

    correct, rows = compare.judge(cell.numbers or {}, cell.limits)
    if trace:
        metrics = layer_metrics(cell)
    else:
        metrics = {m["name"]: {"value": cell.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.files["end_to_end"]}
    device = device_info(cell)
    out = {"correct": bool(correct and cell.numbers is not None), "attempted": cell.attempted,
           "failed": cell.failed, "metrics": metrics, "device": device}
    if trace:
        s = cell.reading["summary"]
        device.update(busy_s=s.busy_s(), window_s=s.window_s)
        out["breakdown"] = {"device_ops": s.top_device_ops(), "idle_gaps": s.idle_gaps()}
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return out


def device_info(cell: Cell) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(cell.device),
            "count": cell.files["entry"]["chips"], "memory_peak_bytes": cell.peak_bytes}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader,nounits", f"--id={cell.device.index or 0}"],
                               capture_output=True, text=True, timeout=30).stdout.strip()
        info["power_limit_w"] = float(limit)
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return info


def finite(obj):
    """``obj`` with non-finite floats written as strings (JSON has none)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def print_result(out: dict) -> None:
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(out)), flush=True)
