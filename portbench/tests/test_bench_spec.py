"""BENCHMARK.json and every file it names: the contract's shapes, names and
units, and that each cell's files are found by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import harness

BENCH = harness.load_json(harness.SPEC)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_check_budget_fits_with_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/") and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        config = harness.load_json(harness.ROOT / c["file"])
        assert config["reduced"] == c["reduced"]
        assert config["cfg"]["MODEL"]["NAME"] == "OTPose"


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        for cell in m["workloads"]:
            # each cell that reads the metric reports the end-to-end metric it moves
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(workload):
    files = harness.cell_files(BENCH, workload)
    assert files["traffic"]["kind"] in ("eval_pipelined", "train_steps")
    assert files["limits"] and all(v > 0 for v in files["limits"].values())
    names = {m["name"] for m in files["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert files["per_layer"]
    for m in files["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)


def test_metric_files_match_the_spec():
    on_disk = {p.name[:-3] for p in (harness.PACKAGE / "metrics").glob("*.py")}
    assert on_disk == {m["name"] for m in BENCH["per_layer"]}


def test_a_new_cell_is_new_files_and_an_entry(tmp_path):
    """Adding a cell copies nothing and edits no module: a traffic file, a
    limits file and an entry in BENCHMARK.json."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.PACKAGE, root / harness.PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    traffic = dict(harness.load_json(harness.PACKAGE / "traffic" / "eval_pipelined_b30.json"),
                   batch=16)
    (root / "portbench" / "traffic" / "eval_pipelined_b16.json").write_text(json.dumps(traffic))
    limits = harness.load_json(harness.PACKAGE / "workloads" / "posetrack_eval_b30.json")
    (root / "portbench" / "workloads" / "posetrack_eval_b16.json").write_text(json.dumps(limits))
    bench["workloads"].append({"name": "posetrack_eval_b16", "config": "otpose_w48_posetrack",
                               "traffic": "eval_pipelined_b16", "chips": 1, "why": "B = 16"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "posetrack_eval_b30" in m.get("workloads", []):
            m["workloads"].append("posetrack_eval_b16")
    files = harness.cell_files(bench, "posetrack_eval_b16", root=root)
    assert files["traffic"]["batch"] == 16 and files["limits"] == limits["limits"]
    assert {m["name"] for m in files["per_layer"]} == {
        m["name"] for m in harness.cell_files(BENCH, "posetrack_eval_b30")["per_layer"]}
