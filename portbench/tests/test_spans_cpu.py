"""The program-span and program-counter readers over whole traced runs of
the harness on the CPU at the tiny spec: each gives a finite number in its
cells and None in the other entry's, and in every step the stages its
spans split it into add up to within 15% of the step's own host time."""

from __future__ import annotations

import collections
import math

import pytest
import torch

from portbench import harness, spans
from portbench.tests.tiny import tiny_files

SEED = 2 ** 31 + 4242
CPU = torch.device("cpu")
BENCH = harness.load_json(harness.SPEC)
READERS = {m["name"]: m["workloads"] for m in BENCH["per_layer"]
           if m["source"] in ("program_span", "program_counter")}
STAGES = {"otpose.eval.step": ("otpose.model.hrnet", "otpose.model.encoders",
                               "otpose.model.refine", "otpose.eval.decode"),
          "otpose.train.step": ("otpose.train.forward", "otpose.train.backward",
                                "otpose.train.update")}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """The layer metrics of a traced tiny run of each entry, each run
    reading only its own step records."""
    from otpose_tpu_torch.utils import profiling

    out = {}
    for workload, step in (("posetrack_eval_b30", "otpose.eval.step"),
                           ("posetrack_train_b8", "otpose.train.step")):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(profiling, "_records", collections.deque(maxlen=profiling.RING))
            cell = harness.run_cell(tiny_files(workload), SEED, 2.0, True, CPU)
            shares = [sum(r.ms(name) for name in STAGES[step]) / r.ms(step)
                      for r in profiling.records() if r.name == step and not r.profiled]
            medians = {name: spans.stage_ms(step, name) for name in STAGES[step]}
            out[workload] = (harness.layer_metrics(cell), shares, medians)
    return out


def test_every_new_reader_is_in_the_spec():
    assert set(READERS) == {
        "hrnet_host_ms_per_batch.eval", "encoders_host_ms_per_batch.eval",
        "refine_host_ms_per_batch.eval", "syncs_per_batch.eval",
        "forward_host_ms_per_step.train", "backward_host_ms_per_step.train",
        "update_host_ms_per_step.train", "syncs_per_step.train"}


@pytest.mark.parametrize("workload", ["posetrack_eval_b30", "posetrack_train_b8"])
@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_its_cells_and_nothing_else(runs, workload, name):
    metrics = runs[workload][0]
    value = metrics.get(name, {}).get("value")
    if workload in READERS[name]:
        assert value is not None and math.isfinite(value) and value >= 0, (name, metrics)
    else:
        assert value is None, (name, value)


@pytest.mark.parametrize("workload,step", [("posetrack_eval_b30", "otpose.eval.step"),
                                           ("posetrack_train_b8", "otpose.train.step")])
def test_the_stages_add_up_to_the_step(runs, workload, step):
    _, shares, medians = runs[workload]
    assert all(v is not None and v > 0 for v in medians.values()), medians
    assert len(shares) >= 3 and all(0.85 <= x <= 1.0 for x in shares), shares


def test_readers_give_none_for_a_program_without_records(monkeypatch):
    from otpose_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    cell = harness.Cell(tiny_files("posetrack_eval_b30"), SEED, 1.0, True, CPU)
    for name in READERS:
        assert harness.load_metric(name).read(cell) is None
