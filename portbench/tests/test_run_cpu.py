"""Whole runs of the harness on the CPU at the tiny spec, past its look for a
card: the result line's shape, and ``correct`` false with the timed path
broken underneath (an answer altered where it is produced; a train step
that returns its state unchanged; half of each batch left out, the loss's
mean taken over the rest) or with the control, the reference in fp8, in the
program's place.  One chip, so no exchange between chips can be left out."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import compare, control, harness, program, weights
from portbench.kinds import eval_pipelined
from portbench.tests.tiny import tiny_files

SEED = 2 ** 31 + 12345
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(workload, trace=False, **traffic):
    cell = harness.run_cell(tiny_files(workload, **traffic), SEED, 0.5, trace, CPU)
    return cell, compare.judge(cell.numbers, cell.limits)[0]


@pytest.mark.parametrize("workload", ["posetrack_eval_b30", "posetrack_train_b8"])
def test_sound_runs_are_correct_and_report_their_metrics(workload, monkeypatch):
    monkeypatch.setattr(harness, "device_info", lambda cell: {"platform": "gpu"})
    cell, correct = _run(workload)
    assert correct, cell.numbers
    out = harness.result(cell, trace=False)
    assert list(out)[-1] == "checks" and out["correct"]
    assert set(out["metrics"]) == {m["name"] for m in cell.files["end_to_end"]}
    assert set(out["checks"]) == set(cell.limits)
    json.dumps(harness.finite(out))


def test_a_traced_run_reads_its_layer_metrics(monkeypatch):
    monkeypatch.setattr(harness, "device_info", lambda cell: {"platform": "gpu"})
    cell, _ = _run("posetrack_eval_b30", trace=True)
    out = harness.result(cell, trace=True)
    # no device on the CPU: the trace's readers find no kernel and stay silent
    assert "host_ms_per_batch.eval" in out["metrics"] and "mfu.eval" in out["metrics"]
    assert "fused_attn_roofline.eval" not in out["metrics"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    make = program.eval_step

    def altered(model, dtype):
        step = make(model, dtype)

        def run(inputs, margin):
            return control.mirrored(step(inputs, margin), model.spec.pe_w)
        return run

    monkeypatch.setattr(program, "eval_step", altered)
    assert not _run("posetrack_eval_b30")[1]


def test_the_control_in_the_programs_place_is_not_correct(monkeypatch):
    refs = []

    def control(model, dtype):
        def run(inputs, margin):
            return eval_pipelined.reference_decoded(refs[-1], inputs, margin, 1, "fp8")
        return run

    build = program.build

    def keep_reference(config, state, device):
        refs.append(weights.make_reference(config["cfg"], SEED, device, center=True))
        return build(config, state, device)

    monkeypatch.setattr(program, "build", keep_reference)
    monkeypatch.setattr(program, "eval_step", control)
    assert not _run("posetrack_eval_b30")[1]


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    make = program.train_step

    def unchanged(model, *args, **kwargs):
        step, opt = make(model, *args, **kwargs)

        def run(batch):
            before = {k: v.clone() for k, v in model.state_dict().items()}
            out = step(batch)
            model.load_state_dict(before)
            return out
        return run, opt

    monkeypatch.setattr(program, "train_step", unchanged)
    assert not _run("posetrack_train_b8")[1]


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    make = program.train_step

    def halved(model, *args, **kwargs):
        step, opt = make(model, *args, **kwargs)

        def run(batch):
            return step({k: v[:v.shape[0] // 2] for k, v in batch.items()})
        return run, opt

    monkeypatch.setattr(program, "train_step", halved)
    assert not _run("posetrack_train_b8")[1]


def test_the_train_control_in_the_programs_place_is_not_correct(monkeypatch):
    from portbench.kinds import train_steps

    states = []
    build = program.build

    def keep_state(config, state, device):
        states.append({k: v.detach().clone() for k, v in state.items()})
        return build(config, state, device)

    def control(step, opt, model, ring, seeds, generator):
        files = tiny_files("posetrack_train_b8")
        return train_steps.reference_steps(states[-1], files["config"]["cfg"], files["traffic"],
                                           ring, seeds, CPU, precision="fp8")

    monkeypatch.setattr(program, "build", keep_state)
    monkeypatch.setattr(train_steps, "first_steps", control)
    assert not _run("posetrack_train_b8")[1]
