"""``otpose_tpu_torch/utils/profiling.py``: spans, step records, the counter
registry and the count of host synchronisations.

- a step record's spans, their parents and order, the ring's bound, a step
  nested in another opening nothing;
- no ``record_function`` entered while no profiler records, one a span
  while one does;
- under a CPU ``torch.profiler`` the tiny decoded eval step and train step
  emit their spans as ``user_annotation`` events inside the step's span,
  none named like a registered op (``otpose::``), and the eval loop's
  dispatch and fetch spans;
- the op counters' deltas in a step record;
- ``host_syncs`` with its ``file:line`` from a faked synchronisation
  warning (there is no device here), ``torch.cuda.synchronize`` counted,
  and CUDA's sync debug mode, the warning filters and
  ``torch.cuda.synchronize`` restored after the step;
- ``maybe_trace``'s file name for eval batches.
"""

import collections
import inspect
import json
import os
import sys
import warnings

import pytest
import torch

from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
from otpose_tpu_torch.engine.runner import _pipelined_forward
from otpose_tpu_torch.engine.trainer import make_decoded_eval_step, make_train_step
from otpose_tpu_torch.evaluate import pck
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.utils import profiling
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.torch_port import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CPU = [torch.profiler.ProfilerActivity.CPU]
MODEL_SPANS = ("otpose.model.hrnet", "otpose.model.encoders", "otpose.model.refine")


@pytest.fixture(autouse=True)
def _fresh_ring(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=profiling.RING))


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_otpose_cfg()
    _, model = build_model(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    b, (w, h), (hw, hh) = 2, cfg.MODEL.IMAGE_SIZE, cfg.MODEL.HEATMAP_SIZE
    j = cfg.MODEL.NUM_JOINTS
    batch = {"inputs": torch.randn(b, h, w, 15, generator=gen),
             "margin": torch.ones(b, 4),
             "target": torch.rand(b, hh, hw, j, generator=gen),
             "target_weight": torch.ones(b, j, 1)}
    return cfg, model, batch


def _trace_events(prof, tmp_path) -> list:
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _annotations(events) -> dict:
    """{name: [(start, end)]} of the ``otpose.*`` user annotations."""
    out: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("otpose"):
            out.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return out


def _inside(inner, outer) -> bool:
    return all(any(o[0] <= s and e <= o[1] for o in outer) for s, e in inner)


def test_a_step_record_holds_its_spans_their_parents_and_counters():
    with profiling.step("otpose.test.step"):
        with profiling.span("a"):
            with profiling.span("b"):
                profiling.count("test.things", 3)
        with profiling.step("otpose.test.step"):          # nested: no second record
            with profiling.span("a"):
                pass
    (rec,) = profiling.records()
    assert rec.name == "otpose.test.step" and rec.profiled is False
    assert [(n, p) for n, p, _s, _e in rec.spans] == [
        ("b", "a"), ("a", "otpose.test.step"), ("a", "otpose.test.step"),
        ("otpose.test.step", None)]
    starts = {n: s for n, _p, s, _e in rec.spans}
    assert all(s <= e for _n, _p, s, e in rec.spans)
    assert starts["otpose.test.step"] <= min(starts.values())
    assert rec.counters == {"test.things": 3}
    assert rec.ms("a") == pytest.approx(sum(e - s for n, _p, s, e in rec.spans
                                            if n == "a") * 1e-6)
    assert rec.ms("a") <= rec.ms("otpose.test.step")
    with profiling.span("outside"):                          # no open step: filed nowhere
        pass
    with profiling.step("otpose.test.step"):
        pass
    first, second = profiling.records()
    assert second.index > first.index and [s[0] for s in second.spans] == ["otpose.test.step"]


def test_the_ring_keeps_the_last_records():
    for _ in range(profiling.RING + 5):
        with profiling.step("otpose.test.step"):
            pass
    recs = profiling.records()
    assert len(recs) == profiling.RING
    assert recs[-1].index - recs[0].index == profiling.RING - 1


def test_a_step_that_raises_is_recorded_and_closes_its_spans():
    with pytest.raises(ValueError):
        with profiling.step("otpose.test.step"):
            with profiling.span("a"):
                raise ValueError("x")
    (rec,) = profiling.records()
    assert [s[0] for s in rec.spans] == ["a", "otpose.test.step"]
    assert not profiling._stack and not profiling._open


def test_no_record_function_without_a_profiler(monkeypatch, tmp_path):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiling.step("otpose.test.step"):
        with profiling.span("otpose.test.a"):
            pass
    assert entered == []
    with torch.profiler.profile(activities=CPU) as prof:
        with profiling.step("otpose.test.step"):
            with profiling.span("otpose.test.a"):
                torch.ones(4).sum()
    assert entered == ["otpose.test.step", "otpose.test.a"]
    assert profiling.records()[-1].profiled is True
    assert set(_annotations(_trace_events(prof, tmp_path))) == {"otpose.test.step", "otpose.test.a"}


def test_the_counter_registry():
    before = profiling.counters()
    profiling.count("test.registry")
    profiling.count("test.registry", 4)
    grown = profiling.since(before)
    assert grown["test.registry"] == 5 and grown["test.never"] == 0
    copy = profiling.counters()
    copy["test.registry"] = -1
    assert profiling.counters()["test.registry"] == before.get("test.registry", 0) + 5


def test_eval_step_spans_under_the_profiler(tiny, tmp_path):
    _, model, batch = tiny
    step = make_decoded_eval_step(model)
    with torch.profiler.profile(activities=CPU) as prof:
        step(batch["inputs"], batch["margin"])
    spans = _annotations(_trace_events(prof, tmp_path))
    assert set(spans) == {"otpose.eval.step", "otpose.eval.decode", *MODEL_SPANS}
    assert len(spans["otpose.eval.step"]) == 1          # the inner forward's step opened none
    for name in MODEL_SPANS + ("otpose.eval.decode",):
        assert _inside(spans[name], spans["otpose.eval.step"])
    (rec,) = profiling.records()
    assert rec.name == "otpose.eval.step" and rec.profiled
    assert {n: p for n, p, _s, _e in rec.spans} == {
        **{s: "otpose.eval.step" for s in MODEL_SPANS},
        "otpose.eval.decode": "otpose.eval.step", "otpose.eval.step": None}
    # the op counters' deltas: the CPU ops' calls, no launch
    assert {k: v for k, v in rec.counters.items() if k.endswith((".calls", ".launches"))} == {
        "fused_attn.calls": 4, "fused_mlp.calls": 6, "deform_conv.calls": 1}


def test_train_step_spans_under_the_profiler(tiny, tmp_path):
    cfg, model, batch = tiny
    opt = make_optimizer(model, cfg, make_schedule(cfg, 10))
    step = make_train_step(model, opt, generator=torch.Generator().manual_seed(1))
    try:
        with torch.profiler.profile(activities=CPU) as prof:
            step(batch)
    finally:
        model.eval()
    spans = _annotations(_trace_events(prof, tmp_path))
    stages = ("otpose.train.forward", "otpose.train.backward", "otpose.train.update")
    assert set(spans) == {"otpose.train.step", *stages, *MODEL_SPANS}
    for name in stages:
        assert _inside(spans[name], spans["otpose.train.step"])
    for name in MODEL_SPANS:
        assert _inside(spans[name], spans["otpose.train.forward"])
    assert len(spans["otpose.train.update"]) == 2        # the BN commit, then the optimizer
    (rec,) = profiling.records()
    assert rec.counters["deform_conv.calls"] == 1 and rec.ms("otpose.train.update") > 0
    assert {p for n, p, _s, _e in rec.spans if n in stages} == {"otpose.train.step"}


def test_eval_loop_dispatch_and_fetch_spans(tmp_path):
    def run(inputs, margin):
        with profiling.step("otpose.eval.step"):
            return inputs + margin

    loader = [({"inputs": torch.ones(2), "margin": torch.ones(2)}, [None] * 2)] * 3
    with torch.profiler.profile(activities=CPU) as prof:
        got = list(_pipelined_forward(loader, run, lambda o: o.numpy(), "cpu"))
    assert len(got) == 3
    spans = _annotations(_trace_events(prof, tmp_path))
    assert len(spans["otpose.eval.dispatch"]) == len(spans["otpose.eval.fetch"]) == 3
    assert _inside(spans["otpose.eval.step"], spans["otpose.eval.dispatch"])
    assert not any(name.startswith("otpose::") for name in spans)


def _pck_line() -> int:
    lines, first = inspect.getsourcelines(pck.accuracy_device)
    return first + next(i for i, line in enumerate(lines) if "torch.tensor(" in line)


def test_host_syncs_are_counted_by_site_and_the_mode_restored(tiny, monkeypatch):
    """A faked synchronisation warning where the train step copies a host
    list to the device (``evaluate/pck.py``), and an explicit
    ``torch.cuda.synchronize``: each counted with its site."""
    cfg, model, batch = tiny
    modes, waits = [0], []
    monkeypatch.setattr(profiling, "_counts_syncs", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: modes.append(mode))
    fake_synchronize = lambda device=None: waits.append(device)  # noqa: E731
    monkeypatch.setattr(torch.cuda, "synchronize", fake_synchronize)
    real_tensor = torch.tensor

    def syncing_tensor(data, *args, **kwargs):
        if sys._getframe(1).f_code is pck.accuracy_device.__code__:   # a copy to the card
            warnings.warn(profiling.SYNC_WARNING + " (faked)", UserWarning, stacklevel=2)
        return real_tensor(data, *args, **kwargs)

    monkeypatch.setattr(torch, "tensor", syncing_tensor)
    opt = make_optimizer(model, cfg, make_schedule(cfg, 10))
    step = make_train_step(model, opt, generator=torch.Generator().manual_seed(1))
    filters = list(warnings.filters)
    try:
        with torch.profiler.profile(activities=CPU):
            step(batch)
            with pytest.warns(UserWarning, match="unrelated"):
                with profiling.step("otpose.test.step"):
                    explicit = inspect.currentframe().f_lineno + 1
                    torch.cuda.synchronize()
                    warnings.warn("unrelated", UserWarning)
                    assert modes[-1] == "warn"
    finally:
        model.eval()
    train, test = profiling.records()
    site = f"host_syncs@evaluate/pck.py:{_pck_line()}"
    assert train.counters["host_syncs"] == train.counters[site] == 1
    assert test.counters == {"host_syncs": 1,
                             f"host_syncs@test_torch_profiling.py:{explicit}": 1}
    assert waits == [None]                                   # the real call still made
    assert modes == [0, "warn", 0, "warn", 0]                # set for each step, restored
    assert torch.cuda.synchronize is fake_synchronize
    assert warnings.filters == filters


def test_no_sync_counting_without_a_profiler(monkeypatch):
    monkeypatch.setattr(profiling, "_counts_syncs", lambda: True)
    monkeypatch.setattr(profiling, "_SyncCount", None)      # would raise if made
    with profiling.step("otpose.test.step"):
        pass
    assert profiling.records()[-1].counters == {}


@pytest.mark.parametrize("what,name", [("steps", "trace_steps_10-14.json"),
                                       ("eval_batches", "trace_eval_batches_10-14.json")])
def test_maybe_trace_names_its_file(tmp_path, what, name):
    d = str(tmp_path / "prof")
    for step in range(16):
        with profiling.maybe_trace(d, step=step, what=what):
            with profiling.step("otpose.test.step"):
                torch.ones(4).sum()
    assert os.listdir(d) == [name]
    with open(os.path.join(d, name)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "otpose.test.step" in names
    assert [r.profiled for r in profiling.records()] == [10 <= s < 15 for s in range(16)]
