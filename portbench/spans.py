"""What the program-span and program-counter readers (``metrics/<name>.py``)
share: the step records the program keeps (``otpose_tpu_torch/utils/
profiling.py::records``: each step's spans on its own host clock and its
counters' growth).  Host times are the median over the records made with
no profiler (the window's steps); counts the mean over those a profiler
recorded (the traced burst).  A program that keeps no records gives None,
as does a cell whose steps have another name."""

from __future__ import annotations

import statistics


def _records(step: str) -> list:
    try:
        from otpose_tpu_torch.utils import profiling
    except ImportError:
        return []
    take = getattr(profiling, "records", None)
    return [r for r in take() if r.name == step] if take is not None else []


def stage_ms(step: str, stage: str) -> float | None:
    """Median host ms a step in the spans named ``stage`` of the steps
    named ``step`` made with no profiler."""
    values = [r.ms(stage) for r in _records(step)
              if not r.profiled and any(s[0] == stage for s in r.spans)]
    return statistics.median(values) if values else None


def mean_count(step: str, counter: str) -> float | None:
    """Mean growth of ``counter`` a step over the steps named ``step`` that
    a profiler recorded."""
    values = [r.counters.get(counter, 0) for r in _records(step) if r.profiled]
    return statistics.fmean(values) if values else None
