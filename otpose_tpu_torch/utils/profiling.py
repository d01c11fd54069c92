"""Spans, counters and trace capture of the port.

``step(name)`` is the outermost span of one step: it opens a ``StepRecord``
(an index, whether a profiler was recording at entry, the step's spans and
the deltas of every counter over it) and on exit appends it to a ring of
the last ``RING`` records, which ``records()`` returns.  Nothing is written
out.  A step opened inside another (the flip forward inside the decoded
eval step) opens nothing: its spans file into the outer record.

``span(name)`` times one stage of a step on ``time.perf_counter_ns`` and
files (name, parent, start, end) into the open record.  When a profiler
records, it also enters ``torch.profiler.record_function(name)``, so the
stage lands in the trace on the kernels' clock; when none records it
enters nothing (an idle ``record_function`` costs microseconds a call).
Spans are named ``otpose.<layer>.<stage>``, never ``otpose::``, the prefix
of the registered ops.  One step runs at a time: the span stack is the
process's, shared by the thread that runs the step and the autograd
threads it waits on.

``count(name, n)`` adds to one process-wide registry; ``counters()``
copies it and ``since(before)`` gives what grew after a copy.  The
kernels' wrappers (``ops/cuda/``) count ``<op>.calls`` (op calls, either
device), ``<op>.launches`` (kernel launches, CUDA only),
``<op>.wide_launches`` (those on the wide path), ``deform_conv.bwd_launches``
and ``<op>.packs`` (weight packs made); the eval steps' HRNet runner
(``engine/graphs.py``) counts ``hrnet_graph.eager`` (calls run eagerly),
``hrnet_graph.captures`` and ``hrnet_graph.replays`` (CUDA graph captures
and replays).  In a step that a profiler records,
``host_syncs`` counts the host's waits on the device (``.item()``, copies
to the host, copies from pageable memory, ``torch.cuda.synchronize``),
also on the autograd threads, and ``host_syncs@<file>:<line>`` names the
line of the package where each came from; a step with no profiler pays
nothing for it.

``maybe_trace`` records a ``torch.profiler`` trace of steps
[first, first + num) into ``cfg.TPU.PROFILE_DIR`` (CPU activity, and CUDA
activity when a GPU is visible) and writes it there as a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import logging
import os
import os.path as osp
import sys
import time
import warnings
from typing import Optional

import torch

logger = logging.getLogger(__name__)

RING = 256
SYNC_WARNING = "called a synchronizing CUDA operation"
_PACKAGE = osp.dirname(osp.dirname(osp.abspath(__file__))) + os.sep
_THIS = osp.abspath(__file__)
_profiling = torch._C._autograd._profiler_enabled

_counters: dict = {}
_records: collections.deque = collections.deque(maxlen=RING)
_stack: list = []            # names of the open spans, innermost last
_open: list = []             # the open StepRecord, if any
_index = itertools.count()


@dataclasses.dataclass
class StepRecord:
    """One step: its spans as (name, parent name, start ns, end ns) in the
    order they ended (the step's own span last) and ``counters``, each
    counter's growth over the step."""
    index: int
    name: str
    profiled: bool
    spans: list
    counters: dict

    def ms(self, name: str) -> float:
        """Host ms in the spans called ``name`` (summed where it repeats)."""
        return sum(e - s for n, _p, s, e in self.spans if n == name) * 1e-6


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    return dict(_counters)


def since(before: dict) -> collections.Counter:
    """What each counter grew by after ``before`` (a ``counters()``); an
    unchanged counter reads 0."""
    return collections.Counter({k: v - before.get(k, 0) for k, v in _counters.items()
                                if v != before.get(k, 0)})


def records() -> list:
    """The ring's step records, oldest first."""
    return list(_records)


class span:
    """Time the body as the stage ``name`` of the open step."""
    __slots__ = ("name", "_parent", "_t0", "_fn")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._fn = torch.profiler.record_function(self.name) if _profiling() else None
        if self._fn is not None:
            self._fn.__enter__()
        self._parent = _stack[-1] if _stack else None
        _stack.append(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack.pop()
        if _open:
            _open[0].spans.append((self.name, self._parent, self._t0, t1))
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


class step:
    """The outermost span of one step, which opens its ``StepRecord``."""
    __slots__ = ("name", "_span", "_before", "_syncs")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._span = None
        if _open:
            return self
        profiled = _profiling()
        _open.append(StepRecord(next(_index), self.name, profiled, [], {}))
        self._before = dict(_counters)
        self._syncs = _SyncCount() if profiled and _counts_syncs() else None
        if self._syncs is not None:
            self._syncs.__enter__()
        self._span = span(self.name)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self._span is None:
            return False
        try:
            self._span.__exit__(*exc)
        finally:
            if self._syncs is not None:
                self._syncs.__exit__(*exc)
            rec = _open.pop()
            rec.counters = dict(since(self._before))
            _records.append(rec)
        return False


def _counts_syncs() -> bool:
    """Whether there is a device whose synchronisations can be counted."""
    return torch.cuda.is_initialized()


def _note_sync(fallback: str) -> None:
    """Count a synchronisation at the innermost frame of the package below
    the caller (``fallback`` where none is)."""
    site = fallback
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PACKAGE) and path != _THIS:
            site = f"{path[len(_PACKAGE):]}:{f.f_lineno}"
            break
        f = f.f_back
    count("host_syncs")
    count(f"host_syncs@{site}")


class _SyncCount:
    """Count the synchronisations of the body: CUDA's sync debug mode set to
    warn, its warnings caught (every repeat) and counted, and
    ``torch.cuda.synchronize``, which that mode does not report, wrapped;
    the mode, the warning filters and ``torch.cuda.synchronize`` are
    restored on exit."""

    def __enter__(self):
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self._show = warnings.showwarning
        warnings.showwarning = self._shown
        self._synchronize = torch.cuda.synchronize
        torch.cuda.synchronize = self._explicit
        self._mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def _shown(self, message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            _note_sync(f"{osp.basename(filename)}:{lineno}")
        else:
            self._show(message, category, filename, lineno, file, line)

    def _explicit(self, device=None):
        caller = sys._getframe(1)
        _note_sync(f"{osp.basename(caller.f_code.co_filename)}:{caller.f_lineno}")
        return self._synchronize(device)

    def __exit__(self, *exc):
        try:
            torch.cuda.set_sync_debug_mode(self._mode)
        finally:
            torch.cuda.synchronize = self._synchronize
            self._catch.__exit__(*exc)
        return False


# the profiler running across steps (and across train_epoch calls), if any
_active = {"prof": None, "first": 0}


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str], step: int = 0, first_step: int = 10,
                num_steps: int = 5, what: str = "steps"):
    """Trace steps [first_step, first_step + num_steps) when ``profile_dir``
    is set, into ``trace_<what>_<first>-<last>.json``; a no-op otherwise.

    Start and stop are paired through module state, not by step arithmetic
    alone: a run resumed from a checkpoint may enter the window midway (the
    trace then starts at the first step it sees), and the stop comes on the
    window's last step or on the first step past it, whichever is seen, so a
    resumed or short run never stops a trace it did not start."""
    if not profile_dir:
        yield
        return
    in_window = first_step <= step < first_step + num_steps
    if in_window and _active["prof"] is None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _active.update(prof=prof, first=step)
    try:
        yield
    finally:
        prof = _active["prof"]
        if prof is not None and step >= first_step + num_steps - 1:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            path = osp.join(profile_dir, f"trace_{what}_{_active['first']}-{step}.json")
            prof.export_chrome_trace(path)
            _active["prof"] = None
            logger.info("profiler trace written to %s", path)
