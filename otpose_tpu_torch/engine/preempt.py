"""Graceful preemption for training (counterpart of
``otpose_tpu/engine/preempt.py``, single process).

A preempted machine gets SIGTERM and a short grace window.  The guard turns
the first SIGTERM into a request flag; the train loop stops at the next
iteration boundary (``engine/runner.py::train_epoch``'s ``should_stop``), the
train CLI checkpoints the exact (epoch, iteration) and returns, and the next
run resumes at that batch.  The resumed run equals the uninterrupted one bit
for bit, because every random stream is keyed by indices, not by how far a
sequence has run: the epoch's shuffle by (seed, epoch), each sample's
augmentation by (seed, epoch, index), each step's dropout by (seed, epoch,
step) (``engine/runner.py::step_seed``).  The multi-process guard, which
agrees on a common stop iteration across processes, comes with multi-GPU
(ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import logging
import signal
from typing import Iterable

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Installs signal handlers that set a flag instead of ending the
    process; a second signal restores the previous handler and raises the
    signal again (the way out when the graceful path hangs).

    Usage::

        guard = PreemptionGuard().install()
        ...
        train_epoch(..., should_stop=guard.check)
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._prev = {}
        self.requested = False

    def install(self) -> "PreemptionGuard":
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _handle(self, signum, frame):
        if self.requested:
            prev = self._prev.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            logger.warning("second signal %d: restoring the previous handling", signum)
            signal.raise_signal(signum)
            return
        self.requested = True
        logger.warning("signal %d received: will checkpoint at the next iteration boundary "
                       "and exit", signum)

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def check(self) -> bool:
        """The iteration-boundary probe (``train_epoch``'s ``should_stop``)."""
        return self.requested


def make_preemption_guard(start_step: int = 0) -> PreemptionGuard:
    """The installed single-process guard.  ``start_step`` (the resumed
    TensorBoard step) is the multi-process guard's common counter base in
    the JAX package; one process has nothing to agree on, so it is unused
    until multi-GPU comes (ROADMAP Queue 1 item 7)."""
    del start_step
    return PreemptionGuard().install()
