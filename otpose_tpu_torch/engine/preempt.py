"""Graceful preemption for training (counterpart of
``otpose_tpu/engine/preempt.py``).

A preempted machine gets SIGTERM and a short grace window.  The guard turns
the first SIGTERM into a request flag; the train loop stops at the next
iteration boundary (``engine/runner.py::train_epoch``'s ``should_stop``), the
train CLI checkpoints the exact (epoch, iteration) and returns, and the next
run resumes at that batch.  The resumed run equals the uninterrupted one bit
for bit, because every random stream is keyed by indices, not by how far a
sequence has run: the epoch's shuffle by (seed, epoch), each sample's
augmentation by (seed, epoch, index), each step's dropout by (seed, epoch,
step) (``engine/runner.py::step_seed``).  Under a multi-process launch
the SIGTERM may reach one rank only, and a rank that stopped alone would
leave the others waiting in a collective: ``ClusterPreemptionGuard`` makes
every rank stop at the same iteration.
"""

from __future__ import annotations

import logging
import signal
from typing import Iterable

from otpose_tpu_torch.parallel.distributed import process_info, reached_preemption_sync_point

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


class ClusterPreemptionGuard(PreemptionGuard):
    """The multi-process guard: each rank's signal handler sets its own
    ``signalled`` flag; ``check`` (once an iteration, on every rank) takes
    the MAX of the flags across the ranks
    (``distributed.reached_preemption_sync_point``), so ``requested``
    becomes True on every rank at the same iteration.  The check's id
    counts from ``start_step``, the same on every rank (the resumed
    TensorBoard step)."""

    def __init__(self, start_step: int = 0, signals: Iterable[int] = (signal.SIGTERM,)):
        super().__init__(signals)
        self._next_step = int(start_step)
        self.signalled = False

    def _handle(self, signum, frame):
        if self.signalled:
            prev = self._prev.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            logger.warning("second signal %d: restoring the previous handling", signum)
            signal.raise_signal(signum)
            return
        self.signalled = True
        logger.warning("signal %d received: every rank will checkpoint at the next iteration "
                       "boundary and exit", signum)

    def check(self) -> bool:
        if not self.requested:
            step, self._next_step = self._next_step, self._next_step + 1
            if reached_preemption_sync_point(step, self.signalled):
                self.requested = True
                logger.warning("preemption: every rank stops at check %d", step)
        return self.requested


def make_preemption_guard(start_step: int = 0) -> PreemptionGuard:
    """The installed guard for the launch: ``ClusterPreemptionGuard``
    counting from ``start_step`` (the resumed TensorBoard step) across
    several ranks, the single-process ``PreemptionGuard`` otherwise."""
    if process_info()[1] > 1:
        return ClusterPreemptionGuard(start_step).install()
    return PreemptionGuard().install()
