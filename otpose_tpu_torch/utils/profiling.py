"""Trace capture for training (counterpart of ``maybe_trace`` in
``otpose_tpu/utils/profiling.py``).

``maybe_trace`` records a ``torch.profiler`` trace of train steps
[first, first + num) into ``cfg.TPU.PROFILE_DIR`` (CPU activity, and CUDA
activity when a GPU is visible) and writes it there as a Chrome trace.
``StepTimer`` is a rolling step-time meter that waits for the device only
every ``sync_every`` steps, through ``synchronize``.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import os.path as osp
import time
from typing import Optional

import torch

logger = logging.getLogger(__name__)

# the profiler running across steps (and across train_epoch calls), if any
_active = {"prof": None, "first": 0}


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str], step: int = 0, first_step: int = 10,
                num_steps: int = 5):
    """Trace steps [first_step, first_step + num_steps) when ``profile_dir``
    is set; a no-op otherwise.

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
            path = osp.join(profile_dir, f"trace_steps_{_active['first']}-{step}.json")
            prof.export_chrome_trace(path)
            _active["prof"] = None
            logger.info("profiler trace written to %s", path)


def _first_tensor(tree):
    """The first tensor of a nested dict / list / tuple, in the JAX package's
    leaf order (dict keys sorted), or None."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            found = _first_tensor(leaf)
            if found is not None:
                return found
    return None


def synchronize(tree) -> None:
    """Wait for the device work behind ``tree``'s first tensor: its CUDA
    device is synchronized.  Without a tensor, or for a CPU one, nothing
    runs asynchronously and this does nothing."""
    t = _first_tensor(tree)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class StepTimer:
    """Rolling step-time / throughput meter that waits for the device only
    at its sync points (every ``sync_every`` steps)."""

    def __init__(self, sync_every: int = 50):
        self.sync_every = sync_every
        self._count = 0
        self._t_last_sync = time.perf_counter()
        self._steps_since_sync = 0
        self.avg_step_time = float("nan")

    def step(self, output_tree=None) -> Optional[float]:
        """Call once a step; returns the average step time since the last
        sync point at a sync point, else None."""
        self._count += 1
        self._steps_since_sync += 1
        if self._count % self.sync_every == 0:
            if output_tree is not None:
                synchronize(output_tree)
            now = time.perf_counter()
            self.avg_step_time = (now - self._t_last_sync) / self._steps_since_sync
            self._t_last_sync = now
            self._steps_since_sync = 0
            return self.avg_step_time
        return None

    def throughput(self, batch_size: int) -> float:
        if not math.isfinite(self.avg_step_time) or self.avg_step_time <= 0:
            return float("nan")
        return batch_size / self.avg_step_time
