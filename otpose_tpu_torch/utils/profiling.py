"""Trace capture for training (counterpart of ``maybe_trace`` in
``otpose_tpu/utils/profiling.py``).

``maybe_trace`` records a ``torch.profiler`` trace of train steps
[first, first + num) into ``cfg.TPU.PROFILE_DIR`` (CPU activity, and CUDA
activity when a GPU is visible) and writes it there as a Chrome trace.  The
step timer and ``synchronize`` of the JAX module are not ported yet
(ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import contextlib
import logging
import os
import os.path as osp
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
