"""Batch assembly of host-path samples (counterpart of
``otpose_tpu/data/pipeline.py::collate_host_samples``; that module's device
preprocessing is not ported yet)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def collate_host_samples(samples) -> Dict[str, np.ndarray]:
    """Stack host-path samples (from PoseTrackDataset.get_sample_host)."""
    batch = {
        "inputs": np.stack([s["inputs"] for s in samples]),
        "target": np.stack([s["target"] for s in samples]),
        "target_weight": np.stack([s["target_weight"] for s in samples]),
        "margin": np.stack([s["margin"] for s in samples]),
    }
    metas = [s["meta"] for s in samples]
    return batch, metas
