"""Small IO, seeding and registry utilities (counterpart of
``otpose_tpu/utils/io.py``).

ref: utils/rw_json.py:4-14, utils/model_env.py:7-16, utils/registry.py:9-74.
"""

from __future__ import annotations

import json
import random
from typing import Callable, Dict, Optional

import numpy as np
import torch


def read_json_from_file(path: str):
    with open(path, "r") as f:
        return json.load(f)


def write_json_to_file(obj, path: str):
    with open(path, "w") as f:
        json.dump(obj, f)


def set_random_seed(seed: int):
    """Seed python, numpy and torch's default generators, on the CPU and on
    every CUDA device (ref: utils/model_env.py:7-16).  The port's model
    inits and dropout draw from explicit ``torch.Generator``s, which this
    leaves alone."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)          # the CPU generator and, lazily, every CUDA one
    torch.cuda.manual_seed_all(seed)


class Registry:
    """Name -> constructor registry (ref: utils/registry.py:9-74)."""

    def __init__(self, name: str):
        self._name = name
        self._map: Dict[str, Callable] = {}

    def register(self, obj: Optional[Callable] = None, *, name: Optional[str] = None):
        def _do(fn: Callable) -> Callable:
            key = name or fn.__name__
            if key in self._map:
                raise KeyError(f"{key} already registered in {self._name}")
            self._map[key] = fn
            return fn

        if obj is None:
            return _do
        return _do(obj)

    def get(self, name: str) -> Callable:
        if name not in self._map:
            raise KeyError(f"{name} not found in registry {self._name} "
                           f"(have: {sorted(self._map)})")
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map


DATASET_REGISTRY = Registry("DATASET")
MODEL_REGISTRY = Registry("MODEL")
