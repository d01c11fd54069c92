"""JAX ``(params, state)`` -> the port's ``state_dict``, and back.

The inverse of the JAX package's ``models/torch2jax.py::convert_state_dict``:

- 4-D conv kernels HWIO -> OIHW
- 3-D conv1d kernels (K, I, O) -> (O, I, K)
- (C,) channel-LayerNorm and drop-path params -> (1, C, 1), chosen by the
  owning module's name as ``convert_state_dict`` chooses them; the
  ConvTransformer's ``embd_norm.{i}`` LNs, whose owner is an index, too
- ``rel_pe`` (1, 1, n_head, window) as stored
- ``pos_embd`` state (1, T, C) -> (1, C, T)
- BN running stats taken from ``state``

A bare ``pose_hrnet`` tree (the HRNet keys without OTPose's
``rough_pose_estimation_net.`` prefix) goes through the same rules.

Arrays arrive as numpy (the port never imports JAX); ``load_jax_weights``
loads them with ``strict=True``.  ``to_jax`` is the inverse, for holding a
trained port model (params, BN running stats, or gradients by name) against
the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_CHANNEL_TOKENS = ("ln", "norm", "drop_path", "scale")


def is_channel_param(name: str) -> bool:
    """A channel-LN / drop-path param: stored (1, C, 1) in torch, (C,) in
    JAX.  Matched on the owning module's name, as ``convert_state_dict``
    does."""
    parts = name.split(".")
    owner = parts[-2] if len(parts) > 1 else ""
    if owner.isdigit() and len(parts) > 2 and parts[-3] == "embd_norm":
        owner = "embd_norm"            # the ModuleList of embedding-conv LNs
    return (name.endswith((".weight", ".bias", ".scale"))
            and any(t in owner for t in _CHANNEL_TOKENS))


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":   # numpy has no bf16; ml_dtypes does
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))   # a writable, contiguous copy


def from_jax(params: Mapping, state: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for name, arr in params.items():
        arr = np.asarray(arr)
        if name.endswith("rel_pe"):
            pass
        elif arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))       # HWIO -> OIHW
        elif arr.ndim == 3:
            arr = np.transpose(arr, (2, 1, 0))          # (K, I, O) -> (O, I, K)
        elif arr.ndim == 1 and is_channel_param(name):
            arr = arr.reshape(1, -1, 1)
        sd[name] = _tensor(arr)
    for name, arr in state.items():
        arr = np.asarray(arr)
        if name.endswith("pos_embd"):
            arr = np.transpose(arr, (0, 2, 1))          # (1, T, C) -> (1, C, T)
        sd[name] = _tensor(arr)
    return sd


def load_jax_weights(model: torch.nn.Module, params: Mapping, state: Mapping):
    """Load JAX weights into ``model`` (strict: every key on both sides)."""
    model.load_state_dict(from_jax(params, state), strict=True)
    return model


def jax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    """One port tensor named ``name`` (a parameter, a buffer or a parameter's
    gradient) as the JAX package stores it: an f32 numpy copy (f64 stays
    f64), which a later in-place update of ``t`` leaves as it is."""
    t = t.detach()
    arr = (t if t.dtype == torch.float64 else t.float()).cpu().numpy().copy()
    if name.endswith("rel_pe"):
        return arr
    if name.endswith("pos_embd"):
        return np.transpose(arr, (0, 2, 1))
    if arr.ndim == 4:
        return np.transpose(arr, (2, 3, 1, 0))          # OIHW -> HWIO
    if arr.ndim == 3 and is_channel_param(name):
        return arr.reshape(-1)
    if arr.ndim == 3:
        return np.transpose(arr, (2, 1, 0))             # (O, I, K) -> (K, I, O)
    return arr


def to_jax(model: torch.nn.Module):
    """The port model as JAX ``(params, state)`` numpy dicts."""
    params = {n: jax_layout(n, p) for n, p in model.named_parameters()}
    state = {n: jax_layout(n, b) for n, b in model.named_buffers()}
    return params, state
