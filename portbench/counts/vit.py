"""The arithmetic of a ViT estimator (``reference/vitpose.py``) from the
configuration's shapes, whatever implements it: the four dense products a
block, the attention's bytes and operations, and a whole eval batch's model
FLOPs.  A multiply-add counts two operations, as ``flops.py``'s counter
counts them."""

from __future__ import annotations

import functools
import json

import torch

from portbench.counts import Work, flops
from portbench.reference import model as ref_model
from portbench.reference import vitpose


def product_flops(cfg: dict, frames: int) -> int:
    """The blocks' qkv, proj, fc1 and fc2 over ``frames`` frames: 2 x the
    four weights' elements (12 C^2 at MLP ratio 4) x tokens x depth."""
    s = vitpose.ViTSpec(cfg)
    weights = 3 * s.dim * s.dim + s.dim * s.dim + 2 * s.dim * s.dim * s.mlp_ratio
    return 2 * weights * s.tokens * s.depth * frames


def attention(cfg: dict, frames: int, dtype: str = "bfloat16") -> Work:
    """The fused attention of every block over ``frames`` frames: q, k and v
    read and the output written (N x C each a layer and frame), and the
    products q k^T and att v (2 N^2 d each a head)."""
    s = vitpose.ViTSpec(cfg)
    es = 2 if dtype == "bfloat16" else 4
    calls = s.depth * frames
    moved = 4 * s.tokens * s.dim * es * calls
    ops = 2 * 2 * s.tokens * s.tokens * s.dim * calls
    return Work(moved, ops, 0, dtype)


@functools.lru_cache(maxsize=4)
def _batch_flops(cfg_json: str, batch: int) -> int:
    cfg = json.loads(cfg_json)
    w, h = cfg["MODEL"]["IMAGE_SIZE"]
    with torch.device("meta"):
        model = vitpose.OTPose(cfg).eval()
        x, margin = torch.empty(batch, h, w, 15), torch.empty(batch, 4)
    with torch.no_grad():
        return flops._counted(lambda: ref_model.forward(model, x, margin))


def eval_flops(cfg: dict, batch: int) -> int:
    """The model FLOPs of one eval forward of ``batch`` clips: the reference
    on the meta device under ``FlopCounterMode`` (products and convolutions;
    the estimator on 5 x ``batch`` frames and OTPose's head)."""
    return _batch_flops(json.dumps(cfg, sort_keys=True), batch)
