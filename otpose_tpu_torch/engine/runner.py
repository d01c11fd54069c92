"""Evaluation engine loops (counterpart of ``otpose_tpu/engine/runner.py``'s
eval side, single device).

ref: script/Common.py:296-453.  The forward and the decode run on the
model's device; the host feeds batches, keeps the PCK meter, back-projects
17 points a box and runs the poseval stage.  ``make_flip_eval_step`` is the
flip-test averaging behind ``VAL.FLIP_VAL`` / ``TEST.FLIP_TEST``.  The
``DEBUG.VIS_*`` drawing helpers are not ported yet (ROADMAP Queue 1 item
10): with such a flag set the loops raise.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict

import numpy as np
import torch

from otpose_tpu_torch.data.posetrack import FLIP_PAIRS
from otpose_tpu_torch.evaluate.pck import accuracy, calc_dists, dist_acc
from otpose_tpu_torch.models.otpose import OTPose, otpose_forward
from otpose_tpu_torch.ops.affine import apply_affine_to_points, get_affine_transform
from otpose_tpu_torch.ops.heatmap import get_final_preds, get_max_preds
from otpose_tpu_torch.utils.device import resolve_device, resolve_dtype
from otpose_tpu_torch.utils.table import pipe_table

logger = logging.getLogger(__name__)


class AverageMeter:
    """ref: script/Common.py:22-40."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


def flip_permutation(num_joints: int) -> list:
    """The joint order that swaps each left/right pair of ``FLIP_PAIRS``."""
    pairs = np.asarray(FLIP_PAIRS)
    perm = np.arange(num_joints)
    perm[pairs[:, 0]], perm[pairs[:, 1]] = pairs[:, 1], pairs[:, 0]
    return perm.tolist()


def make_flip_eval_step(model: OTPose, *, compute_dtype=torch.float32,
                        fused: bool = True) -> Callable:
    """Eval forward with horizontal flip-test averaging: ``step(inputs
    (B, H, W, 15), margin (B, 4))`` -> (heatmaps (B, Hh, Hw, J), teacher
    (B, Hh, Hw, J)).

    The clip is flipped on W and run a second time; those heatmaps are
    unflipped, their left/right joints swapped, and shifted right by one
    column with column 0 duplicated (the simple-baselines shift), then
    averaged with the direct pass.  The teacher is the direct pass's rough
    heatmaps of the current frame.  The step puts the model in eval mode."""
    dtype = resolve_dtype(compute_dtype)
    perm = flip_permutation(model.spec.num_joints)

    @torch.inference_mode()
    def step(inputs, margin):
        model.eval()
        out = otpose_forward(model, inputs, margin, compute_dtype=dtype, fused=fused)
        out_f = otpose_forward(model, torch.flip(inputs, dims=[2]), margin,
                               compute_dtype=dtype, fused=fused)
        heat_f = torch.flip(out_f[0], dims=[2])[..., perm]
        heat_f = torch.cat([heat_f[:, :, :1], heat_f[:, :, :-1]], dim=2)
        return (out[0] + heat_f) * 0.5, out[1][:inputs.shape[0]]

    return step


def refuse_vis(cfg) -> None:
    if cfg.DEBUG.VIS_SKELETON or cfg.DEBUG.VIS_BBOX:
        raise NotImplementedError(
            "DEBUG.VIS_SKELETON / DEBUG.VIS_BBOX: the drawing helpers are not ported "
            "yet (ROADMAP Queue 1 item 10)")


def _pipelined_forward(loader, run_fn, fetch_fn, device):
    """One-deep pipeline over an eval loader: enqueue batch i + 1's forward
    before fetching batch i's results, so the device computes while the host
    decodes and accumulates.

    ``run_fn(inputs, margin)`` launches the device step on tensors on
    ``device``; ``fetch_fn(outs)`` brings its results to the host, which
    waits for them.  A batch of the device loader is already on ``device``
    and is taken as it is; a host batch is staged in pinned memory and
    copied without blocking for a CUDA device."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    pending = None
    for batch, metas in loader:
        fwd = []
        for k in ("inputs", "margin"):
            v = batch[k]
            if isinstance(v, torch.Tensor):
                if v.device.type != device.type:
                    raise ValueError(f"eval: the loader's {k} is on {v.device}, the run on "
                                     f"{device}")
                fwd.append(v)
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            fwd.append(t.pin_memory().to(device, non_blocking=True) if cuda else t)
        outs = run_fn(*fwd)
        if pending is not None:
            p_outs, p_batch, p_metas = pending
            yield fetch_fn(p_outs), p_batch, p_metas
        pending = (outs, batch, metas)
    if pending is not None:
        p_outs, p_batch, p_metas = pending
        yield fetch_fn(p_outs), p_batch, p_metas


def _to_host(t) -> np.ndarray:
    """A tensor on any device, or a host array, as a numpy array."""
    return t.float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _box_rows(all_boxes, idx, metas):
    """Fill rows idx.. of the (N, 6) box table [center | scale | area | score]
    from a batch's metas; returns (center, scale)."""
    center = np.stack([m["center"] for m in metas])
    scale = np.stack([m["scale"] for m in metas])
    n = len(metas)
    all_boxes[idx:idx + n, 0:2] = center
    all_boxes[idx:idx + n, 2:4] = scale
    all_boxes[idx:idx + n, 4] = np.prod(scale * 200, 1)
    all_boxes[idx:idx + n, 5] = np.asarray([m["score"] for m in metas])
    return center, scale


def _finish(dataset, cfg, all_preds, all_boxes, filenames_map, output_dir, phase,
            tb_writer, global_steps):
    name_values, mean_ap = dataset.evaluate(cfg, all_preds, output_dir, all_boxes,
                                            filenames_map)
    _print_name_value(name_values, cfg.MODEL.NAME)
    if tb_writer is not None:
        tb_writer.add_scalar(f"{phase}/mAP", mean_ap, global_steps)
    return name_values, mean_ap


def evaluate_epoch(eval_fn, loader, dataset, cfg, output_dir: str, *,
                   phase: str = "validate", device=None, tb_writer=None,
                   global_steps: int = 0):
    """Full evaluation pass with the decode on the host (ref:
    script/Common.py:296-453): ``eval_fn`` is a ``make_eval_step`` or
    ``make_flip_eval_step`` step of a model on ``device``.  Returns
    (name_values, mean_ap)."""
    refuse_vis(cfg)
    device = resolve_device(device)
    batch_time = AverageMeter()
    acc_meter = AverageMeter()
    all_preds = np.zeros((len(dataset), cfg.MODEL.NUM_JOINTS, 3))
    all_boxes = np.zeros((len(dataset), 6))
    filenames_map: Dict[str, list] = {}
    idx = 0
    end = time.time()

    pipeline = _pipelined_forward(loader, lambda x, m: eval_fn(x, m)[0], _to_host, device)
    for it, (preds_np, batch, metas) in enumerate(pipeline):
        # PCK meter on NCHW layout
        heat = preds_np.transpose(0, 3, 1, 2)
        _, avg_acc, cnt, _ = accuracy(heat, _to_host(batch["target"]).transpose(0, 3, 1, 2))
        acc_meter.update(avg_acc, cnt)
        batch_time.update(time.time() - end)
        end = time.time()

        for i, meta in enumerate(metas):
            filenames_map.setdefault(meta["image"], []).append(idx + i)
        center, scale = _box_rows(all_boxes, idx, metas)
        n = preds_np.shape[0]
        preds, maxvals = get_final_preds(heat, center, scale)
        all_preds[idx:idx + n, :, 0:2] = preds[:, :, 0:2]
        all_preds[idx:idx + n, :, 2:3] = maxvals
        idx += n
        if it % cfg.PRINT_FREQ == 0:
            logger.info("%s: [%d/%d]\tTime %.3f (%.3f)\tAccuracy %.3f (%.3f)",
                        phase, it, len(loader), batch_time.val, batch_time.avg,
                        acc_meter.val, acc_meter.avg)
    return _finish(dataset, cfg, all_preds, all_boxes, filenames_map, output_dir, phase,
                   tb_writer, global_steps)


def _print_name_value(name_value, full_arch_name):
    """ref: script/Common.py:65-77.  Values print as a four-decimal number
    read back and formatted with ``%g``, which is what tabulate makes of
    them."""
    cells = [format(float("{:.4f}".format(v)), "g") for v in name_value.values()]
    table = pipe_table([[full_arch_name] + cells],
                       headers=["Model"] + list(name_value.keys()))
    logger.info("=> Result Table: \n" + table)


def evaluate_epoch_decoded(decoded_fn, loader, dataset, cfg, output_dir: str, *,
                           phase: str = "validate", device=None, tb_writer=None,
                           global_steps: int = 0):
    """Evaluation with the decode on the device: fetches 17 coords per box
    instead of full heatmaps (the reference decodes heatmaps on the host per
    box, ref: script/Common.py:419-432).  ``decoded_fn`` is a
    ``make_decoded_eval_step`` step of a model on ``device``.  Functionally
    equivalent to ``evaluate_epoch`` (same PCK meter semantics, same poseval
    output)."""
    refuse_vis(cfg)
    device = resolve_device(device)
    batch_time = AverageMeter()
    acc_meter = AverageMeter()
    num_joints = cfg.MODEL.NUM_JOINTS
    hm_w, hm_h = cfg.MODEL.HEATMAP_SIZE
    all_preds = np.zeros((len(dataset), num_joints, 3))
    all_boxes = np.zeros((len(dataset), 6))
    filenames_map: Dict[str, list] = {}
    idx = 0
    end = time.time()

    pipeline = _pipelined_forward(loader, decoded_fn,
                                  lambda outs: tuple(_to_host(o) for o in outs), device)
    for it, ((coords, maxvals, raw_coords), batch, metas) in enumerate(pipeline):
        # PCK meter: device pred argmax vs host target argmax
        # (ref: utils/evaluate.py:384-415)
        gt_coords, _ = get_max_preds(_to_host(batch["target"]).transpose(0, 3, 1, 2))
        norm = np.ones((coords.shape[0], 2)) * np.array([hm_h, hm_w]) / 10
        dists = calc_dists(raw_coords, gt_coords, norm)
        accs = [dist_acc(dists[i]) for i in range(num_joints)]
        valid = [a for a in accs if a >= 0]
        if valid:
            acc_meter.update(float(np.mean(valid)), len(valid))
        batch_time.update(time.time() - end)
        end = time.time()

        for i, meta in enumerate(metas):
            filenames_map.setdefault(meta["image"], []).append(idx + i)
        center, scale = _box_rows(all_boxes, idx, metas)
        n = coords.shape[0]
        for i in range(n):
            trans = get_affine_transform(center[i], scale[i], 0, [hm_w, hm_h], inv=1)
            all_preds[idx + i, :, 0:2] = apply_affine_to_points(coords[i], trans)
        all_preds[idx:idx + n, :, 2:3] = maxvals
        idx += n
        if it % cfg.PRINT_FREQ == 0:
            logger.info("%s: [%d/%d]\tTime %.3f (%.3f)\tAccuracy %.3f (%.3f)",
                        phase, it, len(loader), batch_time.val, batch_time.avg,
                        acc_meter.val, acc_meter.avg)
    return _finish(dataset, cfg, all_preds, all_boxes, filenames_map, output_dir, phase,
                   tb_writer, global_steps)
