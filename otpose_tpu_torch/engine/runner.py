"""Training and evaluation engine loops (counterpart of
``otpose_tpu/engine/runner.py``).

ref: script/Common.py:79-453.  ``train_epoch`` runs one epoch of train
steps, each on the model's device with its dropout generator re-seeded from
(seed, epoch, step) and, under a multi-process launch, the data index.  In
evaluation the forward and the decode run on the model's device; the host
feeds batches, keeps the PCK meter, back-projects 17 points a box and runs
the poseval stage.  Under a launch (``parallel/distributed.py``) every rank
holds the full eval batch, runs its data group's row block
(``parallel/mesh.py::make_eval_shard_fn``; under a ``seq`` axis the ranks of
a seq group split its tokens) and gathers every data group's outputs; rank
0 alone runs poseval and its mean AP reaches the others by
``broadcast_scalar``.
``make_flip_eval_step`` is the flip-test averaging behind ``VAL.FLIP_VAL`` /
``TEST.FLIP_TEST``.  The ``DEBUG.VIS_*`` flags draw as the JAX loops do, on
the primary rank: ``VIS_SKELETON`` / ``VIS_BBOX`` put each box's skeleton and
box on its original frame every eval iteration (both loops) and, in
``evaluate_epoch``, dump a crop-space result image every ``PRINT_FREQ``
iterations; ``VIS_TENSORBOARD`` adds input and target grids to the train
loop's TensorBoard writer.
"""

from __future__ import annotations

import itertools
import logging
import time
from collections import defaultdict
from typing import Callable, Dict

import numpy as np
import torch

from otpose_tpu_torch.data.posetrack import FLIP_PAIRS
from otpose_tpu_torch.engine.graphs import BackboneGraph
from otpose_tpu_torch.evaluate.pck import accuracy, calc_dists, dist_acc
from otpose_tpu_torch.models.otpose import OTPose, otpose_forward
from otpose_tpu_torch.ops.affine import apply_affine_to_points, get_affine_transform
from otpose_tpu_torch.ops.heatmap import get_final_preds, get_max_preds
from otpose_tpu_torch.parallel.distributed import (broadcast_scalar, data_info, fetch,
                                                   is_primary)
from otpose_tpu_torch.parallel.mesh import place
from otpose_tpu_torch.utils import profiling
from otpose_tpu_torch.utils.device import resolve_device, resolve_dtype
from otpose_tpu_torch.utils.table import pipe_table

logger = logging.getLogger(__name__)
TRAIN_KEYS = ("inputs", "margin", "target", "target_weight")


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
                        fused: bool = True, seq=None, teacher: bool = True) -> Callable:
    """Eval forward with horizontal flip-test averaging: ``step(inputs
    (B, H, W, 15), margin (B, 4))`` -> (heatmaps (B, Hh, Hw, J), teacher
    (B, Hh, Hw, J)).

    The clip is flipped on W and run a second time; those heatmaps are
    unflipped, their left/right joints swapped, and shifted right by one
    column with column 0 duplicated (the simple-baselines shift), then
    averaged with the direct pass.  The teacher is the direct pass's rough
    heatmaps of the current frame.  The step puts the model in eval mode;
    ``seq`` runs both passes sequence parallel.  Without ``seq`` both
    passes run HRNet through the step's ``BackboneGraph``, as
    ``make_eval_step`` does: the direct pass's teacher is copied out of the
    graph's buffer before the flipped pass replays into it, and
    ``teacher=False`` returns None in its place."""
    dtype = resolve_dtype(compute_dtype)
    # the joint swap as an index on the model's device, made once: an index
    # list would be copied to the card from pageable memory every step, a wait
    perm = torch.tensor(flip_permutation(model.spec.num_joints),
                        device=next(model.parameters()).device)
    backbone = BackboneGraph(model) if seq is None else None

    @torch.inference_mode()
    def step(inputs, margin):
        with profiling.step("otpose.eval.step"):
            model.eval()
            out = otpose_forward(model, inputs, margin, compute_dtype=dtype, fused=fused,
                                 seq=seq, backbone=backbone)
            rough = None
            if teacher:
                rough = out[1][:inputs.shape[0]]
                rough = rough if backbone is None else backbone.keep(rough)
            out_f = otpose_forward(model, torch.flip(inputs, dims=[2]), margin,
                                   compute_dtype=dtype, fused=fused, seq=seq,
                                   backbone=backbone)
            heat_f = torch.flip(out_f[0], dims=[2])[..., perm]
            heat_f = torch.cat([heat_f[:, :, :1], heat_f[:, :, :-1]], dim=2)
            return (out[0] + heat_f) * 0.5, rough

    return step


def _batch_on(batch, keys, device: torch.device) -> list:
    """The tensors ``batch[k]`` for ``keys`` on ``device``.  A batch of the
    device loader is already there and is taken as it is; a host batch is
    staged in pinned memory and copied without blocking for a CUDA device."""
    return [place(batch[k], device) for k in keys]


def step_seed(seed: int, epoch: int, global_steps: int, rank: int = 0) -> int:
    """The seed of a train step's dropout generator: a hash of (seed, epoch,
    global step), as the JAX package keys a step's dropout by
    ``fold_in(fold_in(PRNGKey(seed), epoch), global_steps)``.  A step's
    draws then depend on its indices only, so a resumed run draws what the
    uninterrupted run drew (the bits differ from JAX's).  A rank above 0 of
    a multi-process launch hashes its rank in too, so the ranks draw
    independent masks for their different rows; rank 0's seed is the
    single-process one.  ``rank`` is the data index: the ranks of a seq
    group hold the same rows and draw the same masks."""
    entropy = [seed, epoch, global_steps] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


def train_epoch(step_fn, state, loader, epoch: int, cfg, *, seed: int,
                generator: torch.Generator, tb_writer=None, global_steps: int = 0,
                start_iteration: int = 0, should_stop=None) -> tuple:
    """One training epoch (ref: script/Common.py:79-294).  Returns (state,
    global_steps, completed_iterations).

    ``step_fn`` is a ``make_train_step`` step of ``state.model`` made with
    ``generator``, which is re-seeded before each step from ``step_seed(seed,
    epoch, global_steps)``.  ``start_iteration`` resumes mid-epoch: the
    loader skips the first k batches, and ``global_steps`` must already count
    them.  ``should_stop`` (``PreemptionGuard.check``) is asked after each
    step; when it says so the epoch returns early and
    ``completed_iterations`` says what to checkpoint.  Metrics come to the
    host only every ``PRINT_FREQ`` iterations and on the last one (a fetch
    waits for the device), for the log line and the TensorBoard scalars,
    in the span ``otpose.train.fetch_metrics``; steps [10, 15) are traced
    into ``TPU.PROFILE_DIR`` when it is set."""
    device = next(state.model.parameters()).device
    batch_time = AverageMeter()
    data_time = AverageMeter()
    acc_meter = AverageMeter()
    losses = defaultdict(AverageMeter)

    end = time.time()
    max_iter = len(loader)
    completed = start_iteration
    rank = data_info()[0]
    if start_iteration:
        loader.set_start_iteration(start_iteration)
    for it, (batch, _metas) in enumerate(loader, start=start_iteration):
        data_time.update(time.time() - end)
        batch = dict(zip(TRAIN_KEYS, _batch_on(batch, TRAIN_KEYS, device)))
        generator.manual_seed(step_seed(seed, epoch, global_steps, rank))
        with profiling.maybe_trace(cfg.TPU.PROFILE_DIR, step=global_steps):
            metrics = step_fn(batch)
        batch_time.update(time.time() - end)
        end = time.time()
        global_steps += 1
        completed = it + 1

        if it % cfg.PRINT_FREQ == 0 or it >= max_iter - 1:
            with profiling.span("otpose.train.fetch_metrics"):
                host_metrics = {k: float(v) for k, v in metrics.items()}
            for k, v in host_metrics.items():
                losses[k].update(v)
            if tb_writer is not None:
                for k, v in host_metrics.items():
                    tb_writer.add_scalar(f"train/{k}", v, global_steps)
                if cfg.DEBUG.VIS_TENSORBOARD:
                    _tb_image_grids(tb_writer, batch, global_steps)
            acc_meter.update(host_metrics.get("pck_acc", 0.0))
            bsz = batch["inputs"].shape[0]
            loss_meter = losses["final_loss"]
            # the averages are over the fetched iterations (ref: Common.py:212-218)
            logger.info(
                "Epoch: [%03d][%05d/%05d]\tTime %.3fs (%.3fs)\t"
                "Speed %.1f samples/s\tData %.3fs\tLoss %.5f (%.5f)\tAcc %.3f",
                epoch, it, max_iter, batch_time.val, batch_time.avg,
                bsz / max(batch_time.val, 1e-9), data_time.val,
                loss_meter.val, loss_meter.avg, acc_meter.avg)
        if should_stop is not None and should_stop():
            logger.info("train_epoch: stop requested at epoch %d iteration %d", epoch, completed)
            break
    return state, global_steps, completed


def _pipelined_forward(loader, run_fn, fetch_fn, device, shard_fn=None):
    """One-deep pipeline over an eval loader: enqueue batch i + 1's forward
    before fetching batch i's results, so the device computes while the host
    decodes and accumulates.

    ``run_fn(inputs, margin)`` launches the device step on tensors on
    ``device`` (``_batch_on``); ``fetch_fn(outs)`` brings its results to the
    host, which waits for them.  With a ``shard_fn``
    (``parallel/mesh.py::make_eval_shard_fn``) the step runs on the rows it
    gives, and the outputs of a split batch come back from every rank
    (``distributed.fetch``).  The spans ``otpose.eval.dispatch`` and
    ``otpose.eval.fetch`` time ``run_fn`` and the wait for its results."""
    device = torch.device(device)
    pending = None
    for batch, metas in loader:
        if shard_fn is None:
            (inputs, margin), gather = _batch_on(batch, ("inputs", "margin"), device), False
        else:
            rows, gather = shard_fn({k: batch[k] for k in ("inputs", "margin")}, device)
            inputs, margin = rows["inputs"], rows["margin"]
        with profiling.span("otpose.eval.dispatch"):
            outs = run_fn(inputs, margin)
        if pending is not None:
            yield _fetched(fetch_fn, *pending)
        pending = (outs, gather, batch, metas)
    if pending is not None:
        yield _fetched(fetch_fn, *pending)


def _fetched(fetch_fn, outs, gather, batch, metas):
    """``fetch_fn`` of the outputs, every rank's rows first where ``gather``."""
    with profiling.span("otpose.eval.fetch"):
        if gather:
            outs = tuple(fetch(o) for o in outs) if isinstance(outs, tuple) else fetch(outs)
        return fetch_fn(outs), batch, metas


def _to_host(t) -> np.ndarray:
    """A tensor on any device, or a host array, as a numpy array."""
    return t.float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _drawing(cfg) -> bool:
    """Whether the eval loops draw on this rank (``DEBUG.VIS_SKELETON`` or
    ``VIS_BBOX``, on the primary rank only)."""
    return bool(cfg.DEBUG.VIS_SKELETON or cfg.DEBUG.VIS_BBOX) and is_primary()


def _tb_image_grids(tb_writer, batch, global_steps, max_images: int = 6):
    """Input-frame and target-heatmap grids for TensorBoard
    (ref: script/Common.py:455-589, behind DEBUG.VIS_TENSORBOARD)."""
    from otpose_tpu_torch.utils.images import tensor2im

    inputs = _to_host(batch["inputs"][:max_images])
    imgs = np.stack([tensor2im(x[:, :, :3])[..., ::-1] for x in inputs])  # RGB
    tb_writer.add_images("train/input_images", imgs, global_steps, dataformats="NHWC")
    target = _to_host(batch["target"][:max_images])               # (N, Hh, Hw, J)
    heat = target.max(axis=-1, keepdims=True)
    heat = (heat / np.maximum(heat.max(axis=(1, 2, 3), keepdims=True), 1e-6)
            * 255).astype(np.uint8)
    tb_writer.add_images("train/gt_heatmaps", heat, global_steps, dataformats="NHWC")


def _dump_vis(cfg, output_dir, phase, it, batch, metas, preds_heat):
    """Crop-space skeleton and heatmap result image of a batch's first box,
    behind the DEBUG.VIS_* flags (ref: utils/evaluate.py:244-338)."""
    import os.path as osp

    from otpose_tpu_torch.utils.images import save_result_images, tensor2im

    out_dir = osp.join(output_dir, f"{phase}_vis")
    pose, conf = get_max_preds(preds_heat.transpose(0, 3, 1, 2))
    inputs = _to_host(batch["inputs"][:1])
    img = tensor2im(inputs[0, :, :, :3])
    stride = inputs.shape[1] / preds_heat.shape[1]
    return save_result_images(out_dir, img, pose[0] * stride, conf[0, :, 0],
                              heatmaps=preds_heat[0].transpose(2, 0, 1), name=f"{it}_pred_")


def _vis_origin_images(cfg, output_dir, phase, metas, preds, maxvals):
    """Skeleton and box overlays accumulated on the original frames, every
    eval iteration (ref: script/Common.py:591-602 and utils/images.py:40-88).
    ``preds`` are back-projected origin-image coordinates, so boxes and
    joints land on the same frame."""
    import os.path as osp

    from otpose_tpu_torch.ops.bbox import cs2box
    from otpose_tpu_torch.utils.images import draw_skeleton_in_origin_image

    coords = np.concatenate([preds[:, :, :2], maxvals], axis=-1)
    paths = [m["image"] for m in metas]
    bboxes = [cs2box(m["center"], m["scale"], pattern="xyxy") for m in metas]
    return draw_skeleton_in_origin_image(
        paths, coords, bboxes, osp.join(output_dir, f"{phase}_vis"),
        vis_skeleton=cfg.DEBUG.VIS_SKELETON, vis_bbox=cfg.DEBUG.VIS_BBOX)


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
    """Rank 0 writes the poseval files and scores them; every rank returns
    its mean AP (the others an empty table)."""
    name_values, mean_ap = {}, None
    if is_primary():
        name_values, mean_ap = dataset.evaluate(cfg, all_preds, output_dir, all_boxes,
                                                filenames_map)
        _print_name_value(name_values, cfg.MODEL.NAME)
    mean_ap = broadcast_scalar(mean_ap)
    if tb_writer is not None:
        tb_writer.add_scalar(f"{phase}/mAP", mean_ap, global_steps)
    return name_values, mean_ap


def evaluate_epoch(eval_fn, loader, dataset, cfg, output_dir: str, *,
                   phase: str = "validate", device=None, tb_writer=None,
                   global_steps: int = 0, shard_fn=None):
    """Full evaluation pass with the decode on the host (ref:
    script/Common.py:296-453): ``eval_fn`` is a ``make_eval_step`` or
    ``make_flip_eval_step`` step of a model on ``device``; ``shard_fn``
    places each batch over the ranks (see ``_pipelined_forward``).
    Returns (name_values, mean_ap); under a launch rank 0's table, the
    other ranks' empty, the mean AP on every rank.  With ``DEBUG.VIS_*``
    the primary rank draws (``_vis_origin_images``, ``_dump_vis``)."""
    device = resolve_device(device)
    batch_time = AverageMeter()
    acc_meter = AverageMeter()
    all_preds = np.zeros((len(dataset), cfg.MODEL.NUM_JOINTS, 3))
    all_boxes = np.zeros((len(dataset), 6))
    filenames_map: Dict[str, list] = {}
    idx = 0
    end = time.time()

    pipeline = _pipelined_forward(loader, lambda x, m: eval_fn(x, m)[0], _to_host, device,
                                  shard_fn)
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
        if _drawing(cfg):
            _vis_origin_images(cfg, output_dir, phase, metas, preds, maxvals)
        if it % cfg.PRINT_FREQ == 0:
            logger.info("%s: [%d/%d]\tTime %.3f (%.3f)\tAccuracy %.3f (%.3f)",
                        phase, it, len(loader), batch_time.val, batch_time.avg,
                        acc_meter.val, acc_meter.avg)
            if _drawing(cfg):
                _dump_vis(cfg, output_dir, phase, it, batch, metas, preds_np)
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
                           global_steps: int = 0, shard_fn=None):
    """Evaluation with the decode on the device: fetches 17 coords per box
    instead of full heatmaps (the reference decodes heatmaps on the host per
    box, ref: script/Common.py:419-432).  ``decoded_fn`` is a
    ``make_decoded_eval_step`` step of a model on ``device``.  Functionally
    equivalent to ``evaluate_epoch`` (same PCK meter semantics, same poseval
    output, the same ``shard_fn`` and return values; ``DEBUG.VIS_*`` draws
    on the original frames).  Batches [10, 15) are traced into
    ``TPU.PROFILE_DIR`` when it is set, from the dispatch of the first to
    the dispatch of the last."""
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

    dispatched = itertools.count()

    def traced(inputs, margin):
        with profiling.maybe_trace(cfg.TPU.PROFILE_DIR, step=next(dispatched),
                                   what="eval_batches"):
            return decoded_fn(inputs, margin)

    pipeline = _pipelined_forward(loader, traced,
                                  lambda outs: tuple(_to_host(o) for o in outs), device,
                                  shard_fn)
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
        if _drawing(cfg):
            _vis_origin_images(cfg, output_dir, phase, metas, all_preds[idx - n:idx], maxvals)
        if it % cfg.PRINT_FREQ == 0:
            logger.info("%s: [%d/%d]\tTime %.3f (%.3f)\tAccuracy %.3f (%.3f)",
                        phase, it, len(loader), batch_time.val, batch_time.avg,
                        acc_meter.val, acc_meter.avg)
    return _finish(dataset, cfg, all_preds, all_boxes, filenames_map, output_dir, phase,
                   tb_writer, global_steps)
