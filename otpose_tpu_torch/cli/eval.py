"""Evaluation entry point (counterpart of ``otpose_tpu/cli/eval.py``).

ref: eval.py:19-121.

    python -m otpose_tpu_torch.cli.eval --cfg <yaml> [--val|--test] [--device cpu]
    torchrun --nproc_per_node N -m otpose_tpu_torch.cli.eval --cfg <yaml> ...

builds the val/test dataset, resolves the checkpoint list (explicit
MODEL_FILE, a specific checkpoint id, or latest), and runs the poseval
evaluation for each on one device: ``cuda`` unless ``--device cpu`` is given,
and without a GPU the default raises.  The config keeps the JAX package's key
names (``TPU.COMPUTE_DTYPE``, ``TPU.PARAM_DTYPE``, ``TPU.DEVICE_PREPROCESS``),
so one yaml serves both packages.

``TPU.DEVICE_PREPROCESS`` picks the loader as in the JAX package: ``auto``
(the repository's yamls) takes the device loader in its ``crops`` mode on a
GPU and the host loader on the CPU; ``crops``, ``full`` and ``off`` choose.

With ``DEBUG.VIS_SKELETON`` or ``VIS_BBOX`` set the heatmaps come to the
host (``make_eval_step`` or, with flip, ``make_flip_eval_step``, then
``evaluate_epoch``), which decodes them and draws, as the JAX CLI does;
otherwise the decode runs on the device and 17 coords a box come back.

Under a multi-process launch (``parallel/distributed.py``) the batch is
``BATCH_SIZE_PER_GPU`` times the number of ranks, every rank loads it whole
and runs its data group's row block (a batch that does not divide runs
whole on every data group), and rank 0 scores the gathered keypoints.
``TPU.MESH_AXES ["data", "seq"]`` with ``MESH_SHAPE [D, S]`` (-1: the ranks
left) lays the ranks out as D data groups of S ranks that split the
conv-transformer's tokens (``parallel/sequence.py``; JAX's ``seq_axis``).
"""

from __future__ import annotations

import logging
import os.path as osp

import torch

from otpose_tpu_torch.config import default_parse_args
from otpose_tpu_torch.data import describe_loader, make_loader
from otpose_tpu_torch.data.posetrack import PoseTrackDataset
from otpose_tpu_torch.engine import checkpoints as ckpt
from otpose_tpu_torch.engine.base import RunBase
from otpose_tpu_torch.engine.runner import (evaluate_epoch, evaluate_epoch_decoded,
                                            make_flip_eval_step)
from otpose_tpu_torch.engine.trainer import make_decoded_eval_step, make_eval_step
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.otpose import prepare_eval_params
from otpose_tpu_torch.parallel import distributed
from otpose_tpu_torch.parallel.mesh import make_eval_shard_fn, make_mesh, seq_group
from otpose_tpu_torch.utils.device import resolve_device, resolve_dtype

logger = logging.getLogger(__name__)


class Eval(RunBase):
    """``dataset_cls`` is the dataset to build (a ``PoseTrackDataset``
    subclass that supplies frames another way, for a machine without cv2).
    ``make_step`` is the one method a subclass overrides to wrap the step,
    as a smoke run does to bracket each step with CUDA events."""

    def __init__(self, phase: str = "validate", args=None, device=None,
                 dataset_cls=PoseTrackDataset):
        args = args if args is not None else default_parse_args()
        # before any folder is made: without a GPU the default device raises
        self.device = resolve_device(device if device is not None
                                     else getattr(args, "device", None))
        super().__init__(phase, args=args)
        cfg = self.cfg
        world = distributed.maybe_initialize(cfg, device=self.device)[1]
        mesh = make_mesh(cfg)
        self.seq = seq_group(mesh)
        self.shard_fn = make_eval_shard_fn(mesh)
        self.dataset = dataset_cls(cfg, phase)
        sub = cfg.VAL if phase == "validate" else cfg.TEST
        self.batch = sub.BATCH_SIZE_PER_GPU * world
        self.loader = make_loader(cfg, self.dataset, self.batch, shuffle=False,
                                  device=self.device)
        logger.info("=> %s loader: %s on %s", phase, describe_loader(self.loader), self.device)
        self.model_file = sub.MODEL_FILE
        self.flip = sub.FLIP_VAL if phase == "validate" else sub.FLIP_TEST
        self.compute_dtype = resolve_dtype(cfg.TPU.COMPUTE_DTYPE)
        # drawing needs the heatmaps on the host; otherwise decode on the device
        self.use_decoded = not (cfg.DEBUG.VIS_SKELETON or cfg.DEBUG.VIS_BBOX)

    def list_model_files(self):
        """ref: eval.py:64-83."""
        if self.model_file:
            return [ckpt.resolve_model_file(self.model_file, self.cfg,
                                            self.checkpoints_save_folder)]
        val_from = int(getattr(self.args, "val_from_checkpoint", -1))
        folder = self.checkpoints_save_folder
        if val_from >= 0:
            all_ckpts = ckpt.get_all_checkpoints(folder)
            return [c for c in all_ckpts
                    if ckpt._parse_epoch(osp.basename(c)) >= val_from]
        latest = ckpt.get_latest_checkpoint(folder)
        if latest is None:
            best = ckpt.get_best_checkpoint(folder)
            return [best] if best else []
        return [latest]

    def make_step(self, model):
        """The eval step of ``model``: decoded (forward and decode on its
        device; 17 coords a box come back), or with ``use_decoded`` false
        the heatmap step (with the flip average when ``flip``); sequence
        parallel under a ``seq`` axis."""
        if self.use_decoded:
            return make_decoded_eval_step(model, compute_dtype=self.compute_dtype,
                                          flip=self.flip, seq=self.seq)
        if self.flip:
            return make_flip_eval_step(model, compute_dtype=self.compute_dtype, seq=self.seq)
        return make_eval_step(model, compute_dtype=self.compute_dtype, seq=self.seq)

    def eval(self):
        results = []
        model_files = self.list_model_files()
        if not model_files:
            raise FileNotFoundError(
                f"no checkpoint found in {self.checkpoints_save_folder} and no "
                f"MODEL_FILE configured")
        for model_file in model_files:
            logger.info("=> evaluating %s", model_file)
            model = self._load(model_file)
            eval_epoch = evaluate_epoch_decoded if self.use_decoded else evaluate_epoch
            name_values, mean_ap = eval_epoch(
                self.make_step(model), self.loader, self.dataset, self.cfg,
                self.cfg.OUTPUT_DIR, phase=self.phase, device=self.device,
                shard_fn=self.shard_fn)
            results.append((model_file, name_values, mean_ap))
        return results

    def _load(self, model_file: str):
        """A fresh model on the device with the checkpoint merged in
        (ref: eval.py:97-116)."""
        _, model = build_model(self.cfg, seed=0, device=self.device)
        blob = ckpt.restore_checkpoint(model_file)
        if self.pe_name == "MSRA":
            # MSRA checkpoints store the pose net under a
            # 'rough_pose_estimation_net.' prefix (ref: eval.py:109-111)
            strip = "rough_pose_estimation_net."
            for part in ("params", "model_state"):
                blob[part] = {
                    (k[len(strip):] if k.startswith(strip) else k): v
                    for k, v in blob.get(part, {}).items()}
        n = ckpt.merge_checkpoint(blob, model)
        total = sum(1 for _ in model.parameters())
        logger.info("=> loaded %d/%d tensors", n, total)
        if n == 0:
            # the reference's load_state_dict is strict; evaluating a
            # random-init model would silently report garbage mAP
            raise ValueError(
                f"checkpoint {model_file} matched 0 of {total} tensors "
                f"(wrong architecture/width for this config?)")
        # eval fast path (once per checkpoint, outside the step): optional
        # bf16 conv/dense weights; norm statistics still run in f32
        return prepare_eval_params(
            model, torch.bfloat16 if self.cfg.TPU.PARAM_DTYPE == "bfloat16" else None)


def main(argv=None):
    args = default_parse_args(argv)
    phase = "test" if getattr(args, "test", False) else "validate"
    try:
        Eval(phase, args).eval()
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
