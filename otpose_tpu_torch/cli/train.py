"""Training entry point (counterpart of ``otpose_tpu/cli/train.py``).

ref: train.py:20-124.

    python -m otpose_tpu_torch.cli.train --cfg <yaml> [--device cpu]
        [--sigma_schedule E ...] [opts...]
    torchrun --nproc_per_node N -m otpose_tpu_torch.cli.train --cfg <yaml> ...

builds the train dataset and loader, the model (the reference init, then the
pretrained HRNet of ``MODEL.PRETRAINED``), the optimizer and the train step;
resumes from the latest ``epoch_N_state`` in the experiment's checkpoint
folder; then for each epoch anneals the target sigma, trains, saves an epoch
checkpoint every ``TRAIN.SAVE_MODEL_PER_EPOCH`` epochs (in the background
under ``TPU.ASYNC_CHECKPOINT``, overlapping validation), validates, and
keeps the best-mAP checkpoint.  A SIGTERM stops the run at the next
iteration boundary with a checkpoint of that exact iteration; the next run
resumes there (``engine/preempt.py``).  It runs on ``cuda`` unless
``--device cpu`` is given; without a GPU the default raises.  The yamls'
``TPU.DEVICE_PREPROCESS auto`` takes the device loader on a GPU.

Under a multi-process launch (``torchrun``, or the JAX package's
``OTPOSE_COORDINATOR`` / ``OTPOSE_NUM_PROCESSES`` / ``OTPOSE_PROCESS_ID``;
``parallel/distributed.py``) each rank runs on its own card, the global
batch is ``TRAIN.BATCH_SIZE_PER_GPU`` times the number of ranks, each rank
loads its rows of it, the step averages the gradients across the ranks, and
validation splits each batch over the ranks.  Rank 0 alone writes
checkpoints and TensorBoard; a SIGTERM to any rank stops every rank at the
same iteration.
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
from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
from otpose_tpu_torch.engine.preempt import make_preemption_guard
from otpose_tpu_torch.engine.runner import evaluate_epoch_decoded, train_epoch
from otpose_tpu_torch.engine.trainer import (init_train_state, make_decoded_eval_step,
                                             make_train_step)
from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.ops.heatmap import adjust_sigma
from otpose_tpu_torch.parallel import distributed
from otpose_tpu_torch.parallel.mesh import make_eval_shard_fn, make_mesh, replicate
from otpose_tpu_torch.utils.device import resolve_device, resolve_dtype

logger = logging.getLogger(__name__)


class Train(RunBase):
    """The training run.  ``device`` overrides ``--device``; ``dataset_cls``
    is the dataset to build for training and validation (a
    ``PoseTrackDataset`` subclass that supplies frames another way, for a
    machine without cv2).

    The step takes ``TPU.COMPUTE_DTYPE``, ``LOSS.TOPK``,
    ``LOSS.USE_TARGET_WEIGHT``, ``TPU.REMAT`` and ``TPU.ACCUM_STEPS``;
    ``TPU.DONATE_STATE`` has no meaning here (PyTorch updates the weights
    in place); the mesh keys allow one ``data`` axis over every rank."""

    def __init__(self, args=None, device=None, dataset_cls=PoseTrackDataset):
        args = args if args is not None else default_parse_args()
        # before any folder is made: without a GPU the default device raises
        self.device = resolve_device(device if device is not None
                                     else getattr(args, "device", None))
        super().__init__("train", args=args)
        cfg = self.cfg
        self.world = distributed.maybe_initialize(cfg, device=self.device)[1]
        self.mesh = make_mesh(cfg)
        self.dataset_cls = dataset_cls
        self.seed = cfg.SEED
        self.train_dataset = dataset_cls(cfg, "train")
        # the global batch; each rank loads its rows of it
        self.batch_size = cfg.TRAIN.BATCH_SIZE_PER_GPU * self.world
        self.loader = make_loader(cfg, self.train_dataset, self.batch_size,
                                  shuffle=cfg.TRAIN.SHUFFLE, drop_last=True, seed=self.seed,
                                  device=self.device, process_shard=True)
        logger.info("=> train loader: %s on %s", describe_loader(self.loader), self.device)

        _, self.model = build_model(cfg, seed=self.seed, device=self.device)
        self.pretrained_loaded = self._load_pretrained(self.model)
        replicate(self.model)

        schedule = make_schedule(cfg, max(1, len(self.loader)))
        self.optimizer = make_optimizer(self.model, cfg, schedule)
        self.train_state = init_train_state(self.model, self.optimizer)
        self.compute_dtype = resolve_dtype(cfg.TPU.COMPUTE_DTYPE)
        self.generator = torch.Generator(device=self.device)
        self.step_fn = make_train_step(self.model, self.optimizer,
                                       compute_dtype=self.compute_dtype, topk=cfg.LOSS.TOPK,
                                       use_target_weight=cfg.LOSS.USE_TARGET_WEIGHT,
                                       remat=cfg.TPU.REMAT, accum_steps=cfg.TPU.ACCUM_STEPS,
                                       generator=self.generator)
        # validation decodes on the device from the f32 master weights, as
        # they are: prepare_eval_params would cast them in place
        self.eval_fn = make_decoded_eval_step(self.model, compute_dtype=self.compute_dtype)

        self.tb_writer = None
        if distributed.is_primary():
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                logger.warning("tensorboardX unavailable; skipping TensorBoard logging")
            else:
                self.tb_writer = SummaryWriter(self.tb_save_folder)

    def _load_pretrained(self, model) -> int:
        """The pretrained COCO HRNet's partial load (ref:
        model/OTPose.py:477-499): the parameters of ``MODEL.PRETRAINED`` that
        ``filter_pretrained_for_otpose`` keeps and whose shapes match, then
        its BN statistics under their own name or under the pose net's
        prefix.  Returns the number of parameter tensors loaded."""
        path = self.cfg.MODEL.PRETRAINED
        if not path:
            return 0
        if not osp.isfile(path):
            logger.warning("pretrained model %s not found", path)
            return 0
        blob = ckpt.restore_checkpoint(path)
        loaded = ckpt.filter_pretrained_for_otpose(
            blob["params"], tuple(self.cfg.MODEL.EXTRA.get("PRETRAINED_LAYERS", ("*",))))
        own = model.state_dict()
        n = 0
        with torch.no_grad():
            for k, v in loaded.items():
                if k in own and own[k].shape == v.shape:
                    own[k].copy_(v)
                    n += 1
            for k, v in blob["model_state"].items():
                for cand in (k, f"rough_pose_estimation_net.{k}"):
                    if cand in own and own[cand].shape == v.shape:
                        own[cand].copy_(v)
                        break
        logger.info("=> loaded %d pretrained tensors from %s", n, path)
        return n

    def train(self):
        """Run (or resume) training to ``TRAIN.END_EPOCH``, or to a SIGTERM;
        returns the train state, every save committed."""
        self.train_state, begin_epoch, tb_steps, start_it = ckpt.resume(
            self.checkpoints_save_folder, self.train_state)
        if begin_epoch or start_it:
            logger.info("=> resumed from epoch %d (iteration %d)", begin_epoch, start_it)
        guard = make_preemption_guard(start_step=tb_steps)
        try:
            self._epochs(guard, begin_epoch, tb_steps, start_it)
        finally:
            guard.uninstall()
        ckpt.wait_for_saves()
        if self.tb_writer is not None:
            self.tb_writer.flush()
        return self.train_state

    def _epochs(self, guard, begin_epoch: int, tb_steps: int, start_it: int) -> None:
        cfg = self.cfg
        sigma_schedule = list(getattr(self.args, "sigma_schedule", []) or [])
        best_map = -1.0
        for epoch in range(begin_epoch, cfg.TRAIN.END_EPOCH):
            if sigma_schedule:
                self.train_dataset.sigma = adjust_sigma(epoch, cfg.MODEL.SIGMA, sigma_schedule)
            self.loader.set_epoch(epoch)
            self.train_state, tb_steps, done_it = train_epoch(
                self.step_fn, self.train_state, self.loader, epoch, cfg, seed=self.seed,
                generator=self.generator, tb_writer=self.tb_writer, global_steps=tb_steps,
                start_iteration=start_it if epoch == begin_epoch else 0,
                should_stop=guard.check)
            if guard.requested:
                # iteration 0 when the epoch happened to finish: the resume
                # begins the next epoch
                it_arg = 0 if done_it >= len(self.loader) else done_it
                ckpt.save_checkpoint(self.checkpoints_save_folder, epoch, self.train_state,
                                     tensorboard_global_steps=tb_steps, iteration=it_arg)
                logger.info("=> preempted: checkpointed epoch %d at iteration %d/%d; "
                            "exiting cleanly", epoch, done_it, len(self.loader))
                return
            if epoch % cfg.TRAIN.SAVE_MODEL_PER_EPOCH == 0:
                # asynchronous: the serialisation overlaps the validation below
                ckpt.save_checkpoint(self.checkpoints_save_folder, epoch, self.train_state,
                                     tensorboard_global_steps=tb_steps,
                                     async_save=bool(cfg.TPU.ASYNC_CHECKPOINT)
                                     and self.world == 1)
            mean_ap = self._validate(tb_steps)
            if mean_ap is not None and mean_ap > best_map:
                best_map = mean_ap
                ckpt.save_best_checkpoint(self.checkpoints_save_folder, self.train_state,
                                          float(mean_ap))

    def _validate(self, tb_steps: int):
        """One decoded evaluation of the training model; returns its mAP,
        or None when the validation annotations are absent.  The dataset and
        its loader are built once (the reference rebuilds its Eval object
        every epoch, ref: train.py:92-93)."""
        cfg = self.cfg
        if not hasattr(self, "_val_dataset"):
            try:
                self._val_dataset = self.dataset_cls(cfg, "validate")
            except FileNotFoundError as e:
                # only absent val annotations disable validation; any other
                # error fails, or best-checkpoint selection would vanish
                logger.warning("validation dataset unavailable (%s); skipping per-epoch "
                               "validation", e)
                self._val_dataset = None
            self._val_loader = None if self._val_dataset is None else make_loader(
                cfg, self._val_dataset, cfg.VAL.BATCH_SIZE_PER_GPU * self.world, shuffle=False,
                device=self.device)
            if self._val_loader is not None:
                logger.info("=> validation loader: %s", describe_loader(self._val_loader))
        if self._val_dataset is None:
            return None
        _, mean_ap = evaluate_epoch_decoded(
            self.eval_fn, self._val_loader, self._val_dataset, cfg, cfg.OUTPUT_DIR,
            phase="validate", device=self.device, tb_writer=self.tb_writer,
            global_steps=tb_steps, shard_fn=make_eval_shard_fn(self.mesh))
        return mean_ap


def main(argv=None):
    args = default_parse_args(argv)
    try:
        Train(args).train()
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
