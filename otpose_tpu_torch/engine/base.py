"""Run setup: output directories, logging, experiment naming.

ref: script/base.py:12-94.  ``RunBase`` derives
``OUTPUT_DIR/EXPERIMENT_NAME/DatasetName`` with checkpoints/tensorboard/log
subfolders and resets the root logger to file+stdout.  The port's copy of
``otpose_tpu/engine/base.py``.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import sys
import time

from otpose_tpu_torch.config import default_parse_args, get_dataset_name, setup
from otpose_tpu_torch.utils.table import pipe_table


def create_folder(path: str):
    os.makedirs(path, exist_ok=True)


class RunBase:
    def __init__(self, phase: str, args=None, cfg=None):
        self.phase = phase
        self.args = args if args is not None else default_parse_args()
        # --PE_Name semantics (ref: eval.py:109-111, script/Common.py:111-120):
        # OTPOSE is the model; MSRA only changes eval checkpoint loading (the
        # 'rough_pose_estimation_net.' prefix strip, see cli/eval.Eval._load).
        # POSETRANSFORMER names a single-frame branch whose model class the
        # reference cannot even import (script/Common.py:119-120 calls
        # model(input_x) on a model never built); accepting and silently
        # running OTPOSE instead would be worse than rejecting it.
        self.pe_name = str(getattr(self.args, "PE_Name", "OTPOSE")).upper()
        if self.pe_name not in ("OTPOSE", "MSRA"):
            raise NotImplementedError(
                f"--PE_Name {self.pe_name} is not supported: the reference's "
                "POSETRANSFORMER branch is broken upstream (script/"
                "Common.py:119-120 forwards a model that is never "
                "constructed); use OTPOSE, or MSRA for prefix-stripped "
                "checkpoint loading at eval")
        self.cfg = cfg if cfg is not None else setup(self.args)
        self.output_path_dict = {}
        self._setup_cfg()
        self._update_output_paths(phase)

    def _setup_cfg(self):
        cfg = self.cfg
        dataset_name = get_dataset_name(cfg)
        cfg.OUTPUT_DIR = osp.join(cfg.OUTPUT_DIR, cfg.EXPERIMENT_NAME, dataset_name)
        self.checkpoints_save_folder = osp.join(cfg.OUTPUT_DIR, "checkpoints")
        self.log_save_folder = osp.join(cfg.OUTPUT_DIR, "log")
        self.tb_save_folder = osp.join(cfg.OUTPUT_DIR, "tensorboard")
        for f in (self.checkpoints_save_folder, self.log_save_folder,
                  self.tb_save_folder):
            create_folder(f)
        self.output_path_dict = {
            "checkpoints_save_folder": self.checkpoints_save_folder,
            "tb_save_folder": self.tb_save_folder,
            "log_save_folder": self.log_save_folder,
        }

    def _update_output_paths(self, phase: str):
        self.log_file = osp.join(
            self.log_save_folder,
            "{}-{}.log".format(phase, time.strftime("%Y_%m_%d_%H")))
        self.reset_logger(self.log_file)
        self.show_info()

    def show_info(self):
        logger = logging.getLogger(__name__)
        table = pipe_table(
            [["Phase", self.phase],
             ["Log File", self.log_file],
             ["Checkpoint Folder", self.checkpoints_save_folder],
             ["Tensorboard_save_folder", self.tb_save_folder]],
            headers=["Key", "Value"])
        logger.info("=> Executor Operating Parameter Table: \n" + table)

    @staticmethod
    def reset_logger(save_file: str, logger_level=logging.INFO):
        logger = logging.getLogger()
        while logger.hasHandlers():
            logger.removeHandler(logger.handlers[0])
        logger.setLevel(logger_level)
        fh = logging.FileHandler(save_file)
        fh.setLevel(logger_level)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        logger.addHandler(fh)
        logger.addHandler(logging.StreamHandler(sys.stdout))
