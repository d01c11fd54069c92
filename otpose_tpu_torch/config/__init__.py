"""Config system: defaults schema + YAML/_BASE_/opts loading + CLI args.

Public surface matches the reference contract (ref: utils/setup.py:72-118,
configs/arg_parse.py:5-47): ``get_cfg()``, ``update_config(cfg, args)``,
``setup(args)``, ``default_parse_args()``, ``get_dataset_name(cfg)``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

from otpose_tpu_torch.config.defaults import get_cfg
from otpose_tpu_torch.config.node import CfgNode

__all__ = [
    "CfgNode",
    "get_cfg",
    "update_config",
    "setup",
    "default_parse_args",
    "get_dataset_name",
]


def update_config(cfg: CfgNode, args) -> None:
    """Merge the YAML file + CLI opts and root all paths (ref: utils/setup.py:72-94)."""
    cfg.merge_from_file(args.cfg)
    cfg.merge_from_list(list(getattr(args, "opts", []) or []))

    root = getattr(args, "rootDir", "") or getattr(args, "root_dir", "")
    if root:
        cfg.ROOT_DIR = root

    def _root(p: str) -> str:
        if not p:
            return p
        return os.path.abspath(os.path.join(cfg.ROOT_DIR, p))

    cfg.OUTPUT_DIR = _root(cfg.OUTPUT_DIR)
    cfg.DATASET.JSON_DIR = _root(cfg.DATASET.JSON_DIR)
    cfg.DATASET.IMG_DIR = _root(cfg.DATASET.IMG_DIR)
    cfg.DATASET.TEST_IMG_DIR = _root(cfg.DATASET.TEST_IMG_DIR)
    cfg.MODEL.PRETRAINED = _root(cfg.MODEL.PRETRAINED)
    cfg.VAL.ANNOT_DIR = _root(cfg.VAL.ANNOT_DIR)
    cfg.VAL.COCO_BBOX_FILE = _root(cfg.VAL.COCO_BBOX_FILE)
    cfg.TEST.ANNOT_DIR = _root(cfg.TEST.ANNOT_DIR)
    cfg.TEST.COCO_BBOX_FILE = _root(cfg.TEST.COCO_BBOX_FILE)


def setup(args) -> CfgNode:
    """Build the merged config for a run (ref: utils/setup.py:109-118)."""
    cfg = get_cfg()
    update_config(cfg, args)
    return cfg


def get_dataset_name(cfg: CfgNode) -> str:
    """'PoseTrack' -> 'PoseTrack17'/'PoseTrack18' (ref: utils/setup.py:123-129)."""
    name = cfg.DATASET.NAME
    if name == "PoseTrack":
        name = name + ("18" if cfg.DATASET.IS_2018 else "17")
    return name


def default_parse_args(argv=None):
    """CLI surface of the reference entry points (ref: configs/arg_parse.py:5-47)."""
    parser = argparse.ArgumentParser(description="Train keypoints network")
    parser.add_argument("--cfg", type=str, default="./configs/17/model_RSN.yaml",
                        help="experiment configure file name")
    parser.add_argument("--PE_Name", type=str, default="OTPose")
    parser.add_argument("--train", action="store_true", default=True)
    parser.add_argument("--val", action="store_true", default=False)
    parser.add_argument("--val_from_checkpoint", type=int, default=-1,
                        help="exec val from the checkpoint_id; ignored when the "
                             "config specifies a model file")
    parser.add_argument("--sigma_schedule", type=int, nargs="+", default=[],
                        help="decrease target sigma at these epochs")
    parser.add_argument("--test", action="store_true", default=False)
    parser.add_argument("--root_dir", type=str, default="./")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default; raises without a GPU) or cpu")
    parser.add_argument("opts", help="modify config options from the command line",
                        default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    args.rootDir = osp.abspath(args.root_dir)
    if not osp.isabs(args.cfg):
        args.cfg = osp.abspath(args.cfg)
    args.PE_Name = args.PE_Name.upper()
    args.opts = args.opts or []
    return args
