"""Flagship and tiny model configs (the port's copy of the JAX package's)."""

from __future__ import annotations

from otpose_tpu_torch.config import get_cfg


def flagship_otpose_cfg():
    """Full OTPose/HRNet-W48 config at PoseTrack geometry
    (ref: configs/Base_PoseTrack17.yaml:37-43, configs/17/model_RSN.yaml)."""
    cfg = get_cfg()
    cfg.MODEL.NAME = "OTPose"
    cfg.MODEL.NUM_JOINTS = 17
    cfg.MODEL.IMAGE_SIZE = [288, 384]
    cfg.MODEL.HEATMAP_SIZE = [72, 96]
    cfg.MODEL.SIGMA = 3
    cfg.MODEL.DEFORMABLE_CONV_CH = 32
    cfg.MODEL.OFFSET_MASK_COMBINE_CONV = 2
    cfg.MODEL.DEFORMABLE_CONV.DILATION = [3, 6, 9, 12, 15]
    cfg.MODEL.DEFORMABLE_CONV.AGGREGATION_TYPE = "weighted_sum"
    cfg.MODEL.EXTRA.FINAL_CONV_KERNEL = 1
    cfg.MODEL.EXTRA.PRETRAINED_LAYERS = ["*"]
    for name, branches, mods in (("STAGE2", 2, 1), ("STAGE3", 3, 4), ("STAGE4", 4, 3)):
        cfg.MODEL.EXTRA[name] = {
            "NUM_MODULES": mods,
            "NUM_BRANCHES": branches,
            "BLOCK": "BASIC",
            "NUM_BLOCKS": [4] * branches,
            "NUM_CHANNELS": [48 * (2 ** i) for i in range(branches)],
            "FUSE_METHOD": "SUM",
        }
    return cfg


def tiny_otpose_cfg(image_size=64, heatmap_size=16, width0=8, num_joints=17):
    """A miniature OTPose config (same topology, small channels/resolution)."""
    cfg = get_cfg()
    cfg.MODEL.NAME = "OTPose"
    cfg.MODEL.NUM_JOINTS = num_joints
    cfg.MODEL.IMAGE_SIZE = [image_size, image_size]
    cfg.MODEL.HEATMAP_SIZE = [heatmap_size, heatmap_size]
    cfg.MODEL.SIGMA = 2
    cfg.MODEL.DEFORMABLE_CONV_CH = 16
    cfg.MODEL.OFFSET_MASK_COMBINE_CONV = 1
    cfg.MODEL.DEFORMABLE_CONV.DILATION = [3, 6]
    cfg.MODEL.DEFORMABLE_CONV.AGGREGATION_TYPE = "weighted_sum"
    cfg.MODEL.EXTRA.FINAL_CONV_KERNEL = 1
    cfg.MODEL.EXTRA.PRETRAINED_LAYERS = ["*"]
    cfg.MODEL.EXTRA.SCALE_ARCH = [0, 2, 1]
    cfg.MODEL.EXTRA.FLOW_SCALE_ARCH = [0, 2, 0]
    for name, branches in (("STAGE2", 2), ("STAGE3", 3), ("STAGE4", 4)):
        cfg.MODEL.EXTRA[name] = {
            "NUM_MODULES": 1,
            "NUM_BRANCHES": branches,
            "BLOCK": "BASIC",
            "NUM_BLOCKS": [1] * branches,
            "NUM_CHANNELS": [width0 * (2 ** i) for i in range(branches)],
            "FUSE_METHOD": "SUM",
        }
    cfg.TRAIN.LR = 1e-4
    cfg.TRAIN.WARMUP_EPOCHS = 1
    cfg.TRAIN.END_EPOCH = 2
    return cfg
