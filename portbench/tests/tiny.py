"""A miniature configuration and traffic for CPU runs of the harness: the
flagship's topology at 64 x 64 input, 16 x 16 heatmaps and 8-channel
HRNet."""

from __future__ import annotations

import copy
import json

from portbench import harness

TINY_MODEL = {
    "NUM_JOINTS": 17, "IMAGE_SIZE": [64, 64], "HEATMAP_SIZE": [16, 16], "SIGMA": 2,
    "DEFORMABLE_CONV_CH": 16, "OFFSET_MASK_COMBINE_CONV": 1,
    "DEFORMABLE_CONV": {"DILATION": [3, 6], "AGGREGATION_TYPE": "weighted_sum"},
}


def tiny_config(joints: int = 17) -> dict:
    config = harness.load_json(harness.PACKAGE / "configs" / "otpose_w48_posetrack.json")
    cfg = config["cfg"]
    cfg["MODEL"].update(copy.deepcopy(TINY_MODEL), NUM_JOINTS=joints)
    extra = cfg["MODEL"]["EXTRA"]
    extra.update(SCALE_ARCH=[0, 2, 1], FLOW_SCALE_ARCH=[0, 2, 0])
    for name, branches in (("STAGE2", 2), ("STAGE3", 3), ("STAGE4", 4)):
        extra[name] = {"NUM_MODULES": 1, "NUM_BRANCHES": branches, "BLOCK": "BASIC",
                       "NUM_BLOCKS": [1] * branches,
                       "NUM_CHANNELS": [8 * 2 ** i for i in range(branches)],
                       "FUSE_METHOD": "SUM"}
    cfg["PRINT_FREQ"] = 2
    return config


def tiny_files(workload: str, **traffic) -> dict:
    """The files of ``workload`` with the tiny configuration and a small
    batch, as ``harness.cell_files`` gives them."""
    files = harness.cell_files(harness.load_json(harness.SPEC), workload)
    joints = files["config"]["cfg"]["MODEL"]["NUM_JOINTS"]
    files["config"] = tiny_config(min(joints, 21))
    files["traffic"] = dict(files["traffic"], batch=2, ring=2, warmup=1, trace_batches=2,
                            trace_steps=1, reference_rows=1, **traffic)
    return json.loads(json.dumps(files))
