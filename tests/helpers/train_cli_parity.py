"""The set-up that ``tests/test_torch_train_cli.py``'s train-CLI tests and
``tests/helpers/native_crop_sensitivity.py`` share: the config a run reads,
the two-video tree of the CLI parity test and its weights."""

import numpy as np

from otpose_tpu_torch.models.factory import build_model
from otpose_tpu_torch.models.jax_bridge import load_jax_weights
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.synthetic_data import make_synthetic_posetrack


def fill_cfg(cfg, root, dirs, pth, name, batch):
    """``cfg`` pointed at the synthetic tree ``dirs`` and the weights ``pth``,
    f32, no warm-up or half-body crops, written to ``root/name.yaml``; the
    yaml's path."""
    json_dir, img_dir, annot_dir = dirs
    cfg.EXPERIMENT_NAME = name
    cfg.OUTPUT_DIR = str(root / "output")
    cfg.DATASET.NAME = "PoseTrack"
    cfg.DATASET.JSON_DIR = json_dir
    cfg.DATASET.IMG_DIR = img_dir
    cfg.DATASET.TEST_IMG_DIR = img_dir
    cfg.DATASET.COLOR_RGB = True
    cfg.MODEL.PRETRAINED = pth
    cfg.VAL.ANNOT_DIR = annot_dir
    cfg.VAL.USE_GT_BBOX = True
    cfg.VAL.BATCH_SIZE_PER_GPU = 4
    cfg.TRAIN.BATCH_SIZE_PER_GPU = batch
    cfg.TRAIN.SAVE_MODEL_PER_EPOCH = 1
    cfg.TRAIN.PROB_HALF_BODY = 0.0
    cfg.TRAIN.WARMUP = False
    cfg.WORKERS = 2
    cfg.PRINT_FREQ = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    path = root / f"{name}.yaml"
    path.write_text(cfg.dump())
    return str(path)


def parity_tree(root):
    """Two videos of four 96 x 96 jpg frames, two people a frame:
    ``(json_dir, img_dir, annot_dir)``."""
    return make_synthetic_posetrack(str(root), num_videos=2, frames_per_video=4,
                                    people_per_frame=2, img_w=96, img_h=96)


def parity_weights():
    """numpy values with JAX init's keys, HRNet's final conv scaled so the
    losses stay O(1), the offset and mask convs so the DCN samples near its
    taps (the reference init is no witness: its gradients are f32 residue
    in most tensors, and the two packages' updates there differ in sign).
    Returns ``(params, state, model)``: the JAX-layout arrays and the port's
    tiny model holding them, on the CPU."""
    from otpose_tpu.models.otpose import OTPoseSpec as JaxSpec
    from otpose_tpu.models.otpose import _init_otpose_impl
    from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg

    from tests.helpers.torch_port import numpy_weights

    params, state = numpy_weights(_init_otpose_impl, JaxSpec.from_cfg(jax_tiny_cfg()))
    for name in params:
        if name.endswith(".weight") and name.startswith(("offsets_list", "masks_list")):
            params[name] = params[name] * np.float32(3e-4)
    for k in ("weight", "bias"):
        params[f"rough_pose_estimation_net.final_layer.{k}"] *= np.float32(0.05)
    _, model = build_model(tiny_otpose_cfg(), device="cpu")
    load_jax_weights(model, params, state)
    return params, state, model
