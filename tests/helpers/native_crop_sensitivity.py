"""How far the port's native crop moves the train CLI's first loss, against
half a uint8 step of noise on the cv2 crop.

    JAX_PLATFORMS=cpu python -m tests.helpers.native_crop_sensitivity

builds ``tests/test_torch_train_cli.py::test_both_train_clis_agree_for_one_epoch``'s
set-up in a temporary directory (the synthetic jpg tree, the tiny spec with
the test's numpy weights, dropout off, the first shuffled batch of 8), takes
that batch through the host ``Loader`` with the native library and without
it, and prints: the largest gap between the two crops in uint8 steps and
between their targets; the first step's metrics (``compute_losses`` in train
mode) on each batch and on the cv2 batch plus three draws of uniform noise
of half a uint8 step; and each forward output's RMS change between the two
batches, relative to its RMS.  The tree, the config and the weights are the
test's own (``tests/helpers/train_cli_parity.py``); the JAX package gives
the weights' key set and shapes only.
"""

import copy
import tempfile
from pathlib import Path

import numpy as np
import torch

from otpose_tpu_torch.config import default_parse_args, setup
from otpose_tpu_torch.data.loader import Loader
from otpose_tpu_torch.data.posetrack import PoseTrackDataset
from otpose_tpu_torch.engine.trainer import compute_losses
from otpose_tpu_torch.models.blocks import set_drop_rates
from otpose_tpu_torch.models.otpose import otpose_forward
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.train_cli_parity import fill_cfg, parity_tree, parity_weights

STD = np.array([0.229, 0.224, 0.225], np.float32)
OUTPUTS = ("output", "rough", "intersection", "prev_b", "context_encoding", "sq", "tb")


def _dataset(root: Path):
    """The port's train split as the slow test's train CLI reads it."""
    yaml = fill_cfg(tiny_otpose_cfg(), root, parity_tree(root), "", "torch_cli", 8)
    cfg = setup(default_parse_args(["--cfg", yaml, "--root_dir", str(root), "--device", "cpu"]))
    return cfg, PoseTrackDataset(cfg, "train")


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def main() -> None:
    torch.manual_seed(0)
    model = set_drop_rates(parity_weights()[2]).train()
    with tempfile.TemporaryDirectory() as tmp:
        cfg, ds = _dataset(Path(tmp))
        batches = {}
        for name, native in (("native", True), ("cv2", False)):
            loader = Loader(ds, 8, shuffle=True, drop_last=True, num_workers=1, seed=cfg.SEED,
                            native_host=native)
            assert loader.host_warp == ("native" if native else "warp_frame")
            batches[name] = next(iter(loader))[0]
    a, b = batches["native"], batches["cv2"]
    gap = np.abs(a["inputs"] - b["inputs"]).reshape(*a["inputs"].shape[:-1], 5, 3) * 255 * STD
    print(f"crops: the largest gap {gap.max():.4f} of a uint8 step; targets: "
          f"{np.abs(a['target'] - b['target']).max():.3e}")

    def metrics(batch, tag):
        with torch.no_grad():
            _, m, _ = compute_losses(copy.deepcopy(model), _tensors(batch))
        print(f"{tag}: " + ", ".join(f"{k} {float(v):.5f}" for k, v in m.items()))
        return float(m["final_loss"])

    base = metrics(b, "cv2")
    print(f"native: first loss {metrics(a, 'native') / base - 1:+.4%} from cv2's")
    rng = np.random.RandomState(0)
    for i in range(3):
        noise = rng.uniform(-0.5, 0.5, b["inputs"].shape) / (255 * np.tile(STD, 5))
        loss = metrics(dict(b, inputs=(b["inputs"] + noise).astype(np.float32)),
                       f"cv2 + half a uint8 step of noise, draw {i}")
        print(f"  first loss {loss / base - 1:+.4%} from cv2's")
    outs = {}
    for name, batch in batches.items():
        with torch.no_grad():
            t = _tensors(batch)
            outs[name] = otpose_forward(copy.deepcopy(model), t["inputs"], t["margin"])
    for name, x, y in zip(OUTPUTS, outs["native"], outs["cv2"]):
        rms = float(y.pow(2).mean().sqrt())
        print(f"{name}: RMS {rms:.4f}, native - cv2 RMS {float((x - y).pow(2).mean().sqrt()) / rms:.2%}"
              f" of it")


if __name__ == "__main__":
    main()
