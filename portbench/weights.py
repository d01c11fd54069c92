"""The benchmark's weights and inputs, made on the device from the seed.

The weights are drawn in one call of a ``torch.Generator`` on the device
into the reference model (``reference/model.py``), then calibrated by one
float32 reference forward over two clips drawn from the same seed (see that
module): so the heatmaps have peaks and the deformable conv samples inside
the image.  Both sides get that state: the program by ``load_state_dict``,
the reference as it is.

Clips are N(0, 1) frames and margins 0-2, as ``chip_smoke.py`` draws them;
train targets are Gaussians (peak 1.0 at the truncated grid position of a
joint drawn inside the image, a 3-sigma window) with the first 60% of the
joints labelled in every clip, as ``chip_smoke.py::synthetic_train_batch``
makes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import model as ref_model
from portbench.reference import ops

CALIBRATION_CLIPS = 2
# BN biases sit 3 deviations above the ReLU's kink (as
# ``otpose_tpu_torch/utils/testing.py::condition_for_gradients_`` raises
# them): at O(1) biases BN and ReLU chains of random weights amplify a
# perturbation layer after layer, and HRNet's heatmaps in bf16 differ from
# float32 by more than their own deviation
BN_BIAS = 3.0


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the part ``tag`` of a run with ``seed``."""
    words = [seed % 2 ** 64 >> 32, seed % 2 ** 32] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _owner_kind(model, name: str) -> str:
    owner = model.get_submodule(name.rsplit(".", 1)[0])
    return type(owner).__name__


@torch.no_grad()
def make_reference(cfg: dict, seed: int, device, center: bool = False) -> ref_model.OTPose:
    """The calibrated float32 reference model of ``cfg`` for ``seed``, in
    eval mode on ``device``: convolution and dense weights N(0, 1 / fan_in),
    biases N(0, 0.01) (BN biases N(3, 0.01)), norm weights 1, block scales
    1 + N(0, 0.01), then ``reference.model.forward(calibrate=True,
    center=center)``: the decoded eval cells center each joint's heatmaps,
    the train cell keeps their offsets."""
    with torch.device(device):
        model = ref_model.OTPose(ref_model.Spec.from_config(cfg))
    params = list(model.named_parameters())
    noise = torch.randn(sum(p.numel() for _, p in params), generator=generator(seed, "weights",
                                                                              device),
                        device=device)
    at = 0
    for name, p in params:
        n = noise[at:at + p.numel()].view_as(p)
        at += p.numel()
        kind = _owner_kind(model, name)
        if kind in ("BatchNorm", "LayerNormCT") and name.endswith("weight"):
            p.fill_(1.0)
        elif kind == "AffineScale":
            p.copy_(1.0 + 0.1 * n)
        elif kind == "BatchNorm":
            p.copy_(BN_BIAS + 0.1 * n)
        elif name.endswith("bias"):
            p.copy_(0.1 * n)
        else:
            p.copy_(n / math.sqrt(p[0].numel()))
    gen = generator(seed, "calibration", device)
    spec = model.spec
    h, w = spec.pe_h * 4, spec.pe_w * 4
    x = torch.randn(CALIBRATION_CLIPS, h, w, 15, generator=gen, device=device)
    model.eval()
    with ops.exact_f32():
        ref_model.forward(model, x, torch.ones(CALIBRATION_CLIPS, 4, device=device),
                          calibrate=True, center=center)
    return model


def clips(cfg: dict, batch: int, gen: torch.Generator, device):
    """(inputs (B, H, W, 15), margin (B, 4)) on ``device``."""
    w, h = cfg["MODEL"]["IMAGE_SIZE"]
    inputs = torch.randn(batch, h, w, 15, generator=gen, device=device)
    margin = torch.randint(0, 3, (batch, 4), generator=gen, device=device).float()
    return inputs, margin


def targets(cfg: dict, batch: int, labelled: float, gen: torch.Generator, device):
    """(target (B, Hh, Hw, J), target_weight (B, J, 1)): a Gaussian of the
    configuration's sigma at a joint drawn uniformly 8 pixels inside the
    image, for the first ``int(J * labelled)`` joints; none elsewhere."""
    m = cfg["MODEL"]
    j, sigma = m["NUM_JOINTS"], m["SIGMA"]
    (w, h), (hw, hh) = m["IMAGE_SIZE"], m["HEATMAP_SIZE"]
    u = torch.rand(batch, j, 2, generator=gen, device=device, dtype=torch.float64)
    jx = 8 + u[..., 0] * (w - 16)
    jy = 8 + u[..., 1] * (h - 16)
    mu_x = torch.trunc(jx / (w / hw) + 0.5)
    mu_y = torch.trunc(jy / (h / hh) + 0.5)
    xs = torch.arange(hw, device=device, dtype=torch.float32)
    ys = torch.arange(hh, device=device, dtype=torch.float32)
    dx = xs[None, None, None, :] - mu_x.float()[..., None, None]
    dy = ys[None, None, :, None] - mu_y.float()[..., None, None]
    g = torch.exp(-(dx ** 2 + dy ** 2) / (2 * sigma ** 2))
    tmp = sigma * 3
    vis = torch.zeros(batch, j, device=device)
    vis[:, :int(j * labelled)] = 1.0
    keep = (dx.abs() <= tmp) & (dy.abs() <= tmp) & (vis[..., None, None] > 0.5)
    target = torch.where(keep, g, 0.0)
    return target.permute(0, 2, 3, 1).contiguous(), vis[..., None]
