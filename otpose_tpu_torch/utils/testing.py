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


def dcn_case(b, c, o, h, w, dilations, dtype, gen, device="cuda", reach: int = 3):
    """Inputs of the DCN at calibrated offsets: (x, offsets, masks, weights,
    biases, dilations).  Each offset is an integer in [-reach, reach] plus a
    fraction in [0.05, 0.95], so samples land near their taps (most inside
    the image) and away from integer positions, where the tent function's
    derivative and the bilinear corners' differ.  Weights (D, O, C, 3, 3)
    and biases (D, O) are f32, the maps ``dtype``."""
    import torch

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=device) * scale

    def offsets():
        whole = torch.randint(-reach, reach + 1, (b, 18 * c, h, w), generator=gen, device=device)
        frac = 0.05 + 0.9 * torch.rand(b, 18 * c, h, w, generator=gen, device=device)
        return (whole + frac).to(dtype)

    d = len(dilations)
    return (r(b, c, h, w).to(dtype), [offsets() for _ in range(d)],
            [r(b, 9 * c, h, w).to(dtype) for _ in range(d)],
            r(d, o, c, 3, 3, scale=1 / (9 * c) ** 0.5), r(d, o, scale=0.1), tuple(dilations))


def dcn_inside_share(args) -> float:
    """The share of the DCN's samples that fall inside (-1, H) x (-1, W)."""
    import torch

    x, offs, _, _, _, dilations = args
    b, c, h, w = x.shape
    py = torch.arange(h, device=x.device, dtype=torch.float32)[:, None]
    px = torch.arange(w, device=x.device, dtype=torch.float32)[None, :]
    inside = total = 0
    for off, dil in zip(offs, dilations):
        off = off.float().reshape(b, c, 9, 2, h, w)
        for k in range(9):
            sy = py + ((k // 3) * dil - dil) + off[:, :, k, 0]
            sx = px + ((k % 3) * dil - dil) + off[:, :, k, 1]
            inside += int(((sy > -1) & (sy < h) & (sx > -1) & (sx < w)).sum())
            total += sy.numel()
    return inside / total


def dcn_gradients(fn, args, g):
    """The gradients of ``fn(*args)`` against ``g`` with respect to x, each
    offset map, each mask map, the weights and the biases, in that order."""
    x, offs, masks, weights, biases, dilations = args
    leaves = [t.detach().clone().requires_grad_() for t in (x, *offs, *masks, weights, biases)]
    d = len(dilations)
    out = fn(leaves[0], leaves[1:1 + d], leaves[1 + d:1 + 2 * d], leaves[-2], leaves[-1],
             dilations)
    out.backward(g)
    return [t.grad for t in leaves]


def condition_for_gradients_(model, x, margin) -> None:
    """Make ``model`` (random O(1) weights, dropout rates at 0) a fixture on
    which two f32 train-mode gradients can be compared tensor by tensor, in
    place, on the clip ``x`` (B, H, W, 15) with ``margin``:

    - every BN bias is raised by 3, so the ReLU after it sees inputs ~3
      deviations above its kink.  At biases near 0 about one element in
      1e5 sits within f32 rounding of the kink; its ReLU mask then differs
      between two f32 runs (and from f64), and on the tiny spec one such
      element moves a tensor's gradient by percents of its peak in the
      encoders and the refinement, whose gradients are small sums;
    - HRNet's final conv is rescaled so that in train mode the rough
      heatmaps have mean 0 in each joint and a deviation of 0.05: the
      occlusion target ``(target + total_b * squeezed) / 2`` and the losses
      then stay O(1)."""
    import torch

    from otpose_tpu_torch.models.core import BatchNorm
    from otpose_tpu_torch.models.otpose import otpose_forward

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    training = model.training
    with torch.no_grad():
        for m in bns:
            m.bias.add_(3.0)
        model.train()
        rough = otpose_forward(model, x, margin)[1].float()        # (5B, h, w, J)
        mean = rough.mean(dim=(0, 1, 2))
        scale = 0.05 / (rough - mean).std().item()
        final = model.rough_pose_estimation_net.final_layer
        final.weight.mul_(scale)
        final.bias.sub_(mean.to(final.bias)).mul_(scale)
    for m in bns:
        m.pending = None
    model.train(training)


def loss_gradients(model, batch, dtype=None):
    """(loss, metrics, {name: gradient}) of one train-mode forward and
    backward of ``engine/trainer.py::compute_losses`` on a copy of
    ``model`` (dropout as the model's rates say), with the model and
    ``batch`` cast to ``dtype`` (None: as they are).  In f64 every sum of
    the port stays f64 (its norm statistics and the DCN's sums are
    otherwise f32, through ``Tensor.float``): the exact-arithmetic witness
    on the CPU."""
    import copy

    import torch

    from otpose_tpu_torch.engine.trainer import compute_losses

    model = copy.deepcopy(model).train()
    if dtype is not None:
        model = model.to(dtype)
        batch = {k: v.to(dtype) for k, v in batch.items()}
    dtype = next(model.parameters()).dtype
    float32 = torch.Tensor.float
    if dtype == torch.float64:
        torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else float32(t)
    try:
        total, metrics, _ = compute_losses(model, batch, compute_dtype=dtype)
        total.backward()
    finally:
        torch.Tensor.float = float32
    return float(total.detach()), metrics, {n: p.grad for n, p in model.named_parameters()}
