"""Deformable position-sensitive RoI pooling, DCN v1's deform_pool, in plain
PyTorch (counterpart of ``otpose_tpu/ops/deform_pool.py``).

ref: thirdparty/deform_conv/src/deform_pool_cuda.cpp:6-80 and
deform_pool_cuda_kernel.cu:43-130.  The reference package exports it
(thirdparty/deform_conv/__init__.py:2) and OTPose does not call it.

Per (roi, output channel, ph, pw) bin the output is the mean of
``sample_per_part``^2 bilinear samples of the position-sensitive channel
``(ctop * group_size + gh) * group_size + gw``, the bin moved by the part's
learned offset times ``trans_std`` unless ``no_trans``; samples outside
[-0.5, size - 0.5] are skipped and in-range coordinates clamp to
[0, size - 1].
"""

from __future__ import annotations

import torch


def deform_psroi_pool(x, rois, trans, *, spatial_scale: float, out_size: int,
                      output_dim: int, group_size: int = 1, part_size: int | None = None,
                      sample_per_part: int = 4, trans_std: float = 0.0, no_trans: bool = True):
    """x: (B, C, H, W) with C = output_dim * group_size^2; rois: (N, 5)
    [batch index, x1, y1, x2, y2]; trans: (N, 2 * num_classes, part, part)
    offsets or None.  Returns (top, top_count), each (N, output_dim,
    out_size, out_size): the pooled values and the number of samples each
    bin took."""
    part_size = part_size or out_size
    b, c, h, w = x.shape
    n = rois.shape[0]
    ps = out_size
    dev = x.device
    rois = rois.float()

    batch_ind = rois[:, 0].long()
    start_w = torch.round(rois[:, 1]) * spatial_scale - 0.5
    start_h = torch.round(rois[:, 2]) * spatial_scale - 0.5
    end_w = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    end_h = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp(end_w - start_w, min=0.1)
    roi_h = torch.clamp(end_h - start_h, min=0.1)
    bin_w, bin_h = roi_w / ps, roi_h / ps
    sub_w, sub_h = bin_w / sample_per_part, bin_h / sample_per_part

    p = torch.arange(ps, device=dev)
    part = torch.floor(p.float() / ps * part_size).long()                      # (ps,)
    g = torch.clamp(torch.floor(p.float() * group_size / ps).long(), 0, group_size - 1)

    ctop = torch.arange(output_dim, device=dev)
    if no_trans or trans is None:
        trans_x = torch.zeros(n, output_dim, ps, ps, device=dev)
        trans_y = torch.zeros(n, output_dim, ps, ps, device=dev)
    else:
        channels_each = output_dim // (trans.shape[1] // 2)
        class_id = ctop // channels_each                                     # (O,)
        pick = lambda t: t[:, class_id][:, :, part][:, :, :, part]  # noqa: E731
        trans_x = pick(trans[:, 0::2].float()) * trans_std
        trans_y = pick(trans[:, 1::2].float()) * trans_std

    r = lambda v: v[:, None, None, None]  # noqa: E731
    wstart = p.float()[None, None, None, :] * r(bin_w) + r(start_w) + trans_x * r(roi_w)
    hstart = p.float()[None, None, :, None] * r(bin_h) + r(start_h) + trans_y * r(roi_h)
    chan = (ctop[:, None, None] * group_size + g[None, :, None]) * group_size + g[None, None, :]

    s = torch.arange(sample_per_part, device=dev).float()
    r6 = lambda v: v[:, None, None, None, None, None]  # noqa: E731
    sw = wstart[..., None, None] + s[None, None, None, None, None, :] * r6(sub_w)
    sh = hstart[..., None, None] + s[None, None, None, None, :, None] * r6(sub_h)
    valid = (sw >= -0.5) & (sw <= w - 0.5) & (sh >= -0.5) & (sh <= h - 0.5)
    swc, shc = sw.clamp(0.0, w - 1.0), sh.clamp(0.0, h - 1.0)

    flat = x[batch_ind].float().reshape(n, c * h * w)
    x0, y0 = torch.floor(swc).long(), torch.floor(shc).long()
    lx, ly = swc - x0, shc - y0
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    chan_b = chan[None, ..., None, None].expand(sw.shape)

    def gather(yy, xx):
        idx = chan_b * (h * w) + yy * w + xx
        return torch.gather(flat, 1, idx.reshape(n, -1)).reshape(idx.shape)

    val = ((gather(y0, x0) * (1 - lx) + gather(y0, x1) * lx) * (1 - ly)
           + (gather(y1, x0) * (1 - lx) + gather(y1, x1) * lx) * ly)
    val = torch.where(valid, val, 0.0)
    count = valid.sum(dim=(-2, -1))
    total = val.sum(dim=(-2, -1))
    out = torch.where(count > 0, total / torch.clamp(count, min=1), 0.0)
    return out, count


# the reference's functional name (thirdparty/deform_conv/functions/deform_pool.py)
deform_roi_pooling = deform_psroi_pool
