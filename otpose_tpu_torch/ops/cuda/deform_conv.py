"""Multi-dilation modulated deformable conv (counterpart of
``otpose_tpu/ops/deform_conv.py::modulated_deform_conv_multi``).

The mean over D dilations of a 3x3 DCNv2 with padding equal to the
dilation, stride 1 and one channel per deformable group (the OTPose
refinement, ref: model/OTPose.py:381-394).  Layouts are NCHW: offsets
(B, 2*9*C, H, W) in (group, tap, y/x) channel order, raw masks
(B, 9*C, H, W), weights (D, O, C, 3, 3), biases (D, O).  Sample positions,
bilinear weights and sums are f32 whatever the input dtype; the result is
rounded once to ``x.dtype``.

The wrapper calls the registered op ``otpose::deform_conv``: on a CUDA
tensor it launches ``csrc/deform_conv.cu`` in its exact mode, on a CPU
tensor it runs ``modulated_deform_conv_multi_plain``, the same function in
plain PyTorch.  The same kernel, in its other mode, serves
``deform_conv_fused.deform_conv_fused`` through ``launch``.  The op's
registered autograd calls ``otpose::deform_conv_bwd``, which on a CUDA
tensor launches ``csrc/deform_conv_bwd.cu`` (every gradient: x, offsets,
masks, weights, biases) and on a CPU tensor runs the plain version's
autograd.  The launch counts are kept inside the ops' CUDA implementations,
so an exported program that calls an op counts each launch.

``pack_dcn_weights`` puts the weights in the kernel's layout once
(``models/otpose.py::dcn_pack`` caches the result on the model); the
wrappers take either the raw weights, which they pack on every call, or
such a pack.

Any O and any D run on the card, through the kernels only.  Past 32
outputs both kernels take their wide paths (``otp_deform_wide`` and the
backward's ``dcn_bwd_wide_kernel``), which sample once for every output and
contract over O on the tensor cores in split TF32, in ``product_cols(O)``
columns (O rounded up to 16: 144 at 133 joints); the forward takes
``WIDE_COLS`` columns a launch, the backward at most ``MAX_BWD_OUTPUTS``
outputs a pass (past them a pass a range of outputs, ``backward_ranges``).
D above ``MAX_DILATIONS`` (``WIDE_DILATIONS`` on the wide paths) is a group
of launches, that many dilations each.  The counters
``deform_conv.launches`` / ``deform_conv.bwd_launches`` (``utils/profiling.py``)
count each launch of the main kernel (``kernel_launches``,
``backward_launches``): one a call at the flagship's O = 17, D = 5 and at
133 joints.  The make_pallas3 mode (``deform_conv_fused``) keeps a launch a
group of 32 outputs.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass

import torch

from otpose_tpu_torch.ops.cuda import build
from otpose_tpu_torch.utils import profiling


EXACT, PALLAS3 = 0, 1          # the kernel's rounding modes
OUTPUT_PADS = (8, 20, 32)      # O is zero-padded to the first of these that holds it,
OUTPUT_GROUP = 32              # and above 32 to a multiple of 32 (make_pallas3's groups)
PRODUCT_TILE = 16              # the wide paths' product columns: O rounded up to this
WIDE_COLS = 144                # product columns a wide forward launch (one m64n144k8 product)
MAX_BWD_OUTPUTS = 288          # the most outputs a backward pass takes (its d W accumulators)
MAX_DILATIONS = 8              # dilations a launch (the kernels' kMaxD)
WIDE_DILATIONS = 5             # dilations a launch on the wide paths (their kWideMaxD)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "otp_deform": (_I, [_P, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I),
                        _P, _P, _P, _P] + [_I] * 11 + [_P]),
    "otp_deform_max_groups": (_I, []),
    "otp_deform_tile": (_I, [_I]),
    "otp_deform_wide": (_I, [_P, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I),
                             _P, _P, _P, _P] + [_I] * 9 + [_P]),
    "otp_deform_wide_scratch": (ctypes.c_longlong, [_I] * 8),
    "otp_deform_wide_cols": (_I, []),
    "otp_deform_wide_dilations": (_I, []),
}
_BWD_SIGNATURES = {
    "otp_deform_bwd": (_I, [_P, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I)]
                       + [_P] * 8 + [_I] * 9 + [_P]),
    "otp_deform_bwd_scratch": (ctypes.c_longlong, [_I] * 9),
    "otp_deform_bwd_max_outputs": (_I, []),
    "otp_deform_bwd_wide_dilations": (_I, []),
}


@dataclass(frozen=True)
class DcnPack:
    """The DCN weights in the kernel's layout: ``w`` (D, C, 9, OP) f32 with
    row c * 9 + k the weights of group c, tap k = 3 * ky + kx (the mask
    channel order), zero past O (``output_pad``); ``bias`` (OP,) f32, the
    mean over D of the biases, zero past O."""
    d: int
    c: int
    o: int
    w: torch.Tensor
    bias: torch.Tensor


def output_pad(o: int) -> int:
    """OP, the pack's O: the first of ``OUTPUT_PADS`` that holds ``o``, above
    32 ``o`` rounded up to a multiple of ``OUTPUT_GROUP`` (the make_pallas3
    mode's groups of 32; the exact mode's wide paths read the first
    ``product_cols(o)`` of them)."""
    if o > OUTPUT_PADS[-1]:
        return -(-o // OUTPUT_GROUP) * OUTPUT_GROUP
    return next(p for p in OUTPUT_PADS if p >= o)


def product_cols(o: int) -> int:
    """The wide paths' product columns past 32 outputs: ``o`` rounded up to
    ``PRODUCT_TILE`` (two n8 tiles; 144 at 133 and 136)."""
    return -(-o // PRODUCT_TILE) * PRODUCT_TILE


def kernel_launches(d: int, o: int, mode: int = EXACT) -> int:
    """Launches of the forward's main kernel a call makes at D dilations and
    O outputs: a launch a group of ``MAX_DILATIONS`` dilations and of 32
    outputs of the pack in the make_pallas3 mode; on the exact mode's wide
    path (past 32) a group of ``WIDE_DILATIONS`` dilations and of
    ``WIDE_COLS`` product columns."""
    if mode == EXACT and o > OUTPUT_PADS[-1]:
        return -(-d // WIDE_DILATIONS) * -(-product_cols(o) // WIDE_COLS)
    return -(-d // MAX_DILATIONS) * max(1, output_pad(o) // OUTPUT_GROUP)


def backward_ranges(o: int) -> list[tuple[int, int]]:
    """The ranges of outputs [o0, o1) the backward takes a pass each: all
    O up to ``MAX_BWD_OUTPUTS``; past them as few ranges as hold O, each of
    the same whole 16-column product tiles but the last (160 and 129 at
    289 outputs)."""
    if o <= MAX_BWD_OUTPUTS:
        return [(0, o)]
    n = -(-o // MAX_BWD_OUTPUTS)
    size = product_cols(-(-o // n))
    return [(o0, min(o, o0 + size)) for o0 in range(0, o, size)]


def backward_launches(d: int, o: int) -> int:
    """Launches of the backward's main kernel a call makes at D dilations
    and O outputs: one a group of ``MAX_DILATIONS`` dilations, of
    ``WIDE_DILATIONS`` past 32 outputs (no O groups), for each of
    ``backward_ranges(O)``."""
    return sum(-(-d // (WIDE_DILATIONS if o1 - o0 > OUTPUT_PADS[-1] else MAX_DILATIONS))
               for o0, o1 in backward_ranges(o))


@torch.no_grad()
def pack_dcn_weights(weights, biases, device=None) -> DcnPack:
    """Weights (D, O, C, 3, 3) and biases (D, O) in the kernel's layout."""
    d, o, c = weights.shape[:3]
    if tuple(weights.shape) != (d, o, c, 3, 3) or tuple(biases.shape) != (d, o):
        raise ValueError("deform conv: weights must be (D, O, C, 3, 3) and biases (D, O)")
    op = output_pad(o)
    device = weights.device if device is None else device
    w = torch.zeros(d, c, 9, op, device=device)
    w[..., :o] = weights.to(device=device, dtype=torch.float32).permute(0, 2, 3, 4, 1).reshape(
        d, c, 9, o)
    bias = torch.zeros(op, device=device)
    bias[:o] = biases.to(device=device, dtype=torch.float32).mean(0)
    profiling.count("deform_conv.packs")
    return DcnPack(d, c, o, w, bias)


def unpack(pk: DcnPack):
    """(weights (D, O, C, 3, 3), biases (1, O)) with the pack's values: the
    plain versions' arguments (the mean over one row of biases is the row)."""
    w = pk.w[..., :pk.o].reshape(pk.d, pk.c, 3, 3, pk.o).permute(0, 4, 1, 2, 3)
    return w, pk.bias[None, :pk.o]


def _bilinear(xf, sy, sx, h: int, w: int):
    """Zero-padded bilinear samples of xf (B, C, H*W) at f32 positions
    (B, C, P); a sample contributes when -1 < y < H and -1 < x < W."""
    valid = (sy > -1) & (sy < h) & (sx > -1) & (sx < w)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    ly, lx = sy - y0, sx - x0
    out = torch.zeros_like(sy)
    for dy, wy in ((0, 1 - ly), (1, ly)):
        for dx, wx in ((0, 1 - lx), (1, lx)):
            yy, xx = y0 + dy, x0 + dx
            ok = valid & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            v = torch.gather(xf, 2, idx)
            out = out + torch.where(ok, wy * wx * v, torch.zeros_like(v))
    return out


def modulated_deform_conv_multi_plain(x, offsets_list, masks_list, weights,
                                      biases, dilations) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    b, c, h, w = x.shape
    p = h * w
    xf = x.float().reshape(b, c, p)
    py = torch.arange(h, device=x.device, dtype=torch.float32)[:, None].expand(h, w).reshape(p)
    px = torch.arange(w, device=x.device, dtype=torch.float32)[None, :].expand(h, w).reshape(p)
    acc = torch.zeros(b, weights.shape[1], p, device=x.device, dtype=torch.float32)
    for off, msk, wd, dil in zip(offsets_list, masks_list, weights, dilations):
        off = off.float().reshape(b, c, 9, 2, p)
        msk = msk.float().reshape(b, c, 9, p)
        wd = wd.float()
        for k in range(9):
            sy = (py + float((k // 3) * dil - dil)) + off[:, :, k, 0]
            sx = (px + float((k % 3) * dil - dil)) + off[:, :, k, 1]
            val = _bilinear(xf, sy, sx, h, w) * msk[:, :, k]
            acc = acc + torch.einsum("oc,bcp->bop", wd[:, :, k // 3, k % 3], val)
    out = acc / len(dilations) + biases.float().mean(0)[:, None]
    return out.reshape(b, -1, h, w).to(x.dtype)


def _check_maps(what: str, x, offsets_list, masks_list, pk: DcnPack, dilations):
    """Raise unless the maps have the layouts above, all contiguous and in
    x's dtype and device, and match the pack's D and C."""
    b, c, h, w = x.shape
    d = len(dilations)
    if (pk.d, pk.c) != (d, c) or pk.w.device != x.device:
        raise ValueError(f"{what}: weights packed for D={pk.d}, C={pk.c} on {pk.w.device}; "
                         f"the call has D={d}, C={c} on {x.device}")
    if len(offsets_list) != d or len(masks_list) != d:
        raise ValueError(f"{what}: one offset and mask map per dilation")
    for t, ch in [(x, c)] + [(t, 18 * c) for t in offsets_list] + [(t, 9 * c) for t in masks_list]:
        if (t.dtype != x.dtype or t.device != x.device or not t.is_contiguous()
                or tuple(t.shape) != (b, ch, h, w)):
            raise ValueError(f"{what}: inputs must be contiguous NCHW tensors of x's dtype "
                             f"and device; got {tuple(t.shape)}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def stage_split(b: int, tiles: int, sms: int, stages: int) -> int:
    """Blocks over which each of the ``b * tiles`` (item, pixel tile) blocks'
    ``stages`` (channel, dilation) stages are split: 1 when those blocks
    give every SM one, else enough for two a SM (B = 1 at the flagship
    shape on 132 SMs: 14 tiles, 19 blocks a tile), at most one a stage."""
    return 1 if tiles * b >= sms else min(stages, -(-2 * sms // (tiles * b)))


def partial_slots(split: int, c: int, d: int) -> int:
    """The f32 partial sums' slots of a forward call split ``split`` ways
    (``stage_split`` over a launch's C * min(D, 8) stages): each group of
    ``MAX_DILATIONS`` dilations takes ``min(split, C * its D)``; 0 where one
    launch of one split writes the output itself."""
    if split == 1 and d <= MAX_DILATIONS:
        return 0
    return sum(min(split, c * min(MAX_DILATIONS, d - d0)) for d0 in range(0, d, MAX_DILATIONS))


def launch(mode: int, what: str, x, offsets_list, masks_list, weights, biases, dilations,
           packed: DcnPack | None) -> torch.Tensor:
    """Run ``csrc/deform_conv.cu`` in ``mode`` (EXACT or PALLAS3) on CUDA
    tensors; raises on what the kernel does not take.  When B x tiles leaves
    SMs without a block (B = 1), the (channel, dilation) stages are split
    (``stage_split``); the blocks write f32 partial sums, which a second
    kernel adds in a fixed order, as it adds the groups of dilations above
    ``MAX_DILATIONS`` (``partial_slots``).  The exact mode past 32 outputs
    is the wide path (``launch_wide``)."""
    code = build.dtype_code(x.dtype)
    if packed is None:
        packed = pack_dcn_weights(weights, biases, device=x.device)
    _check_maps(what, x, offsets_list, masks_list, packed, dilations)
    lib = build.load("deform_conv", _SIGNATURES)
    b, c, h, w = x.shape
    d, o, op = packed.d, packed.o, packed.w.shape[-1]
    if mode == EXACT and op > OUTPUT_PADS[-1]:
        return launch_wide(lib, what, x, offsets_list, masks_list, packed, dilations)
    if lib.otp_deform_max_groups() != MAX_DILATIONS:
        raise RuntimeError(f"{what}: the library takes {lib.otp_deform_max_groups()} "
                           f"dilations a launch, the wrapper groups {MAX_DILATIONS}")
    tiles = -(-h * w // lib.otp_deform_tile(code))
    sms = _sm_count(x.device.index if x.device.index is not None
                    else torch.cuda.current_device())
    split = stage_split(b, tiles, sms, c * min(d, MAX_DILATIONS))
    wide = _wide(x, [x, *offsets_list, *masks_list])
    out = torch.empty(b, o, h, w, device=x.device, dtype=x.dtype)
    slots = partial_slots(split, c, d)
    partial = (torch.empty(slots, b, o, h * w, device=x.device, dtype=torch.float32)
               if slots else None)
    offs = (ctypes.c_void_p * d)(*[t.data_ptr() for t in offsets_list])
    msks = (ctypes.c_void_p * d)(*[t.data_ptr() for t in masks_list])
    dils = (ctypes.c_int * d)(*[int(v) for v in dilations])
    err = lib.otp_deform(
        x.data_ptr(), offs, msks, dils, packed.w.data_ptr(), packed.bias.data_ptr(),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        b, c, o, op, h, w, d, split, mode, int(wide), code,
        build.stream_ptr(x.device))
    build.check(lib, err, what)
    return out


def launch_wide(lib, what: str, x, offsets_list, masks_list, packed: DcnPack,
                dilations) -> torch.Tensor:
    """The exact mode past 32 outputs (``otp_deform_wide``): every output
    from one sampling, its scratch (the weights' split fragments, the
    blocks' partial sums) allocated here at the size the library asks."""
    if (lib.otp_deform_wide_cols(), lib.otp_deform_wide_dilations()) != (WIDE_COLS,
                                                                         WIDE_DILATIONS):
        raise RuntimeError(f"{what}: the library takes {lib.otp_deform_wide_cols()} columns "
                           f"and {lib.otp_deform_wide_dilations()} dilations a launch, the "
                           f"wrapper counts {WIDE_COLS} and {WIDE_DILATIONS}")
    code = build.dtype_code(x.dtype)
    b, c, h, w = x.shape
    d, o, op = packed.d, packed.o, packed.w.shape[-1]
    wide = _wide(x, [x, *offsets_list, *masks_list])
    nbytes = lib.otp_deform_wide_scratch(b, c, o, h, w, d, int(wide), code)
    if nbytes < 0:
        raise ValueError(f"{what}: the wide kernel does not take B={b}, C={c}, O={o}, "
                         f"{h}x{w}, D={d} (scratch query {nbytes})")
    out = torch.empty(b, o, h, w, device=x.device, dtype=x.dtype)
    scratch = torch.empty(nbytes, device=x.device, dtype=torch.uint8)
    offs = (ctypes.c_void_p * d)(*[t.data_ptr() for t in offsets_list])
    msks = (ctypes.c_void_p * d)(*[t.data_ptr() for t in masks_list])
    dils = (ctypes.c_int * d)(*[int(v) for v in dilations])
    err = lib.otp_deform_wide(
        x.data_ptr(), offs, msks, dils, packed.w.data_ptr(), packed.bias.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), b, c, o, op, h, w, d, int(wide), code,
        build.stream_ptr(x.device))
    build.check(lib, err, what)
    return out


def _wide(x, maps) -> bool:
    """Whether 16-byte copies of the offset and mask rows and of the x plane's
    image rows are possible: rows a multiple of 16 bytes, 16-byte aligned."""
    return ((x.shape[-1] * x.element_size()) % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in maps))


def launch_backward(g, x, offsets_list, masks_list, packed: DcnPack, dilations):
    """Run ``csrc/deform_conv_bwd.cu`` on CUDA tensors: the gradients of the
    exact mode's output with respect to x, the offset maps, the mask maps,
    the weights (D, O, C, 3, 3) and the biases (D, O), from the output's
    gradient ``g`` (B, O, H, W), in ``backward_launches(D, O)`` launches of
    the main kernel (past 32 outputs the wide one; past
    ``MAX_BWD_OUTPUTS`` outputs a pass a range, ``backward_by_ranges``).
    d x, d W and d bias are computed in f32;
    d x is returned in x's dtype, the D offset and mask gradients stacked as
    (D, B, 18C, H, W) and (D, B, 9C, H, W), d W and d bias in f32."""
    what = "modulated_deform_conv_multi backward"
    code = build.dtype_code(x.dtype)
    _check_maps(what, x, offsets_list, masks_list, packed, dilations)
    b, c, h, w = x.shape
    d, o, op = packed.d, packed.o, packed.w.shape[-1]
    g = g.to(x.dtype).contiguous()
    if tuple(g.shape) != (b, o, h, w):
        raise ValueError(f"{what}: the output's gradient has shape {tuple(g.shape)}")
    lib = build.load("deform_conv_bwd", _BWD_SIGNATURES)
    if (lib.otp_deform_bwd_max_outputs(), lib.otp_deform_bwd_wide_dilations()) != (
            MAX_BWD_OUTPUTS, WIDE_DILATIONS):
        raise RuntimeError(f"{what}: the library takes {lib.otp_deform_bwd_max_outputs()} "
                           f"outputs and {lib.otp_deform_bwd_wide_dilations()} dilations a "
                           f"wide launch, the wrapper {MAX_BWD_OUTPUTS} and {WIDE_DILATIONS}")
    ranges = backward_ranges(o)
    if len(ranges) > 1:
        return backward_by_ranges(launch_backward, g, x, offsets_list, masks_list, packed,
                                  dilations, ranges)
    wide = _wide(x, [x, *offsets_list, *masks_list])
    nbytes = lib.otp_deform_bwd_scratch(b, c, o, op, h, w, d, int(wide), code)
    if nbytes < 0:
        raise ValueError(f"{what}: the kernel does not take B={b}, C={c}, O={o}, {h}x{w}, "
                         f"D={d} (scratch query {nbytes})")
    dev = x.device
    d_off = torch.empty(d, b, 18 * c, h, w, device=dev, dtype=x.dtype)
    d_mask = torch.empty(d, b, 9 * c, h, w, device=dev, dtype=x.dtype)
    dx = torch.empty(b, c, h, w, device=dev, dtype=x.dtype)
    scratch = torch.empty(nbytes, device=dev, dtype=torch.uint8)
    dw = torch.empty(d, o, c, 3, 3, device=dev, dtype=torch.float32)
    dbias = torch.empty(d, o, device=dev, dtype=torch.float32)
    offs = (ctypes.c_void_p * d)(*[t.data_ptr() for t in offsets_list])
    msks = (ctypes.c_void_p * d)(*[t.data_ptr() for t in masks_list])
    dils = (ctypes.c_int * d)(*[int(v) for v in dilations])
    err = lib.otp_deform_bwd(x.data_ptr(), offs, msks, dils, packed.w.data_ptr(), g.data_ptr(),
                             d_off.data_ptr(), d_mask.data_ptr(), dx.data_ptr(),
                             scratch.data_ptr(), dw.data_ptr(), dbias.data_ptr(),
                             b, c, o, op, h, w, d, int(wide), code, build.stream_ptr(dev))
    build.check(lib, err, what)
    return dx, d_off, d_mask, dw, dbias


def backward_by_ranges(run, g, x, offsets_list, masks_list, packed: DcnPack, dilations,
                       ranges):
    """The gradients of ``launch_backward`` past ``MAX_BWD_OUTPUTS``
    outputs: ``run`` (``launch_backward``) a pass each range of ``ranges``
    on that range's rows of g and columns of the pack.  d W and d bias are
    the passes' rows; d x, d offset and d mask are linear in g W, so each is
    the sum of the passes'.  The passes run in f32 on x, the maps and g made
    f32 (exact from bf16: the same sampling and sums as the bf16 kernel's),
    are added in f32 in range order and rounded once to x's dtype."""
    d, c = packed.d, packed.c
    xf, gf = x.float(), g.float()
    offs, msks = [t.float() for t in offsets_list], [t.float() for t in masks_list]
    sums, dws, dbs = None, [], []
    for o0, o1 in ranges:
        n = o1 - o0
        w = packed.w.new_zeros(d, c, 9, output_pad(n))
        w[..., :n] = packed.w[..., o0:o1]
        bias = packed.bias.new_zeros(output_pad(n))
        bias[:n] = packed.bias[o0:o1]
        dx, d_off, d_mask, dw, dbias = run(gf[:, o0:o1], xf, offs, msks,
                                           DcnPack(d, c, n, w, bias), dilations)
        sums = [dx, d_off, d_mask] if sums is None else [
            s.add_(t) for s, t in zip(sums, (dx, d_off, d_mask))]
        dws.append(dw)
        dbs.append(dbias)
    dx, d_off, d_mask = (t.to(x.dtype) for t in sums)
    return dx, d_off, d_mask, torch.cat(dws, 1), torch.cat(dbs, 1)


# ---------------------------------------------------------------------------
# the registered ops: ``otpose::deform_conv`` (with its autograd) and
# ``otpose::deform_conv_bwd``.  Each takes the pack as its tensors
# (``pack_w``, ``pack_bias``) and O; the forward also takes the raw weights
# and biases, or None, which are the tensors its gradient is for.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _autograd_inside_op():
    """Record autograd graphs inside an op's implementation, which the
    dispatcher runs below autograd (the autograd keys excluded)."""
    key = torch._C.DispatchKey.AutogradFunctionality
    was = torch._C._dispatch_tls_is_dispatch_key_excluded(key)
    torch._C._dispatch_tls_set_dispatch_key_excluded(key, False)
    try:
        with torch.enable_grad():
            yield
    finally:
        torch._C._dispatch_tls_set_dispatch_key_excluded(key, was)


def pack_of(pack_w, pack_bias, o: int) -> DcnPack:
    """The ``DcnPack`` whose tensors an op was given."""
    d, c = pack_w.shape[:2]
    return DcnPack(d, c, o, pack_w, pack_bias)


@torch.library.custom_op("otpose::deform_conv", mutates_args=(), device_types="cpu")
def deform_conv_op(x: torch.Tensor, offsets: list[torch.Tensor], masks: list[torch.Tensor],
                   pack_w: torch.Tensor, pack_bias: torch.Tensor, weights: torch.Tensor | None,
                   biases: torch.Tensor | None, dilations: list[int], o: int) -> torch.Tensor:
    """CPU: the plain version, from the raw weights where they are given."""
    profiling.count("deform_conv.calls")
    if weights is None:
        weights, biases = unpack(pack_of(pack_w, pack_bias, o))
    return modulated_deform_conv_multi_plain(x, offsets, masks, weights, biases, dilations)


@deform_conv_op.register_kernel("cuda")
def _deform_conv_cuda(x, offsets, masks, pack_w, pack_bias, weights, biases, dilations, o):
    profiling.count("deform_conv.calls")
    out = launch(EXACT, "modulated_deform_conv_multi", x, offsets, masks, None, None, dilations,
                 pack_of(pack_w, pack_bias, o))
    profiling.count("deform_conv.launches", kernel_launches(len(dilations), o, EXACT))
    return out


@deform_conv_op.register_fake
def _deform_conv_fake(x, offsets, masks, pack_w, pack_bias, weights, biases, dilations, o):
    return x.new_empty(x.shape[0], o, x.shape[2], x.shape[3])


@torch.library.custom_op("otpose::deform_conv_bwd", mutates_args=(), device_types="cpu")
def deform_conv_bwd_op(g: torch.Tensor, x: torch.Tensor, offsets: list[torch.Tensor],
                       masks: list[torch.Tensor], pack_w: torch.Tensor, pack_bias: torch.Tensor,
                       weights: torch.Tensor | None, biases: torch.Tensor | None,
                       dilations: list[int], o: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """The gradients of ``otpose::deform_conv`` from its output's gradient
    ``g``: d x, the offset and mask gradients stacked over D, d weights
    (D, O, C, 3, 3) and d biases (D, O), in the raw weights' dtypes where
    they are given, else f32 (zeros: the op was given no weights to
    differentiate).  CPU: the plain version's autograd."""
    d, c = len(dilations), x.shape[1]
    raw = weights is not None
    if not raw:
        weights, biases = unpack(pack_of(pack_w, pack_bias, o))
    leaves = [t.detach().requires_grad_() for t in (x, *offsets, *masks)]
    if raw:
        weights, biases = (t.detach().requires_grad_() for t in (weights, biases))
        leaves += [weights, biases]
    with _autograd_inside_op():
        out = modulated_deform_conv_multi_plain(leaves[0], leaves[1:1 + d],
                                                leaves[1 + d:1 + 2 * d], weights, biases,
                                                dilations)
        grads = torch.autograd.grad(out, leaves, g)
    dw, dbias = (grads[-2], grads[-1]) if raw else (x.new_zeros(d, o, c, 3, 3, dtype=torch.float32),
                                                     x.new_zeros(d, o, dtype=torch.float32))
    return (grads[0], torch.stack(grads[1:1 + d]), torch.stack(grads[1 + d:1 + 2 * d]), dw,
            dbias)


@deform_conv_bwd_op.register_kernel("cuda")
def _deform_conv_bwd_cuda(g, x, offsets, masks, pack_w, pack_bias, weights, biases, dilations, o):
    dx, d_off, d_mask, dw, dbias = launch_backward(g, x, offsets, masks,
                                                   pack_of(pack_w, pack_bias, o), dilations)
    profiling.count("deform_conv.bwd_launches", backward_launches(len(dilations), o))
    if weights is not None:
        dw, dbias = dw.to(weights.dtype), dbias.to(biases.dtype)
    return dx, d_off, d_mask, dw, dbias


@deform_conv_bwd_op.register_fake
def _deform_conv_bwd_fake(g, x, offsets, masks, pack_w, pack_bias, weights, biases, dilations, o):
    d, (b, c, h, w) = len(dilations), x.shape
    wdt = torch.float32 if weights is None else weights.dtype
    bdt = torch.float32 if biases is None else biases.dtype
    return (torch.empty_like(x), offsets[0].new_empty(d, b, 18 * c, h, w),
            masks[0].new_empty(d, b, 9 * c, h, w), x.new_empty(d, o, c, 3, 3, dtype=wdt),
            x.new_empty(d, o, dtype=bdt))


def _setup_context(ctx, inputs, output):
    x, offsets, masks, pack_w, pack_bias, weights, biases, dilations, o = inputs
    ctx.save_for_backward(x, *offsets, *masks, pack_w, pack_bias, weights, biases)
    ctx.dilations, ctx.o = dilations, o


def _backward(ctx, g):
    x, *rest = ctx.saved_tensors
    d = len(ctx.dilations)
    offsets, masks = rest[:d], rest[d:2 * d]
    pack_w, pack_bias, weights, biases = rest[2 * d:]
    dx, d_off, d_mask, dw, dbias = deform_conv_bwd_op(g, x, offsets, masks, pack_w, pack_bias,
                                                      weights, biases, ctx.dilations, ctx.o)
    if weights is None:
        dw = dbias = None
    return dx, list(d_off.unbind(0)), list(d_mask.unbind(0)), None, None, dw, dbias, None, None


deform_conv_op.register_autograd(_backward, setup_context=_setup_context)


def modulated_deform_conv_multi(x, offsets_list, masks_list, weights=None, biases=None,
                                dilations=(), *, packed: DcnPack | None = None) -> torch.Tensor:
    """x: (B, C, H, W) -> (B, O, H, W); see the module docstring.  Or, in
    place of ``weights`` and ``biases``, ``packed`` from ``pack_dcn_weights``.
    Raw weights are packed once a call, without grad; their gradients come
    from ``otpose::deform_conv_bwd``."""
    build.check_device("modulated_deform_conv_multi", x)
    if packed is None:
        packed = pack_dcn_weights(weights, biases, device=x.device)
    return deform_conv_op(x, list(offsets_list), list(masks_list), packed.w, packed.bias,
                          weights, biases, [int(v) for v in dilations], packed.o)
