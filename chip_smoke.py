#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``otpose_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. checks for a CUDA device and prints its ``nvidia-smi`` name and power limit;
2. builds the five kernel sources and nvJPEG's (``jpeg_nv.cu``) from
   ``otpose_tpu_torch/csrc`` with ``nvcc``, in parallel;
3. holds each of the five kernel rows against its plain PyTorch version at
   the shapes its paths give it, in f32 (TF32 off) and bf16, and times both
   with CUDA events: fused attention, fused MLP and the DCN at the flagship
   shapes at B = 16 (eval) and B = 1 (inference); the fused-sampling DCN
   (the DCN's kernel in its make_pallas3 rounding mode) at the same shapes,
   and against the exact mode: in f32 the same function, in bf16 it must
   share its plain version's rounding far more often than the exact mode
   does; the token shift in its four modes, f32 and bf16, at (16, 256), at
   the attention's halo size (16 * 136, 6912) and at the shapes that stress
   its vector path (L not a multiple of a 16-byte vector, L odd, L shorter
   than a vector, R = 1, more rows than the grid, a view that starts off a
   16-byte boundary), where it must be exact, then timed in every mode at
   the halo size (eager and CUDA-graph replay, ``torch.roll`` beside
   ``rotate``, achieved TB/s); in bf16
   the fused MLP, the attention and both DCN modes also print the share of
   outputs that differ from their own plain version (the MLP and the exact
   DCN must stay at or below 5%); the fused kernels and the DCN are timed
   through weights packed once, as the model calls them, and the packed
   call must give the raw-weight call's bits (every kernel sums in a fixed
   order), twice; every row's ``ms``
   is CUDA events around eager calls, and the DCN (at B = 16 and B = 1, both
   modes, both dtypes) is also timed by replaying a CUDA graph of 20 calls
   (``graph_ms``), the device's time without the wrapper's host work; the
   f32 fused attention and MLP (split TF32 on the tensor cores) must meet an
   f64 witness within 1e-4 of the output's peak (the attention's score,
   softmax and att @ v tail in f64; the MLP's whole tail) and be faster than
   their plain versions at B = 16 (B = 1 printed), their bound being three
   TF32 passes at 495 TFLOP/s;
4. runs the flagship decoded eval (HRNet-W48, 384x288, B = 16) from
   ``build_model`` in bf16 with bf16 weights, then in f32 with and without
   the fused kernels (``fused=False``: 0 / 0 / 1 launches), checks the output
   shapes and values and the kernel launch counts (12 / 16 / 1 per forward),
   that the counted step packs no weights (the blocks and the model cache
   their packs, the DCN's included), and times the steps in clips/s (the
   two f32 steps in turns: kernels, plain, plain, kernels);
5. runs the flagship flip-test decoded eval in bf16 (two forwards a step:
   24 / 32 / 2 launches) and times it in clips/s;
6. runs the single-clip inference API (``PoseEstimator.infer_images``, B = 1,
   bf16) on five synthetic 720x1280 frames: a finite (17, 3) result and
   12 / 16 / 1 launches per call; prints the median latency of 20 calls and
   its preprocess / forward / decode split;
7. runs the two experiment tools as functions: one round of
   ``tools/exp_deform_fused`` (the DCN kernel's two rounding modes) and
   ``tools/probe_shift`` (every token-shift mode OK);
8. runs the tiny config on the GPU and on the CPU (plain versions) with the
   same weights (offset and mask convs calibrated, most DCN samples inside
   the image) and holds the decoded results against each other;
9. runs the eval CLI (``cli/eval.py::Eval("validate", args).eval()``) at
   flagship width and depth in bf16, B = 16, no flip, over a synthetic
   PoseTrack-format tree of 64 boxes made from a seed in a temporary
   directory (frames as uint8 arrays that ``ArrayFramesDataset`` reads and
   crops with the port's torch warp, needing no cv2), from a checkpoint of
   random weights saved in
   the reference's ``.pth`` layout, five times: an untimed first run with
   ``TPU.DEVICE_PREPROCESS full`` (the device warp; the process's first
   steps), then with the key left at the config's ``auto`` (the device
   loader in its crops mode), with ``off`` (the host loader) on four and on
   one loader thread, and with ``full`` again.  Each run: 12 / 16 / 1 launches a batch, one
   json a video, an AP table of 8 entries that is not perfect; the device
   loader's first batch equals the host loader's on the card, the auto
   run's AP table equals the off run's to 1e-9, the one-thread run agrees
   with the four-thread one, and the full run's AP is printed beside them.
   Prints boxes/s of each whole loop, the share of its wall time that the
   CUDA events around the steps span (the device busy, or waiting for the
   host's next launch) and the host's time in each step's launches.

10. holds the DCN's backward kernel (``csrc/deform_conv_bwd.cu``) against
    the plain version's autograd at the flagship shape (B = 8 in f32 and
    bf16, B = 1 in bf16), at offsets calibrated so that most samples fall
    inside the image: each of the five gradients' worst error over its peak
    (f32 1e-4, bf16 5e-2), in bf16 the share of elements that differ, two
    calls bit-equal in every gradient, the kernel's ms against the plain
    backward's and the bound;
11. checks that the fused attention, fused MLP and token shift raise on a
    CUDA tensor that requires grad (they have no backward);
12. runs the flagship train step (``configs/17/model_RSN.yaml`` at full
    width and depth, reference init, synthetic batches with Gaussian targets
    from ``ops/heatmap.py::generate_heatmaps``, some joints labelled and some
    not): first one step each in bf16 and f32 from copies of the initial
    model on one B = 2 batch (the two losses), then on one model and
    optimizer bf16 at B = 8 (2 warm-up steps, 5 timed), f32 at B = 2 (3
    steps) and bf16 at B = 16 with ``ACCUM_STEPS 2`` (1 step), each step's
    six metrics finite, its ms (CUDA events), clips/s, peak memory and
    launches (0 / 0 / 1 / 1 per micro-batch); then every trainable parameter
    must hold a finite gradient and every BN running stat must have moved;
13. runs one train step of the tiny config in f32 on the card and on the
    CPU from the same weights (mask convs calibrated, offset convs zeroed,
    dropout rates 0, SGD) and holds every gradient and every update against
    each other (1e-3 of its peak, 2e-2 for HRNet's stem and layer1, plus
    1e-6 of the largest, for gradients that are residues);
14. runs the train CLI (``cli/train.py::Train(args).train()``) at flagship
    width and depth from ``configs/17/model_RSN.yaml`` as it is (bf16,
    ``TRAIN.BATCH_SIZE_PER_GPU`` 2, ``TPU.DEVICE_PREPROCESS auto``: the device
    loader in crops mode) over a synthetic tree of 32 train and 32 val boxes
    (frames as arrays through ``ArrayFramesDataset``), ``MODEL.PRETRAINED`` a
    reference-layout ``.pth`` of random reference-init weights, two epochs with
    ``--sigma_schedule 1``, cuDNN deterministic: every step's six metrics
    finite, 0 / 0 / 1 / 1 launches a step and 12 / 16 / 1 a validation batch,
    one weight pack a block a validation, every parameter tensor of the
    ``.pth`` loaded, epoch 1's targets drawn at sigma - 1, ``epoch_0_state``,
    ``epoch_1_state`` and one ``best_mAP_*_state``, the eval CLI on the best
    checkpoint giving that validation's AP table to 1e-9 and its keypoints
    (the reference init's heatmaps are nearly flat and its AP may be 0: at
    least 98% of the coordinates identical, the max values to 1e-3 of their
    peak, and not all alike); prints clips/s of
    the train loops and the share of their wall time the steps' CUDA events
    span, validation boxes/s, whether the asynchronous epoch saves were
    still being written when validation ended, a checkpoint's save times
    (synchronous and asynchronous: until the call returns and until
    committed) and peak memory; then, in a fresh folder, a run that sends
    itself SIGTERM after five steps (``epoch_0_state`` at iteration 5) and a
    new ``Train`` that resumes it (its resume time printed), whose weights,
    BN statistics, optimizer moments and count and TensorBoard steps must
    equal the uninterrupted run's bit for bit (or, should some op be left
    non-deterministic, be no farther from them than a second uninterrupted
    run is: both printed); the phase's seconds and the script's total;
15. exports and serves (``cli/export.py``, ``engine/export.py``,
    ``tools/serve.py``): ``python -m otpose_tpu_torch.cli.export`` on
    ``configs/17/model_RSN.yaml`` (bf16 compute, ``TPU.PARAM_DTYPE bfloat16``)
    from a reference-layout ``.pth`` of random reference-init weights, a
    baked artifact at B = 16 and an external-weights one at B = 1, the two
    at once, beside a tiny artifact traced on the card and loaded on the CPU
    (``move_to_device_pass``; 1e-3 of the peak against the card's answers);
    each flagship artifact loaded in a fresh process (``chip_smoke.py
    --serve-worker``), which must import no model code, and held against the
    live ``make_decoded_eval_step`` on the same clips, bit for bit; the served call
    12 / 16 / 1 launches and no weight pack; its clips/s beside the live
    step's in this call; the serve tool's ``main`` on a local port
    answering 1, 5 and 16 clips (each row equal to the artifact's answer)
    and rejecting 17, its latency over HTTP at 1 and 16 clips (the tool
    and the two fresh processes load at once, then take the card in turn);
    export seconds (with when each CLI's log reached its config, its loaded
    model and its written artifact), artifact bytes and load seconds
    printed;
16. runs the port's data parallelism (``parallel/``): (1) in this process,
    a one-rank NCCL group on a free port, the flagship f32 train step at
    B = 2 for two steps (cuDNN deterministic, dropout 0) bit-equal in its
    losses, weights and BN statistics to the same steps without a group,
    with the device collectives a micro-batch (one all-reduce a BN layer
    each way, the loss's two labelled tests, the PCK meter, the gradients,
    the metrics) and ms a step with and without the group; (2) two ranks
    sharing the card (``chip_smoke.py --dist-worker`` processes, a ``gloo``
    device group, as NCCL refuses two ranks on one GPU), f32 at a global
    B = 2 against (1)'s run without a group (SGD and the refinement
    calibrated, as phase 13 holds gradients: the metrics to 2e-4 relative,
    each tensor's update after each step to 1e-3 of its peak plus 1e-6 of
    the largest; a single-process run on the rows swapped shows the f32
    spread) and bf16 at a global B = 8 from the reference init (finite,
    0 / 0 / 1 / 1 launches a rank a micro-batch), the ranks bit-equal to each
    other; ms a step and peak memory a rank, which are no scaling number;
    (3) in the same processes the decoded eval sharded over the two ranks
    (``make_eval_shard_fn`` and ``fetch``) in bf16 and f32 on a batch of 16
    (8 a rank) and of 5 (whole on each rank) against the single-process
    step on the same clips: at least 98% of coordinates identical, max
    values to 1e-3 of their peak, 12 / 16 / 1 launches a rank a batch;
    (4) the train CLI with two ranks on ``configs/17/model_RSN.yaml`` as it
    is (bf16, 2 a rank, the device loader) over a synthetic tree of 16 + 16
    boxes, one epoch with validation: rank 0 alone writes ``epoch_0_state``
    and one ``best_mAP_*_state``, the ranks' weights bit-equal, rank 0's AP
    table equal to a single-process eval CLI's on the best checkpoint to
    1e-9 and its keypoints held to that CLI's by phase 14's gate; a run
    whose rank 1 alone gets SIGTERM after 2 steps stops both ranks there,
    and its two-rank resume ends bit-equal to the uninterrupted run; the
    phase's seconds;
17. JPEG frames on the card and the detector: (1) probes the machine for
    ``nvjpeg.h`` and ``libnvjpeg.so*`` beside ``nvcc``, ``jpeglib.h`` on
    g++'s include path, ``find_library("jpeg")``, whether the JAX package's
    committed ``native/libotpose_io.so`` loads (in a subprocess), PIL, cv2,
    and the port's native library and nvJPEG; (2) decodes the JPEG fixture
    (``tests/fixtures/jpeg/``: five 1280x720 4:2:0 frames, a 333x251 4:4:4,
    a greyscale and a 333x251 4:2:2 one) with nvJPEG on each backend the
    card has against the fixture's libjpeg decode (the maximum and mean
    uint8 difference of the pixels, and of the planes, against bars), a
    batch into a 1088x1920 staging buffer against each frame alone, a 4:4:0
    frame refused by name, and decode rates at 1280x720 (nvJPEG on each
    backend, cv2 and PIL on a host thread); (3) runs the detector
    (``detector/yolov3.py``, full YOLOv3 and yolov3-tiny at 416, He-scaled
    weights from a seed, BN calibrated on two fixture frames) on the card in
    f32 against its plain CPU forward: raw outputs, kept boxes, ms a frame
    beside the bound; (4) runs ``tools/generate_boxes`` over a tree of the
    fixture's frames on the card (nvJPEG) and on the CPU, holds the two
    boxes files to each other (the share of matched boxes against a
    control's) and the detector's input from nvJPEG's pixels to libjpeg's,
    then the eval CLI on the test split with ``USE_GT_BBOX`` false over the
    card's boxes under ``full``: nvJPEG chosen, 12 / 16 / 1 launches a
    batch, boxes/s, and its keypoints against the same run on cv2's frames
    (the share within 4 px against a control's); (5) ``tools/bench_input_pipeline``'s
    table on the card.  nvJPEG ports no TPU kernel: it gets a line of its
    own (``nvjpeg: {...}``), not a ``kernels`` entry;
18. the modules ported last: (1) the eval CLI on its heatmap path
    (``DEBUG.VIS_SKELETON`` and ``VIS_BBOX`` on: ``make_eval_step`` /
    ``make_flip_eval_step`` and ``evaluate_epoch``, the drawing on the
    original frames) in bf16 at B = 16 over a tree of the fixture's jpg
    frames (validation, ground-truth boxes), without and with the flip, each
    beside the decoded path on the same tree and weights: 12 / 16 / 1
    launches a batch (24 / 32 / 2 with the flip), one drawn image a frame
    and a result dump a batch, keypoints within one f32 step of the decoded
    path's and equal max values, boxes/s; (2) ``build_model`` with
    ``MODEL.NAME pose_hrnet`` (HRNet-W48, 384x288, B = 16, f32, TF32 off,
    weights of std 1/sqrt(fan_in)): the card against the CPU to 2e-4 of the
    peak, ms a forward; (3) a ConvTransformer at C = 136, T = 6912, arch (1, 6, 2),
    window 19 at every level, ``use_rel_pe``, B = 2, in eval in f32 (1e-4
    of the peak against the CPU) and bf16 (RMS from the CPU's f32 answer no
    more than twice the CPU bf16 plain version's; the share of outputs that
    differ from it printed): 8 fused-MLP launches a forward (every window
    block's MLP), no fused attention; (4) ``tools/time_train_step`` in bf16
    at B = 8 without remat (0 / 0 / 1 / 1 launches a step), the median ms of
    three steps each timed alone, beside phase 12's median; (5) K2, ``tools/exp_fused_train_mlp`` (6 blocks, B = 8,
    C = 136, T = 6912, bf16): three interleaved rounds of 10 calls an arm,
    each arm's ms, the fused arm's share, one block's gradients fused
    against plain no farther apart than two plain runs, 6 fused-MLP
    launches a fused call; (6) the DCN variants (groups 2, deformable groups
    4, stride 2, dilation 2, C = 64) and ``deform_psroi_pool`` on the card
    against the CPU to 1e-5 of the peak; the phase's seconds.

19. runs the port's sequence parallelism (``parallel/sequence.py``: a
    ``data x seq`` mesh, the conv-transformers' tokens split over the seq
    ranks) with ranks sharing the card (``--dist-worker`` processes, a
    ``gloo`` device group), the flagship from weights of std
    1/sqrt(fan_in) and a calibrated refinement, against this process's
    one-rank steps on the same weights and inputs: (1) four ranks at
    ``data 2 x seq 2``: the bf16 decoded, heatmap and flip eval at B = 16
    (8 rows a data group): the heatmaps' RMS from the one-rank f32 answer
    no more than twice the one-rank bf16 plain step's (the share of
    outputs that differ from it printed); (2) two ranks at ``data 1 x seq
    2``: the f32 eval at B = 2 against the one-rank plain step (heatmaps to
    1e-5 of their peak, keypoints equal where the top-two gap is clear), a
    bf16 train step at B = 4 (finite, the ranks bit-equal) and an f32 SGD
    step at B = 2 with dropout at the yaml's rates from one generator seed
    (each tensor's update to 1e-4 of its peak plus 1e-6 of the largest);
    (3) five ranks at ``data 1 x seq 5``, where T = 6912 splits into
    unequal slices (``SeqGroup.split``: 1384, 1384, 1384, 1380 and 1380
    tokens in the scale encoders, stride 4; 1383, 1383, 1382, 1382 and 1382
    in the flow encoder): the f32 eval at B = 2 and the f32 SGD step at B =
    2, held as (2) holds them, with the slices printed; launches a rank 0 /
    0 / 1 an eval forward and 0 / 0 / 1 / 1 a train micro-batch, the
    collectives by group a forward and a micro-batch against the count the
    blocks make (the same on unequal slices), ms and clips/s and each rank's
    peak memory beside the one rank's (recorded, not gated: the ranks share
    one card); the phase's seconds.

20. runs the shapes beyond the shipped configs, which the JAX package runs:
    (a) the tiny config at 21 and 33 joints and at nine dilations (1 to 9)
    on the card against the CPU (the seven outputs to 1e-3 of the peak,
    keypoints on clear peaks), with the launches the blocks' gate predicts
    (``gate_counts``: the fused kernels in every eval block of C >= 32, the
    attention at stride 1, on their wide paths past 160 channels; the DCN a
    launch a group of 8 dilations, of 5 on its wide path past 32 outputs);
    (b) the flagship (HRNet-W48, 384x288) at 26 and 133 joints, decoded
    eval at B = 2 in
    bf16 and f32, with the fused kernels and without: the launches JAX's
    gate gives (12 / 16 / 1 and 18 / 22 / 1), finite outputs, the f32
    forward with the kernels to 1e-3 of each output's peak against without,
    the bf16 keypoints against the plain step's beside a control (plain
    bf16 against plain f32), ms a step with and without the kernels in
    turns, and one bf16 train step at 133 joints and B = 2 (finite metrics,
    the DCN's forward and backward a launch each, ms); (c) the DCN at O = C
    = 133 on its wide paths, 96x72, B = 2, at five dilations and at nine (3
    to 27), forward in f32 and bf16 against its plain version under row 3's
    gate (f32 also against an f64 witness) and backward (bf16 at five, f32
    at nine) under row 6's, each call's launches (one a group of 5
    dilations), two calls bit-equal, ms against the plain version's, the
    bound and the grouped launches' before (no slower than those); (d) the
    fused kernels' predicates (``supports``, ``narrow``) against
    ``otp_fused_attn_smem``,
    ``otp_fused_attn_narrow`` and the MLP's entry points (the narrow ones to
    160 channels, ``otp_fused_mlp_wide`` past them) at C = 1 to 1100,
    1 to 16 heads, both dtypes; (e), inside phase 19's five ranks at ``1 x
    5``: the flagship's temporal encoder at T = 8 (three ranks with no
    token) and phase 18's window-19 encoder at T = 32 (halos wider than the
    slices) against the one-rank forward to 1e-5 of the peak; (f) rows 1
    and 2 on their wide paths (the products on ``wgmma`` fed by TMA,
    ``csrc/hopper_gemm.cuh``) at (B, C, T) = (2, 208, 6912) and (2, 1064,
    6912), f32 and bf16, under phase 3's gates, two calls bit-equal, the
    kernel no slower than its plain version in each of the eight cells, ms
    beside the plain version's, the bound and its share, each launch's
    device ms, and the products alone by ``torch.matmul`` (the library
    column: products only, not the function); the phase's seconds.

``python3 chip_smoke.py --phase15`` (or ``--phase17`` to ``--phase20``)
builds the kernels and runs that phase alone (a development run: no kernels
line, no result line).

Each path (phases 4 to 7, 9, 12, 14, 15, 16, 17, 18, 19 and 20) is driven with every
launch count set to 0 just before it and read just after (phase 15's in the
process that serves, phase 16's and 19's in each rank).  It prints a ``kernels`` JSON line, the
card line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
SMEM_LIMIT = 232448   # bytes of shared memory one H100 block may use
BATCH = 16
KERNEL_MODULES = ("fused_attn", "fused_mlp", "deform_conv", "deform_conv_fused", "token_shift")
FORWARD_COUNTS = {"fused_attn": 12, "fused_mlp": 16, "deform_conv": 1, "deform_conv_bwd": 0,
                  "deform_conv_fused": 0, "token_shift": 0}
# a train step's launches for each micro-batch: the fused kernels are eval-only
TRAIN_COUNTS = {"fused_attn": 0, "fused_mlp": 0, "deform_conv": 1, "deform_conv_bwd": 1,
                "deform_conv_fused": 0, "token_shift": 0}
DCN_DILATIONS = (3, 6, 9, 12, 15)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attn_case(dtype, gen, batch, c=136, n_head=2):
    """Flagship attention inputs (other widths: ``c``, ``n_head``).  In bf16
    the q and k projection weights are drawn 4x and their biases 10x
    smaller, so that |S| stays near 10: the model rounds S to bf16 before
    the softmax (as the reference does), and where |S| is near 100 a bf16
    ulp of S is 0.5, so two correct summation orders that round one score
    to neighbouring values move its attention weight by up to e^0.5 (seen on
    the chip: 0.3 at |S| = 75)."""
    import torch

    t = 6912
    f = dict(device="cuda", dtype=torch.float32)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, **f) * scale  # noqa: E731
    args = [r(batch, c, t).to(dtype),
            1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    args += [r(c, 1, 3, scale=1 / math.sqrt(3)).to(dtype) for _ in range(3)]
    for _ in range(3):
        args += [1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1)]
    proj = []
    for p in range(3):
        small = dtype == torch.bfloat16 and p < 2
        proj += [r(c, c, 1, scale=(0.25 if small else 1.0) / math.sqrt(c)).to(dtype),
                 r(c, scale=0.01 if small else 0.1).to(dtype)]
    return args + proj + [n_head]


def mlp_case(dtype, gen, t, batch, c=136):
    import torch

    f = dict(device="cuda", dtype=torch.float32)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, **f) * scale  # noqa: E731
    return [r(batch, c, t).to(dtype), 1 + r(1, c, 1, scale=0.1), r(1, c, 1, scale=0.1),
            r(4 * c, c, 1, scale=1 / math.sqrt(c)).to(dtype), r(4 * c, scale=0.1).to(dtype),
            r(c, 4 * c, 1, scale=1 / math.sqrt(4 * c)).to(dtype), r(c, scale=0.1).to(dtype)]


def dcn_case(dtype, gen, batch):
    import torch

    c, h, w, dil = 17, 96, 72, (3, 6, 9, 12, 15)
    f = dict(device="cuda", dtype=torch.float32)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=gen, **f) * scale  # noqa: E731
    x = r(batch, c, h, w).to(dtype)
    offs = [r(batch, 18 * c, h, w, scale=2.0).to(dtype) for _ in dil]
    masks = [r(batch, 9 * c, h, w).to(dtype) for _ in dil]
    weights = r(len(dil), c, c, 3, 3, scale=1 / math.sqrt(9 * c)).to(dtype)
    biases = r(len(dil), c, scale=0.1)
    return [x, offs, masks, weights, biases, dil]


def work(name, args):
    """(bytes, operations, least ms of those operations) the function needs:
    matrix products at the tensor-core bf16 rate, or in f32 as three TF32
    passes on the tensor cores (the least work that keeps f32 accuracy
    there: the f32 fused kernels' split).  The deformable conv's bilinear
    sampling is scalar f32 work; its contraction over O is a matrix product
    ((B H W) x (D C 9) samples times W), as the reference computes it; the
    two may overlap, so the least time is the longer of them."""
    import torch

    mm_peak = PEAK_TF32 / 3 if args[0].dtype == torch.float32 else PEAK_BF16
    if name == "fused_attn":
        x = args[0]
        b, c, t = x.shape
        hs = c // args[-1]
        ops = 3 * 2 * c * c * t * b + 2 * (2 * c * hs * t * b)
        return 2 * nbytes(x), ops, ops / mm_peak * 1e3
    if name == "fused_mlp":
        x, w1 = args[0], args[3]
        b, c, t = x.shape
        ops = 2 * 2 * c * w1.shape[0] * t * b
        return 2 * nbytes(x), ops, ops / mm_peak * 1e3
    x, offs, masks, weights = args[:4]
    b, c, h, w = x.shape
    d, o = weights.shape[:2]
    samples = d * 9 * c * b * h * w
    # per sample: bilinear weights and 4 corners (~11 flops) and the mask;
    # then 2 O flops of the contraction
    scalar, mm = samples * 12, samples * 2 * o
    moved = nbytes(x, *offs, *masks, weights) + b * o * h * w * x.element_size()
    return moved, scalar + mm, max(scalar / PEAK_F32, mm / mm_peak) * 1e3


def attn_f64_errors(args, got, want):
    """max|kernel - ref| and max|plain - ref|, where ref runs the plain f32
    front (LN, depthwise, LN, projections) and then the scores, softmax and
    att @ v in f64."""
    import torch

    from otpose_tpu_torch.models import core

    (x, l1w, l1b, dq, dk, dv, nqw, nqb, nkw, nkb, nvw, nvb,
     wq, bq, wk, bk, wv, bv, n_head) = args
    n = core.layer_norm_ct(x, l1w, l1b)
    q, k, v = (core.dense_1x1_ct(core.layer_norm_ct(core.depthwise_conv1d_k3_ct(n, dw), nw, nb),
                                 w, b)
               for dw, nw, nb, w, b in ((dq, nqw, nqb, wq, bq), (dk, nkw, nkb, wk, bk),
                                        (dv, nvw, nvb, wv, bv)))
    b, c, t = q.shape
    hs = c // n_head
    qs = (q * q.new_tensor(1 / math.sqrt(hs))).double().reshape(b, n_head, hs, t)
    s64 = qs @ k.double().reshape(b, n_head, hs, t).transpose(-1, -2)
    ref = (torch.softmax(s64, -1) @ v.double().reshape(b, n_head, hs, t)).reshape(b, c, t)
    return ((got.double() - ref).abs().max().item(), (want.double() - ref).abs().max().item())


def mlp_f64_errors(args, got, want):
    """max|kernel - ref| and max|plain - ref|, where ref is the whole MLP
    tail (LN, both products, exact GELU, residual) in f64 from the same f32
    inputs."""
    import torch

    x, lw, lb, w1, b1, w2, b2 = (a.double() for a in args)
    mu = x.mean(1, keepdim=True)
    var = ((x - mu) ** 2).mean(1, keepdim=True)
    n = (x - mu) / torch.sqrt(var + 1e-5) * lw.reshape(1, -1, 1) + lb.reshape(1, -1, 1)
    h = torch.nn.functional.gelu(w1[:, :, 0] @ n + b1[:, None])
    ref = x + w2[:, :, 0] @ h + b2[:, None]
    return ((got.double() - ref).abs().max().item(), (want.double() - ref).abs().max().item())


def packed_call(name, kern, args):
    """A call of ``kern`` on ``args`` through weights packed once, as the
    model makes them (the DCN's pack serves both of its modes)."""
    from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp

    x, dtype = args[0], args[0].dtype
    if name in ("deform_conv", "deform_conv_fused"):
        pk = deform_conv.pack_dcn_weights(args[3], args[4])
        return lambda: kern(*args[:3], dilations=args[5], packed=pk)
    if name == "fused_mlp":
        pk = fused_mlp.pack_mlp_weights(*args[1:], dtype)
        return lambda: fused_mlp.fused_mlp_residual_ct(x, packed=pk)
    if name == "fused_attn":
        pk = fused_attn.pack_attn_weights(*args[1:-1], dtype)
        return lambda: fused_attn.fused_attn_ct(x, packed=pk, n_head=args[-1])
    return lambda: kern(*args)


def check_kernels():
    import torch

    from otpose_tpu_torch.ops.cuda import deform_conv, deform_conv_fused, fused_attn, fused_mlp
    from otpose_tpu_torch.utils.timing import graph_ms, time_ms

    kernels = {
        "fused_attn": (fused_attn.fused_attn_ct, fused_attn.fused_attn_plain,
                       "otpose_tpu_torch/csrc/fused_attn.cu",
                       "otpose_tpu/ops/pallas/fused_attn.py:196"),
        "fused_mlp": (fused_mlp.fused_mlp_residual_ct, fused_mlp.fused_mlp_plain,
                      "otpose_tpu_torch/csrc/fused_mlp.cu",
                      "otpose_tpu/ops/pallas/fused_mlp.py:87"),
        "deform_conv": (deform_conv.modulated_deform_conv_multi,
                        deform_conv.modulated_deform_conv_multi_plain,
                        "otpose_tpu_torch/csrc/deform_conv.cu",
                        "otpose_tpu/ops/deform_conv.py:276"),
        "deform_conv_fused": (deform_conv_fused.deform_conv_fused,
                              deform_conv_fused.deform_conv_fused_plain,
                              "otpose_tpu_torch/csrc/deform_conv.cu",
                              "tools/exp_deform_pallas3.py:50"),
    }
    # tolerance on max|kernel - plain| as a share of max(1, max|plain|).
    # f32: the two differ by summation order, and the plain attention's
    # cuBLAS score sum over T = 6912 (|S| in the hundreds) errs by ~1e-4 of
    # the output's peak itself, which attn_f64_errors shows; bf16: a one-ulp
    # rounding flip where the two sums land on either side of a bf16
    # boundary, the tolerance of the JAX package's bf16 kernel tests.
    tol = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, shares, dcn_ms, dcn_graph_ms, f32_rows = {}, {}, {}, {}, {}
    for name, (kern, plain, src, replaces) in kernels.items():
        for dtype in (torch.float32, torch.bfloat16):
            # the eval's batch first (the timed case), then the inference API's
            cases = [case for batch in (BATCH, 1) for case in (
                [mlp_case(dtype, gen, t, batch) for t in (6912, 3456, 1728)]
                if name == "fused_mlp" else
                [attn_case(dtype, gen, batch) if name == "fused_attn"
                 else dcn_case(dtype, gen, batch)])]
            for i, args in enumerate(cases):
                got = kern(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1.0, want.float().abs().max().item())
                ok = math.isfinite(err) and err <= tol[dtype] * scale
                shape = tuple(args[0].shape)
                log(f"check {name} {str(dtype)[6:]} x{shape}: max_abs_err {err:.3e} "
                    f"(tolerance {tol[dtype]:.0e} x {scale:.3g}) {'ok' if ok else 'FAILED'}")
                if not ok:
                    fail(f"{name} {dtype} disagrees with its plain version")
                if name == "fused_attn" and dtype == torch.float32:
                    k_err, p_err = attn_f64_errors(args, got, want)
                    log(f"check fused_attn float32 against an f64 score/softmax tail: kernel "
                        f"{k_err:.3e}, plain {p_err:.3e} (kernel tolerance 1e-04 x {scale:.3g})")
                    if not k_err <= 1e-4 * scale:
                        fail("fused_attn f32 disagrees with the f64 reference")
                if name == "fused_mlp" and dtype == torch.float32:
                    k_err, p_err = mlp_f64_errors(args, got, want)
                    log(f"check fused_mlp float32 x{tuple(args[0].shape)} against the tail in "
                        f"f64: kernel {k_err:.3e}, plain {p_err:.3e} (kernel tolerance 1e-04 x "
                        f"{scale:.3g})")
                    if not k_err <= 1e-4 * scale:
                        fail("fused_mlp f32 disagrees with the f64 reference")
                if name in ("fused_attn", "fused_mlp") and dtype == torch.bfloat16:
                    # the max error cannot see a dropped rounding point (it
                    # stays within an ulp of the peak); the share of outputs
                    # that differ can.  The MLP's two products accumulate in
                    # f32 on both sides, so only summation-order flips remain;
                    # in the attention one flipped bf16 score moves a whole
                    # softmax row, so its share is printed with no limit.
                    share = (got != want).float().mean().item()
                    shares.setdefault(name, {})[f"{shape}"] = share
                    log(f"check {name} bfloat16 rounding x{shape}: outputs that differ from "
                        f"the plain version: {share:.4%}"
                        + (" (limit 5%)" if name == "fused_mlp" else " (no limit)"))
                    if name == "fused_mlp" and not share <= 0.05:
                        fail("fused_mlp bf16 does not round as its plain version does")
                if name == "deform_conv_fused" and dtype == torch.float32:
                    # in f32 the two modes of the DCN kernel are one function
                    shipped = deform_conv.modulated_deform_conv_multi(*args)
                    d_err = (got - shipped).abs().max().item()
                    log(f"check deform_conv_fused float32 against the exact mode: "
                        f"{d_err:.3e} (tolerance 1e-03 x {scale:.3g})")
                    if not d_err <= 1e-3 * scale:
                        fail("deform_conv_fused f32 disagrees with the exact mode")
                if name == "deform_conv" and dtype == torch.bfloat16:
                    # the exact mode rounds once, as its plain version does:
                    # only summation-order flips may remain
                    share = (got != want).float().mean().item()
                    shares.setdefault(name, {})[f"{shape}"] = share
                    log(f"check deform_conv bfloat16 rounding x{shape}: outputs "
                        f"that differ from the plain version: {share:.4%} (limit 5%)")
                    if not share <= 0.05:
                        fail("deform_conv bf16 does not round as its plain version does")
                if name == "deform_conv_fused" and dtype == torch.bfloat16:
                    # bf16 outputs a rounding apart differ by one ulp, inside
                    # the tolerance above whatever the rounding points, so
                    # count the outputs that differ: this mode rounds where
                    # its plain version does, the exact mode does not
                    shipped = deform_conv.modulated_deform_conv_multi(*args)
                    own = (got != want).float().mean().item()
                    other = (shipped != want).float().mean().item()
                    shares.setdefault(name, {})[f"{shape}"] = own
                    log(f"check deform_conv_fused bfloat16 rounding x{shape}: "
                        f"outputs that differ from the plain version: kernel {own:.4%}, exact "
                        f"mode {other:.4%} (kernel must stay below a tenth of the other)")
                    if not own < 0.1 * other:
                        fail("deform_conv_fused bf16 does not round as its plain version does")
                # time the eval's case, the DCN's inference case too, and the
                # f32 fused kernels' inference case (B = 1, T = 6912)
                dcn = name in ("deform_conv", "deform_conv_fused")
                fused32 = name in ("fused_attn", "fused_mlp") and dtype == torch.float32
                if (i == 0 or (dcn and i == len(cases) - 1)
                        or (fused32 and shape[0] == 1 and shape[2] == 6912)):
                    call = packed_call(name, kern, args)
                    # every kernel sums in a fixed order: a call gives the same
                    # bits each time, the raw-weight call the packed call's
                    if name != "deform_conv_fused" and not (
                            torch.equal(call(), got) and torch.equal(call(), got)):
                        fail(f"{name} {dtype}: the packed-weight calls differ from the "
                             "raw-weight call")
                    ms = time_ms(call, iters=20)
                    # the DCN by graph replay too: at B = 1 eager calls time
                    # the wrapper's host work as well as the kernel
                    gms = graph_ms(call) if dcn else None
                    plain_ms = time_ms(lambda: plain(*args), iters=3)
                    moved, ops, t_ops = work(name, args)
                    t_bytes = moved / PEAK_BYTES * 1e3
                    bound = max(t_bytes, t_ops)
                    log(f"time {name} {str(dtype)[6:]} B={shape[0]}: kernel {ms:.4f} ms"
                        + (f" (graph replay {gms:.4f} ms)" if dcn else "")
                        + f", plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({moved / 1e6:.1f} MB,"
                        f" {ops / 1e9:.2f} GFLOP; {bound / ms:.1%} of it)"
                        + (f"; at the f32 rate outside the tensor cores the bound is "
                           f"{ops / PEAK_F32 * 1e3:.4f} ms" if fused32 else ""))
                    if fused32:
                        f32_rows.setdefault(name, {}).update(
                            {f"ms_b{shape[0]}": ms, f"plain_ms_b{shape[0]}": plain_ms,
                             f"bound_ms_b{shape[0]}": bound,
                             f"bound_ms_fp32_cores_b{shape[0]}": ops / PEAK_F32 * 1e3})
                        if shape[0] == BATCH and not ms < plain_ms:
                            fail(f"{name} f32 ({ms:.4f} ms) is not faster than its plain "
                                 f"version ({plain_ms:.4f} ms) at B={BATCH}")
                    if dtype == torch.bfloat16 and i == 0:
                        rows[name] = dict(
                            name=name, route="cuda", source=src, replaces=replaces,
                            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by="bytes" if t_bytes >= t_ops else "operations",
                            library_ms=None)
                        if dcn:
                            rows[name]["graph_ms"] = gms
                    elif dtype == torch.bfloat16:
                        rows[name].update(ms_b1=ms, plain_ms_b1=plain_ms, bound_ms_b1=bound)
                        if dcn:
                            rows[name]["graph_ms_b1"] = gms
                    if dcn:
                        case = f"{str(dtype)[6:]} B={shape[0]}"
                        dcn_ms.setdefault(name, {})[case] = ms
                        dcn_graph_ms.setdefault(name, {})[case] = gms
    for name, by_shape in shares.items():
        rows[name]["bf16_differ_share"] = by_shape
    for name, by_case in dcn_ms.items():
        rows[name]["ms_by_case"] = by_case
        rows[name]["graph_ms_by_case"] = dcn_graph_ms[name]
    for name, f32 in f32_rows.items():
        rows[name]["f32"] = f32
    return rows


# token-shift shapes beyond the probe's (16, 256) and the halo size: L not a
# multiple of a 16-byte vector, L odd, L shorter than one vector, R = 1, more
# rows than the grid's 65535, a row of more than one chunk
SHIFT_SHAPES = ((16, 256), (16, 250), (3, 6911), (5, 129), (1, 1), (1, 2), (2, 7), (1, 8),
                (1, 6912), (70000, 24), (7, 4099))


def check_token_shift():
    """Every mode of the token shift against its plain version, exactly, in
    bf16 and f32, at ``SHIFT_SHAPES``, at the attention's halo size and on
    views that start 1 and 3 elements off a 16-byte boundary (the
    element-wise kernel); then ``tools/probe_shift.py::time_modes`` at the
    halo size in bf16.  The JSON row times the ``rotate`` mode, the one that
    a single PyTorch call (``torch.roll``) computes; its ``max_abs_err`` is
    the largest over every case."""
    import torch

    from otpose_tpu_torch.ops.cuda import token_shift
    from otpose_tpu_torch.tools import probe_shift

    gen = torch.Generator(device="cuda").manual_seed(6)
    halo = probe_shift.HALO
    err, cases = 0.0, 0
    for shape in SHIFT_SHAPES + (halo,):
        for dtype in (torch.float32, torch.bfloat16):
            base = torch.randn(shape[0] * shape[1] + 8, generator=gen, device="cuda").to(dtype)
            for offset in (0, 1, 3):
                x = base[offset:offset + shape[0] * shape[1]].view(*shape)
                for mode in token_shift.MODES:
                    got = token_shift.token_shift(x, mode)
                    want = token_shift.token_shift_plain(x, mode)
                    torch.cuda.synchronize()
                    err = max(err, (got.float() - want.float()).abs().max().item())
                    cases += 1
                    if not torch.equal(got, want):
                        fail(f"token_shift {mode} {dtype} {shape} at offset {offset} differs "
                             "from its plain version")
    log(f"check token_shift: {cases} cases (4 modes x f32, bf16 x {len(SHIFT_SHAPES) + 1} "
        "shapes x 3 offsets from a 16-byte boundary) exact")
    res = probe_shift.time_modes(halo, torch.bfloat16)
    probe_shift.report(res, out=log)
    rot = res["rotate"]
    for mode in token_shift.MODES:
        if not res[mode]["graph_ms"] >= res[mode]["bound_ms"]:
            fail(f"token_shift {mode}: {res[mode]['graph_ms']:.4f} ms is under its bound of "
                 f"{res[mode]['bound_ms']:.4f} ms: the timing loop reads a warm cache")
    return dict(name="token_shift", route="cuda", source="otpose_tpu_torch/csrc/token_shift.cu",
                replaces="tools/probe_shift.py:25", launches=None, max_abs_err=err, ms=rot["ms"],
                plain_ms=rot["plain_ms"], bound_ms=rot["bound_ms"], bound_by="bytes",
                library_ms=res["roll"]["ms"], graph_ms=rot["graph_ms"],
                library_graph_ms=res["roll"]["graph_ms"], mode="rotate",
                modes={m: {k: res[m][k] for k in ("ms", "graph_ms", "plain_ms", "bound_ms", "tbps")}
                       for m in token_shift.MODES})


# ---------------------------------------------------------------------------
# phases 4 to 9: the paths
# ---------------------------------------------------------------------------

_COUNTED_FROM: dict = {}


def reset_counts():
    """Count the kernels' launches from here (``utils/profiling.py``'s
    registry)."""
    from otpose_tpu_torch.utils import profiling

    _COUNTED_FROM.clear()
    _COUNTED_FROM.update(profiling.counters())


def read_counts():
    """Launches of each kernel since ``reset_counts``."""
    from otpose_tpu_torch.utils import profiling

    grown = profiling.since(_COUNTED_FROM)
    counts = {name: grown[f"{name}.launches"] for name in KERNEL_MODULES}
    counts["deform_conv_bwd"] = grown["deform_conv.bwd_launches"]
    return counts


def read_wide():
    """The fused attention's and MLP's wide-path launches since
    ``reset_counts``."""
    from otpose_tpu_torch.utils import profiling

    grown = profiling.since(_COUNTED_FROM)
    return grown["fused_attn.wide_launches"], grown["fused_mlp.wide_launches"]


def read_packs():
    """Weight packs made so far by the kernels whose weights are packed."""
    from otpose_tpu_torch.utils import profiling

    made = profiling.counters()
    return {name: made.get(f"{name}.packs", 0) for name in ("fused_attn", "fused_mlp",
                                                              "deform_conv")}


def flagship_eval():
    import torch

    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.models.otpose import prepare_eval_params
    from otpose_tpu_torch.utils.testing import flagship_otpose_cfg

    cfg = flagship_otpose_cfg()
    t0 = time.perf_counter()
    spec, model = build_model(cfg, seed=0)
    log(f"flagship model built on {next(model.parameters()).device} in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(1)
    w, h = cfg.MODEL.IMAGE_SIZE
    inputs = torch.randn(BATCH, h, w, 15, generator=gen, device="cuda")
    margin = torch.randint(0, 3, (BATCH, 4), generator=gen, device="cuda").float()
    j = spec.num_joints
    results, steps = {}, {}
    f32_model = copy.deepcopy(model)
    prepare_eval_params(model, torch.bfloat16)

    def clips_per_s(label, iters=5):
        t0 = time.perf_counter()
        for _ in range(iters):
            steps[label](inputs, margin)
        torch.cuda.synchronize()
        return BATCH / (time.perf_counter() - t0) * iters

    # f32 with and without the kernels ("f32 plain": every block on the
    # plain path, the DCN still its kernel)
    for label, m, dtype, fused in (("bf16", model, torch.bfloat16, True),
                                   ("f32", f32_model, torch.float32, True),
                                   ("f32 plain", f32_model, torch.float32, False)):
        want_counts = FORWARD_COUNTS if fused else dict(FORWARD_COUNTS, fused_attn=0,
                                                        fused_mlp=0)
        step = steps[label] = make_decoded_eval_step(m, compute_dtype=dtype, fused=fused)
        step(inputs, margin)                   # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        reset_counts()
        packs = read_packs()
        coords, maxvals, raw = step(inputs, margin)
        torch.cuda.synchronize()
        counts = read_counts()
        packed = {k: v - packs[k] for k, v in read_packs().items()}
        log(f"flagship {label}: launches {counts}; weight packs in the step {packed}")
        if counts != want_counts:
            fail(f"flagship {label} launches {counts}, expected {want_counts}")
        if any(packed.values()):
            fail(f"flagship {label}: a steady forward packed weights {packed}")
        for name, t, shape in (("coords", coords, (BATCH, j, 2)), ("maxvals", maxvals, (BATCH, j, 1)),
                               ("raw_coords", raw, (BATCH, j, 2))):
            if tuple(t.shape) != shape or not torch.isfinite(t).all():
                fail(f"flagship {label} {name}: shape {tuple(t.shape)} or non-finite values")
        results[label] = dict(counts=counts, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                              coords=coords.float().cpu(), maxvals=maxvals.float().cpu())
        if label == "bf16":          # timed right after its counted step, as before
            results[label]["clips_per_s"] = clips_per_s(label)
    # the f32 pair in turns (kernels, plain, plain, kernels) inside this call
    f32_turns = {"f32": [], "f32 plain": []}
    for label in ("f32", "f32 plain", "f32 plain", "f32"):
        f32_turns[label].append(clips_per_s(label))
    for label, rates in f32_turns.items():
        results[label]["clips_per_s"] = sum(rates) / len(rates)
    for label in ("bf16", "f32", "f32 plain"):
        rate = results[label]["clips_per_s"]
        log(f"flagship {label}: {BATCH / rate * 1e3:.2f} ms per step of {BATCH} clips, "
            f"{rate:.3f} clips/s" + (f" (turns {', '.join(f'{r:.3f}' for r in f32_turns[label])})"
                                     if label in f32_turns else ""))
    fused, plain = results["f32"], results["f32 plain"]
    d = (fused["maxvals"] - plain["maxvals"]).abs().max().item()
    same = (fused["coords"] == plain["coords"]).all(-1).float().mean().item()
    log(f"flagship f32 with the kernels against without: maxvals differ by {d:.3e} at most "
        f"(peak {plain['maxvals'].abs().max().item():.3e}), keypoints identical on {same:.2%}")
    # bf16 (bf16 weights) against f32 keypoints on the same clips: the
    # reference init's heatmaps are nearly flat, so ties and near-ties move
    same = (results["bf16"]["coords"] == results["f32"]["coords"]).all(-1).float().mean().item()
    log(f"flagship bf16 against f32 decoded keypoints: {same:.2%} identical, maxvals differ by "
        f"{(results['bf16']['maxvals'] - results['f32']['maxvals']).abs().max().item():.3e} at "
        f"most (peak {results['f32']['maxvals'].abs().max().item():.3e})")
    results["flip"] = flip_eval(model, inputs, margin, j)
    results["model"] = (cfg, model)
    return results


def flip_eval(model, inputs, margin, j):
    """The flip-test decoded eval in bf16 on the bf16-weight flagship model:
    two forwards a step, so twice the forward's launches."""
    import torch

    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step

    step = make_decoded_eval_step(model, compute_dtype=torch.bfloat16, flip=True)
    step(inputs, margin)
    torch.cuda.synchronize()
    reset_counts()
    coords, maxvals, raw = step(inputs, margin)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: 2 * v for k, v in FORWARD_COUNTS.items()}
    log(f"flagship flip bf16: launches {counts}")
    if counts != want:
        fail(f"flagship flip launches {counts}, expected {want}")
    for name, t, shape in (("coords", coords, (BATCH, j, 2)), ("maxvals", maxvals, (BATCH, j, 1)),
                           ("raw_coords", raw, (BATCH, j, 2))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            fail(f"flagship flip {name}: shape {tuple(t.shape)} or non-finite values")
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        step(inputs, margin)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / iters
    log(f"flagship flip bf16: {sec * 1e3:.2f} ms per step of {BATCH} clips, "
        f"{BATCH / sec:.3f} clips/s")
    return dict(counts=counts, clips_per_s=BATCH / sec)


def inference_api(cfg, model):
    """``PoseEstimator.infer_images`` at B = 1 in bf16 on five synthetic
    720x1280 uint8 frames: one call's launches, then the median latency of
    20 calls and of 20 split ones (preprocess, forward, decode), each part
    ending in a synchronise."""
    import numpy as np
    import torch

    from otpose_tpu_torch.cli.inference import PoseEstimator
    from otpose_tpu_torch.ops.heatmap import get_final_preds

    est = PoseEstimator(cfg, model)
    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(5)]
    box, margin = [500, 120, 260, 420], (1, 1, 2, 2)
    est.infer_images(frames, box, margin)
    torch.cuda.synchronize()
    reset_counts()
    out = est.infer_images(frames, box, margin)
    counts = read_counts()
    log(f"inference B=1 bf16: launches {counts} per call")
    if counts != FORWARD_COUNTS:
        fail(f"inference launches {counts}, expected {FORWARD_COUNTS}")
    if out.shape != (17, 3) or not np.isfinite(out).all():
        fail(f"inference result: shape {out.shape} or non-finite values")
    total, split = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        est.infer_images(frames, box, margin)
        total.append(time.perf_counter() - t0)
    for _ in range(20):
        t0 = time.perf_counter()
        x, center, scale = est.preprocess(frames, box)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        heat = est.forward(x, margin)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        get_final_preds(heat, center[None], scale[None])
        split.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    med = lambda v: float(np.median(v)) * 1e3  # noqa: E731
    res = dict(counts=counts, latency_ms=med(total), preprocess_ms=med([s[0] for s in split]),
               forward_ms=med([s[1] for s in split]), decode_ms=med([s[2] for s in split]))
    log(f"inference latency B=1 ms: {res['latency_ms']:.3f} (median of 20 calls); split: "
        f"preprocess {res['preprocess_ms']:.3f}, forward {res['forward_ms']:.3f}, "
        f"decode {res['decode_ms']:.3f} ms")
    return res


def tools():
    """The two experiment tools, called as functions, each its own path."""
    import torch

    from otpose_tpu_torch.tools import exp_deform_fused, probe_shift

    reset_counts()
    result = exp_deform_fused.run(batch=BATCH, dtype=torch.bfloat16, rounds=1, iters=5,
                                  out=lambda s: log(f"exp_deform_fused: {s}"))
    exp_counts = read_counts()
    if not result["maxdiff"] <= 5e-2 * max(1.0, result["scale"]):
        fail("exp_deform_fused: the DCN kernel's two modes disagree")
    reset_counts()
    ok = probe_shift.probe(out=lambda s: log(f"probe_shift: {s}"))
    probe_counts = read_counts()
    if not all(ok.values()):
        fail(f"probe_shift: {ok}")
    log(f"tools: launches exp_deform_fused {exp_counts}, probe_shift {probe_counts}")
    if exp_counts["deform_conv_fused"] < 1 or probe_counts["token_shift"] != 4:
        fail("the tools did not launch their kernels")
    return {"exp_deform_fused": exp_counts, "probe_shift": probe_counts}


def _scaled_weights_(model, seed: int):
    """Weights of std 1/sqrt(fan_in) so the tiny model's heatmaps are O(1)
    (the reference init's are ~1e-19); norm params and BN stats stay 1/0."""
    import torch

    from otpose_tpu_torch.models.jax_bridge import is_channel_param

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2 and not is_channel_param(name):
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p[0].numel()))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))


def tiny_agreement(joints: int = 17, dilations=None) -> dict:
    """The tiny config (at ``joints`` joints, and ``dilations`` in place of
    its own where given) on the card against the CPU's plain versions from
    the same weights: the launches the blocks' gate predicts, the seven
    outputs to 1e-3 of the peak, the decoded keypoints equal on clear
    peaks.  Returns the launches."""
    import torch

    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.models.otpose import otpose_forward
    from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

    cfg = tiny_otpose_cfg(num_joints=joints)
    if dilations is not None:
        cfg.MODEL.DEFORMABLE_CONV.DILATION = list(dilations)
    _, gpu_model = build_model(cfg, seed=2)
    _scaled_weights_(gpu_model, 2)
    _calibrate_refinement_(gpu_model, 2)
    cpu_model = copy.deepcopy(gpu_model).cpu()
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 64, 64, 15, generator=gen)
    margin = torch.tensor([[1.0, 1, 2, 2], [1, 0, 2, 0]])
    with torch.no_grad():
        want = otpose_forward(cpu_model, x, margin)
        reset_counts()
        got = otpose_forward(gpu_model, x.cuda(), margin.cuda())
        torch.cuda.synchronize()
    counts = read_counts()
    dil = gpu_model.spec.dilations
    label = f"tiny ({joints} joints, {len(dil)} dilations)"
    predicted = gate_counts(gpu_model, torch.float32, joints, dil)
    if counts != predicted:
        fail(f"{label} launches {counts}, the gate predicts {predicted}")
    worst = 0.0
    for g, w in zip(got, want):
        err = (g.cpu() - w).abs().max().item() / max(1.0, w.abs().max().item())
        worst = max(worst, err)
    log(f"{label} f32 GPU (kernels) vs CPU (plain): launches {counts}; worst error "
        f"{worst:.3e} of the peak")
    if not worst <= 1e-3:
        fail(f"{label} GPU forward disagrees with the CPU plain path")
    c_gpu = make_decoded_eval_step(gpu_model)(x.cuda(), margin.cuda())
    c_cpu = make_decoded_eval_step(cpu_model)(x, margin)
    heat = want[0].permute(0, 3, 1, 2).reshape(2, joints, -1)
    top2 = heat.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3
    same = (c_gpu[0].cpu() == c_cpu[0]).all(-1)
    log(f"{label} decoded coords equal on {int((same & clear).sum())}/{int(clear.sum())} "
        "clear peaks")
    if not bool(same[clear].all()):
        fail(f"{label} decoded coords differ between GPU and CPU")
    return counts


def _calibrate_refinement_(model, seed: int) -> float:
    """Scale the offset and mask convs so that, on a random clip, the DCN's
    offsets have a deviation of 2 pixels and its masks of 1: at the O(1)
    weight scales of ``_scaled_weights_`` the refinement's features reach the
    thousands, every sample would leave the image and the heatmaps would be
    flat.  Returns the share of the DCN's samples inside the image after."""
    import torch

    from otpose_tpu_torch.utils.testing import dcn_inside_share

    seen = {"offsets": [], "masks": []}
    hooks = [m["0"].register_forward_hook(
        lambda _m, _i, out, key=key: seen[key].append(out.float()))  # the output stays
        for key, convs in (("offsets", model.offsets_list), ("masks", model.masks_list))
        for m in convs]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w, h = model.spec.pe_w * 4, model.spec.pe_h * 4
    x = torch.randn(2, h, w, 15, generator=gen, device="cuda")
    with torch.no_grad():
        model(x, torch.ones(2, 4, device="cuda"))
        std = {key: seen[key][0].std().item() for key in seen}
        for convs, key, target in ((model.offsets_list, "offsets", 2.0),
                                   (model.masks_list, "masks", 1.0)):
            for m in convs:
                for p in m["0"].parameters():
                    p.mul_(target / std[key])
        for v in seen.values():
            v.clear()
        model(x, torch.ones(2, 4, device="cuda"))
    for hook in hooks:
        hook.remove()
    offs = seen["offsets"]
    shape = (offs[0].shape[0], model.spec.num_joints) + tuple(offs[0].shape[2:])
    inside = dcn_inside_share((torch.empty(shape, device=offs[0].device), offs, None, None, None,
                               model.spec.dilations))
    log(f"refinement calibrated: offsets' deviation {std['offsets']:.3g} -> 2, masks' "
        f"{std['masks']:.3g} -> 1; {inside:.1%} of the DCN's samples inside the image")
    if not inside > 0.5:
        fail("the calibrated refinement samples mostly outside the image")
    return inside


def _first_batch(loader):
    it = iter(loader)
    try:
        return next(it)[0]
    finally:
        it.close()


def eval_cli(seed: int = 0):
    """``Eval("validate", args).eval()`` on the card over a synthetic tree of
    64 boxes: index, window selection, metas, loader, pipelined forward,
    device decode, back-projection, json writing and poseval AP are the
    port's own code; only the frames come as arrays.  Runs: the yaml's
    ``TPU.DEVICE_PREPROCESS`` left at ``auto`` (the device loader, crops),
    ``off`` (the host loader) with four and with one loader thread, and
    ``full`` (the device warp)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from otpose_tpu_torch.cli.eval import Eval
    from otpose_tpu_torch.config import default_parse_args
    from otpose_tpu_torch.data.device_loader import DeviceLoader
    from otpose_tpu_torch.data.loader import Loader
    from otpose_tpu_torch.data.synthetic import ArrayFramesDataset, make_synthetic_posetrack
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.utils.testing import flagship_otpose_cfg

    class TimedEval(Eval):
        """Eval whose steps are bracketed by CUDA events and by the host's
        clock (the time the host spends launching a step), and which notes
        when its model was loaded (the loop starts there)."""

        def _load(self, model_file):
            model = super()._load(model_file)
            torch.cuda.synchronize()
            self.loaded_at = time.perf_counter()
            return model

        def make_step(self, model):
            step, self.events, self.launch_s = super().make_step(model), [], []

            def timed(inputs, margin):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                out = step(inputs, margin)
                end.record()
                self.launch_s.append(time.perf_counter() - t0)
                self.events.append((start, end))
                return out

            return timed

    root = tempfile.mkdtemp(prefix="otpose_eval_cli_")
    try:
        t0 = time.perf_counter()
        json_dir, img_dir, annot_dir = make_synthetic_posetrack(
            root, num_videos=4, frames_per_video=8, people_per_frame=2, img_w=640, img_h=480,
            seed=seed)
        cfg = flagship_otpose_cfg()
        cfg.EXPERIMENT_NAME = "chip_smoke"
        cfg.OUTPUT_DIR = os.path.join(root, "output")
        cfg.DATASET.NAME = "PoseTrack"
        cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR, cfg.DATASET.TEST_IMG_DIR = (
            json_dir, img_dir, img_dir)
        cfg.VAL.ANNOT_DIR = annot_dir
        cfg.VAL.USE_GT_BBOX = True
        cfg.VAL.BATCH_SIZE_PER_GPU = BATCH
        cfg.VAL.FLIP_VAL = False
        cfg.VAL.MODEL_FILE = os.path.join(root, "random_weights.pth")
        cfg.WORKERS = 4
        cfg.TPU.COMPUTE_DTYPE = "bfloat16"
        cfg.TPU.PARAM_DTYPE = "bfloat16"
        if cfg.TPU.DEVICE_PREPROCESS != "auto":
            fail(f"eval CLI: the flagship config sets TPU.DEVICE_PREPROCESS "
                 f"{cfg.TPU.DEVICE_PREPROCESS!r}, not the repository's auto")
        yaml_path = os.path.join(root, "flagship.yaml")
        with open(yaml_path, "w") as fh:
            fh.write(cfg.dump())
        _, model = build_model(cfg, seed=seed)
        _scaled_weights_(model, seed)
        _calibrate_refinement_(model, seed)
        torch.save({"state_dict": model.state_dict()}, cfg.VAL.MODEL_FILE)
        del model
        log(f"eval CLI: tree of 32 frames of 480x640 and the checkpoint written in "
            f"{time.perf_counter() - t0:.1f} s")

        # quoted: on a command line a bare off is YAML's false, not the mode
        OFF = "'off'"

        def make(opts):
            return TimedEval("validate",
                             default_parse_args(["--cfg", yaml_path, "--root_dir", root, *opts]),
                             dataset_cls=ArrayFramesDataset)

        # the device loader's first batch against the host loader's: the same
        # host warp, so the same pixels; the targets drawn on the card
        dev_b = _first_batch(make([]).loader)
        host_b = _first_batch(make(["TPU.DEVICE_PREPROCESS", OFF]).loader)
        for k in ("inputs", "target", "target_weight", "margin"):
            want = torch.from_numpy(np.asarray(host_b[k])).to("cuda")
            got = dev_b[k]
            err = (got.float() - want.float()).abs().max().item()
            if got.device.type != "cuda" or got.shape != want.shape or not err <= (
                    0.0 if k in ("inputs", "margin") else 1e-6):
                fail(f"eval CLI: the device loader's {k} is {tuple(got.shape)} on {got.device}, "
                     f"{err:.3e} from the host loader's")
        log("eval CLI: the device loader's first batch equals the host loader's on the card "
            "(inputs and margins bit-equal, targets and weights to 1e-6)")

        runs = []
        # a first run takes the process's first steps (cuDNN's choices, the
        # weight packs, the allocator's growth): full, the device warp, once
        # untimed; then auto (the device loader, crops) and off (the host
        # loader) on four loader threads, off on one thread (what the
        # loader's threads cost the thread that launches the steps), full
        for label, opts, workers, kind in (
                ("full", ["TPU.DEVICE_PREPROCESS", "full"], 4, "full"),
                ("auto", [], 4, "crops"), ("off", ["TPU.DEVICE_PREPROCESS", OFF], 4, "off"),
                ("off", ["TPU.DEVICE_PREPROCESS", OFF], 1, "off"),
                ("full", ["TPU.DEVICE_PREPROCESS", "full"], 4, "full")):
            ev = make([*opts, "WORKERS", str(workers)])
            loader_kind = (ev.loader.mode if isinstance(ev.loader, DeviceLoader)
                           else "off" if type(ev.loader) is Loader else "?")
            if loader_kind != kind:
                fail(f"eval CLI under {label}: loader {type(ev.loader).__name__} "
                     f"({loader_kind}), expected {kind}")
            kept = {}
            inner = ev.dataset.evaluate

            def spy(cfg_, preds, *args, inner=inner, kept=kept, **kwargs):
                kept["preds"] = np.array(preds)
                return inner(cfg_, preds, *args, **kwargs)

            ev.dataset.evaluate = spy
            boxes, batches = len(ev.dataset), len(ev.loader)
            if boxes < 64 or ev.batch != BATCH or ev.device.type != "cuda":
                fail(f"eval CLI: {boxes} boxes in batches of {ev.batch} on {ev.device}")
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            results = ev.eval()
            torch.cuda.synchronize()
            total, wall = time.perf_counter() - t0, time.perf_counter() - ev.loaded_at
            counts = read_counts()
            want = {k: v * batches for k, v in FORWARD_COUNTS.items()}
            if counts != want:
                fail(f"eval CLI launches {counts}, expected {want} over {batches} batches")
            if len(results) != 1 or len(ev.events) != batches:
                fail(f"eval CLI: {len(results)} results, {len(ev.events)} steps")
            _, name_values, mean_ap = results[0]
            table = np.asarray(list(name_values.values()), np.float64)
            out_dir = os.path.join(ev.cfg.OUTPUT_DIR, "val_set_json_results")
            files = sorted(os.listdir(out_dir))
            for name in files:
                with open(os.path.join(out_dir, name)) as fh:
                    if len(json.load(fh)["annolist"]) != 8:
                        fail(f"eval CLI: {name} does not hold 8 frames")
            if len(files) != 4 or files != sorted(os.listdir(annot_dir)):
                fail(f"eval CLI: json files {files}")
            if table.shape != (8,) or np.isinf(table).any() or not np.isfinite(table).any():
                fail(f"eval CLI: AP table {table}")
            if not np.nanmin(table) < 99.0 or not np.isfinite(kept["preds"]).all():
                fail(f"eval CLI: a perfect table from random weights, or non-finite "
                     f"keypoints: {table}")
            spans = [s.elapsed_time(e) * 1e-3 for s, e in ev.events]
            span = sum(spans)
            log(f"eval CLI TPU.DEVICE_PREPROCESS {label} ({kind}), {workers} loader thread(s): "
                f"{boxes} boxes; the loop (loader, {batches} steps, decode, "
                f"json, poseval) took {wall:.3f} s, {boxes / wall:.3f} boxes/s ({total:.3f} s "
                f"with the model's build and load); the steps' CUDA events span {span:.3f} s, "
                f"{span / wall:.1%} of the loop's wall time ("
                + ", ".join(f"{v:.3f}" for v in spans) + " s), and the host spent "
                + ", ".join(f"{v:.3f}" for v in ev.launch_s) + f" s launching them; launches "
                f"{counts}; AP " + " ".join(f"{k} {v:.4f}" for k, v in name_values.items()))
            runs.append(dict(counts=counts, boxes_per_s=boxes / wall, step_span_share=span / wall,
                             workers=workers, preprocess=label, loader=kind,
                             table=table, preds=kept["preds"], wall_s=wall, batches=batches))
        runs = runs[1:]   # the warm-up run's readings are not kept
        auto, off4, off1, full = runs

        def agreement(a, b):
            same = (a["preds"][..., :2] == b["preds"][..., :2]).all(-1).mean()
            diff = np.nanmax(np.abs(a["table"] - b["table"]))
            nan_same = (np.isnan(a["table"]) == np.isnan(b["table"])).all()
            return same, diff, nan_same

        same, diff, nan_same = agreement(auto, off4)
        log(f"eval CLI: auto (device loader) against off (host loader): {same:.2%} of keypoints "
            f"identical, AP tables differ by at most {diff:.3e} (limit 1e-9)")
        if not (diff <= 1e-9 and nan_same):
            fail("eval CLI: the device loader's AP table differs from the host loader's")
        # the fused attention sums its score tiles with f32 atomics, so two
        # runs differ in the last bits and a near-tied argmax may move by a
        # cell: the runs must agree on nearly every keypoint, and on the
        # table up to what those few can move
        same, diff, nan_same = agreement(off4, off1)
        log(f"eval CLI: off with one loader thread against four: {same:.2%} of keypoints "
            f"identical, AP table differs by at most {diff:.4f}")
        if not (same >= 0.98 and diff <= 1.0 and nan_same):
            fail("eval CLI: two runs on the same seed disagree")
        same, diff, _ = agreement(full, off4)
        log(f"eval CLI: full (the device warp) against off: {same:.2%} of keypoints identical, "
            f"AP tables differ by at most {diff:.4f} (no limit: float warp against the uint8 "
            f"crops); full AP " + " ".join(f"{v:.4f}" for v in full["table"]))
        return runs
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phases 10 to 13: the DCN's backward kernel and the train step
# ---------------------------------------------------------------------------

def dcn_bwd_work(args, o):
    """(bytes, operations, least ms of those operations) the DCN's backward
    needs: offsets, masks, x and g read once; d offsets, d masks and d x
    written once (d W and d bias are kilobytes).  Per sample, the matrix
    products G = W^T g (2 O) and d W += g (m s)^T (2 O), at the tensor-core
    rate of the dtype (as ``work``), and scalar f32 work: the bilinear
    sample and its two derivatives (~20), the three gradients and four d x
    corners (~12); the least time is the longer of the two."""
    import torch

    x, offs, masks = args[:3]
    b, c, h, w = x.shape
    g_bytes = b * o * h * w * x.element_size()
    moved = 2 * nbytes(*offs, *masks) + 2 * nbytes(x) + g_bytes
    samples = len(offs) * 9 * c * b * h * w
    mm_peak = PEAK_TF32 / 3 if x.dtype == torch.float32 else PEAK_BF16
    scalar, mm = samples * 32, samples * 4 * o
    return moved, scalar + mm, max(scalar / PEAK_F32, mm / mm_peak) * 1e3


def check_dcn_backward():
    """The backward kernel against the plain version's autograd at the
    flagship shape (B = 8 in f32 and bf16, B = 1 in bf16), at offsets
    calibrated so that most samples fall inside the image: each gradient's
    worst error over its peak, in bf16 the share of elements that differ,
    the kernel's ms (CUDA events around the backward launch alone) against
    the plain version's backward and the bound."""
    import torch

    from otpose_tpu_torch.ops.cuda import deform_conv
    from otpose_tpu_torch.utils.testing import dcn_case, dcn_gradients, dcn_inside_share
    from otpose_tpu_torch.utils.timing import time_ms

    names = ("x", "offsets", "masks", "weights", "biases")
    tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    gen = torch.Generator(device="cuda").manual_seed(21)
    row, worst = None, 0.0
    for batch, dtype in ((8, torch.float32), (8, torch.bfloat16), (1, torch.bfloat16)):
        args = dcn_case(batch, 17, 17, 96, 72, DCN_DILATIONS, dtype, gen)
        inside = dcn_inside_share(args)
        g = torch.randn(batch, 17, 96, 72, generator=gen, device="cuda").to(dtype)
        got = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
        want = dcn_gradients(deform_conv.modulated_deform_conv_multi_plain, args, g)
        torch.cuda.synchronize()
        d = len(DCN_DILATIONS)
        groups = lambda gr: [gr[0], torch.cat([t.flatten() for t in gr[1:1 + d]]),  # noqa: E731
                             torch.cat([t.flatten() for t in gr[1 + d:1 + 2 * d]]), gr[-2], gr[-1]]
        parts = []
        for name, gk, gp in zip(names, groups(got), groups(want)):
            err = (gk.float() - gp.float()).abs().max().item()
            peak = gp.float().abs().max().item()
            rel = err / peak
            worst = max(worst, err) if batch == 8 and dtype == torch.bfloat16 else worst
            part = f"{name} {rel:.3e}"
            if dtype == torch.bfloat16 and gk.dtype == torch.bfloat16:
                part += f" (differ {(gk != gp).float().mean().item():.3%})"
            parts.append(part)
            if not (math.isfinite(err) and peak > 0 and rel <= tol[dtype]):
                fail(f"deform_conv backward {dtype} B={batch}: d {name} err {err:.3e} over "
                     f"peak {peak:.3e}")
        log(f"check deform_conv_bwd {str(dtype)[6:]} B={batch}: {inside:.1%} of samples inside "
            f"the image; worst error over peak: " + ", ".join(parts)
            + f" (tolerance {tol[dtype]:.0e}) ok")
        again = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
        same = [torch.equal(a, b) for a, b in zip(groups(got), groups(again))]
        log(f"deform_conv_bwd {str(dtype)[6:]} B={batch}: two calls bit-equal: "
            + ", ".join(f"{n} {'yes' if ok else 'no'}" for n, ok in zip(names, same)))
        if not all(same):   # d x is an exact fixed-point sum, the rest fixed-order sums
            fail(f"deform_conv backward {dtype} B={batch}: two calls differ")
        x, offs, masks, weights, biases, dil = args
        pk = deform_conv.pack_dcn_weights(weights, biases)
        ms = time_ms(lambda: deform_conv.launch_backward(g, x, offs, masks, pk, dil), iters=10)
        leaves = [t.detach().clone().requires_grad_() for t in (x, *offs, *masks, weights, biases)]
        out = deform_conv.modulated_deform_conv_multi_plain(
            leaves[0], leaves[1:1 + d], leaves[1 + d:1 + 2 * d], leaves[-2], leaves[-1], dil)
        plain_ms = time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True),
                           iters=2, warmup=1)
        del out, leaves
        moved, ops, t_ops = dcn_bwd_work(args, 17)
        t_bytes = moved / PEAK_BYTES * 1e3
        bound = max(t_bytes, t_ops)
        log(f"time deform_conv_bwd {str(dtype)[6:]} B={batch}: kernel {ms:.4f} ms, plain backward "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({moved / 1e6:.1f} MB, {ops / 1e9:.2f} "
            f"GFLOP; {bound / ms:.1%} of it)")
        key = f"{str(dtype)[6:]} B={batch}"
        if row is None:
            row = dict(name="deform_conv_bwd", route="cuda",
                       source="otpose_tpu_torch/csrc/deform_conv_bwd.cu",
                       replaces="otpose_tpu/ops/deform_conv.py:276", launches=None,
                       max_abs_err=None, ms=None, plain_ms=None, bound_ms=None,
                       bound_by=None, library_ms=None, ms_by_case={}, plain_ms_by_case={},
                       bound_ms_by_case={}, inside_share_by_case={}, bit_equal={})
        row["ms_by_case"][key], row["plain_ms_by_case"][key] = ms, plain_ms
        row["bound_ms_by_case"][key], row["inside_share_by_case"][key] = bound, inside
        row["bit_equal"][key] = dict(zip(names, same))
        if batch == 8 and dtype == torch.bfloat16:
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
    row["max_abs_err"] = worst
    return row


def synthetic_train_batch(cfg, batch: int, gen, labelled: float = 0.6):
    """A train batch on the card: random frames and margins, Gaussian targets
    from ``ops/heatmap.py::generate_heatmaps`` at random joints.  Joints
    17 * labelled onwards are invisible in every clip (weight 0, no peak), so
    the loss's batch-global test finds some joints labelled and some not."""
    import numpy as np
    import torch

    from otpose_tpu_torch.ops.heatmap import generate_heatmaps

    rng = np.random.RandomState(int(torch.randint(0, 2 ** 31, (1,), generator=gen,
                                                  device=gen.device)))
    w, h = cfg.MODEL.IMAGE_SIZE
    j = cfg.MODEL.NUM_JOINTS
    targets, weights = [], []
    for _ in range(batch):
        joints = np.zeros((j, 3))
        joints[:, 0] = rng.uniform(8, w - 8, j)
        joints[:, 1] = rng.uniform(8, h - 8, j)
        vis = np.zeros((j, 3))
        vis[:int(j * labelled), 0] = 1.0
        t, tw = generate_heatmaps(joints, vis, cfg.MODEL.SIGMA, cfg.MODEL.IMAGE_SIZE,
                                  cfg.MODEL.HEATMAP_SIZE, j)
        targets.append(t.transpose(1, 2, 0))
        weights.append(tw)
    dev = dict(device="cuda")
    return {"inputs": torch.randn(batch, h, w, 15, generator=gen, **dev),
            "margin": torch.randint(0, 3, (batch, 4), generator=gen, **dev).float(),
            "target": torch.from_numpy(np.stack(targets)).to(**dev),
            "target_weight": torch.from_numpy(np.stack(weights)).to(**dev)}


def _train_run(label, step, batch, steps, warmup, micro):
    """``steps`` train steps after ``warmup`` ones, each timed by CUDA events,
    with its metrics, launches and peak memory."""
    import torch

    want = {k: v * micro for k, v in TRAIN_COUNTS.items()}
    for _ in range(warmup):
        step(batch)
    torch.cuda.synchronize()
    times, counts, first = [], None, None
    for i in range(steps):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        metrics = step(batch)
        end.record()
        torch.cuda.synchronize()
        counts = read_counts()
        ms = start.elapsed_time(end)
        times.append(ms)
        vals = {k: v.item() for k, v in metrics.items()}
        first = vals if first is None else first
        b = batch["inputs"].shape[0]
        log(f"train {label} step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in vals.items())
            + f"; {ms:.2f} ms, {b / ms * 1e3:.3f} clips/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches {counts}")
        if len(vals) != 6 or not all(math.isfinite(v) for v in vals.values()):
            fail(f"train {label}: metrics {vals}")
        if counts != want:
            fail(f"train {label}: launches {counts} a step, expected {want}")
    return dict(ms=times, clips_per_s=[batch["inputs"].shape[0] / t * 1e3 for t in times],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, counts=counts,
                first=first)


def flagship_train(card: str):
    """The flagship train step (``configs/17/model_RSN.yaml``, full width and
    depth, reference init, synthetic batches) on one model and optimizer:
    bf16 at B = 8 (2 warm-up steps, 5 timed), f32 at B = 2 (3 steps), one
    step at B = 16 with ``TPU.ACCUM_STEPS 2``.  The LR comes from
    ``make_schedule`` with 1 iteration an epoch: lr(t) = t * LR / 11 in the
    warm-up, > 0 from the second update on.  Then every trainable parameter
    must hold a finite gradient and every BN running stat must have moved.
    Before that, one step each in bf16 and f32 from copies of the initial
    model on one B = 2 batch and one dropout seed: the two first-step
    losses."""
    import torch

    from otpose_tpu_torch.config import get_cfg
    from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
    from otpose_tpu_torch.engine.trainer import make_train_step
    from otpose_tpu_torch.models.core import BatchNorm
    from otpose_tpu_torch.models.factory import build_model

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs/17/model_RSN.yaml"))
    spec, model = build_model(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(31)
    b2 = synthetic_train_batch(cfg, cfg.TRAIN.BATCH_SIZE_PER_GPU, gen)
    first = {}
    for dtype in ("bfloat16", "float32"):
        twin = copy.deepcopy(model)
        step = make_train_step(twin, make_optimizer(twin, cfg, make_schedule(cfg, 1)),
                               compute_dtype=dtype,
                               generator=torch.Generator(device="cuda").manual_seed(5))
        first[dtype] = step(b2)["final_loss"].item()
        del twin, step
    rel = abs(first["bfloat16"] - first["float32"]) / abs(first["float32"])
    log(f"train first-step loss on one B=2 batch: bf16 {first['bfloat16']:.6g}, f32 "
        f"{first['float32']:.6g} (relative difference {rel:.3e})")
    if not rel <= 5e-2:
        fail("train: the bf16 first-step loss is far from the f32 one")

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers() if "running" in n}
    opt = make_optimizer(model, cfg, make_schedule(cfg, 1))
    tgen = torch.Generator(device="cuda").manual_seed(7)
    runs = {}
    for label, dtype, batch, steps, warmup, accum in (
            ("bf16 B=8", "bfloat16", 8, 5, 2, 1),
            ("f32 B=2", "float32", cfg.TRAIN.BATCH_SIZE_PER_GPU, 3, 0, 1),
            ("bf16 B=16 ACCUM_STEPS 2", "bfloat16", 16, 1, 0, 2)):
        step = make_train_step(model, opt, compute_dtype=dtype, accum_steps=accum,
                               generator=tgen)
        runs[label] = _train_run(label, step, synthetic_train_batch(cfg, batch, gen), steps,
                                 warmup, accum)
        r = runs[label]
        log(f"train {label}: median {sorted(r['ms'])[len(r['ms']) // 2]:.2f} ms a step, "
            f"{max(r['clips_per_s']):.3f} clips/s at best, peak {r['peak_gib']:.2f} GiB ({card})")
    bad = [n for n, p in model.named_parameters()
           if p.requires_grad and (p.grad is None or not torch.isfinite(p.grad).all())]
    if bad:
        fail(f"train: {len(bad)} trainable parameters without a finite gradient, e.g. {bad[:3]}")
    moved = sum(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    still = [n for n, b in model.named_buffers() if n in stats and torch.equal(b, stats[n])]
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    log(f"train: every one of {len(before)} parameters has a finite gradient; {moved} moved "
        f"after {opt.count} updates; {len(stats) - len(still)} of {len(stats)} running stats "
        f"({n_bn} BN layers) moved")
    if still or moved < 0.9 * len(before):
        fail(f"train: running stats {still[:3]} did not move, or only {moved} parameters did")
    return runs


def tiny_train_agreement():
    """The tiny spec in f32 with weights of std 1/sqrt(fan_in), conditioned
    for gradients (``utils/testing.py::condition_for_gradients_``: every BN
    bias raised by 3, so no ReLU input sits within f32 rounding of the
    kink, and HRNet's final conv rescaled so the losses stay O(1)), the
    mask convs calibrated, the offset convs zeroed and the dropout rates at
    0.  The gradients of one forward and backward on the card (the DCN's
    forward and backward kernels) and on the CPU (plain versions), the
    CPU's also in f64 as the witness; then one SGD step (no weight decay)
    on each, whose update is the momentum buffer, the clipped gradient.
    Each gradient, however small beside the largest, is held to 1e-3 of its
    own peak three ways: card against CPU, card against f64, and the
    card's update against the CPU's.  A tensor whose f32 gradient is itself
    ill-conditioned on this input (the CPU's misses the f64 one by more than
    1e-3 of the peak: a sum that cancels, such as an encoder's output bias
    whose shift the next batch-statistics BN removes but for the image
    border) passes if the card is no farther from f64 than twice the CPU;
    at most 5% of the tensors may, and they are printed.  Gradients that
    are zero in exact arithmetic (f64 peak under 1e-12 of the largest) are
    f32 residue, held to 1e-6 of the largest.  Zero offsets put every
    sample exactly on a pixel, so rounding moves none across the bilinear
    derivative's jump at integer positions (``check_dcn_backward`` holds
    the kernel at fractional positions)."""
    import torch

    from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
    from otpose_tpu_torch.engine.trainer import make_train_step
    from otpose_tpu_torch.models.blocks import set_drop_rates
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.utils.testing import (condition_for_gradients_, loss_gradients,
                                                tiny_otpose_cfg)

    cfg = tiny_otpose_cfg()
    cfg.TRAIN.OPTIMIZER, cfg.TRAIN.WARMUP, cfg.TRAIN.WD = "SGD", False, 0.0
    _, gpu_model = build_model(cfg, seed=4)
    _scaled_weights_(gpu_model, 4)
    set_drop_rates(gpu_model)
    gen = torch.Generator(device="cuda").manual_seed(9)
    batch = synthetic_train_batch(cfg, 2, gen)
    condition_for_gradients_(gpu_model, batch["inputs"], batch["margin"])
    _calibrate_refinement_(gpu_model, 4)
    with torch.no_grad():
        for m in gpu_model.offsets_list:
            m["0"].weight.zero_()
    cpu_model = copy.deepcopy(gpu_model).cpu()
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    # the unclipped gradients, on copies of the models before the step
    grads = {dev: {n: g.detach().cpu() for n, g in loss_gradients(m, b)[2].items()}
             for dev, m, b in (("cuda", gpu_model, batch), ("cpu", cpu_model, cpu_batch))}
    loss64, _, exact = loss_gradients(cpu_model, cpu_batch, torch.float64)
    results = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        opt = make_optimizer(model, cfg, make_schedule(cfg, 4))
        step = make_train_step(model, opt)
        reset_counts()
        metrics = step(batch if dev == "cuda" else cpu_batch)
        counts = read_counts()
        state = opt.opt.state
        results[dev] = dict(
            counts=counts, loss=metrics["final_loss"].item(),
            updates={n: state[p]["momentum_buffer"].cpu() for n, p in model.named_parameters()})
    if results["cuda"]["counts"] != TRAIN_COUNTS:
        fail(f"tiny train step launches {results['cuda']['counts']}")
    top64 = max(g.abs().max().item() for g in exact.values())
    top_u = max(u.abs().max().item() for u in results["cpu"]["updates"].values())
    zeros, strict, exempt, bad, worst = [], 0, [], [], (0.0, "")
    for n, w in exact.items():
        card, cpu = grads["cuda"][n].double(), grads["cpu"][n].double()
        u_card, u_cpu = results["cuda"]["updates"][n], results["cpu"]["updates"][n]
        if w.abs().max().item() <= 1e-12 * top64:
            zeros.append(n)
            if not (card.abs().max().item() <= 1e-6 * top64
                    and u_card.abs().max().item() <= 1e-6 * top_u):
                bad.append((n, "zero in exact arithmetic"))
            continue
        peak = w.abs().max().item()
        e_card = (card - w).abs().max().item() / peak
        e_cpu = (cpu - w).abs().max().item() / peak
        e_pair = (card - cpu).abs().max().item() / peak
        e_upd = (u_card - u_cpu).abs().max().item() / u_cpu.abs().max().item()
        err = max(e_card, e_pair, e_upd)
        worst = max(worst, (err, n))
        if err <= 1e-3:
            strict += 1
        elif e_card <= 2 * e_cpu:
            exempt.append((n, e_card, e_cpu))
        else:
            bad.append((n, e_card, e_cpu, e_pair, e_upd))
    live = len(exact) - len(zeros)
    log("tiny train step f32 GPU (kernels) vs CPU (plain), CPU f64 the witness: loss "
        f"{results['cuda']['loss']:.6g} / {results['cpu']['loss']:.6g} / {loss64:.6g}; "
        f"{strict} of {live} gradients (and their updates) within 1e-3 of their peak on all "
        f"three counts, worst {worst[0]:.3e} ({worst[1]}); {len(exempt)} where f32 itself "
        "misses 1e-3 and the card is no farther from f64 than twice the CPU ("
        + ", ".join(f"{n} {c:.2e} vs {p:.2e}" for n, c, p in exempt[:4]) + f"); {len(zeros)} "
        f"zero in exact arithmetic; launches {results['cuda']['counts']}")
    if bad or len(exempt) > 0.05 * live:
        fail(f"tiny train step disagrees between the card and the CPU: {bad[:5]}, "
             f"{len(exempt)} exempt")


def check_grad_refusals():
    """F1 on the card: the kernels without a backward raise on a CUDA tensor
    that requires grad."""
    import torch

    from otpose_tpu_torch.ops.cuda import fused_attn, fused_mlp, token_shift

    gen = torch.Generator(device="cuda").manual_seed(8)
    a = attn_case(torch.float32, gen, 1)
    m = mlp_case(torch.float32, gen, 64, 1)
    x = torch.randn(4, 64, device="cuda")
    for name, fn, args in (("fused_attn_ct", fused_attn.fused_attn_ct, a),
                           ("fused_mlp_residual_ct", fused_mlp.fused_mlp_residual_ct, m),
                           ("token_shift", token_shift.token_shift, [x, "right"])):
        try:
            fn(args[0].clone().requires_grad_(), *args[1:])
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            fail(f"{name} ran on a CUDA tensor that requires grad")
    log("F1: fused_attn_ct, fused_mlp_residual_ct and token_shift raise under grad on the card")


# ---------------------------------------------------------------------------
# phase 14: the train CLI
# ---------------------------------------------------------------------------

def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _host_state(trainer):
    """The numbers a resumed run must reproduce, on the host: the model's
    ``state_dict`` (weights and BN statistics), the optimizer's state by
    parameter and its update count."""
    import torch

    sd = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    opt = trainer.optimizer.opt
    moments = [{k: v.detach().cpu().clone() if torch.is_tensor(v) else v
                for k, v in opt.state[p].items()} for p in trainer.optimizer.params]
    return sd, moments, trainer.optimizer.count


def _state_diff(a, b):
    """(bit-equal, worst max|diff| / peak over the tensors, its name)."""
    import torch

    (sd_a, mom_a, n_a), (sd_b, mom_b, n_b) = a, b
    pairs = [(k, v, sd_b[k]) for k, v in sd_a.items()]
    pairs += [(f"optimizer[{i}].{k}", v, mb[k]) for i, (ma, mb) in enumerate(zip(mom_a, mom_b))
              for k, v in ma.items()]
    equal, worst = n_a == n_b and len(mom_a) == len(mom_b), (0.0, "")
    for name, x, y in pairs:
        if torch.equal(x, y):
            continue
        equal = False
        peak = max(x.abs().max().item(), 1e-30)
        worst = max(worst, ((x.float() - y.float()).abs().max().item() / peak, name))
    return equal, worst[0], worst[1]


def train_cli(card: str):
    """Phase 14: ``cli/train.py::Train`` at flagship width and depth
    (``configs/17/model_RSN.yaml`` as it is: bf16, ``BATCH_SIZE_PER_GPU`` 2,
    ``DEVICE_PREPROCESS auto``, so the device loader in crops mode) over a
    synthetic PoseTrack tree of 32 train and 32 val boxes read through
    ``ArrayFramesDataset``, from a reference-layout ``.pth`` of random
    reference-init weights as ``MODEL.PRETRAINED``, ``TRAIN.END_EPOCH 2``,
    ``--sigma_schedule 1``; cuDNN deterministic.  Then the eval CLI on the
    best checkpoint, the save timings, and a run in a fresh folder that
    sends itself SIGTERM after five steps and a new ``Train`` that resumes
    it, held to the uninterrupted run bit for bit."""
    import shutil
    import signal
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from otpose_tpu_torch.cli import train as train_mod
    from otpose_tpu_torch.cli.eval import Eval
    from otpose_tpu_torch.cli.train import Train
    from otpose_tpu_torch.config import default_parse_args, get_cfg
    from otpose_tpu_torch.data.device_loader import DeviceLoader
    from otpose_tpu_torch.data.synthetic import ArrayFramesDataset, make_synthetic_posetrack
    from otpose_tpu_torch.engine import checkpoints as ckpt
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.ops.heatmap import generate_heatmaps

    class KeptPreds(ArrayFramesDataset):
        """``ArrayFramesDataset`` that keeps the keypoints of every
        evaluation, in order."""

        kept = []

        def evaluate(self, cfg_, preds, *a, **k):
            KeptPreds.kept.append(np.array(preds))
            return super().evaluate(cfg_, preds, *a, **k)

    class TimedTrain(Train):
        """Train whose steps are bracketed by CUDA events and launch counts
        (their six metrics and their targets' mass a labelled joint kept
        on the card until the run ends), whose validation batches are
        counted and whose validations are timed, with the weight packs they
        make and whether an asynchronous save was still being written when
        they ended; it sends itself SIGTERM after ``stop_after`` steps."""

        def __init__(self, args, stop_after=None):
            super().__init__(args, dataset_cls=KeptPreds)
            self.steps, self.val_batches, self.validations = [], [], []
            step, evaluate = self.step_fn, self.eval_fn

            def timed_step(batch):
                before = read_counts()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                metrics = step(batch)
                end.record()
                # read after the run: a boolean index here would wait for the card
                self.steps.append(dict(events=(start, end), counts=_delta(before, read_counts()),
                                       metrics=torch.stack(list(metrics.values())),
                                       names=list(metrics), sigma=self.train_dataset.sigma,
                                       mass=batch["target"].sum((1, 2)),
                                       labelled=batch["target_weight"][..., 0] > 0))
                if len(self.steps) == stop_after:
                    os.kill(os.getpid(), signal.SIGTERM)
                return metrics

            def counted_eval(inputs, margin):
                before = read_counts()
                out = evaluate(inputs, margin)
                self.val_batches.append(_delta(before, read_counts()))
                return out

            self.step_fn, self.eval_fn = timed_step, counted_eval

        def _validate(self, tb_steps):
            torch.cuda.synchronize()
            packs, t0 = read_packs(), time.perf_counter()
            mean_ap = super()._validate(tb_steps)
            torch.cuda.synchronize()
            thread = ckpt._WRITER._thread
            self.validations.append(dict(
                seconds=time.perf_counter() - t0, packs=_delta(packs, read_packs()),
                boxes=len(self._val_dataset),
                save_pending=thread is not None and thread.is_alive()))
            return mean_ap

    phase_t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="otpose_train_cli_")
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        json_dir, img_dir, annot_dir = make_synthetic_posetrack(
            root, num_videos=2, frames_per_video=8, people_per_frame=2, img_w=640, img_h=480,
            seed=3)
        cfg = get_cfg()
        cfg.merge_from_file(os.path.join(ROOT, "configs/17/model_RSN.yaml"))
        if (cfg.TRAIN.BATCH_SIZE_PER_GPU, cfg.TPU.COMPUTE_DTYPE, cfg.TPU.DEVICE_PREPROCESS) != (
                2, "bfloat16", "auto"):
            fail("train CLI: configs/17/model_RSN.yaml no longer sets batch 2, bf16 and auto")
        cfg.OUTPUT_DIR = os.path.join(root, "output")
        cfg.DATASET.NAME = "PoseTrack"
        cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR, cfg.DATASET.TEST_IMG_DIR = (
            json_dir, img_dir, img_dir)
        cfg.VAL.ANNOT_DIR = annot_dir
        cfg.VAL.USE_GT_BBOX = True
        cfg.TRAIN.END_EPOCH = 2
        cfg.MODEL.PRETRAINED = os.path.join(root, "pretrained.pth")
        yaml_path = os.path.join(root, "model_RSN.yaml")
        with open(yaml_path, "w") as fh:
            fh.write(cfg.dump())
        _, model = build_model(cfg, seed=1)
        n_params = sum(1 for _ in model.parameters())
        torch.save({"state_dict": model.state_dict()}, cfg.MODEL.PRETRAINED)
        del model

        def args(name, *opts):
            return default_parse_args(["--sigma_schedule", "1", "--cfg", yaml_path, "--root_dir",
                                       root, "EXPERIMENT_NAME", name, *opts])

        validations, epochs, saves, resumes = [], [], [], []
        KeptPreds.kept.clear()

        def spy_eval(inner):
            def run(*a, **k):
                out = inner(*a, **k)
                validations.append(out)
                return out
            return run

        def timed_epoch(inner):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner(*a, **k)
                torch.cuda.synchronize()
                epochs.append(time.perf_counter() - t0)
                return out
            return run

        def timed_save(inner):
            def run(*a, **k):
                t0 = time.perf_counter()
                out = inner(*a, **k)
                saves.append((k.get("async_save", False), (time.perf_counter() - t0) * 1e3))
                return out
            return run

        def timed_resume(inner):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner(*a, **k)
                torch.cuda.synchronize()
                resumes.append((time.perf_counter() - t0) * 1e3)
                return out
            return run

        patch = mock.patch.object
        with patch(train_mod, "evaluate_epoch_decoded",
                   spy_eval(train_mod.evaluate_epoch_decoded)), \
                patch(train_mod, "train_epoch", timed_epoch(train_mod.train_epoch)), \
                patch(ckpt, "save_checkpoint", timed_save(ckpt.save_checkpoint)), \
                patch(ckpt, "resume", timed_resume(ckpt.resume)):
            # -------------------------------------------- the uninterrupted run
            t0 = time.perf_counter()
            tr = TimedTrain(args("whole"))
            build_s = time.perf_counter() - t0
            if not (isinstance(tr.loader, DeviceLoader) and tr.loader.mode == "crops"
                    and tr.device.type == "cuda" and tr.batch_size == 2):
                fail(f"train CLI: loader {type(tr.loader).__name__}, device {tr.device}, "
                     f"batch {tr.batch_size}")
            if tr.pretrained_loaded != n_params:
                fail(f"train CLI: {tr.pretrained_loaded} of {n_params} pretrained tensors loaded")
            iters = len(tr.loader)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            tr.train()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = read_counts()
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            steps, val_batches = tr.steps, tr.val_batches
            want = {k: TRAIN_COUNTS[k] * len(steps) + FORWARD_COUNTS[k] * len(val_batches)
                    for k in counts}
            if len(steps) != 2 * iters or len(tr.validations) != 2 or counts != want:
                fail(f"train CLI: {len(steps)} steps, {len(tr.validations)} validations, "
                     f"launches {counts}, expected {want}")
            bad = [i for i, s in enumerate(steps) if s["counts"] != TRAIN_COUNTS]
            bad_val = [c for c in val_batches if c != FORWARD_COUNTS]
            if bad or bad_val:
                fail(f"train CLI: launches a step {steps[bad[0]]['counts'] if bad else ''} or a "
                     f"validation batch {bad_val[:1]}, expected {TRAIN_COUNTS} and "
                     f"{FORWARD_COUNTS}")
            metrics = torch.stack([s["metrics"] for s in steps]).cpu()
            if metrics.shape[1] != 6 or not torch.isfinite(metrics).all():
                fail(f"train CLI: step metrics {steps[0]['names']} not all finite: {metrics}")
            pack_want = {k: FORWARD_COUNTS[k] for k in ("fused_attn", "fused_mlp", "deform_conv")}
            if any(v["packs"] != pack_want for v in tr.validations):
                fail(f"train CLI: weight packs a validation {[v['packs'] for v in tr.validations]}"
                     f", expected one a block {pack_want}")

            # targets: epoch 1 drawn at sigma - 1 (the mass of a whole
            # Gaussian, the median over a step's labelled joints)
            hm_w, hm_h = cfg.MODEL.HEATMAP_SIZE
            full = {}
            for sigma in (cfg.MODEL.SIGMA, cfg.MODEL.SIGMA - 1):
                joint = np.asarray([[cfg.MODEL.IMAGE_SIZE[0] / 2, cfg.MODEL.IMAGE_SIZE[1] / 2, 0]])
                t, _ = generate_heatmaps(joint, np.ones((1, 3)), sigma, cfg.MODEL.IMAGE_SIZE,
                                         cfg.MODEL.HEATMAP_SIZE, 1)
                full[sigma] = float(t.sum())
            ratios = []
            for i, s in enumerate(steps):
                want_sigma = cfg.MODEL.SIGMA - (i >= iters)
                ratio = s["mass"][s["labelled"]].median().item() / full[want_sigma]
                ratios.append(ratio)
                if s["sigma"] != want_sigma or abs(ratio - 1) > 0.05:
                    fail(f"train CLI step {i}: the dataset's sigma {s['sigma']}, the targets' "
                         f"mass {ratio:.4f} of a sigma-{want_sigma} Gaussian's")
            log(f"train CLI: targets at sigma {cfg.MODEL.SIGMA} in epoch 0 and "
                f"{cfg.MODEL.SIGMA - 1} in epoch 1: a labelled joint's median mass "
                f"{min(ratios):.4f}-{max(ratios):.4f} of the whole Gaussian's "
                f"({full[cfg.MODEL.SIGMA]:.2f}, {full[cfg.MODEL.SIGMA - 1]:.2f})")

            files = sorted(os.listdir(tr.checkpoints_save_folder))
            bests = [f for f in files if f.startswith("best_mAP_")]
            if len(bests) != 1 or files[1:] != ["epoch_0_state", "epoch_1_state"]:
                fail(f"train CLI: checkpoints {files}")
            spans = [s["events"][0].elapsed_time(s["events"][1]) * 1e-3 for s in steps]
            loop_s = sum(epochs)
            clips = len(steps) * tr.batch_size
            boxes = sum(v["boxes"] for v in tr.validations)
            val_s = sum(v["seconds"] for v in tr.validations)
            names = steps[0]["names"]
            log(f"train CLI (configs/17/model_RSN.yaml, {cfg.TPU.COMPUTE_DTYPE}, "
                f"B={tr.batch_size}, the device loader, {tr.loader.mode}): built and the "
                f"pretrained .pth loaded ({tr.pretrained_loaded} of {n_params} parameter "
                f"tensors) in {build_s:.3f} s; {len(steps)} steps in 2 epochs, the train loops "
                f"{loop_s:.3f} s, {clips / loop_s:.4f} clips/s, the steps' CUDA events span "
                f"{sum(spans):.3f} s, {sum(spans) / loop_s:.1%} of the loops' wall time (median "
                f"step {sorted(spans)[len(spans) // 2] * 1e3:.2f} ms); "
                f"validation {boxes} boxes in {val_s:.3f} s, {boxes / val_s:.4f} boxes/s "
                f"(" + ", ".join(f"{v['seconds']:.3f} s" for v in tr.validations) + "); the "
                f"epoch saves returned in " + ", ".join(f"{ms:.1f} ms" for _, ms in saves)
                + f" (async), still being written when validation ended: "
                + ", ".join(str(v["save_pending"]) for v in tr.validations) + f"; the whole "
                f"run {run_s:.3f} s; peak memory {peak_gib:.2f} GiB; launches a step "
                f"{steps[0]['counts']}, a validation batch {val_batches[0]}; packs a validation "
                f"{tr.validations[0]['packs']}; first step "
                + ", ".join(f"{k} {v:.6g}" for k, v in zip(names, metrics[0].tolist()))
                + "; last step "
                + ", ".join(f"{k} {v:.6g}" for k, v in zip(names, metrics[-1].tolist()))
                + f" ({card})")

            # ------------------------------------ the eval CLI on the best
            best = os.path.join(tr.checkpoints_save_folder, bests[0])
            best_ap = ckpt._parse_best(bests[0])
            found = [nv for nv, ap in validations if ap == best_ap]
            ev = Eval("validate", args("whole", "VAL.MODEL_FILE", best), dataset_cls=KeptPreds)
            (_, name_values, mean_ap), = ev.eval()
            got = np.asarray(list(name_values.values()), np.float64)
            want_table = np.asarray(list(found[0].values()), np.float64) if found else None
            diff = np.nanmax(np.abs(got - want_table)) if found else float("nan")
            log(f"train CLI: the eval CLI on {bests[0]}: AP "
                + " ".join(f"{k} {v:.4f}" for k, v in name_values.items())
                + f"; the validation's table differs by at most {diff:.3e} (limit 1e-9)")
            if not (found and diff <= 1e-9
                    and (np.isnan(got) == np.isnan(want_table)).all() and mean_ap == best_ap):
                fail("train CLI: the eval CLI on the best checkpoint does not reproduce its "
                     "validation's AP table")
            # the fused attention adds its score tiles with f32 atomics, so a
            # near-tied argmax may move by a cell between two runs
            best_i = next(i for i, (_, ap) in enumerate(validations) if ap == best_ap)
            mine, theirs = KeptPreds.kept[-1], KeptPreds.kept[best_i]
            same = (mine[..., :2] == theirs[..., :2]).all(-1).mean()
            peak = np.abs(theirs[..., 2]).max()
            maxval_err = np.abs(mine[..., 2] - theirs[..., 2]).max() / peak
            log(f"train CLI: the eval CLI's keypoints against that validation's: {same:.2%} of "
                f"coordinates identical, max values to {maxval_err:.3e} of their peak "
                f"({peak:.4g}), {len(np.unique(theirs[..., 2]))} distinct max values")
            if not (same >= 0.98 and maxval_err <= 1e-3 and len(np.unique(theirs[..., 2])) > 1):
                fail("train CLI: the eval CLI on the best checkpoint does not reproduce its "
                     "validation's keypoints")
            del ev

            # ------------------------------------------------ save timings
            folder = os.path.join(root, "save_timing")
            timing = []
            for async_save in (False, True, False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = ckpt.save_checkpoint(folder, 0, tr.train_state,
                                            tensorboard_global_steps=1, async_save=async_save)
                back = (time.perf_counter() - t0) * 1e3
                ckpt.wait_for_saves()
                timing.append((async_save, back, (time.perf_counter() - t0) * 1e3))
            size_mb = os.path.getsize(os.path.join(path, ckpt.STATE_FILE)) / 2 ** 20
            log("train CLI: an epoch checkpoint of " + f"{size_mb:.1f} MiB: "
                + "; ".join(f"{'async' if a else 'sync'} returned in {b:.1f} ms, committed in "
                            f"{c:.1f} ms" for a, b, c in timing))
            whole = _host_state(tr)
            whole_meta = ckpt.restore_checkpoint(
                os.path.join(tr.checkpoints_save_folder, "epoch_1_state"))["meta"]
            del tr
            torch.cuda.empty_cache()

            # ------------------------------------------ preempt and resume
            resumes.clear()
            pre = TimedTrain(args("preempted"), stop_after=5)
            pre.train()
            pre_files = sorted(os.listdir(pre.checkpoints_save_folder))
            meta = ckpt.restore_checkpoint(
                os.path.join(pre.checkpoints_save_folder, "epoch_0_state"))["meta"]
            if len(pre.steps) != 5 or pre_files != ["epoch_0_state"] or meta != {
                    "begin_epoch": 0, "tensorboard_global_steps": 5, "iteration": 5}:
                fail(f"train CLI preempted: {len(pre.steps)} steps, {pre_files}, meta {meta}")
            del pre
            torch.cuda.empty_cache()
            res = TimedTrain(args("preempted"))
            res.train()
            res_meta = ckpt.restore_checkpoint(
                os.path.join(res.checkpoints_save_folder, "epoch_1_state"))["meta"]
            resumed = _host_state(res)
            if len(res.steps) != 2 * iters - 5 or res_meta != whole_meta:
                fail(f"train CLI resumed: {len(res.steps)} steps, meta {res_meta} against "
                     f"{whole_meta}")
            del res
            torch.cuda.empty_cache()
            equal, worst, where = _state_diff(whole, resumed)
            log(f"train CLI: SIGTERM after 5 steps checkpointed epoch 0 at iteration 5; resumed "
                f"in {resumes[-1]:.1f} ms (the state read and loaded), the run went on for "
                f"{2 * iters - 5} steps; its weights, BN statistics, optimizer moments and "
                f"count ({resumed[2]}) and TensorBoard steps "
                f"({res_meta['tensorboard_global_steps']}) against the uninterrupted run's: "
                + ("bit-equal" if equal else f"max |diff| / peak {worst:.3e} ({where})"))
            if not equal:
                # the rule for an op left non-deterministic: no farther than
                # two uninterrupted runs are from each other
                torch.cuda.empty_cache()
                again = TimedTrain(args("whole_again"))
                again.train()
                twin = _host_state(again)
                del again
                equal2, worst2, where2 = _state_diff(whole, twin)
                log(f"train CLI: two uninterrupted runs: "
                    + ("bit-equal" if equal2 else f"max |diff| / peak {worst2:.3e} ({where2})"))
                if not worst <= worst2:
                    fail("train CLI: the resumed run is farther from the uninterrupted one "
                         "than two uninterrupted runs are from each other")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
        shutil.rmtree(root, ignore_errors=True)
    log(f"train CLI phase: {time.perf_counter() - phase_t0:.1f} s")
    return dict(step=steps[0]["counts"], val_batch=val_batches[0], clips_per_s=clips / loop_s,
                span_share=sum(spans) / loop_s, val_boxes_per_s=boxes / val_s,
                save_ms=timing, resume_ms=resumes[-1], peak_gib=peak_gib, bit_equal=equal)


# ---------------------------------------------------------------------------
# phase 15: export and serving
# ---------------------------------------------------------------------------

def _backend_flags(torch) -> None:
    """The numerics every process of this script runs with: no TF32, and
    plain bf16 products accumulated in f32 throughout, as the kernels do."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def serve_worker(artifact: str, clips: str, out: str) -> None:
    """A fresh process (``chip_smoke.py --serve-worker``): load ``artifact``
    on the card with ``load_exported``, which must import no model code;
    wait until ``out + ".go"`` exists (the caller's sign that the card is
    free: the loads of phase 15's processes overlap, their calls do not);
    one counted call on ``clips``; then clips/s over 5 calls.  Writes the
    outputs and the readings to ``out`` (``.npz`` and ``.json``)."""
    import numpy as np
    import torch

    _backend_flags(torch)
    t0 = time.perf_counter()
    from otpose_tpu_torch.engine.export import load_exported

    model = load_exported(artifact)
    load_s = time.perf_counter() - t0
    models = sorted(n for n in sys.modules if n.startswith("otpose_tpu_torch.models"))
    with np.load(clips) as z:
        inputs = torch.from_numpy(z["inputs"]).cuda()
        margin = torch.from_numpy(z["margin"]).cuda()
    deadline = time.perf_counter() + 900
    while not os.path.exists(out + ".go"):
        if time.perf_counter() > deadline:
            sys.exit("serve worker: no go within 900 s")
        time.sleep(0.05)
    model(inputs, margin)                     # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    reset_counts()
    packs = read_packs()
    outs = model(inputs, margin)
    torch.cuda.synchronize()
    counts, packed = read_counts(), _delta(packs, read_packs())
    iters = 5
    t1 = time.perf_counter()
    for _ in range(iters):
        model(inputs, margin)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t1) / iters
    np.savez(out + ".npz", *[o.float().cpu().numpy() for o in outs])
    with open(out + ".json", "w") as fh:
        json.dump(dict(load_s=load_s, counts=counts, packs=packed, models=models,
                       clips_per_s=inputs.shape[0] / sec, ms=sec * 1e3, meta=model.meta), fh)


def _start_worker(artifact: str, clips: str, out: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                             "--serve-worker", artifact, clips, out], cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _finish_worker(proc: subprocess.Popen, artifact: str, out: str, timeout: int = 600) -> dict:
    """Let the worker ``proc`` call its model (``serve_worker``) and read
    what it wrote."""
    open(out + ".go", "w").close()
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"serve worker on {artifact}: no answer within {timeout} s")
    if proc.returncode != 0:
        fail(f"serve worker on {artifact}: rc {proc.returncode}\n{err[-4000:]}")
    with open(out + ".json") as fh:
        res = json.load(fh)
    import numpy as np

    with np.load(out + ".npz") as z:
        res["outs"] = [z[f"arr_{i}"] for i in range(len(z.files))]
    return res


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _check_bit_equal(label: str, got, live) -> None:
    """Served outputs against the live step's on the same clips: every
    kernel and cuDNN sum in a fixed order, so they must be the same bits."""
    import numpy as np

    if not all(np.array_equal(g, w) for g, w in zip(got, live)):
        gap = max(float(np.abs(g - w).max()) for g, w in zip(got, live))
        same = float((got[0] == live[0]).all(-1).mean())
        fail(f"served {label}: differs from the live step by up to {gap:.3e}, coords "
             f"identical on {same:.2%} of the joints")
    log(f"served {label}: coords, maxvals and raw_coords bit-equal to the live step")


def _http(url: str, body: bytes | None = None, timeout: int = 300):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npz_bytes(inputs, margin) -> bytes:
    import io

    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, inputs=inputs, margin=margin)
    return buf.getvalue()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start_serve_tool(artifact: str):
    """``otpose_tpu_torch/tools/serve.py::main`` on a local port, in a
    process with this script's numerics flags, so that its answers can be
    held bit-equal to the fresh process's: (process, port, start time)."""
    port = _free_port()
    launcher = ("import sys, torch\n"
                "from chip_smoke import _backend_flags\n"
                "_backend_flags(torch)\n"
                "from otpose_tpu_torch.tools.serve import main\n"
                "main(sys.argv[1:])\n")
    proc = subprocess.Popen([sys.executable, "-c", launcher, "--artifact", artifact, "--port",
                             str(port)], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, port, time.perf_counter()


def _wait_listening(proc: subprocess.Popen, t0: float) -> float:
    """Seconds from the serve tool's start until it listens (its load and
    one warm-up call)."""
    import select

    deadline = time.perf_counter() + 600
    line = ""
    while "serving" not in line:
        if proc.poll() is not None:
            fail(f"serve tool exited with {proc.returncode}: {proc.stderr.read()[-4000:]}")
        if time.perf_counter() > deadline:
            fail("serve tool did not start listening within 600 s")
        ready, _, _ = select.select([proc.stdout], [], [], 5)
        if ready:
            line = proc.stdout.readline()
    return time.perf_counter() - t0


def _serve_requests(port: int, ready_s: float, clips, margin, want) -> dict:
    """Requests to the listening serve tool: 1, 5 and 16 clips (each row
    equal to the fresh process's answer on the same clips) and one of 17,
    which it must reject; the latency of 1 and 16 clips over HTTP, median
    of 5 requests each."""
    import numpy as np

    url = f"http://127.0.0.1:{port}"
    status, meta = _http(url + "/health")
    if status != 200 or meta.get("batch_size") != BATCH:
        fail(f"serve /health: {status} {meta}")
    names = ("coords", "maxvals", "raw_coords")
    latency = {}
    for n in (1, 5, 16):
        body = _npz_bytes(clips[:n], margin[:n])
        times = []
        for _ in range(5 if n in (1, 16) else 1):
            t1 = time.perf_counter()
            status, reply = _http(url + "/predict", body)
            times.append((time.perf_counter() - t1) * 1e3)
            if status != 200:
                fail(f"serve: a request of {n} clips answered {status}: {reply}")
        for name, w in zip(names, want):
            if not np.array_equal(np.asarray(reply[name], np.float32), w[:n]):
                fail(f"serve: {name} of a request of {n} clips differs from the artifact's "
                     "answer on the same clips")
        latency[n] = sorted(times)[len(times) // 2]
    over = np.concatenate([clips, clips[:1]])
    status, reply = _http(url + "/predict", _npz_bytes(over, np.concatenate([margin,
                                                                           margin[:1]])))
    if status != 400 or "exported batch" not in reply.get("error", ""):
        fail(f"serve: a request of 17 clips answered {status}: {reply}")
    log(f"serve tool: listening {ready_s:.1f} s after its start (load and one warm-up "
        f"call, beside the two workers' loads); requests of 1, 5 and 16 clips answered, each "
        f"row equal to the artifact's own answer; 17 clips rejected with 400 "
        f"({reply['error']}); latency over HTTP {latency[1]:.2f} ms at 1 clip, "
        f"{latency[16]:.2f} ms at 16 (median of 5)")
    return dict(ready_s=ready_s, latency_ms=latency)


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _tiny_export_on_cpu() -> None:
    """A tiny artifact (heatmaps and teacher, f32) traced on the card and
    loaded on the CPU, held against the card's answers (1e-3 of the peak, as
    phase 8), and the card's load bit-equal to the live step."""
    import shutil
    import tempfile

    import torch

    from otpose_tpu_torch.engine.export import export_eval, load_exported, save_exported
    from otpose_tpu_torch.engine.trainer import make_eval_step
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

    spec, model = build_model(tiny_otpose_cfg(), seed=2)
    _scaled_weights_(model, 2)
    _calibrate_refinement_(model, 2)
    root = tempfile.mkdtemp(prefix="otpose_tiny_export_")
    try:
        out = save_exported(root, export_eval(model, batch_size=2, decoded=False), spec,
                            batch_size=2, compute_dtype=torch.float32, flip=False,
                            decoded=False)
        gen = torch.Generator().manual_seed(4)
        x = torch.randn(2, 64, 64, 15, generator=gen)
        margin = torch.tensor([[1.0, 1, 2, 2], [1, 0, 2, 0]])
        on_card = load_exported(out)(x, margin)
        live = make_eval_step(model)(x.cuda(), margin.cuda())
        if not all(torch.equal(a, b) for a, b in zip(on_card, live)):
            fail("tiny artifact on the card differs from the live step")
        t0 = time.perf_counter()
        on_cpu = load_exported(out, device="cpu")
        load_s = time.perf_counter() - t0
        got = on_cpu(x, margin)
        worst = max((g - w.cpu()).abs().max().item() / max(1.0, w.abs().max().item())
                    for g, w in zip(got, on_card))
        log(f"tiny artifact traced on the card, loaded on the CPU in {load_s:.1f} s "
            f"(move_to_device_pass): worst error against the card's answers {worst:.3e} of "
            f"the peak; the card's load bit-equal to the live step")
        if not (got[0].device.type == "cpu" and worst <= 1e-3):
            fail("the tiny artifact on the CPU disagrees with the card's answers")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def start_serving() -> dict:
    """Phase 15's first half, run just before phase 16 so that its slow host
    work overlaps that phase's: ``python -m otpose_tpu_torch.cli.export`` on
    ``configs/17/model_RSN.yaml`` (bf16 compute, ``TPU.PARAM_DTYPE
    bfloat16``) from a reference-layout ``.pth`` of random reference-init
    weights, a baked artifact at B = 16 and an external-weights one at
    B = 1, the two exports started at once; the clips; a thread that starts
    the serve tool and the two fresh processes the moment both exports have
    ended (``_load_when_exported``), so their loads overlap phase 16 too;
    the tiny export beside them.  ``serving`` finishes the phase.  Every
    process started here is stopped at exit, whatever fails."""
    import atexit
    import tempfile

    import numpy as np
    import torch

    from otpose_tpu_torch.config import get_cfg
    from otpose_tpu_torch.models.factory import build_model

    st = dict(phase_t0=time.perf_counter(), root=tempfile.mkdtemp(prefix="otpose_export_"),
              lock=threading.Lock(), stopped=False, exports={}, export_s={}, workers=[])
    atexit.register(_stop_serving, st)
    root = st["root"]
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs/17/model_RSN.yaml"))
    if cfg.TPU.COMPUTE_DTYPE != "bfloat16" or cfg.VAL.FLIP_VAL:
        fail("export: configs/17/model_RSN.yaml no longer sets bf16 without the flip")
    cfg.OUTPUT_DIR = os.path.join(root, "output")
    cfg.VAL.MODEL_FILE = os.path.join(root, "random_weights.pth")
    yaml_path = os.path.join(root, "model_RSN.yaml")
    with open(yaml_path, "w") as fh:
        fh.write(cfg.dump())
    _, model = build_model(cfg, seed=5)
    torch.save({"state_dict": model.state_dict()}, cfg.VAL.MODEL_FILE)
    arts = {16: os.path.join(root, "artifact_b16"), 1: os.path.join(root, "artifact_b1")}
    gen = torch.Generator(device="cuda").manual_seed(6)
    w, h = cfg.MODEL.IMAGE_SIZE
    inputs = torch.randn(BATCH, h, w, 15, generator=gen, device="cuda")
    margin = torch.randint(0, 3, (BATCH, 4), generator=gen, device="cuda").float()
    clips, clips1 = os.path.join(root, "clips.npz"), os.path.join(root, "clips1.npz")
    np.savez(clips, inputs=inputs.cpu().numpy(), margin=margin.cpu().numpy())
    np.savez(clips1, inputs=inputs[:1].cpu().numpy(), margin=margin[:1].cpu().numpy())
    st.update(cfg=cfg, model=model, arts=arts, inputs=inputs, margin=margin,
              out16=os.path.join(root, "served16"), out1=os.path.join(root, "served1"),
              clips=clips, clips1=clips1, t0=time.perf_counter())
    with st["lock"]:
        st["exports"] = {b: subprocess.Popen(
            [sys.executable, "-m", "otpose_tpu_torch.cli.export", "--cfg", yaml_path,
             "--root_dir", root, "--batch", str(b), "--out", arts[b], "--weights",
             "baked" if b == BATCH else "external", "TPU.PARAM_DTYPE", "bfloat16"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for b in arts}
    # each CLI's lines with the seconds since the start at which they came
    st["lines"] = lines = {b: [] for b in st["exports"]}
    st["readers"] = [threading.Thread(target=lambda b, out: lines[b].extend(
        (time.perf_counter() - st["t0"], text) for text in out), args=(b, proc.stdout),
        daemon=True) for b, proc in st["exports"].items()]
    for reader in st["readers"]:
        reader.start()
    st["loader"] = threading.Thread(target=_load_when_exported, args=(st,), daemon=True)
    st["loader"].start()
    _tiny_export_on_cpu()
    return st


def _load_when_exported(st: dict) -> None:
    """``start_serving``'s thread: wait for both export CLIs; when both
    have ended well, start the serve tool and the two fresh processes,
    which load at once and use the card only when ``serving`` lets them."""
    for b, proc in st["exports"].items():
        proc.wait()
        st["export_s"][b] = time.perf_counter() - st["t0"]
    if any(proc.returncode != 0 for proc in st["exports"].values()):
        return
    with st["lock"]:
        if st["stopped"]:
            return
        st["tool"] = _start_serve_tool(st["arts"][16])
        st["workers"] = [_start_worker(st["arts"][16], st["clips"], st["out16"]),
                         _start_worker(st["arts"][1], st["clips1"], st["out1"])]


def _stop_serving(st: dict) -> None:
    """Stop every process ``start_serving`` started, and remove its files."""
    import shutil

    with st["lock"]:
        st["stopped"] = True
        tool = st.get("tool")
        for proc in [*st["exports"].values(), *([tool[0]] if tool else []), *st["workers"]]:
            _stop(proc)
    shutil.rmtree(st["root"], ignore_errors=True)


def serving(card: str, st: dict) -> dict:
    """Phase 15's second half, after phase 16 (``start_serving`` started
    it): each artifact loaded in a fresh process and held against the live
    ``make_decoded_eval_step`` on the same clips; the B = 16 one must launch
    12 / 16 / 1 kernels and make no pack a call, and its clips/s is read
    beside the live step's; the serve tool over the B = 16 artifact answers
    requests.  The three processes loaded at once, and now use the card one
    after another."""
    import torch

    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
    from otpose_tpu_torch.models.otpose import prepare_eval_params

    t_after = time.perf_counter()
    try:
        st["loader"].join(timeout=900)
        if st["loader"].is_alive():
            fail("export CLIs: no end within 900 s")
        arts, lines, export_s = st["arts"], st["lines"], st["export_s"]
        for (b, proc), reader in zip(st["exports"].items(), st["readers"]):
            reader.join(timeout=60)
            if proc.returncode != 0:
                fail(f"export CLI at batch {b}: rc {proc.returncode}\n"
                     + "".join(text for _, text in lines[b])[-4000:])
            marks = {m: next((f"{t:.1f}" for t, text in lines[b] if m in text), "none")
                     for m in ("=> exporting", "=> loaded", "=> wrote")}
            log(f"export CLI at batch {b}: its log's '=> exporting' (config read), '=> loaded' "
                f"(model built, checkpoint loaded) and '=> wrote' (traced and saved) lines at "
                + ", ".join(marks.values()) + " s after the start")
        sizes = {b: _dir_bytes(a) for b, a in arts.items()}
        log(f"export CLI (the two at once, beside the tiny export and, in a whole run, phase "
            f"16): batch 16 "
            f"baked done {export_s[16]:.1f} s, {sizes[16]} bytes; batch 1 external done "
            f"{export_s[1]:.1f} s, {sizes[1]} bytes "
            f"({os.path.getsize(os.path.join(arts[1], 'otpose_eval.pt2'))} in the program)")

        model, inputs, margin = st["model"], st["inputs"], st["margin"]
        prepare_eval_params(model, torch.bfloat16)
        step = make_decoded_eval_step(model, compute_dtype=torch.bfloat16)

        # the serve tool and the two fresh processes loaded at once; now each
        # uses the card alone: the tool's warm-up, the B = 16 process's
        # calls, the B = 1 process's, the live step's, the requests
        tool, port, tool_t0 = st["tool"]
        workers = st["workers"]
        ready_s = _wait_listening(tool, tool_t0)
        served = _finish_worker(workers[0], arts[16], st["out16"])
        served1 = _finish_worker(workers[1], arts[1], st["out1"])
        live = [t.float().cpu().numpy() for t in step(inputs, margin)]
        live1 = [t.float().cpu().numpy() for t in step(inputs[:1], margin[:1])]
        iters = 5
        step(inputs, margin)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(iters):
            step(inputs, margin)
        torch.cuda.synchronize()
        live_rate = BATCH * iters / (time.perf_counter() - t1)
        serve = _serve_requests(port, ready_s, inputs.cpu().numpy(), margin.cpu().numpy(),
                                served["outs"])
    finally:
        _stop_serving(st)
    log(f"served B=16 (fresh process): loaded in {served['load_s']:.1f} s, launches "
        f"{served['counts']}, weight packs in the call {served['packs']}, model modules "
        f"imported {served['models']}; {served['clips_per_s']:.3f} clips/s "
        f"({served['ms']:.2f} ms a call) against the live step's {live_rate:.3f} clips/s "
        f"in this call ({card})")
    if served["counts"] != FORWARD_COUNTS:
        fail(f"served artifact launches {served['counts']}, expected {FORWARD_COUNTS}")
    if any(served["packs"].values()) or served["models"]:
        fail("the served call packed weights or the loader imported model code")
    if served["meta"]["fused"] is not True or served["meta"]["weights"] != "baked":
        fail(f"served manifest {served['meta']}")
    _check_bit_equal("B=16 baked", served["outs"], live)
    log(f"served B=1 external (fresh process): loaded in {served1['load_s']:.1f} s, "
        f"launches {served1['counts']}, packs {served1['packs']}, "
        f"{served1['ms']:.2f} ms a call")
    if served1["counts"] != FORWARD_COUNTS or any(served1["packs"].values()):
        fail(f"served B=1 launches {served1['counts']}, packs {served1['packs']}")
    _check_bit_equal("B=1 external", served1["outs"], live1)
    now = time.perf_counter()
    log(f"export and serving phase: {now - st['phase_t0']:.1f} s from the exports' start, "
        f"{now - t_after:.1f} s of it after phase 16")
    return dict(counts=served["counts"], counts_b1=served1["counts"],
                clips_per_s=served["clips_per_s"], live_clips_per_s=live_rate,
                export_s=export_s, bytes=sizes, load_s=(served["load_s"], served1["load_s"]),
                **serve)


# ---------------------------------------------------------------------------
# phase 16: data parallel on the card
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_TIMEOUT = 600


def _flagship_cfg():
    from otpose_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs/17/model_RSN.yaml"))
    return cfg


def _seed0_model(cfg):
    """The flagship model from seed 0, built once a process: the phase's
    models are copies of it (the reference init's draws take seconds on a
    host that several ranks share)."""
    from otpose_tpu_torch.models.factory import build_model

    return build_model(cfg, seed=0)[1]


def _train_model(base, state=None):
    """A copy of ``base`` (``_seed0_model``) with its dropout rates at 0,
    or with the weights and buffers of ``state``."""
    from otpose_tpu_torch.models.blocks import set_drop_rates

    model = set_drop_rates(copy.deepcopy(base))
    if state is not None:
        model.load_state_dict(state)
    return model


def _sgd(cfg):
    """``cfg`` with SGD at a constant LR and no weight decay: the f32
    comparisons of phase 16 hold each update to the gradients it is made
    of (AdamW's first step is about lr * sign(g), which turns rounding in a
    gradient that is zero but for rounding into a full step)."""
    cfg = cfg.clone()
    cfg.TRAIN.OPTIMIZER, cfg.TRAIN.WD, cfg.TRAIN.WARMUP = "SGD", 0.0, False
    return cfg


def _eval_model(base, dtype: str):
    """A copy of ``base`` (``_seed0_model``) as the eval CLI prepares it:
    bf16 weights for a bf16 step."""
    import torch

    from otpose_tpu_torch.models.otpose import prepare_eval_params

    return prepare_eval_params(copy.deepcopy(base),
                               torch.bfloat16 if dtype == "bfloat16" else None)


def _host_sd(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _digest(model) -> str:
    """A hash of every bit of ``model``'s weights and buffers."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dp_steps(model, cfg, dtype: str, batch, steps: int = 2, states=None):
    """``steps`` train steps of ``model`` on ``batch`` (this rank's rows) with
    a new optimizer, each timed by CUDA events after a barrier: the metrics,
    ms, launches, device-group collectives and peak memory of each, and the
    optimizer; ``states``, a list, gets the host state after each step."""
    import torch

    from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
    from otpose_tpu_torch.engine.trainer import make_train_step
    from otpose_tpu_torch.parallel import distributed

    opt = make_optimizer(model, cfg, make_schedule(cfg, 1))
    step = make_train_step(model, opt, compute_dtype=dtype,
                           generator=torch.Generator(device="cuda").manual_seed(5))
    out = []
    for _ in range(steps):
        distributed.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        before = distributed.COUNTS["device"]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        metrics = step(batch)
        end.record()
        torch.cuda.synchronize()
        out.append(dict(metrics={k: v.item() for k, v in metrics.items()},
                        ms=start.elapsed_time(end), counts=read_counts(),
                        collectives=distributed.COUNTS["device"] - before,
                        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
        if states is not None:
            states.append(_host_sd(model))
    return out, opt


def _ms(steps) -> str:
    return " / ".join(f"{s['ms']:.2f}" for s in steps)


def _dist_start(task: str, spec: dict, tag: str, world: int = DP_WORLD):
    """``world`` ranks of ``chip_smoke.py --dist-worker task`` on a free
    port, sharing the card, with ``spec`` written beside their outputs."""
    path = spec["out"].replace("%d", f"{tag}_spec") + ".json"
    with open(path, "w") as fh:
        json.dump(spec, fh)
    port = _free_port()
    base = dict(os.environ, OTPOSE_COORDINATOR=f"127.0.0.1:{port}",
                OTPOSE_NUM_PROCESSES=str(world))
    return [subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                              "--dist-worker", task, path], cwd=ROOT,
                             env=dict(base, OTPOSE_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _dist_wait(procs, spec: dict, what: str) -> list:
    """Each rank's exit within ``DP_TIMEOUT`` seconds and its results; any
    failure kills every rank and fails the run."""
    logs, deadline = [], time.monotonic() + DP_TIMEOUT
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        fail(f"data parallel {what}: a rank did not finish within {DP_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode != 0 for p in procs):
        # every rank's log, those that exited 0 too: the first to fail need
        # not be rank 0, and a peer that left early is part of the story
        fail(f"data parallel {what}: " + "\n".join(
            f"rank {r} exited with {p.returncode}\n{out[-4000:]}"
            for r, (p, out) in enumerate(zip(procs, logs))))
    results = []
    for r in range(len(procs)):
        with open(spec["out"] % r) as fh:
            results.append(json.load(fh))
    return results


def dist_worker(task: str, spec_path: str) -> None:
    """A rank of phase 16 or 19 (``chip_smoke.py --dist-worker TASK SPEC``,
    with ``OTPOSE_COORDINATOR`` / ``OTPOSE_NUM_PROCESSES`` /
    ``OTPOSE_PROCESS_ID`` set): ``steps`` (the train steps and the sharded
    decoded eval), ``cli`` (the train CLI), ``seq_eval`` or ``seq_train``
    (phase 19's sequence-parallel eval and train).  Writes its results to
    ``spec["out"] % rank``."""
    import torch

    from otpose_tpu_torch.parallel import distributed

    _backend_flags(torch)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    with open(spec_path) as fh:
        spec = json.load(fh)
    try:
        out = {"steps": _worker_steps, "cli": _worker_cli, "seq_eval": _worker_seq_eval,
               "seq_train": _worker_seq_train}[task](spec)
    finally:
        # the rank's collectives by group, in its log: a failed run prints
        # every rank's log, so ranks that ran different collectives show it
        print(f"collectives {dict(distributed.COUNTS)}", flush=True)
        distributed.shutdown()
    with open(spec["out"] % out["rank"], "w") as fh:
        json.dump(out, fh)


def _worker_steps(spec: dict) -> dict:
    """The two-rank train steps (f32 at a global B = 2, bf16 at B = 8) and
    the sharded decoded eval (bf16 and f32, B = 16 and B = 5)."""
    import numpy as np
    import torch

    from otpose_tpu_torch.engine.runner import _pipelined_forward, _to_host
    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
    from otpose_tpu_torch.parallel import distributed
    from otpose_tpu_torch.parallel.mesh import make_eval_shard_fn, make_mesh, replicate

    cfg = _flagship_cfg()
    rank, world = distributed.maybe_initialize(cfg)
    out = dict(rank=rank, world=world, transport=distributed.device_transport())
    batches = torch.load(spec["batches"], weights_only=True)
    base = _seed0_model(cfg)
    for dtype in ("float32", "bfloat16"):
        # f32: the parent's calibrated model (``_dp_one_rank``); bf16: the
        # reference init, as the yaml trains it
        state = torch.load(spec["model"], weights_only=True) if dtype == "float32" else None
        model = replicate(_train_model(base, state))
        full = batches[dtype]
        rows = distributed.local_rows(len(full["inputs"]))
        batch = {k: v[rows].cuda() for k, v in full.items()}
        states = [] if dtype == "float32" and rank == 0 else None
        steps, _ = _dp_steps(model, _sgd(cfg) if dtype == "float32" else cfg, dtype, batch,
                             states=states)
        out[dtype] = dict(steps=steps, rows=rows.tolist(), digest=_digest(model))
        if states:
            torch.save(states, spec["state"])
        del model, states
        torch.cuda.empty_cache()

    clips = torch.load(spec["clips"], weights_only=True)
    shard_fn = make_eval_shard_fn(make_mesh(cfg))
    for dtype in ("bfloat16", "float32"):
        step = make_decoded_eval_step(_eval_model(base, dtype), compute_dtype=dtype)
        step(clips["inputs"][:1].cuda(), clips["margin"][:1].cuda())     # the packs
        counts = []

        def counted(inputs, margin, step=step, counts=counts):
            torch.cuda.synchronize()
            reset_counts()
            outs = step(inputs, margin)
            torch.cuda.synchronize()
            counts.append(read_counts())
            return outs

        loader = [({"inputs": clips["inputs"][:n].cuda(), "margin": clips["margin"][:n].cuda()},
                   None) for n in (BATCH, 5)]
        outs = [o for o, _, _ in _pipelined_forward(
            loader, counted, lambda o: tuple(_to_host(t) for t in o), "cuda", shard_fn)]
        out[f"eval_{dtype}"] = dict(counts=counts)
        if rank == 0:
            np.savez(spec["eval"] % dtype, *[a for o in outs for a in o])
    return out


def _worker_cli(spec: dict) -> dict:
    """``cli/train.py::Train(...).train()`` over the synthetic tree, rank
    ``spec["sigterm_rank"]`` sending itself SIGTERM after
    ``spec["sigterm_after"]`` steps: steps, launches, checkpoint writes,
    the validation's table (rank 0's keypoints to ``spec["preds"]``) and a
    digest of the final state."""
    import signal

    import numpy as np
    import torch

    from otpose_tpu_torch.cli import train as train_mod
    from otpose_tpu_torch.cli.train import Train
    from otpose_tpu_torch.config import default_parse_args
    from otpose_tpu_torch.data.synthetic import ArrayFramesDataset
    from otpose_tpu_torch.engine import checkpoints as ckpt
    from otpose_tpu_torch.parallel import distributed

    writes, validations, kept = [], [], []
    commit, evaluate = ckpt._commit, train_mod.evaluate_epoch_decoded

    class KeptPreds(ArrayFramesDataset):
        """Keeps the keypoints that rank 0 scores."""

        def evaluate(self, cfg_, preds, *a, **k):
            kept.append(np.array(preds))
            return super().evaluate(cfg_, preds, *a, **k)

    def counted_commit(path, payload):
        writes.append(os.path.basename(path))
        commit(path, payload)

    def kept_eval(*a, **k):
        result = evaluate(*a, **k)
        validations.append(result)
        return result

    ckpt._commit, train_mod.evaluate_epoch_decoded = counted_commit, kept_eval
    args = default_parse_args(["--cfg", spec["cfg"], "--root_dir", spec["root"],
                               "EXPERIMENT_NAME", spec["name"]])
    tr = Train(args, dataset_cls=KeptPreds)
    rank = distributed.process_info()[0]
    steps, val_batches = [], []
    step, evaluate_fn = tr.step_fn, tr.eval_fn

    def counted_step(batch):
        before = read_counts()
        metrics = step(batch)
        steps.append(dict(loss=metrics["final_loss"].item(), counts=_delta(before, read_counts())))
        if rank == spec.get("sigterm_rank") and len(steps) == spec["sigterm_after"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return metrics

    def counted_eval(inputs, margin):
        before = read_counts()
        outs = evaluate_fn(inputs, margin)
        val_batches.append(_delta(before, read_counts()))
        return outs

    tr.step_fn, tr.eval_fn = counted_step, counted_eval
    t0 = time.perf_counter()
    tr.train()
    torch.cuda.synchronize()
    if kept:
        np.save(spec["preds"], kept[-1])
    return dict(rank=rank, transport=distributed.device_transport(), steps=steps,
                val_batches=val_batches, writes=writes, seconds=time.perf_counter() - t0,
                files=sorted(os.listdir(tr.checkpoints_save_folder)),
                folder=tr.checkpoints_save_folder, batch_size=tr.batch_size,
                loader=f"{type(tr.loader).__name__} {getattr(tr.loader, 'mode', '')}",
                validations=[[nv, ap] for nv, ap in validations], digest=_digest(tr.model),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def _dp_one_rank(cfg, base, batch2, card: str) -> dict:
    """Item 1: the f32 train step at B = 2 for two steps (SGD, ``_sgd``)
    from the same model without a group and in a one-rank NCCL group made
    in this process: bit-equal losses, weights and BN statistics.  The
    model's refinement is calibrated (``_calibrate_refinement_``): at the
    reference init its offsets are a tiny fraction of a pixel, every sample
    sits on a pixel and the bilinear derivative's jump there makes the
    offset convs' gradients, and the gradient norm, differ by 2e-4 between
    two f32 runs.
    A third run without a group on the two rows swapped shows the f32
    spread."""
    import torch

    from otpose_tpu_torch.models.core import BatchNorm
    from otpose_tpu_torch.parallel import distributed

    model = _train_model(base)
    _calibrate_refinement_(model, 16)
    initial = _host_sd(model)
    runs = {}
    for label in ("swapped", "plain", "grouped"):
        if label == "grouped":
            env = {"OTPOSE_COORDINATOR": f"127.0.0.1:{_free_port()}",
                   "OTPOSE_NUM_PROCESSES": "1", "OTPOSE_PROCESS_ID": "0"}
            distributed.maybe_initialize(env=env, device="cuda")
        order = [1, 0] if label == "swapped" else [0, 1]
        twin = copy.deepcopy(model)
        states = []
        steps, _ = _dp_steps(twin, _sgd(cfg), "float32", {k: v[order] for k, v in batch2.items()},
                             states=states)
        runs[label] = dict(steps=steps, states=states, transport=distributed.device_transport())
        del twin
        torch.cuda.empty_cache()
        if label == "grouped":
            # one collective alone: the host's time to issue it and the card's
            t = torch.zeros(2, 256, device="cuda")
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            for _ in range(200):
                distributed.all_reduce_(t)
            end.record()
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            runs[label]["one_us"] = (host_us, start.elapsed_time(end) / 200 * 1e3)
    distributed.shutdown()
    plain, grouped = runs["plain"], runs["grouped"]
    equal = ([s["metrics"] for s in plain["steps"]] == [s["metrics"] for s in grouped["steps"]]
             and all(torch.equal(v, grouped["states"][-1][k])
                     for k, v in plain["states"][-1].items()))
    per_micro = grouped["steps"][0]["collectives"]
    # a BN layer's statistics forward and backward, the two losses' labelled
    # tests, the PCK meter, the gradients, the metrics
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    want = 2 * n_bn + 5
    log(f"data parallel, one rank in a {grouped['transport'][0]} group "
        f"({grouped['transport'][1]}), f32 B=2, two steps, cuDNN deterministic, dropout 0: "
        f"losses, weights and BN statistics "
        + ("bit-equal to the same steps without a group" if equal else "DIFFER from the steps "
           "without a group")
        + f"; {per_micro} device collectives a micro-batch (2 x {n_bn} BN layers + 5 expected; "
        f"{plain['steps'][0]['collectives']} without a group); ms a step "
        f"{_ms(grouped['steps'])} with the group, {_ms(plain['steps'])} without; one "
        f"all-reduce of (2, 256) f32 alone {grouped['one_us'][0]:.1f} µs of host and "
        f"{grouped['one_us'][1]:.1f} µs of the card's "
        f"span ({card})")
    if grouped["transport"][0] != "nccl" or not equal or per_micro != want:
        fail("data parallel: the one-rank NCCL run is not the single-process run")
    return dict(initial=initial, plain=plain, grouped=grouped, swapped=runs["swapped"])


def data_parallel(card: str) -> dict:
    """Phase 16: the port's data parallelism on the card.  Item 1 (one rank,
    NCCL, in this process), then two ranks sharing the card (``gloo`` device
    group) as ``--dist-worker`` processes: the train steps and the sharded
    decoded eval against this process's single-process runs, then the train
    CLI (uninterrupted, and preempted by a SIGTERM to rank 1 alone, at once;
    then the resume), checked against a single-process eval CLI."""
    import shutil
    import tempfile

    import torch

    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step

    phase_t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="otpose_dp_")
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        cfg = _flagship_cfg()
        gen = torch.Generator(device="cuda").manual_seed(41)
        batches = {"float32": synthetic_train_batch(cfg, cfg.TRAIN.BATCH_SIZE_PER_GPU, gen),
                   "bfloat16": synthetic_train_batch(cfg, 8, gen)}
        base = _seed0_model(cfg)
        one = _dp_one_rank(cfg, base, batches["float32"], card)
        torch.save({d: {k: v.cpu() for k, v in b.items()} for d, b in batches.items()},
                   os.path.join(root, "batches.pt"))
        torch.save(one["initial"], os.path.join(root, "model.pt"))
        w, h = cfg.MODEL.IMAGE_SIZE
        clips = {"inputs": torch.randn(BATCH, h, w, 15, generator=gen, device="cuda"),
                 "margin": torch.randint(0, 3, (BATCH, 4), generator=gen,
                                         device="cuda").float()}
        torch.save({k: v.cpu() for k, v in clips.items()}, os.path.join(root, "clips.pt"))
        refs = {}
        for dtype in ("bfloat16", "float32"):
            step = make_decoded_eval_step(_eval_model(base, dtype), compute_dtype=dtype)
            refs[dtype] = [[_to_numpy(o) for o in step(clips["inputs"][:n], clips["margin"][:n])]
                           for n in (BATCH, 5)]
            del step
        torch.cuda.empty_cache()

        # ---------------------------- two ranks: train steps, sharded eval
        spec = {k: os.path.join(root, v) for k, v in (
            ("batches", "batches.pt"), ("model", "model.pt"), ("clips", "clips.pt"),
            ("state", "rank0.pt"), ("eval", "eval_%s.npz"), ("out", "steps_%d.json"))}
        t0 = time.perf_counter()
        ranks = _dist_wait(_dist_start("steps", spec, "steps"), spec, "steps")
        steps_s = time.perf_counter() - t0
        _dp_train_checks(cfg, one, ranks, torch.load(spec["state"], weights_only=True), card)
        _dp_eval_checks(ranks, refs, spec, card)

        # ------------------------------------------- two ranks: the CLI
        cli = _dp_cli(cfg, root, card)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
        shutil.rmtree(root, ignore_errors=True)
    log(f"data parallel phase: {time.perf_counter() - phase_t0:.1f} s (the steps' and eval "
        f"workers {steps_s:.1f} s)")
    return dict(train=ranks[0]["bfloat16"]["steps"][0]["counts"],
                eval=ranks[0]["eval_bfloat16"]["counts"][0], cli=cli)


def _to_numpy(t):
    return t.float().cpu().numpy()


def _dp_train_checks(cfg, one, ranks, rank0, card: str) -> None:
    """Item 2: the two ranks against the single-process f32 run and each
    other; the bf16 steps finite, bit-equal across the ranks, with 0 / 0 /
    1 / 1 launches a micro-batch."""
    import torch

    r0, r1 = ranks
    if [r["transport"][0] for r in ranks] != ["gloo"] * DP_WORLD:
        fail(f"data parallel: two ranks on one card took {r0['transport']}")
    plain, swapped = one["plain"], one["swapped"]
    worst_ms = [max((abs(a["metrics"][k] / b["metrics"][k] - 1), k) for k in b["metrics"]
                    if b["metrics"][k]) for a, b in zip(r0["float32"]["steps"], plain["steps"])]
    worst_m = max(m for m, _ in worst_ms)
    spread = [max(abs(a["metrics"][k] / b["metrics"][k] - 1) for k in b["metrics"]
                  if b["metrics"][k]) for a, b in zip(swapped["steps"], plain["steps"])]
    initial = one["initial"]
    # each tensor's update after each step against the single-process run's:
    # 1e-3 of its peak plus 1e-6 of the largest update's (phase 13's rule, for
    # gradients that are residues, as a conv bias's before train BN is)
    worst = []
    for got, want in zip(rank0, plain["states"]):
        refs = {k: want[k] - initial[k] for k, v in got.items() if v.is_floating_point()}
        top = max(r.abs().max().item() for r in refs.values())
        ratios = sorted((((got[k] - initial[k] - ref).abs().max().item()
                          / (1e-3 * ref.abs().max().item() + 1e-6 * top)), k)
                        for k, ref in refs.items() if ref.abs().max() > 0)
        worst.append(ratios[::-1][:5])
    log(f"data parallel, two ranks sharing the card ({r0['transport'][0]}: "
        f"{r0['transport'][1]}), f32 SGD, global B=2 (1 a rank), two steps: metrics against the "
        f"single-process steps to {' / '.join(f'{m:.3e} ({k})' for m, k in worst_ms)} relative "
        f"in the two steps (limit 2e-4; the single-process run on the rows swapped: "
        f"{' / '.join(f'{m:.3e}' for m in spread)}); each tensor's update (weights and "
        f"running stats) against its limit (1e-3 of its peak plus 1e-6 of the largest), the "
        f"five worst after step 1: "
        + ", ".join(f"{k} {r:.3g}" for r, k in worst[0]) + "; after step 2: "
        + ", ".join(f"{k} {r:.3g}" for r, k in worst[1]) + "; the ranks' weights and BN "
        f"statistics " + ("bit-equal" if r0["float32"]["digest"] == r1["float32"]["digest"]
                          else "DIFFER"))
    if not (worst_m <= 2e-4 and all(w[0][0] <= 1 for w in worst)
            and r0["float32"]["digest"] == r1["float32"]["digest"]):
        fail("data parallel: the two-rank f32 steps are not the single-process steps")
    bf = [r["bfloat16"]["steps"] for r in ranks]
    finite = all(math.isfinite(v) for s in bf for st in s for v in st["metrics"].values())
    counts_ok = all(st["counts"] == TRAIN_COUNTS for s in bf for st in s)
    log(f"data parallel, two ranks sharing the card, bf16, global B=8 (4 a rank), two steps: "
        f"metrics {bf[0][-1]['metrics']}; the ranks "
        + ("bit-equal" if r0["bfloat16"]["digest"] == r1["bfloat16"]["digest"] else "DIFFER")
        + f"; launches a rank a micro-batch {bf[0][0]['counts']}; "
        f"{bf[0][0]['collectives']} device collectives a micro-batch; ms a step "
        + "; ".join(f"rank {r}: f32 {_ms(ranks[r]['float32']['steps'])}, bf16 {_ms(bf[r])}"
                    for r in range(DP_WORLD))
        + "; peak memory "
        + ", ".join(f"rank {r} {max(s['peak_gib'] for s in bf[r]):.2f} GiB"
                    for r in range(DP_WORLD))
        + f". Two processes share one card here, so these times are no scaling number ({card})")
    if not (finite and counts_ok and r0["bfloat16"]["digest"] == r1["bfloat16"]["digest"]):
        fail("data parallel: the two-rank bf16 steps")


def _dp_eval_checks(ranks, refs, spec, card: str) -> None:
    """Item 3: the sharded decoded eval against the single-process step on
    the same clips, phase 14's gate, 12 / 16 / 1 launches a rank a batch."""
    import numpy as np

    for dtype in ("bfloat16", "float32"):
        with np.load(spec["eval"] % dtype) as z:
            got = [z[f"arr_{i}"] for i in range(len(z.files))]
        for i, n in enumerate((BATCH, 5)):
            coords, maxvals = got[3 * i], got[3 * i + 1]
            want_c, want_m = refs[dtype][i][0], refs[dtype][i][1]
            same = (coords == want_c).all(-1).mean()
            peak = np.abs(want_m).max()
            err = np.abs(maxvals - want_m).max() / peak
            counts = [r[f"eval_{dtype}"]["counts"][i] for r in ranks]
            how = (f"split, {n // DP_WORLD} a rank" if n % DP_WORLD == 0
                   else "whole on every rank")
            log(f"data parallel, sharded decoded eval {dtype}, a batch of {n} ({how}): "
                f"{same:.2%} of coordinates identical to the single-process step, max values to "
                f"{err:.3e} of their peak; launches a rank {counts} ({card})")
            if coords.shape != want_c.shape or not (same >= 0.98 and err <= 1e-3) or any(
                    c != FORWARD_COUNTS for c in counts):
                fail(f"data parallel: the sharded decoded eval ({dtype}, B={n})")


def _dp_cli(cfg, root, card: str) -> dict:
    """Item 4: the train CLI with two ranks over a synthetic tree of 16 + 16
    boxes, the yaml as it is (bf16, 2 a rank, the device loader), one
    epoch with validation; a run whose rank 1 alone gets SIGTERM after 2
    steps, then its two-rank resume."""
    import numpy as np

    from otpose_tpu_torch.cli.eval import Eval
    from otpose_tpu_torch.config import default_parse_args
    from otpose_tpu_torch.data.synthetic import ArrayFramesDataset, make_synthetic_posetrack

    json_dir, img_dir, annot_dir = make_synthetic_posetrack(
        root, num_videos=2, frames_per_video=4, people_per_frame=2, img_w=640, img_h=480,
        seed=7)
    cfg.OUTPUT_DIR = os.path.join(root, "output")
    cfg.DATASET.NAME = "PoseTrack"
    cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR, cfg.DATASET.TEST_IMG_DIR = (
        json_dir, img_dir, img_dir)
    cfg.VAL.ANNOT_DIR = annot_dir
    cfg.VAL.USE_GT_BBOX = True
    cfg.TRAIN.END_EPOCH = 1
    yaml_path = os.path.join(root, "model_RSN.yaml")
    with open(yaml_path, "w") as fh:
        fh.write(cfg.dump())

    def spec(name, tag, **kw):
        return dict(cfg=yaml_path, root=root, name=name, preds=os.path.join(root, f"{tag}.npy"),
                    out=os.path.join(root, f"cli_{tag}_%d.json"), **kw)

    whole_spec = spec("whole", "whole")
    pre_spec = spec("preempted", "preempted", sigterm_rank=1, sigterm_after=2)
    t0 = time.perf_counter()
    started = [_dist_start("cli", whole_spec, "whole"), _dist_start("cli", pre_spec, "pre")]
    whole = _dist_wait(started[0], whole_spec, "train CLI")
    pre = _dist_wait(started[1], pre_spec, "train CLI, preempted")
    first_s = time.perf_counter() - t0
    res_spec = spec("preempted", "resumed")
    t0 = time.perf_counter()
    res = _dist_wait(_dist_start("cli", res_spec, "res"), res_spec, "train CLI, resumed")
    res_s = time.perf_counter() - t0

    w0, w1 = whole
    bests = [f for f in w0["files"] if f.startswith("best_mAP_")]
    ok_files = len(bests) == 1 and sorted(w0["files"]) == sorted(["epoch_0_state"] + bests)
    steps_ok = all(s["counts"] == TRAIN_COUNTS for r in whole for s in r["steps"])
    val_ok = all(c == FORWARD_COUNTS for r in whole for c in r["val_batches"])
    log(f"data parallel, the train CLI with two ranks sharing the card (configs/17/"
        f"model_RSN.yaml, {cfg.TPU.COMPUTE_DTYPE}, {cfg.TRAIN.BATCH_SIZE_PER_GPU} a rank, global "
        f"{w0['batch_size']}, {w0['loader']}, {w0['transport'][0]}): {len(w0['steps'])} steps "
        f"and a validation in {w0['seconds']:.1f} s on rank 0; checkpoints {w0['files']}; "
        f"writes rank 0 {w0['writes']}, rank 1 {w1['writes']}; the ranks' final weights "
        + ("bit-equal" if w0["digest"] == w1["digest"] else "DIFFER")
        + f"; launches a step {w0['steps'][0]['counts']}, a validation batch a rank "
        f"{w0['val_batches'][0]}; peak memory {w0['peak_gib']:.2f} / {w1['peak_gib']:.2f} GiB "
        f"({card})")
    if not (ok_files and w0["writes"] == ["epoch_0_state"] + bests and w1["writes"] == []
            and w0["digest"] == w1["digest"] and steps_ok and val_ok
            and len(w0["steps"]) == len(w1["steps"]) == 4):
        fail("data parallel: the two-rank train CLI")

    # the single-process eval CLI on the best checkpoint: rank 0's table and,
    # as the reference init's AP is 0, its keypoints (phase 14's gate)
    class KeptPreds(ArrayFramesDataset):
        kept = []

        def evaluate(self, cfg_, preds, *a, **k):
            KeptPreds.kept.append(np.array(preds))
            return super().evaluate(cfg_, preds, *a, **k)

    table, ap = w0["validations"][-1]
    best = os.path.join(w0["folder"], bests[0])
    ev = Eval("validate", default_parse_args(["--cfg", yaml_path, "--root_dir", root,
                                               "EXPERIMENT_NAME", "whole",
                                               "VAL.MODEL_FILE", best]),
              dataset_cls=KeptPreds)
    (_, name_values, mean_ap), = ev.eval()
    del ev
    mine, theirs = KeptPreds.kept[-1], np.load(whole_spec["preds"])
    same = (mine[..., :2] == theirs[..., :2]).all(-1).mean()
    peak = np.abs(theirs[..., 2]).max()
    maxval_err = np.abs(mine[..., 2] - theirs[..., 2]).max() / peak
    got = np.asarray(list(name_values.values()), np.float64)
    want = np.asarray(list(table.values()), np.float64)
    diff = float(np.nanmax(np.abs(got - want))) if np.isfinite(want).any() else 0.0
    log(f"data parallel: the single-process eval CLI on {bests[0]}: AP "
        + " ".join(f"{k} {v:.4f}" for k, v in name_values.items())
        + f"; rank 0's validation table differs by at most {diff:.3e} (limit 1e-9); its "
        f"keypoints against rank 0's: {same:.2%} of coordinates identical, max values to "
        f"{maxval_err:.3e} of their peak ({peak:.4g}), {len(np.unique(theirs[..., 2]))} distinct "
        f"max values")
    if not (list(name_values) == list(table) and diff <= 1e-9
            and (np.isnan(got) == np.isnan(want)).all() and mean_ap == ap
            and same >= 0.98 and maxval_err <= 1e-3 and len(np.unique(theirs[..., 2])) > 1):
        fail("data parallel: the eval CLI does not reproduce rank 0's validation")

    p0, p1 = pre
    r0, r1 = res
    log(f"data parallel: SIGTERM to rank 1 alone after 2 steps: rank 0 ran "
        f"{len(p0['steps'])} steps, rank 1 {len(p1['steps'])}, checkpoints {p0['files']} (both "
        f"runs at once {first_s:.1f} s); the two-rank resume ran {len(r0['steps'])} steps in "
        f"{res_s:.1f} s and ends "
        + ("bit-equal" if r0["digest"] == w0["digest"] == r1["digest"] else "DIFFERENT")
        + " to the uninterrupted run on both ranks")
    if not (len(p0["steps"]) == len(p1["steps"]) == 2 and p0["files"] == ["epoch_0_state"]
            and p1["writes"] == [] and len(r0["steps"]) == len(r1["steps"]) == 2
            and r0["digest"] == w0["digest"] and r1["digest"] == w1["digest"]
            and [s["loss"] for s in p0["steps"] + r0["steps"]]
            == [s["loss"] for s in w0["steps"]]):
        fail("data parallel: the preempted and resumed two-rank runs")
    return dict(step=w0["steps"][0]["counts"], val_batch=w0["val_batches"][0])


# ---------------------------------------------------------------------------
# phase 17: JPEG frames on the card, the detector and the test split
# ---------------------------------------------------------------------------

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "jpeg")
FIXTURE_FRAMES = tuple(f"frame_{i:03d}" for i in range(5))
# nvJPEG against libjpeg's decode of the fixture, each frame: the largest
# uint8 difference and the mean difference of the RGB pixels, and the
# largest difference of the planes before upsampling (those in
# planes.npz).  The card's conversion kernel does libjpeg's own upsampling
# and colour arithmetic, so only the two IDCTs' rounding is left: it read
# max 3, mean <= 0.0251 and planes <= 1 on every frame (PERF.md section 6),
# and nvJPEG's own RGB output, the design this replaced, read max 54-70 and
# mean 0.547-0.603, which these bars refuse
NVJPEG_MAX, NVJPEG_MEAN, NVJPEG_PLANES_MAX = 6, 0.1, 2
# the detector on the card (f32, TF32 off) against its plain CPU forward at
# the same weights: raw outputs to 1e-4 of their peak, probabilities to 1e-4,
# and the same kept boxes to 0.05 px on every coordinate
DET_REL, DET_PROB, DET_BOX_PX = 1e-4, 1e-4, 0.05
# the detector's 416x416 input from nvJPEG's pixels against libjpeg's, in
# uint8 steps: an average of pixels then a rounding, so at most one step
# more than the pixels' own difference (it read 3)
DET_INPUT_STEPS = 4
# boxes from nvJPEG frames against boxes from the host's frames: the share
# of both sides' boxes with a box on the other side within 4 px on every
# coordinate.  The seeded detector is chaotic (a uint8 step in a few pixels
# of its input moves its boxes), so the share is held against a control:
# libjpeg's frames against the same with a uint8 step added to 0.5% of the
# values.  nvJPEG's frames differ on about 2% of the values, by up to 3
# steps, so the share may fall below the control's, by at most
# BOX_MARGIN (it read 83.21% against 92.09%)
BOX_MATCH_PX, BOX_MARGIN = 4.0, 0.10
# the test-split eval's keypoints, frames by nvJPEG against frames by cv2:
# the share within 4 px, held as the boxes are against a control (cv2's
# frames with a uint8 step added to 0.5% of values; it read 86.62% against
# 86.27%)
KP_PX, KP_MARGIN = 4.0, 0.10
DETECTOR_SEED = 0
DETECTOR_BIASES = dict(obj_bias=-1.0, person_bias=1.0)


def _gxx_include_dirs() -> list:
    import shutil

    gxx = shutil.which("g++")
    if gxx is None:
        return []
    out = subprocess.run([gxx, "-xc++", "-E", "-v", "-"], input="", capture_output=True,
                         text=True, timeout=60).stderr.splitlines()
    try:
        start = out.index("#include <...> search starts here:") + 1
        end = out.index("End of search list.")
    except ValueError:
        return []
    return [d.strip() for d in out[start:end]]


def probe_decoders() -> dict:
    """What this machine offers to decode JPEG: nvJPEG beside nvcc, libjpeg's
    header and library, whether the JAX package's committed native library
    loads (in a subprocess), PIL and cv2, and the port's two decoders."""
    import ctypes.util
    import glob

    from otpose_tpu_torch.data import native as native_io
    from otpose_tpu_torch.data import nvjpeg
    from otpose_tpu_torch.ops.cuda import build

    cuda = os.path.dirname(os.path.dirname(build.nvcc_path()))
    found = {}
    for sub in ("include", "lib64", "targets/x86_64-linux/include", "targets/x86_64-linux/lib"):
        found[sub] = sorted(os.path.basename(p) for pat in ("nvjpeg.h", "libnvjpeg.so*")
                            for p in glob.glob(os.path.join(cuda, sub, pat)))
    dirs = _gxx_include_dirs()
    so = os.path.join(ROOT, "native", "libotpose_io.so")
    proc = subprocess.run([sys.executable, "-c", "import ctypes, sys; ctypes.CDLL(sys.argv[1])",
                           so], capture_output=True, text=True, timeout=120)
    committed = "loads" if proc.returncode == 0 else (
        "does not load: " + (proc.stderr.strip().splitlines() or ["?"])[-1])
    mods = {}
    for name in ("PIL", "cv2"):
        try:
            mod = __import__(name)
            mods[name] = getattr(mod, "__version__", "?")
        except ImportError as e:
            mods[name] = f"absent ({e})"
    nv = nvjpeg.is_available()
    probe = {
        "cuda_dir": cuda, "nvjpeg_files": found,
        "jpeglib.h": [d for d in dirs if os.path.exists(os.path.join(d, "jpeglib.h"))],
        "gxx_include_dirs": dirs, "find_library(jpeg)": ctypes.util.find_library("jpeg"),
        "native/libotpose_io.so": committed, **mods,
        "port native library": "builds and loads" if native_io.is_available()
        else f"unavailable: {native_io.reason()}",
        "nvjpeg": (("hardware backend" if nvjpeg.hardware_backend() else
                    "default backend only: nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE) returned "
                    + nvjpeg.hardware_status()) if nv
                   else f"unavailable: {nvjpeg.reason()}"),
    }
    for k, v in probe.items():
        log(f"probe: {k}: {v}")
    return probe


def _diff(got, want):
    import numpy as np

    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(d.max()), float(d.mean()), float((d > 0).mean())


def _rate(fn, count: int, reps: int = 5, sync=None) -> float:
    fn()
    if sync:
        sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if sync:
        sync()
    return count * reps / (time.perf_counter() - t0)


def check_nvjpeg(card: str) -> dict:
    """nvJPEG's decode of the fixture against libjpeg's (the fixture's
    ``decoded.npz``) on each backend, its planes against libjpeg's
    (``planes.npz``), the conversion kernel against its plain version
    (``data/nvjpeg.py::ycc_to_rgb``) on nvJPEG's planes, a batch into a
    larger staging buffer equal to the frames decoded alone with zeros
    around them, and decode rates at 1280x720 on each backend and of the
    host decoders this machine has."""
    import numpy as np
    import torch

    from otpose_tpu_torch.data import native as native_io
    from otpose_tpu_torch.data import nvjpeg

    ref = np.load(os.path.join(FIXTURE, "decoded.npz"))
    ref_planes = np.load(os.path.join(FIXTURE, "planes.npz"))
    names = FIXTURE_FRAMES + ("odd_444", "grey", "odd_422")
    paths = [os.path.join(FIXTURE, n + ".jpg") for n in names]
    data = nvjpeg.read_bytes(paths)
    report = {"frames": {}}
    worst = 0
    # "auto" runs the hardware backend where nvjpegCreateEx gave one, else
    # the default backend: the forced default is a second path only then
    backends = ("auto", "default") if nvjpeg.hardware_backend() else ("auto",)
    for backend in backends:
        for name, path, blob in zip(names, paths, data):
            h, w = nvjpeg.jpeg_size(blob)
            dec = nvjpeg.decode_jpeg_batch_device([path], h, w, "cuda", backend=backend,
                                                  data=[blob], keep_planes=True)
            got = dec.out[0].cpu().numpy()
            if (dec.hs[0], dec.ws[0]) != ref[name].shape[:2]:
                fail(f"nvJPEG: {name} decoded as {dec.hs[0]}x{dec.ws[0]}, libjpeg "
                     f"{ref[name].shape}")
            planes = dec.planes[0]
            if planes is None:
                fail(f"nvJPEG: {name} ({dec.conversions[0]}) did not go through the "
                     f"conversion kernel")
            plain = nvjpeg.ycc_to_rgb(*planes)
            if not torch.equal(plain, dec.out[0]):
                fail(f"nvJPEG: the conversion kernel differs from ycc_to_rgb on {name}")
            plane_err = {}
            for k, p in zip(("y", "cb", "cr"), planes):
                if p is not None and f"{name}_{k}" in ref_planes:
                    plane_err[k] = _diff(p.cpu().numpy(), ref_planes[f"{name}_{k}"])[0]
            mx, mean, share = _diff(got, ref[name])
            log(f"nvJPEG {backend} ({dec.backends[0]} backend ran, {dec.conversions[0]} "
                f"conversion kernel, equal to its plain version) {name} {w}x{h}: against "
                f"libjpeg max |d| {mx} (bar {NVJPEG_MAX}), mean {mean:.4f} (bar "
                f"{NVJPEG_MEAN}), {share:.2%} of values differ"
                + (f"; planes against libjpeg's max |d| {plane_err} (bar {NVJPEG_PLANES_MAX})"
                   if plane_err else ""))
            if (mx > NVJPEG_MAX or mean > NVJPEG_MEAN
                    or any(v > NVJPEG_PLANES_MAX for v in plane_err.values())):
                fail(f"nvJPEG: {name} on the {dec.backends[0]} backend differs from "
                     f"libjpeg's decode beyond the bar")
            report["frames"][f"{name}/{dec.backends[0]}"] = {
                "max_abs_err": mx, "mean_abs_err": mean, "share_differ": share,
                "planes_max_abs_err": plane_err}
            worst = max(worst, mx)
    report["max_abs_err"] = worst
    # the loader's call: a batch into a larger zeroed buffer, pitch max_w * 3
    big = torch.zeros((len(paths), 1088, 1920, 3), dtype=torch.uint8, device="cuda")
    dec = nvjpeg.decode_jpeg_batch_device(paths, 1088, 1920, "cuda", out=big, data=data)
    for i, (name, blob) in enumerate(zip(names, data)):
        h, w = dec.hs[i], dec.ws[i]
        alone = nvjpeg.decode_jpeg_batch_device(
            [paths[i]], h, w, "cuda", backend="default" if dec.backends[i] == "default"
            else "auto", data=[blob]).out
        inside = torch.equal(big[i, :h, :w], alone[0])
        outside = int(big[i, h:].count_nonzero()) + int(big[i, :h, w:].count_nonzero())
        if not inside or outside:
            fail(f"nvJPEG: {name} in a 1088x1920 staging buffer differs from its decode "
                 f"alone ({outside} nonzero bytes outside the frame)")
    log(f"nvJPEG: a batch of {len(paths)} into a 1088x1920 staging buffer equals each frame "
        f"decoded alone, zeros around them (backends {dec.backends}, conversions "
        f"{dec.conversions})")
    # a sampling the conversion kernel lacks (4:4:0) is refused, naming the file
    s440 = os.path.join(FIXTURE, "small_440.jpg")
    try:
        nvjpeg.decode_jpeg_batch_device([paths[0], s440], 1088, 1920, "cuda")
        fail("nvJPEG: a 4:4:0 frame was decoded, not refused")
    except ValueError as e:
        if s440 not in str(e) or "chroma sampling" not in str(e):
            fail(f"nvJPEG: the 4:4:0 frame was refused without its name: {e}")
        log(f"nvJPEG: a 4:4:0 frame is refused: {e}")
    # rates at 1280x720: 20 frames a call
    hd = paths[:5] * 4
    hd_data = data[:5] * 4
    staging = torch.zeros((20, 720, 1280, 3), dtype=torch.uint8, device="cuda")
    rates = {}
    for backend in backends:
        ran = "default" if backend == "default" or not nvjpeg.hardware_backend() else "hardware"
        rates[f"nvjpeg_{ran}"] = _rate(
            lambda b=backend: nvjpeg.decode_jpeg_batch_device(hd, 720, 1280, "cuda", out=staging,
                                                              backend=b, data=hd_data),
            20, sync=torch.cuda.synchronize)
    import cv2

    rates["cv2_host_1thread"] = _rate(lambda: [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
                                               for p in hd], 20)
    try:
        from PIL import Image

        rates["pil_host_1thread"] = _rate(
            lambda: [np.asarray(Image.open(p).convert("RGB")) for p in hd], 20)
    except ImportError:
        rates["pil_host_1thread"] = None
    rates["native_host"] = (_rate(lambda: native_io.decode_jpeg_batch(hd, 720, 1280), 20)
                            if native_io.is_available() else None)
    log("decode rates at 1280x720, frames/s (" + card + "): "
        + ", ".join(f"{k} {v if v is None else f'{v:.2f}'}" for k, v in rates.items())
        + " (host rates on one thread, native where its library builds)")
    report["frames_per_s"] = rates
    report["backend"] = "hardware" if nvjpeg.hardware_backend() else "default"
    return report


def _conv_flops(model, x) -> int:
    import torch

    total = []

    def hook(mod, inp, out):
        total.append(2 * out.numel() * mod.weight[0].numel())

    handles = [m.register_forward_hook(hook) for m in model.convs]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return sum(total)


def _sorted_kept(kept):
    import numpy as np

    return kept[np.lexsort((kept[:, 1], kept[:, 0], kept[:, 6]))]


def check_detector(card: str) -> dict:
    """Both variants at 416 on the card against the plain CPU forward at the
    same He-scaled weights (BN calibrated on two fixture frames, heads
    scaled), on fixture frame 0 preprocessed on the CPU: raw outputs, kept
    boxes, the card's own preprocessing, and ms a frame.  Returns the full
    variant's weights for the tree's detector."""
    import numpy as np
    import torch

    from otpose_tpu_torch.detector import yolov3 as Y

    ref = np.load(os.path.join(FIXTURE, "decoded.npz"))
    frames = [ref[n] for n in FIXTURE_FRAMES]
    out = {}
    with torch.no_grad():
        x_cpu = torch.stack([Y.preprocess_image(f)[0] for f in frames[:2]]).permute(0, 3, 1, 2)
        on_card = Y.preprocess_image(torch.from_numpy(frames[0]).cuda())[0]
        if not torch.equal(on_card.cpu(), x_cpu[0].permute(1, 2, 0)):
            fail("detector: preprocess_image on the card differs from the CPU's")
        for variant in ("yolov3", "yolov3-tiny"):
            cpu = Y.build_yolo(Y.init_he_weights(DETECTOR_SEED, variant, **DETECTOR_BIASES),
                               variant, "cpu")
            cpu.calibrate_bn_(x_cpu.contiguous())
            weights = cpu.darknet_params()
            gpu = Y.build_yolo(weights, variant, "cuda")
            inp = x_cpu[:1].contiguous()
            want = cpu(inp)[0].numpy()
            got = gpu(inp.cuda())[0].cpu().numpy()
            peak = float(np.abs(want).max())
            rel = float(np.abs(got - want).max()) / peak
            prob = float(np.abs(got[:, 4:] - want[:, 4:]).max())
            kw, kg = (_sorted_kept(Y.non_max_suppression(d, 0.4, 0.4)) for d in (want, got))
            box = float(np.abs(kw[:, :4] - kg[:, :4]).max()) if len(kw) == len(kg) and len(kw) \
                else (0.0 if len(kw) == len(kg) else float("inf"))
            same_cls = len(kw) == len(kg) and np.array_equal(kw[:, 6], kg[:, 6])
            inp_c = inp.cuda()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            for _ in range(3):
                gpu(inp_c)
            torch.cuda.synchronize()
            start.record()
            for _ in range(20):
                gpu(inp_c)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 20
            t0 = time.perf_counter()
            for _ in range(3):
                cpu(inp)
            cpu_ms = (time.perf_counter() - t0) / 3 * 1e3
            flops = _conv_flops(cpu, inp)
            bound = flops / PEAK_F32 * 1e3
            log(f"detector {variant} at 416 on the card (f32, TF32 off) against the CPU: raw "
                f"outputs {rel:.3e} of their peak {peak:.1f} (bar {DET_REL}), probabilities "
                f"{prob:.3e} (bar {DET_PROB}); kept boxes {len(kg)} on the card, {len(kw)} on "
                f"the CPU, coordinates within {box:.4f} px (bar {DET_BOX_PX}); {ms:.3f} ms a frame "
                f"on the card (B=1, CUDA events), {cpu_ms:.1f} ms on the CPU; "
                f"{flops / 1e9:.2f} GFLOP, bound {bound:.3f} ms at the f32 peak ({card})")
            if not (rel <= DET_REL and prob <= DET_PROB and box <= DET_BOX_PX and same_cls):
                fail(f"detector {variant}: the card's forward differs from the CPU's")
            out[variant] = {"ms": ms, "cpu_ms": cpu_ms, "gflop": flops / 1e9, "bound_ms": bound,
                            "rel_err": rel, "kept": len(kg), "weights": weights}
    return out


def _fixture_tree(root: str, seed: int = 0):
    """A PoseTrack-format tree of one video whose five 1280x720 frames are
    the fixture's jpgs (``make_synthetic_posetrack``'s jsons and annotations,
    four people a frame)."""
    import shutil

    from otpose_tpu_torch.data.synthetic import make_synthetic_posetrack

    json_dir, img_dir, annot_dir = make_synthetic_posetrack(
        root, num_videos=1, frames_per_video=5, people_per_frame=4, img_w=1280, img_h=720,
        seed=seed)
    arrays = sorted(os.path.join(d, f) for d, _, fs in os.walk(img_dir) for f in fs
                    if f.endswith(".npy"))
    for name, path in zip(FIXTURE_FRAMES, arrays):
        shutil.copyfile(os.path.join(FIXTURE, name + ".jpg"), path[:-4] + ".jpg")
        os.remove(path)
    return json_dir, img_dir, annot_dir


def _nearest_box_px(a: list, b: list) -> list:
    """For each box of ``a``, the largest coordinate difference to its
    nearest box in ``b`` (inf when ``b`` is empty)."""
    import numpy as np

    if not b:
        return [float("inf")] * len(a)
    bb = np.asarray(b)
    return [float(np.abs(bb - np.asarray(x)).max(axis=1).min()) for x in a]


def _box_control(weights) -> float:
    """The seeded detector's own sensitivity: on the card, its boxes on the
    fixture's libjpeg frames against its boxes on the same frames with one
    uint8 step added to 0.5% of the values (drawn from a seed); the share of
    both sides' boxes with a match within BOX_MATCH_PX."""
    import numpy as np

    from otpose_tpu_torch.detector import yolov3 as Y

    ref = np.load(os.path.join(FIXTURE, "decoded.npz"))
    det = Y.YoloV3Detector(weights=weights, device="cuda")
    rng = np.random.RandomState(0)
    dists = []
    for name in FIXTURE_FRAMES:
        frame = ref[name]
        bumped = frame.astype(np.int16) + (rng.rand(*frame.shape) < 0.005)
        a = [b[:4] for b in det.detect_persons(frame)]
        b = [b[:4] for b in det.detect_persons(np.clip(bumped, 0, 255).astype(np.uint8))]
        dists += _nearest_box_px(a, b) + _nearest_box_px(b, a)
    return float(np.mean([d <= BOX_MATCH_PX for d in dists])) if dists else 1.0


def _stepped(read_frame):
    """``read_frame`` with one uint8 step added to 0.5% of each frame's
    values (drawn from a seed made from the path): the control of phase 17's
    keypoint comparison."""
    import zlib

    import numpy as np

    def read(path):
        im = read_frame(path)
        rng = np.random.RandomState(zlib.crc32(path.encode()))
        return np.clip(im.astype(np.int16) + (rng.rand(*im.shape) < 0.005), 0,
                       255).astype(np.uint8)

    return read


def test_split(card: str, weights) -> dict:
    """``tools/generate_boxes`` over the fixture tree on the card (frames by
    nvJPEG) and on the CPU (frames by the host's decoder), then the eval CLI
    on the test split with ``USE_GT_BBOX`` false over the card's boxes, under
    ``full`` with the decoder it chose (nvJPEG), and again with the frames
    decoded by cv2 on the host: launches, boxes/s, keypoints."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from otpose_tpu_torch.cli.eval import Eval
    from otpose_tpu_torch.config import default_parse_args
    from otpose_tpu_torch.data import nvjpeg
    from otpose_tpu_torch.detector import yolov3 as Y
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.tools import generate_boxes
    from otpose_tpu_torch.utils.testing import flagship_otpose_cfg

    class LoadTimed(Eval):
        def _load(self, model_file):
            model = super()._load(model_file)
            torch.cuda.synchronize()
            self.loaded_at = time.perf_counter()
            return model

    root = tempfile.mkdtemp(prefix="otpose_test_split_")
    try:
        json_dir, img_dir, annot_dir = _fixture_tree(root)
        wpath = os.path.join(root, "yolov3_seeded.weights")
        Y.save_darknet_weights(wpath, weights, "yolov3")
        if not all(np.array_equal(a["weight"], b["weight"])
                   for a, b in zip(Y.load_darknet_weights(wpath), weights)):
            fail("detector: the darknet file does not read back")
        boxes_card, boxes_cpu = (os.path.join(root, f"test_boxes_{d}.json") for d in ("card", "cpu"))
        base = ["--json_dir", json_dir, "--img_dir", img_dir, "--weights", wpath]
        gb = generate_boxes.main(base + ["--out", boxes_card])
        if not gb["decoder"].startswith("nvjpeg") or gb["frames"] != 5 or gb["boxes"] == 0:
            fail(f"generate_boxes on the card: {gb}")
        gb_cpu = generate_boxes.main(base + ["--out", boxes_cpu, "--device", "cpu"])
        with open(boxes_card) as fh:
            card_boxes = json.load(fh)
        with open(boxes_cpu) as fh:
            cpu_boxes = json.load(fh)
        dists, counts = [], []
        for name in sorted({b["image_name"] for b in card_boxes + cpu_boxes}):
            a = [b["bbox"] for b in card_boxes if b["image_name"] == name]
            c = [b["bbox"] for b in cpu_boxes if b["image_name"] == name]
            dists += _nearest_box_px(a, c) + _nearest_box_px(c, a)
            counts.append((len(a), len(c)))
        share = float(np.mean([d <= BOX_MATCH_PX for d in dists])) if dists else 1.0
        control = _box_control(weights)
        ref = np.load(os.path.join(FIXTURE, "decoded.npz"))
        steps = []
        for name in FIXTURE_FRAMES:
            path = os.path.join(FIXTURE, name + ".jpg")
            h, w = ref[name].shape[:2]
            frame = nvjpeg.decode_jpeg_batch_device([path], h, w, "cuda").out[0]
            a = Y.preprocess_image(frame)[0]
            b = Y.preprocess_image(torch.from_numpy(ref[name]).cuda())[0]
            steps.append(int(((a - b).abs().max() * 255).round().item()))
        log(f"generate_boxes: {gb['boxes']} boxes over {gb['frames']} frames on the card "
            f"({gb['decoder']}), {gb['frames'] / gb['seconds']:.3f} frames/s; "
            f"{gb_cpu['boxes']} on the CPU ({gb_cpu['decoder']}), "
            f"{gb_cpu['frames'] / gb_cpu['seconds']:.3f} frames/s; boxes a frame (card, CPU) "
            f"{counts}; {share:.2%} of both sides' boxes have a box on the other side within "
            f"{BOX_MATCH_PX} px (control, libjpeg's frames against the same with a uint8 step "
            f"added to 0.5% of values, on the card: {control:.2%}; bar: the control's less "
            f"{BOX_MARGIN:.0%}); the detector's input from nvJPEG's pixels against libjpeg's, "
            f"largest difference a frame {steps} uint8 steps (bar {DET_INPUT_STEPS}) ({card})")
        if max(steps) > DET_INPUT_STEPS:
            fail("generate_boxes: the detector's input from nvJPEG's pixels differs from "
                 "libjpeg's beyond the bar")
        if share < control - BOX_MARGIN:
            fail("generate_boxes: the boxes from nvJPEG's frames match the CPU's less often "
                 "than the control allows")

        cfg = flagship_otpose_cfg()
        cfg.EXPERIMENT_NAME = "chip_smoke_test_split"
        cfg.OUTPUT_DIR = os.path.join(root, "output")
        cfg.DATASET.NAME = "PoseTrack"
        cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR, cfg.DATASET.TEST_IMG_DIR = (
            json_dir, img_dir, img_dir)
        cfg.DATASET.COLOR_RGB = True
        cfg.TEST.ANNOT_DIR = annot_dir
        cfg.TEST.USE_GT_BBOX = False
        cfg.TEST.COCO_BBOX_FILE = boxes_card
        cfg.TEST.IMAGE_THRE = 0.0
        cfg.TEST.BATCH_SIZE_PER_GPU = BATCH
        cfg.TEST.FLIP_TEST = False
        cfg.TEST.MODEL_FILE = os.path.join(root, "random_weights.pth")
        cfg.WORKERS = 4
        cfg.TPU.COMPUTE_DTYPE = "bfloat16"
        cfg.TPU.PARAM_DTYPE = "bfloat16"
        cfg.TPU.DEVICE_PREPROCESS = "full"
        yaml_path = os.path.join(root, "test_split.yaml")
        with open(yaml_path, "w") as fh:
            fh.write(cfg.dump())
        _, model = build_model(cfg, seed=0)
        _scaled_weights_(model, 0)
        _calibrate_refinement_(model, 0)
        torch.save({"state_dict": model.state_dict()}, cfg.TEST.MODEL_FILE)
        del model

        runs = {}
        for decoder in ("nvjpeg", "read_frame", "read_frame+step"):
            ev = LoadTimed("test", default_parse_args(["--cfg", yaml_path, "--root_dir", root]))
            if ev.loader.decoder != "nvjpeg":
                fail(f"eval CLI on the test split under full chose {ev.loader.decoder}, "
                     f"not nvjpeg")
            ev.loader.decoder = ev.loader.decoder_detail = decoder.split("+")[0]
            if decoder.endswith("+step"):
                ev.dataset.read_frame = _stepped(ev.dataset.read_frame)
            kept = {}
            inner = ev.dataset.evaluate

            def spy(cfg_, preds, *args, inner=inner, kept=kept, **kwargs):
                kept["preds"] = np.array(preds)
                return inner(cfg_, preds, *args, **kwargs)

            ev.dataset.evaluate = spy
            boxes, batches = len(ev.dataset), len(ev.loader)
            if boxes != len(card_boxes):
                fail(f"eval CLI on the test split: {boxes} boxes, the boxes file has "
                     f"{len(card_boxes)}")
            frames_before = dict(nvjpeg.frames)
            torch.cuda.synchronize()
            reset_counts()
            results = ev.eval()
            torch.cuda.synchronize()
            wall = time.perf_counter() - ev.loaded_at
            counts = read_counts()
            want = {k: v * batches for k, v in FORWARD_COUNTS.items()}
            if counts != want:
                fail(f"eval CLI on the test split ({decoder}): launches {counts}, expected {want} "
                     f"over {batches} batches")
            decoded = sum(nvjpeg.frames.values()) - sum(frames_before.values())
            if (decoded > 0) != (decoder == "nvjpeg"):
                fail(f"eval CLI on the test split ({decoder}): nvJPEG decoded {decoded} frames")
            _, name_values, _ = results[0]
            table = np.asarray(list(name_values.values()), np.float64)
            if table.shape != (8,) or not np.isfinite(kept["preds"]).all():
                fail(f"eval CLI on the test split ({decoder}): AP table {table}")
            log(f"eval CLI on the test split, USE_GT_BBOX false, full, frames decoded by "
                f"{ev.loader.decoder_detail if decoder == 'nvjpeg' else decoder + ' (cv2)'}: "
                f"{boxes} detector boxes, {batches} batches, {boxes / wall:.3f} boxes/s "
                f"({wall:.3f} s from the model's load), {decoded} frames on nvJPEG; launches "
                f"{counts}; AP " + " ".join(f"{k} {v:.4f}" for k, v in name_values.items()))
            runs[decoder] = dict(counts=counts, batches=batches, boxes_per_s=boxes / wall,
                                 preds=kept["preds"])
        def keypoint_distances(x, y):
            a, b = runs[x]["preds"][..., :2], runs[y]["preds"][..., :2]
            return np.sqrt(((a - b) ** 2).sum(-1))

        dist = keypoint_distances("nvjpeg", "read_frame")
        ctrl = keypoint_distances("read_frame+step", "read_frame")
        within, ctrl_within = float((dist <= KP_PX).mean()), float((ctrl <= KP_PX).mean())
        log(f"eval CLI on the test split: keypoints from nvJPEG frames against cv2's: "
            f"{float((dist == 0).mean()):.2%} identical, {within:.2%} within {KP_PX} px (bar: "
            f"the control's less {KP_MARGIN:.0%}), median {float(np.median(dist)):.3f} px, max "
            f"{dist.max():.2f} px; control, cv2's frames with a uint8 step added to 0.5% of "
            f"values against cv2's: {float((ctrl == 0).mean()):.2%} identical, "
            f"{ctrl_within:.2%} within {KP_PX} px, median {float(np.median(ctrl)):.3f} px")
        if within < ctrl_within - KP_MARGIN:
            fail("eval CLI on the test split: nvJPEG's keypoints match cv2's less often than "
                 "the control allows")
        return {"generate_boxes": gb, "generate_boxes_cpu": gb_cpu, "runs": runs}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def jpeg_phase(card: str) -> dict:
    """Phase 17: the probe, nvJPEG against libjpeg, the detector on the card,
    the test split through generate_boxes and the eval CLI, and
    bench_input_pipeline's table on the card."""
    import torch

    from otpose_tpu_torch.data import nvjpeg
    from otpose_tpu_torch.tools import bench_input_pipeline

    phase_t0 = time.perf_counter()
    probe = probe_decoders()
    if not nvjpeg.is_available():
        fail(f"nvJPEG is unavailable on this machine: {nvjpeg.reason()}")
    nv = check_nvjpeg(card)
    det = check_detector(card)
    split = test_split(card, det["yolov3"]["weights"])
    torch.cuda.empty_cache()
    rows = bench_input_pipeline.run(samples=32, batch=BATCH, workers=(1, 4), videos=2, frames=6,
                                    device="cuda", use_fixture=True, log=log)
    run = split["runs"]["nvjpeg"]
    nv_line = {"nvjpeg": {
        "source": "otpose_tpu_torch/csrc/jpeg_nv.cu", "replaces": "host libjpeg decode "
        "(otpose_tpu/data/device_loader.py:74-89)", "backend": nv["backend"],
        "calls": nvjpeg.calls, "frames": dict(nvjpeg.frames),
        "conversion_kernel_launches": nvjpeg.launches,
        "max_abs_err": nv["max_abs_err"], "frames_per_s": nv["frames_per_s"],
        "detector_ms": {v: det[v]["ms"] for v in det},
        "detector_bound_ms": {v: det[v]["bound_ms"] for v in det},
        "generate_boxes_frames_per_s": split["generate_boxes"]["frames"]
        / split["generate_boxes"]["seconds"],
        "test_split_boxes_per_s": run["boxes_per_s"],
        "bench": [r for r in rows if "samples_per_s" in r]}}
    print("nvjpeg: " + json.dumps(nv_line), flush=True)
    log(f"JPEG and detector phase (17): {time.perf_counter() - phase_t0:.1f} s")
    return {"probe": probe, "per_batch": {k: v // run["batches"] for k, v in run["counts"].items()}}


# ---------------------------------------------------------------------------
# phase 18: the remaining modules (the eval CLI's drawing path, pose_hrnet,
# window attention and embedding convs, the two tools, the DCN variants)
# ---------------------------------------------------------------------------

# the encoder of phase 18: the temporal encoder's width and depth with an
# embedding conv and window 19 at every level (2 * 9 = 18 divides 6912, 3456
# and 1728, as the reference's banded form needs)
WINDOW_SPEC = dict(n_in=136, n_embd=136, n_head=2, n_embd_ks=3, max_len=6912, arch=(1, 6, 2),
                   mha_win_size=(19,), use_rel_pe=True)


def _rel_err(got, want) -> float:
    return ((got.float().cpu() - want.float().cpu()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def vis_eval_cli(card: str) -> dict:
    """Phase 18 (1): the eval CLI on its heatmap path, ``DEBUG.VIS_SKELETON``
    and ``VIS_BBOX`` on, B = 16, bf16, without and with the flip, over the
    fixture's jpg tree (validation split, ground-truth boxes), each against
    the decoded path on the same tree and weights: launches a batch, the
    image files written (one a frame with a box, a result dump a batch at
    ``PRINT_FREQ`` 1), keypoints within one f32 step of each coordinate (the
    heatmap path's decode stores its back-projection in f32, the decoded
    path's in f64; both decode the same heatmaps) and max values equal."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from otpose_tpu_torch.cli.eval import Eval
    from otpose_tpu_torch.config import default_parse_args
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.utils.testing import flagship_otpose_cfg

    class Cached(Eval):
        """One model for the phase's four runs, its load timed."""
        model = None

        def _load(self, model_file):
            if Cached.model is None:
                Cached.model = super()._load(model_file)
            torch.cuda.synchronize()
            self.loaded_at = time.perf_counter()
            return Cached.model

    root = tempfile.mkdtemp(prefix="otpose_vis_cli_")
    try:
        json_dir, img_dir, annot_dir = _fixture_tree(root)
        cfg = flagship_otpose_cfg()
        cfg.DATASET.NAME = "PoseTrack"
        cfg.DATASET.JSON_DIR, cfg.DATASET.IMG_DIR, cfg.DATASET.TEST_IMG_DIR = (
            json_dir, img_dir, img_dir)
        cfg.DATASET.COLOR_RGB = True
        cfg.VAL.ANNOT_DIR = annot_dir
        cfg.VAL.USE_GT_BBOX = True
        cfg.VAL.BATCH_SIZE_PER_GPU = BATCH
        cfg.VAL.MODEL_FILE = os.path.join(root, "random_weights.pth")
        cfg.PRINT_FREQ = 1
        cfg.WORKERS = 4
        cfg.TPU.COMPUTE_DTYPE = "bfloat16"
        cfg.TPU.PARAM_DTYPE = "bfloat16"
        _, model = build_model(cfg, seed=0)
        _scaled_weights_(model, 0)
        _calibrate_refinement_(model, 0)
        torch.save({"state_dict": model.state_dict()}, cfg.VAL.MODEL_FILE)
        del model
        runs = {}
        for flip in (False, True):
            for draw in (False, True):
                label = ("heatmap path, drawing" if draw else "decoded path") + (
                    ", flip" if flip else "")
                cfg.EXPERIMENT_NAME = f"vis_{int(flip)}{int(draw)}"
                cfg.VAL.FLIP_VAL = flip
                cfg.DEBUG.VIS_SKELETON = cfg.DEBUG.VIS_BBOX = draw
                yaml_path = os.path.join(root, cfg.EXPERIMENT_NAME + ".yaml")
                with open(yaml_path, "w") as fh:
                    fh.write(cfg.dump())
                ev = Cached("validate", default_parse_args(["--cfg", yaml_path,
                                                            "--root_dir", root]))
                if ev.use_decoded == draw:
                    fail(f"eval CLI ({label}): use_decoded {ev.use_decoded}")
                kept = {}
                inner = ev.dataset.evaluate

                def spy(cfg_, preds, *args, inner=inner, kept=kept, **kwargs):
                    kept["preds"] = np.array(preds)
                    return inner(cfg_, preds, *args, **kwargs)

                ev.dataset.evaluate = spy
                boxes, batches = len(ev.dataset), len(ev.loader)
                torch.cuda.synchronize()
                reset_counts()
                results = ev.eval()
                torch.cuda.synchronize()
                wall = time.perf_counter() - ev.loaded_at
                counts = read_counts()
                want = {k: v * batches * (2 if flip else 1) for k, v in FORWARD_COUNTS.items()}
                if counts != want:
                    fail(f"eval CLI ({label}): launches {counts}, expected {want} over "
                         f"{batches} batches")
                _, name_values, _ = results[0]
                if len(name_values) != 8 or not np.isfinite(kept["preds"]).all():
                    fail(f"eval CLI ({label}): AP table {name_values}")
                vis_dir = os.path.join(ev.cfg.OUTPUT_DIR, "validate_vis")
                written = sorted(os.path.relpath(os.path.join(r, f), vis_dir)
                                 for r, _, fs in os.walk(vis_dir) for f in fs)
                frames = {r["image"] for r in ev.dataset.data}
                drawn = [n for n in written if n.startswith("SkeletonAndBbox")]
                dumps = [n for n in written if n.endswith("_pred_result.jpg")]
                log(f"eval CLI on the fixture's jpg tree, {label} (B={BATCH}, bf16): {boxes} "
                    f"boxes, {batches} batches, {boxes / wall:.3f} boxes/s ({wall:.3f} s from "
                    f"the model's load); launches {counts}; {len(drawn)} frames drawn, "
                    f"{len(dumps)} result dumps; AP "
                    + " ".join(f"{k} {v:.4f}" for k, v in name_values.items()) + f" ({card})")
                if draw:
                    if len(drawn) != len(frames) or len(dumps) != batches:
                        fail(f"eval CLI ({label}): wrote {len(drawn)} frames (want "
                             f"{len(frames)}) and {len(dumps)} dumps (want {batches})")
                    if not all(os.path.getsize(os.path.join(vis_dir, n)) > 0 for n in written):
                        fail(f"eval CLI ({label}): an empty image file")
                elif written:
                    fail(f"eval CLI ({label}): drew {len(written)} files with the flags off")
                runs[(flip, draw)] = dict(counts=counts, batches=batches,
                                          boxes_per_s=boxes / wall, preds=kept["preds"])
            a, b = runs[(flip, True)]["preds"], runs[(flip, False)]["preds"]
            d = np.abs(a[..., :2] - b[..., :2])
            ulps = float((d / np.spacing(np.abs(b[..., :2]).astype(np.float32))).max())
            same_max = bool(np.array_equal(a[..., 2], b[..., 2]))
            log(f"eval CLI{' flip' if flip else ''}: the heatmap path's keypoints against the "
                f"decoded path's: max |d| {d.max():.3e} px, {ulps:.3f} f32 steps of the "
                f"coordinate at most (bar 1: the heatmap path keeps its back-projection in "
                f"f32), max values equal: {same_max}")
            if ulps > 1.0 or not same_max:
                fail("eval CLI: the heatmap path's keypoints differ from the decoded path's")
        return runs
    finally:
        shutil.rmtree(root, ignore_errors=True)


def pose_hrnet(card: str) -> dict:
    """Phase 18 (2): ``build_model`` with ``MODEL.NAME pose_hrnet``:
    HRNet-W48 at 384x288, B = 16, f32 (TF32 off), weights of std
    1/sqrt(fan_in) from a seed (``_scaled_weights_``);
    the card's heatmaps against the CPU forward of the same weights (2e-4 of
    the peak), ms a forward by CUDA events."""
    import torch

    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.models.hrnet import HRNet
    from otpose_tpu_torch.utils.testing import flagship_otpose_cfg
    from otpose_tpu_torch.utils.timing import time_ms

    cfg = flagship_otpose_cfg()
    cfg.MODEL.NAME = "pose_hrnet"
    _, model = build_model(cfg, seed=0)
    if not isinstance(model, HRNet) or next(model.parameters()).device.type != "cuda":
        fail("build_model(pose_hrnet) did not give an HRNet on the card")
    _scaled_weights_(model, 18)
    cpu = copy.deepcopy(model).cpu()
    w, h = cfg.MODEL.IMAGE_SIZE
    x = torch.randn(BATCH, 3, h, w, generator=torch.Generator().manual_seed(18))
    with torch.no_grad():
        got = model(x.cuda())
        torch.cuda.synchronize()
        ms = time_ms(lambda: model(x.cuda()), iters=5, warmup=1)
        t0 = time.perf_counter()
        want = cpu(x)
        cpu_s = time.perf_counter() - t0
    err = _rel_err(got, want)
    log(f"pose_hrnet (HRNet-W48, 384x288, B={BATCH}, f32, TF32 off): heatmaps "
        f"{tuple(got.shape)}, card against CPU {err:.3e} of the peak (bar 2e-4); "
        f"{ms:.2f} ms a forward on the card, {cpu_s:.1f} s on the CPU ({card})")
    if tuple(got.shape) != (BATCH, 17, h // 4, w // 4) or not torch.isfinite(got).all() \
            or not err <= 2e-4:
        fail("pose_hrnet: the card's heatmaps disagree with the CPU's")
    return dict(ms=ms, err=err)


def window_encoder(card: str) -> dict:
    """Phase 18 (3): a ConvTransformer at the temporal encoder's width (C =
    136, T = 6912, arch (1, 6, 2), window 19 at every level, ``use_rel_pe``)
    in eval on the card in f32 and bf16 against its plain version on the
    CPU, B = 2: f32 to 1e-4 of the peak; bf16 no farther from the CPU's f32
    answer (RMS) than twice the CPU's own bf16 plain version, and the share
    of outputs that differ from that plain version printed.  Each window
    block's MLP takes the fused kernel: 8 fused-MLP launches a forward, no
    fused attention."""
    import torch

    from otpose_tpu_torch.models.conv_transformer import (ConvTransformer,
                                                          ConvTransformerSpec,
                                                          init_conv_transformer_)
    from otpose_tpu_torch.utils.timing import time_ms

    spec = ConvTransformerSpec(**WINDOW_SPEC)
    cpu = init_conv_transformer_(ConvTransformer(spec), torch.Generator().manual_seed(19)).eval()
    card_model = copy.deepcopy(cpu).cuda()
    x = torch.randn(2, 136, 96, 72, generator=torch.Generator().manual_seed(20))
    blocks = spec.arch[1] + spec.arch[2]
    out, counts = {}, {}
    with torch.no_grad():
        ref = cpu(x)
        ref_bf16 = cpu(x.bfloat16())
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.cuda().to(dtype)
            card_model(xd)
            torch.cuda.synchronize()
            reset_counts()
            out[dtype] = card_model(xd)
            torch.cuda.synchronize()
            counts[dtype] = read_counts()
            out[dtype].append(time_ms(lambda: card_model(xd), iters=5, warmup=1))
    want = dict(FORWARD_COUNTS, fused_attn=0, fused_mlp=blocks, deform_conv=0)
    f32_err = max(_rel_err(g, w) for g, w in zip(out[torch.float32][:-1], ref))
    rms = lambda a, b: ((a.float().cpu() - b.float()) ** 2).mean().sqrt().item()  # noqa: E731
    card_rms = max(rms(g, w) for g, w in zip(out[torch.bfloat16][:-1], ref))
    plain_rms = max(rms(g, w) for g, w in zip(ref_bf16, ref))
    differ = sum(int((g.cpu() != w).sum()) for g, w in zip(out[torch.bfloat16][:-1], ref_bf16))
    share = differ / sum(w.numel() for w in ref_bf16)
    log(f"window encoder (C=136, T=6912, arch (1, 6, 2), window 19, rel_pe, B=2): launches f32 "
        f"{counts[torch.float32]}, bf16 {counts[torch.bfloat16]}; f32 card against CPU "
        f"{f32_err:.3e} of the peak (bar 1e-4); bf16 RMS from the CPU's f32 {card_rms:.3e} "
        f"against the CPU bf16 plain version's {plain_rms:.3e} (bar 2x), "
        f"{share:.2%} of outputs differ from that plain version; "
        f"{out[torch.float32][-1]:.3f} ms f32, {out[torch.bfloat16][-1]:.3f} ms bf16 a forward "
        f"({card})")
    if any(c != want for c in counts.values()):
        fail(f"window encoder: launches {counts}, expected {want}")
    if not f32_err <= 1e-4 or not card_rms <= 2 * plain_rms:
        fail("window encoder: the card disagrees with the CPU plain version")
    return dict(counts=counts[torch.bfloat16], f32_err=f32_err, share=share)


def dcn_variants(card: str) -> dict:
    """Phase 18 (6): ``ops/deform_conv.py``'s DCNv2 (groups 2, deformable
    groups 4, stride 2, dilation 2, C = 64), its gather form and DCNv1, and
    ``ops/deform_pool.py::deform_psroi_pool`` with part offsets, on the card
    against the CPU in f32 (1e-5 of the peak; the pool's sample counts
    equal)."""
    import importlib

    import torch

    dc = importlib.import_module("otpose_tpu_torch.ops.deform_conv")
    dp = importlib.import_module("otpose_tpu_torch.ops.deform_pool")
    gen = torch.Generator().manual_seed(21)
    b, c, h, w, o, dg, groups, stride, dil = 2, 64, 64, 64, 64, 4, 2, 2, 2
    ho = wo = (h + 2 * dil - dil * 2 - 1) // stride + 1
    args = dict(x=torch.randn(b, c, h, w, generator=gen),
                off=1.5 * torch.randn(b, dg * 18, ho, wo, generator=gen),
                mask=torch.rand(b, dg * 9, ho, wo, generator=gen),
                weight=torch.randn(o, c // groups, 3, 3, generator=gen) / 24.0,
                bias=0.1 * torch.randn(o, generator=gen))
    kw = dict(stride=stride, padding=dil, dilation=dil, deformable_groups=dg)
    calls = {
        "modulated_deform_conv": lambda a: dc.modulated_deform_conv(
            a["x"], a["off"], a["mask"], a["weight"], a["bias"], groups=groups, **kw),
        "deform_conv": lambda a: dc.deform_conv(a["x"], a["off"], a["weight"], a["bias"],
                                                groups=groups, **kw),
        "modulated_deform_conv_gather": lambda a: dc.modulated_deform_conv_gather(
            a["x"], a["off"][:, :dg * 18], a["mask"], torch.cat([a["weight"]] * groups, 1),
            a["bias"], **kw)}
    errs = {}
    for name, fn in calls.items():
        got = fn({k: v.cuda() for k, v in args.items()})
        errs[name] = _rel_err(got, fn(args))
    rois = torch.tensor([[0, 2, 3, 40, 50], [1, 0, 0, 63, 63], [1, 10.4, 6.6, 30.5, 60],
                         [0, -6, -4, 20, 17]])
    trans = torch.randn(4, 2, 7, 7, generator=gen)
    xp = torch.randn(b, 8 * 49, 48, 48, generator=gen)
    pk = dict(spatial_scale=0.75, out_size=7, output_dim=8, group_size=7, sample_per_part=4,
              trans_std=0.1, no_trans=False)
    top, count = dp.deform_psroi_pool(xp.cuda(), rois.cuda(), trans.cuda(), **pk)
    want_top, want_count = dp.deform_psroi_pool(xp, rois, trans, **pk)
    errs["deform_psroi_pool"] = _rel_err(top, want_top)
    same_count = torch.equal(count.cpu(), want_count)
    log("DCN variants and PSRoI pooling on the card against the CPU (f32, C=64, groups 2, "
        "deformable groups 4, stride 2, dilation 2; the pool 8 x 7 x 7 from 392 channels): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" of the peak (bar 1e-5); the pool's counts equal: {same_count} ({card})")
    if not all(v <= 1e-5 for v in errs.values()) or not same_count:
        fail("DCN variants: the card disagrees with the CPU")
    return errs


def remaining_modules(card: str, train_ms: float | None = None) -> dict:
    """Phase 18: the modules of the JAX package ported last, on the card:
    the eval CLI's drawing path, ``pose_hrnet``, the window encoder,
    ``tools/time_train_step``, ``tools/exp_fused_train_mlp`` (K2) and the
    DCN variants.  Returns each path's launches."""
    import torch

    from otpose_tpu_torch.ops.cuda import fused_mlp
    from otpose_tpu_torch.tools import exp_fused_train_mlp, time_train_step

    phase_t0 = time.perf_counter()
    cli = vis_eval_cli(card)
    torch.cuda.empty_cache()
    pose_hrnet(card)
    torch.cuda.empty_cache()
    enc = window_encoder(card)
    torch.cuda.empty_cache()

    reset_counts()
    tts = time_train_step.run(batch=8, iters=3, remat=False, log=log)
    counts = read_counts()
    log(f"tools/time_train_step (bf16, B=8, no remat): {tts['ms']:.2f} ms a step, "
        f"{tts['clips_per_s']:.3f} clips/s; phase 12's bf16 B=8 step in this call: "
        + (f"{train_ms:.2f} ms" if train_ms is not None else "not run") + f" ({card})")
    if tts["launches"] != TRAIN_COUNTS or counts["deform_conv_bwd"] != 5:
        fail(f"time_train_step: launches a step {tts['launches']} (expected {TRAIN_COUNTS}), "
             f"{counts['deform_conv_bwd']} DCN backward launches over 5 steps")
    torch.cuda.empty_cache()

    reset_counts()
    k2 = exp_fused_train_mlp.run(batch=8, channels=136, tokens=6912, blocks=6, iters=10,
                                 rounds=3, log=log)
    k2_counts = read_counts()
    fused_share = sum(k2["fused_ms"]) / sum(k2["plain_ms"])
    x, params = exp_fused_train_mlp.make_inputs(8, 136, 6912, 1, torch.bfloat16, "cuda")
    a = exp_fused_train_mlp.one_block_gradients(x, params[0])
    b = exp_fused_train_mlp.one_block_gradients(x, params[0])
    spread = max((p - q).abs().max().item() for p, q in zip(a["plain"][1], b["plain"][1]))
    grads_gap = max(k2["one_block"][n] for n in ("x",) + exp_fused_train_mlp.PARAMS)
    log(f"K2 (tools/exp_fused_train_mlp, 6 blocks, B=8, C=136, T=6912, bf16): plain "
        + ", ".join(f"{v:.3f}" for v in k2["plain_ms"]) + " ms, fused "
        + ", ".join(f"{v:.3f}" for v in k2["fused_ms"])
        + f" ms a round's call (bound {k2['bound_ms']:.4f} ms, {k2['bound_by']}); fused / "
        f"plain {fused_share:.3f}; one block's gradients, fused "
        f"against plain: max |d| {grads_gap:.3e} (two plain runs' spread {spread:.3e}); "
        f"fused-MLP launches {k2['launches']} over {3 * 10} timed fused calls ({card})")
    if grads_gap > spread or k2["launches"] != 6 * 3 * 10 or \
            k2_counts["fused_mlp"] < k2["launches"]:
        fail(f"K2: gradients {k2['one_block']} (spread {spread}), launches {k2['launches']}")
    del x, params, a, b
    torch.cuda.empty_cache()

    dcn_variants(card)
    log(f"remaining modules (phase 18): {time.perf_counter() - phase_t0:.1f} s")
    return {"eval_cli_heatmap_per_batch": {k: v // cli[(False, True)]["batches"]
                                           for k, v in cli[(False, True)]["counts"].items()},
            "eval_cli_heatmap_flip_per_batch": {k: v // cli[(True, True)]["batches"]
                                                for k, v in cli[(True, True)]["counts"].items()},
            "window_encoder": enc["counts"], "time_train_step": tts["launches"],
            # a fused-arm call: forward and backward through the six blocks
            "k2_tool": dict(k2_counts, fused_mlp=k2["launches"] // 30),
            "k2": dict(plain_ms=k2["plain_ms"], fused_ms=k2["fused_ms"], share=fused_share,
                       bound_ms=k2["bound_ms"])}


# ---------------------------------------------------------------------------
# phase 19: sequence parallelism on the card
# ---------------------------------------------------------------------------

SP_EVAL_LAYOUT = (2, 2)     # data x seq: four ranks, bf16 eval at B = 16 and the flip
SP_TRAIN_LAYOUT = (1, 2)    # two ranks: f32 eval at B = 2 and the train steps
SP_UNEVEN_LAYOUT = (1, 5)   # five ranks, T = 6912 in unequal slices: f32 eval and SGD, B = 2
SP_SEED = 19


def _calibrate_bn_(model, x, margin) -> None:
    """Set every BN layer's running statistics to its input's (biased)
    statistics on the clip ``x``, layer by layer in one eval forward, so
    that every BN output is normalised: at weights of std 1/sqrt(fan_in)
    the running statistics 0 / 1 let HRNet's activations grow to ~1e8."""
    import torch

    from otpose_tpu_torch.models.core import BatchNorm

    def calibrate(m, args):
        xf = args[0].float()
        m.running_mean.copy_(xf.mean(dim=(0, 2, 3)))
        m.running_var.copy_(xf.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model.eval()(x, margin)
    finally:
        for hook in hooks:
            hook.remove()


def _sp_cfg(layout):
    cfg = _flagship_cfg()
    cfg.TPU.MESH_AXES, cfg.TPU.MESH_SHAPE = ["data", "seq"], list(layout)
    return cfg


def _sp_base(cfg, state):
    """The flagship model with phase 19's weights ``state``, built once a
    process: its modules made and ``state`` loaded, no reference init drawn
    (its draws take seconds on a host that five ranks share)."""
    from otpose_tpu_torch.models.otpose import OTPose, OTPoseSpec

    model = OTPose(OTPoseSpec.from_cfg(cfg))
    model.load_state_dict(state)
    return model.cuda().eval()


def _sp_model(base, dtype=None):
    """A copy of ``base``: bf16 weights for a bf16 eval (``dtype``), the f32
    master weights for training (``dtype`` None)."""
    import torch

    from otpose_tpu_torch.models.otpose import prepare_eval_params

    model = copy.deepcopy(base)
    if dtype is None:
        return model
    return prepare_eval_params(model, torch.bfloat16 if dtype == "bfloat16" else None)


def _sp_runs(fn, reps: int, barrier=None) -> tuple:
    """``fn()`` ``reps`` times, each after a barrier (``barrier``) and timed
    by CUDA events: the last outputs and each run's ms, launches, peak
    memory and collectives by group."""
    import torch

    from otpose_tpu_torch.parallel import distributed

    runs, outs = [], None
    for _ in range(reps):
        if barrier is not None:
            barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        before = dict(distributed.COUNTS)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        outs = fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(dict(ms=start.elapsed_time(end), counts=read_counts(),
                         collectives={k: distributed.COUNTS[k] - before[k] for k in before},
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
    return outs, runs


def _sp_eval_worker(spec, base, seq, mesh, dtype: str, batch: int, flip: bool) -> tuple:
    """This rank's decoded (timed: a warm-up, then ``spec["reps"]``) and
    heatmap eval steps, and the flip once where asked, on its data group's
    rows of the first ``batch`` clips; the fetched outputs."""
    import torch

    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step, make_eval_step
    from otpose_tpu_torch.parallel import distributed
    from otpose_tpu_torch.parallel.mesh import make_eval_shard_fn

    model = _sp_model(base, dtype)
    clips = torch.load(spec["clips"], weights_only=True)
    rows, sharded = make_eval_shard_fn(mesh)({k: v[:batch].cuda() for k, v in clips.items()},
                                             "cuda")
    if not sharded:
        fail(f"sequence parallel eval: a batch of {batch} was not split over the data groups")
    steps = {"decoded": make_decoded_eval_step(model, compute_dtype=dtype, seq=seq),
             "heatmap": make_eval_step(model, compute_dtype=dtype, seq=seq)}
    if flip:
        steps["flip"] = make_decoded_eval_step(model, compute_dtype=dtype, flip=True, seq=seq)
    out, arrays = {"rows": len(rows["inputs"])}, {}
    for name, step in steps.items():
        reps = spec["reps"] + 1 if name == "decoded" else 1
        outs, runs = _sp_runs(lambda step=step: step(rows["inputs"], rows["margin"]), reps,
                              distributed.barrier)
        out[name] = runs[1:] if name == "decoded" else runs
        arrays[name] = [distributed.fetch(o) for o in outs]
    del model, steps
    torch.cuda.empty_cache()
    return out, arrays


def _worker_seq_eval(spec: dict) -> dict:
    """Phase 19's four ranks at ``data = 2 x seq = 2``: bf16 eval at B = 16
    (decoded, heatmap, flip)."""
    import numpy as np
    import torch

    from otpose_tpu_torch.parallel import distributed
    from otpose_tpu_torch.parallel.mesh import make_mesh, seq_group

    cfg = _sp_cfg(spec["layout"])
    rank, world = distributed.maybe_initialize(cfg)
    mesh = make_mesh(cfg)
    t0 = time.perf_counter()
    base = _sp_base(cfg, torch.load(spec["model"], weights_only=True))
    built = time.perf_counter() - t0
    res, arrays = _sp_eval_worker(spec, base, seq_group(mesh), mesh, "bfloat16", BATCH, True)
    if rank == 0:
        np.savez(spec["arrays"], **{f"{n}_{i}": a for n, v in arrays.items()
                                    for i, a in enumerate(v)})
    return dict(rank=rank, world=world, transport=distributed.device_transport(),
                seq=distributed.seq_info(), data=distributed.data_info(),
                seconds=dict(build=built, run=time.perf_counter() - t0 - built), **res)


def _sp_r1_cases(cfg, seq) -> dict:
    """Phase 20 (e), R1's splits inside phase 19's ranks at ``1 x 5``: the
    flagship's temporal encoder (C = 136, two heads) at T = 8 (2 x 4), whose
    stride-4 split leaves three of the five ranks no token (4, 4, 0, 0, 0),
    and phase 18's window-19 encoder at T = 32 (4 x 8: slices 8, 8, 8, 4,
    4, then 4, 4, 4, 2, 2 and 2, 2, 2, 1, 1), whose 9 halo tokens a side
    span several slices.  In f32, seeded, each one's gathered outputs
    against its one-rank plain forward in this process: the worst error
    over the peak, the slices and the launches."""
    import torch

    from otpose_tpu_torch.models.conv_transformer import (ConvTransformer,
                                                          ConvTransformerSpec,
                                                          init_conv_transformer_)
    from otpose_tpu_torch.models.otpose import OTPoseSpec

    out = {}
    for name, spec, hw in (("empty_rank", OTPoseSpec.from_cfg(cfg).temporal_spec(), (2, 4)),
                           ("wide_window", ConvTransformerSpec(**WINDOW_SPEC), (4, 8))):
        enc = init_conv_transformer_(ConvTransformer(spec),
                                     torch.Generator().manual_seed(20)).eval().cuda()
        x = torch.randn(2, spec.n_in, *hw, generator=torch.Generator().manual_seed(21)).cuda()
        with torch.no_grad():
            want = enc(x, fused=False)
            reset_counts()
            got = enc(x, seq=seq)
            torch.cuda.synchronize()
        split = seq.split(hw[0] * hw[1], spec.scale_factor ** spec.arch[2])
        out[name] = dict(err=max(((g - w).abs().max() / w.abs().max()).item()
                                 for g, w in zip(got, want)),
                         lengths=split.lengths, counts=read_counts())
    return out


def _worker_seq_train(spec: dict) -> dict:
    """Phase 19's two ranks at ``data = 1 x seq = 2`` or five at ``1 x 5``:
    f32 eval at B = 2, then the train steps of ``spec["train"]``: a bf16
    step at B = 4 (after a warm-up step) and an f32 SGD step at B = 2 (rank
    0's state after it to ``spec["state"]``)."""
    import numpy as np
    import torch

    from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
    from otpose_tpu_torch.engine.trainer import make_train_step
    from otpose_tpu_torch.parallel import distributed
    from otpose_tpu_torch.parallel.mesh import make_mesh, seq_group

    cfg = _sp_cfg(spec["layout"])
    rank, world = distributed.maybe_initialize(cfg)
    mesh = make_mesh(cfg)
    seq = seq_group(mesh)
    t0 = time.perf_counter()
    base = _sp_base(cfg, torch.load(spec["model"], weights_only=True))
    built = time.perf_counter() - t0
    res, arrays = _sp_eval_worker(spec, base, seq, mesh, "float32", 2, False)
    if rank == 0:
        np.savez(spec["arrays"], **{f"{n}_{i}": a for n, v in arrays.items()
                                    for i, a in enumerate(v)})
    out = dict(rank=rank, world=world, transport=distributed.device_transport(),
               seq=distributed.seq_info(), data=distributed.data_info(), eval=res)
    if spec.get("r1"):
        out["r1"] = _sp_r1_cases(cfg, seq)
    batches = torch.load(spec["batches"], weights_only=True)
    for dtype, reps, conf in (("bfloat16", 2, cfg), ("float32", 1, _sgd(cfg))):
        if dtype not in spec["train"]:
            continue
        model = _sp_model(base)
        step = make_train_step(model, make_optimizer(model, conf, make_schedule(conf, 1)),
                               compute_dtype=dtype, seq=seq,
                               generator=torch.Generator(device="cuda").manual_seed(SP_SEED))
        full = batches[dtype]
        rows = distributed.local_rows(len(full["inputs"]))
        batch = {k: v[rows].cuda() for k, v in full.items()}
        metrics, runs = _sp_runs(lambda step=step, batch=batch: step(batch), reps,
                                 distributed.barrier)
        # the first of two steps warms up (cuDNN's and cuBLAS's handles, the
        # DCN backward's scratch)
        out[dtype] = dict(runs=runs[-1:], rows=len(rows), digest=_digest(model),
                          metrics={k: v.item() for k, v in metrics.items()})
        if dtype == "float32" and rank == 0:
            torch.save(_host_sd(model), spec["state"])
        del model, step
        torch.cuda.empty_cache()
    out["seconds"] = dict(build=built, run=time.perf_counter() - t0 - built)
    return out


def _sp_one_rank(cfg, base, clips, batches) -> dict:
    """The references in this process, without a launch: the plain eval
    steps (f32 at B = 16 and B = 2, timed at B = 2, bf16 at B = 16, timed),
    and the train
    steps (bf16 at B = 4, a warm-up and a timed step; one f32 SGD step at
    B = 2) from the same weights and generator seed."""
    import torch

    from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
    from otpose_tpu_torch.engine.trainer import (make_decoded_eval_step, make_eval_step,
                                                 make_train_step)

    ref = {}
    for dtype in ("float32", "bfloat16"):
        model = _sp_model(base, dtype)
        heat = make_eval_step(model, compute_dtype=dtype, fused=False)
        ref[f"heat_{dtype}"] = _to_numpy(heat(clips["inputs"], clips["margin"])[0])
        decoded = make_decoded_eval_step(model, compute_dtype=dtype, fused=False)
        if dtype == "float32":
            ref["heat_f32_b2"] = _to_numpy(heat(clips["inputs"][:2], clips["margin"][:2])[0])
            outs, runs = _sp_runs(lambda: decoded(clips["inputs"][:2], clips["margin"][:2]), 3)
            ref["decoded_f32_b2"] = [_to_numpy(o) for o in outs]
            ref["decoded_f32_b2_runs"] = runs[1:]
        else:
            _, runs = _sp_runs(lambda: decoded(clips["inputs"], clips["margin"]), 3)
            ref["decoded_bf16"] = runs[1:]
        del model, heat, decoded
        torch.cuda.empty_cache()
    for dtype, reps, conf in (("bfloat16", 2, cfg), ("float32", 1, _sgd(cfg))):
        model = _sp_model(base)
        step = make_train_step(model, make_optimizer(model, conf, make_schedule(conf, 1)),
                               compute_dtype=dtype,
                               generator=torch.Generator(device="cuda").manual_seed(SP_SEED))
        metrics, runs = _sp_runs(lambda step=step, batch=batches[dtype]: step(batch), reps)
        ref[f"train_{dtype}"] = dict(runs=runs[-1:],
                                     metrics={k: v.item() for k, v in metrics.items()})
        if dtype == "float32":
            ref["state_f32"] = _host_sd(model)
        del model, step
        torch.cuda.empty_cache()
    return ref


def _median_ms(runs) -> float:
    return sorted(r["ms"] for r in runs)[len(runs) // 2]


def _sp_f32_eval(path, one, layout, card: str) -> tuple:
    """An f32 decoded eval at B = 2 on ``layout`` (its rank 0's arrays at
    ``path``) against the one-rank plain step: the line, and whether the
    heatmaps are within 1e-5 of their peak and the keypoints equal on every
    clear peak (a top-two gap above 2e-5 of the peak)."""
    import numpy as np

    with np.load(path) as z:
        got = {k: z[k] for k in z.files}
    heat, want = got["heatmap_0"], one["heat_f32_b2"]
    peak = np.abs(want).max()
    err = np.abs(heat - want).max() / peak
    flat = np.sort(want.transpose(0, 3, 1, 2).reshape(2, want.shape[-1], -1), axis=-1)
    clear = (flat[..., -1] - flat[..., -2]) > 2e-5 * peak
    same = (got["decoded_0"] == one["decoded_f32_b2"][0]).all(-1)
    log(f"sequence parallel f32 decoded eval, B=2 at data {layout[0]} x seq {layout[1]} "
        f"({layout[1]} ranks sharing the card, gloo): heatmaps to {err:.3e} of their peak "
        f"{peak:.4g} against the one-rank plain step (limit 1e-5); keypoints equal on "
        f"{int(same[clear].sum())}/{int(clear.sum())} clear peaks ({int(same.sum())}/"
        f"{same.size} in all; {clear.mean():.1%} of the peaks are clear: a top-two gap above "
        f"2e-5 of the peak) ({card})")
    return err <= 1e-5 and clear.mean() >= 0.5 and bool(same[clear].all())


def _sp_f32_train(path, ranks, one, state, layout, card: str) -> bool:
    """An f32 SGD step at B = 2 on ``layout`` (rank 0's state after it at
    ``path``) against the one-rank step: the line, and whether each
    tensor's update is within 1e-4 of its peak plus 1e-6 of the largest and
    the ranks end bit-equal."""
    import torch

    sp_state = torch.load(path, weights_only=True)
    want = one["state_f32"]
    refs = {k: want[k] - state[k] for k, v in sp_state.items() if v.is_floating_point()}
    top = max(r.abs().max().item() for r in refs.values())
    ratios = sorted((((sp_state[k] - state[k] - ref).abs().max().item()
                      / (1e-4 * ref.abs().max().item() + 1e-6 * top)), k)
                    for k, ref in refs.items() if ref.abs().max() > 0)[::-1]
    m_sp, m_one = ranks[0]["float32"]["metrics"], one["train_float32"]["metrics"]
    worst_m = max((abs(m_sp[k] / m_one[k] - 1), k) for k in m_one if m_one[k])
    digests = {r["float32"]["digest"] for r in ranks}
    log(f"sequence parallel f32 SGD train step, B=2 at data {layout[0]} x seq {layout[1]}, "
        f"dropout at the yaml's rates from one generator seed: each tensor's update (weights "
        f"and running stats) against its limit (1e-4 of its peak plus 1e-6 of the largest), "
        f"the five worst: " + ", ".join(f"{k} {r:.3g}" for r, k in ratios[:5])
        + f"; metrics to {worst_m[0]:.3e} ({worst_m[1]}) relative; the {len(ranks)} ranks "
        + ("bit-equal" if len(digests) == 1 else "DIFFER") + f" ({card})")
    return ratios[0][0] <= 1 and len(digests) == 1


def _sp_checks(cfg, one, ev, tr, un, spec_e, spec_t, spec_u, state, card: str) -> None:
    """Phase 19's gates and lines (see the module docstring)."""
    import numpy as np

    from otpose_tpu_torch.models.otpose import OTPoseSpec
    from otpose_tpu_torch.parallel.sequence import split_lengths

    spec = OTPoseSpec.from_cfg(cfg)
    encoders = (spec.flow_scale_arch, spec.scale_arch, spec.scale_arch)
    # a stem block's halo, score sum and scramble, a branch block's and its
    # skip's halo, a gather an encoder output; backward: the gathers' are
    # local, the shards' gather; one sum of the encoders' gradients a step
    fwd = sum(3 * a[1] + 4 * a[2] + 1 + a[2] for a in encoders)
    bwd = fwd - sum(1 + a[2] for a in encoders) + len(encoders)
    eval_counts = dict(FORWARD_COUNTS, fused_attn=0, fused_mlp=0)
    flip_counts = {k: 2 * v for k, v in eval_counts.items()}
    if any(r["transport"][0] != "gloo" for r in ev + tr + un):
        fail(f"sequence parallel: ranks sharing one card took {ev[0]['transport']}")

    # ------------------------------------------- f32 eval, 1 x 2, B = 2
    if not _sp_f32_eval(spec_t["arrays"], one, SP_TRAIN_LAYOUT, card):
        fail("sequence parallel: the f32 eval is not the one-rank step")
    # ------------------------------------------- bf16 eval, 2 x 2, B = 16
    with np.load(spec_e["arrays"]) as z:
        got = {k: z[k] for k in z.files}
    f32 = one["heat_float32"]
    rms = lambda a: float(np.sqrt(np.mean((a - f32) ** 2)))  # noqa: E731
    rms_sp, rms_one = rms(got["heatmap_0"]), rms(one["heat_bfloat16"])
    differ = float((got["heatmap_0"] != one["heat_bfloat16"]).mean())
    finite = all(np.isfinite(v).all() for v in got.values())
    log(f"sequence parallel bf16 eval, B=16 at data 2 x seq 2 (four ranks): heatmaps' RMS "
        f"from the f32 answer {rms_sp:.4e} against the one-rank bf16 plain step's "
        f"{rms_one:.4e} (limit twice); {differ:.2%} of the outputs differ from the one-rank "
        f"bf16 plain step's; the flip's keypoints finite: {finite} ({card})")
    if not (finite and rms_sp <= 2 * rms_one):
        fail("sequence parallel: the bf16 eval")
    # ------------------------------------------- launches and collectives
    bad = [(r["rank"], n, run["counts"]) for r in ev for n in ("decoded", "heatmap", "flip")
           for run in r[n] if run["counts"] != (flip_counts if n == "flip" else eval_counts)]
    bad += [(r["rank"], "f32 eval", run["counts"]) for r in tr + un
            for run in r["eval"]["decoded"] if run["counts"] != eval_counts]
    bad += [(r["rank"], d, run["counts"]) for r in tr + un for d in ("bfloat16", "float32")
            for run in r.get(d, {}).get("runs", ()) if run["counts"] != TRAIN_COUNTS]
    per_fwd = ev[0]["decoded"][0]["collectives"]
    per_micro = tr[0]["bfloat16"]["runs"][-1]["collectives"]
    log(f"sequence parallel launches a rank: an eval batch {ev[0]['decoded'][0]['counts']}, a "
        f"flip batch {ev[0]['flip'][0]['counts']}, a train micro-batch "
        f"{tr[0]['bfloat16']['runs'][-1]['counts']}; collectives by group a forward {per_fwd} "
        f"({fwd} seq expected), a train micro-batch {per_micro} ({fwd + bwd + 1} seq expected)")
    if bad:
        fail(f"sequence parallel: launches {bad[:4]}")
    if per_fwd["seq"] != fwd or per_fwd["device"] != 0 or per_micro["seq"] != fwd + bwd + 1:
        fail("sequence parallel: the collectives a forward or a micro-batch")
    # ------------------------------------------- f32 train step, 1 x 2, B = 2
    if not _sp_f32_train(spec_t["state"], tr, one, state, SP_TRAIN_LAYOUT, card):
        fail("sequence parallel: the f32 train step is not the one-rank step")
    # ------------------------------------------- bf16 train, time, memory
    bf = [r["bfloat16"] for r in tr]
    finite = all(math.isfinite(v) for b in bf for v in b["metrics"].values())
    log(f"sequence parallel bf16 train step, B=4 at data 1 x seq 2: metrics {bf[0]['metrics']}; "
        f"the ranks " + ("bit-equal" if len({b['digest'] for b in bf}) == 1 else "DIFFER")
        + f"; ms a step {', '.join(f'{_median_ms(b['runs']):.2f}' for b in bf)} (one rank "
        f"{_median_ms(one['train_bfloat16']['runs']):.2f}); peak memory a rank "
        + ", ".join(f"{max(r['peak_gib'] for r in b['runs']):.2f}" for b in bf)
        + f" GiB (one rank at B=4 {max(r['peak_gib'] for r in one['train_bfloat16']['runs']):.2f}"
        f" GiB) ({card})")
    if not (finite and len({b["digest"] for b in bf}) == 1):
        fail("sequence parallel: the bf16 train step")
    ms_sp = max(_median_ms(r["decoded"]) for r in ev)
    ms_one = _median_ms(one["decoded_bf16"])
    log(f"sequence parallel bf16 decoded eval, B=16 at data 2 x seq 2: {BATCH / ms_sp * 1e3:.3f}"
        f" clips/s ({ms_sp:.2f} ms a batch, the slowest rank's median) against one rank's plain "
        f"step {BATCH / ms_one * 1e3:.3f} clips/s ({ms_one:.2f} ms); peak memory a rank "
        + ", ".join(f"{max(x['peak_gib'] for x in r['decoded']):.2f}" for r in ev)
        + f" GiB (one rank at B=16 {max(x['peak_gib'] for x in one['decoded_bf16']):.2f} GiB). "
        f"The ranks share one card over gloo: these are no scaling numbers ({card})")
    # ------------------------------------------- unequal slices: 1 x 5, f32, B = 2
    t = cfg.MODEL.HEATMAP_SIZE[0] * cfg.MODEL.HEATMAP_SIZE[1]
    size = SP_UNEVEN_LAYOUT[1]
    slices = {f"stride {s}": split_lengths(t, size, s)
              for s in sorted({e.scale_factor ** e.arch[2]
                               for e in (spec.flow_spec(), spec.temporal_spec())})}
    ok_eval = _sp_f32_eval(spec_u["arrays"], one, SP_UNEVEN_LAYOUT, card)
    u_fwd = un[0]["eval"]["decoded"][0]["collectives"]
    u_micro = un[0]["float32"]["runs"][-1]["collectives"]
    ms_u = max(_median_ms(r["eval"]["decoded"]) for r in un)
    ms_one = _median_ms(one["decoded_f32_b2_runs"])
    log(f"sequence parallel at data 1 x seq {size}, T = {t} in unequal slices "
        + ", ".join(f"{k} {v}" for k, v in slices.items())
        + f": collectives by group a forward {u_fwd} ({fwd} seq expected), an f32 train "
        f"micro-batch {u_micro} ({fwd + bwd + 1} seq expected); launches a rank an eval batch "
        f"{un[0]['eval']['decoded'][0]['counts']}, a train micro-batch "
        f"{un[0]['float32']['runs'][-1]['counts']}; f32 decoded eval at B=2 {ms_u:.2f} ms a "
        f"batch (the slowest rank's median) against one rank's plain step {ms_one:.2f} ms; "
        f"peak memory a rank "
        + ", ".join(f"{max(x['peak_gib'] for x in r['eval']['decoded']):.2f}" for r in un)
        + f" GiB in the eval (one rank "
        f"{max(x['peak_gib'] for x in one['decoded_f32_b2_runs']):.2f} GiB), "
        + ", ".join(f"{max(x['peak_gib'] for x in r['float32']['runs']):.2f}" for r in un)
        + f" GiB in the f32 step (one rank "
        f"{max(x['peak_gib'] for x in one['train_float32']['runs']):.2f} GiB). The ranks "
        f"share one card over gloo: these are no scaling numbers ({card})")
    if not ok_eval:
        fail(f"sequence parallel: the f32 eval at 1 x {size} is not the one-rank step")
    if u_fwd["seq"] != fwd or u_fwd["device"] != 0 or u_micro["seq"] != fwd + bwd + 1:
        fail(f"sequence parallel: the collectives a forward or a micro-batch at 1 x {size}")
    if not _sp_f32_train(spec_u["state"], un, one, state, SP_UNEVEN_LAYOUT, card):
        fail(f"sequence parallel: the f32 train step at 1 x {size} is not the one-rank step")


def sequence_parallel(card: str) -> dict:
    """Phase 19: the port's sequence parallelism on the card, ranks sharing
    it as ``--dist-worker`` processes (a ``gloo`` device group) against this
    process's one-rank steps on the same weights (``_scaled_weights_`` and a
    calibrated refinement) and inputs."""
    import shutil
    import tempfile

    import torch

    from otpose_tpu_torch.models.factory import build_model

    phase_t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="otpose_sp_")
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        cfg = _flagship_cfg()
        model = build_model(cfg, seed=0)[1]
        _scaled_weights_(model, SP_SEED)
        gen = torch.Generator(device="cuda").manual_seed(SP_SEED)
        w, h = cfg.MODEL.IMAGE_SIZE
        _calibrate_bn_(model, torch.randn(2, h, w, 15, generator=gen, device="cuda"),
                       torch.ones(2, 4, device="cuda"))
        _calibrate_refinement_(model, SP_SEED)
        state = _host_sd(model)
        torch.save(state, os.path.join(root, "model.pt"))
        clips = {"inputs": torch.randn(BATCH, h, w, 15, generator=gen, device="cuda"),
                 "margin": torch.randint(0, 3, (BATCH, 4), generator=gen,
                                         device="cuda").float()}
        batches = {"bfloat16": synthetic_train_batch(cfg, 4, gen),
                   "float32": synthetic_train_batch(cfg, 2, gen)}
        torch.save({k: v.cpu() for k, v in clips.items()}, os.path.join(root, "clips.pt"))
        torch.save({d: {k: v.cpu() for k, v in b.items()} for d, b in batches.items()},
                   os.path.join(root, "batches.pt"))
        t0 = time.perf_counter()
        one = _sp_one_rank(cfg, model, clips, batches)
        one_s = time.perf_counter() - t0
        del clips, batches, model
        torch.cuda.empty_cache()
        common = {"model": os.path.join(root, "model.pt"),
                  "clips": os.path.join(root, "clips.pt"),
                  "batches": os.path.join(root, "batches.pt"), "reps": 2}
        spec_e = dict(common, layout=list(SP_EVAL_LAYOUT), arrays=os.path.join(root, "ev.npz"),
                      out=os.path.join(root, "seq_eval_%d.json"))
        spec_t = dict(common, layout=list(SP_TRAIN_LAYOUT), arrays=os.path.join(root, "tr.npz"),
                      state=os.path.join(root, "state.pt"), train=["bfloat16", "float32"],
                      out=os.path.join(root, "seq_train_%d.json"))
        spec_u = dict(common, layout=list(SP_UNEVEN_LAYOUT), arrays=os.path.join(root, "un.npz"),
                      state=os.path.join(root, "state_uneven.pt"), train=["float32"],
                      out=os.path.join(root, "seq_uneven_%d.json"), r1=True)
        t0 = time.perf_counter()
        ev = _dist_wait(_dist_start("seq_eval", spec_e, "seq_eval",
                                    SP_EVAL_LAYOUT[0] * SP_EVAL_LAYOUT[1]),
                        spec_e, "sequence parallel eval")
        ev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tr = _dist_wait(_dist_start("seq_train", spec_t, "seq_train",
                                    SP_TRAIN_LAYOUT[0] * SP_TRAIN_LAYOUT[1]),
                        spec_t, "sequence parallel train")
        tr_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        un = _dist_wait(_dist_start("seq_train", spec_u, "seq_uneven",
                                    SP_UNEVEN_LAYOUT[0] * SP_UNEVEN_LAYOUT[1]),
                        spec_u, "sequence parallel on unequal slices")
        un_s = time.perf_counter() - t0
        _sp_checks(cfg, one, ev, tr, un, spec_e, spec_t, spec_u, state, card)
        r1 = _sp_r1_check(un, card)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
        shutil.rmtree(root, ignore_errors=True)
    log(f"sequence parallel phase: {time.perf_counter() - phase_t0:.1f} s (one rank "
        f"{one_s:.1f} s, the four eval ranks {ev_s:.1f} s, the two train ranks {tr_s:.1f} s, "
        f"the five ranks on unequal slices {un_s:.1f} s; a rank's model build / its work: eval "
        f"{ev[0]['seconds']['build']:.1f} / {ev[0]['seconds']['run']:.1f} s, train "
        f"{tr[0]['seconds']['build']:.1f} / {tr[0]['seconds']['run']:.1f} s, unequal "
        f"{un[0]['seconds']['build']:.1f} / {un[0]['seconds']['run']:.1f} s)")
    return dict(eval=ev[0]["decoded"][0]["counts"], train=tr[0]["bfloat16"]["runs"][-1]["counts"],
                uneven_eval=un[0]["eval"]["decoded"][0]["counts"],
                uneven_train=un[0]["float32"]["runs"][-1]["counts"], r1=r1)


def _sp_r1_check(un, card: str) -> dict:
    """Phase 20 (e)'s gate on the five ranks' ``_sp_r1_cases``: every
    rank's gathered outputs within 1e-5 of the peak of the one-rank plain
    forward, no kernel launched (the fused kernels are off under ``seq``;
    an encoder has no DCN), and the slices as the split gives them."""
    none = {k: 0 for k in FORWARD_COUNTS}
    out = {}
    for name in ("empty_rank", "wide_window"):
        errs = [r["r1"][name]["err"] for r in un]
        lengths = un[0]["r1"][name]["lengths"]
        counts = [r["r1"][name]["counts"] for r in un]
        log(f"R1 at data 1 x seq {SP_UNEVEN_LAYOUT[1]} (phase 20 (e), in phase 19's ranks): "
            f"{name}, slices {lengths} at the first level: each rank's gathered outputs to "
            + ", ".join(f"{e:.3e}" for e in errs) + " of the peak against the one-rank plain "
            f"forward (limit 1e-5); launches a rank {counts[0]} ({card})")
        if not all(e <= 1e-5 for e in errs) or any(c != none for c in counts):
            fail(f"sequence parallel R1 {name}: the ranks disagree with one rank or launched")
        out[name] = dict(err=max(errs), lengths=lengths)
    if 0 not in out["empty_rank"]["lengths"]:
        fail("sequence parallel R1: no rank of the empty_rank case is empty")
    return out


# ---------------------------------------------------------------------------
# phase 20: the joint and dilation counts beyond the shipped configs
# ---------------------------------------------------------------------------

WIDE_JOINTS = (26, 133)                  # Halpe-26; COCO-WholeBody's 133
WIDE_BATCH = 2
# the launches a forward at those joints (fused attention, fused MLP, DCN)
# by JAX's gate (``otpose_tpu/models/blocks.py::transformer_block_ct``):
# every eval block of C >= 32, the attention where its stride is 1
WIDE_COUNTS = {26: (12, 16, 1), 133: (18, 22, 1)}
PREDICATE_CHANNELS = 1100                # (d)'s grid: past Halpe-136's 1088
NINE_DILATIONS = tuple(range(3, 30, 3))  # the flagship's five, continued to nine
# (c)'s DCN at O = C = 133, B = 2 before the wide paths: the grouped launches'
# ms (PERF.md section 6, rows 3 and 6, in brackets; H100 80GB HBM3 at 700 W),
# which the wide kernels must not exceed.  They serve the gate and its log
# line only: the kernels line holds what this run measured
PARENT_DCN_MS = {"bfloat16 O=133 D=5 B=2": 3.0177, "bfloat16 O=133 D=9 B=2": 5.4469,
                 "float32 O=133 D=5 B=2": 3.5309, "float32 O=133 D=9 B=2": 6.3283}
PARENT_DCN_BWD_MS = {"bfloat16 O=133 D=5 B=2": 12.2966, "float32 O=133 D=9 B=2": 41.6769}


def gate_counts(model, dtype, joints: int, dilations) -> dict:
    """The launches a forward of ``model`` makes by the blocks' gate: a
    global stride-1 block's attention and every block's MLP at C >= 32
    where its kernel takes the shape (``supports``), and the DCN's groups
    of launches (``kernel_launches``)."""
    from otpose_tpu_torch.models.blocks import TransformerBlock
    from otpose_tpu_torch.ops.cuda import deform_conv, fused_attn, fused_mlp

    attn = mlp = 0
    for m in model.modules():
        if isinstance(m, TransformerBlock):
            c = m.ln1.weight.numel()
            attn += (c >= 32 and m.window <= 1 and m.ds_stride == 1
                     and fused_attn.supports(c, m.n_head, dtype))
            mlp += c >= 32 and fused_mlp.supports(c, dtype)
    return dict(FORWARD_COUNTS, fused_attn=attn, fused_mlp=mlp,
                deform_conv=deform_conv.kernel_launches(len(dilations), joints))


def wide_counts(model, dtype) -> tuple:
    """(attention, MLP) launches a forward of ``model`` makes on the wide
    paths by the blocks' gate: the fused blocks whose shape ``narrow`` (the
    attention) or ``MAX_CHANNELS`` (the MLP) leaves to the wide path."""
    from otpose_tpu_torch.models.blocks import TransformerBlock
    from otpose_tpu_torch.ops.cuda import fused_attn, fused_mlp

    attn = mlp = 0
    for m in model.modules():
        if isinstance(m, TransformerBlock):
            c = m.ln1.weight.numel()
            if c < 32:
                continue
            attn += (m.window <= 1 and m.ds_stride == 1 and fused_attn.supports(c, m.n_head, dtype)
                     and not fused_attn.narrow(c, m.n_head, dtype))
            align = fused_mlp.CHANNEL_ALIGN[dtype]
            mlp += fused_mlp.supports(c, dtype) and -(-c // align) * align > fused_mlp.MAX_CHANNELS
    return attn, mlp


def wide_flagship(card: str, joints: int) -> dict:
    """Phase 20 (b): the flagship (HRNet-W48, 384x288) at ``joints`` joints,
    decoded eval at B = 2 in bf16 (bf16 weights) and in f32 (TF32 off),
    each with the fused kernels and without (``fused=False``): the launches
    JAX's gate gives (``WIDE_COUNTS``; the fused kernels none without
    them), finite outputs of the shapes; f32: the seven outputs of a forward
    with the kernels to 1e-3 of each output's peak against without; bf16:
    the decoded keypoints with the kernels equal to those without on every
    clear peak of the plain step's heatmaps (phase 20 (a)'s gate, a clear
    peak's top-two gap above 1% of the joint's peak), the share within
    ``KP_PX`` and a control (plain bf16 against plain f32) printed; ms a
    step with and without the kernels, in turns.  Weights of std
    1/sqrt(fan_in) from a seed, BN statistics taken on the clip and the
    refinement calibrated, so the heatmaps have peaks (the reference
    init's are flat)."""
    import torch

    from otpose_tpu_torch.engine.trainer import make_decoded_eval_step
    from otpose_tpu_torch.models.factory import build_model
    from otpose_tpu_torch.models.otpose import otpose_forward, prepare_eval_params
    from otpose_tpu_torch.utils.testing import flagship_otpose_cfg
    from otpose_tpu_torch.utils.timing import time_ms

    cfg = flagship_otpose_cfg()
    cfg.MODEL.NUM_JOINTS = joints
    spec, model = build_model(cfg, seed=0)
    _scaled_weights_(model, joints)
    gen = torch.Generator(device="cuda").manual_seed(joints)
    w, h = cfg.MODEL.IMAGE_SIZE
    inputs = torch.randn(WIDE_BATCH, h, w, 15, generator=gen, device="cuda")
    margin = torch.ones(WIDE_BATCH, 4, device="cuda")
    _calibrate_bn_(model, inputs, margin)
    _calibrate_refinement_(model, joints)
    models = {"f32": model, "bf16": prepare_eval_params(copy.deepcopy(model), torch.bfloat16)}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    widths = sorted({m.ln1.weight.numel() for m in model.modules() if hasattr(m, "ln1")})
    attn, mlp, dcn = WIDE_COUNTS[joints]
    want = gate_counts(model, torch.float32, joints, spec.dilations)
    if (want["fused_attn"], want["fused_mlp"], want["deform_conv"]) != (attn, mlp, dcn):
        fail(f"flagship at {joints} joints: the blocks' gate gives {want}, JAX's "
             f"{WIDE_COUNTS[joints]}")
    plain_counts = dict(want, fused_attn=0, fused_mlp=0)
    want_wide = wide_counts(model, torch.float32)
    shapes = ((WIDE_BATCH, joints, 2), (WIDE_BATCH, joints, 1), (WIDE_BATCH, joints, 2))
    steps, coords, counts, wide = {}, {}, {}, {}
    for label in ("bf16", "f32"):
        for fused in (True, False):
            key = (label, fused)
            step = steps[key] = make_decoded_eval_step(models[label],
                                                       compute_dtype=dtypes[label], fused=fused)
            step(inputs, margin)
            torch.cuda.synchronize()
            reset_counts()
            outs = step(inputs, margin)
            torch.cuda.synchronize()
            counts[key] = read_counts()
            wide[key] = read_wide()
            if fused and wide[key] != wide_counts(model, dtypes[label]):
                fail(f"flagship at {joints} joints, {label}: wide-path launches (attention, "
                     f"MLP) {wide[key]}, expected {wide_counts(model, dtypes[label])}")
            if counts[key] != (want if fused else plain_counts):
                fail(f"flagship at {joints} joints, {label} fused={fused}: launches "
                     f"{counts[key]}, expected {want if fused else plain_counts}")
            if any(tuple(o.shape) != sh or not torch.isfinite(o).all()
                   for o, sh in zip(outs, shapes)):
                fail(f"flagship at {joints} joints, {label} fused={fused}: outputs of shape "
                     "or values off")
            coords[key] = outs[0].float()
    # f32: the seven outputs with the kernels against without
    with torch.no_grad():
        got = otpose_forward(model, inputs, margin)
        ref = otpose_forward(model, inputs, margin, fused=False)
    worst = max((g.float() - r.float()).abs().max().item()
                / max(1e-30, r.float().abs().max().item()) for g, r in zip(got, ref))
    del got, ref
    # bf16: the decoded keypoints with the kernels against without, on the
    # plain step's clear peaks (a top-two gap above 1% of the joint's peak,
    # more than two bf16 steps there); beside it, for scale, the share within
    # KP_PX and the control, plain bf16 against plain f32
    with torch.no_grad():
        heat = otpose_forward(models["bf16"], inputs, margin, compute_dtype=torch.bfloat16,
                              fused=False)[0]
    flat = heat.float().permute(0, 3, 1, 2).reshape(WIDE_BATCH, joints, -1)
    top2 = flat.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 0.01 * flat.abs().amax(dim=-1)
    same = (coords[("bf16", True)] == coords[("bf16", False)]).all(-1)
    del heat, flat
    dist = lambda a, b: (coords[a] - coords[b]).norm(dim=-1)  # noqa: E731
    within = (dist(("bf16", True), ("bf16", False)) <= KP_PX).float().mean().item()
    ctrl = (dist(("bf16", False), ("f32", False)) <= KP_PX).float().mean().item()
    ms = {key: [] for key in steps}
    for label in ("bf16", "f32"):
        for fused in (True, False, False, True):
            ms[(label, fused)].append(time_ms(lambda: steps[(label, fused)](inputs, margin),
                                              iters=3, warmup=1))
    avg = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"flagship at {joints} joints (encoder widths {widths}), decoded eval B={WIDE_BATCH}: "
        f"launches with the kernels {counts[('bf16', True)]} in bf16, "
        f"{counts[('f32', True)]} in f32 (JAX's gate: {attn} / {mlp} / {dcn}), of which on "
        f"the wide paths (attention, MLP) {wide[('bf16', True)]} in bf16, "
        f"{wide[('f32', True)]} in f32 (the gate: {want_wide}); f32 forward "
        f"with the kernels against without: worst {worst:.3e} of an output's peak (limit "
        f"1e-3); bf16 decoded keypoints with the kernels equal to those without on "
        f"{int((same & clear).sum())}/{int(clear.sum())} clear peaks (all of them: the gate), "
        f"on {same.float().mean().item():.2%} of all, within {KP_PX} px on {within:.2%} "
        f"(control, plain bf16 against plain f32: {ctrl:.2%}); ms a step "
        + ", ".join(f"{label} {'kernels' if fused else 'plain'} {avg[(label, fused)]:.2f} "
                    f"({' / '.join(f'{v:.2f}' for v in ms[(label, fused)])})"
                    for label, fused in ms)
        + f" ({card})")
    if not worst <= 1e-3:
        fail(f"flagship at {joints} joints: the f32 forward with the kernels disagrees with "
             "the plain one")
    if not clear.any() or not bool(same[clear].all()):
        fail(f"flagship at {joints} joints: the bf16 keypoints with the kernels differ from "
             "the plain step's on a clear peak (or no peak is clear)")
    del model, models, steps
    torch.cuda.empty_cache()
    return dict(counts=counts[("bf16", True)], counts_f32=counts[("f32", True)],
                wide_launches={"bf16": wide[("bf16", True)], "f32": wide[("f32", True)]},
                f32_worst=worst, bf16_clear_equal=int((same & clear).sum()),
                bf16_clear=int(clear.sum()), bf16_within=within, control_within=ctrl,
                ms={f"{label} {'kernels' if fused else 'plain'}": v
                    for (label, fused), v in avg.items()})


WIDE_ROW_SHAPES = ((WIDE_BATCH, 208, 6912), (WIDE_BATCH, 1064, 6912))   # 26 and 133 joints


def products_ms(name, args) -> float:
    """ms of the matrix products of row 1 or 2 alone, by ``torch.matmul`` at
    the same shapes and dtype on random operands (CUDA events, eager): the
    MLP's two ((B T) x C by C x 4C, then by 4C x C), the attention's three
    projections, same-head scores and att @ v.  A yardstick of the products
    only, not of the function (no LN, conv, GELU, softmax or rounding)."""
    import torch

    from otpose_tpu_torch.utils.timing import time_ms

    x = args[0]
    b, c, t = x.shape
    r = lambda *s: torch.randn(*s, device="cuda").to(x.dtype)  # noqa: E731
    if name == "fused_mlp":
        hid = args[3].shape[0]
        xn, g, w1, w2 = r(b * t, c), r(b * t, hid), r(hid, c), r(c, hid)
        return time_ms(lambda: (torch.matmul(xn, w1.T), torch.matmul(g, w2.T)), iters=5)
    n_head = args[-1]
    hs = c // n_head
    y, w, q, att = r(3, b, c, t), r(3, 1, c, c), r(b, n_head, hs, t), r(b, n_head, hs, hs)
    return time_ms(lambda: (torch.matmul(w, y), torch.matmul(q, q.transpose(-1, -2)),
                            torch.matmul(att, q)), iters=5)


def wide_kernel_rows(card: str) -> dict:
    """Phase 20 (f): rows 1 and 2 on their wide paths at the temporal
    encoders' shapes at 26 and 133 joints, (B, C, T) = (2, 208, 6912) and
    (2, 1064, 6912), two heads, in f32 and bf16: against the plain version
    under phase 3's gate (1e-3 in f32 and 5e-2 in bf16 of max(1, peak); in
    bf16 the share of outputs that differ, at most 5% for the MLP, printed
    for the attention), in f32 against the f64 witness within 1e-4 of
    max(1, peak) or twice the plain f32 version's own error there, whichever
    is larger (the witness runs the plain version's f32 front, so the plain
    version's error is its f32 tail's alone while the kernel's adds its own
    front's f32 rounding; at C = 1064 the long score sums carry either to
    about 1e-4 of the peak), two calls bit-equal, ms of the kernel and the
    plain version by CUDA events, the kernel no slower than the plain version
    (the gate), the bound (``work``) and its share, the device ms of each of
    the call's launches (``torch.profiler``) and, as the library column's
    yardstick, the function's matrix products alone by ``torch.matmul`` at
    the same shapes (``products_ms``: products only, not the function)."""
    import torch

    from otpose_tpu_torch.ops.cuda import fused_attn, fused_mlp
    from otpose_tpu_torch.tools.attn_time import device_split
    from otpose_tpu_torch.utils import profiling
    from otpose_tpu_torch.utils.timing import time_ms

    tol = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
    gen = torch.Generator(device="cuda").manual_seed(2020)
    rows = {"fused_attn": {}, "fused_mlp": {}}
    for b, c, t in WIDE_ROW_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for name, mod in (("fused_attn", fused_attn), ("fused_mlp", fused_mlp)):
                if name == "fused_attn":
                    args = attn_case(dtype, gen, b, c=c)
                    kern, plain = fused_attn.fused_attn_ct, fused_attn.fused_attn_plain
                    wide = not fused_attn.narrow(c, args[-1], dtype)
                else:
                    args = mlp_case(dtype, gen, t, b, c=c)
                    kern, plain = fused_mlp.fused_mlp_residual_ct, fused_mlp.fused_mlp_plain
                    wide = fused_mlp.supports(c, dtype) and c > fused_mlp.MAX_CHANNELS
                if not wide:
                    fail(f"{name} at C={c}: not a shape of the wide path")
                call = packed_call(name, kern, args)
                before = profiling.counters()
                got = call()
                torch.cuda.synchronize()
                if profiling.since(before)[f"{name}.launches"] != 1:
                    fail(f"{name} at C={c}: the call did not launch the kernel once")
                same = torch.equal(call(), got)
                want = plain(*args)
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1.0, want.float().abs().max().item())
                key = f"{str(dtype)[6:]} B={b} C={c} T={t}"
                row = dict(max_abs_err=err, bit_equal=same)
                extra = ""
                if dtype == torch.float32:
                    k_err, p_err = (attn_f64_errors if name == "fused_attn"
                                    else mlp_f64_errors)(args, got, want)
                    row["f64_err"], row["plain_f64_err"] = k_err, p_err
                    witness = max(1e-4 * scale, 2 * p_err)
                    extra = (f"; against the f64 witness kernel {k_err:.3e}, plain {p_err:.3e} "
                             f"(tolerance {witness:.3e}: 1e-04 x {scale:.3g} or twice the "
                             "plain's)")
                else:
                    share = (got != want).float().mean().item()
                    row["bf16_differ_share"] = share
                    extra = (f"; bf16 outputs that differ from the plain version {share:.4%}"
                             + (" (limit 5%)" if name == "fused_mlp" else " (no limit)"))
                del got, want
                ms = time_ms(call, iters=10)
                plain_ms = time_ms(lambda: plain(*args), iters=3)
                moved, ops, t_ops = work(name, args)
                t_bytes = moved / PEAK_BYTES * 1e3
                bound = max(t_bytes, t_ops)
                split = device_split(call, calls=3)
                row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           library_ms=products_ms(name, args),
                           library="products only, not the function (torch.matmul)",
                           launch_ms={k: v[0] for k, v in split.items()})
                rows[name][key] = row
                log(f"wide {name} {key}: max_abs_err {err:.3e} (tolerance {tol[dtype]:.0e} x "
                    f"{scale:.3g}){extra}; a second call {'bit-equal' if same else 'DIFFERS'}; "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (the gate: kernel <= plain), "
                    f"bound {bound:.4f} ms ({moved / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP; "
                    f"{row['bound_by']}; {bound / ms:.1%} of it); library (products only, not "
                    f"the function) {row['library_ms']:.4f} ms; device ms a launch: "
                    + ", ".join(f"{k} {v[0]:.4f} ({v[1]:.3g} a call)" for k, v in split.items())
                    + f" ({card})")
                if not ms <= plain_ms:
                    fail(f"wide {name} {key}: the kernel ({ms:.4f} ms) is slower than its plain "
                         f"version ({plain_ms:.4f} ms)")
                if not (math.isfinite(err) and err <= tol[dtype] * scale):
                    fail(f"wide {name} {key} disagrees with its plain version")
                if dtype == torch.float32 and not row["f64_err"] <= witness:
                    fail(f"wide {name} {key} disagrees with the f64 witness")
                if name == "fused_mlp" and dtype == torch.bfloat16 and \
                        not row["bf16_differ_share"] <= 0.05:
                    fail(f"wide {name} {key} does not round as its plain version does")
                if not same:
                    fail(f"wide {name} {key}: two calls differ")
                del args, call
                torch.cuda.empty_cache()
    return rows


def dcn_f64_errors(args, got, want):
    """max|kernel - ref| and max|plain - ref|, where ref is the DCN in f64
    from the same f32 sample positions (pixel + tap + offset rounded in f32,
    as both versions take them): bilinear weights, samples, masks, the
    contraction and the mean in f64."""
    import torch

    from otpose_tpu_torch.ops.cuda import deform_conv

    x, offsets_list, masks_list, weights, biases, dilations = args
    b, c, h, w = x.shape
    p = h * w
    xf = x.double().reshape(b, c, p)
    py = torch.arange(h, device=x.device, dtype=torch.float32)[:, None].expand(h, w).reshape(p)
    px = torch.arange(w, device=x.device, dtype=torch.float32)[None, :].expand(h, w).reshape(p)
    acc = torch.zeros(b, weights.shape[1], p, device=x.device, dtype=torch.float64)
    for off, msk, wd, dil in zip(offsets_list, masks_list, weights, dilations):
        off = off.float().reshape(b, c, 9, 2, p)
        msk = msk.double().reshape(b, c, 9, p)
        for k in range(9):
            sy = ((py + float((k // 3) * dil - dil)) + off[:, :, k, 0]).double()
            sx = ((px + float((k % 3) * dil - dil)) + off[:, :, k, 1]).double()
            val = deform_conv._bilinear(xf, sy, sx, h, w) * msk[:, :, k]
            acc += torch.einsum("oc,bcp->bop", wd[:, :, k // 3, k % 3].double(), val)
    ref = (acc / len(dilations) + biases.double().mean(0)[:, None]).reshape(b, -1, h, w)
    return ((got.double() - ref).abs().max().item(), (want.double() - ref).abs().max().item(),
            max(1.0, ref.abs().max().item()))


def wide_dcn(card: str) -> dict:
    """Phase 20 (c): the DCN at O = C = 133 (the wide paths: one sampling
    for every output, a launch a group of 5 dilations), 96x72, B = 2, at the
    flagship's five dilations and at nine (two groups of dilations), against
    its plain version under row 3's gate (1e-3 in f32 and 5e-2 in bf16 of
    max(1, peak), at most 5% of bf16 outputs apart; f32 also against the
    f64 witness, ``dcn_f64_errors``: max(1e-4 x scale, twice the plain
    version's error)) and the backward under row 6's (each gradient to 1e-4
    in f32 and 5e-2 in bf16 of its peak, two calls bit-equal), at calibrated
    offsets; each call's launches (1 at D = 5, 2 at D = 9), its ms (no more
    than the grouped launches' before, ``PARENT_DCN_MS``), the plain
    version's and the bound."""
    import torch

    from otpose_tpu_torch.ops.cuda import deform_conv
    from otpose_tpu_torch.utils.testing import dcn_case, dcn_gradients, dcn_inside_share
    from otpose_tpu_torch.utils.timing import time_ms

    c, h, w = 133, 96, 72
    gen = torch.Generator(device="cuda").manual_seed(20)
    fwd, bwd = {}, {}
    for dil in (DCN_DILATIONS, NINE_DILATIONS):
        groups = deform_conv.kernel_launches(len(dil), c)
        if groups != -(-len(dil) // deform_conv.WIDE_DILATIONS):
            fail(f"deform_conv O={c} D={len(dil)}: {groups} launches planned, not one a "
                 "group of dilations")
        for dtype in (torch.float32, torch.bfloat16):
            args = dcn_case(WIDE_BATCH, c, c, h, w, dil, dtype, gen)
            x, offs, masks, weights, biases, _ = args
            pk = deform_conv.pack_dcn_weights(weights, biases)
            call = lambda: deform_conv.modulated_deform_conv_multi(  # noqa: E731
                x, offs, masks, dilations=dil, packed=pk)
            reset_counts()
            got = call()
            torch.cuda.synchronize()
            launches = read_counts()["deform_conv"]
            want = deform_conv.modulated_deform_conv_multi_plain(*args)
            err = (got.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            tol = 1e-3 if dtype == torch.float32 else 5e-2
            share = (got != want).float().mean().item()
            same = torch.equal(call(), got)
            ms = time_ms(call, iters=10)
            plain_ms = time_ms(lambda: deform_conv.modulated_deform_conv_multi_plain(*args),
                               iters=2, warmup=1)
            moved, _, t_ops = work("deform_conv", args)
            bound = max(moved / PEAK_BYTES * 1e3, t_ops)
            key = f"{str(dtype)[6:]} O={c} D={len(dil)} B={WIDE_BATCH}"
            fwd[key] = dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, differ_share=share)
            witness = ""
            if dtype == torch.float32:
                k_err, p_err, w_scale = dcn_f64_errors(args, got, want)
                fwd[key].update(f64_err=k_err, plain_f64_err=p_err)
                bar = max(1e-4 * w_scale, 2 * p_err)
                witness = (f"; against the f64 witness kernel {k_err:.3e}, plain {p_err:.3e} "
                           f"(tolerance {bar:.3e}: 1e-04 x {w_scale:.3g} or twice the plain's)")
                if not k_err <= bar:
                    fail(f"wide deform_conv {key} disagrees with the f64 witness")
            log(f"wide deform_conv {key}: {launches} launches ({groups} expected); "
                f"max_abs_err {err:.3e} (tolerance {tol:.0e} x {scale:.3g}), outputs that differ "
                f"from the plain version {share:.4%} (bf16 limit 5%){witness}, a second call "
                f"{'bit-equal' if same else 'DIFFERS'}; kernel {ms:.4f} ms (the grouped "
                f"launches before: {PARENT_DCN_MS[key]:.4f}), plain {plain_ms:.4f} ms, bound "
                f"{bound:.4f} ms ({bound / ms:.1%} of it) ({card})")
            if launches != groups or not (math.isfinite(err) and err <= tol * scale) or not same:
                fail(f"wide deform_conv {key} disagrees with its plain version")
            if dtype == torch.bfloat16 and not share <= 0.05:
                fail(f"wide deform_conv {key} does not round as its plain version does")
            if not ms <= PARENT_DCN_MS[key]:
                fail(f"wide deform_conv {key}: {ms:.4f} ms, slower than the grouped launches' "
                     f"{PARENT_DCN_MS[key]:.4f}")
            del got, want
        dtype = torch.bfloat16 if dil == DCN_DILATIONS else torch.float32
        args = dcn_case(WIDE_BATCH, c, c, h, w, dil, dtype, gen)
        inside = dcn_inside_share(args)
        g = torch.randn(WIDE_BATCH, c, h, w, generator=gen, device="cuda").to(dtype)
        reset_counts()
        got = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
        torch.cuda.synchronize()
        launches = read_counts()["deform_conv_bwd"]
        again = dcn_gradients(deform_conv.modulated_deform_conv_multi, args, g)
        want = dcn_gradients(deform_conv.modulated_deform_conv_multi_plain, args, g)
        d = len(dil)
        split = lambda gr: [gr[0], torch.cat([t.flatten() for t in gr[1:1 + d]]),  # noqa: E731
                            torch.cat([t.flatten() for t in gr[1 + d:1 + 2 * d]]), gr[-2], gr[-1]]
        tol = 1e-4 if dtype == torch.float32 else 5e-2
        rels = {n: (gk.float() - gp.float()).abs().max().item() / gp.float().abs().max().item()
                for n, gk, gp in zip(("x", "offsets", "masks", "weights", "biases"), split(got),
                                     split(want))}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again, want
        x, offs, masks, weights, biases, _ = args
        pk = deform_conv.pack_dcn_weights(weights, biases)
        ms = time_ms(lambda: deform_conv.launch_backward(g, x, offs, masks, pk, dil), iters=5)
        leaves = [t.detach().clone().requires_grad_() for t in (x, *offs, *masks, weights, biases)]
        out = deform_conv.modulated_deform_conv_multi_plain(
            leaves[0], leaves[1:1 + d], leaves[1 + d:1 + 2 * d], leaves[-2], leaves[-1], dil)
        plain_ms = time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True),
                           iters=1, warmup=1)
        del out, leaves
        moved, _, t_ops = dcn_bwd_work(args, c)
        bound = max(moved / PEAK_BYTES * 1e3, t_ops)
        key = f"{str(dtype)[6:]} O={c} D={d} B={WIDE_BATCH}"
        bwd[key] = dict(launches=launches, rel_err=rels, bit_equal=same, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound, inside_share=inside)
        want_launches = deform_conv.backward_launches(d, c)
        log(f"wide deform_conv_bwd {key}: {launches} launches ({want_launches} expected); "
            f"{inside:.1%} of samples inside the image; worst error over peak "
            + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
            + f" (tolerance {tol:.0e}); two calls {'bit-equal' if same else 'DIFFER'}; kernel "
            f"{ms:.4f} ms (the grouped launches before: {PARENT_DCN_BWD_MS[key]:.4f}), plain "
            f"backward {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.1%} of it) ({card})")
        if launches != want_launches or not all(math.isfinite(r) and r <= tol
                                                for r in rels.values()):
            fail(f"wide deform_conv_bwd {key} disagrees with the plain version's autograd")
        if not same:
            fail(f"wide deform_conv_bwd {key}: two calls differ")
        if not ms <= PARENT_DCN_BWD_MS[key]:
            fail(f"wide deform_conv_bwd {key}: {ms:.4f} ms, slower than the grouped launches' "
                 f"{PARENT_DCN_BWD_MS[key]:.4f}")
        torch.cuda.empty_cache()
    return dict(forward=fwd, backward=bwd)


def check_predicates(card: str) -> dict:
    """Phase 20 (d): ``fused_attn.supports`` against the library's own
    ``otp_fused_attn_smem`` (a shape it takes: at most the shared memory a
    block may use) and ``fused_attn.narrow`` against ``otp_fused_attn_narrow``
    (the path a shape takes), and ``fused_mlp.supports`` against the MLP's
    entry points (which refuse a shape before any launch, and launch the
    others on zeros), at C = 1 to 1100, every head count of 1, 2, 4, 8 and
    16 that divides C, in f32 and bf16."""
    import torch

    from otpose_tpu_torch.ops.cuda import build, fused_attn, fused_mlp

    attn_lib = build.load("fused_attn", fused_attn._SIGNATURES)
    mlp_lib = build.load("fused_mlp", fused_mlp._SIGNATURES)
    stream = build.stream_ptr(torch.device("cuda"))
    points, wrong, largest = 0, [], {}
    for dtype in (torch.float32, torch.bfloat16):
        code = build.dtype_code(dtype)
        for c in range(1, PREDICATE_CHANNELS + 1):
            for n_head in (1, 2, 4, 8, 16):
                if c % n_head:
                    continue
                lib_ok = attn_lib.otp_fused_attn_smem(c, n_head, code) <= SMEM_LIMIT
                lib_narrow = attn_lib.otp_fused_attn_narrow(c, n_head, code) == 1
                points += 1
                if (lib_ok, lib_narrow) != (fused_attn.supports(c, n_head, dtype),
                                            fused_attn.narrow(c, n_head, dtype)):
                    wrong.append(("fused_attn", str(dtype)[6:], c, n_head, lib_ok, lib_narrow))
            cp = -(-c // fused_mlp.CHANNEL_ALIGN[dtype]) * fused_mlp.CHANNEL_ALIGN[dtype]
            hp = -(-4 * c // fused_mlp.HIDDEN_TILE) * fused_mlp.HIDDEN_TILE
            t = 8
            bufs = [torch.zeros(n, device="cuda", dtype=dt) for n, dt in (
                (c * t, dtype), (c * t, dtype), (c, torch.float32), (c, torch.float32),
                (hp * cp, dtype), (hp, torch.float32), (cp * hp, dtype), (cp, torch.float32))]
            bufs[1].fill_(float("nan"))       # the output: a launch writes every value (0)
            ptrs = [b.data_ptr() for b in bufs]
            if cp <= fused_mlp.MAX_CHANNELS:
                launch = mlp_lib.otp_fused_mlp_tc if code == 1 else mlp_lib.otp_fused_mlp_f32
                err = launch(*ptrs, 1, c, cp, hp, t, stream)
            else:      # the wide path's entry, with the scratch the wrapper gives it
                scratch = [torch.empty(shape, device="cuda", dtype=dtype) for shape in
                           fused_mlp.wide_plan(1, c, t, hp, dtype)["shapes"].values()]
                scratch += scratch[-1:] * (3 - len(scratch))   # bf16: no split weights
                err = mlp_lib.otp_fused_mlp_wide(*ptrs, *(b.data_ptr() for b in scratch), 1, c,
                                                 cp, hp, t, code, stream)
            torch.cuda.synchronize()
            lib_ok = err == 0 and not bufs[1].any().item()
            points += 1
            if lib_ok != fused_mlp.supports(c, dtype):
                wrong.append(("fused_mlp", str(dtype)[6:], c, lib_ok))
            if lib_ok:
                largest[f"fused_mlp {str(dtype)[6:]}"] = c
        largest[f"fused_attn {str(dtype)[6:]}, one head, narrow"] = max(
            c for c in range(1, PREDICATE_CHANNELS + 1) if fused_attn.narrow(c, 1, dtype))
    log(f"the fused kernels' predicates against the libraries at {points} points (C 1-"
        f"{PREDICATE_CHANNELS}, heads 1-16, f32 and bf16): {len(wrong)} disagree {wrong[:4]}; "
        f"the largest C taken {largest} ({card})")
    if wrong:
        fail(f"the fused kernels' predicates disagree with the libraries: {wrong[:8]}")
    return dict(points=points, largest=largest)


def wide_train_step(card: str) -> dict:
    """Phase 20 (b), training: the flagship (``configs/17/model_RSN.yaml``)
    at 133 joints, reference init, one bf16 train step at B = 2 on a
    synthetic batch after a warm-up step (``_train_run``): six finite
    metrics, the step's launches (the DCN's forward and backward once each,
    on their wide paths: ``TRAIN_COUNTS``) and its ms by CUDA events."""
    import torch

    from otpose_tpu_torch.config import get_cfg
    from otpose_tpu_torch.engine.optim import make_optimizer, make_schedule
    from otpose_tpu_torch.engine.trainer import make_train_step
    from otpose_tpu_torch.models.factory import build_model

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs/17/model_RSN.yaml"))
    cfg.MODEL.NUM_JOINTS = 133
    _, model = build_model(cfg, seed=0)
    step = make_train_step(model, make_optimizer(model, cfg, make_schedule(cfg, 1)),
                           compute_dtype="bfloat16",
                           generator=torch.Generator(device="cuda").manual_seed(5))
    batch = synthetic_train_batch(cfg, WIDE_BATCH, torch.Generator(device="cuda").manual_seed(133))
    run = _train_run(f"bf16 B={WIDE_BATCH} at 133 joints", step, batch, 1, 1, 1)
    log(f"train bf16 B={WIDE_BATCH} at 133 joints: {run['ms'][0]:.2f} ms a step, loss "
        f"{run['first']['final_loss']:.6g}, launches {run['counts']} (the DCN's backward on "
        f"its wide kernel), peak {run['peak_gib']:.2f} GiB ({card})")
    del model, step, batch
    torch.cuda.empty_cache()
    return run


def wide_shapes(card: str) -> dict:
    """Phase 20: (a) the tiny eval at 21 and 33 joints and at nine
    dilations on the card against the CPU; (b) the flagship at 26 and 133
    joints, bf16 and f32, with the fused kernels and without, and a bf16
    train step at 133 joints; (c) the wide DCN forward and backward at
    O = 133; (d) the fused kernels' predicates against their libraries;
    (f) rows 1 and 2 on their wide paths at C = 208 and 1064.  (e), R1's
    splits, runs inside phase 19's ranks."""
    import torch

    phase_t0 = time.perf_counter()
    paths, flagship = {}, {}
    for joints, dil in ((21, None), (33, None), (17, tuple(range(1, 10)))):
        key = f"tiny_j{joints}" + ("" if dil is None else f"_d{len(dil)}")
        paths[key] = tiny_agreement(joints, dil)
    for joints in WIDE_JOINTS:
        run = flagship[joints] = wide_flagship(card, joints)
        paths[f"flagship_j{joints}_b{WIDE_BATCH}"] = run["counts"]
        paths[f"flagship_j{joints}_b{WIDE_BATCH}_f32"] = run["counts_f32"]
    torch.cuda.empty_cache()
    train = wide_train_step(card)
    paths[f"train_step_j133_b{WIDE_BATCH}_bf16"] = train["counts"]
    dcn = wide_dcn(card)
    check_predicates(card)
    rows = wide_kernel_rows(card)
    log(f"wide shapes phase: {time.perf_counter() - phase_t0:.1f} s")
    return dict(paths=paths, dcn=dcn, rows=rows, flagship=flagship, train=train)


def main(only: str | None = None) -> None:
    start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        from otpose_tpu_torch.ops.cuda import build
    except ImportError as e:
        fail(f"the otpose_tpu_torch package is not beside this script ({e})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _backend_flags(torch)

    t0 = time.perf_counter()
    secs = build.build_all(build.KERNELS + ("jpeg_nv",))
    log(f"build: {len(secs)} kernels in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for name, report in build.ptxas_report.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "properties for" in line:
                log(f"ptxas {name}: {line.strip()}")

    if only in ("15", "17", "18", "19", "20"):
        # a development run of one phase alone: no kernels line, no result line
        {"15": lambda card: serving(card, start_serving()), "17": jpeg_phase,
         "18": remaining_modules, "19": sequence_parallel, "20": wide_shapes}[only](card)
        log(f"phase {only} alone: {time.perf_counter() - start:.1f} s")
        return
    rows = check_kernels()
    rows["token_shift"] = check_token_shift()
    flag = flagship_eval()
    infer = inference_api(*flag["model"])
    eval_rates = {k: flag[k]["clips_per_s"] for k in ("bf16", "f32", "f32 plain", "flip")}
    latency = infer["latency_ms"]
    paths = {"decoded_eval": flag["bf16"]["counts"], "flip_eval": flag["flip"]["counts"],
             "inference": infer["counts"], **tools()}
    tiny_agreement()
    cli = eval_cli()
    per_batch = {k: v // cli[0]["batches"] for k, v in cli[0]["counts"].items()}
    paths["eval_cli_per_batch"] = per_batch
    del flag, infer
    torch.cuda.empty_cache()
    rows["deform_conv_bwd"] = check_dcn_backward()
    check_grad_refusals()
    train = flagship_train(card)
    paths["train_step_bf16_b8"] = train["bf16 B=8"]["counts"]
    tiny_train_agreement()
    torch.cuda.empty_cache()
    cli_train = train_cli(card)
    paths["train_cli_step"] = cli_train["step"]
    paths["train_cli_val_batch"] = cli_train["val_batch"]
    torch.cuda.empty_cache()
    # phase 15's exports and loads run on the host beside phase 16
    started = start_serving()
    dp = data_parallel(card)
    paths["dp_train_step_rank"] = dp["train"]
    paths["sharded_eval_batch_rank"] = dp["eval"]
    torch.cuda.empty_cache()
    serve = serving(card, started)
    paths["served_artifact"] = serve["counts"]
    paths["served_artifact_b1"] = serve["counts_b1"]
    del started
    torch.cuda.empty_cache()
    jpeg = jpeg_phase(card)
    paths["test_split_eval_cli_per_batch"] = jpeg["per_batch"]
    torch.cuda.empty_cache()
    bf16_train_ms = sorted(train["bf16 B=8"]["ms"])[len(train["bf16 B=8"]["ms"]) // 2]
    rest = remaining_modules(card, train_ms=bf16_train_ms)
    k2 = rest.pop("k2")
    paths.update(rest)
    torch.cuda.empty_cache()
    sp = sequence_parallel(card)
    paths["sp_eval_batch_rank"] = sp["eval"]
    paths["sp_train_micro_batch_rank"] = sp["train"]
    torch.cuda.empty_cache()
    wide = wide_shapes(card)
    paths.update(wide["paths"])
    rows["deform_conv"]["wide"] = wide["dcn"]["forward"]
    for name in ("fused_attn", "fused_mlp"):
        rows[name]["wide"] = wide["rows"][name]
        rows[name]["wide_source"] = "otpose_tpu_torch/csrc/hopper_gemm.cuh"
    rows["deform_conv_bwd"]["wide"] = wide["dcn"]["backward"]
    # each kernel's launches on its own path: the eval's for the model's
    # kernels, the experiment tool's for the other two, a train step's for
    # the DCN's backward
    own = {"deform_conv_fused": "exp_deform_fused", "token_shift": "probe_shift",
           "deform_conv_bwd": "train_step_bf16_b8"}
    for name, row in rows.items():
        row["launches"] = paths[own.get(name, "decoded_eval")][name]
        row["launches_by_path"] = {p: c[name] for p, c in paths.items()}
    log(f"flagship decoded eval bf16: {eval_rates['bf16']:.3f} clips/s, "
        f"f32: {eval_rates['f32']:.3f} clips/s (without the fused kernels "
        f"{eval_rates['f32 plain']:.3f}), flip bf16: "
        f"{eval_rates['flip']:.3f} clips/s (B={BATCH}); inference latency B=1: "
        f"{latency:.3f} ms; train step: "
        + "; ".join(f"{k} {sorted(r['ms'])[len(r['ms']) // 2]:.2f} ms, peak {r['peak_gib']:.2f} GiB"
                    for k, r in train.items())
        + "; eval CLI over a synthetic tree: "
        + "; ".join(f"{r['preprocess']} ({r['loader']}) {r['boxes_per_s']:.3f} boxes/s with "
                    f"{r['workers']} loader thread(s), the "
                    f"steps' events span {r['step_span_share']:.1%} of the loop's wall time"
                    for r in cli)
        + f"; train CLI: {cli_train['clips_per_s']:.4f} clips/s, the steps' events span "
        f"{cli_train['span_share']:.1%} of its loops, validation "
        f"{cli_train['val_boxes_per_s']:.4f} boxes/s, a checkpoint "
        + ", ".join(f"{'async' if a else 'sync'} {b:.1f} / {c:.1f} ms"
                    for a, b, c in cli_train["save_ms"])
        + f" (returned / committed), resume {cli_train['resume_ms']:.1f} ms, peak "
        f"{cli_train['peak_gib']:.2f} GiB, the resumed run "
        + ("bit-equal" if cli_train["bit_equal"] else "within two runs' spread")
        + f"; served artifact (B={BATCH}, bf16, fresh process) {serve['clips_per_s']:.3f} "
        f"clips/s against the live step's {serve['live_clips_per_s']:.3f} in the same call, "
        f"HTTP latency {serve['latency_ms'][1]:.2f} ms at 1 clip and "
        f"{serve['latency_ms'][16]:.2f} ms at {BATCH}"
        + f"; data parallel (phase 16): launches a rank a train micro-batch {dp['train']}, a "
        f"sharded eval batch {dp['eval']}, a two-rank train-CLI step {dp['cli']['step']}"
        + f"; the test split over detector boxes (phase 17): launches a batch {jpeg['per_batch']}"
        + f"; phase 18: the eval CLI's heatmap path launches a batch "
        f"{rest['eval_cli_heatmap_per_batch']} (flip {rest['eval_cli_heatmap_flip_per_batch']}), "
        f"the window encoder a forward {rest['window_encoder']}, K2 fused / plain "
        f"{k2['share']:.3f} (plain {', '.join(f'{v:.3f}' for v in k2['plain_ms'])} ms, fused "
        f"{', '.join(f'{v:.3f}' for v in k2['fused_ms'])} ms)"
        + f"; sequence parallel (phase 19): launches a rank an eval batch {sp['eval']}, a train "
        f"micro-batch {sp['train']}; on unequal slices (1 x {SP_UNEVEN_LAYOUT[1]}) an eval batch "
        f"{sp['uneven_eval']}, an f32 train micro-batch {sp['uneven_train']}"
        + "; phase 20: launches " + ", ".join(f"{k} {v}" for k, v in wide["paths"].items())
        + f"; the script {time.perf_counter() - start:.1f} s ({card})")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(f"nvidia-smi: {card}", flush=True)
    # the script drives one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}), flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    if sys.argv[1:2] == ["--serve-worker"]:
        sys.path.insert(0, ROOT)
        serve_worker(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--dist-worker"]:
        sys.path.insert(0, ROOT)
        dist_worker(*sys.argv[2:4])
    elif sys.argv[1:2] in (["--phase15"], ["--phase17"], ["--phase18"], ["--phase19"],
                           ["--phase20"]):
        main(only=sys.argv[1][-2:])
    else:
        main()
