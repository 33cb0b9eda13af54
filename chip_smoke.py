"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``nunif_tpu_torch/csrc`` and drives
the port's main paths, each with seeded weights loaded from ``.nztm`` files
written by the port:

- waifu2x swin_unet_2x: holds K1 and K2 against their plain PyTorch twins
  at the shapes of the 1080p path, and K5 (the block on window-ordered
  tokens) at the six shapes of the window path and one batch-2 shape, with
  controls that must fail (zero bias; the roll mask where pad was asked),
  K1 and K5 timed beside a composite of PyTorch calls (``F.linear`` x4,
  SDPA with the bias and mask as one float mask; ``composite_ms``, not one
  call, so no ``library_ms``), with the kernel's tile plan and the weight
  bytes its tiles read from L2 a frame (a count from shapes) on a line of
  their own; renders one 1080p frame to 4K through
  ``TiledRenderer.frame_program``, checks that the frame went through the
  kernels (launch counters) and agrees with the twin path, profiles it;
  renders it again with
  ``NUNIF_TPU_SWIN_IMG=0`` (launches K5 14, K1 0, K2 1) against the twin
  path and the K1 path's frame, timed beside it; and drives
  ``Waifu2x.convert`` (and the CLI when PIL is present) on a multi-tile
  image;
- waifu2x swin_unet_4xl (LayerNorm blocks): holds K4 (window attention) and
  K6 (the same in image layout) at the eight shapes of the 540p path and
  K2 at its 96 -> 192 stem, each K4 / K6 check with controls that must
  fail, K6 timed beside K4 with the window partition and reverse copies,
  each bf16 launch also back to back against its bound, and the kernel's
  registers and spills; its launch plan (``window_attn_plan``, from the
  library) and the bias bytes it reads (a count) print on the "K4 / K6
  frame:" line, beside the frame sums;
  runs the image-form attention module (K6) at the frame's 14 block
  shapes; renders one 540p frame to 4K (launches K4 14, K2 1, K1 0)
  against the twin path, profiles it (with K4's share of the device
  time), and drives ``Waifu2x.convert`` and
  the CLI with ``--method scale4x`` and ``--arch waifu2x.swin_unet_4xl``;
  then renders swin_unet_1x, swin_unet_4x and the downscaled 2x model on a
  small image;
- iw3: holds K3 (stereo warp) and K7 (DINOv2 attention) against their twins
  at the shapes of the 1080p half-SBS path, each with controls that must
  fail, K7 also on strided views of a qkv projection as the path passes
  them and timed back to back and by device time beside SDPA (device time
  in a process of its own, ``chip_smoke.py --k7-device-ms``), runs a
  batch of 8 uint8 1080p frames through ``Iw3FrameProcessor``
  (Any_V2_S depth, row_flow_v3, divergence 2, edge dilation 2, half-SBS),
  checks the launch counters, the time and the agreement with the twin
  path, and drives the iw3 CLI on an image when PIL is present; then the
  same batch through iw3's other methods (``mlbw_l2``, ``mlbw_l4``,
  ``forward_fill``, ``forward_inpaint``, ``mlbw_l2_inpaint``; MLBW, mask-MLBW
  and LightInpaintV1 weights seeded, written to and loaded from ``.nztm``):
  exact K3 / K7 launches a method, not degenerate (pixels moved, inpaint
  masks on 0-50% of the pixels and changed by the net), against the twins
  (K7 on the depth; the methods that make discrete decisions on the depth,
  K3 alone on the frame), timed and profiled; and the CLI with three of
  them;
- iw3's temporal path ("iw3 temporal"): 48 (or 40) indexed uint8 1080p
  frames in batches of 8 through ``Iw3FrameProcessor`` and its ``flush``
  in five cases: windowed and streaming Video Depth Anything (VDA-S,
  seeded weights with active motion modules, from ``.nztm``) with
  row_flow_v3, Any_V2_S under an EMA lookahead of 30, and
  ``mlbw_l2_inpaint_video`` (LightVideoInpaintV1, 12-frame clips) under
  Any_V2_S and streaming VDA: the frames each call returns, every frame
  once and in order, exact K3 / K7 launches (K7 also at the window's
  (32, 6, 1373, 64)), the twins (K7 at the normalised depth, K3 alone on
  the frame for the clip inpaint, both on the other cases' frames), the
  windowed model's temporal mixing, fps over whole runs, peak memory and
  a profiler split;
- iw3's other depth families ("iw3 depth families"): ZoeD_N, ZoeD_NK,
  ZoeD_Any_N, Any_V3_Mono and NULL on 8 structured 1080p frames through
  ``Iw3FrameProcessor`` with row_flow_v3, DepthPro and DepthPro_S on one
  through ``process_image``, at full width (BEiT-L / ViT-L) on weights
  seeded on the card (ZoeD_N's through a .nztm round trip): exact K7
  launches (``FAMILY_K7``), not degenerate, K7 against its twin at the
  normalised depth and the frame against the twin path (>= 45 dB), the
  time (median of 3 after a warm run) and peak memory; then the image CLI
  with ``--depth-model ZoeD_N`` and ``DepthPro``; K7 is also held and
  timed at DepthPro's (35, 16, 577, 64) and ZoeD_Any_N's (8, 16, 1401,
  64);
- iw3's extras ("iw3 extras"): VR180's bicubic sampler on the card
  against the CPU; 8 structured 1080p frames with 140-row black bars,
  which ``AutoCropDetector`` must find exactly and ``Iw3FrameProcessor``
  cuts off on the host, through seeded DepthAA (``iw3.depth_aa``) and the
  SOD convergence estimator (``iw3.sod_v1``, EMA on) under half-SBS,
  anaglyph dubois, VR180, half-RGBD and the debug depth, then 48 frames
  through an EMA lookahead of 30 with the estimator: exact launches (K7
  12 a batch at the cropped frame's (8, 6, 1877, 64), K3 1, 0 under the
  debug depth; the lagged run K7 72, K3 4), K7 held at the normalised
  depth and at the convergence it yields, K3 alone on the frame, the
  time, peak memory, the saliency mask's share, the convergences, a
  split (depth, depth with DepthAA, the estimator) and a profile of the
  half-SBS batch; then the CLI: ``--export`` and its ``.yml`` re-import
  against a direct render, ``--anaglyph dubois --depth-aa`` and
  ``--vr180 --convergence-mode sod_v1``;
- iw3's desktop stream ("iw3 desktop"): 60 raw 1080p frames pushed over
  the ``IW3CAP01`` TCP capture socket into ``desktop.run_pipeline`` with
  Any_V2_S and row_flow_v3 (the iw3 batch's ``.nztm`` files) at batch 1,
  an HTTP client reading ``/stream``: K7 12 and K3 1 launches a frame,
  exact; every part a half-SBS JPEG of the frame's size; one frame's SBS
  before JPEG against the twin path and against K3's twin alone (>= 50
  dB each), its normalised depth against K7's twin (>= 45 dB), K7 alone
  at the stream's (1, 6, 1373, 64) in the "k7" phase; fps and the per-frame stage medians (capture wait,
  depth, warp / compose, host read, JPEG encode);
- cliqa ("cliqa", BASELINE config 3): the three predictors at their width,
  ``norm="none"``, seeded and written to ``.nztm``; the filter CLI on the
  card over 16 structured 1080p JPEGs of several qualities per kind, its
  kept set equal to what the CPU's scores of the same weights keep (a
  threshold in their widest gap), the scores and raw outputs within fp32
  tolerance of the CPU's, the chosen patches equal; then a reference
  ``.pth`` of ten importer rows (the iw3 stereo, inpaint and helper nets,
  cliqa, stlizer's outpaint net; state dicts built by
  ``tests/torch_pth_states.py`` from ``tests/torchref``'s plain modules) loaded on the card and held to the CPU's forward (fp32);
- waifu2x turbo_2x, the bundled zoo (``models/waifu2x/turbo``, trained
  weights, no hand-written kernel: cuDNN convs): loads all four
  checkpoints through ``Waifu2x``; holds an untrained turbo_2x and
  turbo_4x to a float64 catrom upscale (1e-5: the base is true fp32);
  renders one 1080p frame to 4K through ``frame_program`` at the default
  tiles (256, batch 8) and as one tile, median of 3, with a
  ``torch.profiler`` split by renderer range and op and the frame's
  operations (a count from shapes) and bound; scores the shipped
  checkpoints on the eval set (``tests/torch_data/w2x_eval_256.npz``) by
  the benchmark protocol against the JAX package's scores (and, where PIL
  is present, noise1 / noise3 with JPEG noise); runs ``Waifu2x.convert``
  on a 1080p RGBA image with TTA and grain, written as a 16-bit PNG and
  read back by zlib (and, where PIL is present, as 8 bits and through the
  CLI at its defaults);
- waifu2x serving ("waifu2x serving"): cunet, upcunet, swin_unet_v2_2x
  (base 96), swin_unet_v2_4x and wgmlp_4x (base 128), each from a ``.nztm``
  of seeded weights, one frame through ``frame_program`` at the default 256
  tiles (1080p; the 4x models 540p -> 4K), CUDA-event times, and one 64 px
  tile against the same model on the CPU in fp32 (1e-5) and in bf16
  (1.5e-2, against the CPU's fp32); then the port's web
  server (``Waifu2xWebService`` on 127.0.0.1, port 0, in a thread) on a
  seeded swin_unet_2x and on the bundled turbo ``scale2x``: 4 POST /api of
  a 1920x1080 PNG (one, two concurrent, the first again from the cache),
  each reply equal to the renderer on the decoded input, K1 / K2 launches
  exact (14 / 1 a forward pass, none on turbo), /api/tile plain and with
  TTA equal to ``tile_forward``, GET / in Japanese, /api/tile/info; and
  ``waifu2x(model_type="turbo").convert`` equal to the CLI's PNG;
- K4 and K6 at windows past 6: imagenet swin_t's four stages (window 7,
  N = 49, head dim 32, batch 64 at 224 px, shifts 0 and 3) and one
  window-8 shape (N = 64), against their twins with K4's controls;
- the probes: holds T1 (strip relayout), T3 (window dot pair, bf16 and
  int8) and T4 (repeated dot pair, 8 shapes) against their twins at the
  tools' shapes (T1 also at scale 2.0, where the tool's scale rounds to
  1.0, with its window hook, and controls that must fail), then runs the
  three ``nunif_tpu_torch.tools`` probes, which time them, and T1's device
  time a launch at each block (in a process of its own); its plan prints
  on a line of its own; then T2 (the piecewise Swin block, ten variants with
  W8A8 int8 dense layers and int8 scores) at both of its tool's shapes
  against its twin, with controls (zero bias table, per-window attention)
  that must fail, and its tool's run;
- video ("video"): the engine (``nunif_tpu_torch.video``) and both CLIs'
  video paths at 1080p.  What ``ldd`` resolves for
  ``native/libnunif_video.so`` decides the file I/O: with libav, lossless
  utvideo files; without it, raw-frame files through this script's
  ``RawVideoReader`` / ``RawVideoWriter`` (``VideoReader`` /
  ``VideoWriter``'s interface; the package ships none).  A 48-frame clip
  written and read back identical; the iw3 CLI at its defaults (Any_V2_S,
  row_flow_v3, half-SBS, batch 4): exact K7 / K3 launches, the output
  equal to ``Iw3FrameProcessor`` on the decoded frames in memory, >= 45 dB
  a frame against the twins, fps and the engine's stage times (decode
  wait, callback issue, device wait, encode); ``--scene-detect
  --autocrop`` on a clip with a cut and 140-row bars against the detector
  and the pre-pass; BASELINE config 5 chained through the CLIs (stlizer on
  a shaky clip from ``stlizer.gen_test_video`` with seeded SuperPoint,
  then streaming VDA-S + ``mlbw_l2_inpaint_video``; ``--border
  outpaint`` once), fps a stage and peak memory; waifu2x turbo_2x at the
  CLI's defaults and swin_unet_2x (K1 14, K2 1 a frame); K3 in
  SuperPoint's two-pass warp on (8, 1080, 1920, 3) fp32 against its twin
  and the gather, timed beside its bytes bound and ``F.grid_sample``;
  ``find_transform`` on the card; the HDR tone map against the CPU;
- imagenet ("imagenet"): swin_t at batch 64, 224 px, bf16, from a
  ``.nztm`` of seeded weights: exactly 12 K4 launches a forward, the
  logits against the same forward on K4's twin (K4's bf16 tolerance) with
  the top-1 agreement, images a second (min and median of 5 forwards after
  a warm one); vgg11 at batch 64 in bf16 (finite logits, images a second)
  and at batch 2 in fp32 against the port's fp32 forward on the CPU;
- the entry points ("entry points"): ``python -m nunif_tpu_torch.waifu2x``
  and ``python -m nunif_tpu_torch.iw3`` in child processes (seeded
  swin_unet_2x; Any_V2_S + row_flow_v3), each output equal to
  ``cli.main``'s; ``python -m nunif_tpu_torch.cli.i2i`` on a swin_unet_2x
  ``.nztm`` and a 1080p PNG, its K1 / K2 launches counted in the child
  (14 / 1 a forward pass) and its PNG against the renderer;
  ``count_parameters``, ``merge_model`` and ``show_train_args`` on that
  file;
- export ("export"): swin_unet_2x exported at tile 256, batch 4 (a
  ``torch.export`` program whose graph calls K1 and K2 as custom ops),
  loaded and run on the card in a child that imports only
  ``nunif_tpu_torch.models.export``: K1 14, K2 1 launches, output equal to
  the eager model's;
- the GUI ("gui"): an in-process ``GuiService`` with seeded slots
  (swin_unet_2x; Any_V2_S + row_flow_v3), a waifu2x job and an iw3 job on
  a 1080p PNG over HTTP with progress read from ``/api/progress``: each
  PNG equal to the direct ``Waifu2x.convert`` / ``process_image`` call,
  the launches of each job exact (K1 14 / K2 1 a forward pass; K7 12, K3
  1), the job's decode / render / encode seconds;
- waifu2x training ("waifu2x training"): swin_unet_2x at base 96 (the
  tamed seeded weights, the relative-position tables at std 1) on
  one synthetic batch of 16 x 112^2 from the port's dataset (seed 71),
  loss ``lbp``: the loss and every parameter's gradient through K1 / K2
  (forward launches read from the counters, K1 14 and K2 1, none in the
  backward, which is the twins' VJP) against the twin path, each tensor's
  relative error held to the twin path's own bf16-vs-fp32 error, with the
  zero-bias control failing that check; the parameters after one Adam step
  on both paths; the kernels' weight packs remade after the step equal to
  fresh ones; then ``python -m nunif_tpu_torch.train waifu2x`` at its
  defaults (320 synthetic samples, 2 epochs) in a child process: finite
  losses, the eval Y-PSNR, steps and samples a second, the share of the
  wall spent waiting on the host data pipeline, peak memory, and its
  exported ``.nztm`` loaded and rendered through ``TiledRenderer`` on K1 /
  K2; then the same command with ``--resume`` from a checkpoint at the
  tamed weights, whose eval Y-PSNR must rise from the first epoch to the
  second and whose exported model's frame must hold to the twins' at
  FRAME_PSNR_MIN;
- feature losses and GAN ("feature losses and GAN"): (a) the input
  gradient of the DINOv2 pool loss on a fixed 16 x 192^2 bf16 batch
  (seeded ViT-S trunk) through K7, K7 launched 24 times in the forward and
  none in the backward (the twin's VJP), against the twin path, held to
  K7_GRAD_BAR times the twin's own bf16-vs-fp32 error, with the twin at
  twice the scale as the control that must fail it and K7's rounding
  written in plain PyTorch beside it; (b, c) a swin_unet_2x training step
  on ``l1dinov2`` (K1 14, K2 1, K7 24 a forward, none in the backward) and
  on each other feature-net loss, ms a step; ``python -m
  nunif_tpu_torch.train waifu2x --loss l1dinov2 --resume`` from the tamed
  checkpoint for 2 epochs of 160 samples in a child, its ``.nztm`` held to
  the twins' frame at FRAME_PSNR_MIN; (d) ``train inpaint
  --discriminator l3c`` and ``ffc`` at their defaults for 24 steps (the
  adaptive weight 0 during the warmup of 8, inside its clamp after,
  every metric finite), the trained ``.nztm`` inpainting a 1080p frame
  and scored by the inpaint benchmark (masked PSNR, LPIPS), and the video
  net with 12-frame clips;
- the other trainers ("trainers"): (a) swin_t from a ``.nztm`` of seeded
  weights, one training step on a fixed 16 x 224^2 batch with seeded
  labels (cross-entropy on the fp32 logits): K4 12 launches in the
  forward and none in the backward (the twin's VJP), each parameter's
  gradient against the twin path held to K4_GRAD_BAR times the twin's own
  bf16-vs-fp32 error (K4's rounding in plain PyTorch beside it), the twin
  at twice the score scale as the control that must fail it, fwd + bwd ms
  and peak memory of both paths; (b)
  ``train imagenet`` at its defaults for one epoch on a seeded
  class-folder tree, swin_t then vgg11: K4's launches, steps and samples a
  second, the data-wait share, peak memory, each ``.nztm`` loaded on the
  card with the trainer's last eval accuracy, vgg11's calibrated
  BatchNorm statistics against a float64 recomputation over the same
  batches; (c) ``create_training_data sbs`` and ``train sbs`` for
  row_flow_v3 (resumed from the shaped seeded weights) and mlbw_l2, then
  the trained row_flow_v3 ``.nztm`` on the iw3 1080p batch (K3, K7, >=
  FRAME_PSNR_MIN against the twins); (d) one short epoch of ``sod``,
  ``depth_aa``, ``da3mono`` (and its benchmark), ``stlizer_outpaint`` and
  ``cliqa --kind jpeg``, each ``.nztm`` loaded; (e) the mask-threshold
  sweep of a seeded ``sbs.mask_mlbw_l2`` over 4 seeded 540p pairs, each
  IoU finite and in [0, 1].

Every kernel is timed with CUDA events in turns (plain, kernel, library,
library, kernel, plain) beside its twin and, where one PyTorch call computes
the same function, that call (``library_ms``); ``bound_ms`` is the least
time the card could take for the same work, from this run's shapes: the
larger of the bytes it must move over 3.35 TB/s and its operations over the
dense peak of its type (989 TFLOP/s bf16, 1979 TOP/s int8, 67 TFLOP/s
fp32).

Prints, before the last line, the card's name and power limit
(``nvidia-smi``) and one JSON line of per-kernel results (bf16; ``ms``,
``plain_ms``, ``library_ms`` and ``bound_ms`` add up the launches of one
frame of each path that runs the kernel (K1, K2, K4, K5, K6) or of one iw3
batch of 8 frames (K3, K7), each shape timed on its own; a probe's row is
one call at its tool's main shape, and its launches those of its tool's
run); the last line is
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero and
prints no result.  Needs CUDA: without it, or without the repository beside
this file, it exits 1.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# (relative, absolute) tolerances, see tests/test_torch_cuda.py for the
# reasoning: fp32 kernels sum the twins' fp32 products in another order;
# bf16 kernels round at the twins' points, so a difference is one flipped
# rounding step and its downstream effect
K2_TOL = {"bfloat16": (1 / 64, 1e-2), "float32": (0.0, 2e-4)}
K1_TOL = {"bfloat16": (0.0, 0.05), "float32": (0.0, 2e-4)}
# K4 rounds at the twin's two points (probabilities, output)
K4_TOL = {"bfloat16": (1 / 64, 1e-2), "float32": (0.0, 2e-5)}
FRAME_PSNR_MIN = 45.0  # uint8 frame, kernel path vs twin path, tamed weights
# K3 sums the twin's two non-zero fp32 products with the twin's roundings
K3_ATOL = 1e-5
# K7 rounds unnormalised probabilities and rescales online where the twin
# rounds normalised ones: abs and relative-L2 bounds, both must hold
K7_ATOL, K7_REL_L2 = 1e-2, 1e-2
IW3_BATCH, IW3_HW = 8, (1080, 1920)
# the card's published peaks (H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# K4 at the 4xl's 540p shapes (C, H, W, shift) and its launches a frame:
# swin1 at C = 192, swin2 and swin4 at 288x480, swin3 at 144x240, swin5 at
# 576x960 (the 4x trunk runs swin5 at 2C)
K4_FRAME = {(192, 576, 960, 0): 1, (192, 576, 960, 3): 1,
            (384, 288, 480, 0): 2, (384, 288, 480, 3): 2,
            (384, 144, 240, 0): 3, (384, 144, 240, 3): 3,
            (384, 576, 960, 0): 1, (384, 576, 960, 3): 1}
# K5 on the window path of swin_unet_2x at 1080p: (C, unpadded H, W, shift)
# and launches a frame; shifted blocks run on a grid padded by one window
K5_FRAME = {(96, 1104, 1920, 0): 2, (96, 1104, 1920, 3): 2,
            (192, 552, 960, 0): 2, (192, 552, 960, 3): 2,
            (192, 276, 480, 0): 3, (192, 276, 480, 3): 3}
# the probes' tolerances (tests/test_torch_probes.py): T3 bf16 / int8
# (relative, absolute), at least 99% of elements bit-equal; T4 bf16
# relative (int8 and T1 exact)
T3_TOL = {"bfloat16": (2 ** -7, 1e-2), "int8": (2 ** -7, 2e-2)}
T4_RTOL = 1e-3
# K4 / K6 at imagenet swin_t's stages (batch 64 at 224 px, window 7, head
# dim 32): (C, H = W, shift); then one window-8 shape (C, H = W, shift,
# batch).  swin_t's stages hold 2, 2, 6 and 2 blocks, half of them shifted,
# except the 7x7 stage, which drops its shift (shift 3 there is a kernel
# check only); the "imagenet" phase runs the forward pass.
SWIN_T = ((96, 56, 0), (96, 56, 3), (192, 28, 0), (192, 28, 3),
          (384, 14, 0), (384, 14, 3), (768, 7, 0), (768, 7, 3))
SWIN_T_BATCH = 64
WINDOW8 = (128, 64, 4, 8)
# T2 against its twin (tests/test_torch_cuda.py): max abs err and the share
# of bit-equal elements (the bf16 GEMMs sum in another order than the twin)
T2_ATOL, T2_BIT_EQUAL = 0.05, 0.95


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def sh(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        fail(f"{' '.join(cmd)} -> rc {proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout.strip()


def bound_ops(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time for the work, whose
    operations may run at more than one type's peak: {"bfloat16": flops,
    "int8": ops}."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_FLOPS[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(nbytes, flops, dtype="bfloat16"):
    return bound_ops(nbytes, {dtype: flops})


def cuda_time(fn, torch):
    """Milliseconds of one call, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def compare_timed(kernel, plain, torch, library=None, rounds=2, more=None):
    """Warm each, then time in turns plain, kernel, [library, more...,
    more..., library,] kernel, plain; medians by name ("library" is None
    without one).  ``more`` names further functions to time in the same
    turns."""
    fns = {"plain": plain, "kernel": kernel}
    if library is not None:
        fns["library"] = library
    fns.update(more or {})
    order = list(fns) + list(fns)[::-1]
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for which in order:
            times[which].append(cuda_time(fns[which], torch))
    out = {name: statistics.median(v) for name, v in times.items()}
    out.setdefault("library", None)
    return out


def compare(got, want, tol):
    """(within tolerance and finite, max abs err, relative L2 error)."""
    rel, atol = tol
    d = (got.float() - want.float()).abs()
    finite = bool(d.isfinite().all()) and bool(got.float().isfinite().all())
    ok = finite and bool((d <= want.float().abs() * rel + atol).all())
    rel_l2 = float(d.norm() / want.float().norm())
    return ok, float(d.max()), rel_l2


def check_close(got, want, tol, what):
    ok, err, rel_l2 = compare(got, want, tol)
    if not ok:
        fail(f"{what}: max abs err {err} (non-finite or beyond tolerance "
             f"rel {tol[0]}, abs {tol[1]})")
    return err, rel_l2


def uint8_psnr(a, b):
    d = a.float() - b.float()
    mse = float((d * d).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


class twins:
    """Within the block, the named kernels of the given modules are their
    plain twins: ``with twins((k1, "fused_swin_block_image"), ...)``."""

    def __init__(self, *pairs):
        self.pairs = pairs
        self.saved = []

    def __enter__(self):
        plain = {"fused_swin_block_image": "swin_block_image_plain",
                 "fused_swin_block": "swin_block_plain",
                 "fused_window_attention": "window_attention_plain",
                 "fused_window_attention_image": "window_attention_image_plain",
                 "stem_conv3x3": "stem_conv3x3_plain",
                 "warp_x_bounded": "warp_x_bounded_plain",
                 "sdpa": "sdpa_plain"}
        for mod, name in self.pairs:
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, getattr(mod, plain[name]))

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def iw3_frames(torch, dev, n, h, w, seed):
    """Seeded uint8 frames with structure (smooth colour fields, a moving
    disc, noise), made on the device."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    yy = torch.linspace(0, 1, h, device=dev).reshape(1, h, 1)
    xx = torch.linspace(0, 1.8, w, device=dev).reshape(1, 1, w)
    shift = torch.arange(n, device=dev).reshape(n, 1, 1) * 0.05
    base = torch.stack([torch.sin(6 * (xx + shift) + 2 * yy),
                        torch.cos(5 * yy - 3 * (xx + shift)),
                        (xx + shift) * yy], dim=-1) * 0.3 + 0.5
    disc = (((xx - 0.9 - shift) ** 2 + (yy - 0.5) ** 2) < 0.06).float()
    f = base * (1 - 0.5 * disc[..., None]) + 0.05 * torch.randn(
        (n, h, w, 3), generator=gen, device=dev)
    return (f.clamp(0, 1) * 255 + 0.5).to(torch.uint8)


def iw3_models(torch, dev, model_dir, flow_path=None):
    """Write shaped seeded weights to .nztm and load them back through the
    port's loaders: (depth model, row_flow_v3), on the card; ``flow_path``:
    row_flow_v3 from that .nztm instead."""
    from nunif_tpu_torch.iw3.depth import create_depth_model
    from nunif_tpu_torch.iw3.depth.depth_anything import (
        DepthAnything, shaped_flax_params as depth_params)
    from nunif_tpu_torch.iw3.models.row_flow_v3 import (
        RowFlowV3, shaped_flax_params as flow_params)
    from nunif_tpu_torch.models import from_flax, load_model, save_model
    depth = DepthAnything(encoder="vits")
    from_flax(depth, depth_params(depth, seed=0))
    save_model(depth, os.path.join(model_dir, "depth_any_v2_s.nztm"))
    if flow_path is None:
        flow = RowFlowV3()
        from_flax(flow, flow_params(flow, seed=1))
        flow_path = os.path.join(model_dir, "row_flow_v3.nztm")
        save_model(flow, flow_path)
    dm = create_depth_model("Any_V2_S", device=dev).load(
        checkpoint=os.path.join(model_dir, "depth_any_v2_s.nztm"))
    flow, _meta = load_model(flow_path, device=dev)
    return dm, flow


def iw3_batch(torch, dev, model_dir, k3, k7, flow_path=None):
    """8 uint8 1080p frames -> half-SBS through Iw3FrameProcessor: launch
    counts, non-degeneracy, median time of 3 batches after a warm one,
    and PSNR against the same batch through the twins; ``flow_path``: a
    row_flow_v3 .nztm to run in place of the seeded one."""
    from nunif_tpu_torch.iw3.composition import StereoFormat
    from nunif_tpu_torch.iw3.pipeline import StereoConfig, apply_divergence
    from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
    dm, flow = iw3_models(torch, dev, model_dir, flow_path)
    cfg = StereoConfig(method="row_flow_v3", divergence=2.0, convergence=0.5,
                       format=StereoFormat(half_sbs=True))
    proc = Iw3FrameProcessor(cfg, dm, flow, edge_dilation=2)
    frames = iw3_frames(torch, dev, IW3_BATCH, *IW3_HW, seed=4)
    k3.warp_x_bounded.launches = 0
    k7.sdpa.launches = 0
    out = proc(frames)
    torch.cuda.synchronize()
    launches = {"warp_x_bounded": k3.warp_x_bounded.launches,
                "sdpa": k7.sdpa.launches}
    print(f"iw3 batch launches: {launches}", flush=True)
    if tuple(out.shape) != (IW3_BATCH,) + IW3_HW + (3,):
        fail(f"iw3 batch output shape {tuple(out.shape)}")
    if launches != {"warp_x_bounded": 1, "sdpa": 12}:
        fail(f"iw3 batch did not run each kernel as expected: {launches}")
    if not (bool(out.isfinite().all()) and float(out.min()) >= 0.0
            and float(out.max()) <= 1.0):
        fail("iw3 batch output not finite in [0, 1]")
    # the path is not degenerate: depth varies and the warp moves pixels
    with torch.no_grad():
        x = frames.float() / 255
        depth = torch.stack(dm.minmax_normalize(dm.infer(x, edge_dilation=2)))
        left, _right = apply_divergence(depth, x, cfg, flow)
    depth_std = float(depth.std())
    moved = float(((left - x).abs() > 0.5 / 255).float().mean())
    print(f"iw3 normalised depth std {depth_std:.4f}, left-eye pixels moved "
          f"{moved:.4f}", flush=True)
    if depth_std <= 0.05 or moved < 0.10:
        fail(f"iw3 path degenerate: depth std {depth_std}, moved {moved}")
    del x, depth, left, _right
    batch_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        proc(frames)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    with twins((k3, "warp_x_bounded"), (k7, "sdpa")):
        out_twin = proc(frames)
        torch.cuda.synchronize()
    q = (out.clamp(0, 1) * 255 + 0.5).to(torch.uint8)
    q_twin = (out_twin.clamp(0, 1) * 255 + 0.5).to(torch.uint8)
    psnr = uint8_psnr(q, q_twin)
    med = statistics.median(batch_ms)
    print(f"iw3 batch 8 x 1080p -> half-SBS: median {med:.1f} ms "
          f"({1000 * IW3_BATCH / med:.1f} fps; runs "
          f"{[round(v, 1) for v in batch_ms]}); vs twins PSNR {psnr:.2f} dB, "
          f"identical px {float((q == q_twin).float().mean()):.4f}", flush=True)
    if psnr < FRAME_PSNR_MIN:
        fail(f"iw3 batch PSNR vs twins {psnr:.2f} dB < {FRAME_PSNR_MIN}")
    return med, launches, psnr


def k7_inputs(torch, gen, n, layout, batch=IW3_BATCH, heads=6):
    """(batch, heads, n, 64) bf16 q, k, v: three contiguous tensors, or
    ("strided") views of one (batch, n, 3, heads, 64) qkv tensor, as
    dinov2.Attention passes them on the iw3 path."""
    if layout == "strided":
        qkv = torch.randn((batch, n, 3, heads, 64), generator=gen,
                          device="cuda").to(torch.bfloat16)
        return tuple(qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    return tuple(torch.randn((batch, heads, n, 64), generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for _ in range(3))


def k7_launch_times(torch, F, k7, q, k, v):
    """K7 and SDPA on the same inputs without the host's share: 20 launches
    back to back between two CUDA events (median of 3)."""
    from nunif_tpu_torch.tools import time_ms
    kernel = lambda: k7.sdpa(q, k, v)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    return dict(ms_b2b=time_ms(kernel, 20), library_ms_b2b=time_ms(library, 20))


# K7's shapes (tokens, layout, batch, heads): the iw3 batch's (8 frames of
# 1080p: 28 x 49 patches + cls), two others, Video Depth Anything's window
# of 32 frames (ViT-S, 6 heads); the ViT-L trunks at 16 heads: DepthPro's
# 35 tiles of a frame (24 x 24 patches + cls) and ZoeD_Any_N's batch of 8
# (a 392 x 700 input: 28 x 50 patches + cls)
K7_SHAPES = ((1373, "contiguous", IW3_BATCH, 6), (1344, "contiguous", IW3_BATCH, 6),
             (197, "contiguous", IW3_BATCH, 6), (1373, "strided", IW3_BATCH, 6),
             (1373, "strided", 32, 6), (577, "strided", 35, 16),
             (1401, "strided", IW3_BATCH, 16), (1373, "strided", 1, 6))


def k7_device_child():
    """``chip_smoke.py --k7-device-ms``: K7's and SDPA's device time a
    launch (``tools.device_ms``, torch.profiler) at each of K7_SHAPES, as
    one JSON line.  The smoke run starts it in a process of its own: in the
    long one the profiler drops kernel records, and SDPA's read None."""
    import torch
    import torch.nn.functional as F
    from nunif_tpu_torch.ops import sdpa as k7
    from nunif_tpu_torch.tools import device_ms
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for n, layout, batch, heads in K7_SHAPES:
        q, k, v = k7_inputs(torch, gen, n, layout, batch, heads)
        out[f"{batch} {heads} {n} {layout}"] = dict(
            ms_device=device_ms(lambda: k7.sdpa(q, k, v)),
            library_ms_device=device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v)))
    print(json.dumps(out), flush=True)


def iw3_cli(model_dir):
    try:
        from PIL import Image
    except ImportError:
        return "skipped (no PIL)"
    import torch
    from nunif_tpu_torch.iw3 import cli
    frame = iw3_frames(torch, torch.device("cuda"), 1, 540, 960, seed=5)[0]
    src = os.path.join(model_dir, "iw3_in.png")
    out = os.path.join(model_dir, "iw3_out.png")
    Image.fromarray(frame.cpu().numpy()).save(src)
    cli.main(["-i", src, "-o", out, "--half-sbs", "--device", "cuda",
              "--depth-checkpoint", os.path.join(model_dir, "depth_any_v2_s.nztm"),
              "--stereo-checkpoint", os.path.join(model_dir, "row_flow_v3.nztm")])
    with Image.open(out) as im:
        if im.size != (960, 540):
            fail(f"iw3 CLI output size {im.size}")
    return "cli.main --half-sbs"


# iw3's other methods (the "iw3 methods" phase): K3 launches a batch of 8
# frames.  MLBW warps the [x, flip(x)] batch once a layer; mlbw_l2_inpaint's
# two-layer mask-MLBW warps each eye by its own call, as the JAX package
# does (2 layers x 2 eyes); the forward warps and their inpainting never
# reach K3.  K7: the depth net's 12 launches under every method.
IW3_METHODS = {"mlbw_l2": 2, "mlbw_l4": 4, "forward_fill": 0,
               "forward_inpaint": 0, "mlbw_l2_inpaint": 4}
IW3_DIVERGENCE, IW3_CONVERGENCE = 2.0, 0.5  # the CLI's defaults
# Methods whose stereo step makes discrete decisions on the depth: the
# depth-ordered splat (which source wins a pixel, where the holes fall) and
# the thresholded hole mask, inpainted by a seeded net.  K7's rounding
# against its twin (normalised depth: mean abs 0.0024, max 0.025 on this
# batch) moves those decisions: their frames read 42.4-42.8 dB (forward
# warps) and 37.8 dB (mlbw_l2_inpaint) against the full twin path, where
# the MLBW methods read 53 (H100 80GB HBM3, 700 W).  So each kernel is
# held at FRAME_PSNR_MIN where it acts: K7 on the depth, and K3 on the
# frame with only K3 replaced by its twin (the same depth); the full twin
# path's PSNR is printed beside them.
IW3_DISCRETE = ("forward_fill", "forward_inpaint", "mlbw_l2_inpaint")
# seeded weights of the methods' nets: (file, registry name, seed)
IW3_METHOD_NETS = {"mlbw_l2": ("mlbw_l2.nztm", "sbs.mlbw_l2", 1),
                   "mlbw_l4": ("mlbw_l4.nztm", "sbs.mlbw_l4", 1),
                   "mask_mlbw": ("mask_mlbw_l2.nztm", "sbs.mask_mlbw_l2", 2),
                   "inpaint": ("light_inpaint_v1.nztm",
                               "inpaint.light_inpaint_v1", 3)}


def iw3_method_models(torch, dev, model_dir):
    """Write the methods' nets with shaped seeded weights to .nztm and
    load them back through the port's loader: {method: side model}."""
    from nunif_tpu_torch.iw3.forward_inpaint import ForwardInpaint
    from nunif_tpu_torch.iw3.mlbw_inpaint import MLBWInpaint
    from nunif_tpu_torch.iw3.models import light_inpaint_v1, mlbw
    from nunif_tpu_torch.models import create_model, from_flax, load_model, save_model
    nets = {}
    for key, (fname, name, seed) in IW3_METHOD_NETS.items():
        net = create_model(name)
        shaped = (light_inpaint_v1 if key == "inpaint" else mlbw).shaped_flax_params
        from_flax(net, shaped(net, seed))
        path = os.path.join(model_dir, fname)
        save_model(net, path)
        nets[key], _meta = load_model(path, device=dev)
    return {"mlbw_l2": nets["mlbw_l2"], "mlbw_l4": nets["mlbw_l4"],
            "forward_fill": None,
            "forward_inpaint": ForwardInpaint(nets["inpaint"]),
            "mlbw_l2_inpaint": MLBWInpaint(nets["inpaint"], nets["mask_mlbw"])}


def iw3_hole_check(torch, method, side, x, depth, left):
    """(share of the left eye's pixels in the inpaint mask, mean abs
    change the net made inside it): the mask the net was given (the left
    eye runs flipped; the closing and the corner-anchored resize are
    symmetric), against the same eye without inpainting."""
    from nunif_tpu_torch.iw3.backward_warp import (
        apply_divergence_nn_delta_weight, postprocess_hole_mask)
    from nunif_tpu_torch.iw3.dilation import mask_closing
    from nunif_tpu_torch.iw3.forward_warp import apply_divergence_forward_warp
    from nunif_tpu_torch.iw3.mlbw_inpaint import MASK_MLBW_THRESHOLD
    if method == "forward_inpaint":
        bare, _r, lmask, _rm = apply_divergence_forward_warp(
            x, depth, IW3_DIVERGENCE, IW3_CONVERGENCE, return_mask=True,
            width_base=False)
        mask = mask_closing((lmask > 0).float())
    else:
        bare, logits = apply_divergence_nn_delta_weight(
            side.mask_model, x, depth, IW3_DIVERGENCE, IW3_CONVERGENCE,
            shift=-1, return_mask=True)
        mask = postprocess_hole_mask(logits, x.shape[1:3], MASK_MLBW_THRESHOLD)
    inside = mask.bool().expand_as(bare)
    return float(mask.mean()), float((left - bare).abs()[inside].mean())


def iw3_methods_phase(torch, dev, model_dir, k3, k7):
    """8 uint8 1080p frames through Iw3FrameProcessor with each method of
    IW3_METHODS (half-SBS, divergence 2, convergence 0.5, edge dilation 2):
    exact K3 / K7 launch counts, outputs finite in [0, 1], >= 10% of the
    left eye's pixels moved, the inpaint mask on 0-50% of the pixels and
    changed by the net, >= 45 dB against the twins (K7 on the depth; for
    IW3_DISCRETE, K3 on the frame with K7 kept), median of 3 batches after
    a warm one, and a torch.profiler split of one batch."""
    from nunif_tpu_torch.iw3.composition import StereoFormat
    from nunif_tpu_torch.iw3.depth import create_depth_model
    from nunif_tpu_torch.iw3.pipeline import StereoConfig, apply_divergence
    from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
    dm = create_depth_model("Any_V2_S", device=dev).load(
        checkpoint=os.path.join(model_dir, "depth_any_v2_s.nztm"))
    sides = iw3_method_models(torch, dev, model_dir)
    frames = iw3_frames(torch, dev, IW3_BATCH, *IW3_HW, seed=4)
    def norm_depth():
        with torch.no_grad():
            return torch.stack(dm.minmax_normalize(dm.infer(x, edge_dilation=2)))
    x = frames.float() * (1.0 / 255.0)
    depth = norm_depth()
    with twins((k7, "sdpa")):
        depth_twin = norm_depth()
    to_u8 = lambda t: (t.clamp(0, 1) * 255 + 0.5).to(torch.uint8)  # noqa: E731
    depth_psnr = uint8_psnr(to_u8(depth), to_u8(depth_twin))
    print(f"iw3 methods: normalised depth {tuple(depth.shape)} vs twins PSNR "
          f"{depth_psnr:.2f} dB, max abs "
          f"{float((depth - depth_twin).abs().max()):.4g}, mean abs "
          f"{float((depth - depth_twin).abs().mean()):.4g}", flush=True)
    if depth_psnr < FRAME_PSNR_MIN:
        fail(f"iw3 methods: depth PSNR vs twins {depth_psnr:.2f} dB < "
             f"{FRAME_PSNR_MIN}")
    del depth_twin
    rows = {}
    for method, k3_want in IW3_METHODS.items():
        side = sides[method]
        cfg = StereoConfig(method=method, divergence=IW3_DIVERGENCE,
                           convergence=IW3_CONVERGENCE,
                           format=StereoFormat(half_sbs=True))
        proc = Iw3FrameProcessor(cfg, dm, side, edge_dilation=2)
        k3.warp_x_bounded.launches = 0
        k7.sdpa.launches = 0
        out = proc(frames)
        torch.cuda.synchronize()
        launches = {"warp_x_bounded": k3.warp_x_bounded.launches,
                    "sdpa": k7.sdpa.launches}
        if launches != {"warp_x_bounded": k3_want, "sdpa": 12}:
            fail(f"iw3 {method}: launches {launches}, want K3 {k3_want}, K7 12")
        if tuple(out.shape) != (IW3_BATCH,) + IW3_HW + (3,):
            fail(f"iw3 {method}: output shape {tuple(out.shape)}")
        if not (bool(out.isfinite().all()) and float(out.min()) >= 0.0
                and float(out.max()) <= 1.0):
            fail(f"iw3 {method}: output not finite in [0, 1]")
        with torch.no_grad():
            left, right = apply_divergence(depth, x, cfg, side)
            moved = float(((left - x).abs() > 0.5 / 255).float().mean())
            holes = iw3_hole_check(torch, method, side, x, depth, left) \
                if "inpaint" in method else None
        del left, right
        if moved < 0.10:
            fail(f"iw3 {method}: {moved:.4f} of the left eye's pixels moved")
        if holes is not None and not (0.0 < holes[0] < 0.5 and holes[1] > 1 / 255):
            fail(f"iw3 {method}: inpaint mask on {holes[0]:.4f} of the pixels, "
                 f"mean change inside {holes[1]:.4f}")
        batch_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            proc(frames)
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        with twins((k3, "warp_x_bounded"), (k7, "sdpa")):
            out_twin = proc(frames)
            torch.cuda.synchronize()
        psnr = uint8_psnr(to_u8(out), to_u8(out_twin))
        psnr_k3 = None
        if method in IW3_DISCRETE:
            with twins((k3, "warp_x_bounded")):
                out_twin = proc(frames)
                torch.cuda.synchronize()
            psnr_k3 = uint8_psnr(to_u8(out), to_u8(out_twin))
        del out, out_twin
        med = statistics.median(batch_ms)
        hole_txt = "" if holes is None else (
            f"; left-eye inpaint mask {holes[0]:.4f} of the pixels, mean "
            f"change inside {holes[1]:.4f}")
        print(f"iw3 {method} batch 8 x 1080p -> half-SBS: median {med:.1f} ms "
              f"({1000 * IW3_BATCH / med:.1f} fps; runs "
              f"{[round(v, 1) for v in batch_ms]}); launches {launches}; "
              f"left-eye pixels moved {moved:.4f}{hole_txt}; vs twins PSNR "
              f"{psnr:.2f} dB" + ("" if psnr_k3 is None else
                                   f", vs K3's twin alone {psnr_k3:.2f} dB"),
              flush=True)
        held = psnr if psnr_k3 is None else psnr_k3
        if held < FRAME_PSNR_MIN:
            fail(f"iw3 {method}: PSNR vs twins {held:.2f} dB < {FRAME_PSNR_MIN}")
        print(f"iw3 {method} profile:", flush=True)
        device_ms = profile_frame(torch, proc, frames, top=10,
                                  share_of=("K3 warp_x_bounded", "warp_x_kernel"))
        rows[method] = dict(ms=med, runs=batch_ms, launches=launches,
                            psnr=psnr, psnr_k3=psnr_k3, moved=moved,
                            device_ms=device_ms)
        torch.cuda.empty_cache()
    return rows


def iw3_methods_cli(model_dir):
    """The iw3 CLI on one 540p PNG with --method mlbw_l2, forward_fill and
    mlbw_l2_inpaint, from the written checkpoints."""
    try:
        from PIL import Image
    except ImportError:
        return "skipped (no PIL)"
    import torch
    from nunif_tpu_torch.iw3 import cli
    frame = iw3_frames(torch, torch.device("cuda"), 1, 540, 960, seed=5)[0]
    src = os.path.join(model_dir, "iw3_methods_in.png")
    Image.fromarray(frame.cpu().numpy()).save(src)
    ckpt = {"mlbw_l2": "mlbw_l2.nztm", "forward_fill": None,
            "mlbw_l2_inpaint": "light_inpaint_v1.nztm"}
    for method, fname in ckpt.items():
        out = os.path.join(model_dir, f"iw3_{method}.png")
        argv = ["-i", src, "-o", out, "--method", method, "--half-sbs",
                "--device", "cuda", "--depth-checkpoint",
                os.path.join(model_dir, "depth_any_v2_s.nztm")]
        if fname:
            argv += ["--stereo-checkpoint", os.path.join(model_dir, fname)]
        cli.main(argv)
        with Image.open(out) as im:
            if im.size != (960, 540):
                fail(f"iw3 CLI --method {method}: output size {im.size}")
    return "cli.main --method " + ", ".join(ckpt)


# iw3's temporal path (the "iw3 temporal" phase): uint8 1080p frames in
# batches of 8 through Iw3FrameProcessor and its flush, half-SBS,
# divergence 2, convergence 0.5, edge dilation 2.  Case: (depth model,
# method, frames, EMA (decay, lookahead) or None).
TEMPORAL_CASES = {
    "a": ("VDA_S", "row_flow_v3", 48, None),
    "b": ("VDA_Stream_S", "row_flow_v3", 48, None),
    "c": ("Any_V2_S", "row_flow_v3", 48, (0.9, 30)),
    "d": ("Any_V2_S", "mlbw_l2_inpaint_video", 40, None),
    "e": ("VDA_Stream_S", "mlbw_l2_inpaint_video", 40, None),
}
# frames each call returns (the batches, then the flush) and the exact
# launches of a whole run.  (a) windowed VDA: one window of 32 frames when
# the 32nd arrives, then the flush's window of 10 context + 16 new frames
# padded to 32 (K7: 2 windows x 12 blocks at (32, 6, 1373, 64)); K3 once
# a compose call.  (b) streaming: no lag, K7 12 a batch at (8, 6, 1373,
# 64).  (c) the lookahead of 30 holds frames 29 deep.  (d, e) the clip
# queue drains 12 at frames 16, 24 and 40, the flush pads the last 4 to a
# clip; the mask-MLBW warps each eye of a batch (K3 4 a batch).
TEMPORAL_COUNTS = {"a": [0, 0, 0, 32, 0, 0, 16], "b": [8] * 6 + [0],
                   "c": [0, 0, 0, 3, 8, 8, 29], "d": [0, 12, 12, 0, 12, 4],
                   "e": [0, 12, 12, 0, 12, 4]}
TEMPORAL_LAUNCHES = {"a": {"sdpa": 24, "warp_x_bounded": 2},
                     "b": {"sdpa": 72, "warp_x_bounded": 6},
                     "c": {"sdpa": 72, "warp_x_bounded": 4},
                     "d": {"sdpa": 60, "warp_x_bounded": 20},
                     "e": {"sdpa": 60, "warp_x_bounded": 20}}
# the methods that decide on the depth (the hole mask), held where K3 acts
TEMPORAL_DISCRETE = ("d", "e")
CODE_BITS, CODE_ROWS = 6, 96  # the frame index, burnt into the top rows


def indexed_frames(torch, dev, n, seed):
    """iw3_frames with the frame index burnt into the top CODE_ROWS rows as
    CODE_BITS black / white blocks, most significant first."""
    frames = iw3_frames(torch, dev, n, *IW3_HW, seed=seed)
    bw = IW3_HW[1] // CODE_BITS
    for i in range(n):
        for b in range(CODE_BITS):
            frames[i, :CODE_ROWS, b * bw:(b + 1) * bw] = 255 * ((i >> (CODE_BITS - 1 - b)) & 1)
    return frames


def read_indexes(out):
    """The indexes burnt into half-SBS output frames, from the centres of
    the left eye's code blocks (which the warp moves by < 40 px)."""
    bw = out.shape[2] // 2 // CODE_BITS
    idx = [0] * out.shape[0]
    for b in range(CODE_BITS):
        c = b * bw + bw // 2
        v = out[:, 16:CODE_ROWS - 16, c - bw // 4:c + bw // 4].float().mean(dim=(1, 2, 3))
        idx = [2 * i + int(x > 127.5) for i, x in zip(idx, v.tolist())]
    return idx


def temporal_models(torch, dev, model_dir):
    """Seeded VDA-S (motion modules' output projections non-zero) and
    LightVideoInpaintV1 weights written to .nztm and loaded back through
    the port's loaders, beside the earlier phases' Any_V2_S, row_flow_v3
    and mask-MLBW: {name: model}."""
    from nunif_tpu_torch.iw3.depth import create_depth_model
    from nunif_tpu_torch.iw3.depth.vda import VideoDepthAnything, shaped_flax_params
    from nunif_tpu_torch.iw3.mlbw_inpaint import MLBWInpaintVideo
    from nunif_tpu_torch.iw3.models import light_video_inpaint_v1 as lv
    from nunif_tpu_torch.models import from_flax, load_model, save_model
    vda = VideoDepthAnything(encoder="vits")
    from_flax(vda, shaped_flax_params(vda, 5))
    save_model(vda, os.path.join(model_dir, "vda_s.nztm"))
    net = lv.LightVideoInpaintV1()
    from_flax(net, lv.shaped_flax_params(net, 6))
    save_model(net, os.path.join(model_dir, "light_video_inpaint_v1.nztm"))
    del vda, net
    path = lambda f: os.path.join(model_dir, f)  # noqa: E731
    models = {name: create_depth_model(name, device=dev).load(checkpoint=path(f))
              for name, f in (("VDA_S", "vda_s.nztm"), ("VDA_Stream_S", "vda_s.nztm"),
                              ("Any_V2_S", "depth_any_v2_s.nztm"))}
    models["row_flow_v3"] = load_model(path("row_flow_v3.nztm"), device=dev)[0]
    models["mlbw_l2_inpaint_video"] = MLBWInpaintVideo(
        load_model(path("light_video_inpaint_v1.nztm"), device=dev)[0],
        load_model(path("mask_mlbw_l2.nztm"), device=dev)[0])
    return models


def temporal_run(torch, models, case, frames):
    """One whole run of a case from a reset state: (frames each call
    returned, the outputs as uint8)."""
    from nunif_tpu_torch.iw3.composition import StereoFormat
    from nunif_tpu_torch.iw3.pipeline import StereoConfig
    from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
    depth_name, method, n, ema = TEMPORAL_CASES[case]
    dm, side = models[depth_name], models[method]
    dm.reset()
    if ema is None:
        dm.disable_ema()
    else:
        dm.enable_ema(ema[0], buffer_size=ema[1])
    if hasattr(side, "reset"):
        side.reset()
    cfg = StereoConfig(method=method, divergence=IW3_DIVERGENCE,
                       convergence=IW3_CONVERGENCE, format=StereoFormat(half_sbs=True))
    proc = Iw3FrameProcessor(cfg, dm, side, edge_dilation=2)
    counts, outs = [], []
    for y in [proc(frames[i:i + IW3_BATCH]) for i in range(0, n, IW3_BATCH)] + [proc.flush()]:
        counts.append(0 if y is None else int(y.shape[0]))
        if y is not None:
            if not (bool(y.isfinite().all()) and float(y.min()) >= 0.0
                    and float(y.max()) <= 1.0):
                fail(f"iw3 temporal ({case}): output not finite in [0, 1]")
            outs.append((y * 255 + 0.5).to(torch.uint8))
    torch.cuda.synchronize()
    return counts, torch.cat(outs)


def temporal_depth_psnr(torch, k7, dm, x):
    """Normalised depth of the frames x (n, H, W, 3) in [0, 1] with K7
    against K7's twin, uint8 PSNR: a window of the windowed model, or the
    streaming model from a reset state."""
    from nunif_tpu_torch.iw3.depth_scaler import frame_stats, minmax_normalize

    def depth():
        dm.reset()
        with torch.no_grad():
            d = dm.infer(x, edge_dilation=2)
        st = frame_stats(d)
        return minmax_normalize(d, st[:, 0].reshape(-1, 1, 1, 1),
                                st[:, 1].reshape(-1, 1, 1, 1))
    got = depth()
    with twins((k7, "sdpa")):
        want = depth()
    dm.reset()
    to_u8 = lambda t: (t.clamp(0, 1) * 255 + 0.5).to(torch.uint8)  # noqa: E731
    return uint8_psnr(to_u8(got), to_u8(want)), float(got.std())


def iw3_temporal_phase(torch, dev, model_dir, k3, k7):
    """The five TEMPORAL_CASES: exact frame counts and launches, every
    frame once and in order (the burnt-in indexes), outputs finite in [0,
    1], >= 10% of the left eye's pixels moved, >= 45 dB against the twins
    (K7 at the normalised depth, K3 alone on the frame where the method
    decides on the depth, both twins on the frames of the others), the
    windowed model's temporal mixing, fps (host median of 3 whole runs
    after a warm one, the flush included), peak memory and a
    torch.profiler split of one run."""
    from nunif_tpu_torch.iw3.composition import StereoFormat, postprocess_image
    models = temporal_models(torch, dev, model_dir)
    frames = indexed_frames(torch, dev, 48, seed=6)
    x = frames.float() * (1.0 / 255.0)
    to_u8 = lambda t: (t.clamp(0, 1) * 255 + 0.5).to(torch.uint8)  # noqa: E731
    # K7 at the normalised depth; windowed VDA's temporal mixing
    vda = models["VDA_S"]
    checks = {}
    for name, n in (("VDA_S", 32), ("VDA_Stream_S", IW3_BATCH)):
        checks[name] = temporal_depth_psnr(torch, k7, models[name], x[:n])
    with torch.no_grad():
        prep = vda._preprocess(x[:32])
        window0 = vda.window_forward(prep)[0]
        alone0 = vda.window_forward(prep[:1])[0]
    mixing = float((window0 - alone0).abs().max() / (window0.max() - window0.min()))
    del prep, window0, alone0
    print(f"iw3 temporal: normalised depth vs K7's twin (PSNR dB, depth std) "
          f"{checks}; windowed VDA frame 0 in its window vs alone: max diff "
          f"{mixing:.4f} of its range", flush=True)
    for name, (psnr, std) in checks.items():
        if psnr < FRAME_PSNR_MIN or std <= 0.05:
            fail(f"iw3 temporal: {name} depth vs K7's twin {psnr:.2f} dB, std {std:.4f}")
    if mixing < 1e-2:
        fail(f"iw3 temporal: windowed VDA's frame 0 does not depend on its window "
             f"({mixing:.3g})")
    rows = {}
    for case, (depth_name, method, n, ema) in TEMPORAL_CASES.items():
        what = f"iw3 temporal ({case}: {depth_name}, {method}" + (
            f", EMA {ema}" if ema else "") + ")"
        for fn in (k3.warp_x_bounded, k7.sdpa):
            fn.launches = 0
        counts, out = temporal_run(torch, models, case, frames)
        launches = {"sdpa": k7.sdpa.launches,
                    "warp_x_bounded": k3.warp_x_bounded.launches}
        order = read_indexes(out)
        if counts != TEMPORAL_COUNTS[case] or sum(counts) != n:
            fail(f"{what}: frames a call {counts}, want {TEMPORAL_COUNTS[case]}")
        if order != list(range(n)):
            fail(f"{what}: frames out of order or lost: {order}")
        if launches != TEMPORAL_LAUNCHES[case]:
            fail(f"{what}: launches {launches}, want {TEMPORAL_LAUNCHES[case]}")
        # the left eye against the frame composed unwarped
        first = out[:IW3_BATCH]
        with torch.no_grad():
            ref = to_u8(postprocess_image(x[:IW3_BATCH], x[:IW3_BATCH],
                                          StereoFormat(half_sbs=True)))
        half = out.shape[2] // 2
        moved = float(((first[:, :, :half].int() - ref[:, :, :half].int()).abs() > 1)
                      .float().mean())
        del ref, first
        if moved < 0.10:
            fail(f"{what}: {moved:.4f} of the left eye's pixels moved")
        pairs = ((k3, "warp_x_bounded"),) if case in TEMPORAL_DISCRETE else (
            (k3, "warp_x_bounded"), (k7, "sdpa"))
        with twins(*pairs):
            _c, out_twin = temporal_run(torch, models, case, frames)
        psnr = uint8_psnr(out, out_twin)
        del out, out_twin
        if psnr < FRAME_PSNR_MIN:
            fail(f"{what}: PSNR vs twins {psnr:.2f} dB < {FRAME_PSNR_MIN}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            temporal_run(torch, models, case, frames)
            run_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(run_s)
        print(f"{what}, {n} x 1080p -> half-SBS: median {med * 1e3:.1f} ms a run "
              f"({n / med:.2f} fps; runs {[round(v * 1e3, 1) for v in run_s]}); frames "
              f"a call {counts}; launches {launches}; left-eye pixels moved "
              f"{moved:.4f}; vs {'K3' if len(pairs) == 1 else 'both'} twin"
              f"{'' if len(pairs) == 1 else 's'} PSNR {psnr:.2f} dB; peak memory "
              f"{peak:.2f} GiB", flush=True)
        print(f"iw3 temporal ({case}) profile:", flush=True)
        # one session: a run records up to ~31k kernels, and where a session
        # dropped records its retries have dropped them too, each retry a
        # whole run under the profiler (the smoke's time limit)
        device = profile_frame(torch, lambda f: temporal_run(torch, models, case, f),
                               frames, top=10,
                               share_of=("K7 flash_attn", "flash"), tries=1)
        rows[case] = dict(ms=med * 1e3, runs_ms=[v * 1e3 for v in run_s], fps=n / med,
                          frames=n, counts=counts, launches=launches, moved=moved,
                          psnr=psnr, psnr_twins="K3" if len(pairs) == 1 else "K3 K7",
                          peak_gib=peak, device_ms=device)
        torch.cuda.empty_cache()
    rows["depth_checks"] = {k: {"psnr": v[0], "std": v[1]} for k, v in checks.items()}
    rows["mixing"] = mixing
    del models, frames, x
    torch.cuda.empty_cache()
    return rows


# iw3's other depth families (the "iw3 depth families" phase): K7 launches a
# batch of 8 1080p frames (DepthPro / DepthPro_S: one frame), from the
# code's shape math.  ZoeD_N / NK run the BEiT attention (plain, with its
# bias) and no K7; ZoeD_Any_N's DINOv2-L takes 24 blocks at (8, 16, 1401,
# 64); Any_V3_Mono's at (8, 16, 1373, 64); DepthPro's patch ViT runs its
# 35 tiles as one batch, (35, 16, 577, 64) x 24, and the image and FOV
# ViTs (1, 16, 577, 64) x 24 each (DepthPro_S: 257 tokens); NULL has no
# network.
FAMILY_K7 = {"ZoeD_N": 0, "ZoeD_NK": 0, "ZoeD_Any_N": 24, "Any_V3_Mono": 24,
             "NULL": 0, "DepthPro": 72, "DepthPro_S": 72}
FAMILY_FRAMES = {"DepthPro": 1, "DepthPro_S": 1}  # process_image, one frame
ROUND_TRIP_FAMILY = "ZoeD_N"


def family_model(torch, dev, name, model_dir, seed):
    """(depth wrapper, parameters): the wrapper's own ``load()`` on the card
    (its full-width net, flax's init drawn from a card generator), then
    ``seeded_weights_`` in place from the same generator with the family's
    ``SEEDED_FILLS``; ``ROUND_TRIP_FAMILY``'s weights are then written to
    .nztm and loaded back through ``load(checkpoint=)`` (the others skip
    the round trip: DepthPro's ~950M parameters would make a 3.8 GB
    file)."""
    from nunif_tpu_torch.iw3.depth import create_depth_model
    from nunif_tpu_torch.iw3.depth.base import SEEDED_FILLS, seeded_weights_
    from nunif_tpu_torch.models import save_model, to_flax
    dm = create_depth_model(name, device=dev)
    if name == "NULL":
        return dm.load(), 0
    gen = torch.Generator(device=dev).manual_seed(seed)
    dm.load(generator=gen)
    seeded_weights_(dm.model, gen, fills=SEEDED_FILLS[name])
    n_params = sum(p.numel() for p in dm.model.parameters())
    if name == ROUND_TRIP_FAMILY:
        net = dm.model
        path = os.path.join(model_dir, "zoed_n.nztm")
        t0 = time.perf_counter()
        save_model(net, path)
        dm.load(checkpoint=path)
        loaded = to_flax(dm.model)
        same = all(np.array_equal(loaded[k], v) for k, v in to_flax(net).items())
        print(f"iw3 depth families: {name} weights -> {path} "
              f"({os.path.getsize(path) / 2 ** 30:.2f} GiB) -> load(checkpoint=) in "
              f"{time.perf_counter() - t0:.1f} s; arrays equal {same}", flush=True)
        if not same:
            fail(f"iw3 depth families: {name}'s .nztm round trip changed the weights")
        del net, loaded
    return dm, n_params


def family_depth(torch, dm, x):
    """The normalised depth (the family's scaler mode, per frame) of x."""
    from nunif_tpu_torch.iw3.depth_scaler import frame_stats
    with torch.no_grad():
        d = dm.infer(x, edge_dilation=2)
        st = frame_stats(d)
        return dm.scaler.normalize(d, st[:, 0].reshape(-1, 1, 1, 1),
                                   st[:, 1].reshape(-1, 1, 1, 1))


def family_run(torch, dm, flow, frames, name):
    """The family's frames -> half-SBS: Iw3FrameProcessor on a batch, or
    process_image on one frame (DepthPro).  uint8 out."""
    from nunif_tpu_torch.iw3.composition import StereoFormat
    from nunif_tpu_torch.iw3.pipeline import StereoConfig, process_image
    from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
    cfg = StereoConfig(method="row_flow_v3", divergence=IW3_DIVERGENCE,
                       convergence=IW3_CONVERGENCE, format=StereoFormat(half_sbs=True))
    if name in FAMILY_FRAMES:
        x = frames[0].float() * (1.0 / 255.0)
        y = process_image(x, cfg, dm, flow, edge_dilation=2)[None]
    else:
        y = Iw3FrameProcessor(cfg, dm, flow, edge_dilation=2)(frames)
    if not (bool(y.isfinite().all()) and float(y.min()) >= 0.0 and float(y.max()) <= 1.0):
        fail(f"iw3 depth families ({name}): output not finite in [0, 1]")
    return (y * 255 + 0.5).to(torch.uint8)


def family_cli(model_dir):
    """The image CLI with --depth-model ZoeD_N (the .nztm written by the
    round trip) and DepthPro (its default seeded init)."""
    try:
        from PIL import Image
    except ImportError:
        return "skipped (no PIL)"
    import torch
    from nunif_tpu_torch.iw3 import cli
    frame = iw3_frames(torch, torch.device("cuda"), 1, 540, 960, seed=22)[0]
    src = os.path.join(model_dir, "families_in.png")
    Image.fromarray(frame.cpu().numpy()).save(src)
    ran = []
    for name, extra in (("ZoeD_N", ["--depth-checkpoint",
                                    os.path.join(model_dir, "zoed_n.nztm")]),
                        ("DepthPro", [])):
        out = os.path.join(model_dir, f"families_{name}.png")
        t0 = time.perf_counter()
        cli.main(["-i", src, "-o", out, "--half-sbs", "--device", "cuda",
                  "--depth-model", name, "--stereo-checkpoint",
                  os.path.join(model_dir, "row_flow_v3.nztm")] + extra)
        with Image.open(out) as im:
            if im.size != (960, 540):
                fail(f"iw3 CLI --depth-model {name}: output size {im.size}")
        ran.append(f"--depth-model {name} ({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
    return "; ".join(ran)


def depth_families_phase(torch, dev, model_dir, k3, k7):
    """Every family of FAMILY_K7 at full width on seeded weights: 8
    structured 1080p frames through Iw3FrameProcessor with row_flow_v3
    (DepthPro / DepthPro_S: one frame through process_image), exact K7
    launches, outputs finite in [0, 1], the normalised depth not flat
    (std > 0.05) and >= 10% of the left eye's pixels moved, K7 against its
    twin at the normalised depth and the frame against the twin path
    (K3 and K7), both >= 45 dB, the time (median of 3 after a warm run) and
    peak memory; then the image CLI with ZoeD_N and DepthPro.  (No
    torch.profiler split: in this long process every session of these
    batches recorded 20-26 kernels fewer than it launched.)"""
    from nunif_tpu_torch.iw3.composition import StereoFormat, postprocess_image
    from nunif_tpu_torch.models import load_model
    t_phase = time.perf_counter()
    flow = load_model(os.path.join(model_dir, "row_flow_v3.nztm"), device=dev)[0]
    frames = iw3_frames(torch, dev, IW3_BATCH, *IW3_HW, seed=21)
    to_u8 = lambda t: (t.clamp(0, 1) * 255 + 0.5).to(torch.uint8)  # noqa: E731
    rows = {}
    for seed, name in enumerate(FAMILY_K7, start=30):
        t_family = time.perf_counter()
        torch.cuda.empty_cache()
        dm, n_params = family_model(torch, dev, name, model_dir, seed)
        n = FAMILY_FRAMES.get(name, IW3_BATCH)
        what = f"iw3 depth families ({name}, {n} x 1080p -> half-SBS)"
        for fn in (k3.warp_x_bounded, k7.sdpa):
            fn.launches = 0
        out = family_run(torch, dm, flow, frames, name)
        torch.cuda.synchronize()
        launches = {"sdpa": k7.sdpa.launches, "warp_x_bounded": k3.warp_x_bounded.launches}
        if tuple(out.shape) != (n,) + IW3_HW + (3,):
            fail(f"{what}: output shape {tuple(out.shape)}")
        if launches["sdpa"] != FAMILY_K7[name] or launches["warp_x_bounded"] != 1:
            fail(f"{what}: launches {launches}, want sdpa {FAMILY_K7[name]}, "
                 f"warp_x_bounded 1")
        x = frames[:n].float() * (1.0 / 255.0)
        depth = family_depth(torch, dm, x)
        depth_std = float(depth.std())
        if FAMILY_K7[name]:
            with twins((k7, "sdpa")):
                depth_twin = family_depth(torch, dm, x)
            depth_psnr = uint8_psnr(to_u8(depth), to_u8(depth_twin))
            del depth_twin
        else:
            depth_psnr = None  # no K7 on this family's path
        with torch.no_grad():
            ref = to_u8(postprocess_image(x, x, StereoFormat(half_sbs=True)))
        half = IW3_HW[1] // 2
        moved = float(((out[:, :, :half].int() - ref[:, :, :half].int()).abs() > 1)
                      .float().mean())
        del ref, depth, x
        if depth_std <= 0.05 or moved < 0.10:
            fail(f"{what}: degenerate: normalised depth std {depth_std:.4f}, "
                 f"left-eye pixels moved {moved:.4f}")
        if depth_psnr is not None and depth_psnr < FRAME_PSNR_MIN:
            fail(f"{what}: normalised depth vs K7's twin {depth_psnr:.2f} dB "
                 f"< {FRAME_PSNR_MIN}")
        with twins((k3, "warp_x_bounded"), (k7, "sdpa")):
            out_twin = family_run(torch, dm, flow, frames, name)
        psnr = uint8_psnr(out, out_twin)
        del out, out_twin
        if psnr < FRAME_PSNR_MIN:
            fail(f"{what}: PSNR vs twins {psnr:.2f} dB < {FRAME_PSNR_MIN}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            family_run(torch, dm, flow, frames, name)
            torch.cuda.synchronize()
            run_ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(run_ms)
        rows[name] = dict(ms=med, runs_ms=run_ms, fps=1000 * n / med, frames=n,
                          params=n_params, launches=launches,
                          depth_psnr_vs_k7_twin=depth_psnr, depth_std=depth_std,
                          moved=moved, psnr_vs_twins=psnr, peak_gib=peak,
                          seconds=time.perf_counter() - t_family)
        print(f"{what}: median {med:.1f} ms ({1000 * n / med:.2f} fps; runs "
              f"{[round(v, 1) for v in run_ms]}); {n_params / 1e6:.1f}M parameters; "
              f"peak memory {peak:.2f} GiB; launches {launches} (K7 want "
              f"{FAMILY_K7[name]}); normalised depth std {depth_std:.4f}, vs K7's "
              f"twin {'no K7' if depth_psnr is None else f'{depth_psnr:.2f} dB'}; "
              f"left-eye pixels moved {moved:.4f}; frame vs twins {psnr:.2f} dB; "
              f"{rows[name]['seconds']:.1f} s", flush=True)
        del dm
        torch.cuda.empty_cache()
    ran = family_cli(model_dir)
    print(f"iw3 depth families CLI ran: {ran}", flush=True)
    print(f"iw3 depth families: phase wall time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return rows


# iw3's extras ("iw3 extras"): 8 structured 1080p frames whose picture is
# 800 rows between black bars of EXTRAS_BARS rows; AutoCropDetector finds
# the bars and the processor cuts them off on the host.  Each format runs
# with seeded DepthAA and the SOD convergence estimator (EMA on); K7 12 a
# batch (at the cropped frame's token count), K3 1 (0 under the debug
# depth, which does not warp).  The lagged case runs 48 frames through an
# EMA lookahead of 30 as the temporal phase's case (c): frames out a call
# [0, 0, 0, 3, 8, 8, 29], K7 72, K3 4, the estimator on every frame out.
EXTRAS_BARS = 140
EXTRAS_FORMATS = {"half_sbs": dict(half_sbs=True), "anaglyph_dubois": dict(anaglyph="dubois"),
                  "vr180": dict(vr180=True), "half_rgbd": dict(half_rgbd=True),
                  "debug_depth": dict(half_sbs=True)}
EXTRAS_LAGGED = dict(frames=48, ema=(0.9, 30), counts=[0, 0, 0, 3, 8, 8, 29],
                     launches={"sdpa": 72, "warp_x_bounded": 4})
# K7's rounding moves the normalised depth (~48 dB against its twin) and
# the estimator's quantiles with it; the convergence it yields is held to
# this (depth units; the estimator's output is a depth position)
EXTRAS_CONVERGENCE_TOL = 0.02


class RecordingEstimator:
    """A ConvergenceEstimator that keeps every convergence it returns."""

    def __init__(self, est):
        self.est, self.out = est, []

    def reset(self):
        self.est.reset()
        self.out = []

    def __call__(self, rgb, depth, reset_pts=None):
        self.out.append(self.est(rgb, depth, reset_pts=reset_pts))
        return self.out[-1]

    def values(self):
        import torch
        return torch.cat(self.out) if self.out else None


def letterbox(torch, content):
    """content (n, h, w, 3) uint8 on the device -> (n, h + 2 EXTRAS_BARS,
    w, 3) uint8 on the host, black bars of EXTRAS_BARS rows above and
    below."""
    n, h, w, c = content.shape
    out = torch.zeros((n, h + 2 * EXTRAS_BARS, w, c), dtype=torch.uint8)
    out[:, EXTRAS_BARS:EXTRAS_BARS + h] = content.cpu()
    return out.numpy()


def extras_models(torch, dev, model_dir, calibration):
    """Seeded DepthAA (shaped: it changes the depth) and SODV1 (its
    saliency median calibrated to 0.5 on ``calibration``) written to .nztm
    and loaded back through the port's loader."""
    from nunif_tpu_torch.iw3.models import depth_aa, sod_v1
    from nunif_tpu_torch.models import from_flax, load_model, save_model
    aa = depth_aa.DepthAA()
    from_flax(aa, depth_aa.shaped_flax_params(aa, 7))
    save_model(aa, os.path.join(model_dir, "depth_aa.nztm"))
    sod = sod_v1.SODV1().to(dev).eval()
    sod_v1.shaped_flax_params(sod, 8, calibration=calibration)
    save_model(sod, os.path.join(model_dir, "sod_v1.nztm"))
    return (load_model(os.path.join(model_dir, "depth_aa.nztm"), device=dev)[0],
            load_model(os.path.join(model_dir, "sod_v1.nztm"), device=dev)[0])


def extras_run(torch, proc, batches):
    """Every batch and the flush through proc: (frames each call returned,
    the outputs)."""
    counts, outs = [], []
    for y in [proc(b) for b in batches] + [proc.flush()]:
        counts.append(0 if y is None else int(y.shape[0]))
        if y is not None:
            outs.append(y)
    torch.cuda.synchronize()
    return counts, torch.cat(outs)


def iw3_extras_phase(torch, dev, model_dir, k3, k7, smi):
    """The extras at full width: letterbox crop, DepthAA, the SOD
    convergence estimator and the EXTRAS_FORMATS outputs (and the debug
    depth), then the lagged case, through Iw3FrameProcessor on host uint8
    frames; exact launches, outputs finite in [0, 1] of the expected shape,
    K7 held at the normalised depth (>= 45 dB) and at the convergence it
    yields (EXTRAS_CONVERGENCE_TOL), K3 alone on the frame (>= 45 dB), the
    time (median of 3 after a warm batch), peak memory, the saliency mask's
    share and the convergences; VR180's bicubic grid_sample on the card
    against the CPU; then the CLI: --export and its re-import against a
    direct render, --anaglyph dubois --depth-aa, --vr180 --convergence-mode
    sod_v1."""
    from nunif_tpu_torch.iw3.composition import StereoFormat
    from nunif_tpu_torch.iw3.convergence_estimator import ConvergenceEstimator
    from nunif_tpu_torch.iw3.depth import create_depth_model
    from nunif_tpu_torch.iw3.depth_scaler import frame_stats, minmax_normalize
    from nunif_tpu_torch.iw3.equirectangular import equirectangular_projection
    from nunif_tpu_torch.iw3.pipeline import StereoConfig
    from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
    from nunif_tpu_torch.models import load_model
    from nunif_tpu_torch.modules.resize import resize
    from nunif_tpu_torch.utils.autocrop import AutoCropDetector
    t_phase = time.perf_counter()
    to_u8 = lambda t: (t.clamp(0, 1) * 255 + 0.5).to(torch.uint8)  # noqa: E731
    # VR180's sampler: F.grid_sample's bicubic on the card against the CPU,
    # the tan grid's edges far outside the image included
    eye = torch.rand((2, 90, 160, 3), generator=torch.Generator().manual_seed(9))
    vr_err = float((equirectangular_projection(eye.to(dev)).cpu()
                    - equirectangular_projection(eye)).abs().max())
    print(f"iw3 extras: VR180 projection on the card vs the CPU, max abs {vr_err:.3g}",
          flush=True)
    if vr_err > 1e-4:
        fail(f"iw3 extras: VR180 projection on the card differs from the CPU by {vr_err}")
    dm = create_depth_model("Any_V2_S", device=dev).load(
        checkpoint=os.path.join(model_dir, "depth_any_v2_s.nztm"))
    flow = load_model(os.path.join(model_dir, "row_flow_v3.nztm"), device=dev)[0]
    h, w = IW3_HW[0] - 2 * EXTRAS_BARS, IW3_HW[1]  # the picture, 800 x 1920
    vr = max(h, w) * 3 // 2  # a VR180 eye: 2880 x 2880
    content = iw3_frames(torch, dev, IW3_BATCH, h, w, seed=41)
    frames = letterbox(torch, content)
    det = AutoCropDetector(mode="black")
    det.update(frames.astype(np.float32) / 255)
    crop = det.get_crop()
    want_crop = (slice(EXTRAS_BARS, IW3_HW[0] - EXTRAS_BARS), slice(None))
    print(f"iw3 extras: AutoCropDetector crop {crop}", flush=True)
    if crop != want_crop:
        fail(f"iw3 extras: AutoCropDetector found {crop}, want {want_crop}")
    x = content.float() * (1.0 / 255.0)

    def norm_depth():
        with torch.no_grad():
            d = dm.infer(x, edge_dilation=2)
        st = frame_stats(d)
        return minmax_normalize(d, st[:, 0].reshape(-1, 1, 1, 1), st[:, 1].reshape(-1, 1, 1, 1))
    def timed(fn):
        """Host milliseconds of a synchronised call, median of 3 after a
        warm one."""
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(runs)
    plain_depth = norm_depth()
    calibration = torch.cat([resize(x, 192, 192, mode="bilinear", antialias=False),
                             resize(plain_depth, 192, 192, mode="bilinear",
                                    antialias=False)], -1)
    aa, sod = extras_models(torch, dev, model_dir, calibration)
    split = {"depth_ms": timed(norm_depth)}
    dm.set_depth_aa(aa)
    split["depth_with_depth_aa_ms"] = timed(norm_depth)
    sal = ConvergenceEstimator(IW3_CONVERGENCE, sod)
    split["estimator_ms"] = timed(lambda: sal(calibration[..., :3], calibration[..., 3:]))
    print(f"iw3 extras split (8 cropped frames, host ms, median of 3): {split}; {smi}",
          flush=True)
    k7.sdpa.launches = 0
    depth = norm_depth()
    tokens = (depth.shape[1] // 14) * (depth.shape[2] // 14) + 1
    aa_change = float((depth - plain_depth).abs().mean())
    with twins((k7, "sdpa")):
        depth_twin = norm_depth()
    depth_psnr = uint8_psnr(to_u8(depth), to_u8(depth_twin))
    print(f"iw3 extras: cropped frames {tuple(x.shape)}, K7 at ({IW3_BATCH}, 6, {tokens}, "
          f"64); normalised depth with DepthAA {tuple(depth.shape)}, std "
          f"{float(depth.std()):.4f}, DepthAA's mean change {aa_change:.4f}; vs K7's twin "
          f"PSNR {depth_psnr:.2f} dB", flush=True)
    if depth_psnr < FRAME_PSNR_MIN or float(depth.std()) <= 0.05 or aa_change < 1e-3:
        fail(f"iw3 extras: depth vs K7's twin {depth_psnr:.2f} dB, std "
             f"{float(depth.std())}, DepthAA change {aa_change}")
    del plain_depth, depth, depth_twin, calibration
    rows = {}
    for name, fmt in EXTRAS_FORMATS.items():
        debug = name == "debug_depth"
        cfg = StereoConfig(method="row_flow_v3", divergence=IW3_DIVERGENCE,
                           convergence=IW3_CONVERGENCE, format=StereoFormat(**fmt))
        est = RecordingEstimator(ConvergenceEstimator(IW3_CONVERGENCE, sod, enable_ema=True))
        proc = Iw3FrameProcessor(cfg, dm, flow, edge_dilation=2, crop=crop,
                                 debug_depth=debug, convergence_estimator=est)
        what = f"iw3 extras ({name})"
        k3.warp_x_bounded.launches = k7.sdpa.launches = 0
        out = proc(frames)
        torch.cuda.synchronize()
        launches = {"sdpa": k7.sdpa.launches, "warp_x_bounded": k3.warp_x_bounded.launches}
        want = {"sdpa": 12, "warp_x_bounded": 0 if debug else 1}
        shape = (IW3_BATCH,) + ((vr, 2 * vr) if name == "vr180" else (h, w)) + (3,)
        if launches != want:
            fail(f"{what}: launches {launches}, want {want}")
        if tuple(out.shape) != shape:
            fail(f"{what}: output shape {tuple(out.shape)}, want {shape}")
        if not (bool(out.isfinite().all()) and float(out.min()) >= 0.0
                and float(out.max()) <= 1.0):
            fail(f"{what}: output not finite in [0, 1]")
        conv = None if debug else est.values()
        share = None if debug else float(est.est.mask_share)
        q = to_u8(out)
        del out
        est.reset()
        with twins((k3, "warp_x_bounded")):
            psnr_k3 = uint8_psnr(q, to_u8(proc(frames)))
        est.reset()
        with twins((k7, "sdpa")):
            q_k7 = to_u8(proc(frames))
        conv_err = None if debug else float((est.values() - conv).abs().max())
        est.reset()
        with twins((k3, "warp_x_bounded"), (k7, "sdpa")):
            psnr_twins = uint8_psnr(q, to_u8(proc(frames)))
        psnr_k7 = uint8_psnr(q, q_k7)
        del q_k7
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        batch_ms = []
        for _ in range(3):
            est.reset()
            t0 = time.perf_counter()
            proc(frames)
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(batch_ms)
        device_ms = None
        if name == "half_sbs":
            print(f"{what} profile:", flush=True)
            device_ms = profile_frame(torch, proc, frames, top=10,
                                      share_of=("K7 sdpa", "flash"))
        rows[name] = dict(ms=med, device_ms=device_ms, runs_ms=batch_ms, fps=1000 * IW3_BATCH / med,
                          peak_gib=peak, launches=launches, shape=list(shape),
                          psnr_vs_k3_twin=psnr_k3, psnr_vs_k7_twin=psnr_k7,
                          psnr_vs_twins=psnr_twins, mask_share=share,
                          convergence=None if conv is None else conv.tolist(),
                          convergence_vs_k7_twin=conv_err)
        print(f"{what}, 8 x 1080p letterboxed -> {shape[1:3]}: median {med:.1f} ms "
              f"({1000 * IW3_BATCH / med:.1f} fps; runs {[round(v, 1) for v in batch_ms]}); "
              f"peak memory {peak:.2f} GiB; launches {launches}; vs K3's twin alone "
              f"{psnr_k3:.2f} dB, vs K7's twin {psnr_k7:.2f} dB, vs both {psnr_twins:.2f} dB"
              + ("" if debug else
                 f"; saliency mask {share:.4f} of the pixels; convergence "
                 f"{[round(v, 4) for v in conv.tolist()]}, vs K7's twin max abs "
                 f"{conv_err:.4g}") + f"; {smi}", flush=True)
        if psnr_k3 < FRAME_PSNR_MIN:
            fail(f"{what}: PSNR vs K3's twin {psnr_k3:.2f} dB < {FRAME_PSNR_MIN}")
        if debug and psnr_k7 < FRAME_PSNR_MIN:
            fail(f"{what}: PSNR vs K7's twin {psnr_k7:.2f} dB < {FRAME_PSNR_MIN}")
        if not debug and (conv_err > EXTRAS_CONVERGENCE_TOL or not 0.0 < share < 1.0):
            fail(f"{what}: convergence vs K7's twin {conv_err}, mask share {share}")
        del proc, est
        torch.cuda.empty_cache()
    rows["lagged"] = extras_lagged(torch, dev, dm, flow, sod, crop, k3, k7, smi)
    dm.set_depth_aa(None)
    dm.disable_ema()
    rows["cli"] = extras_cli(torch, dev, frames[0], model_dir, smi)
    rows["split"] = split
    print(f"iw3 extras: phase wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def extras_lagged(torch, dev, dm, flow, sod, crop, k3, k7, smi):
    """EXTRAS_LAGGED: 48 letterboxed frames in batches of 8 and a flush
    through the EMA lookahead with DepthAA and the estimator."""
    from nunif_tpu_torch.iw3.composition import StereoFormat
    from nunif_tpu_torch.iw3.convergence_estimator import ConvergenceEstimator
    from nunif_tpu_torch.iw3.pipeline import StereoConfig
    from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
    n = EXTRAS_LAGGED["frames"]
    frames = letterbox(torch, iw3_frames(torch, dev, n, IW3_HW[0] - 2 * EXTRAS_BARS,
                                         IW3_HW[1], seed=43))
    batches = [frames[i:i + IW3_BATCH] for i in range(0, n, IW3_BATCH)]
    cfg = StereoConfig(method="row_flow_v3", divergence=IW3_DIVERGENCE,
                       convergence=IW3_CONVERGENCE, format=StereoFormat(half_sbs=True))
    est = RecordingEstimator(ConvergenceEstimator(IW3_CONVERGENCE, sod, enable_ema=True))
    what = "iw3 extras (lagged: EMA lookahead 30 + the estimator)"
    to_u8 = lambda t: (t.clamp(0, 1) * 255 + 0.5).to(torch.uint8)  # noqa: E731

    def run():
        decay, buffer = EXTRAS_LAGGED["ema"]
        dm.reset()
        dm.enable_ema(decay, buffer_size=buffer)
        est.reset()
        proc = Iw3FrameProcessor(cfg, dm, flow, edge_dilation=2, crop=crop,
                                 convergence_estimator=est)
        return extras_run(torch, proc, batches)
    k3.warp_x_bounded.launches = k7.sdpa.launches = 0
    counts, out = run()
    launches = {"sdpa": k7.sdpa.launches, "warp_x_bounded": k3.warp_x_bounded.launches}
    conv = est.values()
    share = float(est.est.mask_share)
    if counts != EXTRAS_LAGGED["counts"] or launches != EXTRAS_LAGGED["launches"]:
        fail(f"{what}: frames a call {counts}, launches {launches}; want "
             f"{EXTRAS_LAGGED['counts']}, {EXTRAS_LAGGED['launches']}")
    if conv is None or conv.shape[0] != n:
        fail(f"{what}: the estimator saw {0 if conv is None else conv.shape[0]} frames of {n}")
    if not (bool(out.isfinite().all()) and float(out.min()) >= 0.0 and float(out.max()) <= 1.0):
        fail(f"{what}: output not finite in [0, 1]")
    q = to_u8(out)
    del out
    with twins((k3, "warp_x_bounded")):
        psnr_k3 = uint8_psnr(q, to_u8(run()[1]))
    with twins((k7, "sdpa")):
        q_k7 = to_u8(run()[1])
    conv_err = float((est.values() - conv).abs().max())
    psnr_k7 = uint8_psnr(q, q_k7)
    del q_k7
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        run_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(run_ms)
    dm.reset()
    dm.disable_ema()
    print(f"{what}, {n} x 1080p: frames a call {counts}; median {med:.1f} ms a run "
          f"({1000 * n / med:.1f} fps; runs {[round(v, 1) for v in run_ms]}); peak memory "
          f"{peak:.2f} GiB; launches {launches}; vs K3's twin alone {psnr_k3:.2f} dB, vs "
          f"K7's twin {psnr_k7:.2f} dB; saliency mask {share:.4f} (last call); convergence "
          f"min {float(conv.min()):.4f} max {float(conv.max()):.4f}, vs K7's twin max abs "
          f"{conv_err:.4g}; {smi}", flush=True)
    if psnr_k3 < FRAME_PSNR_MIN or conv_err > EXTRAS_CONVERGENCE_TOL:
        fail(f"{what}: PSNR vs K3's twin {psnr_k3:.2f} dB, convergence vs K7's twin {conv_err}")
    return dict(ms=med, runs_ms=run_ms, fps=1000 * n / med, peak_gib=peak,
                launches=launches, counts=counts, psnr_vs_k3_twin=psnr_k3,
                psnr_vs_k7_twin=psnr_k7, mask_share=share,
                convergence_range=[float(conv.min()), float(conv.max())],
                convergence_vs_k7_twin=conv_err)


def extras_cli(torch, dev, frame, model_dir, smi):
    """The iw3 CLI on a letterboxed 1080p PNG: --export, its re-import
    against a direct render (>= 45 dB), --anaglyph dubois --depth-aa and
    --vr180 --convergence-mode sod_v1, each exiting 0 at the expected
    size."""
    from PIL import Image
    from nunif_tpu_torch.iw3 import cli
    path = lambda f: os.path.join(model_dir, f)  # noqa: E731
    src = path("extras_in.png")
    Image.fromarray(frame).save(src)
    nets = ["--device", dev.type, "--depth-checkpoint", path("depth_any_v2_s.nztm"),
            "--stereo-checkpoint", path("row_flow_v3.nztm")]
    runs = {"direct": ["-i", src, "-o", path("extras_direct.png"), "--half-sbs"],
            "export": ["-i", src, "-o", path("extras_export"), "--export"],
            "import": ["-i", os.path.join(path("extras_export"), "iw3_export.yml"),
                       "-o", path("extras_import"), "--half-sbs"],
            "anaglyph_depth_aa": ["-i", src, "-o", path("extras_anaglyph.png"),
                                  "--anaglyph", "dubois", "--depth-aa",
                                  "--depth-aa-checkpoint", path("depth_aa.nztm")],
            "vr180_sod": ["-i", src, "-o", path("extras_vr180.png"), "--vr180",
                          "--convergence-mode", "sod_v1", "--sod-checkpoint",
                          path("sod_v1.nztm")]}
    fh, fw = frame.shape[:2]
    vr = max(fh, fw) * 3 // 2
    sizes = {"direct": (fw, fh), "import": (fw, fh), "anaglyph_depth_aa": (fw, fh),
             "vr180_sod": (2 * vr, vr)}
    outs = {"direct": path("extras_direct.png"),
            "import": os.path.join(path("extras_import"), "extras_in.png"),
            "anaglyph_depth_aa": path("extras_anaglyph.png"),
            "vr180_sod": path("extras_vr180.png")}
    seconds = {}
    for name, argv in runs.items():
        t0 = time.perf_counter()
        rc = cli.main(argv + nets)
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            fail(f"iw3 extras CLI {name}: rc {rc}")
        if name in outs:
            with Image.open(outs[name]) as im:
                if im.size != sizes[name]:
                    fail(f"iw3 extras CLI {name}: output size {im.size}, want {sizes[name]}")
        torch.cuda.empty_cache()
    with Image.open(outs["direct"]) as a, Image.open(outs["import"]) as b:
        psnr = uint8_psnr(torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b)))
    print(f"iw3 extras CLI: export -> import vs the direct render {psnr:.2f} dB; seconds "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }; {smi}", flush=True)
    if psnr < FRAME_PSNR_MIN:
        fail(f"iw3 extras CLI: export -> import vs the direct render {psnr:.2f} dB")
    return dict(export_import_psnr=psnr, seconds=seconds)


# ---------------------------------------------------------------------------
# "cliqa" (BASELINE config 3): the three predictors at their only width,
# norm="none" (the reference checkpoints' form), seeded and written to
# .nztm; the filter CLI over CLIQA_IMAGES structured 1080p JPEGs at the
# CLIQA_QUALITIES, on the card, against the same weights on the CPU.  fp32
# on both (TF32 off): the same products summed in another order.
CLIQA_KINDS = {"jpeg": "cliqa.jpeg_quality", "noise": "cliqa.grain_noise_level",
               "resize": "cliqa.scale_factor"}
# the head whose output the score reads, and the score's middle raw value
CLIQA_HEADS = {"jpeg": "quality_output", "noise": "noise_level_output",
               "resize": "scale_factor_output"}
CLIQA_TARGETS = {"jpeg": 50.0, "noise": 25.0, "resize": 1.5}
CLIQA_IMAGES = 16
CLIQA_QUALITIES = (25, 40, 55, 70, 85, 95)
CLIQA_OUT_TOL = (1e-4, 1e-4)  # (relative, absolute) on the raw model outputs
CLIQA_SCORE_ATOL = 1e-3  # quality / PSNR scores; the resize score's factor too
# the reference .pth rows (tests/torch_pth_states.py's ROWS) loaded on the
# card against the CPU (fp32; the outputs lie within [-10, 10]): row -> the
# input shapes of one forward, the second one the model's mask
PTH_ROWS = {
    "sbs.row_flow_v2": [(1, 256, 448, 3)],
    "sbs.row_flow_v3": [(1, 256, 448, 3)],
    "sbs.mlbw_l2": [(1, 256, 448, 3)],
    "sbs.mask_mlbw_l2": [(1, 256, 448, 3)],
    "inpaint.light_inpaint_v1": [(1, 256, 448, 3), (1, 256, 448, 1)],
    "inpaint.light_video_inpaint_v1_large": [(12, 128, 256, 3), (12, 128, 256, 1)],
    "iw3.depth_aa": [(1, 392, 700, 1)],
    "iw3.dsod_v1": [(1, 270, 480, 4)],
    "cliqa.jpeg_quality": [(8, 128, 128, 3)],
    "stlizer.light_outpaint_v1": [(1, 256, 448, 3), (1, 256, 448, 1)],
}
PTH_ATOL = 1e-4


def cliqa_images(root, n=CLIQA_IMAGES, hw=(1080, 1920)):
    """n structured 1080p JPEGs (gradients, discs, texture, noise of several
    levels) at the CLIQA_QUALITIES in turn, some with 4:2:0 chroma."""
    from PIL import Image
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(21)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        f = np.stack([np.sin(xx / (40 + 7 * i) + yy / 90), np.cos(yy / (55 + 3 * i)),
                      (xx + yy) / (h + w)], -1) * 0.35 + 0.5
        for _ in range(6):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(40, 260)
            f[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] *= rng.uniform(0.3, 0.9)
        f += rng.normal(0, 0.01 * (i % 5), f.shape).astype(np.float32)
        im = Image.fromarray((np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8))
        q = CLIQA_QUALITIES[i % len(CLIQA_QUALITIES)]
        im.save(os.path.join(root, f"im{i:02d}.jpg"), quality=q,
                subsampling=2 if i % 2 else 0)


def cliqa_models(torch, model_dir, xs):
    """Seeded norm="none" predictors (flax's init, biases N(0, 0.05)), each
    head's output bias moved so the scores of ``xs`` straddle the middle of
    their range; written to .nztm.  {kind: path}."""
    from nunif_tpu_torch.cliqa import utils as U
    from nunif_tpu_torch.models import create_model, init_flax_default, save_model
    paths = {}
    for kind, name in CLIQA_KINDS.items():
        model = create_model(name, norm="none")
        gen = torch.Generator().manual_seed(len(kind))
        init_flax_default(model, gen)
        with torch.no_grad():
            for pname, p in model.named_parameters():
                if pname.endswith("bias"):
                    p.normal_(0, 0.05, generator=gen)
        model.eval().requires_grad_(False)
        score_fn = U.tv_score if kind == "resize" else U.std_score
        with torch.no_grad():
            raw = []
            for x in xs:
                y = model(torch.from_numpy(U.extract_patches(x, 8, score_fn=score_fn)))
                y = y[0] if isinstance(y, tuple) else y
                raw.append(float(y.min() if kind == "resize" else y.mean()))
            getattr(model, CLIQA_HEADS[kind]).out.bias += \
                CLIQA_TARGETS[kind] - float(np.median(raw))
        paths[kind] = os.path.join(model_dir, f"cliqa_{kind}.nztm")
        save_model(model, paths[kind])
    return paths


def cliqa_scores(torch, model, kind, xs):
    """(scores, raw model outputs, chosen patch indexes) of each image."""
    from nunif_tpu_torch.cliqa import filter_cli
    from nunif_tpu_torch.cliqa import utils as U
    device = next(model.parameters()).device
    score_fn = U.tv_score if kind == "resize" else U.std_score
    scores, raws, idxs = [], [], []
    for x in xs:
        grid = U.patch_grid(x)
        idx = U.patch_indexes(grid, 8, score_fn)
        with torch.no_grad():
            y = model(torch.from_numpy(grid[idx]).to(device))
        raws.append([a.float().cpu() for a in (y if isinstance(y, tuple) else (y,))])
        idxs.append(idx)
        scores.append(filter_cli.score(kind, model, x, 8))
    return scores, raws, idxs


def cliqa_phase(torch, dev, smi):
    """BASELINE config 3 on the card: seeded full-width predictors from
    .nztm, the filter CLI over 16 1080p JPEGs per kind on the card, its
    kept set against the CPU's scores of the same weights (a threshold in
    the widest gap between them), the scores and raw outputs within fp32
    tolerance, the chosen patches equal; the reference .pth rows loaded on
    the card against the CPU."""
    from nunif_tpu_torch.cliqa import filter_cli
    from nunif_tpu_torch.models import load_model
    from nunif_tpu_torch.utils.pil_io import load_image
    t_phase = time.perf_counter()
    work = tempfile.TemporaryDirectory()
    src = os.path.join(work.name, "src")
    cliqa_images(src)
    files = filter_cli.listdir_images(src)
    xs = [load_image(f)[0][..., :3] for f in files]
    paths = cliqa_models(torch, work.name, xs)
    out = {}
    for kind, path in paths.items():
        cpu_model, _ = load_model(path, device="cpu")
        card_model, meta = load_model(path, device=dev)
        if meta["kwargs"] != {"norm": "none"}:
            fail(f"cliqa {kind}: checkpoint kwargs {meta['kwargs']}")
        want, want_raw, want_idx = cliqa_scores(torch, cpu_model, kind, xs)
        got, got_raw, got_idx = cliqa_scores(torch, card_model, kind, xs)
        if any(not np.array_equal(a, b) for a, b in zip(got_idx, want_idx)):
            fail(f"cliqa {kind}: chosen patches differ between the card and the CPU")
        raw_err = 0.0
        for g, w in zip(got_raw, want_raw):
            for a, b in zip(g, w):
                ok, err, _ = compare(a, b, CLIQA_OUT_TOL)
                raw_err = max(raw_err, err)
                if not ok:
                    fail(f"cliqa {kind}: raw outputs differ from the CPU by {err}")
        if kind == "resize":  # the truncated int may flip at a hundredth
            score_err = max(abs(a - b) for a, b in zip(got, want))
            factor_err = max(abs(float(g[0].min()) - float(w[0].min()))
                             for g, w in zip(got_raw, want_raw))
            if score_err > 1 or factor_err > CLIQA_SCORE_ATOL:
                fail(f"cliqa resize: scores {got} vs CPU {want}")
        else:
            score_err = max(abs(a - b) for a, b in zip(got, want))
            if score_err > CLIQA_SCORE_ATOL:
                fail(f"cliqa {kind}: scores differ from the CPU by {score_err}")
        order = sorted(want)
        gaps = np.diff(order)
        if gaps.max() <= 4 * CLIQA_SCORE_ATOL:
            fail(f"cliqa {kind}: no gap between the CPU scores {order}")
        g = int(np.argmax(gaps))
        threshold = (order[g] + order[g + 1]) / 2
        expected = sorted(os.path.basename(f) for f, s in zip(files, want)
                          if s >= threshold)
        dst = os.path.join(work.name, f"kept_{kind}")
        t0 = time.perf_counter()
        rc = filter_cli.main([kind, "-i", src, "-o", dst, "--filter",
                              repr(threshold), "--checkpoint", path,
                              "--device", dev.type])
        cli_s = time.perf_counter() - t0
        kept = sorted(os.listdir(dst))
        if rc != 0 or kept != expected or not 0 < len(kept) < len(files):
            fail(f"cliqa {kind}: the CLI kept {kept}, the CPU scores keep {expected}")
        out[kind] = {"kept": len(kept), "threshold": threshold,
                     "score_max_abs_err": score_err, "raw_max_abs_err": raw_err,
                     "cli_images_per_s": len(files) / cli_s,
                     "score_range": [order[0], order[-1]]}
        print(f"cliqa {kind}: kept {len(kept)}/{len(files)} at {threshold:.4f}; "
              f"score err vs CPU {score_err:.3g}, raw {raw_err:.3g}; CLI "
              f"{len(files) / cli_s:.2f} images/s (1080p JPEG decode included)",
              flush=True)
    out["pth_rows"] = pth_rows_check(torch, dev, work.name)
    work.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def pth_rows_check(torch, dev, work_dir):
    """Each PTH_ROWS row: a reference .pth loaded through ``load_model`` on
    the card and on the CPU, one fp32 forward on each, held within
    PTH_ATOL.  {row: max abs err}."""
    from nunif_tpu_torch.models import load_model
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from torch_pth_states import ROWS, reference_state, save_pth
    errs = {}
    for i, (name, shapes) in enumerate(PTH_ROWS.items()):
        kwargs, kind, ref_kw = ROWS[name]
        sd, _net = reference_state(kind, i, **ref_kw)
        path = save_pth(os.path.join(work_dir, f"row{i}.pth"), name, kwargs, sd)
        card, _ = load_model(path, device=dev)  # converts, writes the cache
        cpu, _ = load_model(path, device="cpu")  # reads the cache
        gen = torch.Generator().manual_seed(i)
        args = [torch.rand(s, generator=gen) for s in shapes]
        if len(args) == 2:
            args[1] = (args[1] > 0.7).float()
        kwargs = {"mask": args.pop()} if len(args) == 2 else {}
        with torch.no_grad():
            want = cpu(*args, **kwargs)
            got = card(*[a.to(dev) for a in args],
                       **{k: v.to(dev) for k, v in kwargs.items()})
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        err = 0.0
        for a, b in zip(got, want):
            ok, e, _ = compare(a.cpu(), b, (0.0, PTH_ATOL))
            err = max(err, e)
            if not ok or a.shape != b.shape:
                fail(f"pth row {name}: the card's forward differs from the "
                     f"CPU's by {e} (shape {tuple(a.shape)})")
        errs[name] = err
        del card, cpu
    print(f"pth rows on the card vs the CPU (fp32 max abs err): {errs}", flush=True)
    return errs


# ---------------------------------------------------------------------------
# "iw3 desktop": the desktop stream at batch 1.  1920x1080 raw frames over
# the IW3CAP01 TCP socket into run_pipeline with Any_V2_S and row_flow_v3
# (the iw3 batch's seeded .nztm files), DESKTOP_FRAMES frames, an HTTP
# client reading /stream.  Each frame runs K7 12 times (the ViT-S trunk)
# and K3 once (both eyes as one warp).
DESKTOP_FRAMES = 60
DESKTOP_WARM = 10  # frames before the timed window
DESKTOP_GRAB_FPS = 60.0  # the grabber pushes as a 60 Hz screen would
DESKTOP_PER_FRAME = {"sdpa": 12, "warp_x_bounded": 1}
DESKTOP_HW = (1080, 1920)
# one frame's SBS before JPEG against the twin path (K7 and K3 both
# replaced) and against K3's twin alone, uint8 PSNR: read at 50.64 dB and
# bit-equal on an H100 80GB HBM3 at 700 W (the iw3 batch of 8 reads 49.77
# against its twin path: K7's rounding moves the normalised depth)
DESKTOP_PSNR_MIN = 50.0


def read_mjpeg(url, stop, parts, errors):
    """Read /stream's parts into ``parts`` until ``stop`` is set."""
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            boundary = r.headers["Content-Type"].split("boundary=")[1].encode()
            while not stop.is_set():
                line = r.readline()
                if not line:
                    return
                if line.strip() != b"--" + boundary:
                    raise ValueError(f"bad part boundary {line[:40]!r}")
                headers = {}
                for h in iter(r.readline, b"\r\n"):
                    k, v = h.decode().split(":", 1)
                    headers[k.strip().lower()] = v.strip()
                if headers.get("content-type") != "image/jpeg":
                    raise ValueError(f"part type {headers}")
                parts.append(r.read(int(headers["content-length"])))
                r.readline()
    except Exception as e:  # noqa: BLE001  (reported by the phase)
        if not stop.is_set():
            errors.append(repr(e))


def desktop_phase(torch, dev, model_dir, k3, k7, smi):
    """The desktop stream on the card: exact K7 / K3 launches a frame, every
    /stream part a half-SBS JPEG of the frame's size, one frame's SBS
    against the twin path, fps and the stage split (medians over the frames
    after DESKTOP_WARM)."""
    import threading
    import types as types_mod
    from http.server import ThreadingHTTPServer
    from PIL import Image
    from nunif_tpu_torch.iw3 import desktop
    from nunif_tpu_torch.iw3.capture_source import FileGrabber, SocketFrameSource
    t_phase = time.perf_counter()
    path = lambda f: os.path.join(model_dir, f)  # noqa: E731
    args = types_mod.SimpleNamespace(
        depth_model="Any_V2_S", depth_checkpoint=path("depth_any_v2_s.nztm"),
        stereo_checkpoint=path("row_flow_v3.nztm"), method="row_flow_v3",
        divergence=2.0, convergence=0.5, resolution=None, full_sbs=False,
        stream_fps=1000.0, quality=90, device="cuda", max_frames=DESKTOP_FRAMES)
    renderer = desktop.build_renderer(args, dev)
    frames = iw3_frames(torch, dev, 8, *DESKTOP_HW, seed=31).cpu().numpy()
    source = SocketFrameSource(("127.0.0.1", 0), timeout=60.0)
    feeding = threading.Event()
    feeding.set()

    def feed():
        i, t_next = 0, time.perf_counter()
        while feeding.is_set():
            yield frames[i % len(frames)]
            i += 1
            t_next += 1.0 / DESKTOP_GRAB_FPS
            time.sleep(max(0.0, t_next - time.perf_counter()))

    feeder = threading.Thread(target=lambda: FileGrabber(source.bound_address).push(feed()),
                              daemon=True)
    feeder.start()
    state = desktop.StreamingState()
    server = ThreadingHTTPServer(("127.0.0.1", 0), desktop.make_handler(state))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    parts, errors, reading = [], [], threading.Event()
    reader = threading.Thread(target=read_mjpeg, args=(
        f"http://127.0.0.1:{server.server_address[1]}/stream", reading, parts,
        errors), daemon=True)
    reader.start()
    k3.warp_x_bounded.launches = 0
    k7.sdpa.launches = 0
    stop = threading.Event()
    worker = threading.Thread(target=desktop.run_pipeline,
                              args=(state, source, args, stop, renderer), daemon=True)
    worker.start()
    t_warm = None
    while worker.is_alive():
        if t_warm is None and state._seq >= DESKTOP_WARM:
            t_warm = time.perf_counter()
        time.sleep(0.001)
    t_end = time.perf_counter()
    torch.cuda.synchronize()
    launches = {"sdpa": k7.sdpa.launches, "warp_x_bounded": k3.warp_x_bounded.launches}
    time.sleep(0.2)
    reading.set()
    server.shutdown()
    server.server_close()
    feeding.clear()
    source.close()
    feeder.join(10)
    reader.join(10)
    n = state._seq
    print(f"iw3 desktop: {n} frames, launches {launches}, {len(parts)} /stream "
          f"parts", flush=True)
    if n != DESKTOP_FRAMES or launches != {k: v * n for k, v in DESKTOP_PER_FRAME.items()}:
        fail(f"iw3 desktop: {n} frames launched {launches}, expected "
             f"{DESKTOP_PER_FRAME} a frame")
    if errors or len(parts) < 2:
        fail(f"iw3 desktop: /stream read {len(parts)} parts, errors {errors}")
    for p in parts:
        with Image.open(io.BytesIO(p)) as im:
            if im.format != "JPEG" or im.size != DESKTOP_HW[::-1]:
                fail(f"iw3 desktop: a /stream part is {im.format} {im.size}")
    times = list(state.frame_ms)[DESKTOP_WARM:]
    split = {k: statistics.median(t[k] for t in times) for k in desktop.STAGES}
    fps = (n - DESKTOP_WARM) / (t_end - t_warm)
    # the same stages with no grabber, socket or HTTP thread running: how
    # much of a streamed frame is the host's contention
    idle = []
    for i in range(5):
        arr, t = renderer(frames[i])
        t0 = time.perf_counter()
        desktop.encode_jpeg(arr, args.quality)
        t["jpeg_encode"] = (time.perf_counter() - t0) * 1e3
        idle.append(t)
    idle = {k: statistics.median(t[k] for t in idle) for k in idle[0]}
    # one frame's SBS before JPEG: the kernel path, the full twin path and
    # K3 alone on the kernel path's depth, each from a reset depth EMA
    frame = frames[3]

    def sbs():
        renderer.depth_model.reset_ema(decay=0.75, buffer_size=1)
        out, _t = renderer.sbs(frame)
        return out

    got = sbs()
    with twins((k3, "warp_x_bounded"), (k7, "sdpa")):
        twin = sbs()
    with twins((k3, "warp_x_bounded")):
        k3_twin = sbs()
    psnr, k3_psnr = uint8_psnr(got, twin), uint8_psnr(got, k3_twin)

    # K7 held at the depth: the frame's normalised depth against K7's twin
    def norm_depth():
        dm = renderer.depth_model
        dm.reset_ema(decay=0.75, buffer_size=1)
        x = torch.from_numpy(frame).to(dev)[None].float() / 255.0
        with torch.no_grad():
            return torch.stack(dm.minmax_normalize(dm.infer(x, edge_dilation=2)))

    to_u8 = lambda t: (t.clamp(0, 1) * 255 + 0.5).to(torch.uint8)  # noqa: E731
    depth = norm_depth()
    with twins((k7, "sdpa")):
        depth_twin = norm_depth()
    depth_psnr = uint8_psnr(to_u8(depth), to_u8(depth_twin))
    # the warp acts: the two eyes of the half-SBS frame differ
    half = DESKTOP_HW[1] // 2
    moved = float((got[:, :half].float() - got[:, half:].float()).abs().gt(8).float().mean())
    out = {"frames": n, "fps": fps, "per_frame_ms": split, "alone_ms": idle,
           "launches_per_frame": {k: v / n for k, v in launches.items()},
           "stream_parts": len(parts), "vs_twins_psnr": psnr,
           "vs_k3_twin_psnr": k3_psnr, "depth_vs_k7_twin_psnr": depth_psnr,
           "depth_std": float(depth.std()), "eyes_px_differ": moved,
           "phase_s": time.perf_counter() - t_phase}
    print(f"iw3 desktop 1080p half-SBS at batch 1: {fps:.2f} fps; per-frame ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
          + "; a frame alone (no grabber, socket or HTTP thread) "
          + ", ".join(f"{k} {v:.2f}" for k, v in idle.items())
          + f"; vs twins {psnr:.2f} dB, K3 alone {k3_psnr:.2f} dB; normalised "
          f"depth vs K7's twin {depth_psnr:.2f} dB (std {float(depth.std()):.4f}); "
          f"{smi}", flush=True)
    if min(psnr, k3_psnr) < DESKTOP_PSNR_MIN:
        fail(f"iw3 desktop: SBS frame vs twins {psnr:.2f} dB, K3's twin alone "
             f"{k3_psnr:.2f} dB (min {DESKTOP_PSNR_MIN})")
    if depth_psnr < FRAME_PSNR_MIN or float(depth.std()) <= 0.05:
        fail(f"iw3 desktop: normalised depth vs K7's twin {depth_psnr:.2f} dB "
             f"(min {FRAME_PSNR_MIN}), std {float(depth.std())}")
    if moved < 0.05:
        fail(f"iw3 desktop: the eyes differ at {moved} of the pixels")
    return out


# waifu2x turbo: the bundled zoo's slots (all turbo_2x, dim 128, 8 blocks)
TURBO_SLOTS = (("scale", None), ("noise_scale", 0), ("noise_scale", 1),
               ("noise_scale", 3))
TURBO_CATROM_ATOL = 1e-5  # untrained model vs float64 catrom (TF32: ~3e-3)
EVAL_NPZ = os.path.join("tests", "torch_data", "w2x_eval_256.npz")
# the JAX package's scores of the shipped checkpoints on the eval set, from
# its benchmark CLI on the CPU (`python -m nunif_tpu.waifu2x.benchmark -i
# <the PNGs of tools/make_eval_set.py> --model-file
# models/waifu2x/turbo/<stem>.nztm --baseline [--noise-level n]`):
# (model PSNR, Y-PSNR, catrom PSNR, Y-PSNR)
JAX_EVAL = {-1: (35.2699, 38.7977, 35.6545, 38.9663),
            1: (30.8935, 35.6531, 30.5930, 35.5705),
            3: (30.1721, 35.4262, 28.7141, 33.7722)}
EVAL_DB_TOL = 0.05  # the port on the card vs the JAX package on the CPU
# the model's lead over catrom on the eval set's textured images (all but
# the two gradients, where catrom is near exact and the model trails it)
TURBO_GAIN_MIN = (0.3, 0.5)
TURBO_RANGES = ("render.pad", "render.tiles", "render.model", "turbo.base",
                "render.blend", "render.quantize")


def turbo_ops(h, w, tiles=1, dim=128, blocks=8, c=3, scale=2):
    """({"bfloat16": flops, "float32": flops}) of turbo on ``tiles`` inputs
    of h x w (a count from shapes): stem, 2 * blocks body convs and the
    tail in bf16, the grouped catrom base in fp32."""
    cells = tiles * (h // 2) * (w // 2)
    ph2c = (2 * scale) ** 2 * c
    return {"bfloat16": 2 * cells * (36 * c * dim + 2 * blocks * 9 * dim * dim
                                     + 9 * dim * ph2c),
            "float32": 2 * cells * 36 * ph2c}


def decode_png16(path):
    """Samples (H, W, C) uint16 of a 16-bit PNG written with filter 0 on
    every row (the port's writer), by zlib and struct alone."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path}: not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype = head[:4]
    channels = {0: 1, 4: 2, 2: 3, 6: 4}[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, -1)
    if depth != 16 or (rows[:, 0] != 0).any():
        fail(f"{path}: depth {depth}, filters {set(rows[:, 0].tolist())}")
    return rows[:, 1:].copy().view(">u2").reshape(h, w, channels).astype(np.uint16)


def turbo_split(torch, program, frame):
    """torch.profiler over one frame (a complete session, ``profiled``):
    device ms of the frame (all kernels), of each renderer / model range,
    and of the ops that launch kernels inside the model (cuDNN convs,
    elementwise, copies), by self device time.  A range that reads 0 is
    "not measured"; so is the whole split where no session was complete."""
    session = profiled(torch, program, frame)
    if session is None:
        return "not measured (every profiler session dropped records)"
    events = session.key_averages()

    def is_cuda(e):
        return str(e.device_type).endswith("CUDA")
    kernels = [e for e in events if is_cuda(e) and e.key not in TURBO_RANGES]
    total = sum(dev_us(e) for e in kernels) / 1e3
    ranges = {}
    for e in events:
        if not is_cuda(e) and e.key in TURBO_RANGES:
            ms = (getattr(e, "device_time_total", None)
                  or getattr(e, "cuda_time_total", 0)) / 1e3
            ranges[e.key] = ms if ms > 0 else "not measured"
    ops = {}
    for e in events:
        if not is_cuda(e) and e.key not in TURBO_RANGES and dev_us(e) > 0:
            ops[e.key] = ops.get(e.key, 0.0) + dev_us(e) / 1e3
    top = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:10])
    kern = sorted(((dev_us(e) / 1e3, e.count, e.key) for e in kernels),
                  reverse=True)[:8]
    return {"device_ms": total, "ranges_ms": ranges, "ops_ms": top,
            "kernels": [(round(ms, 4), n, k[:90]) for ms, n, k in kern],
            "session": session.counts}


def turbo_phase(torch, dev, smi, work_dir, hw=(1080, 1920)):
    """The bundled turbo_2x zoo through the port: load, the untrained model
    against catrom, the hw (1080p) -> 2x frame (timed, profiled), the
    eval-set scores, and convert / the CLI end to end."""
    h, w = hw
    one_tile = (h + 16, w + 16)  # the frame and its offset, even
    from nunif_tpu_torch.utils import pil_io
    from nunif_tpu_torch.utils.rgb_noise import apply_rgb_noise, rgb_noise_like
    from nunif_tpu_torch.utils.tiling import make_tile_config
    from nunif_tpu_torch.modules.resize import resize_matrix
    from nunif_tpu_torch.waifu2x import benchmark as bench
    from nunif_tpu_torch.waifu2x.models import turbo
    from nunif_tpu_torch.waifu2x.runtime import Waifu2x, default_model_dir
    out = {}
    zoo = default_model_dir()
    if zoo is None:
        fail("the bundled models/waifu2x/turbo is missing")
    w2x = Waifu2x(zoo, device=dev)
    w2x.load_model_all()
    for key in TURBO_SLOTS:
        if key not in w2x._slots:
            fail(f"turbo slot {key} did not load from {zoo}")
        m = w2x._slots[key][0]
        if (m.model_name, m.dim, m.blocks, next(m.parameters()).device.type) \
                != ("waifu2x.turbo_2x", 128, 8, dev.type):
            fail(f"turbo slot {key}: {m.model_name} dim {m.dim} on "
                 f"{next(m.parameters()).device}")
    print(f"turbo: loaded {sorted(w2x._slots)} from {zoo}", flush=True)

    # the untrained model (zero tail) is its fp32 catrom base
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.rand((2, 256, 256, 3), generator=gen, device=dev)
    errs = {}
    for cls in (turbo.Turbo2x, turbo.Turbo4x):
        m = turbo.init_untrained(cls(), torch.Generator().manual_seed(0))
        m = m.to(dev).eval().requires_grad_(False)
        s, o = m.i2i_scale, m.i2i_offset
        mh = torch.from_numpy(resize_matrix(256, 256 * s, "catrom", False)).to(
            dev, torch.float64)
        for dtype in (torch.float32, torch.bfloat16):
            xin = x.to(dtype)
            with torch.inference_mode():
                y = m(xin, train=True)
            ref = torch.einsum("oh,bhwc->bowc", mh, xin.double())
            ref = torch.einsum("pw,bowc->bopc", mh, ref)[:, o:256 * s - o,
                                                          o:256 * s - o]
            err = float((y.double() - ref).abs().max())
            errs[f"{m.model_name} {str(dtype)[6:]}"] = err
            if not err <= TURBO_CATROM_ATOL:
                fail(f"untrained {m.model_name} ({dtype} in) vs catrom: max "
                     f"abs err {err} > {TURBO_CATROM_ATOL}")
        # a control, printed: the same with TF32 allowed (whether cuDNN's
        # grouped fp32 conv takes TF32 at all decides if the check sees it)
        torch.backends.cudnn.allow_tf32 = True
        try:
            with torch.inference_mode():
                y = m(x, train=True)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        ref = torch.einsum("oh,bhwc->bowc", mh, x.double())
        ref = torch.einsum("pw,bowc->bopc", mh, ref)[:, o:256 * s - o,
                                                      o:256 * s - o]
        errs[f"{m.model_name} float32, TF32 allowed"] = float(
            (y.double() - ref).abs().max())
        del m
    out["untrained_vs_catrom"] = errs
    print(f"turbo untrained vs float64 catrom (max abs err, limit "
          f"{TURBO_CATROM_ATOL}): {errs}; cudnn fp32 precision "
          f"{getattr(getattr(torch.backends.cudnn, 'conv', None), 'fp32_precision', 'n/a')}, "
          f"allow_tf32 {torch.backends.cudnn.allow_tf32}", flush=True)

    # one 1080p frame to 4K through the shipped scale2x: default tiles and
    # one tile, median of 3 after a warm frame
    model, renderer = w2x.load_model("scale")
    frame = iw3_frames(torch, dev, 1, h, w, seed=9)[0]
    frames = {}
    for label, tile, batch in (
            ("tiles 256 batch 8", None, None),
            (f"one tile {one_tile[0]}x{one_tile[1]}", one_tile, 1)):
        program = renderer.frame_program(h, w, tile_size=tile,
                                         batch_size=batch)
        y = program(frame)
        torch.cuda.synchronize()
        if tuple(y.shape) != (2 * h, 2 * w, 3) or y.dtype != torch.uint8:
            fail(f"turbo frame {label}: {tuple(y.shape)} {y.dtype}")
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            program(frame)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        frames[label] = dict(ms=statistics.median(runs), runs=runs, y=y,
                             program=program)
    # turbo runs no hand-written kernel: every counter stays at 0
    from nunif_tpu_torch.modules import grid_sample
    from nunif_tpu_torch.ops import conv3x3, sdpa, swin_attention
    counted = [(conv3x3, "stem_conv3x3"), (grid_sample, "warp_x_bounded"),
               (sdpa, "sdpa")] + [(swin_attention, n) for n in (
                   "fused_swin_block_image", "fused_swin_block",
                   "fused_window_attention", "fused_window_attention_image")]
    for mod, name in counted:
        getattr(mod, name).launches = 0
    for f in frames.values():
        f["program"](frame)
    torch.cuda.synchronize()
    launches = {name: getattr(mod, name).launches for mod, name in counted}
    print(f"turbo frame launches of the port's kernels: {launches}",
          flush=True)
    if any(launches.values()):
        fail(f"the turbo frame launched a hand-written kernel: {launches}")
    out["launches"] = launches
    a, b = (frames[k]["y"] for k in frames)
    tiled_vs_one = uint8_psnr(a, b)
    bicubic = torch.nn.functional.interpolate(  # a sanity reference only
        frame.permute(2, 0, 1)[None].float(), scale_factor=2, mode="bicubic",
        align_corners=False).clamp(0, 255).round()[0].permute(1, 2, 0)
    vs_bicubic = uint8_psnr(a, bicubic)
    for label, f in frames.items():
        print(f"turbo_2x frame {h}x{w} -> 2x {label}: median {f['ms']:.2f} ms "
              f"(runs {[round(v, 2) for v in f['runs']]}) [{smi}]", flush=True)
    print(f"turbo frame: default tiles vs one tile PSNR {tiled_vs_one:.2f} dB; "
          f"vs bicubic 2x PSNR {vs_bicubic:.2f} dB", flush=True)
    if not 25.0 < vs_bicubic < 60.0:
        fail(f"turbo frame vs a bicubic upscale {vs_bicubic:.2f} dB: not an "
             f"upscale of the input")
    split = {label: turbo_split(torch, f["program"], frame)
             for label, f in frames.items()}
    for label, sp in split.items():
        print(f"turbo frame profile {label}: " + json.dumps(sp), flush=True)
    n_tiles = make_tile_config(h, w, 2, model.i2i_offset, 256,
                               model.i2i_blend_size).n_tiles
    ops = {f"frame {h // 2}x{w // 2} cells": turbo_ops(h, w),
           f"tiles 256 ({n_tiles})": turbo_ops(256, 256, tiles=n_tiles),
           f"one tile {one_tile[0]}x{one_tile[1]}": turbo_ops(*one_tile)}
    nbytes = h * w * 3 + 4 * h * w * 3 + 4 * sum(
        p.numel() for p in model.parameters())
    bounds = {k: bound_ops(nbytes, v) for k, v in ops.items()}
    print("turbo frame operations (a count from shapes): " + json.dumps(
        {k: {"ops": v, "bound_ms": bounds[k][0], "bound_by": bounds[k][1]}
         for k, v in ops.items()}), flush=True)
    out["frames"] = {k: {"ms": f["ms"], "runs": f["runs"]}
                     for k, f in frames.items()}
    out["split"], out["bounds"] = split, bounds
    del frames, a, b, bicubic

    # the eval set by the benchmark protocol (arrays, no PIL); with JPEG
    # noise (noise1, noise3) where PIL is present
    data = np.load(EVAL_NPZ)
    images = [(n, data[n].astype(np.float32) / 255.0) for n in data.files]
    try:
        import PIL  # noqa: F401
        levels = (-1, 1, 3)
    except ImportError:
        levels = (-1,)
        print("turbo eval: PIL is absent, the noise1 / noise3 JPEG-noise "
              "scores did not run", flush=True)
    out["eval"] = {}
    for level in levels:
        slot = ("scale", None) if level < 0 else ("noise_scale", level)
        rows, secs = bench.score_images(
            images, w2x.load_model(*slot)[1], scale=2, noise_level=level,
            baseline=True)
        mean = bench.mean_scores(rows)
        textured = bench.mean_scores(
            [r for r in rows if not r["file"].startswith("gradient")])
        gain = (textured["psnr"] - textured["catrom_psnr"],
                textured["y_psnr"] - textured["catrom_y_psnr"])
        jax_ref = JAX_EVAL[level]
        what = "scale2x" if level < 0 else f"noise{level}_scale2x"
        out["eval"][what] = dict(mean=mean, textured=textured, seconds=secs,
                                 jax=jax_ref)
        print(f"turbo eval {what} (10 images, 256 px): " + json.dumps(
            {k: round(v, 4) for k, v in mean.items()}) + f"; textured 8: "
            f"gain over catrom {gain[0]:+.3f} / {gain[1]:+.3f} dB; the JAX "
            f"package (CPU): {jax_ref}; per image: " + json.dumps(
                [(r["file"], r["psnr"], r["catrom_psnr"]) for r in rows]),
            flush=True)
        if level < 0:
            if (abs(mean["psnr"] - jax_ref[0]) > EVAL_DB_TOL
                    or abs(mean["y_psnr"] - jax_ref[1]) > EVAL_DB_TOL):
                fail(f"turbo eval scale2x {mean['psnr']:.4f} / "
                     f"{mean['y_psnr']:.4f} dB, the JAX package's {jax_ref[:2]}"
                     f" (limit {EVAL_DB_TOL} dB)")
            if gain[0] < TURBO_GAIN_MIN[0] or gain[1] < TURBO_GAIN_MIN[1]:
                fail(f"turbo eval scale2x: textured gain over catrom {gain} "
                     f"< {TURBO_GAIN_MIN}")
        elif not (mean["psnr"] > mean["catrom_psnr"]
                  and mean["y_psnr"] > mean["catrom_y_psnr"]):
            fail(f"turbo eval {what}: the model does not beat catrom {mean}")

    # convert end to end: 1080p RGBA, 8-way TTA, grain; 8 bits and a 16-bit
    # PNG read back
    img = iw3_frames(torch, dev, 1, h, w, seed=10)[0].float() / 255.0
    yy = torch.linspace(-1, 1, h, device=dev)[:, None]
    xx = torch.linspace(-1.8, 1.8, w, device=dev)[None, :]
    alpha = (1.3 - (yy ** 2 + xx ** 2).sqrt()).clamp(0, 1)
    alpha = torch.where(alpha < 0.2, 0.0, alpha)[..., None]
    t0 = time.perf_counter()
    rgb, out_a = w2x.convert(img, alpha, method="noise_scale", noise_level=0,
                             tta=True)
    rgb = apply_rgb_noise(rgb, rgb_noise_like(
        rgb, generator=torch.Generator(device=dev).manual_seed(0)),
        strength=0.1)
    rgba = torch.cat([rgb, out_a], -1)
    torch.cuda.synchronize()
    convert_ms = (time.perf_counter() - t0) * 1e3
    if tuple(rgba.shape) != (2 * h, 2 * w, 4) or not bool(
            rgba.isfinite().all()) or float(rgba.min()) < 0 \
            or float(rgba.max()) > 1:
        fail(f"convert RGBA TTA grain: {tuple(rgba.shape)}, range "
             f"[{float(rgba.min())}, {float(rgba.max())}]")
    r = h // 27  # 40 output pixels at 1080p
    centre = out_a[h - r:h + r, w - r:w + r]
    if float(out_a[:r, :r].max()) > 0.05 or float(centre.min()) < 0.95:
        fail("convert: the upscaled alpha lost its transparent corner or "
             "its opaque centre")
    rgba = rgba.cpu().numpy()
    p16 = os.path.join(work_dir, "turbo16.png")
    pil_io.save_image(rgba, p16, bit_depth=16)
    back16 = decode_png16(p16)
    if not np.array_equal(back16, pil_io.quantize(rgba, 16)):
        fail("16-bit PNG: decoded samples differ from round(x * 65535)")
    ran = "convert RGBA tta grain -> 16-bit PNG (zlib read back)"
    q8 = pil_io.quantize(rgba, 8)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        p8 = os.path.join(work_dir, "turbo8.png")
        pil_io.save_image(rgba, p8)
        with Image.open(p8) as im:
            if not np.array_equal(np.asarray(im), q8):
                fail("8-bit PNG read back differs")
        src, dst = os.path.join(work_dir, "in.png"), os.path.join(work_dir, "o.png")
        Image.fromarray(q8[:h // 2, :w // 2, :3]).save(src)
        from nunif_tpu_torch.waifu2x import cli
        cli.main(["-i", src, "-o", dst])  # the defaults: noise0_scale2x, cuda
        with Image.open(dst) as im:
            if im.size != (w, h):
                fail(f"turbo CLI with defaults: output size {im.size}")
        ran += " + 8-bit PNG (PIL read back) + cli.main -i -o (defaults)"
    else:
        ran += "; 8-bit samples only (PIL is absent: no 8-bit file, no CLI)"
    out["convert_ms"] = convert_ms
    print(f"turbo convert {h}x{w} RGBA, tta, grain: {convert_ms:.1f} ms; ran: "
          f"{ran}", flush=True)
    del w2x, model, renderer
    torch.cuda.empty_cache()
    return out


def k2_row(torch, k2, rng, t, dev, shape, cin, cout):
    """K2 at one stem shape, bf16 and fp32, against its twin; bf16 timed
    beside cuDNN's conv2d (with bias, channels_last, on the cropped input;
    the leaky-ReLU is not part of that call).  The kernel is timed with its
    weights packed beforehand, as the stem module passes them (packed once
    per weight load).  Returns the bf16 row."""
    import torch.nn.functional as F
    b, h, w = shape
    ho, wo = h - 14, w - 14
    x = rng.normal(0, 0.5, (b, h, w, cin))
    kern = t(rng.normal(0, 1 / np.sqrt(9 * cin), (3, 3, cin, cout)))
    bias = t(rng.normal(0, 0.1, (cout,)))
    kw = dict(crop=6, lrelu_slope=0.1)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        xd = t(x, dtype)
        got = k2.stem_conv3x3(xd, kern, bias, **kw)
        torch.cuda.synchronize()
        want = k2.stem_conv3x3_plain(xd, kern, bias, **kw)
        if got.shape != (b, ho, wo, cout):
            fail(f"K2 output shape {tuple(got.shape)}")
        name = str(dtype).split(".")[1]
        err, _ = check_close(got, want, K2_TOL[name], f"K2 {cin}->{cout} {name}")
        lib = None
        if dtype == torch.bfloat16:
            xl = xd[:, 6:h - 6, 6:w - 6].permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            wl = kern.to(dtype).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            bl = bias.to(dtype)
            lib = lambda: F.conv2d(xl, wl, bl)  # noqa: E731
        packed = (k2.pack_stem_weights(kern, dtype), bias.float().contiguous())
        tm = compare_timed(
            lambda: k2.stem_conv3x3(xd, kern, bias, packed=packed, **kw),
            lambda: k2.stem_conv3x3_plain(xd, kern, bias, **kw),
            torch, library=lib)
        ebytes = 2 if dtype == torch.bfloat16 else 4
        nbytes = (b * (ho + 2) * (wo + 2) * cin + b * ho * wo * cout) * ebytes \
            + kern.numel() * 4 + bias.numel() * 4
        bound_ms, bound_by = bound(nbytes, 2 * b * ho * wo * cout * 9 * cin, name)
        row = dict(shape=(b, h, w, cin, cout), dtype=name, max_abs_err=err,
                   ms=tm["kernel"], plain_ms=tm["plain"],
                   library_ms=tm["library"], bound_ms=bound_ms,
                   bound_by=bound_by)
        print(f"K2 stem_conv3x3 {name}: {row}", flush=True)
        if lib is not None:
            print(f"K2 {cin}->{cout} {name}: {100 * bound_ms / tm['kernel']:.1f}% "
                  f"of its bound ({bound_by}), cuDNN / kernel "
                  f"{tm['library'] / tm['kernel']:.3f}", flush=True)
        rows[name] = row
        del got, want, xd
    torch.cuda.empty_cache()
    return rows["bfloat16"]


def k4_phase(torch, k4, rng, t, dev):
    """K4 at every 4xl 540p shape, bf16 and fp32, against its twin, with
    two controls (zero bias; for shift 3, the kernel run unshifted) that
    must fail; bf16 timed beside SDPA with a float mask built once, and back
    to back against its bound, with its launch plan."""
    import torch.nn.functional as F
    from nunif_tpu_torch.tools import time_ms
    from nunif_tpu_torch.modules.attention import (expand_relative_bias,
                                                   shifted_window_mask)
    rows = []
    heads, ws, n = 12, 6, 36
    for (c, h, w, shift) in K4_FRAME:
        n_wh, n_ww = h // ws, w // ws
        nw = n_wh * n_ww
        hd = c // heads
        qkv = rng.standard_normal((nw, n, 3 * c), dtype=np.float32)
        # std 1, not the init's 0.02, so that the bias moves the output
        # well past the bf16 tolerance (control below)
        bias = expand_relative_bias(t(rng.standard_normal((121, heads))), ws)
        kw = dict(num_heads=heads, window=ws, shift=shift, n_wh=n_wh, n_ww=n_ww)
        what = f"K4 C={c} {h}x{w} shift={shift}"
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            qd = t(qkv, dtype)
            got = k4.fused_window_attention(qd, bias, **kw)
            torch.cuda.synchronize()
            want = k4.window_attention_plain(qd, bias, **kw)
            err, rel_l2 = check_close(got, want, K4_TOL[name], f"{what} {name}")
            ctrl = [compare(k4.fused_window_attention(
                qd, torch.zeros_like(bias), **kw), want, K4_TOL[name])]
            if shift:
                ctrl.append(compare(k4.fused_window_attention(
                    qd, bias, **dict(kw, shift=0)), want, K4_TOL[name]))
            if any(ok for ok, _e, _r in ctrl):
                fail(f"{what} {name}: a control (zero bias or no wrap mask) "
                     f"passes the check ({ctrl}): the check is blind")
            del got, want
            row = dict(C=c, H=h, W=w, shift=shift, dtype=name,
                       max_abs_err=err, control_errs=[e for _o, e, _r in ctrl])
            if dtype == torch.bfloat16:
                q, k, v = qd.view(nw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
                mask = bias[None].expand(nw, heads, n, n)
                if shift:
                    wrap = torch.from_numpy(shifted_window_mask(h, w, ws, shift))
                    mask = mask + wrap.to(dev)[:, None]
                mask = mask.to(dtype).contiguous()
                tm = compare_timed(
                    lambda: k4.fused_window_attention(qd, bias, **kw),
                    lambda: k4.window_attention_plain(qd, bias, **kw), torch,
                    library=lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask))
                nbytes = nw * n * 4 * c * 2 + bias.numel() * 4
                bound_ms, bound_by = bound(nbytes, 4 * nw * n * n * c)
                row.update(ms=tm["kernel"], plain_ms=tm["plain"],
                           library_ms=tm["library"], bound_ms=bound_ms,
                           bound_by=bound_by, **window_launch_extras(
                               k4, time_ms, lambda: k4.fused_window_attention(
                                   qd, bias, **kw), c, heads, n, nw, bound_ms,
                               what))
                del q, k, v, mask
            print(f"{what} {name}: {row}", flush=True)
            rows.append(row)
            del qd
            torch.cuda.empty_cache()
    return rows


def block_weights(t, rng, c, heads=6):
    """A Swin block's seeded weights (Dense-shaped) and relative bias, drawn
    at std 1 so that the bias moves the output well past the bf16
    tolerance (the zero-bias control)."""
    from nunif_tpu_torch.modules.attention import expand_relative_bias
    hid = 2 * c
    return [t(rng.standard_normal((c, 3 * c)) / np.sqrt(c)),
            t(rng.normal(0, 0.02, (3 * c,))),
            t(rng.standard_normal((c, c)) / np.sqrt(c)),
            t(rng.normal(0, 0.02, (c,))),
            t(rng.standard_normal((c, hid)) / np.sqrt(c)),
            t(rng.normal(0, 0.02, (hid,))),
            t(rng.standard_normal((hid, c)) / np.sqrt(hid)),
            t(rng.normal(0, 0.02, (c,))),
            expand_relative_bias(t(rng.standard_normal((121, heads))), 6)]


def ptxas_usage(log, needle):
    """Registers and spill bytes of the kernel whose mangled name holds
    ``needle``, from the build's ``-Xptxas -v`` log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and needle in line:
            spill = lines[i + 2].split(",")
            regs = lines[i + 3].split("Used ")[1].split(" registers")[0]
            return dict(registers=int(regs),
                        spill_stores=int(spill[1].split()[0]),
                        spill_loads=int(spill[2].split()[0]))
    fail(f"no ptxas report for {needle}")


def window_plan(k4, c, heads, n, nw, what):
    """The bf16 K4 / K6 launch plan at one shape, from the built library
    (``window_attn_plan``); the shapes of the paths keep the bias in shared
    memory."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = k4.window_attn_plan(c, heads, n, nw, sms)
    if not plan["bias_resident"]:
        fail(f"{what}: the plan {plan} reads the bias from L2")
    return plan


def window_bias_bytes(plan, heads, n, nw):
    """Bytes of fp32 relative bias a bf16 K4 / K6 launch reads, a count from
    the plan: each block its group's bias once where it is resident in
    shared memory, else (and in the first design) each window all heads'
    N x N."""
    if plan["bias_resident"]:
        return plan["grid"] * plan["group"] * n * n * 4
    return nw * heads * n * n * 4


def window_launch_extras(k4, time_ms, fn, c, heads, n, nw, bound_ms, what):
    """K4 / K6 fields of a bf16 row: ms a launch back to back (5 launches,
    median of 3) and its share of the bound, measured; the plan and the
    bias bytes the launch reads, counts that the kernels line leaves out
    (they print on the "K4 / K6 frame:" line)."""
    plan = window_plan(k4, c, heads, n, nw, what)
    b2b = time_ms(fn, 5)
    extras = dict(plan=plan, ms_b2b=b2b, bound_share=bound_ms / b2b,
                  bias_bytes=window_bias_bytes(plan, heads, n, nw),
                  bias_bytes_a_window=nw * heads * n * n * 4)
    print(f"{what}: {b2b:.4f} ms a launch back to back, "
          f"{100 * bound_ms / b2b:.1f}% of its {bound_ms:.4f} ms bound; plan "
          f"{plan}; bias read {extras['bias_bytes']} B", flush=True)
    return extras


def block_l2_weight_bytes(plan, c, n_windows):
    """Bytes of weights the bf16 K1 / K5 kernel reads from L2 in a launch
    over n_windows windows of 36 tokens, a count from shapes: every tile
    (``plan["windows"]`` windows, from ``block_plan``) reads all four
    matrices once (hidden 2C: 16 C^2 bytes)."""
    tiles = -(-n_windows // plan["windows"])
    return tiles * 2 * (4 * c * c + 2 * c * 2 * c)


def block_composite(torch, x, weights, heads, shift, mask, skip=None,
                    image=True):
    """The Swin block as a PyTorch user would write it, for a yardstick:
    (roll and window partition for an image), cuBLAS ``F.linear`` x4 in
    x's dtype, SDPA per head with the relative bias plus the -100 mask
    (``mask``: numpy, windows of one image or None) as one float mask,
    exact GELU, residuals, (window reverse and roll).  The mask is built
    here, outside the timed call."""
    import torch.nn.functional as F
    from nunif_tpu_torch.modules.permute import window_partition2, window_reverse2
    wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, rel = weights
    dt, ws, n = x.dtype, 6, 36
    mats = [w.t().contiguous().to(dt) for w in (wqkv, wproj, wfc1, wfc2)]
    bs = [b.to(dt) for b in (bqkv, bproj, bfc1, bfc2)]
    if image:
        b, h, w, c = x.shape
        nw = b * (h // ws) * (w // ws)
    else:
        nw, n, c = x.shape
    hd = c // heads
    fmask = rel.float()[None]
    if mask is not None:
        per_img = mask.shape[0]
        fmask = (fmask + torch.from_numpy(mask).to(x.device)[:, None]).repeat(
            nw // per_img, 1, 1, 1)
    fmask = fmask.to(dt).contiguous()

    def call():
        xs = x if skip is None else x + skip
        if image:
            if shift:
                xs = torch.roll(xs, (-shift, -shift), dims=(1, 2))
            xs = window_partition2(xs, ws)
        qkv = F.linear(xs, mats[0], bs[0])
        q, k, v = qkv.view(nw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=fmask)
        y1 = F.linear(a.transpose(1, 2).reshape(nw, n, c), mats[1], bs[1]) + xs
        out = F.linear(F.gelu(F.linear(y1, mats[2], bs[2])), mats[3], bs[3]) + y1
        if image:
            out = window_reverse2(out, ws, h, w)
            if shift:
                out = torch.roll(out, (shift, shift), dims=(1, 2))
        return out
    return call


def k5_phase(torch, k5, rng, t):
    """K5 at the window path's six shapes (shifted blocks on the grid padded
    by one window, shift_mode "pad") and one batch-2 shape, bf16 and fp32,
    against its twin with K1's tolerances; controls that must fail: the
    zero-bias kernel and, shifted, the roll mask where pad was asked.  bf16
    timed beside the twin and the composite (no single PyTorch call
    computes a block), with its weights packed beforehand as the block
    module passes them."""
    from nunif_tpu_torch.modules.attention import padded_window_key_mask
    rows = []
    cases = [key + (1,) for key in K5_FRAME] + [list(K5_FRAME)[-1] + (2,)]
    for c, h, w, shift, batch in cases:
        n_wh, n_ww = h // 6 + (shift > 0), w // 6 + (shift > 0)
        nw = batch * n_wh * n_ww
        weights = block_weights(t, rng, c)
        no_bias = weights[:-1] + [torch.zeros_like(weights[-1])]
        x = rng.normal(0, 0.5, (nw, 36, c))
        kw = dict(num_heads=6, window=6, shift=shift, n_wh=n_wh, n_ww=n_ww,
                  shift_mode="pad")
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            what = (f"K5 C={c} grid {n_wh}x{n_ww} (image {h}x{w}) "
                    f"shift={shift} batch={batch} {name}")
            xd = t(x, dtype)
            got = k5.fused_swin_block(xd, *weights, **kw)
            torch.cuda.synchronize()
            want = k5.swin_block_plain(xd, *weights, **kw)
            err, rel_l2 = check_close(got, want, K1_TOL[name], what)
            ctrl = [compare(k5.fused_swin_block(xd, *no_bias, **kw), want,
                            K1_TOL[name])]
            if shift:
                ctrl.append(compare(k5.fused_swin_block(
                    xd, *weights, **dict(kw, shift_mode="roll")), want,
                    K1_TOL[name]))
            if any(ok for ok, _e, _r in ctrl):
                fail(f"{what}: a control (zero bias, roll mask) passes the "
                     f"check ({ctrl}): the check is blind")
            del got, want
            row = dict(C=c, H=h, W=w, shift=shift, batch=batch, dtype=name,
                       max_abs_err=err, control_errs=[e for _o, e, _r in ctrl])
            if dtype == torch.bfloat16 and batch == 1:
                packed = k5.pack_weights(*weights, dtype)
                mask = padded_window_key_mask(n_wh, n_ww, 6, shift) \
                    if shift else None
                comp = block_composite(torch, xd, weights, 6, shift, mask,
                                       image=False)
                comp_err = float((comp().float() - k5.swin_block_plain(
                    xd, *weights, **kw).float()).abs().max())
                tm = compare_timed(
                    lambda: k5.fused_swin_block(xd, *weights, packed=packed, **kw),
                    lambda: k5.swin_block_plain(xd, *weights, **kw), torch,
                    more={"composite": comp})
                tokens = nw * 36
                nbytes = tokens * c * 2 * 2 + \
                    sum(a.numel() for a in weights[:8]) * 2 + weights[8].numel() * 4
                bound_ms, bound_by = bound(nbytes, tokens * (16 * c * c + 4 * 36 * c))
                row.update(ms=tm["kernel"], plain_ms=tm["plain"],
                           composite_ms=tm["composite"], composite_err=comp_err,
                           bound_ms=bound_ms, bound_by=bound_by)
                del comp
            print(f"{what}: {row}", flush=True)
            rows.append(row)
            del xd
            torch.cuda.empty_cache()
    return rows


def k6_phase(torch, k6, rng, t, dev):
    """K6 (image layout) at the 4xl's eight K4 shapes, bf16 and fp32, with
    K4's tolerances and controls; bf16 timed beside its twin, SDPA on the
    windowed views (as for K4), and K4 with the window partition and
    reverse copies around it.  Then the image-form attention module at the
    4xl's 14 block shapes: K6's launches."""
    import torch.nn.functional as F
    from nunif_tpu_torch.modules.attention import (
        ShiftedWindowAttention, expand_relative_bias, shifted_window_mask)
    from nunif_tpu_torch.modules.permute import window_partition2, window_reverse2
    from nunif_tpu_torch.tools import time_ms
    rows = []
    heads, ws, n = 12, 6, 36
    for (c, h, w, shift) in K4_FRAME:
        n_wh, n_ww = h // ws, w // ws
        nw = n_wh * n_ww
        hd = c // heads
        qkv = rng.standard_normal((1, h, w, 3 * c), dtype=np.float32)
        bias = expand_relative_bias(t(rng.standard_normal((121, heads))), ws)
        kw = dict(num_heads=heads, window=ws, shift=shift)
        what = f"K6 C={c} {h}x{w} shift={shift}"
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            qd = t(qkv, dtype)
            got = k6.fused_window_attention_image(qd, bias, **kw)
            torch.cuda.synchronize()
            want = k6.window_attention_image_plain(qd, bias, **kw)
            err, _ = check_close(got, want, K4_TOL[name], f"{what} {name}")
            ctrl = [compare(k6.fused_window_attention_image(
                qd, torch.zeros_like(bias), **kw), want, K4_TOL[name])]
            if shift:
                ctrl.append(compare(k6.fused_window_attention_image(
                    qd, bias, **dict(kw, shift=0)), want, K4_TOL[name]))
            if any(ok for ok, _e, _r in ctrl):
                fail(f"{what} {name}: a control (zero bias or no wrap mask) "
                     f"passes the check ({ctrl}): the check is blind")
            del got, want
            row = dict(C=c, H=h, W=w, shift=shift, dtype=name,
                       max_abs_err=err, control_errs=[e for _o, e, _r in ctrl])
            if dtype == torch.bfloat16:
                wkw = dict(kw, n_wh=n_wh, n_ww=n_ww)
                qw = window_partition2(qd, ws).contiguous()
                q, k, v = qw.view(nw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
                mask = bias[None].expand(nw, heads, n, n)
                if shift:
                    wrap = torch.from_numpy(shifted_window_mask(h, w, ws, shift))
                    mask = mask + wrap.to(dev)[:, None]
                mask = mask.to(dtype).contiguous()
                tm = compare_timed(
                    lambda: k6.fused_window_attention_image(qd, bias, **kw),
                    lambda: k6.window_attention_image_plain(qd, bias, **kw),
                    torch,
                    library=lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask),
                    more={"k4_copies": lambda: window_reverse2(
                        k6.fused_window_attention(
                            window_partition2(qd, ws).contiguous(), bias, **wkw),
                        ws, h, w)})
                bound_ms, bound_by = bound(h * w * 4 * c * 2 + bias.numel() * 4,
                                           4 * h * w * n * c)
                row.update(ms=tm["kernel"], plain_ms=tm["plain"],
                           library_ms=tm["library"],
                           k4_copies_ms=tm["k4_copies"], bound_ms=bound_ms,
                           bound_by=bound_by, **window_launch_extras(
                               k6, time_ms,
                               lambda: k6.fused_window_attention_image(
                                   qd, bias, **kw), c, heads, n, nw, bound_ms,
                               what))
                del q, k, v, mask, qw
            print(f"{what} {name}: {row}", flush=True)
            rows.append(row)
            del qd
            torch.cuda.empty_cache()
    # the image-form attention module (roll, qkv projection, K6, proj, roll
    # back) at each block shape of the 4xl's frame
    k6.fused_window_attention_image.launches = 0
    ran = 0
    for (c, h, w, shift), count in K4_FRAME.items():
        attn = ShiftedWindowAttention(c, heads, ws, shift).to(dev)
        x = t(rng.normal(0, 1, (1, h, w, c)), torch.bfloat16)
        with torch.no_grad():
            for _ in range(count):
                y = attn(x)
                ran += 1
        torch.cuda.synchronize()
        if tuple(y.shape) != (1, h, w, c) or not bool(y.float().isfinite().all()):
            fail(f"K6 module C={c} {h}x{w}: output {tuple(y.shape)} not finite")
        del attn, x, y
    launches = k6.fused_window_attention_image.launches
    print(f"K6 image-form attention module at the 4xl's {ran} block shapes: "
          f"{launches} launches", flush=True)
    if launches != ran:
        fail(f"K6 module path launched K6 {launches} times for {ran} calls")
    torch.cuda.empty_cache()
    return rows, launches


def probe_phase(torch, probes, dev):
    """T1, T3 and T4 against their twins at the tools' shapes (T1 and T4
    int8 exact), then the three tools' runs, which time them and give their
    launches."""
    from nunif_tpu_torch.tools import (microbench_int8_attn as t3_tool,
                                       microbench_mxu_dots as t4_tool,
                                       microbench_strip as t1_tool)
    errs = {}
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((1, t1_tool.H, t1_tool.W, t1_tool.C), generator=gen,
                    device=dev).to(torch.bfloat16)
    t1_checks(torch, probes, x, t1_tool.BLOCKS)
    # the tool's blocks that do not tile its 184 window rows, (16, 8) and
    # (16, 4), on an image of 192
    x = torch.randn((1, 1152, t1_tool.W, t1_tool.C), generator=gen,
                    device=dev).to(torch.bfloat16)
    t1_checks(torch, probes, x, [b for b in t1_tool.BLOCKS if (t1_tool.H // 6) % b[0]])
    errs["strip_relayout"] = 0.0
    del x
    for dtype in (torch.bfloat16, torch.int8):
        name = str(dtype).split(".")[1]
        ins = t3_tool.inputs(dtype, seed=10)
        got = probes.window_dots(*ins)
        torch.cuda.synchronize()
        want = probes.window_dots_plain(*ins)
        err, _ = check_close(got, want, T3_TOL[name], f"T3 window_dots {name}")
        same = float((got == want).float().mean())
        print(f"T3 window_dots {name} ({ins[0].shape[0]} windows): max abs err "
              f"{err:.3g}, "
              f"bit-equal {same:.4f}", flush=True)
        if same < 0.99:
            fail(f"T3 {name}: only {same:.4f} of elements bit-equal")
        errs[f"window_dots_{name}"] = err
        del ins, got, want
    for label, n, c, p, int8 in t4_tool.SHAPES:
        # the fill, then every window's o of the last repetition (the fill
        # sees window 0 of the last block only); the control, one window's
        # khat zeroed, must pass the fill check and fail the window check
        ins = t4_tool.inputs(n, c, p, int8, seed=11)
        check = torch.empty((ins[0].shape[0], n, c), device=dev)
        got = probes.window_dots_repeat(*ins, check=check)
        torch.cuda.synchronize()
        want_check = torch.empty_like(check)
        want = probes.window_dots_repeat_plain(*ins, want_check)
        tol = (0.0, 0.0) if int8 else (T4_RTOL, 0.0)
        err, _ = check_close(got, want, tol, f"T4 {label}")
        if not float(want[0, 0]) or not bool((got == got[0, 0]).all()):
            fail(f"T4 {label}: zero or uneven fill {got[0, :4].tolist()}")
        err_w, _ = check_close(check, want_check, tol, f"T4 {label} windows")
        khat = ins[1].clone()
        khat[5] = 0
        bad_check = torch.empty_like(check)
        bad = probes.window_dots_repeat(ins[0], khat, ins[2], check=bad_check)
        fill_ok, _e, _r = compare(bad, want, tol)
        win_ok, ctrl_err, _r = compare(bad_check, want_check, tol)
        if not fill_ok or win_ok:
            fail(f"T4 {label}: the control (window 5's khat zeroed) passes the "
                 f"window check ({win_ok}) or fails the fill check "
                 f"({not fill_ok}): the check is blind")
        print(f"T4 {label}: fill err {err:.3g}, window err {err_w:.3g}, "
              f"control window err {ctrl_err:.3g}", flush=True)
        for key, e in (("window_dots_repeat", err), ("window_dots_repeat_windows", err_w)):
            errs[key] = max(errs.get(key, 0.0), e)
        del ins, got, want, check, want_check, bad_check, khat
    torch.cuda.empty_cache()
    print(f"probe checks passed: {errs}", flush=True)
    for fn in (probes.strip_pass, probes.strip_relayout, probes.window_dots,
               probes.window_dots_repeat):
        fn.launches = 0
    t1 = t1_tool.run()
    t3 = t3_tool.run()
    t4 = t4_tool.run()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in (
        probes.strip_pass, probes.strip_relayout, probes.window_dots,
        probes.window_dots_repeat)}
    print(f"probe tool launches: {launches}", flush=True)
    if not all(launches.values()):
        fail(f"a probe kernel was not launched by its tool: {launches}")
    # T1's device time a launch at each block, in a process of its own: in
    # this long one torch.profiler drops kernel records
    proc = subprocess.run([sys.executable, "-m", "nunif_tpu_torch.tools.microbench_strip",
                           "--device-ms"], capture_output=True, text=True, timeout=300)
    if proc.returncode:
        fail(f"T1 device time: rc {proc.returncode}: {proc.stderr[-2000:]}")
    print(f"T1 device ms a launch (rh cw):\n{proc.stdout.strip()}", flush=True)
    device = json.loads(proc.stdout.strip().splitlines()[-1])
    for row in t1["rows"]:
        row.update(device[f"{row['rh']} {row['cw']}"])
    return t1, t3, t4, launches, errs


def t1_checks(torch, probes, x, blocks):
    """T1 at each of the blocks that tiles x: both kernels equal the twin
    bit for bit;
    at scale 2.0 (exact in bf16, where the tool's scale rounds to 1.0) both
    give exactly x * 2 and the relayout's window hook equals
    ``window_partition2(x) * 2``.  Controls that must fail: the hook
    against image order reshaped (not partitioned), a kernel's output at
    scale 2.0 against x."""
    h, w, c = x.shape[1:]
    want, want2 = probes.strip_plain(x), probes.strip_plain(x, 2.0)
    want_win = probes.strip_windows_plain(x, 6, 2.0)
    image_order = (x * 2).reshape(want_win.shape)
    windows = torch.empty_like(want_win)
    for rh, cw in blocks:
        if (h // 6) % rh or (w // 6) % cw:
            continue
        for fn in (probes.strip_pass, probes.strip_relayout):
            what = f"T1 {fn.__name__} rh={rh} cw={cw}"
            if not torch.equal(fn(x, rh, cw), want):
                fail(f"{what} differs from x * scale")
            got2 = fn(x, rh, cw, scale=2.0)
            if not torch.equal(got2, want2):
                fail(f"{what} at scale 2.0 differs from x * 2")
            if torch.equal(got2, x):
                fail(f"{what}: the control (x) passes the scale-2.0 check")
        windows.zero_()
        probes.strip_relayout(x, rh, cw, scale=2.0, windows=windows)
        if not torch.equal(windows, want_win):
            fail(f"T1 relayout rh={rh} cw={cw}: the window hook differs from "
                 f"window_partition2(x) * 2")
        if torch.equal(windows, image_order):
            fail(f"T1 relayout rh={rh} cw={cw}: the control (image order "
                 f"reshaped) passes the window check")
    print(f"T1 checks passed at {h}x{w}x{c}, blocks {blocks}: pass and "
          f"relayout equal x * scale, x * 2 at scale 2.0, the window hook "
          f"window_partition2(x) * 2; both controls fail", flush=True)


def swin_t_phase(torch, k4, rng, t, dev):
    """K4 and K6 at imagenet swin_t's stage shapes (window 7, N = 49, head
    dim 32) and one window-8 shape (N = 64), bf16 and fp32, against their
    twins with K4's tolerances and controls (zero bias; shifted, the kernel
    run unshifted); bf16 timed beside the twin and SDPA on the windowed
    views with a float mask."""
    import torch.nn.functional as F
    from nunif_tpu_torch.modules.attention import (expand_relative_bias,
                                                   shifted_window_mask)
    from nunif_tpu_torch.modules.permute import window_partition2
    from nunif_tpu_torch.tools import time_ms
    rows = []
    shapes = [(c, hw, shift, 7, SWIN_T_BATCH) for c, hw, shift in SWIN_T]
    shapes.append(WINDOW8 + (8,))
    for c, hw, shift, ws, batch in shapes:
        heads, n, n_wh = c // 32, ws * ws, hw // ws
        nw = batch * n_wh * n_wh
        qkv = rng.standard_normal((batch, hw, hw, 3 * c), dtype=np.float32)
        bias = expand_relative_bias(
            t(rng.standard_normal(((2 * ws - 1) ** 2, heads))), ws)
        for label in ("K4", "K6"):
            if label == "K4":
                kernel, plain = k4.fused_window_attention, k4.window_attention_plain
                kw = dict(num_heads=heads, window=ws, shift=shift, n_wh=n_wh,
                          n_ww=n_wh)
            else:
                kernel = k4.fused_window_attention_image
                plain = k4.window_attention_image_plain
                kw = dict(num_heads=heads, window=ws, shift=shift)
            what = f"{label} window {ws} C={c} {batch}x{hw}x{hw} shift={shift}"
            for dtype in (torch.bfloat16, torch.float32):
                name = str(dtype).split(".")[1]
                qd = t(qkv, dtype)
                arg = window_partition2(qd, ws).contiguous() if label == "K4" else qd
                got = kernel(arg, bias, **kw)
                torch.cuda.synchronize()
                want = plain(arg, bias, **kw)
                err, _ = check_close(got, want, K4_TOL[name], f"{what} {name}")
                ctrl = [compare(kernel(arg, torch.zeros_like(bias), **kw), want,
                                K4_TOL[name])]
                if shift:
                    ctrl.append(compare(kernel(arg, bias, **dict(kw, shift=0)),
                                        want, K4_TOL[name]))
                if any(ok for ok, _e, _r in ctrl):
                    fail(f"{what} {name}: a control (zero bias or no wrap mask) "
                         f"passes the check ({ctrl}): the check is blind")
                del got, want
                row = dict(kernel=label, C=c, HW=hw, window=ws, batch=batch,
                           shift=shift, dtype=name, max_abs_err=err,
                           control_errs=[e for _o, e, _r in ctrl])
                if dtype == torch.bfloat16:
                    qw = window_partition2(qd, ws).contiguous()
                    q, k, v = qw.view(nw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
                    mask = bias[None].expand(nw, heads, n, n)
                    if shift:
                        wrap = torch.from_numpy(shifted_window_mask(hw, hw, ws, shift))
                        mask = mask + wrap.to(dev).repeat(batch, 1, 1)[:, None]
                    mask = mask.to(dtype).contiguous()
                    tm = compare_timed(
                        lambda: kernel(arg, bias, **kw),
                        lambda: plain(arg, bias, **kw), torch,
                        library=lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask))
                    bound_ms, bound_by = bound(nw * n * 4 * c * 2 + bias.numel() * 4,
                                               4 * nw * n * n * c)
                    row.update(ms=tm["kernel"], plain_ms=tm["plain"],
                               library_ms=tm["library"], bound_ms=bound_ms,
                               bound_by=bound_by, **window_launch_extras(
                                   k4, time_ms, lambda: kernel(arg, bias, **kw),
                                   c, heads, n, nw, bound_ms, f"{what} {name}"))
                    del q, k, v, mask, qw
                print(f"{what} {name}: {row}", flush=True)
                rows.append(row)
                del qd, arg
                torch.cuda.empty_cache()
    return rows


def t2_phase(torch, probes, dev):
    """T2 at both tool shapes, all ten variants, against its twin on the
    check tables (weights N(0, 1 / fan-in), biases N(0, 0.1), bias table
    N(0, 1)); for the whole attention, controls that must fail: a zero bias
    table and per-window attention (-1000 across windows).  Then the port's
    tool at both shapes, which times every variant with the tool's draws
    (bias table N(0, 0.02)) and gives the launches."""
    from nunif_tpu_torch.tools import microbench_swin_pieces as tool

    def agree(got, want):
        d = (got.float() - want.float()).abs()
        err, same = float(d.max()), float((got == want).float().mean())
        ok = bool(d.isfinite().all()) and err <= T2_ATOL and same >= T2_BIT_EQUAL
        return ok, err, same

    errs = {}
    for c in (96, 192):
        g, cw = tool.default_g(c), tool.default_cw(c)
        x = tool.image(c, device=dev)
        win = torch.arange(g * 36, device=dev) // 36
        same_win = (win[:, None] == win[None, :]).repeat(1, c // 16)
        for name in tool.VARIANTS:
            v = tool.variant(name)
            wts = tool.weights(c, g, v["dense_int8"], check=True, seed=c,
                               device=dev)
            kw = dict(G=g, rh=tool.RH, cw=cw, **v)
            got = probes.swin_pieces(x, *wts, **kw)
            torch.cuda.synchronize()
            want = probes.swin_pieces_plain(x, *wts, **kw)
            ok, err, same = agree(got, want)
            what = f"T2 {name} C={c} G={g}"
            if not ok:
                fail(f"{what}: max abs err {err}, bit-equal {same:.4f} (limits "
                     f"{T2_ATOL}, {T2_BIT_EQUAL})")
            if name == "W" and not torch.equal(got, x):
                fail(f"{what}: not a copy")
            ctrl = []
            if v["pieces"] == 4:
                bias = wts[8]
                for control in (torch.zeros_like(bias),
                                torch.where(same_win, bias,
                                            torch.full_like(bias, -1000.0))):
                    ctrl.append(agree(probes.swin_pieces(
                        x, *wts[:8], control, *wts[9:], **kw), want))
                if any(c_ok for c_ok, _e, _s in ctrl):
                    fail(f"{what}: a control (zero bias, per-window attention) "
                         f"passes the check ({ctrl}): the check is blind")
            print(f"{what}: max abs err {err:.3g}, bit-equal {same:.5f}; "
                  f"controls (zero bias, per-window) "
                  f"{[(round(e, 3), round(s_, 4)) for _o, e, s_ in ctrl]}",
                  flush=True)
            errs[(c, name)] = err
            del got, want, wts
            torch.cuda.empty_cache()
        del x
    probes.swin_pieces.launches = 0
    runs = tool.run(96, None, list(tool.VARIANTS)) + \
        tool.run(192, None, list(tool.VARIANTS))
    torch.cuda.synchronize()
    launches = probes.swin_pieces.launches
    print(f"T2 tool launches: {launches}", flush=True)
    if not launches:
        fail("T2: the tool did not launch the kernel")
    for r in runs:
        r["max_abs_err"] = errs[(r["C"], r["name"])]
        r["bound_ms"], r["bound_by"] = bound_ops(r["nbytes"], r["ops"])
    return runs, launches


# ---------------------------------------------------------------------------
# "video": the engine, both CLIs' video paths, scene detection, the autocrop
# pre-pass, stlizer and BASELINE config 5, the two-pass warp on K3, HDR

VIDEO_FRAMES, VIDEO_FPS = 48, 30
VIDEO_BATCH = 4  # the CLIs' --video-batch
VIDEO_CUT = 24  # the scene-detection clip's cut
# iw3 CLI at its defaults over VIDEO_FRAMES frames: 12 batches of 4, K7 12
# a batch (Any_V2_S), K3 1 (row_flow_v3's eyes as one batch)
VIDEO_IW3_LAUNCHES = {"sdpa": 12 * VIDEO_FRAMES // VIDEO_BATCH,
                      "warp_x_bounded": VIDEO_FRAMES // VIDEO_BATCH}
W2X_TURBO_FRAMES, W2X_SWIN_FRAMES = 16, 8
SWIN_TILE = "1120x1936"  # one tile a 1080p frame, as the "frame" phase
# the two-pass warp's transform (|shift| ~40 px, 1.5 degrees); it and the
# HDR tone map run on batches of 8 frames
TWO_PASS_SHIFT, TWO_PASS_ANGLE = (36.0, -18.0), 1.5
TWO_PASS_GATHER_ATOL = 8e-3  # bf16 taps and a bilinear of a bilinear, smooth x
LIBAV = ("libavformat", "libavcodec", "libavutil", "libswscale")
# the lossless settings of the round trip where libav exists
LOSSLESS_ARGS = ["--video-codec", "utvideo", "--pix-fmt", "gbrp"]


class RawVideoReader:
    """A raw-frame file with ``backend.VideoReader``'s interface: a JSON
    header line (width, height, fps, dtype) and the frames, pts i / fps.
    The video phase reads and writes through it where libav is absent."""

    def __init__(self, path, rgb48=False, apply_rotation=True):
        self._f = open(path, "rb")
        head = json.loads(self._f.readline())
        self.width, self.height, self.fps = head["width"], head["height"], head["fps"]
        self._dtype = np.dtype(head["dtype"])
        if (self._dtype == np.uint16) != bool(rgb48):
            raise IOError(f"{path}: {self._dtype} frames, rgb48={rgb48}")
        self.rgb48 = rgb48
        self._start = self._f.tell()
        self._size = self.height * self.width * 3 * self._dtype.itemsize
        self.nb_frames = (os.path.getsize(path) - self._start) // self._size
        self.duration = self.nb_frames / self.fps
        self.rotation = 0
        self.color_trc = self.color_primaries = self.colorspace = 2  # unspecified
        self.color_range = 0
        self.master_max_luminance = self.master_min_luminance = 0.0
        self.max_cll = 0
        self._i = 0

    is_hdr = False

    def __iter__(self):
        return self

    def __next__(self):
        buf = self._f.read(self._size)
        if len(buf) < self._size:
            raise StopIteration
        frame = np.frombuffer(buf, self._dtype).reshape(self.height, self.width, 3)
        self._i += 1
        return frame.copy(), (self._i - 1) / self.fps

    def seek(self, seconds):
        self._i = int(seconds * self.fps)
        self._f.seek(self._start + self._i * self._size)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False


class RawVideoWriter:
    """``backend.VideoWriter``'s interface over a raw-frame file (codec
    settings ignored)."""

    def __init__(self, path, width, height, fps_num, fps_den=1, codec="",
                 pix_fmt="", preset="", crf=0, rgb48=False, audio_source=None,
                 extra_opts=""):
        self.width, self.height = width, height
        self._dtype = np.uint16 if rgb48 else np.uint8
        self._f = open(path, "wb")
        self._f.write((json.dumps({"width": width, "height": height,
                                   "fps": fps_num / fps_den,
                                   "dtype": np.dtype(self._dtype).name}) + "\n").encode())

    def write(self, frame):
        if frame.shape != (self.height, self.width, 3) or frame.dtype != self._dtype:
            raise ValueError(f"frame {frame.shape} {frame.dtype}")
        self._f.write(np.ascontiguousarray(frame).tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False


class raw_video:
    """Within the block the port's video backend reads and writes raw-frame
    files (``RawVideoReader`` / ``RawVideoWriter``)."""

    def __enter__(self):
        from nunif_tpu_torch.video import backend
        self.saved = {k: getattr(backend, k) for k in ("VideoReader", "VideoWriter")}
        backend.VideoReader, backend.VideoWriter = RawVideoReader, RawVideoWriter

    def __exit__(self, *exc):
        from nunif_tpu_torch.video import backend
        for k, v in self.saved.items():
            setattr(backend, k, v)


class engine_runs:
    """Within the block, the stage times of every ``engine.process_video``
    run (decode wait, callback issue, device wait, encode, wall) are
    appended to ``runs``."""

    def __enter__(self):
        from nunif_tpu_torch.video import engine
        self.runs, self.saved = [], engine.process_video

        def recorded(*a, **k):
            stats = self.saved(*a, **k)
            self.runs.append(stats)
            return stats
        engine.process_video = recorded
        return self

    def __exit__(self, *exc):
        from nunif_tpu_torch.video import engine
        engine.process_video = self.saved


def video_io_check():
    """(libav present, the printed finding): the decision comes from what
    ``ldd`` resolves for the native library, not from an exception."""
    from nunif_tpu_torch.video import backend
    lines = sh(["ldd", backend.LIB_PATH]).splitlines()
    av = [ln.strip() for ln in lines if ln.strip().startswith(LIBAV)]
    print("video I/O: ldd native/libnunif_video.so: " + "; ".join(av), flush=True)
    missing = [ln.split()[0] for ln in av if "not found" in ln]
    if missing or len(av) < len(LIBAV):
        return False, (f"video I/O: libav absent ({', '.join(missing)}), file round "
                       f"trip held on the CPU lane")
    codecs = {c: backend.encoder_available(c) for c in ("libx264", "libx265", "utvideo")}
    return True, (f"video I/O: {backend.version()}; encoders {json.dumps(codecs)}")


def video_stats(runs, frames):
    """fps over the whole run and the wall time by stage (the first
    callback's time also alone), summed over the engine runs."""
    total = {k: sum(r[k] for r in runs) for k in
             ("decode_s", "callback_s", "first_callback_s", "device_wait_s",
              "encode_s", "wall_s")}
    return {"fps": frames / total["wall_s"], **{k: round(v, 4) for k, v in total.items()}}


def read_video(path, rgb48=False):
    from nunif_tpu_torch.video import backend
    with backend.VideoReader(path, rgb48=rgb48) as r:
        return np.stack([f for f, _ in r])


def video_models(torch, dev, model_dir):
    """The iw3 nets of the earlier phases (Any_V2_S, row_flow_v3; seeded
    VDA-S and LightVideoInpaintV1) written to .nztm in ``model_dir``:
    (depth model, row_flow_v3) loaded back."""
    from nunif_tpu_torch.iw3.depth.vda import VideoDepthAnything, shaped_flax_params
    from nunif_tpu_torch.iw3.models import light_video_inpaint_v1 as lv
    from nunif_tpu_torch.models import from_flax, save_model
    vda = VideoDepthAnything(encoder="vits")
    from_flax(vda, shaped_flax_params(vda, 5))
    save_model(vda, os.path.join(model_dir, "vda_s.nztm"))
    net = lv.LightVideoInpaintV1()
    from_flax(net, lv.shaped_flax_params(net, 6))
    save_model(net, os.path.join(model_dir, "light_video_inpaint_v1.nztm"))
    return iw3_models(torch, dev, model_dir)


def counted(kernels, fn):
    """fn() with every kernel count set to 0 just before and read just
    after: (fn's result, {kernel: launches})."""
    for k in kernels.values():
        k.launches = 0
    out = fn()
    torch_sync()
    return out, {name: k.launches for name, k in kernels.items()}


def torch_sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def torch_empty_cache():
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def video_phase(torch, dev, k3, k7, kernels, smi, hw=(1080, 1920), cli_extra=(),
                libav=None, resolution=None):
    """The "video" phase (see the module docstring); k3 / k7 are the
    kernels' modules (for ``twins``), ``kernels`` the wrappers whose
    launches it counts ({"sdpa": k7.sdpa, ...}).  A rehearsal on the CPU
    passes a small ``hw``, ``cli_extra`` (``--device cpu``), a small depth
    ``resolution`` and ``libav=False``.  Returns the phase's numbers, for
    its own JSON line and the kernels line."""
    from nunif_tpu_torch.iw3 import cli as iw3_cli
    from nunif_tpu_torch.iw3.composition import StereoFormat
    from nunif_tpu_torch.iw3.pipeline import StereoConfig
    from nunif_tpu_torch.iw3.scene_boundary_cache import load_cache
    from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
    from nunif_tpu_torch.stlizer.__main__ import main as stlizer_main
    from nunif_tpu_torch.stlizer.gen_test_video import generate_shaky_video
    from nunif_tpu_torch.utils.autocrop import autocrop_analyze_video
    from nunif_tpu_torch.utils.shot_boundary import detect_boundaries
    from nunif_tpu_torch.video import VideoOutputConfig, engine, generate_video
    from nunif_tpu_torch.waifu2x import cli as w2x_cli
    t_phase = time.perf_counter()
    out = {}
    # 1. video I/O
    found, line = video_io_check()
    libav = found if libav is None else libav
    print(line, flush=True)
    out["libav"] = libav
    codec = LOSSLESS_ARGS if libav else []
    ext = ".mkv"
    with tempfile.TemporaryDirectory() as d, \
            (contextlib.nullcontext() if libav else raw_video()):
        dm, flow = video_models(torch, dev, d)
        if resolution:
            from nunif_tpu_torch.iw3.depth import create_depth_model
            dm = create_depth_model("Any_V2_S", device=dev).load(
                resolution=resolution, checkpoint=os.path.join(d, "depth_any_v2_s.nztm"))
            cli_extra = list(cli_extra) + ["--resolution", str(resolution)]
        config = VideoOutputConfig(codec="utvideo", pix_fmt="gbrp", audio_copy=False)
        n, (h, w) = VIDEO_FRAMES, hw
        # 2. the source clip and the engine's round trip
        src_frames = iw3_frames(torch, dev, n, h, w, seed=61).cpu().numpy()
        clip = os.path.join(d, "clip" + ext)
        generate_video(clip, iter(src_frames), w, h, fps=VIDEO_FPS, config=config)
        if not np.array_equal(read_video(clip), src_frames):
            fail("video: the clip does not decode to the frames written")
        print(f"video: {n} frames {h}x{w} at {VIDEO_FPS} fps written and read back "
              f"identical", flush=True)
        # 3. the iw3 CLI at its defaults (Any_V2_S, row_flow_v3), half-SBS
        common = ["--depth-checkpoint", os.path.join(d, "depth_any_v2_s.nztm"),
                  "--yes"] + codec + list(cli_extra)
        iw3_out = os.path.join(d, "iw3" + ext)
        t0 = time.perf_counter()
        with engine_runs() as er:
            _r, launches = counted(kernels, lambda: iw3_cli.main(
                ["-i", clip, "-o", iw3_out, "--half-sbs", "--stereo-checkpoint",
                 os.path.join(d, "row_flow_v3.nztm")] + common))
        # fps of the engine's run, and of the whole CLI call (model loads)
        stats = dict(video_stats(er.runs, n), cli_fps=n / (time.perf_counter() - t0))
        got = read_video(iw3_out)
        print(f"video: iw3 CLI {smi}: {json.dumps(stats)}; launches {launches}",
              flush=True)
        if got.shape != (n, h, w, 3):
            fail(f"video: iw3 CLI wrote {got.shape}")
        if dev.type == "cuda" and {k: launches[k] for k in VIDEO_IW3_LAUNCHES} \
                != VIDEO_IW3_LAUNCHES:
            fail(f"video: iw3 CLI launches {launches}, want {VIDEO_IW3_LAUNCHES}")
        cfg = StereoConfig(method="row_flow_v3", divergence=IW3_DIVERGENCE,
                           convergence=IW3_CONVERGENCE, format=StereoFormat(half_sbs=True))
        decoded = read_video(clip)

        def in_memory():
            dm.disable_ema()
            proc = Iw3FrameProcessor(cfg, dm, flow, edge_dilation=2)
            ys = [proc(decoded[i:i + VIDEO_BATCH]) for i in range(0, n, VIDEO_BATCH)]
            ys.append(proc.flush())
            return torch.cat([engine.quantize(y, torch.uint8).cpu()
                              for y in ys if y is not None]).numpy()
        mem = in_memory()
        if not np.array_equal(mem, got):
            fail(f"video: the iw3 CLI's frames differ from the processor's in "
                 f"memory ({uint8_psnr(torch.from_numpy(mem), torch.from_numpy(got)):.2f} dB)")
        with twins((k3, "warp_x_bounded"), (k7, "sdpa")):
            twin = in_memory()
        psnrs = [uint8_psnr(torch.from_numpy(a), torch.from_numpy(b))
                 for a, b in zip(got, twin)]
        moved = float((np.abs(got[:, :, :w // 2].astype(np.int16)
                              - decoded[:, :, ::2].astype(np.int16)) > 2).mean())
        print(f"video: iw3 CLI output equals the processor in memory; against the "
              f"twins min {min(psnrs):.2f} dB a frame; left-eye pixels moved {moved:.3f}",
              flush=True)
        if min(psnrs) < FRAME_PSNR_MIN or moved < 0.05:
            fail(f"video: iw3 CLI against the twins {min(psnrs):.2f} dB, moved {moved}")
        out["iw3"] = dict(stats, launches=launches,  # inf (identical) as None
                          min_psnr_vs_twins=min(psnrs) if np.isfinite(min(psnrs)) else None)
        # --scene-detect --autocrop on a clip with a cut and 140-row bars
        bars = EXTRAS_BARS * h // 1080
        scene = iw3_frames(torch, dev, n, h - 2 * bars, w, seed=62)
        scene[VIDEO_CUT:] = 160 + iw3_frames(torch, dev, n - VIDEO_CUT, h - 2 * bars, w,
                                             seed=63) // 4
        cut = np.zeros((n, h, w, 3), np.uint8)
        cut[:, bars:h - bars] = scene.cpu().numpy()
        cut_clip = os.path.join(d, "cut" + ext)
        generate_video(cut_clip, iter(cut), w, h, fps=VIDEO_FPS, config=config)
        cut_out = os.path.join(d, "cut_out" + ext)
        with engine_runs() as er:
            _r, launches = counted(kernels, lambda: iw3_cli.main(
                ["-i", cut_clip, "-o", cut_out, "--half-sbs", "--scene-detect",
                 "--autocrop", "--ema-normalize", "--scene-cache-dir", d,
                 "--stereo-checkpoint", os.path.join(d, "row_flow_v3.nztm")] + common))
        used = load_cache(cut_clip, 30.0, d)
        want = detect_boundaries(cut_clip, threshold=0.3, min_frames=10, max_fps=30.0)
        crop = autocrop_analyze_video(cut_clip)
        shape = read_video(cut_out).shape
        print(f"video: --scene-detect --autocrop: boundaries {used} (detector {want}), "
              f"crop {crop}, output {shape}; {json.dumps(video_stats(er.runs, n))}",
              flush=True)
        if used != want or want != [VIDEO_CUT] or crop != (slice(bars, h - bars), slice(None)) \
                or shape != (n, h - 2 * bars, w, 3):
            fail("video: scene detection or the autocrop pre-pass disagree")
        out["scene_autocrop"] = dict(boundaries=used, launches=launches)
        # 4. BASELINE config 5: stlizer -> streaming VDA + mlbw_l2_inpaint_video
        image = os.path.join(d, "still.png")
        from PIL import Image
        Image.fromarray(iw3_frames(torch, dev, 1, h, w, seed=64)[0].cpu().numpy()).save(image)
        shaky = os.path.join(d, "shaky" + ext)
        nshaky, _traj = generate_shaky_video(image, shaky, fps=VIDEO_FPS,
                                             seconds_per_image=n / VIDEO_FPS,
                                             device=dev, config=config)
        stable = os.path.join(d, "stable" + ext)
        chain_out = os.path.join(d, "config5" + ext)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        stl = ["-i", shaky, "--cache-dir", d, "--device", str(dev)] + codec
        t0 = time.perf_counter()
        with engine_runs() as er_st:
            _r, l_st = counted(kernels, lambda: stlizer_main(stl + ["-o", stable]))
        t1 = time.perf_counter()
        with engine_runs() as er_vda:
            _r, l_vda = counted(kernels, lambda: iw3_cli.main(
                ["-i", stable, "-o", chain_out, "--half-sbs", "--depth-model",
                 "VDA_Stream_S", "--method", "mlbw_l2_inpaint_video",
                 "--depth-checkpoint", os.path.join(d, "vda_s.nztm"),
                 "--stereo-checkpoint", os.path.join(d, "light_video_inpaint_v1.nztm"),
                 "--yes"] + codec + list(cli_extra)))
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else None
        chain = read_video(chain_out)
        if chain.shape != (nshaky, h, w, 3) or not np.isfinite(chain).all():
            fail(f"video: config 5 wrote {chain.shape}")
        t3 = time.perf_counter()
        with engine_runs() as er_op:
            counted(kernels, lambda: stlizer_main(stl + ["-o", os.path.join(
                d, "outpaint" + ext), "--border", "outpaint"]))
        # each stage's fps over its whole CLI run (models, the stlizer's
        # analysis pass), beside the engine's own run
        out["config5"] = {
            "stlizer": dict(fps=nshaky / (t1 - t0), engine=video_stats(er_st.runs, nshaky),
                            launches=l_st),
            "iw3_vda_inpaint": dict(fps=nshaky / (t2 - t1),
                                    engine=video_stats(er_vda.runs, nshaky), launches=l_vda),
            "chain_fps": nshaky / (t2 - t0), "peak_gib": peak,
            "stlizer_outpaint": dict(fps=nshaky / (time.perf_counter() - t3),
                                     engine=video_stats(er_op.runs, nshaky))}
        print(f"video: BASELINE config 5 {smi}: " + json.dumps(out["config5"]), flush=True)
        if dev.type == "cuda" and (l_vda["sdpa"] == 0 or l_vda["warp_x_bounded"] == 0):
            fail(f"video: config 5 did not run K7 / K3: {l_vda}")
        # 6. waifu2x: turbo_2x at the CLI's defaults, swin_unet_2x seeded
        w2x = {}
        for name, frames, args, expect in (
                ("turbo_2x", W2X_TURBO_FRAMES, [], {}),
                ("swin_unet_2x", W2X_SWIN_FRAMES,
                 ["--method", "scale", "--arch", "waifu2x.swin_unet_2x",
                  "--tile-size", SWIN_TILE],
                 {"fused_swin_block_image": 14 * W2X_SWIN_FRAMES,
                  "stem_conv3x3": W2X_SWIN_FRAMES})):
            src = os.path.join(d, f"w2x_{name}_in" + ext)
            generate_video(src, iter(src_frames[:frames]), w, h, fps=VIDEO_FPS, config=config)
            dst = os.path.join(d, f"w2x_{name}" + ext)
            with engine_runs() as er:
                _r, launches = counted(kernels, lambda: w2x_cli.main(
                    ["-i", src, "-o", dst, "--yes"] + args + codec
                    + (["--device", str(dev)] if cli_extra else [])))
            shape = read_video(dst).shape
            w2x[name] = dict(video_stats(er.runs, frames), launches=launches)
            print(f"video: waifu2x {name} {smi}: {json.dumps(w2x[name])}", flush=True)
            if shape != (frames, 2 * h, 2 * w, 3):
                fail(f"video: waifu2x {name} wrote {shape}")
            if dev.type == "cuda" and any(launches[k] != v for k, v in expect.items()):
                fail(f"video: waifu2x {name} launches {launches}, want {expect}")
        out["waifu2x"] = w2x
    # 5. K3 in the two-pass warp, and find_transform on the card
    out["two_pass"] = two_pass_check(torch, dev, k3, (8,) + tuple(hw) + (3,))
    # 7. HDR
    out["hdr"] = hdr_check(torch, dev, (8,) + tuple(hw) + (3,))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def video_run_launches(video):
    """{run: {kernel: launches}} of the "video" phase's CLI runs, for the
    kernels line."""
    runs = {run: video[run]["launches"] for run in ("iw3", "scene_autocrop")}
    runs.update({f"config5 {k}": v["launches"] for k, v in video["config5"].items()
                 if isinstance(v, dict) and "launches" in v})
    runs.update({f"waifu2x {k}": v["launches"] for k, v in video["waifu2x"].items()})
    return runs


def two_pass_check(torch, dev, k3, shape):
    """``apply_transform(padding_mode="border")`` on a smooth fp32 batch:
    2 K3 launches a call, against the same call with K3's plain twin (K3's
    fp32 tolerance) and against the gather inside the envelope; the times
    (CUDA events, in turns, medians) beside the bytes bound and one
    ``F.grid_sample`` call on the same transform's grid; then
    ``find_transform`` recovers a known shift and angle."""
    import torch.nn.functional as F
    from nunif_tpu_torch.modules.resize import resize
    from nunif_tpu_torch.utils import superpoint as sp
    B, H, W, C = shape
    gen = torch.Generator(device=dev).manual_seed(71)
    x = resize(torch.rand((B, H // 16, W // 16, C), generator=gen, device=dev),
               H, W, mode="bilinear", antialias=False).contiguous()
    shift = torch.tensor([TWO_PASS_SHIFT] * B, device=dev)
    scale = torch.ones(B, device=dev)
    angle = torch.full((B,), TWO_PASS_ANGLE, device=dev)
    center = torch.tensor([[W / 2, H / 2]] * B, device=dev)
    reach = max(map(abs, TWO_PASS_SHIFT)) + abs(np.sin(np.radians(TWO_PASS_ANGLE))) \
        * 0.5 * float(np.hypot(H, W))
    ms = int(-(-int(reach + 1) // 8) * 8)
    if ms > sp.TWO_PASS_MAX_SHIFT:
        fail(f"two-pass warp: bound {ms} beyond {sp.TWO_PASS_MAX_SHIFT}")

    def run():
        return sp.apply_transform(x, shift, scale, angle, center,
                                  padding_mode="border", max_shift=ms)

    def plain():
        with twins((k3, "warp_x_bounded")):
            return run()
    got, launches = counted({"k3": k3.warp_x_bounded}, run)
    want = plain()
    err, _rel = check_close(got, want, (0.0, K3_ATOL), "two-pass warp vs its twin")
    gather = sp.apply_transform(x, shift, scale, angle, center, padding_mode="border",
                                max_shift=sp.TWO_PASS_MAX_SHIFT + 1)
    g_err = float((got - gather)[:, ms:-ms, ms:-ms].abs().max())
    k3_calls = 2 if dev.type == "cuda" else 0
    print(f"two-pass warp {tuple(shape)} fp32, max_shift {ms}: K3 launches "
          f"{launches['k3']} (want {k3_calls}), vs twin {err:.3g}, vs gather "
          f"(interior) {g_err:.3g}", flush=True)
    if launches["k3"] != k3_calls:
        fail(f"two-pass warp launched K3 {launches['k3']} times")
    if g_err > TWO_PASS_GATHER_ATOL:
        fail(f"two-pass warp vs the gather {g_err} > {TWO_PASS_GATHER_ATOL}")
    out = dict(shape=list(shape), max_shift=ms, launches_a_call=launches["k3"],
               max_abs_err=err, gather_err=g_err)
    # find_transform on synthetic matches (tests/test_stlizer.py's case)
    rng = np.random.default_rng(0)
    pts = rng.uniform(20, 300, size=(1, 64, 2)).astype(np.float32)
    c = np.full((1, 1, 2), 160.0, np.float32)
    a = np.radians(3.0)
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]], np.float32)
    pts2 = (pts - c) @ R.T + c + np.array([5.0, -3.0], np.float32)
    sh, _sc, an = sp.find_transform(*(torch.from_numpy(v).to(dev) for v in (pts, pts2, c)),
                                    torch.ones((1, 64), dtype=torch.bool, device=dev),
                                    iteration=100, sigma=2.0, disable_scale=True)
    sh, an = sh.cpu().numpy()[0], float(an[0])
    print(f"find_transform on {dev}: shift {sh.tolist()} (5, -3), angle {an:.4f} (3)",
          flush=True)
    if abs(an - 3.0) > 0.3 or abs(sh[0] - 5.0) > 0.7 or abs(sh[1] + 3.0) > 0.7:
        fail("find_transform did not recover the shift and angle")
    out["find_transform"] = dict(shift=sh.tolist(), angle=an)
    if dev.type != "cuda":
        return out
    # the gather's grid of the same transform for one F.grid_sample call
    yy, xx = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    ra = -np.radians(TWO_PASS_ANGLE)
    px, py = xx - W / 2, yy - H / 2
    sx = px * np.cos(ra) - py * np.sin(ra) + W / 2 - TWO_PASS_SHIFT[0]
    sy = px * np.sin(ra) + py * np.cos(ra) + H / 2 - TWO_PASS_SHIFT[1]
    grid = torch.stack([sx / (W - 1) * 2 - 1, sy / (H - 1) * 2 - 1], -1)[None].expand(
        B, H, W, 2).contiguous()
    xc = x.permute(0, 3, 1, 2)
    tm = compare_timed(run, plain, torch, library=lambda: F.grid_sample(
        xc, grid, mode="bilinear", padding_mode="border", align_corners=True))
    b = bound_ops(2 * x.numel() * x.element_size(), {})
    out.update(ms=tm["kernel"], plain_ms=tm["plain"], library_ms=tm["library"],
               bound_ms=b[0], bound_by=b[1])
    print(f"two-pass warp: {tm['kernel']:.3f} ms (bound {b[0]:.3f}, "
          f"{b[1]}), plain {tm['plain']:.3f}, F.grid_sample {tm['library']:.3f}", flush=True)
    return out


def hdr_check(torch, dev, shape):
    """``hdr2sdr_frames`` on a seeded uint16 batch, PQ and HLG, both
    modes: within 1 LSB of the same call on the CPU (two frames), and its
    time on the device (CUDA events, median of 3)."""
    from nunif_tpu_torch.video import hdr
    gen = torch.Generator(device=dev).manual_seed(72)
    x = torch.randint(0, 65536, shape, generator=gen, device=dev,
                      dtype=torch.int32).to(torch.uint16)
    out = {}
    for trc in (hdr.TRC_PQ, hdr.TRC_HLG):
        for mode in ("hable", "bt2390"):
            kw = dict(trc=trc, peak_nits=1000.0, mode=mode)
            y = hdr.hdr2sdr_frames(x, **kw)
            cpu = hdr.hdr2sdr_frames(x[:2].cpu(), **kw)
            d = int((y[:2].cpu().int() - cpu.int()).abs().max())
            ms = statistics.median(cuda_time(lambda: hdr.hdr2sdr_frames(x, **kw), torch)
                                   for _ in range(3)) if dev.type == "cuda" else None
            out[f"{'pq' if trc == hdr.TRC_PQ else 'hlg'} {mode}"] = dict(max_lsb=d, ms=ms)
            if d > 1:
                fail(f"HDR {trc} {mode}: the device differs from the CPU by {d} LSB")
    print(f"HDR tone map {tuple(shape)} uint16 -> uint8: {json.dumps(out)}", flush=True)
    return out


# the "waifu2x serving" phase: the other waifu2x models at their published
# widths, the web server, the tile API and the hub
SERVING_MODELS = (  # (label, registry name, input frame (h, w))
    ("cunet", "waifu2x.cunet", (1080, 1920)),
    ("upcunet", "waifu2x.upcunet", (1080, 1920)),
    ("swin_unet_v2_2x", "waifu2x.swin_unet_v2_2x", (1080, 1920)),
    ("swin_unet_v2_4x", "waifu2x.swin_unet_v2_4x", (540, 960)),
    ("wgmlp_4x", "waifu2x.wgmlp_4x", (540, 960)),
)
SERVING_TILE = 64  # the tile each model holds against the CPU
# fp32 tile, the card (cuDNN, TF32 off) against the CPU: the same products
# summed in another order, outputs in [0, 1]; read at <= 1.25e-7 on an H100,
# where a TF32 product would miss by ~1e-3
SERVING_TILE_ATOL = 1e-5
# the bf16 tile (the policy of the timed frames) against the CPU's fp32:
# read at 2.4e-3 - 4.4e-3 on an H100, the bf16 roundings of the activations
SERVING_TILE_BF16_ATOL = 1.5e-2
SWIN_FORWARD = {"fused_swin_block_image": 14, "stem_conv3x3": 1}  # a forward
DRIFT_HINT = ("python -m nunif_tpu_torch.tools.serving_drift repeats this "
              "check and names the first module whose output moved")


def serving_flax(model, seed):
    """Seeded weights in flax layout, made with numpy: kernels N(0, 0.5^2 /
    fan_in) clipped at 2 std, biases N(0, 0.02^2), norm scales 1 + N(0,
    0.02^2), the source residual at its nearest-neighbour kernel with a 0.1
    scale, 0.5 added to cunet's UNet1 output bias: the outputs stay near the
    nearest upscale (swin_unet_v2, wgmlp) or near 0.5 (cunet), mostly
    inside (0, 1)."""
    from nunif_tpu_torch.models import to_flax
    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in to_flax(model).items():
        if key.endswith("resampling"):
            a = ref
        elif key.endswith("scale_bias"):
            a = np.full(ref.shape, 0.1)
        elif key.endswith("kernel"):
            a = np.clip(rng.standard_normal(ref.shape), -2, 2) * 0.5 / np.sqrt(
                np.prod(ref.shape[:-1]))
        else:
            a = rng.normal(0.0, 0.02, ref.shape) + key.endswith("scale")
        if key == "unet1/conv_bottom/bias":
            a = a + 0.5
        flat[key] = np.asarray(a, np.float32)
    return flat


def structured_frame(h, w, seed):
    """uint8 (h, w, 3): gradients, a few flat boxes and mild noise (an
    image that PNG compresses, unlike uniform noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img = np.stack([yy, xx, 0.5 + 0.5 * np.sin(6 * (xx + yy))], -1)
    for _ in range(8):
        y0, x0 = rng.integers(0, h - h // 4), rng.integers(0, w - w // 4)
        img[y0:y0 + h // 6, x0:x0 + w // 6] = rng.random(3)
    img = img + rng.normal(0, 0.02, img.shape)
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)


def serving_renders(torch, dev, model_dir, models=SERVING_MODELS):
    """Each model from a .nztm of seeded weights: one frame through
    ``TiledRenderer.frame_program`` at the model's default tiles, timed by
    CUDA events (median of 3 after a warm frame), and one fp32 tile held
    against the same model on the CPU."""
    from nunif_tpu_torch.models import create_model, from_flax, load_model, save_model
    from nunif_tpu_torch.utils.tiling import TiledRenderer, make_tile_config
    out = {}
    for seed, (label, name, (h, w)) in enumerate(models):
        cpu = create_model(name).eval().requires_grad_(False)
        from_flax(cpu, serving_flax(cpu, seed))
        path = os.path.join(model_dir, f"{label}.nztm")
        save_model(cpu, path)
        model, meta = load_model(path, device=dev)
        if meta["name"] != name:
            fail(f"{label}: checkpoint names {meta['name']}")
        renderer = TiledRenderer(model)
        program = renderer.frame_program(h, w)
        frame = torch.from_numpy(structured_frame(h, w, seed)).to(dev)
        y = program(frame)
        s = model.i2i_scale
        if tuple(y.shape) != (h * s, w * s, 3) or y.dtype != torch.uint8:
            fail(f"{label}: frame output {tuple(y.shape)} {y.dtype}")
        yf = y.float()
        if not (20.0 < float(yf.mean()) < 235.0 and float(yf.std()) > 5.0):
            fail(f"{label}: degenerate frame (mean {float(yf.mean()):.1f}, "
                 f"std {float(yf.std()):.1f})")
        ms = [cuda_time(lambda: program(frame), torch) for _ in range(3)]
        t = model.find_valid_tile_size(None)
        cfg = make_tile_config(h, w, s, model.i2i_offset, (t, t),
                               model.i2i_blend_size)
        tile = frame[:SERVING_TILE, :SERVING_TILE].float() / 255.0
        with torch.inference_mode():
            card32 = model(tile[None])[0].cpu()
            card16 = model(tile[None].bfloat16())[0].float().cpu()
            ref = cpu(tile[None].cpu())[0]
        err32 = float((card32 - ref).abs().max())
        err16 = float((card16 - ref).abs().max())
        if not err32 <= SERVING_TILE_ATOL:
            fail(f"{label}: fp32 tile on the card vs the CPU {err32:.3g} > "
                 f"{SERVING_TILE_ATOL}")
        if not err16 <= SERVING_TILE_BF16_ATOL:
            fail(f"{label}: bf16 tile on the card vs the CPU's fp32 "
                 f"{err16:.3g} > {SERVING_TILE_BF16_ATOL}")
        out[label] = {"frame": f"{h}x{w} -> {h * s}x{w * s}",
                      "base_dim": getattr(model, "base_dim", None),
                      "tile": t, "batch": model.i2i_default_batch_size,
                      "tiles": cfg.n_tiles, "ms": statistics.median(ms),
                      "runs_ms": ms, "tile_err_fp32": err32,
                      "tile_err_bf16": err16}
        print(f"serving render {label}: {out[label]}", flush=True)
        del model, renderer, program, cpu
        torch.cuda.empty_cache()
    return out


def png_bytes(a):
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG")
    return buf.getvalue()


def post_image(url, data, timeout=300):
    """POST /api with a multipart upload: (status, content type, body, ms)."""
    import urllib.request
    b = "nunifboundary"
    body = b"".join([
        f"--{b}\r\nContent-Disposition: form-data; name=\"scale\"\r\n\r\n2\r\n".encode(),
        f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
        f"filename=\"a.png\"\r\nContent-Type: image/png\r\n\r\n".encode(),
        data, f"\r\n--{b}--\r\n".encode()])
    req = urllib.request.Request(url + "/api", data=body, headers={
        "Content-Type": f"multipart/form-data; boundary={b}"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        out = (r.status, r.headers["Content-Type"], r.read())
    return out + ((time.perf_counter() - t0) * 1e3,)


def post_tile(url, tile, tta):
    import urllib.request
    h, w = tile.shape[:2]
    req = urllib.request.Request(
        f"{url}/api/tile?w={w}&h={h}&tta={tta}&scale=2",
        data=np.ascontiguousarray(tile).tobytes(),
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, np.frombuffer(r.read(), np.float32).copy()


def serving_web(torch, dev, model_file, kernels, per_forward, work_dir,
                hw=(1080, 1920)):
    """The port's web server on ``model_file`` (127.0.0.1, port 0, in a
    thread): 4 POST /api of an hw PNG (one, two concurrent, the first
    again from the cache), each response against the renderer on the
    decoded input, exactly, and the kernels' launches exact (``per_forward``
    a forward pass, times the render's batches); /api/tile plain and with
    TTA against ``tile_forward``; GET / in Japanese; /api/tile/info."""
    import argparse
    import io
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer
    from PIL import Image
    from nunif_tpu_torch.utils import pil_io
    from nunif_tpu_torch.utils.tiling import make_tile_config
    from nunif_tpu_torch.waifu2x.unlimited import tile_forward
    from nunif_tpu_torch.waifu2x.web import (INDEX_HTML, Waifu2xWebService,
                                             make_handler)
    h, w = hw
    # an empty cache of its own, so that only the repeated request hits it
    args = argparse.Namespace(
        model_file=model_file, arch=None, tile_size=None, batch_size=None,
        noise_level=None, cache_dir=tempfile.mkdtemp(dir=work_dir),
        cache_size_mb=256, public_dir=None, device=str(dev))
    service = Waifu2xWebService(args)
    model = service.renderer.model
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    out = {"model": model.model_name}
    try:
        pngs = [png_bytes(structured_frame(h, w, 20 + i)) for i in range(3)]
        srcs = [np.asarray(Image.open(io.BytesIO(p)).convert("RGB"),
                           np.float32) / 255.0 for p in pngs]
        # the renderer on each decoded input (and a warm run), uncounted,
        # with the host's share of a request: PNG decode and encode by PIL
        refs, render_ms = [], []
        for x in srcs:
            t0 = time.perf_counter()
            refs.append(pil_io.quantize(service.render(x), 8))
            render_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        Image.open(io.BytesIO(pngs[0])).convert("RGB")
        decode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        png_bytes(refs[0])
        encode_ms = (time.perf_counter() - t0) * 1e3

        def requests():
            first = post_image(url, pngs[0])
            pair = [None, None]

            def hit(i):
                pair[i] = post_image(url, pngs[i + 1])
            t0 = time.perf_counter()
            threads = [threading.Thread(target=hit, args=(i,)) for i in (0, 1)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            pair_ms = (time.perf_counter() - t0) * 1e3
            cached = post_image(url, pngs[0])
            return [first] + pair + [cached], pair_ms
        (responses, pair_ms), launches = counted(kernels, requests)
        t = model.find_valid_tile_size(None)
        cfg = make_tile_config(h, w, model.i2i_scale, model.i2i_offset, (t, t),
                               model.i2i_blend_size)
        batches = 1 if cfg.n_tiles == 1 else -(-cfg.n_tiles // model.i2i_default_batch_size)
        want = {k: 3 * batches * per_forward.get(k, 0) for k in kernels}
        if launches != want:
            fail(f"web {model.model_name}: launches {launches}, expected {want} "
                 f"(3 renders of {batches} batches; the 4th request is cached)")
        again = pil_io.quantize(service.render(srcs[0]), 8)
        if not np.array_equal(again, refs[0]):
            fail(f"web {model.model_name}: the renderer's output for the first "
                 f"image changed while the server ran "
                 f"({int((again != refs[0]).sum())} values); {DRIFT_HINT}")
        for i, (status, ctype, body, _ms) in enumerate(responses):
            if status != 200 or ctype != "image/png":
                fail(f"web {model.model_name} request {i}: {status} {ctype}")
            got = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
            ref = refs[[0, 1, 2, 0][i]]
            if got.shape != ref.shape or not np.array_equal(got, ref):
                d = np.abs(got.astype(np.int16) - ref) if got.shape == ref.shape else None
                fail(f"web {model.model_name} request {i}: "
                     f"response differs from the renderer "
                     f"({got.shape} vs {ref.shape}; "
                     f"{'-' if d is None else f'{int((d > 0).sum())} values, max {int(d.max())}'}; "
                     f"equal to another request's reference: "
                     f"{[j for j, r in enumerate(refs) if np.array_equal(got, r)]}); "
                     f"{DRIFT_HINT}")
        if responses[3][2] != responses[0][2]:
            fail("web: the repeated request did not return the cached bytes")
        out.update(render_ms=statistics.median(render_ms[1:]),
                   png_decode_ms=decode_ms, png_encode_ms=encode_ms,
                   request_ms=responses[0][3], pair_ms=pair_ms,
                   pair_requests_per_s=2000.0 / pair_ms,
                   concurrent_ms=[responses[1][3], responses[2][3]],
                   cached_ms=responses[3][3], tiles=cfg.n_tiles,
                   batches=batches, launches=launches)

        # the unlimited tile API, plain and 8-way TTA
        tile = np.asarray(Image.open(io.BytesIO(pngs[0])).convert("RGB"),
                          np.float32)[:t, :t] / 255.0
        for tta in (0, 1):
            (status, got), tl = counted(kernels, lambda: post_tile(url, tile, tta))
            ref = tile_forward(service, tile, tta=tta).reshape(-1)
            if status != 200 or not np.array_equal(got, ref):
                fail(f"tile api tta={tta}: status {status}, max diff "
                     f"{float(np.abs(got - ref).max()) if got.shape == ref.shape else -1}")
            want = {k: (8 if tta else 1) * per_forward.get(k, 0) for k in kernels}
            if tl != want:
                fail(f"tile api tta={tta}: launches {tl}, expected {want}")
            out[f"tile_tta{tta}_launches"] = tl
        with urllib.request.urlopen(url + "/api/tile/info", timeout=60) as r:
            info = json.loads(r.read())
        if (info["name"], info["scale"], info["noise"]) != (
                model.model_name, model.i2i_scale, -1):
            fail(f"tile info {info}")
        req = urllib.request.Request(url + "/", headers={"Accept-Language": "ja"})
        with urllib.request.urlopen(req, timeout=60) as r:
            page, vary = r.read(), r.headers["Vary"]
        if page != service.pages.get("ja") or page == INDEX_HTML.encode() \
                or 'lang="ja"' not in page.decode("utf-8") or vary != "Accept-Language":
            fail("GET / with Accept-Language: ja did not return the ja page")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    print(f"serving web {model.model_name}: {out}", flush=True)
    return out


def serving_hub(torch, dev, work_dir, hw=(540, 960)):
    """``waifu2x(model_type="turbo").convert(pil)`` against the CLI's PNG
    of the same image (``--method scale``), exactly."""
    from PIL import Image
    from nunif_tpu_torch.waifu2x import cli
    from nunif_tpu_torch.waifu2x.hub import waifu2x
    src = os.path.join(work_dir, "hub_in.png")
    dst = os.path.join(work_dir, "hub_cli.png")
    Image.fromarray(structured_frame(*hw, 30)).save(src)
    t0 = time.perf_counter()
    with Image.open(src) as im:
        got = np.asarray(waifu2x(model_type="turbo", device=dev).convert(im))
    hub_ms = (time.perf_counter() - t0) * 1e3
    cli.main(["-i", src, "-o", dst, "--method", "scale", "--device", dev.type])
    with Image.open(dst) as im:
        want = np.asarray(im.convert("RGB"))
    if got.shape != want.shape or not np.array_equal(got, want):
        fail(f"hub convert differs from the CLI ({got.shape} vs {want.shape})")
    return {"hub_convert_ms": hub_ms, "size": list(got.shape)}


def serving_counts(serving, name):
    """A kernel's launches in each web server of the serving phase: its 4
    requests, one tile, one TTA tile."""
    return {run: {"requests": serving[run]["launches"][name],
                  "tile": serving[run]["tile_tta0_launches"][name],
                  "tile_tta": serving[run]["tile_tta1_launches"][name]}
            for run in ("web_swin_unet_2x", "web_turbo")}


def serving_phase(torch, dev, k1, k2, smi):
    """The "waifu2x serving" phase (see the module docstring)."""
    from nunif_tpu_torch.models import from_flax, save_model
    from nunif_tpu_torch.waifu2x.models.swin_unet import SwinUNet2x, tamed_flax_params
    from nunif_tpu_torch.waifu2x.runtime import default_model_dir
    t0 = time.perf_counter()
    kernels = {"fused_swin_block_image": k1.fused_swin_block_image,
               "stem_conv3x3": k2.stem_conv3x3}
    out = {}
    with tempfile.TemporaryDirectory() as work:
        out["renders"] = serving_renders(torch, dev, work)
        swin = SwinUNet2x()
        from_flax(swin, tamed_flax_params(swin, seed=0))
        swin_file = os.path.join(work, "scale2x.nztm")
        save_model(swin, swin_file)
        out["web_swin_unet_2x"] = serving_web(torch, dev, swin_file, kernels,
                                              SWIN_FORWARD, work)
        out["web_turbo"] = serving_web(
            torch, dev, os.path.join(default_model_dir(), "scale2x.nztm"),
            kernels, {}, work)
        out["hub"] = serving_hub(torch, dev, work)
    out["phase_s"] = time.perf_counter() - t0
    print(f"waifu2x serving: {smi}; " + json.dumps(out), flush=True)
    return out


def probe_plans(torch, probes):
    """T2's plan at both tool shapes and T4's at every tool shape, from the
    built library, with what T2 reads from L2 a call: its weights (every
    group reads all four matrices) and, for pieces 3 and 4, the bias table
    (every group reads every head's slice, rows padded to the plan's
    stride).  Counts from the plans and shapes, not measurements."""
    from nunif_tpu_torch.tools import microbench_mxu_dots as t4_tool
    from nunif_tpu_torch.tools import microbench_swin_pieces as t2_tool
    t2 = {}
    for c in (96, 192):
        g = t2_tool.default_g(c)
        h, w = t2_tool.shape(c)
        plan = probes.swin_pieces_plan(c, g)
        groups = (h // 6) * (w // 6) // g
        t2[f"C {c} G {g}"] = dict(
            plan._asdict(), groups=groups,
            l2_weight_bytes={"bf16": groups * 8 * c * c * 2, "int8": groups * 8 * c * c},
            l2_bias_bytes=groups * (c // 16) * plan.rows * plan.bstride * 4)
    t4 = {label: probes.window_dots_plan(torch.int8 if int8 else torch.bfloat16, n, c,
                                         p)._asdict()
          for label, n, c, p, int8 in t4_tool.SHAPES}
    return {"swin_pieces": t2, "window_dots_repeat": t4}


def render_twin_psnr(torch, program, frame, y, pairs):
    """PSNR of the kernel path's frame y against the same frame rendered
    with the given kernels replaced by their twins, and the share of
    identical pixels."""
    with twins(*pairs):
        y_twin = program(frame)
        torch.cuda.synchronize()
    return uint8_psnr(y, y_twin), float((y == y_twin).float().mean())


def dev_us(e):
    """A profiler event's own device time, us."""
    return getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0)


class Session:
    """A complete torch.profiler session: ``key_averages()`` and the
    (kernels recorded, kernels launched) ``counts``."""

    def __init__(self, prof, counts):
        self.key_averages = prof.key_averages
        self.counts = counts


def profiled(torch, program, frame, tries=3):
    """torch.profiler over program(frame), as a ``Session``, or None.  On
    the card's machine the profiler now and then drops kernel records in a
    long process, and a split summed from such a session reads short (a
    range at 0.0 ms); so, as ``nunif_tpu_torch.tools.device_ms`` does, a
    session counts only if it recorded a device kernel for every launch
    the host recorded (``*LaunchKernel*``), and up to ``tries`` sessions
    run."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            program(frame)
            torch.cuda.synchronize()
        events = prof.events()
        device = [e for e in events if str(e.device_type).endswith("CUDA")]
        kernels = sum(1 for e in device if e.name not in TURBO_RANGES
                      and not e.name.startswith(("Memcpy", "Memset")))
        launched = sum("LaunchKernel" in e.name for e in events
                       if not str(e.device_type).endswith("CUDA"))
        if launched and kernels >= launched:
            return Session(prof, (kernels, launched))
        print(f"profiler: a session recorded {kernels} kernels of {launched} "
              f"launched", flush=True)
    return None


def profile_frame(torch, program, frame, top=12, share_of=None, tries=3):
    """torch.profiler over one frame (a complete session, ``profiled``):
    the device time (sum over kernels), the top ops by the device time of
    the kernels they launch, and the top kernels by name (the port's own
    kernels, launched through ctypes, belong to no op and show only there);
    with ``share_of`` (label, name part), the device time and share of the
    kernels whose name holds the part.  None, and "not measured", where no
    session of ``tries`` was complete."""
    session = profiled(torch, program, frame, tries)
    if session is None:
        print("profile: not measured (every profiler session dropped records)",
              flush=True)
        return None
    events = session.key_averages()
    # the renderer's ranges may also show as device events: not kernels
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")
               and e.key not in TURBO_RANGES]
    ops = [e for e in events if not str(e.device_type).endswith("CUDA")
           and e.key not in TURBO_RANGES]
    total = sum(dev_us(e) for e in kernels)
    print(f"profile: device time {total / 1e3:.2f} ms in one frame "
          f"(kernels recorded / launched {session.counts})", flush=True)
    for label, rows in (("op", ops), ("kernel", kernels)):
        for e in sorted(rows, key=dev_us, reverse=True)[:top]:
            if dev_us(e) <= 0:
                break
            print(f"profile {label}: {dev_us(e) / 1e3:8.3f} ms "
                  f"{100 * dev_us(e) / total:5.1f}% x{e.count:<4d} "
                  f"{e.key[:110]}", flush=True)
    if share_of is not None:
        label, part = share_of
        mine = sum(dev_us(e) for e in kernels if part in e.key)
        print(f"profile: {label} {mine / 1e3:.3f} ms, {100 * mine / total:.1f}% "
              f"of the frame's device time", flush=True)
    return total / 1e3


# ---- imagenet, entry points, export and the GUI (the module entry points,
# the generic CLI tools, model export and the browser GUI)

SWIN_T_K4 = 12  # K4 launches a swin_t forward: one a block, 2 + 2 + 6 + 2
IMAGENET_BATCH, IMAGENET_HW = 64, 224
IMAGENET_RUNS = 5  # timed forwards after a warm one
# vgg11 on the card in fp32 (TF32 off) against the port's fp32 forward on
# the CPU: cuDNN's convolutions and the 25088-long fc0 sum in another order
VGG_REL_ATOL = 1e-3  # of the largest |logit|
# the child that runs a module as ``python -m`` does (runpy, as __main__)
# and prints the kernel counters of its run as the last line
RUN_COUNTED = """
import json, runpy, sys
from nunif_tpu_torch.ops import conv3x3, swin_attention, sdpa
from nunif_tpu_torch.modules import grid_sample
module = sys.argv[1]
sys.argv = sys.argv[1:]
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
except SystemExit as e:
    if e.code:
        raise
print(json.dumps({
    "stem_conv3x3": conv3x3.stem_conv3x3.launches,
    "fused_swin_block_image": swin_attention.fused_swin_block_image.launches,
    "fused_window_attention": swin_attention.fused_window_attention.launches,
    "sdpa": sdpa.sdpa.launches,
    "warp_x_bounded": grid_sample.warp_x_bounded.launches}))
"""
# the export phase's child: loads the program with nothing of the port but
# models.export, runs it on the card, prints counts and times
EXPORT_CHILD = """
import json, sys, time
import numpy as np, torch
from nunif_tpu_torch.models.export import ExportedModel
from nunif_tpu_torch.ops import conv3x3, swin_attention
path, x_path, y_path = sys.argv[1:4]
m = ExportedModel(path)
x = torch.from_numpy(np.load(x_path)).to(m.device)
sync = torch.cuda.synchronize if m.device.type == "cuda" else (lambda: None)
m(x)
sync()
conv3x3.stem_conv3x3.launches = 0
swin_attention.fused_swin_block_image.launches = 0
y = m(x)
sync()
counts = {"stem_conv3x3": conv3x3.stem_conv3x3.launches,
          "fused_swin_block_image": swin_attention.fused_swin_block_image.launches}
ms = []
for _ in range(5):
    t0 = time.perf_counter()
    m(x)
    sync()
    ms.append((time.perf_counter() - t0) * 1e3)
np.save(y_path, y.cpu().numpy())
loaded = sorted(n for n in sys.modules if n.startswith("nunif_tpu_torch."))
print(json.dumps({"launches": counts, "ms": ms, "modules": loaded,
                  "kernel_ops": sorted(set(str(n.target).split(".")[1]
                      for n in m.exported.graph.nodes
                      if str(n.target).startswith("nunif_tpu_torch.")))}))
"""
EXPORT_TILE, EXPORT_BATCH = 256, 4
W2X_ENTRY_HW = (540, 960)  # the module entry points' image (out: 1080p)
I2I_HW = GUI_HW = (1080, 1920)


def spawn(args):
    """Start a child process from the repository root."""
    return subprocess.Popen(args, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc, what, timeout=600):
    """A spawned child's stdout, or fail with its stderr's end."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode:
        fail(f"{what}: rc {proc.returncode}: {err[-3000:]}")
    return out


def child(args, what, timeout=600):
    """Run a child process from the repository root: its stdout."""
    return finish(spawn(args), what, timeout)


def timed_runs(torch, fn, runs):
    """Wall ms of ``runs`` calls of fn() each ended by a synchronise, after
    a warm call."""
    fn()
    torch_sync()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch_sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def imagenet_phase(torch, dev, k4, smi, work_dir):
    """swin_t at batch 64, 224 px, bf16, from a .nztm of seeded weights:
    K4's launches a forward (exactly 12), the logits against the same
    forward with K4's twin at K4's bf16 tolerance and the top-1 agreement,
    images a second (min and median of 5 forwards after a warm one); vgg11
    at batch 64 in bf16 (finite logits, images a second) and at batch 2 in
    fp32 against the port's fp32 forward on the CPU."""
    from nunif_tpu_torch.imagenet.models import SwinT, VGG11
    from nunif_tpu_torch.models import from_flax, load_model, save_model
    out = {}
    cpu_model = SwinT()
    from_flax(cpu_model, serving_flax(cpu_model, seed=5))
    path = os.path.join(work_dir, "swin_t.nztm")
    save_model(cpu_model, path)
    del cpu_model
    model, meta = load_model(path, device=dev)
    if meta["name"] != "imagenet.swin_t":
        fail(f"swin_t checkpoint meta {meta['name']}")
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.rand((IMAGENET_BATCH, IMAGENET_HW, IMAGENET_HW, 3), generator=gen,
                   device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        k4.fused_window_attention.launches = 0
        y = model(x)
        torch_sync()
        launches = k4.fused_window_attention.launches
        if launches != SWIN_T_K4:
            fail(f"swin_t forward launched K4 {launches} times, not {SWIN_T_K4}")
        if tuple(y.shape) != (IMAGENET_BATCH, 1000) or not bool(y.isfinite().all()):
            fail(f"swin_t logits {tuple(y.shape)} not finite")
        with twins((k4, "fused_window_attention")):
            y_twin = model(x)
        err, rel_l2 = check_close(y, y_twin, K4_TOL["bfloat16"],
                                  "swin_t logits, K4 against its twin")
        top1 = float((y.float().argmax(-1) == y_twin.float().argmax(-1)).float().mean())
        ms = timed_runs(torch, lambda: model(x), IMAGENET_RUNS)
    ips = [IMAGENET_BATCH * 1e3 / t for t in ms]
    out["swin_t"] = dict(batch=IMAGENET_BATCH, hw=IMAGENET_HW, dtype="bfloat16",
                         k4_launches=launches, max_abs_err_vs_twin=err,
                         rel_l2_vs_twin=rel_l2, top1_agreement=top1,
                         logit_absmax=float(y.float().abs().max()),
                         forward_ms=ms, images_per_s_max=max(ips),
                         images_per_s_median=statistics.median(ips))
    print(f"swin_t batch {IMAGENET_BATCH} x {IMAGENET_HW} bf16: K4 {launches} a "
          f"forward; vs K4's twin max abs err {err:.3g} rel-L2 {rel_l2:.3g}, "
          f"top-1 agreement {top1:.4f}; forward median "
          f"{statistics.median(ms):.2f} ms (min {min(ms):.2f}): "
          f"{statistics.median(ips):.1f} images/s median, {max(ips):.1f} best "
          f"({smi})", flush=True)
    del model, x, y, y_twin
    torch_empty_cache()

    cpu_vgg = VGG11()
    from_flax(cpu_vgg, vgg_flax(cpu_vgg, seed=6))
    cpu_vgg.eval().requires_grad_(False)
    vgg = VGG11()
    vgg.load_state_dict(cpu_vgg.state_dict())
    vgg = vgg.to(dev).eval().requires_grad_(False)
    x = torch.rand((IMAGENET_BATCH, IMAGENET_HW, IMAGENET_HW, 3), generator=gen,
                   device=dev)
    with torch.inference_mode():
        xb = x.to(torch.bfloat16)
        yb = vgg(xb)
        torch_sync()
        if tuple(yb.shape) != (IMAGENET_BATCH, 1000) or not bool(yb.isfinite().all()):
            fail(f"vgg11 bf16 logits {tuple(yb.shape)} not finite")
        ms_v = timed_runs(torch, lambda: vgg(xb), IMAGENET_RUNS)
        y2 = vgg(x[:2]).cpu()
        want = cpu_vgg(x[:2].cpu())
    scale = float(want.abs().max())
    verr = float((y2 - want).abs().max())
    if not verr <= VGG_REL_ATOL * scale:
        fail(f"vgg11 fp32 on the card vs the CPU: max abs err {verr} > "
             f"{VGG_REL_ATOL} x {scale}")
    ips_v = [IMAGENET_BATCH * 1e3 / t for t in ms_v]
    out["vgg11"] = dict(batch=IMAGENET_BATCH, forward_ms_bf16=ms_v,
                        images_per_s_median=statistics.median(ips_v),
                        images_per_s_max=max(ips_v), fp32_max_abs_err_vs_cpu=verr,
                        logit_absmax=scale)
    print(f"vgg11 batch {IMAGENET_BATCH} bf16: forward median "
          f"{statistics.median(ms_v):.2f} ms ({statistics.median(ips_v):.1f} "
          f"images/s); fp32 batch 2 vs CPU max abs err {verr:.3g} (|logit| <= "
          f"{scale:.3g}, limit {VGG_REL_ATOL} of it) ({smi})", flush=True)
    del vgg, cpu_vgg, x, xb, yb
    torch_empty_cache()
    return out


def vgg_flax(model, seed):
    """Seeded VGG11 weights: He-normal kernels (so the logits stay O(1)
    through 11 layers), running variances in [0.5, 2), the rest small."""
    from nunif_tpu_torch.models import to_flax
    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in to_flax(model).items():
        if key.endswith("kernel"):
            a = rng.standard_normal(ref.shape) * np.sqrt(2.0 / np.prod(ref.shape[:-1]))
        elif key.endswith("/var"):
            a = rng.uniform(0.5, 2.0, ref.shape)
        else:
            a = rng.normal(0.0, 0.1, ref.shape) + key.endswith("scale")
        flat[key] = np.asarray(a, np.float32)
    return flat


def seeded_w2x_dir(torch, work_dir):
    """A model directory whose ``scale2x.nztm`` is a tamed swin_unet_2x."""
    from nunif_tpu_torch.models import from_flax, save_model
    from nunif_tpu_torch.waifu2x.models.swin_unet import (SwinUNet2x,
                                                          tamed_flax_params)
    d = os.path.join(work_dir, "w2x_models")
    os.makedirs(d, exist_ok=True)
    m = SwinUNet2x()
    from_flax(m, tamed_flax_params(m, seed=0))
    save_model(m, os.path.join(d, "scale2x.nztm"), train_kwargs={"seed": 0})
    return d


def render_forwards(model, hw, tile_size, batch_size):
    """Forward passes of a TiledRenderer render of an hw image."""
    from nunif_tpu_torch.utils.tiling import TiledRenderer, make_tile_config
    r = TiledRenderer(model)
    tile_hw = r._tile_hw(tile_size)
    cfg = make_tile_config(hw[0], hw[1], model.i2i_scale, model.i2i_offset,
                           tile_hw, model.i2i_blend_size)
    batch = int(batch_size or model.i2i_default_batch_size)
    return -(-cfg.n_tiles // batch)


def entry_points_phase(torch, dev, k1, k2, smi, work_dir):
    """``python -m nunif_tpu_torch.waifu2x`` and ``... .iw3`` (seeded
    checkpoints, --device cuda) against ``cli.main`` on the same input;
    ``python -m nunif_tpu_torch.cli.i2i`` on a swin_unet_2x .nztm and a
    1080p PNG with its K1 / K2 launches (exact: 14 / 1 a forward pass);
    count_parameters, merge_model and show_train_args on that file."""
    from PIL import Image
    from nunif_tpu_torch.cli import count_parameters, merge_model, show_train_args
    from nunif_tpu_torch.iw3 import cli as iw3_cli_mod
    from nunif_tpu_torch.models import load_model, read_checkpoint
    from nunif_tpu_torch.waifu2x import cli as w2x_cli
    out = {}
    d = seeded_w2x_dir(torch, work_dir)
    swin_file = os.path.join(d, "scale2x.nztm")
    src = os.path.join(work_dir, "entry_in.png")
    Image.fromarray(structured_frame(*W2X_ENTRY_HW, 30)).save(src)

    def same_png(a, b, what):
        with Image.open(a) as ia, Image.open(b) as ib:
            pa, pb = np.asarray(ia), np.asarray(ib)
        if pa.shape != pb.shape or not np.array_equal(pa, pb):
            fail(f"{what}: python -m output {pa.shape} differs from cli.main's "
                 f"{pb.shape} (max diff {np.abs(pa.astype(int) - pb).max()})")
        return pa.shape

    # the three children (start-up is most of their time) run at once,
    # beside the in-process calls they are held against
    w2x_argv = ["-i", src, "--method", "scale", "--model-dir", d,
                "--device", dev.type]
    iw3_dir = os.path.join(work_dir, "iw3_models")
    os.makedirs(iw3_dir, exist_ok=True)
    iw3_models(torch, dev, iw3_dir)
    iw3_argv = ["-i", src, "--half-sbs", "--device", dev.type,
                "--depth-checkpoint", os.path.join(iw3_dir, "depth_any_v2_s.nztm"),
                "--stereo-checkpoint", os.path.join(iw3_dir, "row_flow_v3.nztm")]
    big = os.path.join(work_dir, "i2i_in.png")
    Image.fromarray(structured_frame(*I2I_HW, 31)).save(big)
    t0 = time.perf_counter()
    procs = {
        "waifu2x": spawn([sys.executable, "-m", "nunif_tpu_torch.waifu2x",
                          *w2x_argv, "-o", os.path.join(work_dir, "waifu2x_m.png")]),
        "iw3": spawn([sys.executable, "-m", "nunif_tpu_torch.iw3", *iw3_argv,
                      "-o", os.path.join(work_dir, "iw3_m.png")]),
        "i2i": spawn([sys.executable, "-c", RUN_COUNTED, "nunif_tpu_torch.cli.i2i",
                      "-m", swin_file, "-i", big, "-o",
                      os.path.join(work_dir, "i2i.png"), "--device", dev.type])}
    w2x_cli.main(w2x_argv + ["-o", os.path.join(work_dir, "waifu2x_c.png")])
    iw3_cli_mod.main(iw3_argv + ["-o", os.path.join(work_dir, "iw3_c.png")])
    stdout = {k: finish(p, f"python -m ({k})") for k, p in procs.items()}
    children_s = time.perf_counter() - t0
    for app in ("waifu2x", "iw3"):
        out[app] = {"out_shape": list(same_png(
            os.path.join(work_dir, f"{app}_m.png"),
            os.path.join(work_dir, f"{app}_c.png"), app))}
    counts = json.loads(stdout["i2i"].strip().splitlines()[-1])
    model, _meta = load_model(swin_file, device=dev)
    forwards = render_forwards(model, I2I_HW, None, None)
    want = {"stem_conv3x3": forwards, "fused_swin_block_image": 14 * forwards}
    got = {k: counts[k] for k in want}
    if got != want:
        fail(f"i2i launches {counts}, expected {want}")
    from nunif_tpu_torch.utils.pil_io import load_image
    from nunif_tpu_torch.utils.tiling import TiledRenderer
    x, _ = load_image(big)
    ref = TiledRenderer(model).render(torch.from_numpy(x[..., :3]).to(dev))
    ref = (ref.clamp(0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
    with Image.open(os.path.join(work_dir, "i2i.png")) as im:
        got_px = np.array(im)
    p = uint8_psnr(torch.from_numpy(got_px), torch.from_numpy(ref))
    if got_px.shape != (2 * I2I_HW[0], 2 * I2I_HW[1], 3) or p < FRAME_PSNR_MIN:
        fail(f"i2i output {got_px.shape}, PSNR {p} against the renderer")
    out["i2i"] = {"launches": counts, "forwards": forwards,
                  "psnr_vs_renderer": p}
    out["children_wall_s"] = children_s
    print(f"i2i 1080p -> 4K (python -m, swin_unet_2x): launches {got} "
          f"({forwards} forward passes); PSNR vs the renderer {p:.2f} dB "
          f"({smi})", flush=True)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        count_parameters.main(["-m", swin_file, "--device", dev.type])
        show_train_args.main(["-m", swin_file])
    text = buf.getvalue()
    total = sum(a.size for a in read_checkpoint(swin_file)[1].values())
    if not text.startswith(f"waifu2x.swin_unet_2x: {total:,} parameters") \
            or '"train_kwargs": {\n    "seed": 0\n  }' not in text:
        fail(f"count_parameters / show_train_args printed {text[:300]!r}")
    merged = os.path.join(work_dir, "merged.nztm")
    with contextlib.redirect_stderr(io.StringIO()):
        merge_model.main(["-i", swin_file, swin_file, "-o", merged])
    a, b = read_checkpoint(swin_file)[1], read_checkpoint(merged)[1]
    if sorted(a) != sorted(b) or not all(np.array_equal(a[k], b[k]) for k in a):
        fail("merge_model of a file with itself changed its parameters")
    out["tools"] = {"parameters": total}
    print(f"entry points: python -m waifu2x / iw3 equal to cli.main; the "
          f"three children {children_s:.1f} s at once, start-up included; "
          f"count_parameters {total:,}, show_train_args, merge_model ran",
          flush=True)
    del model
    torch_empty_cache()
    return out, d


def export_phase(torch, dev, k1, k2, smi, work_dir, w2x_dir):
    """swin_unet_2x exported at tile 256, batch 4 (bf16, weights in
    params.npz), loaded and run on the card in a child process that imports
    only ``nunif_tpu_torch.models.export``: its K1 / K2 launches (14 / 1)
    and its output against the eager model's, which must be equal."""
    from nunif_tpu_torch.models import load_model
    from nunif_tpu_torch.models.export import export_model, kernel_ops
    model, _meta = load_model(os.path.join(w2x_dir, "scale2x.nztm"), device=dev)
    path = os.path.join(work_dir, "swin_unet_2x.pt2")
    shape = (EXPORT_BATCH, EXPORT_TILE, EXPORT_TILE, 3)
    t0 = time.perf_counter()
    program = export_model(model, path, shape)
    export_s = time.perf_counter() - t0
    ops = kernel_ops(program)
    if ops != ["stem_conv3x3"] + ["fused_swin_block_image"] * 14:
        fail(f"exported graph's kernel ops {ops}")
    # each kernel node reads its packed weights from the program's inputs
    # (layouts.pt2 makes them at load), so a call packs nothing
    packs = [n.args[11] if "swin" in str(n.target) else n.args[3]
             for n in program.graph.nodes
             if str(n.target).startswith("nunif_tpu_torch.")]
    if not all(p and all(a.op == "placeholder" for a in p) for p in packs):
        fail("the exported program packs its kernels' weights on every call")
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.rand(shape, generator=gen, device=dev)
    np.save(os.path.join(work_dir, "export_x.npy"), x.cpu().numpy())
    res = json.loads(child(
        [sys.executable, "-c", EXPORT_CHILD, path,
         os.path.join(work_dir, "export_x.npy"),
         os.path.join(work_dir, "export_y.npy")], "exported program"
    ).strip().splitlines()[-1])
    if any(n.split(".")[1] in ("waifu2x", "iw3", "imagenet") for n in res["modules"]):
        fail(f"the export child imported model modules: {res['modules']}")
    if res["launches"] != {"stem_conv3x3": 1, "fused_swin_block_image": 14}:
        fail(f"exported program launches {res['launches']}")
    with torch.inference_mode():
        k1.fused_swin_block_image.launches = k2.stem_conv3x3.launches = 0
        want = model(x.to(torch.bfloat16)).float()
        torch_sync()
        eager_launches = (k2.stem_conv3x3.launches,
                          k1.fused_swin_block_image.launches)
        eager_ms = timed_runs(torch, lambda: model(x.to(torch.bfloat16)).float(), 5)
    got = torch.from_numpy(np.load(os.path.join(work_dir, "export_y.npy"))).to(dev)
    diff = float((got - want).abs().max())
    if tuple(got.shape) != tuple(want.shape) or diff != 0.0:
        fail(f"exported program vs eager: shape {tuple(got.shape)} / "
             f"{tuple(want.shape)}, max abs diff {diff}")
    out = {"export_s": export_s, "launches": res["launches"],
           "eager_launches": eager_launches, "max_abs_diff_vs_eager": diff,
           "program_ms": res["ms"], "eager_ms": eager_ms,
           "kernel_ops": res["kernel_ops"],
           "file_bytes": os.path.getsize(path)}
    print(f"export swin_unet_2x {shape} bf16: traced and saved in {export_s:.1f} s "
          f"({out['file_bytes']} bytes); the child's run launched "
          f"{res['launches']}; vs eager max abs diff {diff}; program median "
          f"{statistics.median(res['ms']):.2f} ms, eager "
          f"{statistics.median(eager_ms):.2f} ms a batch ({smi})", flush=True)
    del model, program, x, got, want
    torch_empty_cache()
    return out


def gui_phase(torch, dev, k1, k2, k3, k7, smi, work_dir, w2x_dir):
    """An in-process ``GuiService`` on the card with seeded slots
    (swin_unet_2x for waifu2x; Any_V2_S and row_flow_v3 for iw3), served on
    127.0.0.1: a waifu2x job and an iw3 job on a 1080p PNG over HTTP, the
    progress read from /api/progress, each result PNG equal to the direct
    ``Waifu2x.convert`` / ``process_image`` call on the decoded image, the
    kernels' launches a job and its decode / render / encode split."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer
    from PIL import Image
    from nunif_tpu_torch.gui import server
    from nunif_tpu_torch.iw3.composition import StereoFormat
    from nunif_tpu_torch.iw3.pipeline import StereoConfig, process_image
    from nunif_tpu_torch.waifu2x.hub import Waifu2xImageModel
    os.environ["NUNIF_TPU_GUI_DIR"] = os.path.join(work_dir, "gui_settings")
    service = server.GuiService(lang="en", device=dev)
    service._w2x = Waifu2xImageModel(model_dir=w2x_dir, device=dev)
    iw3_dir = os.path.join(work_dir, "iw3_models")
    dm, flow = iw3_models(torch, dev, iw3_dir)
    service._iw3 = ("Any_V2_S", dm)
    service._side["row_flow_v3"] = flow
    srv = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(service))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    kernels = {"stem_conv3x3": k2.stem_conv3x3,
               "fused_swin_block_image": k1.fused_swin_block_image,
               "sdpa": k7.sdpa, "warp_x_bounded": k3.warp_x_bounded}
    png = png_bytes(structured_frame(*GUI_HW, 40))
    x = torch.from_numpy(np.asarray(Image.open(io.BytesIO(png)).convert("RGB"),
                                    np.float32) / 255.0).to(dev)
    b = "guiboundary"

    def run_job(kind, fields):
        body = b"".join(
            [f"--{b}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n"
             f"{v}\r\n".encode() for k, v in fields.items()]
            + [f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
               f"filename=\"in.png\"\r\nContent-Type: image/png\r\n\r\n".encode(),
               png, f"\r\n--{b}--\r\n".encode()])
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        req = urllib.request.Request(
            f"{url}/api/{kind}", data=body,
            headers={"Content-Type": f"multipart/form-data; boundary={b}"})
        with urllib.request.urlopen(req, timeout=600) as r:
            job_id = json.loads(r.read())["job_id"]
        events = []
        with urllib.request.urlopen(f"{url}/api/progress?job={job_id}",
                                    timeout=600) as r:
            for line in r:
                if line.startswith(b"data: "):
                    events.append(json.loads(line[6:]))
                    if events[-1]["done"]:
                        break
        with urllib.request.urlopen(f"{url}/api/result/{job_id}", timeout=600) as r:
            status, result = r.status, r.read()
        wall = time.perf_counter() - t0
        torch_sync()
        launches = {name: k.launches for name, k in kernels.items()}
        if status != 200 or events[-1].get("error") or not events[-1]["done"]:
            fail(f"gui {kind} job: status {status}, last event {events[-1]}")
        px = np.asarray(Image.open(io.BytesIO(result)))
        return px, launches, wall, service.get_job(job_id).times, events

    out = {}
    try:
        for run in range(2):  # the first warms the slots
            px, launches, wall, times, events = run_job(
                "waifu2x", {"method": "scale", "noise_level": "0"})
        with torch.inference_mode():
            want = service._w2x.w2x.convert(x, None, method="scale")[0]
        want = server.quantize_u8(want.cpu().numpy())
        if px.shape != want.shape or not np.array_equal(px, want):
            fail(f"gui waifu2x PNG {px.shape} differs from Waifu2x.convert "
                 f"{want.shape}")
        model = service._w2x.w2x.load_model("scale", None)[0]
        fw = render_forwards(model, GUI_HW, None, None)
        expect = {"stem_conv3x3": fw, "fused_swin_block_image": 14 * fw,
                  "sdpa": 0, "warp_x_bounded": 0}
        if launches != expect:
            fail(f"gui waifu2x job launches {launches}, expected {expect}")
        out["waifu2x"] = {"launches": launches, "wall_s": wall, "times_s": times,
                          "progress": [e["desc"] for e in events]}
        for run in range(2):
            px, launches, wall, times, events = run_job(
                "iw3", {"method": "row_flow_v3", "divergence": "2.0",
                        "convergence": "0.5", "stereo_format": "half_sbs",
                        "depth_model": "Any_V2_S"})
        cfg = StereoConfig(method="row_flow_v3", divergence=2.0, convergence=0.5,
                           format=StereoFormat.from_name("half_sbs"))
        want = process_image(x, cfg, dm, side_model=flow)
        want = server.quantize_u8(want.float().cpu().numpy())
        if px.shape != want.shape or not np.array_equal(px, want):
            fail(f"gui iw3 PNG {px.shape} differs from process_image {want.shape}")
        expect = {"stem_conv3x3": 0, "fused_swin_block_image": 0, "sdpa": 12,
                  "warp_x_bounded": 1}
        if launches != expect:
            fail(f"gui iw3 job launches {launches}, expected {expect}")
        out["iw3"] = {"launches": launches, "wall_s": wall, "times_s": times,
                      "progress": [e["desc"] for e in events]}
    finally:
        srv.shutdown()
    for kind, r in out.items():
        print(f"gui {kind} job 1080p PNG over HTTP: launches {r['launches']}; "
              f"wall {r['wall_s']:.3f} s = " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in r["times_s"].items())
              + f" + HTTP and queueing; PNG equal to the direct call ({smi})",
              flush=True)
    del service, dm, flow
    torch_empty_cache()
    return out


# the "waifu2x training" phase: the CLI's defaults (swin_unet_2x at base
# 96, tile find_valid_tile_size(104) = 112, batch 16, loss lbp, adam)
TRAIN_BASE, TRAIN_TILE, TRAIN_BATCH, TRAIN_SEED = 96, 112, 16, 71
TRAIN_LR = 1e-4
TRAIN_CLI_SAMPLES, TRAIN_CLI_EPOCHS = 320, 2
TRAIN_RENDER_HW = (540, 960)


def train_grads(torch, model, x, y, loss_fn, dtype, counted):
    """(loss, {name: gradient}, forward launches, backward launches, fwd +
    bwd ms) of one training forward of x in ``dtype`` and the backward of
    the loss on its fp32 output; ``counted``: the (module, kernel name)
    pairs whose launches are read."""
    for p in model.parameters():
        p.grad = None
    for mod, name in counted:
        getattr(mod, name).launches = 0
    torch_sync()
    t0 = time.perf_counter()
    pred = model(x.to(dtype), train=True)
    torch_sync()
    fwd = {name: getattr(mod, name).launches for mod, name in counted}
    loss = loss_fn(pred.float(), y)
    loss.backward()
    torch_sync()
    ms = (time.perf_counter() - t0) * 1e3
    bwd = {name: getattr(mod, name).launches - fwd[name]
           for mod, name in counted}
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    return float(loss.detach()), grads, fwd, bwd, ms


def grad_errors(torch, got, want):
    """{name: (relative L2 error, cosine)} of two gradient dicts."""
    out = {}
    for n, w in want.items():
        g = got[n]
        wn = float(w.norm())
        rel = float((g - w).norm()) / wn if wn else float((g - w).norm())
        cos = float((g * w).sum()) / max(float(g.norm()) * wn, 1e-30)
        out[n] = (rel, cos)
    return out


def train_step_check(torch, dev, k1, k2):
    """Part (a) of the training phase: kernel path against twin path on
    one batch, the zero-bias control, one Adam step on each path, the packs
    remade after it."""
    import random
    from nunif_tpu_torch.models import from_flax
    from nunif_tpu_torch.ops.swin_attention import packed_list
    from nunif_tpu_torch.training.optimizers import create_optimizer
    from nunif_tpu_torch.training.schedules import constant_lr
    from nunif_tpu_torch.waifu2x.models.swin_unet import (SwinUNet2x,
                                                          tamed_flax_params)
    from nunif_tpu_torch.waifu2x.training.dataset import Waifu2xDataset
    from nunif_tpu_torch.waifu2x.training.trainer import create_criterion

    # the tamed weights: from flax's init the network is chaotic, and its
    # own bf16 gradients are off its fp32 ones by ~100% (cosines below 0),
    # so no bound drawn from that error could tell a fault from noise
    model = SwinUNet2x(base_dim=TRAIN_BASE)
    from_flax(model, tamed_flax_params(model, seed=0))
    model.to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_SEED)
    tables = [m.relative_position_bias_table for m in model.modules()
              if hasattr(m, "relative_position_bias_table")]
    with torch.no_grad():
        # std 1, as the kernel checks draw them: at 0.02 a kernel without
        # the bias would stay within bf16's error
        for t in tables:
            t.normal_(0.0, 1.0, generator=gen)
    model.requires_grad_(True)
    n_params = sum(p.numel() for p in model.parameters())
    random.seed(TRAIN_SEED)
    ds = Waifu2xDataset(None, model_offset=model.i2i_offset, scale_factor=2,
                        tile_size=TRAIN_TILE, synthetic_p=1.0,
                        num_samples=TRAIN_BATCH, training=True, seed=TRAIN_SEED)
    batch = next(iter(ds.batches(TRAIN_BATCH, n_threads=1)))
    x = torch.from_numpy(batch["x"]).to(dev)
    y = torch.from_numpy(batch["y"]).to(dev)
    loss_fn = create_criterion("lbp")
    pairs = ((k1, "fused_swin_block_image"), (k2, "stem_conv3x3"))
    bf16 = torch.bfloat16

    loss_k, g_k, fwd, bwd, ms_k = train_grads(torch, model, x, y, loss_fn,
                                              bf16, pairs)
    loss_k2, g_k2, _f, _b, ms_k2 = train_grads(torch, model, x, y, loss_fn,
                                               bf16, pairs)
    with twins(*pairs):
        loss_t, g_t, fwd_t, _b, ms_t = train_grads(torch, model, x, y,
                                                   loss_fn, bf16, pairs)
        loss_32, g_32, _f, _b, ms_32 = train_grads(torch, model, x, y,
                                                   loss_fn, torch.float32,
                                                   pairs)
    print(f"train step: swin_unet_2x base {TRAIN_BASE} ({n_params} "
          f"parameters), batch {TRAIN_BATCH} x {TRAIN_TILE}^2, loss lbp; "
          f"loss kernel path {loss_k:.6f} (again {loss_k2:.6f}), twin path "
          f"{loss_t:.6f}, twin fp32 {loss_32:.6f}; launches forward {fwd} "
          f"backward {bwd}; fwd+bwd ms kernel {ms_k:.1f} / {ms_k2:.1f}, "
          f"twin {ms_t:.1f}, twin fp32 {ms_32:.1f}", flush=True)
    if fwd != {"fused_swin_block_image": 14, "stem_conv3x3": 1} or \
            bwd != {"fused_swin_block_image": 0, "stem_conv3x3": 0}:
        fail(f"training forward launches {fwd}, backward {bwd}: expected "
             "K1 14 / K2 1 a forward and none in the backward")
    if fwd_t != {"fused_swin_block_image": 0, "stem_conv3x3": 0}:
        fail(f"twin path launched kernels: {fwd_t}")
    if not all(np.isfinite(v) for v in (loss_k, loss_t, loss_32)):
        fail(f"non-finite loss: {loss_k} {loss_t} {loss_32}")
    if not all(bool(g.isfinite().all()) for g in g_k.values()):
        fail("non-finite gradient on the kernel path")

    # the bound of each tensor: the twin path's own bf16 error against its
    # fp32 gradient (the kernels differ from the twins by bf16 roundings)
    own = grad_errors(torch, g_t, g_32)
    err = grad_errors(torch, g_k, g_t)
    ratio = {n: err[n][0] / max(own[n][0], 1e-30) for n in err}
    worst = max(ratio, key=ratio.get)
    worst_rel = max(err, key=lambda n: err[n][0])
    worst_cos = min(err, key=lambda n: err[n][1])
    print(f"train grads kernel vs twin: worst rel / own bf16 error "
          f"{ratio[worst]:.3f} ({worst}: rel {err[worst][0]:.3g}, own "
          f"{own[worst][0]:.3g}); worst rel {err[worst_rel][0]:.3g} "
          f"({worst_rel}); worst cosine {err[worst_cos][1]:.6f} "
          f"({worst_cos}); loss rel diff {abs(loss_k - loss_t) / abs(loss_t):.3g}",
          flush=True)
    if ratio[worst] > 1.0:
        fail(f"kernel-path gradient of {worst} off the twin path by "
             f"{err[worst][0]:.3g} relative, beyond the twin's own bf16 "
             f"error {own[worst][0]:.3g}")

    # control: the kernel path without the relative bias must fail it
    saved = [t.detach().clone() for t in tables]
    with torch.no_grad():
        for t in tables:
            t.zero_()
    _l, g_c, _f, _b, _ms = train_grads(torch, model, x, y, loss_fn, bf16, pairs)
    with torch.no_grad():
        for t, v in zip(tables, saved):
            t.copy_(v)
    ctrl = grad_errors(torch, g_c, g_t)
    ctrl_ratio = max(ctrl[n][0] / max(own[n][0], 1e-30) for n in ctrl)
    print(f"train grads zero-bias control: worst rel / own bf16 error "
          f"{ctrl_ratio:.3f}", flush=True)
    if ctrl_ratio <= 1.0:
        fail("the zero-bias kernel path passes the gradient check: the "
             "check is blind")

    # one Adam step on each path from the same parameters
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    blocks = [m for m in model.modules() if hasattr(m, "packed_weights")]
    after = {}
    for name, grads in (("kernel", g_k), ("twin", g_t)):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(start[n])
        with torch.no_grad():
            before = [m.packed_weights(bf16) for m in blocks]
            biases = [m.attn.relative_bias() for m in blocks
                      if hasattr(m, "attn")]
        opt = create_optimizer("adam", model, constant_lr(TRAIN_LR))
        opt.step(grads)
        after[name] = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            packs = [m.packed_weights(bf16) for m in blocks]
            fresh = [m.kernel_layout(bf16) for m in blocks]
            new_biases = [m.attn.relative_bias() for m in blocks
                          if hasattr(m, "attn")]
        for m, a, b, f in zip(blocks, before, packs, fresh):
            got = packed_list(b) if hasattr(b, "mats") else list(b)
            if b is a or not all(torch.equal(u, v) for u, v in zip(got, f)):
                fail(f"{type(m).__name__}: the weight pack after the step is "
                     "stale or differs from a fresh pack")
        for m, a, b in zip([m for m in blocks if hasattr(m, "attn")], biases,
                           new_biases):
            if b is a or not torch.equal(b, m.attn.kernel_layout()[0]):
                fail("the gathered relative bias after the step is stale")
    step = max(float((after["kernel"][n] - start[n]).abs().max()) for n in start)
    diff = {n: (after["kernel"][n] - after["twin"][n]).abs() for n in start}
    max_diff = max(float(d.max()) for d in diff.values())
    share = sum(int((d > 0.1 * TRAIN_LR).sum()) for d in diff.values()) / n_params
    print(f"train adam step (lr {TRAIN_LR}): largest update {step:.3g}; "
          f"kernel vs twin parameters max diff {max_diff:.3g}, share beyond "
          f"0.1 lr {share:.3g}; packs of {len(blocks)} modules remade and "
          "equal to fresh ones", flush=True)
    # Adam's first update is lr g / (|g| + eps): two paths differ by at
    # most 2 lr, where a gradient element changes sign
    if not 0.5 * TRAIN_LR < step <= 1.001 * TRAIN_LR or \
            max_diff > 2.002 * TRAIN_LR or share > 0.01:
        fail(f"adam step: update {step}, max diff {max_diff}, share {share}")
    out = {"loss_kernel": loss_k, "loss_twin": loss_t, "loss_twin_fp32": loss_32,
           "forward_launches": fwd, "backward_launches": bwd,
           "worst_rel_over_own": ratio[worst], "worst_rel": err[worst_rel][0],
           "worst_cos": err[worst_cos][1], "control_rel_over_own": ctrl_ratio,
           "adam_max_param_diff": max_diff, "adam_share_beyond": share,
           "fwd_bwd_ms": {"kernel": [ms_k, ms_k2], "twin": ms_t,
                          "twin_fp32": ms_32}, "parameters": n_params}
    del model, g_k, g_k2, g_t, g_32, g_c, after, start
    torch_empty_cache()
    return out


def train_cli_args(model_dir, extra=()):
    return ["waifu2x", "--arch", "waifu2x.swin_unet_2x", "--synthetic-p", "1.0",
            "--num-samples", str(TRAIN_CLI_SAMPLES), "--batch-size",
            str(TRAIN_BATCH), "--max-epoch", str(TRAIN_CLI_EPOCHS),
            "--model-dir", model_dir, "--seed", str(TRAIN_SEED), *extra]


def tamed_checkpoint(torch, model_dir):
    """The trainer's checkpoint before its first epoch, at the tamed
    seeded weights, written through the trainer app the CLI builds: with
    ``--resume`` the CLI then trains from weights whose output is not
    chaotic (from flax's init a norm-free swin_unet's pre-clip output has
    a std in the hundreds).  Returns the eval Y-PSNR of that start on the
    CLI's eval set, in dB."""
    from nunif_tpu_torch.models import from_flax
    from nunif_tpu_torch.train import create_parser
    from nunif_tpu_torch.waifu2x.models.swin_unet import tamed_flax_params
    from nunif_tpu_torch.waifu2x.training.trainer import Waifu2xTrainerApp
    args = create_parser().parse_args(train_cli_args(model_dir))
    app = Waifu2xTrainerApp(args)
    from_flax(app.model, tamed_flax_params(app.model, seed=0))
    app.trainer.save_checkpoint()
    start = -app.trainer.evaluate(
        lambda: app.eval_ds.batches(args.batch_size, n_threads=args.num_workers))
    del app
    torch_empty_cache()
    return start


def train_cli_run(torch, dev, k1, k2, work_dir, tamed, extra=(), name=None,
                  rise=True):
    """Part (b): ``python -m nunif_tpu_torch.train waifu2x`` at its
    defaults (plus ``extra`` flags) in a child, its epoch lines, and its
    exported model rendered through TiledRenderer.  ``tamed``: resumed from
    ``tamed_checkpoint``; with ``rise`` its last epoch's eval Y-PSNR must
    rise above the start's, and its render must hold to the twins' at
    FRAME_PSNR_MIN.  ``name``: the model directory under work_dir."""
    from nunif_tpu_torch.models import load_model
    from nunif_tpu_torch.utils.tiling import TiledRenderer
    model_dir = os.path.join(work_dir, name or (
        "train_w2x_tamed" if tamed else "train_w2x"))
    start_psnr = tamed_checkpoint(torch, model_dir) if tamed else None
    t0 = time.perf_counter()
    out = child([sys.executable, "-m", "nunif_tpu_torch.train",
                 *train_cli_args(model_dir, (("--resume",) if tamed else ())
                                 + tuple(extra))],
                "train CLI", timeout=900)
    wall = time.perf_counter() - t0
    epochs = [json.loads(line[len("train: "):]) for line in out.splitlines()
              if line.startswith("train: ")]
    exported = [json.loads(line[len("exported: "):]) for line in out.splitlines()
                if line.startswith("exported: ")]
    if len(epochs) != TRAIN_CLI_EPOCHS or not exported:
        fail(f"train CLI printed {len(epochs)} epochs: {out[-2000:]}")
    for e in epochs:
        if not (np.isfinite(e["train_loss"]) and e["eval_y_psnr"] is not None
                and np.isfinite(e["eval_y_psnr"])) or e["nan_count"] \
                or not e["device"].startswith("cuda"):
            fail(f"train CLI epoch {e}")
    psnrs = [e["eval_y_psnr"] for e in epochs]
    if tamed and rise and not psnrs[-1] > start_psnr:
        fail(f"train CLI from the tamed weights: eval Y-PSNR {psnrs} dB did "
             f"not rise above the start's {start_psnr} dB")
    files = exported[0]["files"]
    if "waifu2x_swin_unet_2x.nztm" not in files:
        fail(f"train CLI exported {files}")
    model, meta = load_model(os.path.join(model_dir, "waifu2x_swin_unet_2x.nztm"),
                             device=dev)
    h, w = TRAIN_RENDER_HW
    frame = torch.from_numpy(structured_frame(h, w, 3)).to(dev)
    program = TiledRenderer(model).frame_program(h, w)
    k1.fused_swin_block_image.launches = k2.stem_conv3x3.launches = 0
    y = program(frame)
    torch_sync()
    launches = {"fused_swin_block_image": k1.fused_swin_block_image.launches,
                "stem_conv3x3": k2.stem_conv3x3.launches}
    if tuple(y.shape) != (2 * h, 2 * w, 3) or y.dtype != torch.uint8 \
            or not launches["stem_conv3x3"] \
            or launches["fused_swin_block_image"] != 14 * launches["stem_conv3x3"]:
        fail(f"render of the trained model: {tuple(y.shape)} {y.dtype}, "
             f"launches {launches}")
    res = {"epochs": epochs, "wall_s": wall, "best_eval_y_psnr":
           exported[0]["best_eval_y_psnr"], "render_launches": launches,
           "train_kwargs_seed": meta["train_kwargs"]["seed"],
           "start_eval_y_psnr": start_psnr}
    if tamed:
        # from flax's init the trained net is chaotic and its bf16 frame is
        # no closer to the twins' than noise: only the tamed run is held
        psnr, _same = render_twin_psnr(torch, program, frame, y, (
            (k2, "stem_conv3x3"), (k1, "fused_swin_block_image")))
        if psnr < FRAME_PSNR_MIN:
            fail(f"render of the model trained from the tamed weights: PSNR "
                 f"vs twins {psnr:.2f} dB < {FRAME_PSNR_MIN}")
        res["render_psnr_vs_twins"] = psnr
    del model, program
    torch_empty_cache()
    return res


def training_phase(torch, dev, k1, k2, smi, work_dir):
    step = train_step_check(torch, dev, k1, k2)
    out = {"step": step}
    for start, tamed in (("flax init", False), ("tamed", True)):
        cli = out["cli_tamed" if tamed else "cli"] = train_cli_run(
            torch, dev, k1, k2, work_dir, tamed)
        last = cli["epochs"][-1]
        held = (f", vs twins {cli['render_psnr_vs_twins']:.2f} dB; eval "
                f"Y-PSNR at the start {cli['start_eval_y_psnr']:.3f} dB"
                if tamed else "")
        print(f"train CLI from {start} ({smi}): {TRAIN_CLI_EPOCHS} epochs of "
              f"{TRAIN_CLI_SAMPLES} samples in {cli['wall_s']:.1f} s wall; last "
              f"epoch {last['steps_per_second']:.3f} steps/s, "
              f"{last['samples_per_second']:.2f} samples/s, data wait "
              f"{last['data_wait_share']:.3f} of the epoch, peak memory "
              f"{(last['peak_memory_bytes'] or 0) / 2 ** 30:.2f} GiB; losses "
              f"{[round(e['train_loss'], 5) for e in cli['epochs']]}, eval Y-PSNR "
              f"{[round(e['eval_y_psnr'], 3) for e in cli['epochs']]} dB; render "
              f"launches {cli['render_launches']}{held}", flush=True)
    return out


# the "feature losses and GAN" phase: swin_unet_2x's training output at
# the trainer's defaults is 16 x 192^2, which the DINOv2 loss pads to 196^2
# (197 tokens a head).  K7's gradient bar is the twin's own bf16-vs-fp32
# error times K7_GRAD_BAR, the bar of the K1 / K2 gradient check: the pool
# loss's gradient is a sign where the features meet, and a single bf16
# rounding of the attention moves it by 0.74 of the whole trunk's bf16
# error (the kernel's rounding, k7_rounding_model, on the CPU); the control
# runs the twin at a scale off by K7_SCALE_CONTROL (3.5x the error there)
FEAT_BATCH, FEAT_HW = 16, 192
K7_GRAD_BAR, K7_SCALE_CONTROL = 1.0, 2.0
L1DINO_SAMPLES = 160  # a CLI epoch of 10 steps
# a training forward of swin_unet_2x on l1dinov2: K1 14 and K2 1 in the
# generator, K7 12 on the output branch and 12 on the detached target
L1DINO_FORWARD = {"fused_swin_block_image": 14, "stem_conv3x3": 1, "sdpa": 24}
OTHER_FEATURE_LOSSES = ("l1lpips", "l1lpips_std_mask", "l1lpips_dct24",
                        "l1dinov2_10", "yrgb_lbp_dinov2", "l1l4sn", "l1l4sn2",
                        "l1l4sn_swd")
# the inpaint GAN CLI at its defaults (batch GAN_BATCH, 128 px): GAN_STEPS
# steps, the adversarial weight gated off before step GAN_START
GAN_BATCH, GAN_STEPS, GAN_START = 16, 24, 8
GAN_RENDER_HW = (1080, 1920)
GAN_VIDEO_CLIPS = 4


def rel_l2(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def k7_rounding_model(torch):
    """sdpa with K7's rounding points in plain PyTorch: the unnormalised
    probabilities exp(s - max) rounded to q's dtype for P V, the row sum
    and the division in fp32, the output rounded once (the twin rounds the
    normalised probabilities)."""
    def sdpa(q, k, v, scale=None):
        scale = scale or q.shape[-1] ** -0.5
        s = torch.einsum("bhnd,bhmd->bhnm", (q * scale).float(), k.float())
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bhnm,bhmd->bhnd", p.to(q.dtype).float(), v.float())
        return (o / p.sum(-1, keepdim=True)).to(q.dtype)
    return sdpa


def k7_grad_check(torch, dev, k7):
    """Part (a): the gradient of the DINOv2 pool loss with respect to a
    fixed bf16 batch of generator outputs through K7 against the twin path
    (K7's twin on the card), held to K7_GRAD_BAR times the twin's own
    bf16-vs-fp32 error, with the wrong-scale control failing that bar."""
    from nunif_tpu_torch.modules import dinov2_loss as D
    flat = D.seeded_trunk_params("vits", seed=0)
    gen = torch.Generator(device=dev).manual_seed(25)
    shape = (FEAT_BATCH, FEAT_HW, FEAT_HW, 3)
    x = torch.rand(shape, generator=gen, device=dev).to(torch.bfloat16)
    y = (x.float() + 0.05 * torch.randn(shape, generator=gen, device=dev)).clamp(0, 1)
    loss16 = D.dinov2_feature_loss("pool", params=flat)
    loss32 = D.dinov2_feature_loss("pool", params=flat, dtype=torch.float32)

    def grad(fn, inp):
        xx = inp.detach().clone().requires_grad_(True)
        k7.sdpa.launches = 0
        torch_sync()
        t0 = time.perf_counter()
        v = fn(xx, y)
        torch_sync()
        fwd = k7.sdpa.launches
        v.backward()
        torch_sync()
        ms = (time.perf_counter() - t0) * 1e3
        return float(v), xx.grad.float(), fwd, k7.sdpa.launches - fwd, ms

    grad(loss16, x)  # warm: the trunk moves to the card, cuDNN picks
    v_k, g_k, fwd, bwd, ms_k = grad(loss16, x)
    with twins((k7, "sdpa")):
        v_t, g_t, fwd_t, _b, ms_t = grad(loss16, x)
        v_32, g_32, _f, _b, _ms = grad(loss32, x.float())
    saved = k7.sdpa
    try:
        k7.sdpa = lambda q, k, v, scale=None: k7.sdpa_plain(
            q, k, v, scale=(scale or q.shape[-1] ** -0.5) * K7_SCALE_CONTROL)
        _v, g_c, _f, _b, _ms = grad(loss16, x)
        k7.sdpa = k7_rounding_model(torch)
        _v, g_m, _f, _b, _ms = grad(loss16, x)
    finally:
        k7.sdpa = saved
    own = rel_l2(g_t, g_32)
    ratio = rel_l2(g_k, g_t) / max(own, 1e-30)
    ctrl = rel_l2(g_c, g_t) / max(own, 1e-30)
    model_ratio = rel_l2(g_m, g_t) / max(own, 1e-30)
    own_max = float((g_t - g_32).abs().max())
    max_ratio = float((g_k - g_t).abs().max()) / max(own_max, 1e-30)
    print(f"K7 gradient (DINOv2 pool loss, {shape} bf16, seeded trunk): loss "
          f"kernel {v_k:.6f} twin {v_t:.6f} twin fp32 {v_32:.6f}; K7 launches "
          f"forward {fwd} backward {bwd}; rel-L2 vs twin / twin's own bf16 "
          f"error {ratio:.4f} (bar {K7_GRAD_BAR}; own {own:.4g}); max-abs ratio "
          f"{max_ratio:.4f}; K7's rounding in plain PyTorch {model_ratio:.4f}; "
          f"scale x{K7_SCALE_CONTROL} control ratio {ctrl:.3f}; "
          f"fwd+bwd ms kernel {ms_k:.1f} twin {ms_t:.1f}", flush=True)
    if fwd != 2 * 12 or bwd or fwd_t:
        fail(f"K7 gradient: launches forward {fwd} backward {bwd} (twin path "
             f"{fwd_t}); want 24 / 0 / 0")
    if not all(np.isfinite(v) for v in (v_k, v_t, v_32)) or \
            not bool(g_k.isfinite().all()) or float(g_k.abs().max()) == 0:
        fail("K7 gradient: non-finite loss or gradient, or a zero gradient")
    if ratio > K7_GRAD_BAR:
        fail(f"K7 gradient off the twin's by {ratio:.3f} of the twin's own bf16 "
             f"error (bar {K7_GRAD_BAR})")
    if ctrl <= K7_GRAD_BAR:
        fail(f"K7 gradient: the wrong-scale control passes ({ctrl:.3f}): the "
             "check is blind")
    out = {"loss": [v_k, v_t, v_32], "launches_forward": fwd,
           "launches_backward": bwd, "rel_over_own": ratio, "own_rel": own,
           "max_abs_over_own": max_ratio, "control_rel_over_own": ctrl,
           "rounding_model_rel_over_own": model_ratio,
           "fwd_bwd_ms": {"kernel": ms_k, "twin": ms_t}}
    del loss16, loss32, g_k, g_t, g_32, g_c, g_m
    torch_empty_cache()
    return out


def feature_step_model(torch, dev):
    """swin_unet_2x at the trainer's width on the tamed weights, and one
    synthetic batch of the trainer's dataset (x, y on the card)."""
    import random
    from nunif_tpu_torch.models import from_flax
    from nunif_tpu_torch.waifu2x.models.swin_unet import (SwinUNet2x,
                                                          tamed_flax_params)
    from nunif_tpu_torch.waifu2x.training.dataset import Waifu2xDataset
    model = SwinUNet2x(base_dim=TRAIN_BASE)
    from_flax(model, tamed_flax_params(model, seed=0))
    model.to(dev).requires_grad_(True)
    random.seed(TRAIN_SEED)
    ds = Waifu2xDataset(None, model_offset=model.i2i_offset, scale_factor=2,
                        tile_size=TRAIN_TILE, synthetic_p=1.0,
                        num_samples=TRAIN_BATCH, training=True, seed=TRAIN_SEED)
    batch = next(iter(ds.batches(TRAIN_BATCH, n_threads=1)))
    return model, (torch.from_numpy(batch["x"]).to(dev),
                   torch.from_numpy(batch["y"]).to(dev))


def feature_step(torch, model, batch, loss_fn, kernels):
    """One training step's forward (bf16) and backward on ``loss_fn``:
    (loss, forward launches, backward launches, ms, gradients finite)."""
    x, y = batch
    for p in model.parameters():
        p.grad = None
    for k in kernels.values():
        k.launches = 0
    torch_sync()
    t0 = time.perf_counter()
    loss = loss_fn(model(x.to(torch.bfloat16), train=True).float(), y)
    torch_sync()
    fwd = {n: k.launches for n, k in kernels.items()}
    loss.backward()
    torch_sync()
    ms = (time.perf_counter() - t0) * 1e3
    bwd = {n: k.launches - fwd[n] for n, k in kernels.items()}
    finite = all(bool(p.grad.isfinite().all()) for p in model.parameters()
                 if p.grad is not None)
    return float(loss.detach()), fwd, bwd, ms, finite


def feature_losses_check(torch, dev, kernels):
    """Parts (b, in-process) and (c): a swin_unet_2x training step on
    l1dinov2 with the launches of its forward and backward, then one step
    on each of the other eight feature-net losses (a warm step first)."""
    from nunif_tpu_torch.waifu2x.training.trainer import create_criterion
    model, batch = feature_step_model(torch, dev)
    out = {}
    for name in ("l1dinov2",) + OTHER_FEATURE_LOSSES:
        t0 = time.perf_counter()
        loss_fn = create_criterion(name)
        build_s = time.perf_counter() - t0
        feature_step(torch, model, batch, loss_fn, kernels)
        loss, fwd, bwd, ms, finite = feature_step(torch, model, batch, loss_fn,
                                                  kernels)
        print(f"feature loss {name}: swin_unet_2x step ({TRAIN_BATCH} x "
              f"{TRAIN_TILE}^2 -> {FEAT_HW}^2, bf16) {ms:.1f} ms, loss {loss:.6f}; "
              f"launches forward {fwd} backward {bwd}; built in {build_s:.1f} s",
              flush=True)
        if not (np.isfinite(loss) and finite):
            fail(f"feature loss {name}: loss {loss} or a gradient not finite")
        if name == "l1dinov2" and (fwd != L1DINO_FORWARD
                                   or any(bwd.values())):
            fail(f"l1dinov2 training step: launches forward {fwd} backward "
                 f"{bwd}, want {L1DINO_FORWARD} and none")
        if any(bwd.values()):
            fail(f"feature loss {name}: the backward launched {bwd}")
        out[name] = {"ms": ms, "loss": loss, "forward_launches": fwd,
                     "backward_launches": bwd, "build_s": build_s}
        del loss_fn
    del model, batch
    torch_empty_cache()
    return out


def gan_cli_run(torch, dev, work_dir, disc, video=False):
    """Part (d): ``python -m nunif_tpu_torch.train inpaint --discriminator
    disc`` at its defaults (its entry point, in this process): every step's
    metrics finite, the adaptive weight 0 before GAN_START and inside
    [adaptive_min, adaptive_max] x discriminator_weight after; its
    ``.nztm`` loaded and inpainting a 1080p frame (a 12-frame clip at
    540p for the video net): finite, in [0, 1], the input kept outside the
    hole."""
    import csv
    from nunif_tpu_torch.models import load_model
    from nunif_tpu_torch.train import main as train_main
    from nunif_tpu_torch.training.gan import GANConfig
    arch = "inpaint.light_video_inpaint_v1" if video else "inpaint.light_inpaint_v1"
    model_dir = os.path.join(work_dir, f"inpaint_{disc}{'_video' if video else ''}")
    n = GAN_VIDEO_CLIPS if video else GAN_STEPS * GAN_BATCH
    start = GAN_VIDEO_CLIPS // 2 if video else GAN_START  # a clip a step
    argv = ["inpaint", "--arch", arch, "--model-dir", model_dir, "--discriminator",
            disc, "--num-samples", str(n), "--max-epoch", "1",
            "--generator-start-step", str(start)]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_main(argv)
    wall = time.perf_counter() - t0
    lines = [json.loads(s[len("inpaint_gan: "):]) for s in buf.getvalue().splitlines()
             if s.startswith("inpaint_gan: ")]
    if rc or len(lines) != 1:
        fail(f"inpaint GAN CLI ({disc}): rc {rc}, {buf.getvalue()[-2000:]}")
    rep = lines[0]
    with open(os.path.join(model_dir, "gan_steps.csv")) as f:
        rows = list(csv.DictReader(f))
    steps = len(rows)
    metrics = {k: [float(r[k]) for r in rows] for k in ("recon", "gen", "d", "disc_weight")}
    cfg = GANConfig()
    lo, hi = cfg.adaptive_min * cfg.discriminator_weight, cfg.adaptive_max * cfg.discriminator_weight
    want_steps = GAN_VIDEO_CLIPS if video else GAN_STEPS
    w = metrics["disc_weight"]
    if steps != want_steps or not all(np.isfinite(v) for m in metrics.values() for v in m) \
            or not rep["finite"] or not rep["device"].startswith("cuda"):
        fail(f"inpaint GAN CLI ({disc}): {steps} steps, report {rep}")
    if any(v != 0.0 for v in w[:start]) or \
            not all(lo <= v <= hi for v in w[start:]):
        fail(f"inpaint GAN CLI ({disc}): adaptive weights {w}")
    model, _meta = load_model(os.path.join(model_dir, arch.replace(".", "_") + ".nztm"),
                              device=dev)
    h, wd = (540, 960) if video else GAN_RENDER_HW
    frames = 12 if video else 1
    img = torch.from_numpy(np.stack([structured_frame(h, wd, 7 + i)
                                     for i in range(frames)])).to(dev).float() / 255
    mask = torch.zeros((frames, h, wd, 1), device=dev)
    mask[:, h // 4:h // 2, wd // 3:wd // 3 + 48] = 1.0
    with torch.no_grad():
        src = img * (1 - mask)
        t1 = time.perf_counter()
        out = model(src, mask=mask)
        torch_sync()
        render_ms = (time.perf_counter() - t1) * 1e3
    keep = (mask == 0).expand_as(out)
    if tuple(out.shape) != tuple(img.shape) or not bool(out.isfinite().all()) \
            or float(out.min()) < 0 or float(out.max()) > 1 \
            or not torch.equal(out[keep], src[keep]):
        fail(f"inpaint GAN CLI ({disc}): the trained net's inpaint {tuple(out.shape)}")
    bench = None
    if not video:  # the eval benchmark on the trained file, LPIPS included
        from nunif_tpu_torch.iw3.training.inpaint.benchmark import benchmark_main
        bench = benchmark_main(checkpoint=os.path.join(
            model_dir, arch.replace(".", "_") + ".nztm"), lpips=True, device=str(dev))
        if not all(np.isfinite(v) for v in bench.values()):
            fail(f"inpaint benchmark ({disc}): {bench}")
    res = {"steps": steps, "steps_per_second": rep["steps_per_second"],
           "benchmark": bench,
           "samples_per_second": rep["samples_per_second"],
           "data_wait_share": rep["data_wait_share"],
           "peak_memory_bytes": rep["peak_memory_bytes"], "wall_s": wall,
           "last": rep["last"], "start": start,
           "disc_weight_after_start": [min(w[start:]), max(w[start:])],
           "render_ms": render_ms, "render_shape": list(out.shape)}
    del model, img, mask, out, src
    torch_empty_cache()
    return res


def feature_gan_phase(torch, dev, k1, k2, k7, smi, work_dir):
    """The "feature losses and GAN" phase: (a) K7's gradient at the DINOv2
    loss's shape, (b) the l1dinov2 step's launches and its CLI, (c) one step
    of each other feature-net loss, (d) the inpaint GAN CLI with l3c and
    ffc, and the video net with l3c."""
    kernels = {"fused_swin_block_image": k1.fused_swin_block_image,
               "stem_conv3x3": k2.stem_conv3x3, "sdpa": k7.sdpa}
    out = {"k7_grad": k7_grad_check(torch, dev, k7)}
    out["losses"] = feature_losses_check(torch, dev, kernels)
    cli = out["l1dinov2_cli"] = train_cli_run(
        torch, dev, k1, k2, work_dir, True, name="train_w2x_l1dinov2",
        extra=("--loss", "l1dinov2", "--num-samples", str(L1DINO_SAMPLES)),
        rise=False)
    last = cli["epochs"][-1]
    print(f"l1dinov2 CLI from the tamed weights ({smi}): {TRAIN_CLI_EPOCHS} epochs "
          f"of {L1DINO_SAMPLES} samples in {cli['wall_s']:.1f} s wall; last epoch "
          f"{last['steps_per_second']:.3f} steps/s, {last['samples_per_second']:.2f} "
          f"samples/s, data wait {last['data_wait_share']:.3f} of the epoch, peak "
          f"memory {(last['peak_memory_bytes'] or 0) / 2 ** 30:.2f} GiB; losses "
          f"{[round(e['train_loss'], 5) for e in cli['epochs']]}, eval Y-PSNR "
          f"{[round(e['eval_y_psnr'], 3) for e in cli['epochs']]} dB (start "
          f"{cli['start_eval_y_psnr']:.3f}); render launches "
          f"{cli['render_launches']}, vs twins {cli['render_psnr_vs_twins']:.2f} dB",
          flush=True)
    gan = out["gan"] = {}
    for disc, video in (("l3c", False), ("ffc", False), ("l3c", True)):
        label = f"{disc}{' video' if video else ''}"
        r = gan[label] = gan_cli_run(torch, dev, work_dir, disc, video)
        print(f"inpaint GAN CLI ({label}, {smi}): {r['steps']} steps, "
              f"{r['steps_per_second']:.3f} steps/s, {r['samples_per_second']:.2f} "
              f"samples/s, data wait {r['data_wait_share']:.3f}, peak memory "
              f"{(r['peak_memory_bytes'] or 0) / 2 ** 30:.2f} GiB, {r['wall_s']:.1f} s "
              f"wall; last {r['last']}; adaptive weight after step {r['start']} in "
              f"{r['disc_weight_after_start']}; inpaint {r['render_shape']} in "
              f"{r['render_ms']:.1f} ms; eval benchmark {r['benchmark']}", flush=True)
    return out


# the "trainers" phase: swin_t's training step at the trainer's defaults
# (batch 16 x 224^2, bf16), K4 12 a forward and none in the backward; each
# gradient tensor held to K4_GRAD_BAR x the twin's own bf16 error, with the
# twin at 2x the score scale as the control.  The bar of PR 24 / 25, 1.0,
# sits at the noise floor of swin_t's relative-bias tables: their gradient
# sums dL/dlogit over every window, so one bf16 rounding of a probability
# that an fp32 difference flips moves it by the whole net's bf16 error.
# k4_rounding_model, which differs from the twin only in fp32 roundings,
# reaches 1.02 there on the CPU and the kernel 1.049 on the card; the
# control reads 11.  Then each new trainer's CLI for one short epoch
# (TRAINER_STEPS steps of 16)
K4_GRAD_BAR = 1.5
SWIN_T_TRAIN_BATCH = 16
TRAINER_STEPS = 4
TRAINER_CLASSES, TRAINER_IMAGES, TRAINER_EVAL_IMAGES = 4, 32, 8
SWEEP_PAIRS, SWEEP_HW = 4, (540, 960)


def run_train_cli(argv, what, dev):
    """``python -m nunif_tpu_torch.train`` ``argv`` on ``dev`` in this
    process: (its ``train:`` lines, wall s)."""
    from nunif_tpu_torch.train import main as train_main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_main([*argv, "--device", str(dev)])
    wall = time.perf_counter() - t0
    lines = [json.loads(s[len("train: "):]) for s in buf.getvalue().splitlines()
             if s.startswith("train: ")]
    if rc or not lines:
        fail(f"{what}: rc {rc}, {buf.getvalue()[-2000:]}")
    for e in lines:
        if not (np.isfinite(e["train_loss"]) and e["eval_score"] is not None
                and np.isfinite(e["eval_score"])) or e["nan_count"] \
                or e["device"].split(":")[0] != dev.type:
            fail(f"{what}: epoch {e}")
    return lines, wall


def window_attention_scaled(k4, scale):
    """K4's twin with the scores scaled by ``scale`` (q times scale): the
    gradient check's control."""
    def fn(qkv, bias, *, num_heads, window, shift, n_wh, n_ww):
        c = qkv.shape[-1] // 3
        qkv = qkv.clone()
        qkv[..., :c] = qkv[..., :c] * scale
        return k4.window_attention_plain(qkv, bias, num_heads=num_heads,
                                         window=window, shift=shift,
                                         n_wh=n_wh, n_ww=n_ww)
    return fn


def k4_rounding_model(torch, k4):
    """K4's forward at its rounding points in plain PyTorch, with the
    twin's VJP as backward (as the op's): the logit s scale + bias rounded
    once (the kernel's fused multiply-add), the exponential rounded once
    from float64 (the kernel's ``__expf`` is within 2 ulp), the
    normalised probabilities rounded to qkv's dtype, fp32 P V rounded
    once.  It differs from the twin only in fp32 roundings, so its
    gradients' distance from the twin path's is the floor of what any fp32
    evaluation of the same attention reaches."""
    from nunif_tpu_torch.modules.attention import shifted_window_mask

    def forward(qkv, bias, num_heads, window, shift, n_wh, n_ww):
        dt = qkv.dtype
        nw, n, c3 = qkv.shape
        c = c3 // 3
        hd = c // num_heads
        q, k, v = qkv.double().reshape(nw, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
        s = (q @ k.transpose(-1, -2)).float().double() * (hd ** -0.5) + bias.double()[None]
        if shift:
            mask = torch.from_numpy(shifted_window_mask(
                n_wh * window, n_ww * window, window, shift)).to(qkv.device)
            s = (s.reshape(-1, n_wh * n_ww, num_heads, n, n) + mask[None, :, None]
                 ).reshape(nw, num_heads, n, n)
        s = s.float()
        e = torch.exp((s - s.amax(-1, keepdim=True)).double()).float()
        p = (e * (1.0 / e.sum(-1, keepdim=True))).to(dt).float()
        out = (p @ v.float()).to(dt)
        return out.transpose(1, 2).reshape(nw, n, c)

    class Model(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv, bias, kw):
            ctx.save_for_backward(qkv, bias)
            ctx.kw = kw
            return forward(qkv, bias, **kw)

        @staticmethod
        def backward(ctx, grad):
            qkv, bias = ctx.saved_tensors
            with torch.enable_grad():
                a = qkv.detach().requires_grad_(True)
                b = bias.detach().requires_grad_(ctx.needs_input_grad[1])
                wrt = [a, b] if ctx.needs_input_grad[1] else [a]
                gs = torch.autograd.grad(k4.window_attention_plain(a, b, **ctx.kw),
                                         wrt, grad)
            return gs[0], (gs[1] if len(gs) > 1 else None), None

    def fn(qkv, bias, *, num_heads, window, shift, n_wh, n_ww):
        return Model.apply(qkv, bias, dict(num_heads=num_heads, window=window,
                                           shift=shift, n_wh=n_wh, n_ww=n_ww))
    return fn


def swin_t_train_check(torch, dev, k4, smi, work_dir):
    """Part (a): swin_t from a .nztm of seeded weights, one fixed batch of
    16 x 224^2 with seeded labels, cross-entropy on the fp32 logits: K4's
    launches in the forward and the backward, each parameter gradient of
    the K4 path against the twin path within K4_GRAD_BAR x the twin's own
    bf16-vs-fp32 error, the 2x-scale control failing it, fwd + bwd ms and
    peak memory of each path."""
    import torch.nn.functional as F
    from nunif_tpu_torch.imagenet.models import SwinT
    from nunif_tpu_torch.models import from_flax, load_model, save_model
    cpu_model = SwinT()
    from_flax(cpu_model, serving_flax(cpu_model, seed=5))
    path = os.path.join(work_dir, "swin_t_train.nztm")
    save_model(cpu_model, path)
    del cpu_model
    model, _meta = load_model(path, device=dev)
    model.requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(26)
    x = torch.rand((SWIN_T_TRAIN_BATCH, IMAGENET_HW, IMAGENET_HW, 3),
                   generator=gen, device=dev)
    y = torch.randint(0, 1000, (SWIN_T_TRAIN_BATCH,), generator=gen, device=dev)
    pairs = ((k4, "fused_window_attention"),)
    bf16 = torch.bfloat16

    cuda = dev.type == "cuda"

    def step(dtype):
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        out = train_grads(torch, model, x, y, F.cross_entropy, dtype, pairs)
        torch_sync()
        return out + (torch.cuda.max_memory_allocated(dev) if cuda else 0,)

    step(bf16)  # warm: cuDNN and cuBLAS pick their kernels
    loss_k, g_k, fwd, bwd, ms_k, mem_k = step(bf16)
    _l, _g, _f, _b, ms_k2, _m = step(bf16)
    with twins(*pairs):
        step(bf16)
        loss_t, g_t, fwd_t, _b, ms_t, mem_t = step(bf16)
        loss_32, g_32, _f, _b, ms_32, _m = step(torch.float32)
    saved = k4.fused_window_attention
    try:
        k4.fused_window_attention = window_attention_scaled(k4, K7_SCALE_CONTROL)
        _l, g_c, _f, _b, _ms, _m = step(bf16)
        k4.fused_window_attention = k4_rounding_model(torch, k4)
        _l, g_m, _f, _b, _ms, _m = step(bf16)
    finally:
        k4.fused_window_attention = saved
    own = grad_errors(torch, g_t, g_32)

    def over_own(g):
        err = grad_errors(torch, g, g_t)
        return err, {n: err[n][0] / max(own[n][0], 1e-30) for n in err}
    err, ratio = over_own(g_k)
    _e, ctrl_ratio = over_own(g_c)
    _e, model_ratio = over_own(g_m)
    worst = max(ratio, key=ratio.get)
    worst_ctrl = max(ctrl_ratio, key=ctrl_ratio.get)
    worst_model = max(model_ratio, key=model_ratio.get)
    top = sorted(ratio, key=ratio.get, reverse=True)[:4]
    print("swin_t grads, the largest ratios to the twin's own bf16 error: "
          + "; ".join(f"{n}: kernel {ratio[n]:.4f}, rounding model "
                      f"{model_ratio[n]:.4f}" for n in top)
          + f"; the rounding model's worst {model_ratio[worst_model]:.4f} "
          f"({worst_model})", flush=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"swin_t train step ({smi}): batch {SWIN_T_TRAIN_BATCH} x "
          f"{IMAGENET_HW}^2 bf16, {n_params} parameters, cross-entropy; loss "
          f"kernel path {loss_k:.6f}, twin {loss_t:.6f}, twin fp32 {loss_32:.6f}; "
          f"K4 launches forward {fwd} backward {bwd} (twin path {fwd_t}); "
          f"worst rel / own bf16 error {ratio[worst]:.4f} ({worst}: rel "
          f"{err[worst][0]:.4g}, own {own[worst][0]:.4g}; bar {K4_GRAD_BAR}); "
          f"control (scores x{K7_SCALE_CONTROL}) worst {ctrl_ratio[worst_ctrl]:.3f} "
          f"({worst_ctrl}); fwd+bwd ms kernel {ms_k:.1f} / {ms_k2:.1f}, twin "
          f"{ms_t:.1f}, twin fp32 {ms_32:.1f}; peak memory kernel "
          f"{mem_k / 2 ** 30:.2f} GiB, twin {mem_t / 2 ** 30:.2f} GiB", flush=True)
    if fwd != {"fused_window_attention": SWIN_T_K4} or \
            bwd != {"fused_window_attention": 0} or \
            fwd_t != {"fused_window_attention": 0}:
        fail(f"swin_t training step: K4 launches forward {fwd} backward {bwd}, "
             f"twin path {fwd_t}; want {SWIN_T_K4} / 0 / 0")
    if not all(np.isfinite(v) for v in (loss_k, loss_t, loss_32)) or \
            not all(bool(g.isfinite().all()) for g in g_k.values()):
        fail("swin_t training step: a non-finite loss or gradient")
    if ratio[worst] > K4_GRAD_BAR:
        fail(f"swin_t gradient of {worst} off the twin path by {err[worst][0]:.4g} "
             f"relative, beyond {K4_GRAD_BAR} x the twin's own bf16 error "
             f"{own[worst][0]:.4g}")
    if ctrl_ratio[worst_ctrl] <= K4_GRAD_BAR:
        fail(f"swin_t gradient: the x{K7_SCALE_CONTROL} control passes "
             f"({ctrl_ratio[worst_ctrl]:.3f}): the check is blind")
    out = {"loss": [loss_k, loss_t, loss_32], "forward_launches": fwd,
           "backward_launches": bwd, "worst_rel_over_own": ratio[worst],
           "worst_tensor": worst, "control_rel_over_own": ctrl_ratio[worst_ctrl],
           "rounding_model_rel_over_own": model_ratio[worst_model],
           "rounding_model_at_worst": model_ratio[worst],
           "fwd_bwd_ms": {"kernel": [ms_k, ms_k2], "twin": ms_t, "twin_fp32": ms_32},
           "peak_memory_bytes": {"kernel": mem_k, "twin": mem_t},
           "parameters": n_params}
    del model, g_k, g_t, g_32, g_c, g_m, x, y
    torch_empty_cache()
    return out


def image_folder_tree(root):
    """train/ (TRAINER_CLASSES classes x TRAINER_IMAGES) and eval/ (x
    TRAINER_EVAL_IMAGES) of seeded 256^2 PNGs."""
    from PIL import Image
    for split, n in (("train", TRAINER_IMAGES), ("eval", TRAINER_EVAL_IMAGES)):
        for c in range(TRAINER_CLASSES):
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                Image.fromarray(structured_frame(256, 256, 1000 * c + i + (
                    500 if split == "eval" else 0))).save(os.path.join(d, f"{i}.png"))


def imagenet_eval_accuracy(torch, dev, model, root, dtype):
    """Mean of the eval set's per-batch top-1 accuracies (batches of 16),
    as the trainer's eval takes it."""
    from nunif_tpu_torch.imagenet.training import ImageFolderDataset
    ds = ImageFolderDataset(os.path.join(root, "eval"), size=IMAGENET_HW,
                            training=False)
    hits = []
    with torch.no_grad():
        for b in ds.batches(SWIN_T_TRAIN_BATCH):
            logits = model(torch.from_numpy(b["x"]).to(dev, dtype)).float()
            y = torch.from_numpy(b["y"]).to(dev).long()
            hits.append(float((logits.argmax(-1) == y).float().mean()))
    return float(np.mean(hits))


def calibration_check(torch, dev, model_path, root):
    """vgg11's calibrate_bn on the card over 4 training batches against a
    float64 recomputation: each BN input taken by a hook in the same
    train-mode bf16 forwards, concatenated, its two-pass mean and
    variance.  Returns the largest relative error."""
    from nunif_tpu_torch.imagenet.training import (ImageFolderDataset, bn_names,
                                                   calibrate_bn)
    from nunif_tpu_torch.models import load_model
    model, _meta = load_model(model_path, device=dev)
    ds = ImageFolderDataset(os.path.join(root, "train"), size=IMAGENET_HW)
    batches = [b for _, b in zip(range(4), ds.batches(SWIN_T_TRAIN_BATCH))]
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    got = calibrate_bn(model, params, batches, max_batches=16, dtype=torch.bfloat16)
    taken = {n: [] for n in bn_names(model)}
    hooks = [getattr(model, n).register_forward_pre_hook(
        lambda _m, inputs, n=n: taken[n].append(inputs[0].detach().double()
                                                .reshape(-1, inputs[0].shape[-1])))
        for n in taken]
    with torch.no_grad():
        for b in batches:
            model(torch.from_numpy(b["x"]).to(dev, torch.bfloat16), train=True)
    for h in hooks:
        h.remove()
    worst = 0.0
    for n, parts in taken.items():
        v = torch.cat(parts)
        for stat, want in (("mean", v.mean(0)), ("var", v.var(0, unbiased=False))):
            have = got[f"{n}.{stat}"].double()
            rel = float((have - want).abs().max() / want.abs().max())
            worst = max(worst, rel)
    del model, taken
    torch_empty_cache()
    return worst


def imagenet_cli_check(torch, dev, k4, smi, work_dir):
    """Part (b): ``train imagenet`` at its defaults for one epoch on a
    seeded class-folder tree, swin_t (K4 counted) then vgg11; each .nztm
    loaded on the card, its eval accuracy equal to the trainer's last;
    vgg11's calibrated statistics against a float64 recomputation."""
    from nunif_tpu_torch.models import load_model
    root = os.path.join(work_dir, "imagenet_data")
    image_folder_tree(root)
    n = TRAINER_CLASSES * TRAINER_IMAGES
    out = {}
    for arch in ("imagenet.swin_t", "imagenet.vgg11"):
        model_dir = os.path.join(work_dir, arch.replace(".", "_"))
        k4.fused_window_attention.launches = 0
        lines, wall = run_train_cli(
            ["imagenet", "--arch", arch, "--data-dir", root, "--model-dir",
             model_dir, "--num-samples", str(n), "--max-epoch", "1"], arch, dev)
        launches = k4.fused_window_attention.launches
        e = lines[-1]
        path = os.path.join(model_dir, arch.replace(".", "_") + ".nztm")
        model, meta = load_model(path, device=dev)
        acc = imagenet_eval_accuracy(torch, dev, model, root, torch.bfloat16)
        del model
        torch_empty_cache()
        r = out[arch] = {"epoch": e, "wall_s": wall, "k4_launches": launches,
                         "nztm_eval_accuracy": acc, "nztm_name": meta["name"]}
        steps = n // SWIN_T_TRAIN_BATCH
        evals = TRAINER_CLASSES * TRAINER_EVAL_IMAGES // SWIN_T_TRAIN_BATCH
        want = SWIN_T_K4 * (steps + evals) if arch == "imagenet.swin_t" else 0
        if launches != want or e["steps"] != steps:
            fail(f"train {arch}: {e['steps']} steps, K4 launches {launches}, want "
                 f"{steps} and {want}")
        if acc != -e["eval_score"]:
            fail(f"train {arch}: the exported .nztm's eval accuracy {acc} is not "
                 f"the trainer's last eval {-e['eval_score']}")
        if arch == "imagenet.vgg11":
            r["calibration_rel_err"] = calibration_check(torch, dev, path, root)
            if not r["calibration_rel_err"] <= 1e-4:
                fail(f"vgg11 calibrate_bn off a float64 recomputation by "
                     f"{r['calibration_rel_err']} relative")
        print(f"train {arch} CLI ({smi}): {e['steps']} steps of "
              f"{SWIN_T_TRAIN_BATCH} x {IMAGENET_HW}^2 in {wall:.1f} s wall; "
              f"{e['steps_per_second']:.3f} steps/s, {e['samples_per_second']:.2f} "
              f"samples/s, data wait {e['data_wait_share']:.3f}, peak memory "
              f"{(e['peak_memory_bytes'] or 0) / 2 ** 30:.2f} GiB; loss "
              f"{e['train_loss']:.5f}, eval accuracy {-e['eval_score']:.4f} (the "
              f".nztm on the card: {acc:.4f}); K4 launches {launches}"
              + (f"; calibrated BN statistics vs float64 max rel err "
                 f"{r['calibration_rel_err']:.3g}" if arch == "imagenet.vgg11" else ""),
              flush=True)
    return out


def sbs_cli_check(torch, dev, k3, k7, smi, work_dir):
    """Part (c): ``create_training_data sbs`` at its defaults on the card,
    then ``train sbs`` for one epoch: row_flow_v3 resumed from the shaped
    seeded weights of the iw3 phases (written as the trainer's checkpoint,
    so its deltas move pixels), mlbw_l2 from flax's init; the trained
    row_flow_v3 .nztm then drives the iw3 1080p batch (iw3_batch)."""
    from nunif_tpu_torch.create_training_data import main as ctd_main
    from nunif_tpu_torch.iw3.models.row_flow_v3 import RowFlowV3, shaped_flax_params
    from nunif_tpu_torch.iw3.training.sbs.trainer import build_trainer
    from nunif_tpu_torch.models import from_flax, load_model
    from nunif_tpu_torch.train import create_parser
    data = os.path.join(work_dir, "sbs_data")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = ctd_main(["sbs", "-i", "synthetic", "-o", data, "--device", str(dev)])
    data_s = time.perf_counter() - t0
    n_quads = len(os.listdir(os.path.join(data, "train"))) // 4
    if rc or not n_quads:
        fail(f"create_training_data sbs: rc {rc}, {n_quads} quads")
    out = {"data_seconds": data_s, "quads": n_quads}
    n = TRAINER_STEPS * 16
    for arch in ("sbs.row_flow_v3", "sbs.mlbw_l2"):
        model_dir = os.path.join(work_dir, arch.replace(".", "_"))
        argv = ["sbs", "--arch", arch, "--data-dir", data, "--model-dir", model_dir,
                "--num-samples", str(n), "--max-epoch", "1"]
        if arch == "sbs.row_flow_v3":
            trainer, _t, _e = build_trainer(create_parser().parse_args(
                [*argv, "--device", str(dev)]))
            from_flax(trainer.model, shaped_flax_params(RowFlowV3(), seed=1))
            trainer.save_checkpoint()
            del trainer
            argv.append("--resume")
        lines, wall = run_train_cli(argv, f"train {arch}", dev)
        e = lines[-1]
        file = "sbs_row_flow_v3.nztm" if arch == "sbs.row_flow_v3" else "sbs_mlbw.nztm"
        _m, meta = load_model(os.path.join(model_dir, file), device=dev)
        out[arch] = {"epoch": e, "wall_s": wall, "nztm_name": meta["name"]}
        print(f"train sbs {arch} CLI ({smi}): {e['steps']} steps of 16 x 96^2 in "
              f"{wall:.1f} s wall; {e['steps_per_second']:.3f} steps/s, data wait "
              f"{e['data_wait_share']:.3f}, peak memory "
              f"{(e['peak_memory_bytes'] or 0) / 2 ** 30:.2f} GiB; loss "
              f"{e['train_loss']:.6f}, eval loss {e['eval_score']:.6f}", flush=True)
    flow = os.path.join(work_dir, "sbs_row_flow_v3", "sbs_row_flow_v3.nztm")
    med, launches, psnr = iw3_batch(torch, dev, work_dir, k3, k7, flow_path=flow)
    out["iw3_batch"] = {"median_ms": med, "launches": launches, "psnr_vs_twins": psnr}
    print(f"iw3 1080p batch on the trained row_flow_v3 ({smi}): median {med:.1f} ms, "
          f"launches {launches}, kernel path vs twin path {psnr:.2f} dB", flush=True)
    torch_empty_cache()
    return out


OTHER_TRAINERS = {
    "sod": ("iw3_sod_v1.nztm", []),
    "depth_aa": ("iw3_depth_aa.nztm", ["--loss", "dct"]),
    "da3mono": ("iw3_da3mono_disparity.nztm", []),
    "stlizer_outpaint": ("stlizer_light_outpaint_v1.nztm", []),
    "cliqa": ("cliqa_jpeg_quality.nztm", ["--kind", "jpeg", "--synthetic-p", "1.0"]),
}


def other_trainers_check(torch, dev, smi, work_dir):
    """Part (d): one short epoch of each other trainer at its default size
    on synthetic data, each .nztm loaded on the card; da3mono's benchmark
    on its trained file."""
    from nunif_tpu_torch.iw3.training.da3mono import benchmark_main
    from nunif_tpu_torch.models import load_model
    out = {}
    for name, (file, extra) in OTHER_TRAINERS.items():
        model_dir = os.path.join(work_dir, f"train_{name}")
        lines, wall = run_train_cli(
            [name, "--data-dir", os.path.join(work_dir, "no_data"), "--model-dir",
             model_dir, "--num-samples", str(TRAINER_STEPS * 16), "--max-epoch", "1",
             *extra], f"train {name}", dev)
        e = lines[-1]
        _m, meta = load_model(os.path.join(model_dir, file), device=dev)
        r = out[name] = {"epoch": e, "wall_s": wall, "nztm_name": meta["name"]}
        if name == "da3mono":
            r["benchmark_psnr"] = benchmark_main(os.path.join(model_dir, file),
                                                 device=str(dev))
            if not np.isfinite(r["benchmark_psnr"]):
                fail(f"da3mono benchmark: {r['benchmark_psnr']}")
        print(f"train {name} CLI ({smi}): {e['steps']} steps of 16 in {wall:.1f} s "
              f"wall; {e['steps_per_second']:.3f} steps/s, data wait "
              f"{e['data_wait_share']:.3f}, peak memory "
              f"{(e['peak_memory_bytes'] or 0) / 2 ** 30:.2f} GiB; loss "
              f"{e['train_loss']:.6f}, eval {e['eval_score']:.6f}"
              + (f"; benchmark normalised PSNR {r['benchmark_psnr']:.3f} dB"
                 if name == "da3mono" else ""), flush=True)
    torch_empty_cache()
    return out


def sweep_check(torch, dev, smi, work_dir):
    """Part (e): find_mask_threshold.sweep on a seeded sbs.mask_mlbw_l2
    .nztm over SWEEP_PAIRS seeded 540p rgb + depth pairs (smooth depth with
    raised blocks, so the forward warp leaves holes): each IoU finite and
    in [0, 1]."""
    from PIL import Image
    from nunif_tpu_torch.iw3.models.mlbw import MLBW, shaped_flax_params
    from nunif_tpu_torch.iw3.training.sbs.find_mask_threshold import sweep
    from nunif_tpu_torch.models import from_flax, save_model
    root = os.path.join(work_dir, "sweep")
    h, w = SWEEP_HW
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(SWEEP_PAIRS):
        Image.fromarray(structured_frame(h, w, 40 + i)).save(
            os.path.join(root, "rgb", f"{i}.png"))
        rng = np.random.default_rng(60 + i)
        yy, xx = np.mgrid[0:h, 0:w] / w
        d = 0.3 + 0.2 * np.sin(4 * xx + 3 * yy)
        for _ in range(4):
            y0, x0 = rng.integers(0, h - h // 3), rng.integers(0, w - w // 4)
            d[y0:y0 + h // 3, x0:x0 + w // 4] = rng.uniform(0.6, 1.0)
        Image.fromarray((d * 255 + 0.5).astype(np.uint8)).save(
            os.path.join(root, "depth", f"{i}.png"))
    net = MLBW(num_layers=2, base_dim=32, hole_mask=True)
    from_flax(net, shaped_flax_params(net, seed=3))
    ckpt = os.path.join(root, "mask_mlbw_l2.nztm")
    save_model(net, ckpt)
    t0 = time.perf_counter()
    table = sweep(os.path.join(root, "rgb"), os.path.join(root, "depth"), ckpt,
                  device=str(dev))
    wall = time.perf_counter() - t0
    print(f"find_mask_threshold sweep ({smi}): {SWEEP_PAIRS} pairs of {h}x{w} in "
          f"{wall:.1f} s; IoU by threshold {json.dumps(table)}", flush=True)
    if not table or not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in table.values()):
        fail(f"find_mask_threshold sweep: {table}")
    return {"iou": table, "wall_s": wall}


def trainers_phase(torch, dev, k3, k4, k7, smi, work_dir):
    """The "trainers" phase: (a) swin_t's training step through K4,
    (b) the imagenet CLI (swin_t, vgg11), (c) sbs data and training and
    the trained row_flow_v3 on the iw3 batch, (d) the other trainers'
    CLIs, (e) the mask threshold sweep."""
    out = {"swin_t_step": swin_t_train_check(torch, dev, k4, smi, work_dir)}
    out["imagenet"] = imagenet_cli_check(torch, dev, k4, smi, work_dir)
    out["sbs"] = sbs_cli_check(torch, dev, k3, k7, smi, work_dir)
    out["others"] = other_trainers_check(torch, dev, smi, work_dir)
    out["sweep"] = sweep_check(torch, dev, smi, work_dir)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "nunif_tpu_torch")):
        fail(f"nunif_tpu_torch/ not found beside {__file__}")
    sys.path.insert(0, here)
    os.chdir(here)

    import torch.nn.functional as F
    from nunif_tpu_torch.ops import _build
    from nunif_tpu_torch.ops import conv3x3 as k2
    from nunif_tpu_torch.ops import swin_attention as k1  # K1, K4, K5, K6
    from nunif_tpu_torch.models import from_flax, load_model, save_model
    from nunif_tpu_torch.utils.tiling import TiledRenderer
    from nunif_tpu_torch.waifu2x.models.swin_unet import (
        SwinUNet, SwinUNet2x, SwinUNet4x, SwinUNetDownscaled, swin_unet_4xl,
        tamed_flax_params)
    from nunif_tpu_torch.waifu2x.runtime import Waifu2x
    from nunif_tpu_torch.modules import grid_sample as k3
    from nunif_tpu_torch.ops import probes
    from nunif_tpu_torch.ops import sdpa as k7
    k4 = k5 = k6 = k1

    dev = torch.device("cuda")

    # 1. environment
    phase("environment")
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    try:
        nvcc = sh([_build._nvcc(), "--version"]).splitlines()[-1]
    except _build.KernelBuildError as e:
        fail(str(e))
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc: {nvcc}", flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    # 2. build
    phase("build")
    try:
        lib_path, seconds, log = _build.build()
        _build.library()
    except _build.KernelBuildError as e:
        fail(str(e))
    print(f"built {lib_path} in {seconds:.1f} s", flush=True)
    print("\n".join(line for line in log.splitlines()
                    if "registers" in line or "spill" in line
                    or "entry function" in line
                    or "Performance Loss" in line), flush=True)

    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    # 3. K2 at patch_conv1's main-path shapes: swin_unet_2x at 1080p, the
    #    4xl at 540p (one 592x976 tile)
    phase("k2")
    k2_rows = [k2_row(torch, k2, rng, t, dev, (1, 1118, 1934), 48, 96),
               k2_row(torch, k2, rng, t, dev, (1, 590, 974), 96, 192)]

    # 4. K1 at every main-path shape
    phase("k1")
    from nunif_tpu_torch.modules.attention import shifted_window_mask
    k1_rows = []
    shapes = [(96, 1104, 1920, 0, False), (96, 1104, 1920, 3, False),
              (96, 1104, 1920, 0, True), (192, 552, 960, 0, False),
              (192, 552, 960, 3, False), (192, 276, 480, 0, False),
              (192, 276, 480, 3, False)]
    for c, h, w, shift, with_skip in shapes:
        weights = block_weights(t, rng, c)
        no_bias = weights[:-1] + [torch.zeros_like(weights[-1])]
        x = rng.normal(0, 0.5, (1, h, w, c))
        s = rng.normal(0, 0.5, (1, h, w, c)) if with_skip else None
        for dtype in (torch.bfloat16, torch.float32):
            xd = t(x, dtype)
            sd = None if s is None else t(s, dtype)
            kw = dict(num_heads=6, window=6, shift=shift, skip=sd)
            # weights packed once, as the block module passes them
            packed = k1.pack_weights(*weights, dtype)
            got = k1.fused_swin_block_image(xd, *weights, packed=packed, **kw)
            torch.cuda.synchronize()
            want = k1.swin_block_image_plain(xd, *weights, **kw)
            name = str(dtype).split(".")[1]
            what = f"K1 C={c} {h}x{w} shift={shift} skip={with_skip} {name}"
            err, rel_l2 = check_close(got, want, K1_TOL[name], what)
            # control: the kernel without the bias must fail the same check
            ctrl_ok, ctrl_err, _ = compare(
                k1.fused_swin_block_image(xd, *no_bias, **kw), want,
                K1_TOL[name])
            if ctrl_ok:
                fail(f"{what}: the kernel without relative bias passes the "
                     f"check (max abs err {ctrl_err}): the check is blind")
            del got
            more, comp_err = None, None
            if dtype == torch.bfloat16:
                comp = block_composite(
                    torch, xd, weights, 6, shift,
                    shifted_window_mask(h, w, 6, shift) if shift else None,
                    skip=sd)
                comp_err = float((comp().float() - want.float()).abs().max())
                more = {"composite": comp}
            del want
            tm = compare_timed(
                lambda: k1.fused_swin_block_image(xd, *weights, packed=packed, **kw),
                lambda: k1.swin_block_image_plain(xd, *weights, **kw), torch,
                more=more)
            more = comp = None
            tokens = h * w
            ebytes = 2 if dtype == torch.bfloat16 else 4
            nbytes = tokens * c * ebytes * (3 if with_skip else 2) + \
                sum(a.numel() for a in weights[:8]) * ebytes + \
                weights[8].numel() * 4
            bound_ms, bound_by = bound(
                nbytes, tokens * (16 * c * c + 4 * 36 * c), name)
            row = dict(C=c, H=h, W=w, shift=shift, skip=with_skip, dtype=name,
                       max_abs_err=err, ms=tm["kernel"], plain_ms=tm["plain"],
                       bound_ms=bound_ms, bound_by=bound_by)
            if dtype == torch.bfloat16:
                row.update(composite_ms=tm["composite"], composite_err=comp_err)
            print(f"{what}: err {err:.3g} rel-L2 {rel_l2:.3g} (no-bias "
                  f"control err {ctrl_err:.3g}) kernel {tm['kernel']:.3f} ms "
                  f"plain {tm['plain']:.3f} ms bound {bound_ms:.3f} ms "
                  f"({bound_by}); {row.get('composite_ms') or 0:.3f} ms "
                  f"composite (max abs diff to the twin {comp_err})", flush=True)
            k1_rows.append(row)
            del xd, sd
            torch.cuda.empty_cache()

    # 4b. K5 at every shape of the window path
    phase("k5")
    k5_rows = k5_phase(torch, k5, rng, t)

    # 5. one 1080p frame through the port's swin_unet_2x path
    phase("frame")
    tmp = tempfile.TemporaryDirectory()
    model_dir = tmp.name
    cpu_model = SwinUNet2x()
    from_flax(cpu_model, tamed_flax_params(cpu_model, seed=0))
    save_model(cpu_model, os.path.join(model_dir, "scale2x.nztm"))
    model, meta = load_model(os.path.join(model_dir, "scale2x.nztm"), device=dev)
    renderer = TiledRenderer(model)
    program = renderer.frame_program(1080, 1920, tile_size=(1120, 1936))
    frame = np.random.default_rng(1).integers(0, 256, (1080, 1920, 3),
                                              dtype=np.uint8)
    frame_d = torch.from_numpy(frame).to(dev)
    counted = ((k2, "stem_conv3x3"), (k1, "fused_swin_block_image"),
               (k5, "fused_swin_block"), (k4, "fused_window_attention"))

    def counted_run():
        for mod, name in counted:
            getattr(mod, name).launches = 0
        out = program(frame_d)
        torch.cuda.synchronize()
        return out, {name: getattr(mod, name).launches for mod, name in counted}

    y, launches = counted_run()
    print(f"frame launches: {launches}", flush=True)
    if tuple(y.shape) != (2160, 3840, 3) or y.dtype != torch.uint8:
        fail(f"frame output {tuple(y.shape)} {y.dtype}")
    if launches != {"stem_conv3x3": 1, "fused_swin_block_image": 14,
                    "fused_swin_block": 0, "fused_window_attention": 0}:
        fail(f"frame did not run each kernel as expected: {launches}")
    frame_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        program(frame_d)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    psnr, same = render_twin_psnr(torch, program, frame_d, y, (
        (k2, "stem_conv3x3"), (k1, "fused_swin_block_image")))
    print(f"frame 1080p->4K: median {statistics.median(frame_ms):.1f} ms "
          f"(runs {[round(v, 1) for v in frame_ms]}); vs twins PSNR "
          f"{psnr:.2f} dB, identical px {same:.4f}", flush=True)
    if psnr < FRAME_PSNR_MIN:
        fail(f"frame PSNR vs twins {psnr:.2f} dB < {FRAME_PSNR_MIN}")
    profile_frame(torch, program, frame_d)
    yf = y.float() / 255.0
    if not 0.05 < float(yf.mean()) < 0.95:
        fail(f"frame mean {float(yf.mean())} outside the tamed model's range")
    del yf

    # 5b. the same frame on the window path (NUNIF_TPU_SWIN_IMG=0): every
    #     block pads, partitions, runs K5 and reverses
    phase("frame window path")
    saved_env = os.environ.get("NUNIF_TPU_SWIN_IMG")
    os.environ["NUNIF_TPU_SWIN_IMG"] = "0"
    try:
        y5, launches_k5 = counted_run()
        print(f"window-path frame launches: {launches_k5}", flush=True)
        if launches_k5 != {"stem_conv3x3": 1, "fused_swin_block_image": 0,
                           "fused_swin_block": 14, "fused_window_attention": 0}:
            fail(f"window-path frame did not run each kernel as expected: "
                 f"{launches_k5}")
        if tuple(y5.shape) != (2160, 3840, 3) or y5.dtype != torch.uint8:
            fail(f"window-path frame output {tuple(y5.shape)} {y5.dtype}")
        frame_ms_k5 = []
        for _ in range(3):
            t0 = time.perf_counter()
            program(frame_d)
            torch.cuda.synchronize()
            frame_ms_k5.append((time.perf_counter() - t0) * 1e3)
        psnr_k5, same_k5 = render_twin_psnr(torch, program, frame_d, y5, (
            (k2, "stem_conv3x3"), (k5, "fused_swin_block")))
    finally:
        if saved_env is None:
            os.environ.pop("NUNIF_TPU_SWIN_IMG", None)
        else:
            os.environ["NUNIF_TPU_SWIN_IMG"] = saved_env
    psnr_k1k5 = uint8_psnr(y5, y)
    print(f"window-path frame 1080p->4K: median "
          f"{statistics.median(frame_ms_k5):.1f} ms (runs "
          f"{[round(v, 1) for v in frame_ms_k5]}) against the K1 path's "
          f"{statistics.median(frame_ms):.1f} ms; vs twins PSNR {psnr_k5:.2f} "
          f"dB (identical px {same_k5:.4f}); vs the K1 path's frame PSNR "
          f"{psnr_k1k5:.2f} dB (identical px "
          f"{float((y5 == y).float().mean()):.4f})", flush=True)
    if psnr_k5 < FRAME_PSNR_MIN or psnr_k1k5 < FRAME_PSNR_MIN:
        fail(f"window-path frame PSNR {psnr_k5:.2f} dB vs twins, "
             f"{psnr_k1k5:.2f} dB vs the K1 path < {FRAME_PSNR_MIN}")
    del y5

    # 6. multi-tile image through the runtime (and the CLI when PIL exists)
    phase("multitile")
    w2x = Waifu2x(model_dir, device=dev)
    img = np.random.default_rng(2).random((540, 960, 3), dtype=np.float32)
    rgb, alpha = w2x.convert(img, method="scale", tile_size=256, batch_size=8)
    torch.cuda.synchronize()
    if tuple(rgb.shape) != (1080, 1920, 3) or alpha is not None:
        fail(f"convert output {tuple(rgb.shape)}")
    if not (bool(rgb.isfinite().all()) and float(rgb.min()) >= 0.0
            and float(rgb.max()) <= 1.0):
        fail("convert output not finite in [0, 1]")
    ran = "Waifu2x.convert"
    try:
        from PIL import Image
    except ImportError:
        Image = None
    from nunif_tpu_torch.waifu2x import cli
    if Image is not None:
        src = os.path.join(model_dir, "in.png")
        out = os.path.join(model_dir, "out.png")
        Image.fromarray((img * 255).astype(np.uint8)).save(src)
        cli.main(["-i", src, "-o", out, "--method", "scale", "--model-dir",
                  model_dir, "--tile-size", "256", "--batch-size", "8",
                  "--device", "cuda"])
        with Image.open(out) as im:
            if im.size != (1920, 1080):
                fail(f"CLI output size {im.size}")
        ran += " + cli.main"
    print(f"multi-tile 540x960 tile 256 batch 8 ran: {ran}", flush=True)
    del program, renderer, model, w2x, y, frame_d
    torch.cuda.empty_cache()

    # 7. K4 at every 4xl 540p shape
    phase("k4")
    k4_rows = k4_phase(torch, k4, rng, t, dev)

    # 7b. K6 at every 4xl shape in image layout, and its module path
    phase("k6")
    k6_rows, k6_launches = k6_phase(torch, k6, rng, t, dev)

    # 7c. K4 and K6 at imagenet swin_t's window-7 stages and a window-8 shape
    phase("k4 k6 windows 7 and 8")
    swin_t_rows = [r for r in swin_t_phase(torch, k4, rng, t, dev)
                   if r["dtype"] == "bfloat16"]

    # 8. one 540p frame through the port's swin_unet_4xl path
    phase("frame 4xl")
    cpu_model = swin_unet_4xl()
    from_flax(cpu_model, tamed_flax_params(cpu_model, seed=0))
    save_model(cpu_model, os.path.join(model_dir, "scale4x.nztm"))
    del cpu_model
    model, meta = load_model(os.path.join(model_dir, "scale4x.nztm"), device=dev)
    if (meta["name"], model.base_dim, model.layer_norm) != (
            "waifu2x.swin_unet_4x", 192, True):
        fail(f"4xl checkpoint meta {meta['name']} {meta['kwargs']}")
    program = TiledRenderer(model).frame_program(540, 960, tile_size=(592, 976))
    frame_d = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (540, 960, 3), dtype=np.uint8)).to(dev)
    k2.stem_conv3x3.launches = 0
    k1.fused_swin_block_image.launches = 0
    k4.fused_window_attention.launches = 0
    y = program(frame_d)
    torch.cuda.synchronize()
    launches_4xl = {
        "stem_conv3x3": k2.stem_conv3x3.launches,
        "fused_swin_block_image": k1.fused_swin_block_image.launches,
        "fused_window_attention": k4.fused_window_attention.launches}
    print(f"4xl frame launches: {launches_4xl}", flush=True)
    if tuple(y.shape) != (2160, 3840, 3) or y.dtype != torch.uint8:
        fail(f"4xl frame output {tuple(y.shape)} {y.dtype}")
    if launches_4xl != {"stem_conv3x3": 1, "fused_swin_block_image": 0,
                        "fused_window_attention": 14}:
        fail(f"4xl frame did not run each kernel as expected: {launches_4xl}")
    torch.cuda.reset_peak_memory_stats()
    frame_ms_4xl = []
    for _ in range(3):
        t0 = time.perf_counter()
        program(frame_d)
        torch.cuda.synchronize()
        frame_ms_4xl.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    psnr_4xl, same = render_twin_psnr(torch, program, frame_d, y, (
        (k2, "stem_conv3x3"), (k4, "fused_window_attention")))
    mean_4xl = float(y.float().mean()) / 255.0
    print(f"4xl frame 540p->4K: median {statistics.median(frame_ms_4xl):.1f} "
          f"ms (runs {[round(v, 1) for v in frame_ms_4xl]}); peak device "
          f"memory {peak_gb:.2f} GB; vs twins PSNR {psnr_4xl:.2f} dB, "
          f"identical px {same:.4f}; mean {mean_4xl:.4f}", flush=True)
    if psnr_4xl < FRAME_PSNR_MIN:
        fail(f"4xl frame PSNR vs twins {psnr_4xl:.2f} dB < {FRAME_PSNR_MIN}")
    if not 0.05 < mean_4xl < 0.95:
        fail(f"4xl frame mean {mean_4xl} outside the tamed model's range")
    profile_frame(torch, program, frame_d,
                  share_of=("K4 (window_attn_tma)", "window_attn_tma"))
    del program, model, y, frame_d
    torch.cuda.empty_cache()

    # 9. the 4xl through the runtime and the CLI: --method scale4x loads
    #    scale4x.nztm; --arch builds the 4xl from the registry
    phase("entry points 4xl")
    w2x = Waifu2x(model_dir, device=dev)
    img = np.random.default_rng(7).random((270, 480, 3), dtype=np.float32)
    rgb, alpha = w2x.convert(img, method="scale4x", tile_size=256, batch_size=8)
    torch.cuda.synchronize()
    if tuple(rgb.shape) != (1080, 1920, 3) or alpha is not None:
        fail(f"scale4x convert output {tuple(rgb.shape)}")
    if not (bool(rgb.isfinite().all()) and 0.05 < float(rgb.mean()) < 0.95):
        fail("scale4x convert output not finite or outside the tamed range")
    ran = "Waifu2x.convert(method=scale4x)"
    if Image is not None:
        src = os.path.join(model_dir, "in4.png")
        out = os.path.join(model_dir, "out4.png")
        Image.fromarray((img * 255).astype(np.uint8)).save(src)
        cli.main(["-i", src, "-o", out, "--method", "scale4x", "--model-dir",
                  model_dir, "--tile-size", "256", "--batch-size", "8",
                  "--device", "cuda"])
        with Image.open(out) as im:
            if im.size != (1920, 1080):
                fail(f"scale4x CLI output size {im.size}")
        Image.fromarray((img[:64, :64] * 255).astype(np.uint8)).save(src)
        cli.main(["-i", src, "-o", out, "--method", "scale4x", "--arch",
                  "waifu2x.swin_unet_4xl", "--device", "cuda"])
        with Image.open(out) as im:
            if im.size != (256, 256):
                fail(f"--arch waifu2x.swin_unet_4xl CLI output size {im.size}")
        ran += " + cli.main --method scale4x (--model-dir, --arch)"
    print(f"4xl 270x480 tile 256 batch 8 ran: {ran}", flush=True)
    del w2x, rgb
    torch.cuda.empty_cache()

    # 10. the other scales at a small size, through the renderer
    phase("other scales")
    for ctor in (SwinUNet, SwinUNet4x, lambda: SwinUNetDownscaled(
            downscale_factor=2)):
        m = ctor()
        from_flax(m, tamed_flax_params(m, seed=1))
        m = m.to(dev).eval().requires_grad_(False)
        prog = TiledRenderer(m).frame_program(256, 256)
        fr = torch.from_numpy(np.random.default_rng(8).integers(
            0, 256, (256, 256, 3), dtype=np.uint8)).to(dev)
        k2.stem_conv3x3.launches = 0
        k1.fused_swin_block_image.launches = 0
        k4.fused_window_attention.launches = 0
        y = prog(fr)
        torch.cuda.synchronize()
        got = (k2.stem_conv3x3.launches, k1.fused_swin_block_image.launches,
               k4.fused_window_attention.launches)
        s = m.i2i_scale
        psnr_s, _same = render_twin_psnr(torch, prog, fr, y, (
            (k2, "stem_conv3x3"), (k1, "fused_swin_block_image")))
        what = f"{m.model_name} (scale {s}) 256x256"
        print(f"{what}: launches K2/K1/K4 {got}; vs twins PSNR {psnr_s:.2f} dB",
              flush=True)
        if tuple(y.shape) != (256 * s, 256 * s, 3) or got != (1, 14, 0):
            fail(f"{what}: output {tuple(y.shape)}, launches {got}")
        if psnr_s < FRAME_PSNR_MIN:
            fail(f"{what}: PSNR vs twins {psnr_s:.2f} dB < {FRAME_PSNR_MIN}")
        del m, prog, y
    torch.cuda.empty_cache()

    # 11. K3 at the iw3 path's shape: both eyes of 8 frames, max_shift 28
    phase("k3")
    b2, (h, w) = 2 * IW3_BATCH, IW3_HW
    gen = torch.Generator(device=dev).manual_seed(3)
    xw = torch.rand((b2, h, w, 3), generator=gen, device=dev)
    # |delta| <= max_shift, the function's contract; pixels near both
    # edges reach the clip of gx to [0, W - 1]
    dw = (torch.rand((b2, h, w), generator=gen, device=dev) * 2 - 1) * 28
    got = k3.warp_x_bounded(xw, dw, 28)
    torch.cuda.synchronize()
    want = k3.warp_x_bounded_plain(xw, dw, 28)
    k3_err, _ = check_close(got, want, (0.0, K3_ATOL), "K3 warp_x_bounded")
    ctrl_ok, ctrl_err, _ = compare(k3.warp_x_bounded(xw, torch.zeros_like(dw), 28),
                                   want, (0.0, K3_ATOL))
    if ctrl_ok:
        fail(f"K3: the kernel given a zero delta passes the check (max abs "
             f"err {ctrl_err}): the check is blind")
    del got, want
    # the library call: grid_sample with the row-only grid, built once
    x_nchw = xw.permute(0, 3, 1, 2).contiguous()
    gx = (torch.arange(w, device=dev, dtype=torch.float32) + dw) / (w - 1) * 2 - 1
    gy = (torch.arange(h, device=dev, dtype=torch.float32) / (h - 1) * 2 - 1
          ).reshape(1, h, 1).expand(b2, h, w)
    grid = torch.stack([gx, gy], dim=-1)
    lib_out = F.grid_sample(x_nchw, grid, mode="bilinear",
                            padding_mode="border", align_corners=True)
    print(f"K3 grid_sample vs twin max abs diff "
          f"{float((lib_out.permute(0, 2, 3, 1) - k3.warp_x_bounded_plain(xw, dw, 28)).abs().max()):.3g}",
          flush=True)
    del lib_out
    k3_tm = compare_timed(
        lambda: k3.warp_x_bounded(xw, dw, 28),
        lambda: k3.warp_x_bounded_plain(xw, dw, 28), torch,
        library=lambda: F.grid_sample(x_nchw, grid, mode="bilinear",
                                      padding_mode="border", align_corners=True))
    # as the path calls it: fp32 image and delta in, fp32 out
    k3_bound = bound(xw.numel() * 4 * 2 + dw.numel() * 4, 3 * xw.numel(),
                     "float32")
    xb = xw.to(torch.bfloat16)
    k3_raw_ms = statistics.median(
        cuda_time(lambda: k3.warp_x_bounded_kernel(xw, dw, 28), torch)
        for _ in range(5))
    k3_bf16_ms = statistics.median(
        cuda_time(lambda: k3.warp_x_bounded_kernel(xb, dw, 28), torch)
        for _ in range(5))
    print(f"K3 warp_x_bounded {tuple(xw.shape)} max_shift 28: err {k3_err:.3g} "
          f"(zero-delta control err {ctrl_err:.3g}) wrapper "
          f"{k3_tm['kernel']:.3f} ms (kernel alone {k3_raw_ms:.3f} ms, on bf16 x "
          f"{k3_bf16_ms:.3f} ms; plan {k3.warp_x_plan(w, 3, torch.float32, 28)}) "
          f"plain {k3_tm['plain']:.3f} ms grid_sample {k3_tm['library']:.3f} ms "
          f"bound {k3_bound[0]:.3f} ms ({k3_bound[1]})", flush=True)
    del xw, dw, xb, x_nchw, grid, gx, gy
    torch.cuda.empty_cache()

    # 12. K7 at DINOv2-S shapes (K7_SHAPES): 1373 = the 1080p path's 28x49
    # patches + cls, on contiguous q, k, v and on the path's strided views
    # of a qkv tensor, at the iw3 batch's 8 frames, VDA's window of 32 and
    # the desktop stream's one frame
    phase("k7")
    k7_rows = {}
    # the device times a launch, in a process of their own
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--k7-device-ms"],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        fail(f"K7 device time: rc {proc.returncode}: {proc.stderr[-2000:]}")
    print(proc.stdout.strip(), flush=True)
    k7_device = json.loads(proc.stdout.strip().splitlines()[-1])
    for n, layout, batch, heads in K7_SHAPES:
        q, k, v = k7_inputs(torch, gen, n, layout, batch, heads)
        got = k7.sdpa(q, k, v)
        torch.cuda.synchronize()
        want = k7.sdpa_plain(q, k, v)
        ok, err, rel_l2 = compare(got, want, (0.0, K7_ATOL))
        if not ok or rel_l2 > K7_REL_L2:
            fail(f"K7 N={n} {layout}: max abs err {err}, relative L2 {rel_l2} "
                 f"(limits {K7_ATOL}, {K7_REL_L2})")
        # controls: the last 29 keys dropped (a ragged tail tile at 1373),
        # and V's keys permuted (V is read as a transposed operand)
        perm = torch.randperm(n, generator=gen, device=dev)
        ctrl = {"cut-keys": k7.sdpa(q, k[:, :, :n - 29], v[:, :, :n - 29]),
                "permuted-V": k7.sdpa(q, k, v[:, :, perm])}
        ctrl_errs = []
        for what, y in ctrl.items():
            c_ok, c_err, c_rel = compare(y, want, (0.0, K7_ATOL))
            if c_ok and c_rel <= K7_REL_L2:
                fail(f"K7 N={n} {layout}: the {what} control passes the check "
                     f"(err {c_err}, rel L2 {c_rel}): the check is blind")
            ctrl_errs.append(f"{what} control err {c_err:.3g} rel-L2 {c_rel:.3g}")
        tm = compare_timed(lambda: k7.sdpa(q, k, v),
                           lambda: k7.sdpa_plain(q, k, v), torch,
                           library=lambda: F.scaled_dot_product_attention(q, k, v))
        lt = dict(k7_launch_times(torch, F, k7, q, k, v),
                  **k7_device[f"{batch} {heads} {n} {layout}"])
        bound_ms, bound_by = bound(4 * q.numel() * 2, 4 * batch * heads * n * n * 64)
        k7_rows[n, layout, batch, heads] = dict(
            batch=batch, heads=heads, max_abs_err=err, rel_l2=rel_l2, ms=tm["kernel"],
            plain_ms=tm["plain"], library_ms=tm["library"], bound_ms=bound_ms,
            bound_by=bound_by, **lt)
        share = {key: "not measured" if t is None else
                 f"{t:.4f} ms ({bound_ms / t:.1%})" for key, t in lt.items()}
        print(f"K7 sdpa ({batch}, {heads}, {n}, 64) {layout}: err {err:.3g} rel-L2 "
              f"{rel_l2:.3g} ({'; '.join(ctrl_errs)}); one launch: kernel "
              f"{tm['kernel']:.4f} ms plain {tm['plain']:.3f} ms SDPA "
              f"{tm['library']:.4f} ms; back to back: kernel {share['ms_b2b']} "
              f"SDPA {share['library_ms_b2b']}; profiler device time: kernel "
              f"{share['ms_device']} SDPA {share['library_ms_device']}; bound "
              f"{bound_ms:.4f} ms ({bound_by}; share in brackets)", flush=True)
        del q, k, v, got, want, ctrl
    torch.cuda.empty_cache()

    # 13. iw3: 8 uint8 1080p frames through the port's frame processor
    phase("iw3 batch")
    iw3_ms, iw3_launches, iw3_psnr = iw3_batch(torch, dev, model_dir, k3, k7)

    # 14. the iw3 CLI on an image (when PIL exists)
    phase("iw3 cli")
    ran = iw3_cli(model_dir)
    print(f"iw3 image CLI ran: {ran}", flush=True)

    # 14a. iw3's other methods on the same frames, and their CLI
    phase("iw3 methods")
    iw3_methods = iw3_methods_phase(torch, dev, model_dir, k3, k7)
    print(f"iw3 methods CLI ran: {iw3_methods_cli(model_dir)}", flush=True)
    print(f"iw3 methods: {smi}; " + json.dumps(
        {m: {"ms": r["ms"], "fps": 1000 * IW3_BATCH / r["ms"],
             "device_ms": r["device_ms"], "launches": r["launches"],
             "psnr_vs_twins": r["psnr"], "psnr_vs_k3_twin": r["psnr_k3"]}
         for m, r in iw3_methods.items()}),
        flush=True)

    # 14b. iw3's temporal path: VDA (windowed, streaming), the EMA
    #      lookahead, mlbw_l2_inpaint_video, through the lagged processor
    phase("iw3 temporal")
    iw3_temporal = iw3_temporal_phase(torch, dev, model_dir, k3, k7)
    print(f"iw3 temporal: {smi}; " + json.dumps(iw3_temporal), flush=True)

    # 14c. iw3's other depth families at full width on seeded weights
    phase("iw3 depth families")
    families = depth_families_phase(torch, dev, model_dir, k3, k7)
    print(f"iw3 depth families: {smi}; " + json.dumps(families), flush=True)

    # 14d. iw3's extras: crop, DepthAA, the estimator, anaglyph / VR180 /
    #      half-RGBD / debug depth, the lagged case, the CLI
    phase("iw3 extras")
    extras = iw3_extras_phase(torch, dev, model_dir, k3, k7, smi)
    print(f"iw3 extras: {smi}; " + json.dumps(extras), flush=True)

    # 14e. iw3's desktop stream: raw 1080p frames over the capture socket,
    #      run_pipeline at batch 1 (Any_V2_S, row_flow_v3), /stream read
    phase("iw3 desktop")
    desktop = desktop_phase(torch, dev, model_dir, k3, k7, smi)
    print(f"iw3 desktop: {smi}; " + json.dumps(desktop), flush=True)

    # 14f. cliqa (BASELINE config 3): the filter CLI on the card against the
    #      CPU, and the reference .pth rows
    phase("cliqa")
    cliqa = cliqa_phase(torch, dev, smi)
    print(f"cliqa: {smi}; " + json.dumps(cliqa), flush=True)

    # 14g. the bundled turbo_2x zoo: load, catrom, frame, eval set, convert
    phase("waifu2x turbo")
    turbo_phase(torch, dev, smi, model_dir)
    tmp.cleanup()

    # 14h. the other waifu2x models at full width, the web server (swin_unet_2x
    #      and the bundled turbo), the tile API and the hub
    phase("waifu2x serving")
    serving = serving_phase(torch, dev, k1, k2, smi)

    # 15. the probes T1, T3, T4 against their twins, then their tools
    phase("probes")
    t1, t3, t4, probe_launches, probe_errs = probe_phase(torch, probes, dev)

    # 16. T2 against its twin at both tool shapes, then its tool
    phase("t2")
    t2_runs, t2_launches = t2_phase(torch, probes, dev)

    # 17. video: the engine's round trip, both CLIs' video paths, scene
    #     detection and the autocrop pre-pass, stlizer and BASELINE config 5,
    #     K3 in the two-pass warp, the HDR tone map
    phase("video")
    video = video_phase(torch, dev, k3, k7, {
        "sdpa": k7.sdpa, "warp_x_bounded": k3.warp_x_bounded,
        "fused_swin_block_image": k1.fused_swin_block_image,
        "stem_conv3x3": k2.stem_conv3x3}, smi)
    print(f"video: {smi}; " + json.dumps(video), flush=True)
    video_launches = video_run_launches(video)

    # 18. imagenet swin_t (12 K4 a forward) and vgg11 at batch 64, 224 px
    new_dir = tempfile.TemporaryDirectory()
    phase("imagenet")
    imagenet = imagenet_phase(torch, dev, k4, smi, new_dir.name)
    print(f"imagenet: {smi}; " + json.dumps(imagenet), flush=True)

    # 19. python -m of both CLIs and of i2i (K1 / K2 counted), the tools
    phase("entry points")
    entry, w2x_dir = entry_points_phase(torch, dev, k1, k2, smi, new_dir.name)
    print(f"entry points: {smi}; " + json.dumps(entry), flush=True)

    # 20. swin_unet_2x exported, run in a child that imports only the loader
    phase("export")
    exported = export_phase(torch, dev, k1, k2, smi, new_dir.name, w2x_dir)
    print(f"export: {smi}; " + json.dumps(exported), flush=True)

    # 21. the browser GUI's waifu2x and iw3 jobs on a 1080p PNG over HTTP
    phase("gui")
    gui = gui_phase(torch, dev, k1, k2, k3, k7, smi, new_dir.name, w2x_dir)
    print(f"gui: {smi}; " + json.dumps(gui), flush=True)

    # 22. swin_unet_2x trains through K1 / K2 (backward: the twins' VJP)
    phase("waifu2x training")
    training = training_phase(torch, dev, k1, k2, smi, new_dir.name)
    print(f"waifu2x training: {smi}; " + json.dumps(training), flush=True)

    # 23. the DINOv2 feature loss trains through K7 (backward: the twin's
    # VJP); the other feature-net losses; the inpaint GAN step
    phase("feature losses and GAN")
    feature_gan = feature_gan_phase(torch, dev, k1, k2, k7, smi, new_dir.name)
    print(f"feature losses and GAN: {smi}; " + json.dumps(feature_gan), flush=True)

    # 24. every other trainer: swin_t trains through K4 (backward: the
    # twin's VJP), imagenet, sbs (its export drives the iw3 batch), sod,
    # depth_aa, da3mono, stlizer, cliqa, the mask threshold sweep
    phase("trainers")
    trainers = trainers_phase(torch, dev, k3, k4, k7, smi, new_dir.name)
    print(f"trainers: {smi}; " + json.dumps(trainers), flush=True)
    new_dir.cleanup()

    k1_bf16 = [r for r in k1_rows if r["dtype"] == "bfloat16"]
    # launches per frame of each K1 main-path shape; swin4's first block
    # (C = 192, with skip) is counted at the timed shape without skip
    per_frame = {
        (96, 1104, 0, False): 1, (96, 1104, 3, False): 2,
        (96, 1104, 0, True): 1, (192, 552, 0, False): 2,
        (192, 552, 3, False): 2, (192, 276, 0, False): 3,
        (192, 276, 3, False): 3}

    def k1_sum(key):
        return sum(r[key] * per_frame[(r["C"], r["H"], r["shift"], r["skip"])]
                   for r in k1_bf16)

    k4_bf16 = [r for r in k4_rows if r["dtype"] == "bfloat16"]

    def k4_sum(key):
        return sum(r[key] * K4_FRAME[(r["C"], r["H"], r["W"], r["shift"])]
                   for r in k4_bf16)

    def bound_by(rows, mult):
        """The limit (bytes or operations) of the larger share of a frame's
        summed per-launch bounds."""
        share = {"bytes": 0.0, "operations": 0.0}
        for r in rows:
            share[r["bound_by"]] += r["bound_ms"] * mult(r)
        return max(share, key=share.get)

    def k2_sum(key):  # one launch in each path's frame
        return sum(r[key] for r in k2_rows)

    k7_main = k7_rows[1373, "contiguous", IW3_BATCH, 6]
    k7_path = k7_rows[1373, "strided", IW3_BATCH, 6]
    # the bf16 K1 / K5 kernel's build: one instantiation a tile size
    swin_build = {f"{rows} rows": ptxas_usage(log, f"swin_block_wgmmaILi96ELi{mt}E")
                  for rows, mt in ((256, 2), (128, 1))}

    def block_extras(rows, mult):
        """K1 / K5 fields beyond the common ones: the frame sum of the
        composite, the build's registers and spills, and the shapes one by
        one as this run measured them."""
        keys = ("C", "H", "W", "shift", "skip", "batch", "ms", "plain_ms",
                "composite_ms", "composite_err", "bound_ms", "bound_by",
                "max_abs_err")
        return {"composite_ms": sum(r["composite_ms"] * mult(r) for r in rows),
                "build": swin_build,
                "per_shape": [dict((k, r[k]) for k in keys if k in r)
                              for r in rows]}
    k5_bf16 = [r for r in k5_rows if r["dtype"] == "bfloat16"]
    k5_main = [r for r in k5_bf16 if r["batch"] == 1]

    def k5_sum(key):
        return sum(r[key] * K5_FRAME[(r["C"], r["H"], r["W"], r["shift"])]
                   for r in k5_main)

    k6_bf16 = [r for r in k6_rows if r["dtype"] == "bfloat16"]

    def k6_sum(key):
        return sum(r[key] * K4_FRAME[(r["C"], r["H"], r["W"], r["shift"])]
                   for r in k6_bf16)

    # the probes: T1 at the tool's first block (8 x 8 windows), T3 in bf16
    # (int8 beside it), T4 at each shape (the bf16 headpack shape first)
    t1_main = next(r for r in t1["rows"] if (r["rh"], r["cw"]) == (8, 8))
    t1_bound = bound(t1["nbytes"], 0)
    t3_bound = bound(t3["bf16"]["nbytes"], t3["bf16"]["flops"])
    t3_bound_i8 = bound(t3["int8"]["nbytes"], t3["int8"]["flops"], "int8")
    t4_bounds = [bound(r["nbytes"], r["flops"], "int8" if r["int8"] else "bfloat16")
                 for r in t4]
    t2_main = next(r for r in t2_runs if (r["C"], r["name"]) == (96, "P4"))

    def wide(label):
        """K4 or K6 at the window-7 / window-8 shapes (swin_t's stages
        and one window-8 shape), each checked and timed alone."""
        return [dict((k, r[k]) for k in (
            "C", "HW", "window", "batch", "shift", "max_abs_err", "ms", "ms_b2b",
            "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_share"))
            for r in swin_t_rows if r["kernel"] == label]

    # the bf16 K4 / K6 kernel's build at the paths' instantiations: (head
    # dim / 16, key tiles, N) with the bias in shared memory
    window_build = {f"hd {16 * kt} N {n}": ptxas_usage(
        log, f"window_attn_tmaILi{kt}ELi{tiles}ELi{n}ELb1E")
        for kt, tiles, n in ((1, 3, 36), (2, 3, 36), (2, 4, 49), (2, 4, 64))}

    def window_extras(rows, frame_sum):
        """K4 / K6 fields beyond the common ones, all measured in this run:
        the frame sum back to back, the build's registers and spills, and
        each shape's times."""
        keys = ("C", "H", "W", "shift", "ms", "ms_b2b", "bound_ms",
                "bound_share", "max_abs_err")
        return {"ms_b2b": frame_sum("ms_b2b"), "build": window_build,
                "per_shape": [dict((k, r[k]) for k in keys) for r in rows]}
    kernels = {"kernels": [
        {"name": "stem_conv3x3", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/conv3x3.cu",
         "replaces": "nunif_tpu/ops/conv3x3.py:58",
         "launches": launches["stem_conv3x3"] + launches_4xl["stem_conv3x3"],
         # each "video" phase run, counted alone (waifu2x: 1 a frame)
         "video_launches": {run: n["stem_conv3x3"] for run, n in video_launches.items()},
         # each "waifu2x serving" server: its 4 requests, a tile, a TTA tile
         "serving_launches": serving_counts(serving, "stem_conv3x3"),
         # python -m cli.i2i on a 1080p PNG, the exported program's batch,
         # the GUI's waifu2x job on a 1080p PNG
         "i2i_launches": entry["i2i"]["launches"]["stem_conv3x3"],
         "export_launches": exported["launches"]["stem_conv3x3"],
         "gui_launches": gui["waifu2x"]["launches"]["stem_conv3x3"],
         # a swin_unet_2x training forward and backward (the twin's VJP)
         "train_launches": training["step"]["forward_launches"]["stem_conv3x3"],
         "train_backward_launches": training["step"]["backward_launches"]["stem_conv3x3"],
         "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
         "ms": k2_sum("ms"), "plain_ms": k2_sum("plain_ms"),
         "bound_ms": k2_sum("bound_ms"),
         "bound_by": bound_by(k2_rows, lambda r: 1),
         "library_ms": k2_sum("library_ms")},
        {"name": "fused_swin_block_image", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/swin_block.cu",
         "replaces": "nunif_tpu/ops/swin_attention.py:976",
         "launches": launches["fused_swin_block_image"],
         "video_launches": {run: n["fused_swin_block_image"] for run, n in video_launches.items()},
         "serving_launches": serving_counts(serving, "fused_swin_block_image"),
         "i2i_launches": entry["i2i"]["launches"]["fused_swin_block_image"],
         "export_launches": exported["launches"]["fused_swin_block_image"],
         "gui_launches": gui["waifu2x"]["launches"]["fused_swin_block_image"],
         # a swin_unet_2x training forward and backward (the twin's VJP)
         "train_launches": training["step"]["forward_launches"]["fused_swin_block_image"],
         "train_backward_launches": training["step"]["backward_launches"]["fused_swin_block_image"],
         "max_abs_err": max(r["max_abs_err"] for r in k1_bf16),
         "ms": k1_sum("ms"), "plain_ms": k1_sum("plain_ms"),
         "bound_ms": k1_sum("bound_ms"),
         "bound_by": bound_by(k1_bf16, lambda r: per_frame[
             (r["C"], r["H"], r["shift"], r["skip"])]),
         "library_ms": None, **block_extras(k1_bf16, lambda r: per_frame[
             (r["C"], r["H"], r["shift"], r["skip"])])},
        {"name": "warp_x_bounded", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/warp_x.cu",
         "replaces": "nunif_tpu/modules/grid_sample.py:176",
         "launches": iw3_launches["warp_x_bounded"], "max_abs_err": k3_err,
         # each iw3 method's batch (the "iw3 methods" phase), counted alone
         "method_launches": {m: r["launches"]["warp_x_bounded"]
                             for m, r in iw3_methods.items()},
         # each "iw3 temporal" case's whole run (flush included)
         "temporal_launches": {c: iw3_temporal[c]["launches"]["warp_x_bounded"]
                               for c in TEMPORAL_CASES},
         # each "iw3 extras" format's batch, and the lagged case's run
         "extras_launches": {c: r["launches"]["warp_x_bounded"]
                             for c, r in extras.items() if "launches" in r},
         # the "iw3 desktop" stream: a frame's launches, over its run
         "desktop_launches": desktop["launches_per_frame"]["warp_x_bounded"]
         * desktop["frames"], "desktop_frames": desktop["frames"],
         # each "video" phase run; SuperPoint's two-pass warp at 1080p
         "video_launches": {run: n["warp_x_bounded"] for run, n in video_launches.items()},
         "two_pass": video["two_pass"],
         # the GUI's iw3 job on a 1080p PNG
         "gui_launches": gui["iw3"]["launches"]["warp_x_bounded"],
         "ms": k3_tm["kernel"], "plain_ms": k3_tm["plain"],
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "library_ms": k3_tm["library"]},
        {"name": "fused_window_attention", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/window_attn.cu",
         "replaces": "nunif_tpu/ops/swin_attention.py:141",
         "launches": launches_4xl["fused_window_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in k4_bf16),
         "ms": k4_sum("ms"), "plain_ms": k4_sum("plain_ms"),
         "bound_ms": k4_sum("bound_ms"),
         "bound_by": bound_by(k4_bf16, lambda r: K4_FRAME[
             (r["C"], r["H"], r["W"], r["shift"])]),
         "library_ms": k4_sum("library_ms"), "windows_7_8": wide("K4"),
         # imagenet swin_t at batch 64 x 224 px, bf16: one forward's
         # launches, its time and images a second
         "swin_t_launches": imagenet["swin_t"]["k4_launches"],
         "swin_t_forward_ms": imagenet["swin_t"]["forward_ms"],
         "swin_t_images_per_s_median": imagenet["swin_t"]["images_per_s_median"],
         # a swin_t training step at batch 16 x 224^2, bf16: the forward's
         # launches, the backward's (the twin's VJP), the gradient ratio
         "train_launches": trainers["swin_t_step"]["forward_launches"][
             "fused_window_attention"],
         "train_backward_launches": trainers["swin_t_step"]["backward_launches"][
             "fused_window_attention"],
         "train_grad_rel_over_own": trainers["swin_t_step"]["worst_rel_over_own"],
         "train_grad_control_rel_over_own":
             trainers["swin_t_step"]["control_rel_over_own"],
         "train_grad_rounding_model_rel_over_own":
             trainers["swin_t_step"]["rounding_model_rel_over_own"],
         "train_fwd_bwd_ms": trainers["swin_t_step"]["fwd_bwd_ms"]["kernel"],
         "train_cli_launches": trainers["imagenet"]["imagenet.swin_t"]["k4_launches"],
         **window_extras(k4_bf16, k4_sum)},
        {"name": "sdpa", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/flash_attn.cu",
         "replaces": "nunif_tpu/ops/sdpa.py:49",
         "launches": iw3_launches["sdpa"],
         "method_launches": {m: r["launches"]["sdpa"]
                             for m, r in iw3_methods.items()},
         "temporal_launches": {c: iw3_temporal[c]["launches"]["sdpa"]
                               for c in TEMPORAL_CASES},
         "max_abs_err": max(r["max_abs_err"] for r in k7_rows.values()),
         # 12 launches a batch, all at (8, 6, 1373, 64)
         "ms": 12 * k7_main["ms"], "plain_ms": 12 * k7_main["plain_ms"],
         "bound_ms": 12 * k7_main["bound_ms"], "bound_by": k7_main["bound_by"],
         "library_ms": 12 * k7_main["library_ms"],
         # as the path calls it: strided views of the qkv projection, 20
         # launches back to back (median of 3); the strided row per launch
         "ms_b2b": 12 * k7_path["ms_b2b"],
         "library_ms_b2b": 12 * k7_path["library_ms_b2b"],
         "strided_per_launch": k7_path,
         # windowed VDA's shape, one launch (strided views, as its trunk
         # passes them); 12 a window of 32 frames
         "vda_window_per_launch": k7_rows[1373, "strided", 32, 6],
         # the "iw3 depth families" phase: each family's batch of 8 frames
         # (DepthPro / DepthPro_S: one frame), counted alone; one launch at
         # DepthPro's 35 tiles and at ZoeD_Any_N's batch (ViT-L, 16 heads)
         "family_launches": {f: r["launches"]["sdpa"] for f, r in families.items()},
         # "iw3 extras": each format's batch of cropped frames (800 rows),
         # and the lagged case's run
         "extras_launches": {c: r["launches"]["sdpa"]
                             for c, r in extras.items() if "launches" in r},
         "desktop_launches": desktop["launches_per_frame"]["sdpa"]
         * desktop["frames"], "desktop_frames": desktop["frames"],
         # the desktop stream's shape: one frame, strided views
         "desktop_per_launch": k7_rows[1373, "strided", 1, 6],
         "video_launches": {run: n["sdpa"] for run, n in video_launches.items()},
         "gui_launches": gui["iw3"]["launches"]["sdpa"],
         "depth_pro_tiles_per_launch": k7_rows[577, "strided", 35, 16],
         "zoe_any_per_launch": k7_rows[1401, "strided", IW3_BATCH, 16],
         # a swin_unet_2x training forward on l1dinov2 (16 x 192^2 -> 197
         # tokens) and its backward (the twin's VJP); the input gradient
         # of the DINOv2 loss against the twin path, over the twin's own
         # bf16 error, and the wrong-scale control's
         "train_launches": feature_gan["losses"]["l1dinov2"]["forward_launches"]["sdpa"],
         "train_backward_launches":
             feature_gan["losses"]["l1dinov2"]["backward_launches"]["sdpa"],
         "train_grad_rel_over_own": feature_gan["k7_grad"]["rel_over_own"],
         "train_grad_control_rel_over_own":
             feature_gan["k7_grad"]["control_rel_over_own"]},
        {"name": "fused_swin_block", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/swin_block.cu",
         "replaces": "nunif_tpu/ops/swin_attention.py:780",
         "launches": launches_k5["fused_swin_block"],
         "max_abs_err": max(r["max_abs_err"] for r in k5_bf16),
         "ms": k5_sum("ms"), "plain_ms": k5_sum("plain_ms"),
         "bound_ms": k5_sum("bound_ms"),
         "bound_by": bound_by(k5_main, lambda r: K5_FRAME[
             (r["C"], r["H"], r["W"], r["shift"])]),
         "library_ms": None, **block_extras(k5_main, lambda r: K5_FRAME[
             (r["C"], r["H"], r["W"], r["shift"])])},
        {"name": "fused_window_attention_image", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/window_attn.cu",
         "replaces": "nunif_tpu/ops/swin_attention.py:1221",
         "launches": k6_launches,
         "max_abs_err": max(r["max_abs_err"] for r in k6_bf16),
         "ms": k6_sum("ms"), "plain_ms": k6_sum("plain_ms"),
         "bound_ms": k6_sum("bound_ms"),
         "bound_by": bound_by(k6_bf16, lambda r: K4_FRAME[
             (r["C"], r["H"], r["W"], r["shift"])]),
         "library_ms": k6_sum("library_ms"),
         "k4_copies_ms": k6_sum("k4_copies_ms"), "windows_7_8": wide("K6"),
         **window_extras(k6_bf16, k6_sum)},
        {"name": "strip_relayout", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/probe_strip.cu",
         "replaces": "tools/microbench_strip.py:54",
         "launches": probe_launches["strip_relayout"],
         "pass_launches": probe_launches["strip_pass"],
         "max_abs_err": probe_errs["strip_relayout"],
         "ms": t1_main["relayout_ms"], "pass_ms": t1_main["pass_ms"],
         # the least of the timed rounds beside their median (ms), and the
         # device time a launch (torch.profiler)
         "ms_min": t1_main["relayout_min_ms"],
         "pass_ms_min": t1_main["pass_min_ms"],
         "device_ms": t1_main["relayout_device_ms"],
         "pass_device_ms": t1_main["pass_device_ms"],
         "plain_ms": t1["plain_ms"], "bound_ms": t1_bound[0],
         "bound_by": t1_bound[1], "library_ms": t1["library_ms"],
         "blocks": t1["rows"]},
        {"name": "window_dots", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/probe_window_ring.cu",
         "replaces": "tools/microbench_int8_attn.py:56",
         "launches": probe_launches["window_dots"],
         "max_abs_err": probe_errs["window_dots_bfloat16"],
         "ms": t3["bf16"]["ms"], "plain_ms": t3["bf16"]["plain_ms"],
         "bound_ms": t3_bound[0], "bound_by": t3_bound[1],
         "library_ms": t3["bf16"]["library_ms"],
         "int8": dict(ms=t3["int8"]["ms"], plain_ms=t3["int8"]["plain_ms"],
                      max_abs_err=probe_errs["window_dots_int8"],
                      bound_ms=t3_bound_i8[0], bound_by=t3_bound_i8[1])},
        {"name": "window_dots_repeat", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/probe_window_dots.cu",
         "replaces": "tools/microbench_mxu_dots.py:52",
         "launches": probe_launches["window_dots_repeat"],
         "max_abs_err": probe_errs["window_dots_repeat"],
         # each window's o of the last repetition (the check output)
         "max_abs_err_windows": probe_errs["window_dots_repeat_windows"],
         "ms": t4[0]["ms"], "plain_ms": t4[0]["plain_ms"],
         "bound_ms": t4_bounds[0][0], "bound_by": t4_bounds[0][1],
         "library_ms": t4[0]["library_ms"],
         "shapes": [dict(label=r["label"], ms=r["ms"], ns=r["ns"],
                         plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                         bound_ms=b[0], bound_by=b[1])
                    for r, b in zip(t4, t4_bounds)]},
        {"name": "swin_pieces", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/probe_swin_pieces.cu",
         "replaces": "tools/microbench_swin_pieces.py:163",
         "launches": t2_launches,
         "max_abs_err": max(r["max_abs_err"] for r in t2_runs),
         # P4 at C = 96 (1104x1920, G 4); every variant and shape below
         "ms": t2_main["ms"], "plain_ms": t2_main["plain_ms"],
         "bound_ms": t2_main["bound_ms"], "bound_by": t2_main["bound_by"],
         "library_ms": t2_main["library_ms"],
         "variants": [dict((k, r[k]) for k in (
             "C", "G", "name", "ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "max_abs_err")) for r in t2_runs]},
    ]}
    # the bf16 K1 / K5 kernel's tile plan (from the library) and the weight
    # bytes its tiles read from L2 over a frame of each path: a count from
    # shapes and the frame tables, not a measurement
    plan = {c: k1.block_plan(c, 2 * c, 6) for c in (96, 192)}

    def frame_l2_bytes(rows, mult, padded):
        return sum(block_l2_weight_bytes(
            plan[r["C"]], r["C"], (r["H"] // 6 + padded * (r["shift"] > 0)) *
            (r["W"] // 6 + padded * (r["shift"] > 0))) * mult(r) for r in rows)
    print("K1 / K5 plan: " + json.dumps({
        "tiles": {str(c): plan[c] for c in plan},
        "l2_weight_bytes_a_frame": {
            "fused_swin_block_image": frame_l2_bytes(k1_bf16, lambda r: per_frame[
                (r["C"], r["H"], r["shift"], r["skip"])], False),
            "fused_swin_block": frame_l2_bytes(k5_main, lambda r: K5_FRAME[
                (r["C"], r["H"], r["W"], r["shift"])], True)}}), flush=True)
    # counts from the plan and the shapes, and the plans themselves, on a
    # line of their own: the kernels line holds measured numbers only
    plan_keys = ("C", "H", "W", "shift", "plan", "bias_bytes")
    print("K4 / K6 frame: " + json.dumps({
        label: {"ms": fsum("ms"), "ms_b2b": fsum("ms_b2b"),
                "bound_ms": fsum("bound_ms"),
                "bound_share_b2b": fsum("bound_ms") / fsum("ms_b2b"),
                "bias_bytes": fsum("bias_bytes"),
                "bias_bytes_one_read_a_window": fsum("bias_bytes_a_window"),
                "per_shape": [dict((k, r[k]) for k in plan_keys) for r in rows],
                "windows_7_8": [dict((k, r[k]) for k in (
                    "C", "HW", "window", "batch", "shift", "plan", "bias_bytes"))
                    for r in swin_t_rows if r["kernel"] == label]}
        for label, fsum, rows in (("K4", k4_sum, k4_bf16),
                                  ("K6", k6_sum, k6_bf16))}), flush=True)
    print("T2 / T4 plan: " + json.dumps(probe_plans(torch, probes)), flush=True)
    from nunif_tpu_torch.tools import microbench_strip as t1_tool
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print("T1 plan: " + json.dumps({
        f"rh {r['rh']} cw {r['cw']}": probes.strip_plan(
            t1_tool.H, t1_tool.W, t1_tool.C, r["rh"], r["cw"], sms)._asdict()
        for r in t1["rows"]}), flush=True)
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--k7-device-ms"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k7_device_child()
        sys.exit(0)
    sys.exit(main())
