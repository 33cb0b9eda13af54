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
  that must fail, and its tool's run.

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
# check only); swin_t is not ported, so no forward pass runs here.
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


def phase(name):
    print(f"== {name}", flush=True)


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


def iw3_models(torch, dev, model_dir):
    """Write shaped seeded weights to .nztm and load them back through the
    port's loaders: (depth model, row_flow_v3), on the card."""
    from nunif_tpu_torch.iw3.depth import create_depth_model
    from nunif_tpu_torch.iw3.depth.depth_anything import (
        DepthAnything, shaped_flax_params as depth_params)
    from nunif_tpu_torch.iw3.models.row_flow_v3 import (
        RowFlowV3, shaped_flax_params as flow_params)
    from nunif_tpu_torch.models import from_flax, load_model, save_model
    depth = DepthAnything(encoder="vits")
    from_flax(depth, depth_params(depth, seed=0))
    save_model(depth, os.path.join(model_dir, "depth_any_v2_s.nztm"))
    flow = RowFlowV3()
    from_flax(flow, flow_params(flow, seed=1))
    save_model(flow, os.path.join(model_dir, "row_flow_v3.nztm"))
    dm = create_depth_model("Any_V2_S", device=dev).load(
        checkpoint=os.path.join(model_dir, "depth_any_v2_s.nztm"))
    flow, _meta = load_model(os.path.join(model_dir, "row_flow_v3.nztm"),
                             device=dev)
    return dm, flow


def iw3_batch(torch, dev, model_dir, k3, k7):
    """8 uint8 1080p frames -> half-SBS through Iw3FrameProcessor: launch
    counts, non-degeneracy, median time of 3 batches after a warm one,
    and PSNR against the same batch through the twins."""
    from nunif_tpu_torch.iw3.composition import StereoFormat
    from nunif_tpu_torch.iw3.pipeline import StereoConfig, apply_divergence
    from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
    dm, flow = iw3_models(torch, dev, model_dir)
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


def k7_inputs(torch, gen, n, layout, batch=IW3_BATCH):
    """(batch, 6, n, 64) bf16 q, k, v: three contiguous tensors, or
    ("strided") views of one (batch, n, 3, 6, 64) qkv tensor, as
    dinov2.Attention passes them on the iw3 path."""
    if layout == "strided":
        qkv = torch.randn((batch, n, 3, 6, 64), generator=gen,
                          device="cuda").to(torch.bfloat16)
        return tuple(qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    return tuple(torch.randn((batch, 6, n, 64), generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for _ in range(3))


def k7_launch_times(torch, F, k7, q, k, v):
    """K7 and SDPA on the same inputs without the host's share: 20 launches
    back to back between two CUDA events (median of 3)."""
    from nunif_tpu_torch.tools import time_ms
    kernel = lambda: k7.sdpa(q, k, v)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    return dict(ms_b2b=time_ms(kernel, 20), library_ms_b2b=time_ms(library, 20))


# K7's shapes (tokens, layout, batch): the iw3 batch's (8 frames of 1080p:
# 28 x 49 patches + cls), two others, and Video Depth Anything's window of
# 32 frames
K7_SHAPES = ((1373, "contiguous", IW3_BATCH), (1344, "contiguous", IW3_BATCH),
             (197, "contiguous", IW3_BATCH), (1373, "strided", IW3_BATCH),
             (1373, "strided", 32))


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
    for n, layout, batch in K7_SHAPES:
        q, k, v = k7_inputs(torch, gen, n, layout, batch)
        out[f"{batch} {n} {layout}"] = dict(
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
        device = profile_frame(torch, lambda f: temporal_run(torch, models, case, f),
                               frames, top=10,
                               share_of=("K7 flash_attn", "flash"))
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


def profile_frame(torch, program, frame, top=12, share_of=None):
    """torch.profiler over one frame (a complete session, ``profiled``):
    the device time (sum over kernels), the top ops by the device time of
    the kernels they launch, and the top kernels by name (the port's own
    kernels, launched through ctypes, belong to no op and show only there);
    with ``share_of`` (label, name part), the device time and share of the
    kernels whose name holds the part.  None, and "not measured", where no
    session was complete."""
    session = profiled(torch, program, frame)
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
    # of a qkv tensor, at the iw3 batch's 8 frames and VDA's window of 32
    phase("k7")
    k7_rows = {}
    # the device times a launch, in a process of their own
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--k7-device-ms"],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        fail(f"K7 device time: rc {proc.returncode}: {proc.stderr[-2000:]}")
    print(proc.stdout.strip(), flush=True)
    k7_device = json.loads(proc.stdout.strip().splitlines()[-1])
    for n, layout, batch in K7_SHAPES:
        q, k, v = k7_inputs(torch, gen, n, layout, batch)
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
                  **k7_device[f"{batch} {n} {layout}"])
        bound_ms, bound_by = bound(4 * q.numel() * 2, 4 * batch * 6 * n * n * 64)
        k7_rows[n, layout, batch] = dict(
            batch=batch, max_abs_err=err, rel_l2=rel_l2, ms=tm["kernel"],
            plain_ms=tm["plain"], library_ms=tm["library"], bound_ms=bound_ms,
            bound_by=bound_by, **lt)
        share = {key: "not measured" if t is None else
                 f"{t:.4f} ms ({bound_ms / t:.1%})" for key, t in lt.items()}
        print(f"K7 sdpa ({batch}, 6, {n}, 64) {layout}: err {err:.3g} rel-L2 "
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

    # 14c. the bundled turbo_2x zoo: load, catrom, frame, eval set, convert
    phase("waifu2x turbo")
    turbo_phase(torch, dev, smi, model_dir)
    tmp.cleanup()

    # 15. the probes T1, T3, T4 against their twins, then their tools
    phase("probes")
    t1, t3, t4, probe_launches, probe_errs = probe_phase(torch, probes, dev)

    # 16. T2 against its twin at both tool shapes, then its tool
    phase("t2")
    t2_runs, t2_launches = t2_phase(torch, probes, dev)

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

    k7_main = k7_rows[1373, "contiguous", IW3_BATCH]
    k7_path = k7_rows[1373, "strided", IW3_BATCH]
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
        """K4 or K6 at the window-7 / window-8 shapes: kernel checks only,
        since swin_t is not ported."""
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
         "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
         "ms": k2_sum("ms"), "plain_ms": k2_sum("plain_ms"),
         "bound_ms": k2_sum("bound_ms"),
         "bound_by": bound_by(k2_rows, lambda r: 1),
         "library_ms": k2_sum("library_ms")},
        {"name": "fused_swin_block_image", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/swin_block.cu",
         "replaces": "nunif_tpu/ops/swin_attention.py:976",
         "launches": launches["fused_swin_block_image"],
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
         "vda_window_per_launch": k7_rows[1373, "strided", 32]},
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
