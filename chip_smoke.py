"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``nunif_tpu_torch/csrc`` and drives
the port's two main paths, each with seeded weights loaded from ``.nztm``
files written by the port:

- waifu2x: holds K1 and K2 against their plain PyTorch twins at the shapes
  of swin_unet_2x's 1080p path, renders one 1080p frame to 4K through
  ``TiledRenderer.frame_program``, checks that the frame went through the
  kernels (launch counters) and agrees with the twin path, and drives
  ``Waifu2x.convert`` (and the CLI when PIL is present) on a multi-tile
  image;
- iw3: holds K3 (stereo warp) and K7 (DINOv2 attention) against their twins
  at the shapes of the 1080p half-SBS path, each with a control that must
  fail, runs a batch of 8 uint8 1080p frames through ``Iw3FrameProcessor``
  (Any_V2_S depth, row_flow_v3, divergence 2, edge dilation 2, half-SBS),
  checks the launch counters, the time and the agreement with the twin
  path, and drives the iw3 CLI on an image when PIL is present.

Prints, before the last line, the card's name and power limit
(``nvidia-smi``) and one JSON line of per-kernel results (bf16; ``ms`` and
``plain_ms`` add up the launches of one frame (K1, K2) or one batch of 8
frames (K3, K7) at their main-path shapes, each shape timed on its own);
the last line is ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero and prints no result.  Needs CUDA: without it, or without the
repository beside this file, it exits 1.
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
FRAME_PSNR_MIN = 45.0  # uint8 frame, kernel path vs twin path, tamed weights
# K3 sums the twin's two non-zero fp32 products with the twin's roundings
K3_ATOL = 1e-5
# K7 rounds unnormalised probabilities and rescales online where the twin
# rounds normalised ones: abs and relative-L2 bounds, both must hold
K7_ATOL, K7_REL_L2 = 1e-2, 1e-2
IW3_BATCH, IW3_HW = 8, (1080, 1920)


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


def cuda_time(fn, torch):
    """Milliseconds of one call, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def compare_timed(kernel, plain, torch, rounds=2):
    """Warm both, then time in turns plain, kernel, kernel, plain; medians."""
    kernel()
    plain()
    torch.cuda.synchronize()
    times = {"kernel": [], "plain": []}
    for _ in range(rounds):
        for which in ("plain", "kernel", "kernel", "plain"):
            times[which].append(cuda_time(kernel if which == "kernel" else plain,
                                          torch))
    return statistics.median(times["kernel"]), statistics.median(times["plain"])


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
    saved = (k3.warp_x_bounded, k7.sdpa)
    k3.warp_x_bounded, k7.sdpa = k3.warp_x_bounded_plain, k7.sdpa_plain
    try:
        out_twin = proc(frames)
        torch.cuda.synchronize()
    finally:
        k3.warp_x_bounded, k7.sdpa = saved
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

    from nunif_tpu_torch.ops import _build
    from nunif_tpu_torch.ops import conv3x3 as k2
    from nunif_tpu_torch.ops import swin_attention as k1
    from nunif_tpu_torch.modules.attention import expand_relative_bias
    from nunif_tpu_torch.models import from_flax, load_model, save_model
    from nunif_tpu_torch.utils.tiling import TiledRenderer
    from nunif_tpu_torch.waifu2x.models.swin_unet import (SwinUNet2x,
                                                          tamed_flax_params)
    from nunif_tpu_torch.waifu2x.runtime import Waifu2x
    from nunif_tpu_torch.modules import grid_sample as k3
    from nunif_tpu_torch.ops import sdpa as k7

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
                    if "registers" in line or "spill" in line), flush=True)

    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    # 3. K2 at patch_conv1's main-path shape
    phase("k2")
    k2_rows = []
    x = rng.normal(0, 0.5, (1, 1118, 1934, 48))
    kern = t(rng.normal(0, 1 / np.sqrt(9 * 48), (3, 3, 48, 96)))
    bias = t(rng.normal(0, 0.1, (96,)))
    for dtype in (torch.bfloat16, torch.float32):
        xd = t(x, dtype)
        kw = dict(crop=6, lrelu_slope=0.1)
        got = k2.stem_conv3x3(xd, kern, bias, **kw)
        torch.cuda.synchronize()
        want = k2.stem_conv3x3_plain(xd, kern, bias, **kw)
        if got.shape != (1, 1104, 1920, 96):
            fail(f"K2 output shape {tuple(got.shape)}")
        name = str(dtype).split(".")[1]
        err, _ = check_close(got, want, K2_TOL[name], f"K2 {name}")
        ms, plain_ms = compare_timed(
            lambda: k2.stem_conv3x3(xd, kern, bias, **kw),
            lambda: k2.stem_conv3x3_plain(xd, kern, bias, **kw), torch)
        row = dict(dtype=name, max_abs_err=err, ms=ms, plain_ms=plain_ms)
        print(f"K2 stem_conv3x3 {name}: {row}", flush=True)
        k2_rows.append(row)
        del got, want, xd

    # 4. K1 at every main-path shape
    phase("k1")
    k1_rows = []
    shapes = [(96, 1104, 1920, 0, False), (96, 1104, 1920, 3, False),
              (96, 1104, 1920, 0, True), (192, 552, 960, 0, False),
              (192, 552, 960, 3, False), (192, 276, 480, 0, False),
              (192, 276, 480, 3, False)]
    for c, h, w, shift, with_skip in shapes:
        hid = 2 * c
        weights = [t(rng.standard_normal((c, 3 * c)) / np.sqrt(c)),
                   t(rng.normal(0, 0.02, (3 * c,))),
                   t(rng.standard_normal((c, c)) / np.sqrt(c)),
                   t(rng.normal(0, 0.02, (c,))),
                   t(rng.standard_normal((c, hid)) / np.sqrt(c)),
                   t(rng.normal(0, 0.02, (hid,))),
                   t(rng.standard_normal((hid, c)) / np.sqrt(hid)),
                   t(rng.normal(0, 0.02, (c,))),
                   # std 1, not the init's 0.02, so that the bias moves the
                   # output well past the bf16 tolerance (control below)
                   expand_relative_bias(t(rng.standard_normal((121, 6))), 6)]
        no_bias = weights[:-1] + [torch.zeros_like(weights[-1])]
        x = rng.normal(0, 0.5, (1, h, w, c))
        s = rng.normal(0, 0.5, (1, h, w, c)) if with_skip else None
        for dtype in (torch.bfloat16, torch.float32):
            xd = t(x, dtype)
            sd = None if s is None else t(s, dtype)
            kw = dict(num_heads=6, window=6, shift=shift, skip=sd)
            got = k1.fused_swin_block_image(xd, *weights, **kw)
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
            del got, want
            ms, plain_ms = compare_timed(
                lambda: k1.fused_swin_block_image(xd, *weights, **kw),
                lambda: k1.swin_block_image_plain(xd, *weights, **kw), torch)
            row = dict(C=c, H=h, W=w, shift=shift, skip=with_skip, dtype=name,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms)
            print(f"{what}: err {err:.3g} rel-L2 {rel_l2:.3g} (no-bias "
                  f"control err {ctrl_err:.3g}) kernel {ms:.3f} ms plain "
                  f"{plain_ms:.3f} ms", flush=True)
            k1_rows.append(row)
            del xd, sd
            torch.cuda.empty_cache()

    # 5. one 1080p frame through the port's main path
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
    k2.stem_conv3x3.launches = 0
    k1.fused_swin_block_image.launches = 0
    y = program(frame_d)
    torch.cuda.synchronize()
    launches = {"stem_conv3x3": k2.stem_conv3x3.launches,
                "fused_swin_block_image": k1.fused_swin_block_image.launches}
    print(f"frame launches: {launches}", flush=True)
    if tuple(y.shape) != (2160, 3840, 3) or y.dtype != torch.uint8:
        fail(f"frame output {tuple(y.shape)} {y.dtype}")
    if launches != {"stem_conv3x3": 1, "fused_swin_block_image": 14}:
        fail(f"frame did not run each kernel as expected: {launches}")
    frame_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        program(frame_d)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    # the same frame through the twins, on the card
    saved = (k2.stem_conv3x3, k1.fused_swin_block_image)
    k2.stem_conv3x3 = k2.stem_conv3x3_plain
    k1.fused_swin_block_image = k1.swin_block_image_plain
    try:
        y_twin = program(frame_d)
        torch.cuda.synchronize()
    finally:
        k2.stem_conv3x3, k1.fused_swin_block_image = saved
    d = y.float() - y_twin.float()
    mse = float((d * d).mean())
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    same = float((d == 0).float().mean())
    print(f"frame 1080p->4K: median {statistics.median(frame_ms):.1f} ms "
          f"(runs {[round(v, 1) for v in frame_ms]}); vs twins PSNR "
          f"{psnr:.2f} dB, identical px {same:.4f}, max diff "
          f"{float(d.abs().max()):.0f}", flush=True)
    if psnr < FRAME_PSNR_MIN:
        fail(f"frame PSNR vs twins {psnr:.2f} dB < {FRAME_PSNR_MIN}")
    yf = y.float() / 255.0
    if not 0.05 < float(yf.mean()) < 0.95:
        fail(f"frame mean {float(yf.mean())} outside the tamed model's range")

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
    if Image is not None:
        from nunif_tpu_torch.waifu2x import cli
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
    del program, renderer, model, w2x, y, y_twin, frame_d
    torch.cuda.empty_cache()

    # 7. K3 at the iw3 path's shape: both eyes of 8 frames, max_shift 28
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
    k3_ms, k3_plain_ms = compare_timed(lambda: k3.warp_x_bounded(xw, dw, 28),
                                       lambda: k3.warp_x_bounded_plain(xw, dw, 28),
                                       torch)
    xb = xw.to(torch.bfloat16)
    k3_raw_ms = statistics.median(
        cuda_time(lambda: k3.warp_x_bounded_kernel(xb, dw), torch)
        for _ in range(5))
    print(f"K3 warp_x_bounded {tuple(xw.shape)} max_shift 28: err {k3_err:.3g} "
          f"(zero-delta control err {ctrl_err:.3g}) wrapper {k3_ms:.3f} ms "
          f"(kernel alone on bf16 x {k3_raw_ms:.3f} ms) plain {k3_plain_ms:.3f} ms",
          flush=True)
    del xw, dw, xb
    torch.cuda.empty_cache()

    # 8. K7 at DINOv2-S shapes: 1373 = the 1080p path's 28x49 patches + cls
    phase("k7")
    k7_rows = {}
    for n in (1373, 1344, 197):
        q, k, v = (torch.randn((IW3_BATCH, 6, n, 64), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        got = k7.sdpa(q, k, v)
        torch.cuda.synchronize()
        want = k7.sdpa_plain(q, k, v)
        ok, err, rel_l2 = compare(got, want, (0.0, K7_ATOL))
        if not ok or rel_l2 > K7_REL_L2:
            fail(f"K7 N={n}: max abs err {err}, relative L2 {rel_l2} (limits "
                 f"{K7_ATOL}, {K7_REL_L2})")
        # control: the last 29 keys dropped (a ragged tail tile at 1373)
        cut = k7.sdpa(q, k[:, :, :n - 29], v[:, :, :n - 29])
        c_ok, c_err, c_rel = compare(cut, want, (0.0, K7_ATOL))
        if c_ok and c_rel <= K7_REL_L2:
            fail(f"K7 N={n}: the kernel without the last 29 keys passes the "
                 f"check (err {c_err}, rel L2 {c_rel}): the check is blind")
        ms, plain_ms = compare_timed(lambda: k7.sdpa(q, k, v),
                                     lambda: k7.sdpa_plain(q, k, v), torch)
        k7_rows[n] = dict(max_abs_err=err, rel_l2=rel_l2, ms=ms, plain_ms=plain_ms)
        print(f"K7 sdpa (8, 6, {n}, 64): err {err:.3g} rel-L2 {rel_l2:.3g} "
              f"(cut-keys control err {c_err:.3g} rel-L2 {c_rel:.3g}) kernel "
              f"{ms:.3f} ms plain {plain_ms:.3f} ms", flush=True)
        del q, k, v, got, want, cut
    torch.cuda.empty_cache()

    # 9. iw3: 8 uint8 1080p frames through the port's frame processor
    phase("iw3 batch")
    iw3_ms, iw3_launches, iw3_psnr = iw3_batch(torch, dev, model_dir, k3, k7)

    # 10. the iw3 CLI on an image (when PIL exists)
    phase("iw3 cli")
    ran = iw3_cli(model_dir)
    print(f"iw3 image CLI ran: {ran}", flush=True)
    tmp.cleanup()

    k1_bf16 = [r for r in k1_rows if r["dtype"] == "bfloat16"]
    # launches per frame of each K1 main-path shape; swin4's first block
    # (C = 192, with skip) is counted at the timed shape without skip
    per_frame = {
        (96, 1104, 0, False): 1, (96, 1104, 3, False): 2,
        (96, 1104, 0, True): 1, (192, 552, 0, False): 2,
        (192, 552, 3, False): 2, (192, 276, 0, False): 3,
        (192, 276, 3, False): 3}

    def frame_sum(key):
        return sum(r[key] * per_frame[(r["C"], r["H"], r["shift"], r["skip"])]
                   for r in k1_bf16)

    k2_bf16 = k2_rows[0]
    kernels = {"kernels": [
        {"name": "stem_conv3x3", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/conv3x3.cu",
         "replaces": "nunif_tpu/ops/conv3x3.py:58",
         "launches": launches["stem_conv3x3"],
         "max_abs_err": k2_bf16["max_abs_err"], "ms": k2_bf16["ms"],
         "plain_ms": k2_bf16["plain_ms"]},
        {"name": "fused_swin_block_image", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/swin_block.cu",
         "replaces": "nunif_tpu/ops/swin_attention.py:976",
         "launches": launches["fused_swin_block_image"],
         "max_abs_err": max(r["max_abs_err"] for r in k1_bf16),
         "ms": frame_sum("ms"), "plain_ms": frame_sum("plain_ms")},
        {"name": "warp_x_bounded", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/warp_x.cu",
         "replaces": "nunif_tpu/modules/grid_sample.py:176",
         "launches": iw3_launches["warp_x_bounded"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms},
        {"name": "sdpa", "route": "cuda",
         "source": "nunif_tpu_torch/csrc/flash_attn.cu",
         "replaces": "nunif_tpu/ops/sdpa.py:49",
         "launches": iw3_launches["sdpa"],
         "max_abs_err": max(r["max_abs_err"] for r in k7_rows.values()),
         # 12 launches a batch, all at (8, 6, 1373, 64)
         "ms": 12 * k7_rows[1373]["ms"], "plain_ms": 12 * k7_rows[1373]["plain_ms"]},
    ]}
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
