"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``nunif_tpu_torch/csrc``, holds each
against its plain PyTorch twin at the shapes of swin_unet_2x's 1080p main
path, renders one 1080p frame to 4K through ``TiledRenderer.frame_program``
with seeded weights loaded from a ``.nztm`` written by the port, checks that
the frame went through the kernels (launch counters) and agrees with the
twin path, and drives ``Waifu2x.convert`` (and the CLI when PIL is present)
on a multi-tile image.

Prints, before the last line, the card's name and power limit
(``nvidia-smi``) and one JSON line of per-kernel results (bf16; K1's ``ms``
and ``plain_ms`` add up the 14 launches of one frame at their main-path
shapes, each timed on its own); the last line is
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
FRAME_PSNR_MIN = 45.0  # uint8 frame, kernel path vs twin path, tamed weights


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
    ]}
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
