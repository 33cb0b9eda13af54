"""waifu2x image CLI (counterpart of ``nunif_tpu/waifu2x/cli.py``).

Usage:
  python -m nunif_tpu_torch.waifu2x.cli -i in.png -o out.png
                                           # the bundled turbo_2x zoo:
                                           # noise0_scale2x.nztm
  python -m nunif_tpu_torch.waifu2x.cli -i in.png -o out.png --tta \\
      --depth 16 --grain                   # 8-way TTA, 16-bit PNG, grain
  python -m nunif_tpu_torch.waifu2x.cli -i in.png -o out.png --method scale \\
      --arch waifu2x.swin_unet_2x          # seeded random weights
  python -m nunif_tpu_torch.waifu2x.cli -i in_dir/ -o out_dir/ --method scale \\
      --model-dir DIR                      # DIR/scale2x.nztm
  python -m nunif_tpu_torch.waifu2x.cli -i in.png -o out.png --method scale4x \\
      --model-dir DIR                      # DIR/scale4x.nztm (e.g. a swin_unet_4xl)
  python -m nunif_tpu_torch.waifu2x.cli -i in.png -o out.png --method scale4x \\
      --arch waifu2x.swin_unet_4xl         # seeded random weights

Images only: a video input raises ``NotImplementedError``; the video
flags, ``--rotate-*`` and ``--devices`` are not ported.  RGBA and gray +
alpha inputs keep their alpha; ``--grayscale`` reads the image as gray and
writes gray.  ``--device`` defaults to ``cuda`` and fails where CUDA is
missing.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch

from ..utils import pil_io
from ..utils.rgb_noise import apply_rgb_noise, rgb_noise_like
from .runtime import METHODS, Waifu2x, default_model_dir

logger = logging.getLogger("nunif_tpu_torch.waifu2x")

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp", ".tif", ".tiff")
VIDEO_EXTS = (".mp4", ".mkv", ".avi", ".webm", ".mov", ".m2ts", ".ts")


def _tile_size_arg(v):
    """int or "HxW" (rectangular tiles, e.g. 592x1936)."""
    s = str(v).lower()
    if "x" in s:
        h, w = s.split("x")
        return (int(h), int(w))
    return int(s)


def create_parser():
    p = argparse.ArgumentParser(
        prog="nunif_tpu_torch.waifu2x",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--input", "-i", required=True,
                   help="input file, directory, or text file of paths")
    p.add_argument("--output", "-o", required=True,
                   help="output file or directory")
    p.add_argument("--method", "-m", default="noise_scale", choices=METHODS)
    p.add_argument("--noise-level", "-n", type=int, default=0,
                   choices=[0, 1, 2, 3])
    p.add_argument("--model-dir", type=str, default=None,
                   help="model checkpoint directory (default: the bundled one)")
    p.add_argument("--arch", type=str, default=None,
                   help="initialize this architecture with seeded random "
                        "weights instead of loading a checkpoint (testing)")
    p.add_argument("--tile-size", type=_tile_size_arg, default=None,
                   help="tile size: int or HxW (e.g. 592x1936)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--tta", action="store_true")
    p.add_argument("--format", "-f", default="png",
                   choices=["png", "webp", "jpeg"])
    p.add_argument("--quality", "-q", type=int, default=95)
    p.add_argument("--resume", action="store_true",
                   help="skip outputs that already exist")
    p.add_argument("--recursive", "-r", action="store_true")
    p.add_argument("--grayscale", action="store_true",
                   help="read the image as gray and write gray")
    p.add_argument("--image-lib", default="pil", choices=["pil"])
    p.add_argument("--style", default=None,
                   choices=["art", "photo", "scan", "art_scan"],
                   help="model style; selects <model-dir>/<style> when "
                        "that subdirectory exists")
    p.add_argument("--depth", type=int, default=8, choices=[8, 16],
                   help="output bit depth (16: a 16-bit PNG)")
    p.add_argument("--grain", action="store_true",
                   help="add film grain after denoising")
    p.add_argument("--grain-strength", type=float, default=0.2)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda fails where CUDA is missing")
    return p


def _iter_inputs(args):
    inp = args.input
    if os.path.isdir(inp):
        for root, _dirs, files in os.walk(inp):
            for f in sorted(files):
                if f.lower().endswith(IMAGE_EXTS):
                    yield os.path.join(root, f)
            if not args.recursive:
                break
    elif inp.lower().endswith(".txt"):
        with open(inp) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line
    else:
        yield inp


def _output_path(args, in_path):
    if os.path.isdir(args.output) or args.output.endswith(os.sep) \
            or (not os.path.splitext(args.output)[1]):
        os.makedirs(args.output, exist_ok=True)
        stem = os.path.splitext(os.path.basename(in_path))[0]
        return os.path.join(args.output, stem + "." + args.format)
    parent = os.path.dirname(args.output)
    if parent:
        os.makedirs(parent, exist_ok=True)
    return args.output


def _build_runtime(args) -> Waifu2x:
    model_dir = args.model_dir
    if not model_dir:
        model_dir = default_model_dir() or ""
        if model_dir:
            logger.info("using bundled model dir %s", model_dir)
    if model_dir and args.style:
        styled = os.path.join(model_dir, args.style)
        if os.path.isdir(styled):
            model_dir = styled
    w2x = Waifu2x(model_dir=model_dir, device=args.device)
    if args.arch:
        from ..models import create_model, init_flax_default
        from . import models  # noqa: F401  (registers the architectures)
        model = create_model(args.arch)
        init_flax_default(model, torch.Generator().manual_seed(0))
        noise = args.noise_level if args.method.startswith("noise") else None
        w2x.set_slot(args.method, noise, model)
        logger.warning("using RANDOM weights for %s (testing mode)", args.arch)
    return w2x


def process_images(args, w2x: Waifu2x) -> int:
    n = 0
    t0 = time.perf_counter()
    for in_path in _iter_inputs(args):
        out_path = _output_path(args, in_path)
        if args.resume and os.path.exists(out_path):
            continue
        x, meta = pil_io.load_image(
            in_path, color="gray" if args.grayscale else "rgb")
        alpha = None
        if x.shape[-1] in (2, 4):  # gray or RGB + alpha
            alpha = x[..., -1:]
            x = x[..., :-1]
        rgb, out_alpha = w2x.convert(
            x, alpha, method=args.method, noise_level=args.noise_level,
            tile_size=args.tile_size, batch_size=args.batch_size, tta=args.tta)
        if args.grain:
            # half strength on images (the JAX CLI's rule), a generator
            # seeded with the image's index
            gen = torch.Generator(device=rgb.device).manual_seed(n)
            rgb = apply_rgb_noise(rgb, rgb_noise_like(rgb, generator=gen),
                                  strength=args.grain_strength * 0.5)
        if out_alpha is not None:
            rgb = torch.cat([rgb, out_alpha], dim=-1)
        kwargs = {}
        if args.format in ("jpeg", "webp"):
            kwargs["quality"] = args.quality
        pil_io.save_image(rgb.cpu().numpy(), out_path, meta,
                          bit_depth=args.depth, **kwargs)
        n += 1
    dt = time.perf_counter() - t0
    logger.info("processed %d images in %.2fs", n, dt)
    return n


def main(argv=None) -> int:
    args = create_parser().parse_args(argv)
    if args.input.lower().endswith(VIDEO_EXTS):
        raise NotImplementedError(
            "video input is not ported to nunif_tpu_torch yet")
    w2x = _build_runtime(args)
    process_images(args, w2x)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
