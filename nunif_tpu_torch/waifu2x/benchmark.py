"""waifu2x quality benchmark: PSNR / Y-PSNR against a catrom-downscale
baseline (counterpart of ``nunif_tpu/waifu2x/benchmark.py``).

For each image in the eval directory: crop to a multiple of the scale,
downscale by 1/scale (catrom, antialias), optionally add JPEG noise, render
it back up with the model (and with the baseline filters), and report the
mean PSNR / Y-PSNR and the model's time.  ``score_images`` runs the same
protocol on arrays (no PIL unless JPEG noise is asked for).

Usage:
  python -m nunif_tpu_torch.waifu2x.benchmark -i ./eval_images \\
      --model-file models/waifu2x/turbo/scale2x.nztm [--baseline]
  python -m nunif_tpu_torch.waifu2x.benchmark -i ./eval_images \\
      --model-file model.nztm [--baseline] [--noise-level 1]
  python -m nunif_tpu_torch.waifu2x.benchmark -i ./eval_images \\
      --arch waifu2x.swin_unet_4xl --scale 4     # seeded random weights
``--device`` defaults to ``cuda`` and fails where CUDA is missing.
"""
from __future__ import annotations

import argparse
import csv
import io
import logging
import os
import sys
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..modules.resize import resize_matrix

logger = logging.getLogger("nunif_tpu_torch.waifu2x")

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp", ".tif", ".tiff")
# JPEG qualities of the evaluation noise per style and noise level (the
# reference's jpeg_noise settings)
EVAL_QUALITY = {
    "art": {0: [90], 1: [75], 2: [53, 46], 3: [53, 46]},
    "photo": {0: [90], 1: [80], 2: [60, 90], 3: [60, 90]},
}


def listdir_images(d):
    """Image files under ``d``, recursively, sorted within each directory."""
    out = []
    for root, _dirs, files in os.walk(d):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in IMAGE_EXTS:
                out.append(os.path.join(root, f))
    return out


def add_jpeg_noise(im, quality: int, subsampling: str):
    """One JPEG round trip of a PIL RGB image."""
    from PIL import Image
    with io.BytesIO() as buff:
        im.save(buff, format="jpeg", quality=int(quality),
                subsampling=subsampling)
        buff.seek(0)
        out = Image.open(buff)
        out.load()
        return out


def _np_resize(arr, out_h, out_w, mode="catrom", antialias=True):
    mh = resize_matrix(arr.shape[0], out_h, mode, antialias)
    mw = resize_matrix(arr.shape[1], out_w, mode, antialias)
    out = np.einsum("oh,hwc->owc", mh, arr)
    return np.clip(np.einsum("pw,owc->opc", mw, out), 0.0, 1.0)


def psnr(a, b):
    mse = np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2)
    return 10.0 * np.log10(1.0 / max(mse, 1e-10))


def y_psnr(a, b):
    w = np.array([0.299, 0.587, 0.114], np.float32)
    return psnr(a @ w, b @ w)


def iter_images(d):
    from ..utils.pil_io import load_image
    for f in listdir_images(d):
        x, _ = load_image(f)
        yield f, x[..., :3]


def create_parser():
    p = argparse.ArgumentParser(prog="nunif_tpu_torch.waifu2x.benchmark",
                                description=__doc__)
    p.add_argument("--input", "-i", required=True, help="eval image dir")
    p.add_argument("--model-file", default=None, help=".nztm checkpoint")
    p.add_argument("--arch", default=None,
                   help="seeded random-init arch instead of a checkpoint "
                        "(time only)")
    p.add_argument("--scale", type=int, default=2)
    p.add_argument("--noise-level", type=int, default=-1,
                   choices=[-1, 0, 1, 2, 3])
    p.add_argument("--style", default="art", choices=["art", "photo"])
    p.add_argument("--baseline", action="store_true",
                   help="also measure catrom/lanczos/bilinear upscale baselines")
    p.add_argument("--tile-size", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--output", "-o", default=None, help="CSV output path")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda fails where CUDA is missing")
    return p


def _load_renderer(args, device):
    from ..models import create_model, init_flax_default, load_model
    from ..utils.tiling import TiledRenderer
    from . import models  # noqa: F401  (registers the architectures)
    if args.model_file:
        model, _meta = load_model(args.model_file, device=device)
    elif args.arch:
        model = create_model(args.arch)
        init_flax_default(model, torch.Generator().manual_seed(0))
        model = model.to(device).eval().requires_grad_(False)
    else:
        return None, None
    return model, TiledRenderer(model)


def degrade(hr, scale: int, noise_level: int = -1, style: str = "art"):
    """The protocol's input for one image: hr cropped to a multiple of
    ``scale``, downscaled by catrom with antialias and, for noise_level >=
    0, put through the style's JPEG round trips (needs PIL).  Returns
    (cropped hr, lr)."""
    h, w = hr.shape[:2]
    hr = hr[:h - h % scale, :w - w % scale]
    lr = _np_resize(hr, hr.shape[0] // scale, hr.shape[1] // scale)
    if noise_level >= 0:
        from PIL import Image
        im = Image.fromarray((lr * 255 + 0.5).astype(np.uint8))
        for q in EVAL_QUALITY[style][noise_level]:
            im = add_jpeg_noise(im, q, "4:2:0")
        lr = np.asarray(im, np.float32) / 255.0
    return hr, lr


def score_images(images, renderer=None, scale: int = 2, noise_level: int = -1,
                 style: str = "art", baseline: bool = False, tile_size=None,
                 batch_size=None):
    """Score (name, hr) pairs, hr (H, W, 3) float32 in [0, 1], by the
    protocol.  Returns (rows, model seconds): a row per image with the
    model's ``psnr`` / ``y_psnr`` (with a renderer) and, with
    ``baseline``, catrom's, lanczos's and bilinear's."""
    rows = []
    t_model = 0.0
    for name, hr in images:
        hr, lr = degrade(hr, scale, noise_level, style)
        h, w = hr.shape[:2]
        row = {"file": name}
        if renderer is not None:
            t0 = time.perf_counter()
            sr = renderer.render(lr, tile_size=tile_size,
                                 batch_size=batch_size).cpu().numpy()
            t_model += time.perf_counter() - t0
            if renderer.model.i2i_scale != scale:
                sr = _np_resize(sr, h, w)
            row["psnr"] = round(float(psnr(sr, hr)), 4)
            row["y_psnr"] = round(float(y_psnr(sr, hr)), 4)
        if baseline:
            for mode in ("catrom", "lanczos", "bilinear"):
                up = _np_resize(lr, h, w, mode=mode, antialias=False)
                row[f"{mode}_psnr"] = round(float(psnr(up, hr)), 4)
                row[f"{mode}_y_psnr"] = round(float(y_psnr(up, hr)), 4)
        rows.append(row)
    return rows, t_model


def mean_scores(rows) -> dict:
    """{score name: mean over the rows}."""
    keys = [k for k in rows[0] if k != "file"]
    return {k: float(np.mean([r[k] for r in rows])) for k in keys}


def main(argv=None) -> int:
    args = create_parser().parse_args(argv)
    device = resolve_device(args.device)
    _model, renderer = _load_renderer(args, device)
    images = ((os.path.basename(path), hr)
              for path, hr in iter_images(args.input))
    rows, t_model = score_images(
        images, renderer, args.scale, args.noise_level, args.style,
        args.baseline, args.tile_size, args.batch_size)
    if not rows:
        print("no images found", file=sys.stderr)
        return 1
    keys = [k for k in rows[0] if k != "file"]
    for k, v in mean_scores(rows).items():
        print(f"mean {k}: {v:.4f}")
    if renderer is not None:
        print(f"model time: {t_model:.2f}s ({len(rows) / t_model:.2f} img/s)")
    if args.output:
        with open(args.output, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["file"] + keys)
            writer.writeheader()
            writer.writerows(rows)
        logger.info("wrote %s", args.output)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
