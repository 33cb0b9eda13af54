"""A synthetic shaky clip for stabilizer tests (counterpart of
``nunif_tpu/stlizer/gen_test_video.py``).

Still images are warped frame by frame along a smoothed gaussian random
walk of shift-x / shift-y / rotation (a fast small band plus a slow large
one; the same trajectory as the JAX generator for the same seed), on the
device, and encoded.  No per-object motion.

    python -m nunif_tpu_torch.stlizer.gen_test_video -i image.png -o shaky.mp4
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..modules.grid_sample import grid_sample
from ..utils.pil_io import load_image
from .pipeline import gaussian_kernel1d, smooth1d


def _band_noise(rng, n, scale, k_fast=3, k_slow=15):
    """Two-band smoothed gaussian noise."""
    fast = smooth1d(rng.standard_normal(n) * scale * 0.8, gaussian_kernel1d(k_fast))
    slow = smooth1d(rng.standard_normal(n) * scale * 0.2, gaussian_kernel1d(k_slow))
    return (fast + slow).astype(np.float32)


def make_shake_trajectory(n_frames: int, noise_scale: float = 10.0,
                          shift: bool = True, rotate: bool = True,
                          seed: int = 71):
    """(tx, ty, angle) arrays of length n_frames (pixels, radians)."""
    rng = np.random.default_rng(seed)
    sw = 1.0 if shift else 0.0
    rw = 1.0 if rotate else 0.0
    tx = _band_noise(rng, n_frames, noise_scale * sw)
    ty = _band_noise(rng, n_frames, noise_scale * sw)
    ang = _band_noise(rng, n_frames, noise_scale * 0.05 * rw) * (np.pi / 180.0)
    return tx, ty, ang


def warp_frames(img, tx, ty, ang):
    """img (H, W, 3) in [0, 1]; tx / ty (B,) pixels, ang (B,) radians ->
    (B, H, W, 3): rotated about the centre, then shifted (bilinear,
    reflection at the borders)."""
    H, W = img.shape[:2]
    dev = img.device
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    tx, ty, ang = (v.reshape(-1, 1, 1) for v in (tx, ty, ang))
    ca, sa = torch.cos(ang), torch.sin(ang)
    x0, y0 = xx - cx, yy - cy
    sx = ca * x0 - sa * y0 + cx + tx
    sy = sa * x0 + ca * y0 + cy + ty
    grid = torch.stack([sx / (W - 1) * 2.0 - 1.0, sy / (H - 1) * 2.0 - 1.0], dim=-1)
    B = grid.shape[0]
    return grid_sample(img[None].expand(B, H, W, 3), grid, mode="bilinear",
                       padding_mode="reflection")


def generate_shaky_video(image_paths, output_path: str,
                         noise_scale: float = 10.0, fps: int = 30,
                         seconds_per_image: float = 5.0,
                         shift: bool = True, rotate: bool = True,
                         seed: int = 71, batch_size: int = 16,
                         device="cuda", config=None):
    """Encode the shaky clip of each image (paths, or HWC float arrays in
    [0, 1], all one size) in turn; returns (frames, (tx, ty, angle))."""
    from ..core.device import resolve_device
    from ..video import VideoOutputConfig, generate_video
    dev = resolve_device(device)
    if isinstance(image_paths, str):
        image_paths = [image_paths]
    imgs = []
    for p in image_paths:
        x = load_image(p)[0] if isinstance(p, str) else np.asarray(p)
        h = x.shape[0] - x.shape[0] % 8  # mod-8 crop
        w = x.shape[1] - x.shape[1] % 8
        imgs.append(np.ascontiguousarray(x[:h, :w, :3], np.float32))
    if any(i.shape != imgs[0].shape for i in imgs):
        raise ValueError("all input images must have the same size")
    n_per = int(round(fps * seconds_per_image))
    tx, ty, ang = make_shake_trajectory(n_per * len(imgs), noise_scale, shift,
                                        rotate, seed)

    def frames():
        k = 0
        for img in imgs:
            dimg = torch.from_numpy(img).to(dev)
            for s in range(0, n_per, batch_size):
                e = min(s + batch_size, n_per)
                sl = slice(k + s, k + e)
                batch = warp_frames(dimg, *(torch.from_numpy(v[sl]).to(dev)
                                            for v in (tx, ty, ang)))
                yield from torch.clamp(batch, 0, 1).mul(255).add(0.5).to(
                    torch.uint8).cpu().numpy()
            k += n_per

    h, w = imgs[0].shape[:2]
    config = config or VideoOutputConfig(preset="medium", crf=20, audio_copy=False)
    n = generate_video(output_path, frames(), w, h, fps=fps, config=config)
    return n, (tx, ty, ang)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="generate a synthetic shaky test video",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--input", "-i", nargs="+", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--noise-scale", type=float, default=10.0)
    p.add_argument("--disable-shift", action="store_true")
    p.add_argument("--disable-rotate", action="store_true")
    p.add_argument("--seconds", type=float, default=5.0,
                   help="seconds per input image")
    p.add_argument("--seed", type=int, default=71)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    n, _ = generate_shaky_video(
        args.input, args.output, noise_scale=args.noise_scale,
        shift=not args.disable_shift, rotate=not args.disable_rotate,
        seconds_per_image=args.seconds, seed=args.seed, device=args.device)
    print(f"wrote {n} frames -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
