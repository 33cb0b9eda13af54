"""HaldCLUT image -> .cube 3D LUT converter (counterpart of
``nunif_tpu/iw3/haldclut2cube.py``): parse a HaldCLUT PNG, square or
strip, into an (N, N, N, 3) [B][G][R] lattice, optionally resample it to a
target grid by trilinear interpolation, and write a .cube file with red
fastest, the text the JAX tool writes, its header line included.

The player's LUT filters (ffmpeg ``lut3d``) read .cube; HaldCLUT is the
common distribution format for film-emulation LUTs.  Pure numpy, no device
work.

Usage: python -m nunif_tpu_torch.iw3.haldclut2cube -i lut.png -o out_dir/
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def parse_hald(image_path):
    """Load a HaldCLUT image as an (N, N, N, 3) float lattice, [B][G][R].

    HaldCLUT stores the identity-lattice response row-major with red
    cycling fastest, then green, then blue — so a straight reshape of the
    (H*W, 3) pixel stream to (N, N, N, 3) yields [B][G][R] indexing for
    both the square (level^3 x level^3) and strip layouts.
    """
    from PIL import Image

    img = Image.open(image_path).convert("RGB")
    data = np.asarray(img, dtype=np.float32) / 255.0
    n_px = data.shape[0] * data.shape[1]
    grid = int(round(n_px ** (1.0 / 3.0)))
    if grid ** 3 != n_px:
        raise ValueError(
            f"not a HaldCLUT: {n_px} pixels is not a perfect cube")
    return data.reshape(grid, grid, grid, 3)


def resize_lut(lut, target_size):
    """Trilinearly resample an (N, N, N, 3) lattice to ``target_size``.

    Separable formulation: interpolating a regular lattice along each axis
    independently (three 1-D lerps) equals trilinear interpolation, so
    this runs three cheap axis-wise gathers instead of materializing the
    8-corner stencil.
    """
    src = lut.shape[0]
    if src == target_size:
        return lut

    pos = np.linspace(0.0, src - 1.0, target_size)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, src - 2)
    w = (pos - lo).astype(lut.dtype)

    out = lut
    for axis in range(3):
        a = np.take(out, lo, axis=axis)
        b = np.take(out, lo + 1, axis=axis)
        shape = [1, 1, 1, 1]
        shape[axis] = target_size
        ww = w.reshape(shape)
        out = a * (1.0 - ww) + b * ww
    return out


# the .cube header's first line, the JAX tool's, so that both tools write
# the same file
CUBE_HEADER = "# Created by nunif_tpu.iw3.haldclut2cube\n"


def save_cube(lut, output_path, title):
    """Write an (N, N, N, 3) [B][G][R] lattice as a .cube file.

    .cube body order is red-fastest — which is exactly the row-major
    order of the [B][G][R] lattice, so the body is one reshape + savetxt.
    """
    grid = lut.shape[0]
    with open(output_path, "w", encoding="utf-8") as f:
        f.write(CUBE_HEADER)
        f.write(f'TITLE "{title}"\n')
        f.write(f"LUT_3D_SIZE {grid}\n\n")
        np.savetxt(f, lut.reshape(-1, 3), fmt="%.6f")


def convert(input_path, output_dir, size=33):
    os.makedirs(output_dir, exist_ok=True)
    title = os.path.splitext(os.path.basename(input_path))[0]
    output_file = os.path.join(output_dir, title + ".cube")
    lut = parse_hald(input_path)
    if size:
        lut = resize_lut(lut, size)
    save_cube(lut, output_file, title)
    return output_file


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a HaldCLUT image to a .cube 3D LUT")
    p.add_argument("--input", "-i", required=True, help="HaldCLUT image")
    p.add_argument("--output", "-o", required=True, help="output directory")
    p.add_argument("--size", "-s", type=int, default=33,
                   help="target grid size (0 = keep source size)")
    args = p.parse_args(argv)
    out = convert(args.input, args.output, size=args.size)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
