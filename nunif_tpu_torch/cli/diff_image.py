"""Image difference metrics (counterpart of ``nunif_tpu/cli/diff_image.py``).

Usage: python -m nunif_tpu_torch.cli.diff_image a.png b.png [--save diff.png]
Host numpy only: no model runs.
"""
import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="diff_image", description=__doc__)
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--save", default=None)
    args = p.parse_args(argv)

    from ..utils.pil_io import load_image, save_image
    a, _ = load_image(args.a)
    b, _ = load_image(args.b)
    a, b = a[..., :3], b[..., :3]
    if a.shape != b.shape:
        print(f"shape mismatch: {a.shape} vs {b.shape}", file=sys.stderr)
        return 1
    diff = np.abs(a - b)
    mse = float(np.mean(diff ** 2))
    psnr = 10 * np.log10(1.0 / max(mse, 1e-10))
    print(f"MAE: {float(diff.mean()):.6f}  MAX: {float(diff.max()):.6f}  "
          f"PSNR: {psnr:.3f} dB")
    if args.save:
        save_image(np.clip(diff * 4, 0, 1), args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
