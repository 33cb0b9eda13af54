"""count_mask: the background / foreground pixel ratio over the
``*_ML.png`` occlusion masks of a directory (counterpart of
``nunif_tpu/iw3/training/sbs/count_mask.py``), used to weight the
positive class of mask-loss training.  Host numpy and PIL.

    python -m nunif_tpu_torch.iw3.training.sbs.count_mask -i mask_dir
"""
from __future__ import annotations

import argparse
import random
import sys

import numpy as np
from PIL import Image

from ....utils.image_loader import list_images


def count_mask_ratio(input_dir: str, suffix: str = "_ML.png",
                     progress_every: int = 1000, log=print):
    """(background pixels, foreground pixels) summed over the mask files;
    a pixel is foreground where its channels sum above 0."""
    files = [fn for fn in list_images(input_dir) if fn.endswith(suffix)]
    random.shuffle(files)  # progress lines approximate the whole set's ratio
    fg_sum = 0
    bg_sum = 0
    for i, fn in enumerate(files, 1):
        x = np.asarray(Image.open(fn), np.float32)
        if x.ndim == 3:
            x = x.sum(axis=-1)
        fg = int((x > 0).sum())
        fg_sum += fg
        bg_sum += x.size - fg
        if progress_every and i % progress_every == 0:
            log(f"black/white = {bg_sum / max(fg_sum, 1):.2f}")
    return bg_sum, fg_sum


def main(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="measure white/black pixel ratio of *_ML.png masks")
    p.add_argument("--input", "-i", required=True, help="input dir")
    args = p.parse_args(argv)
    bg, fg = count_mask_ratio(args.input)
    print(f"black/white = {bg / max(fg, 1):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
