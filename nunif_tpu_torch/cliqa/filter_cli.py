"""cliqa dataset-filter CLI (counterpart of ``nunif_tpu/cliqa/filter_cli.py``):
score every image under the input directory, copy (or symlink) those at
or above the threshold into the output directory.

Usage:
  python -m nunif_tpu_torch.cliqa.filter_cli jpeg  -i src/ -o dst/ --filter 85
  python -m nunif_tpu_torch.cliqa.filter_cli noise -i src/ -o dst/ --filter 38
  python -m nunif_tpu_torch.cliqa.filter_cli resize -i src/ -o dst/ --filter 90
The model runs on the card (``--device cpu`` on the CPU).
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys

from ..utils.files import listdir_images

logger = logging.getLogger("nunif_tpu_torch.cliqa")

ARCHS = {"jpeg": "cliqa.jpeg_quality", "noise": "cliqa.grain_noise_level",
         "resize": "cliqa.scale_factor"}


def create_parser():
    p = argparse.ArgumentParser(prog="cliqa.filter", description=__doc__)
    p.add_argument("kind", choices=["jpeg", "noise", "resize"])
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--filter", type=float, required=True,
                   help="keep images scoring >= this value")
    p.add_argument("--checkpoint", default=None,
                   help=".nztm model file (or a reference .pth)")
    p.add_argument("--symlink", action="store_true")
    p.add_argument("--num-patches", type=int, default=8)
    p.add_argument("--score-prefix", action="store_true",
                   help="prefix output names with the score")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default cuda; fails "
                        "without CUDA)")
    return p


def load_predictor(kind, checkpoint=None, device="cuda"):
    """The ``kind`` predictor from ``checkpoint``, else flax's init drawn
    from seed 0 (with the JAX CLI's warning), in eval mode on ``device``."""
    import torch
    from ..core.device import resolve_device
    from ..models import create_model, init_flax_default, load_model
    from . import models  # noqa: F401  (registers the predictors)
    if checkpoint:
        model, _meta = load_model(checkpoint, device=device)
        return model
    device = resolve_device(device)
    with torch.device(device):
        model = create_model(ARCHS[kind])
    init_flax_default(model, torch.Generator(device=device).manual_seed(0))
    logger.warning("cliqa: random init (no --checkpoint); scores are "
                   "meaningless, structure/smoke use only")
    return model.eval().requires_grad_(False)


def score(kind, model, x, num_patches):
    """The score the filter compares with its threshold."""
    from . import utils as U
    if kind == "jpeg":
        return U.predict_jpeg_quality(model, x, num_patches)[0]
    if kind == "noise":
        return U.predict_grain_noise_psnr(model, x, num_patches)
    return U.predict_resize_quality(model, x, num_patches)


def main(argv=None):
    args = create_parser().parse_args(argv)
    from ..utils.pil_io import load_image
    model = load_predictor(args.kind, args.checkpoint, args.device)
    os.makedirs(args.output, exist_ok=True)
    kept = total = 0
    for f in listdir_images(args.input):
        x, _ = load_image(f)
        value = score(args.kind, model, x[..., :3], args.num_patches)
        total += 1
        if value >= args.filter:
            kept += 1
            name = os.path.basename(f)
            if args.score_prefix:
                name = f"{value:08.3f}_{name}"
            dst = os.path.join(args.output, name)
            if args.symlink:
                if not os.path.lexists(dst):
                    os.symlink(os.path.abspath(f), dst)
            else:
                shutil.copy2(f, dst)
    print(f"kept {kept}/{total} images", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
