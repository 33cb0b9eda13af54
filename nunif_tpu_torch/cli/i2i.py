"""Tiled inference for any I2I checkpoint (counterpart of
``nunif_tpu/cli/i2i.py``): a file, or every image of a directory into
``<output>/<stem>.png``, through ``TiledRenderer`` (``--tta``: 8-way TTA),
so a swin_unet checkpoint runs kernels K1 / K2 on the card.

Usage: python -m nunif_tpu_torch.cli.i2i -m model.nztm -i in.png -o out.png
The model runs on the card (``--device cpu`` on the CPU).
"""
from __future__ import annotations

import argparse
import os
import sys


def _tile_size_arg(v):
    """int or "HxW" (rectangular tiles, e.g. 592x1936)."""
    if v is None:
        return None
    s = str(v).lower()
    if "x" in s:
        h, w = s.split("x")
        return (int(h), int(w))
    return int(s)


def main(argv=None):
    p = argparse.ArgumentParser(prog="i2i", description=__doc__)
    p.add_argument("--model-file", "-m", required=True)
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--tile-size", type=_tile_size_arg, default=None,
                   help="tile size: int or HxW (e.g. 592x1936)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--tta", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from ..models.io import load_model
    from ..transforms.tta import tta_render
    from ..utils.files import listdir_images
    from ..utils.pil_io import load_image, save_image
    from ..utils.tiling import TiledRenderer

    model, _meta = load_model(args.model_file, device=args.device)
    renderer = TiledRenderer(model)

    def run_one(src, dst):
        x, meta = load_image(src)
        x = torch.from_numpy(x[..., :3]).to(renderer.device)
        if args.tta:
            y = tta_render(renderer, x, tile_size=args.tile_size,
                           batch_size=args.batch_size)
        else:
            y = renderer.render(x, tile_size=args.tile_size,
                                batch_size=args.batch_size)
        save_image(y.cpu().numpy(), dst, meta)

    if os.path.isdir(args.input):
        os.makedirs(args.output, exist_ok=True)
        for f in listdir_images(args.input):
            base = os.path.splitext(os.path.basename(f))[0]
            run_one(f, os.path.join(args.output, base + ".png"))
    else:
        run_one(args.input, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
