"""Count model parameters (counterpart of
``nunif_tpu/cli/count_parameters.py``): the total, then each parameter by
its flax path and flax shape, in the JAX tree's order.

Usage: python -m nunif_tpu_torch.cli.count_parameters -m model.nztm
       python -m nunif_tpu_torch.cli.count_parameters --arch waifu2x.swin_unet_2x
The model is built on the card (``--device cpu`` on the CPU).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="count_parameters", description=__doc__)
    p.add_argument("--model-file", "-m", default=None)
    p.add_argument("--arch", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..core.device import resolve_device
    from ..models import create_model, to_flax
    from ..models.io import ensure_registered, load_model

    if args.model_file:
        model, _meta = load_model(args.model_file, device=args.device)
        name = model.model_name
    elif args.arch:
        ensure_registered(args.arch)
        model = create_model(args.arch).to(resolve_device(args.device))
        name = args.arch
    else:
        p.error("one of --model-file / --arch is required")

    flat = to_flax(model)
    total = sum(a.size for a in flat.values())
    print(f"{name}: {total:,} parameters")
    # jax.tree flattens a dict in key order, level by level
    for key in sorted(flat, key=lambda k: k.split("/")):
        print(f"  {key}: {tuple(flat[key].shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
