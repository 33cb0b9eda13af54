"""Export a checkpoint as a ``torch.export`` program at one static input
bucket (counterpart of ``nunif_tpu/cli/export_model.py``, which writes a
StableHLO ``.nzhlo``; format in ``models/export.py``).

  python -m nunif_tpu_torch.cli.export_model -i model.nztm -o model.pt2 \\
      --tile-size 256 --batch-size 4
The model is exported on the card (``--device cpu`` on the CPU); the
program runs on the device it was exported on, in bf16.
"""
import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="export_model", description=__doc__)
    p.add_argument("--input", "-i", required=True, help=".nztm checkpoint")
    p.add_argument("--output", "-o", required=True, help=".pt2 artifact")
    p.add_argument("--tile-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--bake-params", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..models.export import export_model
    from ..models.io import load_model

    model, _meta = load_model(args.input, device=args.device)
    in_ch = getattr(model, "i2i_in_channels", getattr(model, "in_channels", 3))
    shape = (args.batch_size, args.tile_size, args.tile_size, in_ch)
    export_model(model, args.output, shape, bake_params=args.bake_params)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
