"""Rewrite a checkpoint's model name to its canonical name (counterpart of
``nunif_tpu/cli/convert_model_alias.py``).

  python -m nunif_tpu_torch.cli.convert_model_alias -i old.nztm -o new.nztm
The model loads on the card (``--device cpu`` on the CPU).
"""
import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="convert_model_alias",
                                description=__doc__)
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..models.io import load_model, save_model
    from ..models.register import resolve_alias

    model, meta = load_model(args.input, device=args.device)
    canonical = resolve_alias(model.model_name)
    if canonical == model.model_name:
        print(f"{model.model_name}: already canonical")
    else:
        print(f"{model.model_name} -> {canonical}")
    save_model(model, args.output, train_kwargs=meta.get("train_kwargs"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
