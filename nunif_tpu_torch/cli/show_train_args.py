"""Show the checkpoint's metadata, training args included (counterpart of
``nunif_tpu/cli/show_train_args.py``).

Usage: python -m nunif_tpu_torch.cli.show_train_args -m model.nztm
"""
import argparse
import json
import sys
import zipfile


def main(argv=None):
    p = argparse.ArgumentParser(prog="show_train_args", description=__doc__)
    p.add_argument("--model-file", "-m", required=True)
    args = p.parse_args(argv)
    with zipfile.ZipFile(args.model_file) as zf:
        meta = json.loads(zf.read("__meta__.json"))
    print(json.dumps(meta, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
