"""Training-data entry, one subcommand per addon (counterpart of the root
``create_training_data.py``):

    python -m nunif_tpu_torch.create_training_data waifu2x -i SRC -o DATA
"""
import argparse
import logging
import sys


def create_default_parser():
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--dataset-dir", "-i", type=str, required=True,
                   help="source image directory")
    p.add_argument("--data-dir", "-o", type=str, required=True,
                   help="output training-data directory")
    return p


def create_parser():
    from .addon import load_addons
    parser = argparse.ArgumentParser(prog="create_training_data")
    sub = parser.add_subparsers(dest="command", required=True)
    default_parser = create_default_parser()
    for _, register in load_addons("create_training_data"):
        register(sub, default_parser)
    return parser


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    args = create_parser().parse_args(argv)
    return args.handler(args)


if __name__ == "__main__":
    sys.exit(main())
