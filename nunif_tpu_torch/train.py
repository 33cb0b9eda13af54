"""Training entry, one subcommand per addon (counterpart of the root
``train.py``):

    python -m nunif_tpu_torch.train waifu2x --model-dir DIR [--data-dir DIR]
        [--arch waifu2x.swin_unet_2x] [--synthetic-p 1.0] [--device cuda]

The default parser has the JAX parser's flags but ``--steps-per-dispatch``
(``JAX_FLAGS_NOT_IN_PORT``), and adds ``--device`` (``PORT_ONLY_FLAGS``):
the card unless the caller asks for the CPU.
"""
import argparse
import logging
import sys

# flags of the JAX training parser that the port's does not have
JAX_FLAGS_NOT_IN_PORT = {
    "steps-per-dispatch": "fuses optimizer steps into one device program "
                          "against the TPU host's dispatch latency "
                          "(ROADMAP \"Do not port\"); PyTorch runs eagerly",
}
PORT_ONLY_FLAGS = {"device": "the device to train on (cuda by default; cpu "
                             "runs the kernels' plain twins)"}


def create_default_parser():
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--model-dir", type=str, required=True)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-samples", type=int, default=10000)
    p.add_argument("--max-epoch", type=int, default=200)
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "adamw", "sgd", "lion"])
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--scheduler", default="none",
                   choices=["none", "step", "multistep", "cosine"])
    p.add_argument("--backward-steps", type=int, default=1,
                   help="gradient accumulation steps")
    p.add_argument("--ema-decay", type=float, default=None)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=71)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def create_parser():
    from .addon import load_addons
    parser = argparse.ArgumentParser(prog="train")
    sub = parser.add_subparsers(dest="command", required=True)
    default_parser = create_default_parser()
    for _, register in load_addons("train"):
        register(sub, default_parser)
    return parser


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    args = create_parser().parse_args(argv)
    return args.handler(args)


if __name__ == "__main__":
    sys.exit(main())
