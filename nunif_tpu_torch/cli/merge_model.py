"""Average / merge model checkpoints (counterpart of
``nunif_tpu/cli/merge_model.py``; reference nunif/models/utils.py:135-159):
each parameter is the weighted sum of the inputs' in float64, written as
float32, so the result is bit-equal to the JAX tool's.

Usage: python -m nunif_tpu_torch.cli.merge_model -i a.nztm b.nztm -o merged.nztm
       [--weights 0.7 0.3]
The sums run on the host in numpy, as in the JAX tool: no model runs.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="merge_model", description=__doc__)
    p.add_argument("--input", "-i", nargs="+", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--weights", type=float, nargs="+", default=None)
    args = p.parse_args(argv)

    from ..models import create_model, from_flax, save_model
    from ..models.io import ensure_registered, read_checkpoint

    weights = args.weights or [1.0 / len(args.input)] * len(args.input)
    assert len(weights) == len(args.input)

    meta = acc = None
    for path, w in zip(args.input, weights):
        m, flat = read_checkpoint(path)
        if meta is None:
            meta = m
            acc = {k: np.asarray(a, np.float64) * w for k, a in flat.items()}
        else:
            assert m["name"] == meta["name"], "architecture mismatch"
            acc = {k: a + np.asarray(flat[k], np.float64) * w
                   for k, a in acc.items()}
    ensure_registered(meta["name"])
    model = create_model(meta["name"], **(meta.get("kwargs") or {}))
    from_flax(model, {k: a.astype(np.float32) for k, a in acc.items()})
    save_model(model, args.output)
    print(f"merged {len(args.input)} checkpoints -> {args.output}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
