"""find_mapper: the curve fits behind the mapper parameter tables of
``iw3/mapper.py`` (counterpart of ``nunif_tpu/iw3/training/find_mapper.py``).

  v1v2    which (bias, scale) make softplus01 match the legacy
          softplus01_legacy(c) curve
  mul     which bias (scale 12) makes softplus01 approximate the
          hardplus(mul_scale) "multiply, then clamp" curve
  inv     which inv_softplus01 (bias, scale) best inverts a softplus01
          curve, weighted toward the active region
  check   the mapper curves as CSV

Each search evaluates its whole (bias x scale) grid as one fp32 tensor
computation against the port's own mapper functions, at the JAX tool's
sample positions (``utils/linspace.xla_linspace``).

    python -m nunif_tpu_torch.iw3.training.find_mapper v1v2 [--c 4 6 8.4]
    python -m nunif_tpu_torch.iw3.training.find_mapper mul [--mul-scale 1.5 2 3]
    python -m nunif_tpu_torch.iw3.training.find_mapper inv
    python -m nunif_tpu_torch.iw3.training.find_mapper check --mapper mul_2 [--csv out.csv]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ...utils.linspace import xla_linspace
from ..mapper import get_mapper, softplus01, softplus01_legacy


def linspace(start, stop, num: int) -> torch.Tensor:
    """fp32 ``jnp.linspace(start, stop, num)`` as JAX evaluates it."""
    return torch.from_numpy(xla_linspace(start, stop, num))


def hardplus(x, scale: float):
    """The "multiply, then clamp from below" curve the soft mul_* mappers
    approximate."""
    threshold = 1.0 - (1.0 / scale)
    return torch.where(x >= threshold, (x - threshold) * scale,
                       torch.zeros_like(x))


def _softplus01_grid(x, biases, scales):
    """softplus01 on a (bias, scale) grid: (len(biases), len(scales), len(x))."""
    b = torch.as_tensor(np.asarray(biases), dtype=torch.float32)[:, None, None]
    s = torch.as_tensor(np.asarray(scales), dtype=torch.float32)[None, :, None]
    xx = x[None, None, :]
    v = torch.log1p(torch.exp((xx - b) * s))
    min_v = torch.log1p(torch.exp((0.0 - b) * s))
    max_v = torch.log1p(torch.exp((1.0 - b) * s))
    return (v - min_v) / (max_v - min_v)


def fit_softplus_v1_to_v2(c: float, n_bias: int = 100, n_scale: int = 100):
    """(bias, scale) of least MAE to the legacy softplus01_legacy(c) curve."""
    x = linspace(0, 1, 1000)
    target = softplus01_legacy(x, c)
    biases = np.linspace(0, 1, n_bias)
    scales = np.linspace(1e-3, 20, n_scale)
    mae = torch.mean(torch.abs(_softplus01_grid(x, biases, scales)
                               - target[None, None, :]), dim=-1)
    i, j = np.unravel_index(int(torch.argmin(mae)), mae.shape)
    return {"c": c, "bias": float(biases[i]), "scale": float(scales[j]),
            "mae": float(mae[i, j])}


def fit_softplus_to_hardplus(mul_scale: float, margin: float = 0.2,
                             n_bias: int = 1000):
    """bias (scale 12) of least MAE to hardplus(mul_scale) on the active
    region."""
    threshold = 1.0 - (1.0 / mul_scale)
    threshold += threshold * margin
    x = linspace(threshold, 1, 1000)
    target = hardplus(x, mul_scale)
    biases = np.linspace(0, 1, n_bias)
    grid = _softplus01_grid(x, biases, [12.0])[:, 0, :]
    mae = torch.mean(torch.abs(grid - target[None, :]), dim=-1)
    i = int(torch.argmin(mae))
    return {"mul_scale": mul_scale, "bias": float(biases[i]), "scale": 12.0,
            "mae": float(mae[i])}


def _masked_mean(a, mask):
    return (a * mask).sum(-1) / mask.sum()


def fit_inv_softplus(softplus_bias: float, softplus_scale: float,
                     mul_scale: float, margin: float = 0.2,
                     n_bias: int = 1000, n_scale: int = 100):
    """(bias, scale) of inv_softplus01 so that inv(f(x)) ~ x, the error
    weighted toward the region after the threshold."""
    threshold = 1.0 - (1.0 / mul_scale)
    threshold += threshold * margin
    error_scale2 = (1.0 - threshold) / threshold
    x = linspace(0, 1, 1000)
    y = softplus01(x, softplus_bias, softplus_scale)
    lo = (x <= threshold).float()
    biases = np.linspace(-0.1, 0.1, n_bias)
    scales = np.linspace(-20, 20, n_scale)
    b = torch.as_tensor(biases, dtype=torch.float32)[:, None, None]
    s = torch.as_tensor(scales, dtype=torch.float32)[None, :, None]
    yy = y[None, None, :]
    v = torch.log(torch.clamp(torch.expm1((yy - b) * s), min=1e-6))
    min_v = torch.log(torch.clamp(torch.expm1((0.0 - b) * s), min=1e-6))
    max_v = torch.log(torch.clamp(torch.expm1((1.0 - b) * s), min=1e-6))
    x2 = (v - min_v) / (max_v - min_v)
    err = (x[None, None, :] - x2) ** 2
    score = _masked_mean(err, lo) + _masked_mean(err, 1 - lo) * error_scale2
    i, j = np.unravel_index(int(torch.argmin(score)), score.shape)
    return {"softplus_bias": softplus_bias, "bias": float(biases[i]),
            "scale": float(scales[j]), "mse": float(score[i, j])}


def dump_curves(names, path=None, n: int = 1000):
    """The mapper curves as CSV (x, then a column a mapper): to ``path``,
    or every 20th row printed."""
    x = np.linspace(0, 1, n, dtype=np.float32)
    cols = [x]
    for name in names:
        cols.append(get_mapper(name)(torch.from_numpy(x)).numpy().astype(np.float32))
    out = np.stack(cols, axis=1)
    header = ",".join(["x"] + list(names))
    if path:
        np.savetxt(path, out, delimiter=",", header=header, comments="")
        return path
    print(header)
    for row in out[:: max(n // 20, 1)]:
        print(",".join(f"{v:.5f}" for v in row))
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("v1v2", help="legacy softplus c -> (bias, scale)")
    p1.add_argument("--c", type=float, nargs="+", default=[4.0, 6.0, 8.4])
    p2 = sub.add_parser("mul", help="hardplus mul -> softplus bias")
    p2.add_argument("--mul-scale", type=float, nargs="+",
                    default=[1.5, 2.0, 3.0])
    sub.add_parser("inv", help="fit inv_softplus params for mul_1/2/3")
    p4 = sub.add_parser("check", help="dump mapper curves as CSV")
    p4.add_argument("--mapper", nargs="+",
                    default=["none", "mul_1", "mul_2", "mul_3",
                             "inv_mul_1", "inv_mul_2", "inv_mul_3"])
    p4.add_argument("--csv", default=None)
    args = p.parse_args(argv)

    if args.cmd == "v1v2":
        for c in args.c:
            r = fit_softplus_v1_to_v2(c)
            print(f"c={c}: bias={r['bias']:.3f} scale={r['scale']:.3f} "
                  f"MAE={r['mae']:.5f}")
    elif args.cmd == "mul":
        for m in args.mul_scale:
            r = fit_softplus_to_hardplus(m)
            print(f"mul_scale={m}: bias={r['bias']:.3f} scale=12 "
                  f"MAE={r['mae']:.5f}")
    elif args.cmd == "inv":
        for bias, mul in ((0.343, 1.5), (0.515, 2.0), (0.687, 3.0)):
            r = fit_inv_softplus(bias, 12.0, mul)
            print(f"softplus_bias={bias}: inv bias={r['bias']:.6f} "
                  f"scale={r['scale']:.4f} MSE={r['mse']:.5f}")
    elif args.cmd == "check":
        out = dump_curves(args.mapper, args.csv)
        if out:
            print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
