"""``jnp.linspace`` as the JAX package's compiled programs evaluate it on
the CPU, for code that must pick the same grid points or the same
truncated indexes.

XLA rewrites ``start (1 - i / d) + stop (i / d)`` (d = num - 1) into
``fma(i, stop r, start (1 - i r))`` with r = fp32(1 / d); the integer
parts of these values differ from a plain fp32 evaluation's where the
exact value is an integer.
"""
from __future__ import annotations

import numpy as np


def xla_linspace(start, stop, num: int) -> np.ndarray:
    """fp32 (num,) values, endpoint included."""
    f32 = np.float32
    start, stop = f32(start), f32(stop)
    if num == 1:
        return np.asarray([start], f32)
    i = np.arange(num - 1, dtype=f32)
    r = f32(1) / f32(num - 1)
    head = (start * (f32(1) - i * r)).astype(f32)
    # the fused multiply-add: one rounding of i * (stop r) + head
    out = (i.astype(np.float64) * np.float64(f32(stop * r))
           + head.astype(np.float64)).astype(f32)
    return np.append(out, stop).astype(f32)
