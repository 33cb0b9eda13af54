"""The depth families' bf16 checks at other inputs.

Each bf16 check of ``test_torch_depth_families.py`` and
``test_torch_depth_wrappers.py`` holds the port's bf16 error against JAX's
fp32 output within ``slack`` times JAX's own bf16 error, on one input.
This script reruns those tests with every input seed ``k`` of a test
replaced by ``100 s + k`` (``s`` 0 gives the tests' own inputs; the
weights stay the tests') and prints, for each check, the ratio of the two
errors (RMS, or mean absolute error with the ratio of the largest errors
beside it) instead of asserting it.

Usage: python tests/bf16_error_sweep.py [s ...]   (default: 0 to 6)
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import torch_iw3_helpers as h  # noqa: E402
import test_torch_depth_families as tf  # noqa: E402
import test_torch_depth_wrappers as tw  # noqa: E402


class _Random:
    """numpy.random with ``default_rng(k)`` seeded at 100 s + k."""

    def __init__(self, s):
        self.s = s

    def default_rng(self, k):
        return np.random.default_rng(100 * self.s + k)

    def __getattr__(self, name):
        return getattr(np.random, name)


class _Numpy:
    def __init__(self, s):
        self.random = _Random(s)

    def __getattr__(self, name):
        return getattr(np, name)


def _checks():
    """(module, label, call(monkeypatch))."""
    cases = [(tf, "midas_core", lambda mp: tf.test_midas_core_matches_jax()),
             (tf, "nk_router", lambda mp: tf.test_nk_router_logits_match_jax_fp32_and_bf16(tw._nk())),
             (tf, "depth_pro_net", lambda mp: tf.test_depth_pro_net_matches_jax())]
    for name, tta, dil in tw.ZOE_CASES:
        cases.append((tw, f"wrapper {name}", lambda mp, a=(name, tta, dil):
                      tw.test_zoedepth_wrapper_matches_jax(mp, *a)))
    for name, raw in (("Any_V3_Mono", False), ("Any_V3_Mono_01", True)):
        cases.append((tw, f"wrapper {name}", lambda mp, a=(name, raw, not raw, 2):
                      tw.test_da3_wrapper_matches_jax(mp, *a)))
    cases.append((tw, "wrapper DepthPro_S", tw.test_depth_pro_wrapper_matches_jax))
    return cases


def sweep(seeds):
    tables = pytest.MonkeyPatch()
    h.add_depth_tables(tables)
    rows = []

    def record(got16, want32, jax16, slack=1.0, stat="rms"):
        got16, want32, jax16 = (np.asarray(a, np.float64) for a in (got16, want32, jax16))
        if stat == "mae":
            d, j = np.abs(got16 - want32), np.abs(jax16 - want32)
            rows[-1].update(ratio=float(d.mean() / j.mean()), worst=float(d.max() / j.max()))
        else:
            rows[-1].update(ratio=h.rms(got16, want32) / h.rms(jax16, want32))
        rows[-1].update(stat=stat, slack=slack)

    for s in seeds:
        for mod, label, call in _checks():
            rows.append(dict(s=s, check=label))
            mp = pytest.MonkeyPatch()
            mp.setattr(mod, "np", _Numpy(s))
            mp.setattr(mod, "_hold_bf16", record)
            try:
                call(mp)
            except AssertionError as e:  # a check after the bf16 one
                rows[-1]["other_check_failed"] = str(e)[:120]
            finally:
                mp.undo()
            print(rows[-1], flush=True)
    tables.undo()
    return rows


if __name__ == "__main__":
    sweep([int(a) for a in sys.argv[1:]] or range(7))
