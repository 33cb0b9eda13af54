"""K3's launch plan (``csrc/warp_x.cu:warp_plan``) at every shape the card
tests run (``tests/test_torch_cuda.py:K3_CASES``), in fp32 and bf16.

On the CPU each shape is held to the limits ``csrc/warp_x.cu`` states: the
shared-memory budget a block plans (two blocks an SM), the ring's stages
and the column alignment of segments; the iw3 path's rows fit whole.  The
plan itself has one owner, the library: ``modules/grid_sample.py:
warp_x_plan`` asks it, so that check is marked ``cuda`` and skips without a
card.  On the card (this file imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_warp_plan.py
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import importlib.util
import pathlib
import re

import pytest
import torch

from nunif_tpu_torch.modules import grid_sample as gs

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_WARP_CU = (_ROOT / "nunif_tpu_torch" / "csrc" / "warp_x.cu").read_text()


def _constant(name):
    found = re.search(rf"\b{name}\s*=\s*(\d+)\s*;", _WARP_CU)
    assert found, f"{name} not found in warp_x.cu"
    return int(found.group(1))


SMEM_BUDGET = _constant("kWarpSmemBudget")
STAGES = _constant("kWarpStages")
ALIGN_COLS = _constant("kWarpAlignCols")


def _a16(v):
    return (v + 15) // 16 * 16


def _layout_bytes(cap, seg, c, es):
    """The kernel's shared memory as warp_x.cu lays it out: the stages'
    mbarriers, the ring (x: cap columns, delta: seg values) and two output
    buffers of seg columns."""
    return _a16(STAGES * 8) + STAGES * (_a16(cap * c * es) + _a16(seg * 4)) \
        + 2 * _a16(seg * c * es)


def _cuda_cases():
    spec = importlib.util.spec_from_file_location(
        "_cuda_test_shapes", _ROOT / "tests" / "test_torch_cuda.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.K3_PATH, mod.K3_CASES


K3_PATH, K3_CASES = _cuda_cases()
PLAN_CASES = [(w, c, es, ms) for _b, _h, w, c, ms in K3_CASES for es in (4, 2)]


def test_warp_plan_limits_at_the_path_shape():
    """The iw3 path's rows (1920 pixels, C = 3, fp32) fit the ring whole,
    two blocks an SM, and take the bulk copies (16-byte rows); C = 8 fp32
    rows of 7680 pixels do not, and take segments."""
    _b, _h, w, c, _ms = K3_PATH
    assert 2 * (SMEM_BUDGET + 1024) <= 228 * 1024
    assert _layout_bytes(w, w, c, 4) <= SMEM_BUDGET
    assert (w * c * 4) % 16 == 0 and w % 4 == 0
    assert _layout_bytes(7680, 7680, 8, 4) > SMEM_BUDGET


@pytest.mark.parametrize("w,c,es,max_shift", PLAN_CASES)
def test_warp_plan_shapes_fit_the_budget(w, c, es, max_shift):
    """Every card-test shape has a plan within the budget: whole rows, or
    segments of a multiple of kWarpAlignCols columns whose stage holds the
    segment, a halo of max_shift + 1 on each side and the rounding out of
    both ends to kWarpAlignCols."""
    if _layout_bytes(w, w, c, es) <= SMEM_BUDGET:
        return
    slack = 2 * (max_shift + 1 + ALIGN_COLS)
    seg = max(s for s in range(ALIGN_COLS, w, ALIGN_COLS)
              if _layout_bytes(s + slack, s, c, es) <= SMEM_BUDGET)
    assert seg >= 64 and -(-w // seg) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("w,c,es,max_shift", PLAN_CASES)
def test_warp_plan_of_the_library(w, c, es, max_shift):
    """The built library's plan (card only) is the one the limits above
    allow: whole rows where they fit, else the widest segment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the plan is the built library's)")
    dtype = {4: torch.float32, 2: torch.bfloat16}[es]
    plan = gs.warp_x_plan(w, c, dtype, max_shift)
    assert plan["smem"] <= SMEM_BUDGET
    if _layout_bytes(w, w, c, es) <= SMEM_BUDGET:
        assert plan == dict(seg=w, nseg=1, halo=0, cap=w,
                            smem=_layout_bytes(w, w, c, es))
        return
    slack = 2 * (max_shift + 1 + ALIGN_COLS)
    assert plan["halo"] == max_shift + 1 and plan["cap"] == plan["seg"] + slack
    assert plan["seg"] % ALIGN_COLS == 0 and plan["nseg"] == -(-w // plan["seg"])
    assert _layout_bytes(plan["cap"], plan["seg"], c, es) == plan["smem"]
    assert _layout_bytes(plan["seg"] + ALIGN_COLS + slack, plan["seg"] + ALIGN_COLS,
                         c, es) > SMEM_BUDGET
