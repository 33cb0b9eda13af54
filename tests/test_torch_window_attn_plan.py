"""The bf16 K4 / K6 kernel's launch plan (``csrc/window_attn.cu:tma_plan``)
at every shape the card runs: ``chip_smoke.py``'s K4_FRAME, SWIN_T and
WINDOW8, and ``tests/test_torch_cuda.py``'s K4_CASES and K4_OTHER_CASES.

The plan has one owner, the library; ``ops/swin_attention.py:
window_attn_plan`` asks it, so the plan's own checks are marked ``cuda``
and skip without a card: at each shape it must fit the shared memory a
block may use (``kMaxSmem``), keep two stages or more, cover the rows the
attention reads, give every head group the same number of blocks and keep
the bias in shared memory on the paths.  On the CPU each shape is held to
the kernel's limits as ``csrc/`` states them (head dim, key tiles, the
columns a block stages), and the wrappers' bias check runs.  On the card:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_window_attn_plan.py
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import importlib.util
import pathlib
import re

import pytest
import torch

from nunif_tpu_torch.ops import swin_attention as k4

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "nunif_tpu_torch" / "csrc"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _constant(source, name):
    """An integer constant as a ``csrc/`` file defines it."""
    found = re.search(rf"\b{name}\s*=\s*(\d+)\s*;", (CSRC / source).read_text())
    assert found, f"{name} not found in {source}"
    return int(found.group(1))


MAX_SMEM = _constant("common.cuh", "kMaxSmem")
MAX_TILES = _constant("window_attention.cuh", "kMaxAttnTiles")
MAX_HEAD_DIM = _constant("window_attention.cuh", "kMaxHeadDim")
MAX_GROUP_COLS = _constant("window_attn.cu", "kMaxGroupCols")

_smoke = _load("_chip_smoke_shapes", ROOT / "chip_smoke.py")
_cuda_tests = _load("_cuda_test_shapes", ROOT / "tests" / "test_torch_cuda.py")


def _shapes():
    """(label, C, heads, N, windows, on a path)"""
    out = []
    for c, h, w, shift in _smoke.K4_FRAME:
        out.append((f"4xl-{c}-{h}x{w}-s{shift}", c, 12, 36, (h // 6) * (w // 6),
                    True))
    for c, hw, shift in _smoke.SWIN_T:
        out.append((f"swin_t-{c}-{hw}-s{shift}", c, c // 32, 49,
                    _smoke.SWIN_T_BATCH * (hw // 7) ** 2, True))
    c, hw, shift, batch = _smoke.WINDOW8
    out.append((f"window8-{c}-{hw}-s{shift}", c, c // 32, 64,
                batch * (hw // 8) ** 2, True))
    for b, n_wh, n_ww, ws, shift, c, heads in (_cuda_tests.K4_CASES +
                                               _cuda_tests.K4_OTHER_CASES):
        out.append((f"case-{b}x{n_wh}x{n_ww}-w{ws}-s{shift}-{c}-{heads}", c,
                    heads, ws * ws, b * n_wh * n_ww, False))
    return out


SHAPES = _shapes()
IDS = [s[0] for s in SHAPES]


@pytest.fixture
def sms():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the plan is the built library's)")
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("label,c,heads,n,nw,path", SHAPES, ids=IDS)
def test_the_kernel_takes_the_shape(label, c, heads, n, nw, path):
    """By the limits csrc/ states: a head dim of whole k16 steps up to
    kMaxHeadDim, at most kMaxAttnTiles key tiles, and one head's columns
    within what a block stages."""
    assert c % heads == 0
    hd = c // heads
    assert hd % 16 == 0 and hd <= MAX_HEAD_DIM
    assert 1 <= n <= 16 * MAX_TILES
    assert hd <= MAX_GROUP_COLS and nw >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("label,c,heads,n,nw,path", SHAPES, ids=IDS)
def test_plan_fits_and_covers_the_shape(sms, label, c, heads, n, nw, path):
    plan = k4.window_attn_plan(c, heads, n, nw, sms)
    hd = c // heads
    group = plan["group"]
    assert heads % group == 0 and group * hd <= MAX_GROUP_COLS
    assert plan["smem"] <= MAX_SMEM and plan["stages"] >= 2
    # attention reads rows up to 16 x key tiles - 1 of q, k and v
    assert plan["rows"] % 16 == 0 and n <= plan["rows"] <= 16 * MAX_TILES
    ldr = group * hd + 8
    assert (2 * ldr) % 32 == 16  # an odd number of 16-byte units a row
    assert plan["stage_bytes"] % 128 == 0
    assert plan["stage_bytes"] >= 2 * n * ldr * 2 + plan["rows"] * ldr * 2
    assert plan["smem"] >= plan["stages"] * plan["stage_bytes"]
    groups = heads // group
    assert plan["grid"] % groups == 0 and 1 <= plan["grid"] // groups <= nw
    assert plan["grid"] <= max(sms, groups)
    if path:
        assert plan["bias_resident"] == 1


@pytest.mark.cuda
def test_plan_at_the_4xl_widths(sms):
    """C = 192: all 12 heads a block, three stages beside the 69,120-byte
    bias; C = 384: two groups of 6 heads, four stages."""
    assert k4.window_attn_plan(192, 12, 36, 15360, 132) == dict(
        group=12, rows=48, stages=3, bias_resident=1, smem=213564, grid=132,
        stage_bytes=48128)
    assert k4.window_attn_plan(384, 12, 36, 960, 132) == dict(
        group=6, rows=48, stages=4, bias_resident=1, smem=227152, grid=132,
        stage_bytes=48128)


@pytest.mark.cuda
def test_plan_reads_the_bias_from_l2_where_it_does_not_fit(sms):
    """Window 8 at head dim 16 with 12 heads a group: 221 KB of bias."""
    plan = k4.window_attn_plan(192, 12, 64, 100, sms)
    assert plan["bias_resident"] == 0 and plan["stages"] >= 2
    assert plan["smem"] <= MAX_SMEM


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,n", [(96, 12, 36), (192, 2, 36),
                                       (192, 12, 65), (192, 12, 0),
                                       (100, 12, 36)])
def test_plan_rejects_shapes_the_kernel_does_not_take(sms, c, heads, n):
    with pytest.raises(RuntimeError):
        k4.window_attn_plan(c, heads, n, 1, sms)


def test_bias_check_passes_an_fp32_contiguous_bias_through():
    bias = torch.zeros((12, 36, 36))
    assert k4._bias_f32(bias) is bias
    half = k4._bias_f32(bias.to(torch.bfloat16))
    assert half.dtype == torch.float32 and half.is_contiguous()
    strided = k4._bias_f32(bias.transpose(1, 2))
    assert strided.is_contiguous() and torch.equal(strided, bias)
