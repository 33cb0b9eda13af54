"""The twin of the Hopper probe T2 (``nunif_tpu_torch/ops/probes.py:
swin_pieces``) against the JAX tool kernel, on the CPU.

``tools/microbench_swin_pieces.py`` builds ``pl.pallas_call`` for the TPU
without ``interpret``; these tests wrap its kernel body (``_kernel``) in
``pl.pallas_call(..., interpret=True)`` with the tool's BlockSpecs on a
grid of (H / 6 rh, W / 6 cw) blocks, at C = 32 (2 heads of 16) on 12x24
images.  Importing the tool sets JAX's persistent compilation cache; the
loader puts both settings back, since other test files share the process.
Inputs are made with numpy from a seed: x ~ N(0, 0.5), weights N(0, 1 /
fan-in) (int8: the tool's per-column quantization), biases N(0, 0.1), the
bias table N(0, 1) so that the comparison sees it.

Tolerances: the twin rounds where the compiled tool rounds (XLA keeps the
quantizer's r = 127 / amax, and the W8A8 dense layers' row scale, in fp32),
so at least 99% of output elements are bit-equal.  The rest differ by a flipped rounding
of an fp32 sum taken in another order and its consequences: max abs error
2^-6 (two bf16 steps at the outputs' O(2) magnitude) for bf16 variants and
2^-5 for int8 ones, whose flipped xq moves a whole row's sums.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import functools
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from nunif_tpu_torch.ops import probes
from nunif_tpu_torch.tools import microbench_swin_pieces as port_tool

REPO = pathlib.Path(__file__).resolve().parents[1]
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")
C, H, W = 32, 12, 24
BIT_EQUAL = 0.99
ATOL = {False: 2 ** -6, True: 2 ** -5}  # by whether the variant has int8


@pytest.fixture(scope="module")
def tool():
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "_tool_microbench_swin_pieces",
            REPO / "tools" / "microbench_swin_pieces.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


def _arrays(g, dense_int8, seed):
    """x and the tool's arguments after it (its step's order), on the CPU."""
    wts = port_tool.weights(C, g, dense_int8, check=True, seed=seed,
                            device="cpu")
    x = port_tool.image(C, H, W, seed=seed + 1, device="cpu")
    return x, wts


def _jax(tool, x, wts, g, rh, cw, v):
    heads, hid = C // 16, 2 * C
    wdt = jnp.int8 if v["dense_int8"] else jnp.bfloat16

    def spec(*shape):
        return pl.BlockSpec(shape, lambda i, j: (0,) * len(shape),
                            memory_space=pltpu.VMEM)
    img = pl.BlockSpec((1, rh * 6, cw * 6, C), lambda i, j: (0, i, j, 0),
                       memory_space=pltpu.VMEM)
    f = pl.pallas_call(
        functools.partial(tool._kernel, C=C, heads=heads, G=g, rh=rh, cw=cw,
                          **v),
        grid=(H // (6 * rh), W // (6 * cw)),
        in_specs=[img, spec(C, 3 * C), spec(3 * C), spec(C, C), spec(C),
                  spec(C, hid), spec(hid), spec(hid, C), spec(C),
                  spec(g * 36, heads * g * 36),
                  spec(3 * C), spec(C), spec(hid), spec(C)],
        out_specs=img,
        out_shape=jax.ShapeDtypeStruct((1, H, W, C), jnp.bfloat16),
        interpret=True)
    args = [jnp.asarray(a.float().numpy(), wdt if a.dtype in (
        torch.int8, torch.bfloat16) else jnp.float32) for a in wts]
    return np.asarray(f(jnp.asarray(x.float().numpy(), jnp.bfloat16), *args)
                      .astype(jnp.float32))


def _agree(got, want, atol):
    return float(np.abs(got - want).max()) <= atol and \
        float(np.mean(got == want)) >= BIT_EQUAL


CASES = [(2, 1, 2), (2, 1, 4), (2, 2, 2), (4, 1, 4), (4, 2, 2)]


@pytest.mark.parametrize("name", list(port_tool.VARIANTS))
@pytest.mark.parametrize("g,rh,cw", CASES)
def test_swin_pieces_twin_matches_tool_kernel(tool, name, g, rh, cw):
    v = port_tool.variant(name)
    x, wts = _arrays(g, v["dense_int8"], seed=g + rh + cw)
    want = _jax(tool, x, wts, g, rh, cw, v)
    before = probes.swin_pieces.launches
    got = probes.swin_pieces(x, *wts, G=g, rh=rh, cw=cw, **v)
    assert probes.swin_pieces.launches == before  # CPU: the twin
    assert got.dtype == torch.bfloat16 and got.shape == (1, H, W, C)
    got = got.float().numpy()
    atol = ATOL[v["dense_int8"] or v["scores_int8"]]
    assert float(np.abs(got - want).max()) <= atol
    assert float(np.mean(got == want)) >= BIT_EQUAL
    if name == "W":  # 1.0001 rounds to 1.0 in bf16: a copy
        np.testing.assert_array_equal(got, x.float().numpy())
    else:
        assert np.abs(got - x.float().numpy()).max() > 0.1


@pytest.mark.parametrize("name", ["P4", "P4q", "P4s", "P4qs"])
def test_per_window_attention_fails_against_tool_kernel(tool, name):
    """The tool's attention spans the G windows of a group; per-window
    attention (the bias table with -1000, so e = bf16(2^-100), across
    windows) must fail the same check, and so must a zero bias table."""
    g, rh, cw = 4, 1, 4
    v = port_tool.variant(name)
    x, wts = _arrays(g, v["dense_int8"], seed=7)
    want = _jax(tool, x, wts, g, rh, cw, v)
    kw = dict(G=g, rh=rh, cw=cw, **v)
    atol = ATOL[v["dense_int8"] or v["scores_int8"]]
    assert _agree(probes.swin_pieces(x, *wts, **kw).float().numpy(), want,
                  atol)
    bias = wts[8]
    win = torch.arange(g * 36) // 36
    same = (win[:, None] == win[None, :]).repeat(1, C // 16)
    for control in (torch.where(same, bias, torch.full_like(bias, -1000.0)),
                    torch.zeros_like(bias)):
        got = probes.swin_pieces(x, *wts[:8], control, *wts[9:], **kw)
        assert not _agree(got.float().numpy(), want, atol)


def test_quantizer_matches_tool(tool):
    """The port's quantizer against ``_quant_rows`` on bf16 rows: compiled
    (jit, as the tool kernel runs it) bit for bit in xq and in the scale,
    which the tool returns rounded to bf16; eager JAX rounds r = 127 / amax
    to bf16 as well and differs in a few percent of xq."""
    rows = np.random.default_rng(3).normal(0, 1, (256, 96)).astype(np.float32)
    rows[0] = 0.0  # amax = 0: the 1e-6 floor
    xt = torch.from_numpy(rows).bfloat16()
    xj = jnp.asarray(rows, jnp.bfloat16)
    xq, scale = probes.quant_rows(xt)
    assert xq.dtype == torch.int8 and scale.dtype == torch.float32
    jq, js = jax.jit(tool._quant_rows)(xj)
    assert js.dtype == jnp.bfloat16
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.to(torch.bfloat16).float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    eq, es = tool._quant_rows(xj)
    np.testing.assert_array_equal(np.asarray(es.astype(jnp.float32)),
                                  np.asarray(js.astype(jnp.float32)))
    assert 0.9 < float(np.mean(np.asarray(eq) == xq.numpy())) < 1.0
    assert int(np.abs(xq.numpy()).max()) == 127 and not xq[0].any()


def test_port_tool_draws_the_tool_inputs(tool, monkeypatch):
    """The port's tool draws x, weights, int8 weights, scales and the bias
    table from the JAX tool's seeds and formulas (built here at C = 32)."""
    captured = {}

    def fake_pallas_call(kernel, **kw):
        def f(*args):
            captured["args"] = args
        return f
    monkeypatch.setattr(tool.pl, "pallas_call", fake_pallas_call)
    for dense_int8 in (False, True):
        tool.build(C, 2, H, W, 4, dense_int8=dense_int8, rh=1, cw=2)(None)
        want = captured["args"][1:]
        got = port_tool.weights(C, 2, dense_int8, device="cpu")
        assert len(got) == len(want) == 13
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b.astype(jnp.float32)))
    xj = np.random.default_rng(1).normal(0, 0.5, (1, H, W, C))
    np.testing.assert_array_equal(
        port_tool.image(C, H, W, device="cpu").float().numpy(),
        np.asarray(jnp.asarray(xj, jnp.bfloat16).astype(jnp.float32)))


def test_swin_pieces_wrapper_rejects_other_devices():
    x = torch.empty((1, 12, 24, 32), device="meta", dtype=torch.bfloat16)
    wts = port_tool.weights(32, 2, False, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        probes.swin_pieces(x, *wts, G=2, rh=1, cw=2, pieces=4)


@pytest.mark.parametrize("dense_int8", [False, True])
@pytest.mark.parametrize("c,nb", [(32, 16), (96, 48), (192, 96)])
def test_weight_pack_follows_index_formula(c, nb, dense_int8):
    """T2's weight pack at the widths its kernel runs (C 32, 96, 192: the
    chunk widths 16, 48, 96), bf16 and the int8 wgmma form: a core matrix
    is 8 columns of E = 16 bytes of k (E = 8 bf16, 16 int8), and
    packed[h, ks, n8, kb, r, i] = W[2E ks + E kb + i, nb h + 8 n8 + r]; a k
    step of one chunk is nb * 32 contiguous bytes in either type."""
    wts = port_tool.weights(c, 2, dense_int8, check=True, device="cpu")
    packed = probes.pack_pieces(*wts[:8], *wts[9:], dense_int8=dense_int8)
    assert packed.nc == nb == probes.pieces_chunk_width(c)
    e = 8 if not dense_int8 else 16
    for w, m in zip(wts[0:8:2], packed.mats):
        k, n = w.shape
        assert m.dtype == (torch.int8 if dense_int8 else torch.bfloat16)
        assert tuple(m.shape) == (n // nb, k // (2 * e), nb // 8, 2, 8, e)
        assert m.is_contiguous() and m[0, 0].numel() * m.element_size() == nb * 32
        h, ks, n8, kb, r, i = (torch.from_numpy(a) for a in np.indices(m.shape))
        assert torch.equal(m, w[2 * e * ks + e * kb + i, nb * h + 8 * n8 + r])
