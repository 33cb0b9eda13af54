"""The twins of the Hopper probes T1, T3 and T4 (``nunif_tpu_torch/ops/
probes.py``) against the JAX package's tool kernels, on the CPU.

The tools build ``pl.pallas_call`` for the TPU without ``interpret``, so
these tests wrap the tools' own kernel bodies (``_pass_kernel``,
``_relayout_kernel``, ``_kernel_bf16``, ``_kernel_int8``, ``_mk_kernel``)
in ``pl.pallas_call(..., interpret=True)`` with the tools' BlockSpecs, at a
small number of windows.  Importing a tool sets JAX's persistent
compilation cache; the fixture puts both settings back at once, since
other test files share the process.  Inputs are made with numpy from a
seed, as the tools draw them (uniform bf16, int8 in [-127, 127)).
"""
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

REPO = pathlib.Path(__file__).resolve().parents[1]
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


def _load_tool(name):
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f"_tool_{name}", REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def tools():
    return {name: _load_tool(name) for name in
            ("microbench_strip", "microbench_int8_attn", "microbench_mxu_dots")}


def test_tools_leave_jax_cache_settings(tools):
    assert jax.config.jax_compilation_cache_dir is None or \
        "jax_cache" not in str(jax.config.jax_compilation_cache_dir)


def _vmem(shape, index):
    return pl.BlockSpec(shape, index, memory_space=pltpu.VMEM)


# ---- T1 ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("rh,cw", [(2, 2), (4, 1), (1, 4)])
def test_strip_twin_matches_tool_kernels(tools, monkeypatch, dtype, rh, cw):
    """The tool's pass and relayout kernels at a 24x48x16 image: both are
    x * scale exactly (in bf16 the scale rounds to 1.0, in fp32 it does
    not), and so is the twin; the partition round trip likewise."""
    t = tools["microbench_strip"]
    for name, val in (("H", 24), ("W", 48), ("C", 16), ("nh", 4), ("nw", 8)):
        monkeypatch.setattr(t, name, val)
    jd, td = {"bf16": (jnp.bfloat16, torch.bfloat16),
              "fp32": (jnp.float32, torch.float32)}[dtype]
    x = np.random.default_rng(rh * cw).normal(0, 1, (1, 24, 48, 16)) \
        .astype(np.float32)
    xj = jnp.asarray(x, jd)
    spec = _vmem((1, rh * 6, cw * 6, 16), lambda i, j: (0, i, j, 0))

    def run(kernel):
        return np.asarray(pl.pallas_call(
            kernel, grid=(4 // rh, 8 // cw), in_specs=[spec], out_specs=spec,
            out_shape=jax.ShapeDtypeStruct((1, 24, 48, 16), jd),
            interpret=True)(xj).astype(jnp.float32))

    want = run(t._pass_kernel)
    relayout = run(functools.partial(t._relayout_kernel, rh=rh, cw=cw))
    np.testing.assert_array_equal(relayout, want)
    xt = torch.from_numpy(x).to(td)
    before = (probes.strip_pass.launches, probes.strip_relayout.launches)
    for fn in (probes.strip_pass, probes.strip_relayout):
        got = fn(xt, rh, cw)
        assert got.dtype == td
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert (probes.strip_pass.launches, probes.strip_relayout.launches) == before
    np.testing.assert_array_equal(
        probes.strip_partition_roundtrip(xt).float().numpy(),
        np.asarray(t.xla_partition_roundtrip(xj).astype(jnp.float32)))
    if dtype == "fp32":  # the scale is applied
        assert np.abs(want - x).max() > 1e-4


# ---- T3 ------------------------------------------------------------------

def _t3_inputs(dtype, nw, seed):
    rng = np.random.default_rng(seed)
    shapes = ((nw, 36, 96), (nw, 96, 216), (nw, 216, 104))
    if dtype == "int8":
        return [rng.integers(-127, 127, s).astype(np.int8) for s in shapes]
    return [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]


def _t3_pallas(kernel, arrays, jd, bw=16):
    nw = arrays[0].shape[0]
    return np.asarray(pl.pallas_call(
        kernel, grid=(nw // bw,),
        in_specs=[_vmem((bw, 36, 96), lambda i: (i, 0, 0)),
                  _vmem((bw, 96, 216), lambda i: (i, 0, 0)),
                  _vmem((bw, 216, 104), lambda i: (i, 0, 0))],
        out_specs=_vmem((bw, 36, 96), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((nw, 36, 96), jnp.bfloat16),
        interpret=True)(*[jnp.asarray(a, jd) for a in arrays])
        .astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_window_dots_twin_matches_tool_kernel(tools, dtype):
    """bf16: both round e and the output to bf16 at the same points; exp2
    and the sums differ in the last fp32 bits, so an element may land one
    bf16 step of e (2^-8) times |v| <= 1 away, plus one output step (2^-8
    relative): atol 1e-2, rtol 2^-7.  int8: the integer products are exact;
    round(127 e) may flip where exp2 differs in its last bit, moving an
    output by |v| / 127^2 < 8e-3, plus one output step: atol 2e-2,
    rtol 2^-7.  Both hold at least 99% of elements bit-equal."""
    t = tools["microbench_int8_attn"]
    kernel, jd, td = {"bf16": (t._kernel_bf16, jnp.bfloat16, torch.bfloat16),
                      "int8": (t._kernel_int8, jnp.int8, torch.int8)}[dtype]
    arrays = _t3_inputs(dtype, 32, seed=3)
    want = _t3_pallas(kernel, arrays, jd)
    before = probes.window_dots.launches
    got = probes.window_dots(*[torch.from_numpy(a).to(td) for a in arrays])
    assert probes.window_dots.launches == before
    assert got.dtype == torch.bfloat16 and got.shape == (32, 36, 96)
    got = got.float().numpy()
    atol = 1e-2 if dtype == "bf16" else 2e-2
    np.testing.assert_allclose(got, want, atol=atol, rtol=2 ** -7)
    assert (got == want).mean() >= 0.99
    assert np.abs(want).max() > 0.1  # the outputs are not degenerate


# ---- T4 ------------------------------------------------------------------

def _t4_pallas(t, n, c, p, dtype, arrays):
    jd, acc = {"bf16": (jnp.bfloat16, jnp.float32),
               "int8": (jnp.int8, jnp.int32)}[dtype]
    nwin, bw = arrays[0].shape[0], t.BW
    return np.asarray(pl.pallas_call(
        t._mk_kernel(n, c, p, jd, acc), grid=(nwin // bw,),
        in_specs=[_vmem((bw, n, c), lambda i: (i, 0, 0)),
                  _vmem((bw, c, p), lambda i: (i, 0, 0)),
                  _vmem((bw, p, c), lambda i: (i, 0, 0))],
        out_specs=_vmem((8, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)(*[jnp.asarray(a, jd) for a in arrays]))


def _t4_inputs(dtype, nwin, n, c, p, seed):
    rng = np.random.default_rng(seed)
    shapes = ((nwin, n, c), (nwin, c, p), (nwin, p, c))
    if dtype == "int8":
        return [rng.integers(-127, 127, s).astype(np.int8) for s in shapes]
    return [rng.uniform(0, 1, s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n,c,p", [(36, 48, 108), (36, 96, 216)])
def test_window_dots_repeat_twin_matches_tool_kernel(tools, dtype, n, c, p):
    """The (8, 128) fill of the last block's carry after REPS (64)
    repetitions over 2 blocks of 16 windows.  int8: integer sums and the
    same fp32 steps, exact.  bf16: the fp32 sums differ in their last bits,
    so bf16(s + carry) may flip a step: rtol 1e-3."""
    t = tools["microbench_mxu_dots"]
    assert (t.REPS, t.BW) == (probes.REPS, probes.BLOCK_WINDOWS)
    arrays = _t4_inputs(dtype, 32, n, c, p, seed=n + c)
    want = _t4_pallas(t, n, c, p, dtype, arrays)
    td = {"bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    ins = [torch.from_numpy(a).to(td) for a in arrays]
    before = probes.window_dots_repeat.launches
    got = probes.window_dots_repeat(*ins)
    assert probes.window_dots_repeat.launches == before
    assert got.shape == (8, 128) and got.dtype == torch.float32
    assert np.all(want == want[0, 0]) and want[0, 0] != 0
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)


def _t4_body(t, dtype, arrays):
    """The tool kernel's body (``_mk_kernel``) written out in jnp for every
    grid step of BW windows: the REPS loop of the dot pair with the carry,
    returning (the last step's carry, each window's o of the last
    repetition as fp32)."""
    jd, acc = {"bf16": (jnp.bfloat16, jnp.float32),
               "int8": (jnp.int8, jnp.int32)}[dtype]
    q, kh, vh = (jnp.asarray(a, jd) for a in arrays)
    dims = (((2,), (1,)), ((0,), (0,)))
    outs, carry = [], None
    for i in range(0, q.shape[0], t.BW):
        qb, kb, vb = q[i:i + t.BW], kh[i:i + t.BW], vh[i:i + t.BW]

        def body(_, state, qb=qb, kb=kb, vb=vb):
            carry, _o = state
            s = jax.lax.dot_general(qb, kb, dims, preferred_element_type=acc)
            if jd == jnp.int8:
                e = ((s + carry.astype(jnp.int32)) >> 7).astype(jnp.int8)
            else:
                e = (s + carry).astype(jd)
            o = jax.lax.dot_general(e, vb, dims, preferred_element_type=acc)
            return carry * 0 + o[0, 0, 0].astype(jnp.float32) * 1e-30, o

        o0 = jnp.zeros((t.BW, qb.shape[1], vb.shape[2]), acc)
        carry, o = jax.lax.fori_loop(0, t.REPS, body, (jnp.float32(0), o0))
        outs.append(np.asarray(o, np.float32))
    return float(carry), np.concatenate(outs)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n,c,p", [(36, 48, 108), (36, 96, 216)])
def test_window_dots_repeat_check_matches_tool_body(tools, dtype, n, c, p):
    """The twin's check output (each window's o of the last repetition)
    against the tool kernel's body in jnp, window by window; the body's
    carry is the tool kernel's fill.  int8 exact; bf16 rtol 1e-3 (fp32
    sums in another order may flip a bf16 step of e)."""
    t = tools["microbench_mxu_dots"]
    arrays = _t4_inputs(dtype, 32, n, c, p, seed=n + c + 1)
    carry, want = _t4_body(t, dtype, arrays)
    assert np.all(_t4_pallas(t, n, c, p, dtype, arrays) == np.float32(carry))
    td = {"bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    ins = [torch.from_numpy(a).to(td) for a in arrays]
    got = torch.empty((32, n, c), dtype=torch.float32)
    before = probes.window_dots_repeat.launches
    fill = probes.window_dots_repeat(*ins, check=got)
    assert probes.window_dots_repeat.launches == before
    assert np.abs(want).max(axis=(1, 2)).min() > 0  # no window is degenerate
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
        assert float(fill[0, 0]) == np.float32(carry)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)
        np.testing.assert_allclose(float(fill[0, 0]), carry, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_pack_dots_follows_index_formula(dtype):
    """T4's pack at the hgroup3 shape (C 48, P 108) with the widths the
    kernel's plan gives there: kt[w, ch, pl, r, i] = khat[w, E pl + i,
    pc ch + r] and vt[w, ch, pl, n, i] = vhat[w, pc ch + k(E pl + i), n],
    k the identity in bf16 and e's column order in int8, zeros past C and
    P; and in int8 the order makes the packed product the true one."""
    nw, c, p = 2, 48, 108
    rng = np.random.default_rng(3)
    khat = torch.from_numpy(rng.integers(-127, 127, (nw, c, p)).astype(np.int8)).to(dtype)
    vhat = torch.from_numpy(rng.integers(-127, 127, (nw, p, c)).astype(np.int8)).to(dtype)
    int8 = dtype == torch.int8
    layout = probes.DotsPlan(64, 48, 64, 2) if int8 else probes.DotsPlan(48, 48, 112, 1)
    e = 16 // khat.element_size()
    packed = probes.pack_dots(khat, vhat, layout)
    assert packed.kt.shape == (nw, layout.nch, layout.kp // e, layout.pc, e)
    assert packed.vt.shape == (nw, layout.nch, layout.pc // e, layout.cn, e)
    kpad = torch.zeros((nw, layout.kp, layout.nch * layout.pc), dtype=dtype)
    kpad[:, :c, :p] = khat
    w, ch, pl, r, i = (torch.from_numpy(a) for a in np.indices(packed.kt.shape))
    assert torch.equal(packed.kt, kpad[w, e * pl + i, layout.pc * ch + r])
    vpad = torch.zeros((nw, layout.nch * layout.pc, layout.cn), dtype=dtype)
    vpad[:, :p, :c] = vhat
    order = torch.tensor(probes._S8_ORDER) if int8 else torch.arange(32)
    w, ch, pl, n, i = (torch.from_numpy(a) for a in np.indices(packed.vt.shape))
    kk = e * pl + i
    assert torch.equal(packed.vt, vpad[w, layout.pc * ch + kk // 32 * 32 + order[kk % 32], n])
    if int8:
        # e enters as A with k slot s holding column order[s]: the product
        # over the packed rows is the product over P
        ev = torch.from_numpy(rng.integers(-127, 127, (nw, 8, layout.nch * layout.pc)))
        idx = torch.arange(layout.nch * layout.pc)
        slots = ev[:, :, idx // 32 * 32 + order[idx % 32]]
        vrows = packed.vt.permute(0, 1, 2, 4, 3).reshape(nw, -1, layout.cn).long()
        assert torch.equal(slots @ vrows, ev @ vpad.long())


def test_window_dots_repeat_int8_wraps(tools):
    """The int32 -> int8 cast of (s + carry) >> 7 wraps in the tool's kernel
    and in the twin: the same product with a saturating cast differs."""
    n, c, p = 36, 48, 108
    arrays = _t4_inputs("int8", 32, n, c, p, seed=11)
    q, kh, vh = (torch.from_numpy(a) for a in arrays)
    s = torch.bmm(q.double(), kh.double()).long() >> 7
    assert bool((s.abs() > 127).any())  # the cast has something to wrap
    want = _t4_pallas(tools["microbench_mxu_dots"], n, c, p, "int8", arrays)
    got = probes.window_dots_repeat(q, kh, vh).numpy()
    np.testing.assert_array_equal(got, want)
    # the carry stays below 1, so every repetition of the last block's first
    # window gives o[0, 0] of the plain product; wrapped, it is the result
    first = slice(16, 17)
    wrapped = ((s[first] + 128) % 256) - 128
    red = {name: float(torch.bmm(e.double(), vh[first].double())[0, 0, 0])
           for name, e in (("wrap", wrapped),
                           ("saturate", s[first].clamp(-128, 127)))}
    assert np.float32(red["wrap"]) * np.float32(1e-30) == want[0, 0]
    assert red["saturate"] != red["wrap"]


def test_probe_wrappers_reject_other_devices():
    meta = torch.empty((1, 12, 12, 16), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        probes.strip_pass(meta, 1, 1)
    q = torch.empty((16, 36, 96), device="meta", dtype=torch.int8)
    with pytest.raises(ValueError, match="unsupported device"):
        probes.window_dots(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        probes.window_dots_repeat(q, q, q)
