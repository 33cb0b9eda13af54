"""K3 (bounded horizontal warp) and K7 (attention) twins of nunif_tpu_torch,
and the layout helpers around them, against the JAX package on the CPU.

Inputs are made with numpy from a seed and given to both packages.  The
warp twin is held against both JAX baselines: the XLA offset sum that JAX
runs off the TPU, and the Pallas kernel in interpret mode (as
``tests/test_iw3_warp.py`` runs it).  The attention twin is held against
JAX ``sdpa``, which off the TPU is ``_xla_sdpa``.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nunif_tpu.modules import grid_sample as jgs
from nunif_tpu.modules import pad as jpad
from nunif_tpu.modules import permute as jperm
from nunif_tpu.modules import pool as jpool
from nunif_tpu.ops import sdpa as jsdpa

from nunif_tpu_torch.core import dtypes
from nunif_tpu_torch.modules import grid_sample as gs
from nunif_tpu_torch.modules import pad as tpad
from nunif_tpu_torch.modules import permute as tperm
from nunif_tpu_torch.modules import pool as tpool
from nunif_tpu_torch.modules import resize as tresize
from nunif_tpu_torch.ops import sdpa as k7

# the JAX package's modules/__init__ exports the function under the same name
jresize = importlib.import_module("nunif_tpu.modules.resize")


def _rng(seed):
    return np.random.default_rng(seed)


def _warp_case(shape, max_shift, seed):
    """x in [0, 1]; delta uniform in [-max_shift, max_shift], so pixels
    near both edges reach the clip of gx to [0, W - 1]."""
    rng = _rng(seed)
    x = rng.random(shape, dtype=np.float32)
    delta = rng.uniform(-max_shift, max_shift, shape[:3]).astype(np.float32)
    return x, delta


WARP_CASES = [((2, 11, 40, 3), 6), ((1, 5, 33, 1), 3), ((2, 4, 64, 8), 28),
              ((3, 7, 45, 3), 9)]


@pytest.mark.parametrize("shape,max_shift", WARP_CASES)
def test_warp_twin_matches_jax_xla(shape, max_shift):
    x, delta = _warp_case(shape, max_shift, 60)
    want = np.asarray(jgs.warp_x_bounded(jnp.asarray(x), jnp.asarray(delta),
                                         max_shift))
    got = gs.warp_x_bounded_plain(torch.from_numpy(x), torch.from_numpy(delta),
                                  max_shift).numpy()
    # the same fp32 offset sum over the same bf16 values: measured 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,max_shift", WARP_CASES[:2])
def test_warp_twin_matches_pallas_interpret(shape, max_shift):
    x, delta = _warp_case(shape, max_shift, 61)
    want = np.asarray(jgs._warp_x_bounded_pallas(
        jnp.asarray(x), jnp.asarray(delta), max_shift, interpret=True))
    got = gs.warp_x_bounded_plain(torch.from_numpy(x), torch.from_numpy(delta),
                                  max_shift).numpy()
    # the Pallas kernel sums the same terms (2e-6 against XLA in the JAX
    # package's own test)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_warp_twin_is_the_gather_within_the_bound():
    """Within |delta| <= max_shift the offset sum is the two-tap gather
    that K3 computes, on the bf16-rounded image; gx exactly on the right
    border (W - 1) and beyond it included."""
    x, delta = _warp_case((2, 6, 50, 3), 12, 62)
    delta[0, 0, -5:] = 12.0   # clipped to W - 1
    delta[0, 1, -1] = 0.0     # exactly W - 1
    delta[1, 0, :5] = -12.0   # clipped to 0
    xt, dt = torch.from_numpy(x), torch.from_numpy(delta)
    got = gs.warp_x_bounded_plain(xt, dt, 12)
    want = gs.warp_x(xt.bfloat16().float(), dt)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    jwant = np.asarray(jgs.warp_x(jnp.asarray(xt.bfloat16().float().numpy()),
                                  jnp.asarray(delta)))
    np.testing.assert_allclose(want.numpy(), jwant, rtol=0, atol=1e-6)


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_warp_x_gather_matches_jax(padding_mode):
    x, delta = _warp_case((2, 5, 31, 3), 40, 63)  # beyond the image too
    want = np.asarray(jgs.warp_x(jnp.asarray(x), jnp.asarray(delta),
                                 padding_mode=padding_mode))
    got = gs.warp_x(torch.from_numpy(x), torch.from_numpy(delta),
                    padding_mode=padding_mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_warp_fp32_compute_matches_jax_gather(monkeypatch):
    """With ``IMAGE_DTYPE`` set to fp32 (the fp32 parity runs) the warp
    reads x unrounded."""
    monkeypatch.setattr(dtypes, "IMAGE_DTYPE", torch.float32)
    x, delta = _warp_case((1, 4, 30, 3), 5, 64)
    got = gs.warp_x_bounded(torch.from_numpy(x), torch.from_numpy(delta),
                            5).numpy()
    want = np.asarray(jgs.warp_x(jnp.asarray(x), jnp.asarray(delta)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_warp_dispatch_on_cpu_takes_the_twin():
    x, delta = _warp_case((1, 3, 20, 3), 4, 65)
    before = gs.warp_x_bounded.launches
    got = gs.warp_x_bounded(torch.from_numpy(x), torch.from_numpy(delta), 4)
    want = gs.warp_x_bounded_plain(torch.from_numpy(x), torch.from_numpy(delta), 4)
    assert torch.equal(got, want)
    assert gs.warp_x_bounded.launches == before  # no kernel on the CPU


class _FakeLibrary:
    """Records K3's library call in place of the card's library."""

    def __init__(self):
        self.calls = []

    def nunif_warp_x_bounded(self, dtype, x, delta, out, B, H, W, C, max_shift,
                             stream):
        self.calls.append(dict(dtype=dtype, x=x, delta=delta, shape=(B, H, W, C),
                               max_shift=max_shift))
        return 0


@pytest.fixture
def fake_library(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(gs._build, "library", lambda: lib)
    monkeypatch.setattr(gs._build, "stream_ptr", lambda device: 0)
    return lib


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)])
def test_warp_launch_takes_x_without_a_cast(fake_library, dtype, code):
    """The CUDA branch of ``warp_x_bounded`` (run here on CPU tensors with
    the library call recorded): fp32 or bf16 x goes to the kernel as it is,
    the same storage, no cast pass; the result has x's dtype; the kernel
    gets max_shift, from which it plans its halo."""
    x, delta = (torch.from_numpy(a) for a in _warp_case((2, 3, 16, 3), 5, 66))
    x = x.to(dtype)
    before = gs.warp_x_bounded.launches
    out = gs._warp_x_bounded_cuda(x, delta, 5)
    (call,) = fake_library.calls
    assert call["dtype"] == code == gs._build.dtype_code(dtype)
    assert call["x"] == x.data_ptr() and call["delta"] == delta.data_ptr()
    assert call["shape"] == (2, 3, 16, 3) and call["max_shift"] == 5
    assert out.dtype == dtype and out.shape == x.shape
    assert gs.warp_x_bounded.launches == before + 1


def test_warp_launch_other_dtypes_go_through_fp32(fake_library):
    x, delta = (torch.from_numpy(a) for a in _warp_case((1, 2, 8, 1), 3, 67))
    out = gs._warp_x_bounded_cuda(x.half(), delta.double(), 3)
    (call,) = fake_library.calls
    assert call["dtype"] == gs._build.DTYPE_F32 and out.dtype == torch.float16


def test_warp_launch_rejects_what_the_kernel_does_not_take(fake_library,
                                                           monkeypatch):
    x = torch.zeros((1, 4, 16, 9))
    with pytest.raises(ValueError, match="C <= 8"):
        gs._warp_x_bounded_cuda(x, torch.zeros((1, 4, 16)), 4)
    x = torch.zeros((1, 4, 16, 3))
    with pytest.raises(ValueError, match="delta"):
        gs._warp_x_bounded_cuda(x, torch.zeros((1, 4, 15)), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        gs.warp_x_bounded(x.to("meta"), torch.zeros((1, 4, 16), device="meta"), 4)
    monkeypatch.setattr(dtypes, "IMAGE_DTYPE", torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        gs._warp_x_bounded_cuda(x, torch.zeros((1, 4, 16)), 4)
    assert not fake_library.calls


SDPA_TOL = {  # (atol) measured: fp32 ~1e-7; bf16 one rounding of the output
    "fp32": 1e-5, "bf16": 1e-2}


@pytest.mark.parametrize("n", [37, 1373])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_sdpa_twin_matches_jax(n, dtype):
    rng = _rng(70 + n)
    q, k, v = (rng.standard_normal((1, 2, n, 64)).astype(np.float32)
               for _ in range(3))
    jd = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    td = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    want = np.asarray(jsdpa.sdpa(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                 scale=0.125).astype(jnp.float32))
    got = k7.sdpa_plain(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                        scale=0.125).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SDPA_TOL[dtype])
    if dtype == "bf16":
        # mostly bit-identical: the two frameworks round at the same points
        assert np.mean(got == want) > 0.9


def test_sdpa_dispatch_on_cpu_and_key_count():
    rng = _rng(71)
    q = torch.from_numpy(rng.standard_normal((2, 3, 20, 32)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 3, 9, 32)).astype(np.float32))
    before = k7.sdpa.launches
    got = k7.sdpa(q, kv, kv)  # default scale d ** -0.5, M != N keys
    assert got.shape == (2, 3, 20, 32) and k7.sdpa.launches == before
    want = np.asarray(jsdpa.sdpa(jnp.asarray(q.numpy()), jnp.asarray(kv.numpy()),
                                 jnp.asarray(kv.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode,antialias,align_corners,out_hw", [
    ("bicubic", True, False, (9, 13)),    # downscale (half-SBS class)
    ("bicubic", True, False, (40, 50)),   # upscale
    ("bilinear", True, False, (14, 28)),  # depth preprocess
    ("bilinear", False, False, (30, 41)),  # delta upscale
    ("bilinear", False, True, (36, 50)),  # DPT _interp
    ("bicubic", True, False, (18, 13)),   # height kept: half-SBS
    ("lanczos", True, False, (18, 40)),   # same-size lanczos is no identity
])
def test_resize_matches_jax(mode, antialias, align_corners, out_hw):
    x = _rng(80).random((2, 18, 25, 3), dtype=np.float32)
    want = np.asarray(jresize.resize(jnp.asarray(x), *out_hw, mode=mode,
                                     antialias=antialias,
                                     align_corners=align_corners))
    got = tresize.resize(torch.from_numpy(x), *out_hw, mode=mode,
                         antialias=antialias, align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(
        tresize.resize_matrix(18, out_hw[0], mode, antialias, align_corners),
        jresize.resize_matrix(18, out_hw[0], mode, antialias, align_corners))


def test_pad_pool_permute_match_jax():
    x = _rng(81).random((2, 6, 16, 3), dtype=np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    pads = (1, 3, 2, 0)
    for tf, jf in ((tpad.replication_pad2d, jpad.replication_pad2d),
                   (tpad.zero_pad2d, jpad.zero_pad2d),
                   (tpad.crop2d, jpad.crop2d)):
        np.testing.assert_array_equal(tf(xt, pads).numpy(),
                                      np.asarray(jf(xj, pads)))
    for k in (3, (3, 1), (1, 3)):
        np.testing.assert_array_equal(tpool.max_pool2d(xt, k).numpy(),
                                      np.asarray(jpool.max_pool2d(xj, k)))
        np.testing.assert_array_equal(tpool.min_pool2d(xt, k).numpy(),
                                      np.asarray(jpool.min_pool2d(xj, k)))
    y = _rng(82).random((2, 6, 2, 24), dtype=np.float32)
    np.testing.assert_array_equal(
        tperm.pixel_shuffle2(torch.from_numpy(y), (1, 8)).numpy(),
        np.asarray(jperm.pixel_shuffle2(jnp.asarray(y), (1, 8))))
    np.testing.assert_array_equal(
        tperm.pixel_unshuffle2(xt, (1, 8)).numpy(),
        np.asarray(jperm.pixel_unshuffle2(xj, (1, 8))))
    w = tperm.window_partition2(xt, (3, 4))
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jperm.window_partition2(xj, (3, 4))))
    assert torch.equal(tperm.window_reverse2(w, (3, 4), 6, 16), xt)


@pytest.mark.parametrize("window,shift", [((4, 4), (False, False)),
                                          ((3, 3), (False, False)),
                                          ((4, 4), (True, True))])
def test_window_mha_matches_jax(window, shift):
    """row_flow_v3's rectangular-window attention with its learned score
    bias, fp32; weights drawn with numpy and given to both packages."""
    from nunif_tpu.modules.attention import WindowMHA2d as JMHA
    from nunif_tpu.modules.attention import WindowScoreBias as JBias
    from nunif_tpu.models import unflatten_params
    from nunif_tpu_torch.models import from_flax, to_flax
    from nunif_tpu_torch.modules.attention import WindowMHA2d, WindowScoreBias

    class Pair(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bias = WindowScoreBias(window)
            self.mha = WindowMHA2d(16, 2, window, shift=shift)

    pair = Pair()
    rng = _rng(83)
    flat = {k: rng.normal(0, 0.5, v.shape).astype(np.float32)
            for k, v in to_flax(pair).items()}
    from_flax(pair, flat)
    p = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    x = rng.standard_normal((2, 12, 12, 16)).astype(np.float32)
    jbias = JBias(window).apply({"params": p["bias"]})
    want = np.asarray(JMHA(16, 2, window, shift=shift).apply(
        {"params": p["mha"]}, jnp.asarray(x), attn_mask=jbias))
    with torch.no_grad():
        bias = pair.bias()
        got = pair.mha(torch.from_numpy(x), attn_mask=bias).numpy()
    np.testing.assert_allclose(bias.numpy(), np.asarray(jbias), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
