"""iw3's extras in nunif_tpu_torch against the JAX package, on the CPU: the
anaglyphs, ``grid_sample``, the VR180 projection, the new output formats
through ``postprocess_image``, U2NETP / SODV1, the convergence estimator,
DepthAA, ``AutoCropDetector``, the 16-bit depth PNG and ``ExportConfig``
(the frame processor: tests/test_torch_iw3_extras_frames.py; the CLI:
tests/test_torch_iw3_cli_extras.py).

Tolerances: fp32 nets 1e-4 max abs; the anaglyphs 1e-5; composed uint8
frames >= 50 dB; bf16 nets: the port's error against JAX's fp32 output
no larger than JAX's own bf16 error (max abs; slack 1.0); the quantiles,
the crop slices, the PNG samples and the YAML text exactly.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.iw3 import anaglyph as j_anaglyph
from nunif_tpu.iw3 import convergence_estimator as j_ce
from nunif_tpu.iw3.composition import StereoFormat as JFormat
from nunif_tpu.iw3.composition import postprocess_image as j_postprocess
from nunif_tpu.iw3.depth.base import BaseDepthModel as JBase
from nunif_tpu.iw3.equirectangular import equirectangular_projection as j_equirect
from nunif_tpu.iw3.export_config import ExportConfig as JExportConfig
from nunif_tpu.iw3.models.depth_aa import DepthAA as JDepthAA
from nunif_tpu.iw3.models.depth_aa import depth_aa_infer as j_depth_aa_infer
from nunif_tpu.iw3.models.sod_v1 import SODV1 as JSODV1
from nunif_tpu.modules.grid_sample import grid_sample as j_grid_sample
from nunif_tpu.utils.autocrop import AutoCropDetector as JAutoCrop
from nunif_tpu.utils.u2netp import U2NETP as JU2NETP

from nunif_tpu_torch.iw3 import anaglyph
from nunif_tpu_torch.iw3 import convergence_estimator as ce
from nunif_tpu_torch.iw3.composition import StereoFormat, postprocess_image
from nunif_tpu_torch.iw3.depth.base import BaseDepthModel
from nunif_tpu_torch.iw3.equirectangular import equirectangular_projection
from nunif_tpu_torch.iw3.export_config import ExportConfig
from nunif_tpu_torch.iw3.models.depth_aa import (
    DepthAA, depth_aa_infer, shaped_flax_params as aa_params)
from nunif_tpu_torch.iw3.models.sod_v1 import SODV1, shaped_flax_params as sod_params
from nunif_tpu_torch.models import from_flax, to_flax
from nunif_tpu_torch.modules.grid_sample import grid_sample
from nunif_tpu_torch.utils.autocrop import MODES, AutoCropDetector
from nunif_tpu_torch.utils.u2netp import U2NETP

from torch_iw3_helpers import jparams, patch_fp32, psnr, t, u8


def seeded_flat(model, seed):
    """Flax-layout weights for ``model``: lecun-normal kernels clipped at 2
    std, N(0, 0.02) biases (numpy, for both packages)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in to_flax(model).items():
        if key.endswith("kernel"):
            std = math.sqrt(1.0 / math.prod(ref.shape[:-1])) / 0.8796256610342398
            flat[key] = (np.clip(rng.standard_normal(ref.shape), -2, 2) * std).astype(np.float32)
        else:
            flat[key] = rng.normal(0, 0.02, ref.shape).astype(np.float32)
    return flat


def eyes(seed, b=2, h=24, w=40):
    rng = np.random.default_rng(seed)
    return (rng.random((b, h, w, 3)).astype(np.float32),
            rng.random((b, h, w, 3)).astype(np.float32))


@pytest.mark.parametrize("kind", anaglyph.ANAGLYPH_TYPES)
def test_anaglyph_matches_jax(kind):
    """fp32, max abs 1e-5 (inputs a little outside [0, 1] too)."""
    left, right = eyes(1)
    left, right = left * 1.1 - 0.05, right * 1.1 - 0.05
    got = anaglyph.apply_anaglyph_redcyan(t(left), t(right), kind).numpy()
    want = np.asarray(j_anaglyph.apply_anaglyph_redcyan(
        jnp.asarray(left), jnp.asarray(right), kind))
    assert got.shape == want.shape == left.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert anaglyph.ANAGLYPH_TYPES == j_anaglyph.ANAGLYPH_TYPES


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("padding,align", [("zeros", True), ("border", True),
                                           ("reflection", True), ("zeros", False),
                                           ("border", False)])
def test_grid_sample_matches_jax(mode, padding, align):
    """Every mode x padding the port implements, grids reaching past the
    borders: fp32 max abs 1e-4."""
    rng = np.random.default_rng(2)
    x = rng.random((2, 13, 17, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 9, 11, 2)).astype(np.float32)
    got = grid_sample(t(x), t(grid), mode, padding, align).numpy()
    want = np.asarray(j_grid_sample(jnp.asarray(x), jnp.asarray(grid), mode,
                                    padding, align))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_grid_sample_reflection_unaligned_raises():
    with pytest.raises(NotImplementedError, match="reflection"):
        grid_sample(torch.zeros(1, 4, 4, 1), torch.zeros(1, 2, 2, 2),
                    padding_mode="reflection", align_corners=False)


@pytest.mark.parametrize("hw", [(24, 40), (31, 20)])
def test_equirectangular_matches_jax(hw):
    """Wide and tall (odd) eyes: the padded square, fp32 max abs 1e-4."""
    x = eyes(3, h=hw[0], w=hw[1])[0]
    got = equirectangular_projection(t(x)).numpy()
    want = np.asarray(j_equirect(jnp.asarray(x)))
    assert got.shape == want.shape
    size = max(hw) + max(hw) // 2  # one less on an axis with an odd pad
    assert all(size - 1 <= n <= size for n in got.shape[1:3])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


FORMATS = {
    "anaglyph_dubois": dict(anaglyph="dubois"),
    "anaglyph_over_tb": dict(anaglyph="wimmer2", tb=True, cross_eyed=True),
    "vr180": dict(vr180=True, ipd_offset=5.0),
    "rgbd_no_ipd_pad": dict(rgbd=True, ipd_offset=5.0),
    "half_rgbd": dict(half_rgbd=True, ipd_offset=-5.0, pad=0.1),
    "half_sbs_capped": dict(half_sbs=True, max_output_width=50,
                            keep_aspect_ratio=True),
}


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_postprocess_formats_match_jax(name, monkeypatch):
    """Each new output format (and the anaglyph's precedence over TB and
    cross-eyed, RGBD's skipped IPD pad) through ``postprocess_image``, the
    half downscales in fp32 in both packages: uint8 PSNR >= 50 dB and the
    same shape."""
    patch_fp32(monkeypatch)
    left, right = eyes(4, h=36, w=64)
    got = postprocess_image(t(left), t(right), StereoFormat(**FORMATS[name])).numpy()
    want = np.asarray(j_postprocess(jnp.asarray(left), jnp.asarray(right),
                                    JFormat(**FORMATS[name])))
    assert got.shape == want.shape
    assert psnr(u8(got), u8(want)) >= 50.0


@pytest.fixture(scope="module")
def u2netp_weights():
    return seeded_flat(U2NETP(in_ch=6), 1)


@pytest.mark.parametrize("hw", [(64, 64), (45, 71)])
def test_u2netp_matches_jax(u2netp_weights, hw):
    """All seven maps at 64x64 and at an odd size (RSU7's deepest level 1 x
    2, the ceil pools and the up-resizes land on the same shapes): fp32
    max abs 1e-4; bf16: the port's error against JAX fp32 within JAX
    bf16's (max abs, slack 1.0; measured 0.0019 vs 0.0020 and 0.0020 vs
    0.0023)."""
    model = U2NETP(in_ch=6)
    from_flax(model, u2netp_weights)
    x = np.random.default_rng(5).random((2,) + hw + (6,)).astype(np.float32)
    apply = jax.jit(JU2NETP().apply)
    params = {"params": jparams(u2netp_weights)}
    want = [np.asarray(w) for w in apply(params, jnp.asarray(x))]
    with torch.no_grad():
        got = [g.numpy() for g in model(t(x))]
        got16 = model(t(x).bfloat16())[0].float().numpy()
    assert len(got) == 7
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2,) + hw + (1,)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    want16 = np.asarray(apply(params, jnp.asarray(x, jnp.bfloat16))[0], np.float32)
    assert np.abs(got16 - want[0]).max() <= np.abs(want16 - want[0]).max()


def structured_rgbd(b=2, h=50, w=90, seed=6):
    """rgb with smooth fields and a disc, depth with a nearer disc: (b, h,
    w, 4) float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for i in range(b):
        disc = ((xx - 0.4 - 0.1 * i) ** 2 + (yy - 0.3) ** 2) < 0.03
        rgb = np.stack([np.sin(6 * xx + 2 * yy + i), np.cos(5 * yy - 3 * xx),
                        xx * yy], -1) * 0.3 + 0.5 - 0.3 * disc[..., None]
        depth = 0.3 + 0.4 * yy + 0.3 * disc
        out.append(np.concatenate([rgb, depth[..., None]], -1))
    x = np.stack(out) + 0.01 * rng.standard_normal((b, h, w, 4))
    return np.clip(x, 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def sod():
    """(port SODV1 with calibrated shaped weights, its flax weights)."""
    model = SODV1().eval()
    flat = sod_params(model, 2, calibration=t(structured_rgbd()))
    return model, flat


def test_sod_matches_jax(sod):
    """SODV1 (resize to 192 with antialias, U2NETP, back without) on a 50 x
    90 input: fp32 max abs 1e-4, the mask partial; bf16 within JAX bf16's
    error against JAX fp32 at slack 1.1, mean and max abs (PERF.md section
    6: measured 0.00368 vs 0.00342 and 0.0215 vs 0.0213)."""
    model, flat = sod
    x = structured_rgbd()
    with torch.no_grad():
        got = model(t(x)).numpy()
        got16 = model(t(x).bfloat16()).float().numpy()
    apply = jax.jit(JSODV1().apply)
    params = {"params": jparams(flat)}
    want = np.asarray(apply(params, jnp.asarray(x)))
    want16 = np.asarray(apply(params, jnp.asarray(x, jnp.bfloat16)), np.float32)
    assert got.shape == want.shape == (2, 50, 90, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert 0.1 < (got > 0.5).mean() < 0.9
    err, jax_err = np.abs(got16 - want), np.abs(want16 - want)
    assert err.mean() <= 1.1 * jax_err.mean()
    assert err.max() <= 1.1 * jax_err.max()


def _saliency_cases():
    rng = np.random.default_rng(7)
    depth = rng.random((4, 16, 20, 1)).astype(np.float32)
    sal = rng.random((4, 16, 20, 1)).astype(np.float32)
    sal[1] = 0.0            # empty mask -> 0.5
    sal[2] = 1.0            # full mask
    depth[3] = 0.37         # flat depth (range < 1e-6) -> its quantile
    return sal, depth


@pytest.mark.parametrize("pos", [0.0, 0.5, 0.8])
def test_depth_position_from_ratio_matches_jax(pos):
    """Partial, empty, full and flat cases: exactly equal."""
    sal, depth = _saliency_cases()
    got = ce.depth_position_from_ratio(t(sal), t(depth), pos).numpy()
    want = np.asarray(j_ce.depth_position_from_ratio(
        jnp.asarray(sal), jnp.asarray(depth), pos))
    np.testing.assert_array_equal(got, want)
    assert got[1] == 0.5 and got[3] == pytest.approx(0.37)


def test_convergence_estimator_ema_and_resets_match_jax(sod):
    """EMA (decay 0.9) over three batches with a reset after the second
    frame of the second batch: fp32, max abs 1e-5; without EMA the raw
    positions."""
    model, flat = sod
    x = structured_rgbd(b=3, h=48, w=48)
    est = ce.ConvergenceEstimator(0.6, model, enable_ema=True)
    jsod = JSODV1()
    jitted = types.SimpleNamespace(apply_fn=jax.jit(
        lambda p, x: jsod.apply({"params": p}, x)))
    jest = j_ce.ConvergenceEstimator(0.6, sod_model=jitted,
                                     sod_params=jparams(flat), enable_ema=True)
    for i, resets in enumerate(([False] * 3, [False, True, False], None)):
        xb = np.roll(x, 5 * i, axis=2)
        got = est(t(xb[..., :3]), t(xb[..., 3:]), reset_pts=resets).numpy()
        want = np.asarray(jest(jnp.asarray(xb[..., :3]), jnp.asarray(xb[..., 3:]),
                               reset_pts=resets))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert est.convergence_ema == pytest.approx(jest.convergence_ema, abs=1e-6)
    est.reset(enable_ema=False)
    raw = est(t(x[..., :3]), t(x[..., 3:])).numpy()
    jraw = np.asarray(j_ce.depth_position_from_ratio(
        jitted.apply_fn(jparams(flat), jnp.asarray(x)),
        jnp.asarray(x[..., 3:]), 0.6))
    np.testing.assert_allclose(raw, jraw, rtol=0, atol=1e-5)
    assert 0.0 < float(est.mask_share) < 1.0


def test_depth_aa_matches_jax():
    """DepthAA (clamped) and ``depth_aa_infer`` (whole-batch min / max, a
    frame with a range unlike the other's) on shaped weights: fp32 max abs
    1e-4 (on depth values up to 4), the net changing the depth; at flax's
    init (``proj_out`` zero) the net is the identity; bf16 within JAX
    bf16's error (slack 1.0; measured 0.0078 vs 0.0097)."""
    model = DepthAA().eval()
    flat = aa_params(model, 3)
    from_flax(model, flat)
    rng = np.random.default_rng(8)
    x = rng.random((2, 40, 70, 1)).astype(np.float32)
    x[1] = x[1] * 3 + 1
    jm, jp = JDepthAA(), jparams(flat)
    jitted = types.SimpleNamespace(apply_fn=jax.jit(
        lambda p, x, clamp: jm.apply({"params": p}, x, clamp=clamp),
        static_argnames="clamp"))
    with torch.no_grad():
        got = depth_aa_infer(model, t(x)).numpy()
        got_net = model(t(x[:1])).numpy()
        got16 = model(t(x[:1]).bfloat16()).float().numpy()
    want = np.asarray(j_depth_aa_infer(jitted, jp, jnp.asarray(x)))
    apply = jax.jit(jm.apply)
    want_net = np.asarray(apply({"params": jp}, jnp.asarray(x[:1])))
    want16 = np.asarray(apply({"params": jp}, jnp.asarray(x[:1], jnp.bfloat16)),
                        np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_net, want_net, rtol=0, atol=1e-4)
    assert np.abs(got - x).max() > 0.05
    assert np.abs(got16 - want_net).max() <= np.abs(want16 - want_net).max()
    ident = DepthAA().init_flax_default_(torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        np.testing.assert_array_equal(ident(t(x[:1])).numpy(), x[:1])


def letterboxed(b=3, h=60, w=96, bars=(10, 12), side=(6, 8)):
    """Frames (b, h, w, 3) in [0, 1] with black bars top / bottom
    (``bars``) and left / right (``side``) around textured content."""
    rng = np.random.default_rng(9)
    f = 0.2 + 0.6 * rng.random((b, h, w, 3)).astype(np.float32)
    f[:, :bars[0]] = f[:, h - bars[1]:] = 0.02
    f[:, :, :side[0]] = f[:, :, w - side[1]:] = 0.02
    return f


@pytest.mark.parametrize("mode", MODES)
def test_autocrop_matches_jax(mode):
    """Every mode on letterboxed frames: the same slices as the JAX
    detector, and in ``black`` the bars exactly."""
    frames = letterboxed()
    det, jdet = AutoCropDetector(mode=mode), JAutoCrop(mode=mode)
    det.update(frames)
    jdet.update(frames)
    assert det.get_crop() == jdet.get_crop()
    assert AutoCropDetector.detect(frames[0], mode) == JAutoCrop.detect(frames[0], mode)
    if mode == "black":
        assert det.get_crop() == (slice(10, 48), slice(6, 88))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_depth_png_round_trip_across_packages(tmp_path, writer):
    """A 16-bit depth PNG with min / max text chunks written by one package
    reads back bit-exact in the other (and in its own)."""
    rng = np.random.default_rng(10)
    d = rng.random((20, 30, 1)).astype(np.float32)
    path = str(tmp_path / "d.png")
    save = (BaseDepthModel if writer == "port" else JBase).save_normalized_depth
    save(d if writer == "jax" else t(d), path, png_info={"note": "x"},
         min_depth_value=-0.25, max_depth_value=3.5)
    got, meta = BaseDepthModel.load_depth(path)
    want, jmeta = JBase.load_depth(path)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert meta == jmeta
    assert meta["iw3_min_depth_value"] == "-0.25"
    q = np.asarray(want)
    assert q.shape == (20, 30, 1)
    np.testing.assert_array_equal(
        np.round((q + 0.25) / 3.75 * 65535),
        np.floor(np.clip(d, 0, 1) * 65535).astype(np.float64))


def test_export_config_text_matches_jax(tmp_path):
    """The same fields write byte-equal YAML in both packages, and each
    reads the other's back."""
    from fractions import Fraction
    kw = dict(basename="in.png", fps=Fraction(30000, 1001), mapper="div_6",
              skip_mapper=True, divergence=2.5, convergence=0.25,
              updated_at="2026-01-02T03:04:05")
    ExportConfig("video", **kw).save(str(tmp_path / "a.yml"))
    JExportConfig("video", **kw).save(str(tmp_path / "b.yml"))
    a, b = (tmp_path / "a.yml").read_bytes(), (tmp_path / "b.yml").read_bytes()
    assert a == b
    back = ExportConfig.load(str(tmp_path / "b.yml"))
    assert (back.fps, back.mapper, back.skip_mapper, back.divergence) == \
        (Fraction(30000, 1001), "div_6", True, 2.5)
    assert back.resolve_paths("/x") == ("/x/rgb", "/x/depth")
