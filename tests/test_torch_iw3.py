"""The iw3 frame path of nunif_tpu_torch against the JAX package, on the CPU:
the whole ``Iw3FrameProcessor`` (uint8 frames -> Any_V2_S depth ->
row_flow_v3 -> half-SBS), ``process_image`` and the image CLI (the parts:
tests/test_torch_iw3_parts.py).

Both packages get the same seeded weights drawn with numpy in flax layout
(``shaped_flax_params``: the depth map is not flat and the warp moves
pixels); every whole-path comparison first asserts that the normalised
depth has std > 0.05 and that >= 10% of the left-eye pixels differ from the
input frame.

Precision: both packages hard-code bf16 at three points (the depth
network's input, the warp's image read, the half-SBS resize).  The fp32
runs resolve JAX's ``jnp.bfloat16`` to fp32 in those three modules only
and set the port's ``dtypes.IMAGE_DTYPE`` to fp32 (``fp32``); the port's
depth network takes its compute dtype from ``DepthAnythingModel(dtype=...)``.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nunif_tpu.iw3.composition as j_composition
import nunif_tpu.iw3.depth.depth_anything as j_depth_anything
import nunif_tpu.modules.grid_sample as j_grid_sample
from nunif_tpu.iw3.composition import StereoFormat as JFormat
from nunif_tpu.iw3.models.row_flow_v3 import RowFlowV3 as JRowFlowV3
from nunif_tpu.iw3.pipeline import StereoConfig as JConfig
from nunif_tpu.iw3.pipeline import process_image as j_process_image
from nunif_tpu.iw3.video import Iw3FrameProcessor as JProcessor
from nunif_tpu.models import unflatten_params

from nunif_tpu_torch.core import dtypes
from nunif_tpu_torch.iw3.composition import StereoFormat, postprocess_image
from nunif_tpu_torch.iw3.depth import create_depth_model
from nunif_tpu_torch.iw3.depth.depth_anything import (
    DepthAnything, shaped_flax_params as depth_params)
from nunif_tpu_torch.iw3.models.row_flow_v3 import (
    RowFlowV3, shaped_flax_params as flow_params)
from nunif_tpu_torch.iw3.pipeline import StereoConfig, process_image
from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
from nunif_tpu_torch.models import from_flax

RESOLUTION = 56  # depth input 56x84 (4x6 patches) for 64x96 frames


def _jparams(flat):
    return unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _u8(x):
    return (np.clip(np.asarray(x, np.float32), 0, 1) * 255 + 0.5).astype(np.uint8)


@pytest.fixture(scope="module")
def weights():
    return (depth_params(DepthAnything("vits"), 0),
            flow_params(RowFlowV3(), 1))


@pytest.fixture(scope="module")
def frames():
    """Two 64x96 frames: smooth shapes plus noise, so depth has structure."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:64, 0:96] / 64.0
    base = np.stack([np.sin(3 * xx + yy), np.cos(2 * yy - xx), xx * yy], -1)
    f = [(0.5 + 0.3 * np.roll(base, 7 * i, axis=1)
          + 0.1 * rng.standard_normal(base.shape)) for i in range(2)]
    return _u8(np.stack(f))


def _patch_fp32(monkeypatch):
    """Both packages with their hard-coded bf16 image casts resolved to
    fp32: JAX's ``jnp.bfloat16`` in three modules, the port's
    ``IMAGE_DTYPE``."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    for mod in (j_depth_anything, j_grid_sample, j_composition):
        monkeypatch.setattr(mod, "jnp", proxy)
    monkeypatch.setattr(dtypes, "IMAGE_DTYPE", torch.float32)


@pytest.fixture
def fp32(monkeypatch):
    _patch_fp32(monkeypatch)


@pytest.fixture(scope="module")
def jax_frames_fp32(weights, frames):
    """JAX ``Iw3FrameProcessor`` output under fp32, stateless path."""
    with pytest.MonkeyPatch.context() as mp:
        _patch_fp32(mp)
        jdm, jflow, jfp = _jax(weights)
        jcfg = JConfig(format=JFormat(half_sbs=True))
        return np.asarray(JProcessor(jcfg, jdm, jflow, jfp,
                                     edge_dilation=2)(frames))


def _port(weights, dtype, ema=None):
    dflat, fflat = weights
    dm = create_depth_model("Any_V2_S", device="cpu", dtype=dtype)
    from_flax(dm.load(resolution=RESOLUTION).model, dflat)
    if ema:
        dm.enable_ema(decay=ema, buffer_size=1)
    flow = RowFlowV3()
    from_flax(flow, fflat)
    return dm, flow.eval().requires_grad_(False)


def _jax(weights, ema=None):
    dflat, fflat = weights
    jdm = j_depth_anything.DepthAnythingModel("Any_V2_S")
    jdm.model = j_depth_anything.DepthAnything(encoder="vits")
    jdm.params = _jparams(dflat)
    jdm.prep_lower_bound = RESOLUTION
    if ema:
        jdm.enable_ema(decay=ema, buffer_size=1)
    return jdm, JRowFlowV3(), _jparams(fflat)


def _configs():
    return (StereoConfig(format=StereoFormat(half_sbs=True)),
            JConfig(format=JFormat(half_sbs=True)))


def _assert_not_degenerate(dm, flow, frames, cfg):
    """Normalised depth std > 0.05; >= 10% of left-eye pixels moved."""
    from nunif_tpu_torch.iw3.pipeline import apply_divergence, resize_depth_for
    x = torch.from_numpy(frames).float() / 255
    depth = dm.infer(x, edge_dilation=2)
    dn = torch.stack(dm.minmax_normalize(depth))
    assert float(dn.std()) > 0.05
    left, _right = apply_divergence(resize_depth_for(dn, x, cfg), x, cfg, flow)
    moved = float(((left - x).abs() > 0.5 / 255).float().mean())
    assert moved >= 0.10, moved


def test_frame_processor_fp32_matches_jax(weights, frames, jax_frames_fp32, fp32):
    """Stateless path (EMA off), fp32: max abs err <= 1e-4 on the frame,
    uint8 PSNR >= 50 dB (measured 6.9e-6 and 85.3 dB)."""
    dm, flow = _port(weights, torch.float32)
    cfg, _jcfg = _configs()
    _assert_not_degenerate(dm, flow, frames, cfg)
    got = Iw3FrameProcessor(cfg, dm, flow, edge_dilation=2)(frames).numpy()
    want = jax_frames_fp32
    assert got.shape == want.shape == (2, 64, 96, 3)
    assert np.abs(got - want).max() <= 1e-4
    assert _psnr(_u8(got), _u8(want)) >= 50.0


def test_frame_processor_bf16_matches_jax(weights, frames, jax_frames_fp32):
    """bf16 (the main path's precision): the port differs from JAX bf16 by
    no more than JAX bf16 differs from JAX fp32, max abs on the frame
    (measured 0.043 vs 0.055; uint8 PSNR 48.6 vs 46.5 dB)."""
    want32 = jax_frames_fp32
    jcfg = JConfig(format=JFormat(half_sbs=True))
    jdm16, jflow, jfp = _jax(weights)
    want16 = np.asarray(JProcessor(jcfg, jdm16, jflow, jfp,
                                   edge_dilation=2)(frames))
    dm, flow = _port(weights, torch.bfloat16)
    cfg, _ = _configs()
    _assert_not_degenerate(dm, flow, frames, cfg)
    got = Iw3FrameProcessor(cfg, dm, flow, edge_dilation=2)(frames).numpy()
    err, jax_err = np.abs(got - want16).max(), np.abs(want16 - want32).max()
    assert err <= jax_err, (err, jax_err)
    assert _psnr(_u8(got), _u8(want16)) >= 40.0


def test_frame_processor_ema_path_matches_jax(weights, frames, fp32):
    """EMA on (decay 0.75, buffer 1): per-batch stats read back, host EMA
    constants; two batches so the state carries over.  fp32."""
    cfg, jcfg = _configs()
    _assert_not_degenerate(*_port(weights, torch.float32), frames, cfg)
    dm, flow = _port(weights, torch.float32, ema=0.75)
    proc = Iw3FrameProcessor(cfg, dm, flow, edge_dilation=2)
    jdm, jflow, jfp = _jax(weights, ema=0.75)
    jproc = JProcessor(jcfg, jdm, jflow, jfp, edge_dilation=2)
    for batch in (frames, frames[::-1].copy()):
        got = proc(batch).numpy()
        want = np.asarray(jproc(batch))
        assert np.abs(got - want).max() <= 1e-4
    assert dm.scaler.min_value == pytest.approx(jdm.scaler.min_value, abs=1e-5)
    assert dm.scaler.max_value == pytest.approx(jdm.scaler.max_value, abs=1e-5)
    assert jproc._infer_jit is not None  # JAX took its update_values path


@pytest.mark.parametrize("method", ["grid_sample", "NULL"])
def test_process_image_other_methods_match_jax(weights, frames, fp32, method):
    dm, _flow = _port(weights, torch.float32)
    jdm, _jflow, _jfp = _jax(weights)
    x = frames[0].astype(np.float32) / 255
    fmt = dict(tb=True) if method == "NULL" else dict(cross_eyed=True)
    cfg = StereoConfig(method=method, format=StereoFormat(**fmt))
    if method != "NULL":  # NULL moves nothing by definition
        _assert_not_degenerate(dm, None, frames, cfg)
    got = process_image(torch.from_numpy(x), cfg, dm, edge_dilation=2).numpy()
    want = np.asarray(j_process_image(jnp.asarray(x), JConfig(
        method=method, format=JFormat(**fmt)), jdm, edge_dilation=2))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_cli_image_on_cpu(tmp_path, weights, frames):
    """The image CLI end to end with checkpoints written by the port."""
    from PIL import Image
    from nunif_tpu_torch.iw3 import cli
    from nunif_tpu_torch.models import save_model
    dflat, fflat = weights
    depth = DepthAnything("vits")
    from_flax(depth, dflat)
    flow = RowFlowV3()
    from_flax(flow, fflat)
    save_model(depth, str(tmp_path / "depth.nztm"))
    save_model(flow, str(tmp_path / "flow.nztm"))
    src, dst = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    Image.fromarray(frames[0]).save(src)
    assert cli.main(["-i", src, "-o", dst, "--half-sbs", "--device", "cpu",
                     "--resolution", str(RESOLUTION),
                     "--depth-checkpoint", str(tmp_path / "depth.nztm"),
                     "--stereo-checkpoint", str(tmp_path / "flow.nztm")]) == 0
    with Image.open(dst) as im:
        out = np.asarray(im)
    assert out.shape == (64, 96, 3)
    # the CLI runs the bf16 path: compare with the library call
    dm, fl = _port(weights, torch.bfloat16)
    want = process_image(torch.from_numpy(frames[0]).float() / 255,
                         StereoConfig(format=StereoFormat(half_sbs=True)),
                         dm, fl, edge_dilation=2)
    assert np.abs(out.astype(int) - _u8(want.float().numpy()).astype(int)).max() <= 1


def test_unported_paths_raise(weights, tmp_path):
    from nunif_tpu_torch.iw3 import cli
    dm, flow = _port(weights, torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Iw3FrameProcessor(StereoConfig(), dm, flow, crop=(slice(0, 4), slice(None)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Iw3FrameProcessor(StereoConfig(), dm, flow, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        postprocess_image(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 3),
                          StereoFormat(anaglyph="dubois"))
    with pytest.raises(NotImplementedError, match="video"):
        cli.main(["-i", str(tmp_path / "clip.mp4"), "-o", str(tmp_path / "o.mp4"),
                  "--device", "cpu"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-i", "x.png", "-o", "y.png"])  # --device defaults to cuda

