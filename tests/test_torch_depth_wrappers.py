"""The iw3 wrappers of the other depth families in nunif_tpu_torch against
the JAX package's, on the CPU: ``infer`` of ZoeDepth (ZoeD_N, ZoeD_NK,
ZoeD_Any_N), Depth-Anything-V3 mono (both ``raw_output`` branches, both
scaler modes) and DepthPro (with its FOV head), and one
``Iw3FrameProcessor`` batch with ZoeD_N and with Any_V3_Mono.

The networks are the small configs of tests/test_torch_depth_families.py
(``vitt64``, ``beit_t``, DepthPro at tile 128) on ``seeded_weights_``; both
packages get the same arrays.  fp32 runs resolve the JAX wrappers' bf16
casts to fp32 (``jnp_fp32``): to 1e-4, frames >= 50 dB.  bf16: the port's
mean absolute error against JAX's fp32 output within 1.1x JAX's own bf16
error, its largest within 2x JAX's.  The two round at the same points in
another order, and XLA keeps some sums unrounded where it fuses, so the
two bf16 errors are two draws of the same size; these maps' RMS errors
are ruled by a few pixels and their ratio moves with the seeded input
(0.66-1.39 for ZoeD_Any_N over six inputs), the mean absolute error less
(ZoeD_Any_N over four inputs, measured: 0.76-0.94x JAX's, the largest
0.47-1.32x; DepthPro over eight single frames 0.91-1.14x, mean 0.99, and
over two-frame batches 0.99-1.08x, the higher with TTA).
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nunif_tpu.iw3.composition import StereoFormat as JFormat
from nunif_tpu.iw3.depth import da3 as j3
from nunif_tpu.iw3.depth import depth_pro as jpro
from nunif_tpu.iw3.depth import zoedepth as jz
from nunif_tpu.iw3.models.row_flow_v3 import RowFlowV3 as JRowFlowV3
from nunif_tpu.iw3.pipeline import StereoConfig as JConfig
from nunif_tpu.iw3.video import Iw3FrameProcessor as JProcessor

from nunif_tpu_torch.iw3.composition import StereoFormat
from nunif_tpu_torch.iw3.depth import create_depth_model
from nunif_tpu_torch.iw3.depth import da3 as t3
from nunif_tpu_torch.iw3.depth import depth_pro as tpro
from nunif_tpu_torch.iw3.depth import zoedepth as tz
from nunif_tpu_torch.iw3.depth.base import SEEDED_FILLS as FILLS
from nunif_tpu_torch.iw3.models.row_flow_v3 import RowFlowV3, shaped_flax_params
from nunif_tpu_torch.iw3.pipeline import StereoConfig, apply_divergence, resize_depth_for
from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
from nunif_tpu_torch.models import from_flax

import torch_iw3_helpers as h

pytestmark = pytest.mark.usefixtures("two_threads")
two_threads = h.two_threads


@pytest.fixture(scope="module", autouse=True)
def tables():
    mp = pytest.MonkeyPatch()
    h.add_depth_tables(mp)
    yield
    mp.undo()


_seeded, _hold_bf16 = h.seeded, h.hold_bf16


def _nk():
    return _seeded(tz.ZoeDepthNKNet(core="beit_t"), FILLS["ZoeD_N"])


def _wrappers(name, flat, setup_port, setup_jax, jmod, jmodule, dtype, **kw):
    """(port wrapper on the weights, JAX wrapper on the same)."""
    dm = create_depth_model(name, device="cpu", dtype=dtype, **kw)
    setup_port(dm)
    from_flax(dm.model, flat)
    jdm = jmodule(name, **kw)
    setup_jax(jdm)
    jdm.model, jdm.params = jmod, h.jparams(flat)
    return dm, jdm


def _zoe_pair(name, dtype, flat):
    core = "dinov2_vitt64" if name.startswith("ZoeD_Any") else "beit_t"
    res = 56 if core.startswith("dinov2") else 64

    def port(dm):
        dm.core = core
        dm.load(resolution=res)

    def jsetup(jdm):
        jdm.core = core
        jdm.prep_h_height = jdm.prep_v_height = res
    jcls = jz.ZoeDepthNKNet if name == "ZoeD_NK" else jz.ZoeDepthNet
    return _wrappers(name, flat, port, jsetup, jcls(core=core), jz.ZoeDepthModel, dtype)


def _zoe_flat(name):
    if name == "ZoeD_NK":
        return _nk()[1]
    core = "dinov2_vitt64" if name.startswith("ZoeD_Any") else "beit_t"
    return _seeded(tz.ZoeDepthNet(core=core), FILLS["ZoeD_N" if core == "beit_t" else "ZoeD_Any_N"])[1]


ZOE_CASES = [("ZoeD_N", False, 2), ("ZoeD_NK", True, 0), ("ZoeD_Any_N", True, (2, 1))]


@pytest.mark.parametrize("name,tta,edge_dilation", ZOE_CASES)
def test_zoedepth_wrapper_matches_jax(monkeypatch, name, tta, edge_dilation):
    """ZoeDepthModel.infer: the shrink, reflection pad, the net, TTA,
    nan_to_num, crop and the negated (dilated) depth.  fp32 (the JAX
    wrapper's bf16 cast resolved to fp32) to 1e-4; bf16 within JAX's own
    bf16 error (x 1.1)."""
    flat = _zoe_flat(name)
    # BEiT: a 64x96 input, a 4x6 grid (the bias grown in width); ZoeD_Any:
    # 56x84, a 4x6 patch grid
    x = np.random.default_rng(16).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    j16 = None
    dm16, jdm16 = _zoe_pair(name, torch.bfloat16, flat)
    j16 = np.asarray(jdm16.infer(jnp.asarray(x), tta=tta, edge_dilation=edge_dilation))
    got16 = dm16.infer(torch.from_numpy(x), tta=tta, edge_dilation=edge_dilation).numpy()
    monkeypatch.setattr(jz, "jnp", h.jnp_fp32())
    dm, jdm = _zoe_pair(name, torch.float32, flat)
    want = np.asarray(jdm.infer(jnp.asarray(x), tta=tta, edge_dilation=edge_dilation))
    got = dm.infer(torch.from_numpy(x), tta=tta, edge_dilation=edge_dilation).numpy()
    assert got.shape == want.shape and got.std() > 1e-3 and (got < 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    _hold_bf16(got16, want, j16, slack=1.1, stat="mae")
    assert dm.is_metric() and dm.is_video_supported()


def _da3_pair(name, dtype, flat, raw_output):
    def port(dm):
        dm.encoder = "vitt64"
        dm.load(resolution=70)

    def jsetup(jdm):
        jdm.encoder = "vitt64"
        jdm.prep_lower_bound = 70
    return _wrappers(name, flat, port, jsetup, j3.DepthAnythingV3Mono(encoder="vitt64"),
                     j3.DepthAnythingV3MonoModel, dtype, raw_output=raw_output)


@pytest.mark.parametrize("name,raw_output,tta,edge_dilation",
                         [("Any_V3_Mono", False, True, 2), ("Any_V3_Mono_01", True, False, 2)])
def test_da3_wrapper_matches_jax(monkeypatch, name, raw_output, tta, edge_dilation):
    """DepthAnythingV3MonoModel.infer in both branches and its scaler mode
    ("max" for Any_V3_Mono, "minmax" for Any_V3_Mono_01), fp32 to 1e-4 and
    bf16 within JAX's own bf16 error (x 1.1)."""
    flat = _seeded(t3.DepthAnythingV3Mono("vitt64"), FILLS["Any_V3_Mono"])[1]
    x = np.random.default_rng(17).uniform(0, 1, (2, 70, 112, 3)).astype(np.float32)
    dm16, jdm16 = _da3_pair(name, torch.bfloat16, flat, raw_output)
    j16 = np.asarray(jdm16.infer(jnp.asarray(x), tta=tta, edge_dilation=edge_dilation))
    got16 = dm16.infer(torch.from_numpy(x), tta=tta, edge_dilation=edge_dilation).numpy()
    monkeypatch.setattr(j3, "jnp", h.jnp_fp32())
    dm, jdm = _da3_pair(name, torch.float32, flat, raw_output)
    want = np.asarray(jdm.infer(jnp.asarray(x), tta=tta, edge_dilation=edge_dilation))
    got = dm.infer(torch.from_numpy(x), tta=tta, edge_dilation=edge_dilation).numpy()
    assert got.shape == want.shape and got.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    _hold_bf16(got16, want, j16, slack=1.1, stat="mae")
    assert dm.scaler.mode == jdm.scaler.mode == ("max" if name == "Any_V3_Mono" else "minmax")
    for g, w in zip(dm.minmax_normalize(torch.from_numpy(got)), jdm.minmax_normalize(jnp.asarray(want))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def _pro_pair(dtype, flat):
    def port(dm):
        dm.encoder, dm.tile_size, dm.img_size = "vitt64", 128, 512
        dm.load()

    def jsetup(jdm):
        jdm.encoder, jdm.tile_size, jdm.img_size = "vitt64", 128, 512
    return _wrappers("DepthPro_S", flat, port, jsetup,
                     jpro.DepthPro(encoder="vitt64", tile_size=128, pos_embed_size=24),
                     jpro.DepthProModel, dtype)


def test_depth_pro_wrapper_matches_jax(monkeypatch):
    """DepthProModel.infer with TTA and dilation: the square resize, the
    FOV's f_px in fp32, the clamp, the resize back; the wrapper's default
    position-embedding grid (24) resized to the 8x8 tile grid.  fp32 to 1e-4, bf16 within JAX's own bf16 error (x 1.1);
    a disparity (positive, no sign inversion); images only."""
    flat = _seeded(tpro.DepthPro(encoder="vitt64", tile_size=128), FILLS["DepthPro"])[1]
    x = np.random.default_rng(18).uniform(0, 1, (2, 180, 320, 3)).astype(np.float32)
    dm16, jdm16 = _pro_pair(torch.bfloat16, flat)
    j16 = np.asarray(jdm16.infer(jnp.asarray(x), tta=True, edge_dilation=2))
    got16 = dm16.infer(torch.from_numpy(x), tta=True, edge_dilation=2).numpy()
    monkeypatch.setattr(jpro, "jnp", h.jnp_fp32())
    dm, jdm = _pro_pair(torch.float32, flat)
    want = np.asarray(jdm.infer(jnp.asarray(x), tta=True, edge_dilation=2))
    got = dm.infer(torch.from_numpy(x), tta=True, edge_dilation=2).numpy()
    assert got.shape == want.shape == (2, 180, 320, 1) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    _hold_bf16(got16, want, j16, slack=1.1, stat="mae")
    assert not dm.is_metric() and not dm.is_video_supported() and dm.is_image_supported()


# the frame path

def _frames():
    rng = np.random.default_rng(19)
    yy, xx = np.mgrid[0:96, 0:128] / 96.0
    base = np.stack([np.sin(3 * xx + yy), np.cos(2 * yy - xx), xx * yy], -1)
    disc = ((xx - 0.7) ** 2 + (yy - 0.5) ** 2 < 0.05)[..., None]
    f = [(0.5 + 0.3 * np.roll(base, 9 * i, axis=1) - 0.3 * disc
          + 0.08 * rng.standard_normal(base.shape)) for i in range(2)]
    return h.u8(np.stack(f))


@pytest.mark.parametrize("name", ["ZoeD_N", "Any_V3_Mono"])
def test_frame_processor_matches_jax(monkeypatch, name):
    """One batch of two frames through both ``Iw3FrameProcessor``s (fp32,
    row_flow_v3, half-SBS, divergence 2, edge dilation 2): >= 50 dB, the
    normalised depth not flat and the left eye moved; ZoeD takes the
    mapper's metric branch."""
    fflat = shaped_flax_params(RowFlowV3(), 1)
    if name == "ZoeD_N":
        flat = _zoe_flat(name)
        h.patch_fp32(monkeypatch, jz)
        dm, jdm = _zoe_pair(name, torch.float32, flat)
    else:
        flat = _seeded(t3.DepthAnythingV3Mono("vitt64"), FILLS["Any_V3_Mono"])[1]
        h.patch_fp32(monkeypatch, j3)
        dm, jdm = _da3_pair(name, torch.float32, flat, False)
    flow = RowFlowV3()
    from_flax(flow, fflat)
    flow.eval().requires_grad_(False)
    frames = _frames()
    cfg = StereoConfig(format=StereoFormat(half_sbs=True))
    got = Iw3FrameProcessor(cfg, dm, flow, edge_dilation=2)(frames).numpy()
    jcfg = JConfig(format=JFormat(half_sbs=True))
    want = np.asarray(JProcessor(jcfg, jdm, JRowFlowV3(), h.jparams(fflat), edge_dilation=2)(frames))
    assert got.shape == want.shape == (2, 96, 128, 3)
    x = torch.from_numpy(frames).float() / 255
    dn = torch.stack(dm.minmax_normalize(dm.infer(x, edge_dilation=2)))
    assert float(dn.std()) > 0.05
    left, _right = apply_divergence(resize_depth_for(dn, x, cfg), x, cfg, flow,
                                    metric_depth=dm.is_metric())
    moved = float(((left - x).abs() > 0.5 / 255).float().mean())
    assert moved >= 0.10, moved
    assert h.psnr(h.u8(got), h.u8(want)) >= 50.0


def test_cli_runs_null_depth_on_cpu(tmp_path):
    """The image CLI takes every depth type: NULL (no network) with the
    plain backward warp, one image."""
    from PIL import Image
    from nunif_tpu_torch.iw3 import cli
    src, dst = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    Image.fromarray(_frames()[0]).save(src)
    assert cli.main(["-i", src, "-o", dst, "--depth-model", "NULL", "--method",
                     "grid_sample", "--device", "cpu", "--resolution", "64"]) == 0
    with Image.open(dst) as im:
        assert im.size == (256, 96)
