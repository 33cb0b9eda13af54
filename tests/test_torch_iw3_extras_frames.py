"""``Iw3FrameProcessor``'s extras in nunif_tpu_torch against the JAX
package, on the CPU: letterbox crop, DepthAA, the SOD convergence estimator
with its EMA and scene-cut resets, and the debug depth, over three batches;
and the two reference faults the port does not copy here: the estimator
on the lagged path, and ``--depth-aa`` on DA3 and VDA.

Both packages get the same seeded weights drawn with numpy in flax layout
(Any_V2_S at a 56-pixel depth input, row_flow_v3, DepthAA and SODV1
``shaped_flax_params``), fp32 throughout (``patch_fp32``).  Frames >= 50
dB, depth and convergences to 1e-4.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.iw3 import convergence_estimator as j_ce
from nunif_tpu.iw3.composition import StereoFormat as JFormat
from nunif_tpu.iw3.depth import da3 as j3
from nunif_tpu.iw3.depth import vda as jvda
from nunif_tpu.iw3.models.depth_aa import DepthAA as JDepthAA
from nunif_tpu.iw3.models.row_flow_v3 import RowFlowV3 as JRowFlowV3
from nunif_tpu.iw3.models.sod_v1 import SODV1 as JSODV1
from nunif_tpu.iw3.pipeline import StereoConfig as JConfig
from nunif_tpu.iw3.video import Iw3FrameProcessor as JProcessor

import nunif_tpu.iw3.depth.dinov2 as jdino
import nunif_tpu_torch.iw3.depth.dinov2 as tdino
from nunif_tpu_torch.iw3 import convergence_estimator as ce
from nunif_tpu_torch.iw3.composition import StereoFormat
from nunif_tpu_torch.iw3.depth import create_depth_model
from nunif_tpu_torch.iw3.depth import da3 as t3
from nunif_tpu_torch.iw3.depth import vda as tvda
from nunif_tpu_torch.iw3.depth.base import SEEDED_FILLS
from nunif_tpu_torch.iw3.depth.depth_anything import DepthAnything
from nunif_tpu_torch.iw3.depth.depth_anything import shaped_flax_params as depth_params
from nunif_tpu_torch.iw3.models.depth_aa import (
    DepthAA, depth_aa_infer, shaped_flax_params as aa_params)
from nunif_tpu_torch.iw3.models.row_flow_v3 import RowFlowV3
from nunif_tpu_torch.iw3.models.row_flow_v3 import shaped_flax_params as flow_params
from nunif_tpu_torch.iw3.models.sod_v1 import SODV1, shaped_flax_params as sod_params
from nunif_tpu_torch.iw3.pipeline import StereoConfig
from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
from nunif_tpu_torch.models import from_flax
from nunif_tpu_torch.utils.autocrop import AutoCropDetector

import torch_iw3_helpers as h

pytestmark = pytest.mark.usefixtures("two_threads")
two_threads = h.two_threads

BARS = 8  # black rows above and below the 64 x 96 picture
BOUNDARY = 3  # frame 3 starts a new shot


def letterboxed_video(n=6):
    """n uint8 frames of 80 x 96: 64 rows of structure (smooth fields, a
    moving disc, noise) between black bars of BARS rows."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:64, 0:96] / 64.0
    out = np.zeros((n, 64 + 2 * BARS, 96, 3), np.float32)
    for i in range(n):
        base = np.stack([np.sin(3 * xx + yy + 0.2 * i), np.cos(2 * yy - xx),
                         xx * yy], -1)
        disc = ((xx - 0.5 - 0.08 * i) ** 2 + (yy - 0.5) ** 2 < 0.06)[..., None]
        out[i, BARS:BARS + 64] = (0.5 + 0.3 * base - 0.3 * disc
                                  + 0.05 * rng.standard_normal(base.shape))
    return h.u8(out)


@pytest.fixture(scope="module")
def video():
    return letterboxed_video()


@pytest.fixture(scope="module")
def weights(video):
    """Flax-layout weights: depth, row_flow_v3, DepthAA, SODV1 (its
    saliency calibrated on the cropped frames with a ramp depth)."""
    x = torch.from_numpy(video[:2, BARS:-BARS]).float() / 255
    ramp = torch.linspace(0, 1, 64).reshape(1, 64, 1, 1).expand(2, 64, 96, 1)
    return dict(depth=depth_params(DepthAnything("vits"), 0),
                flow=flow_params(RowFlowV3(), 1),
                aa=aa_params(DepthAA(), 3),
                sod=sod_params(SODV1(), 2, calibration=torch.cat([x, ramp], -1)))


def _jitted(module, **static):
    """A stand-in for a JAX model whose ``apply_fn`` is jitted."""
    names = tuple(static)
    return types.SimpleNamespace(apply_fn=jax.jit(
        lambda p, x, **kw: module.apply({"params": p}, x, **kw),
        static_argnames=names))


def _port(weights, ema=None, aa=True):
    dm, _jdm = h.depth_models(weights["depth"])
    if ema:
        dm.enable_ema(decay=0.75, buffer_size=ema)
    if aa:
        net = DepthAA().eval()
        from_flax(net, weights["aa"])
        dm.set_depth_aa(net)
    flow = RowFlowV3().eval()
    from_flax(flow, weights["flow"])
    sod = SODV1().eval()
    from_flax(sod, weights["sod"])
    return dm, flow, sod


def _jax(weights, ema=None, aa=True):
    _dm, jdm = h.depth_models(weights["depth"])
    if ema:
        jdm.enable_ema(decay=0.75, buffer_size=ema)
    if aa:
        jdm.set_depth_aa(_jitted(JDepthAA(), clamp=False), h.jparams(weights["aa"]))
    return jdm, JRowFlowV3(), h.jparams(weights["flow"])


def _crop(video):
    det = AutoCropDetector(mode="black")
    det.update(video.astype(np.float32) / 255)
    crop = det.get_crop()
    assert crop == (slice(BARS, 64 + BARS), slice(None))
    return crop


class Spy:
    """A convergence estimator that records the reset flags it is given
    and the convergences it returns."""

    def __init__(self, est):
        self.est, self.flags, self.out = est, [], []

    def __call__(self, rgb, depth, reset_pts=None):
        self.flags.extend(reset_pts)
        self.out.append(self.est(rgb, depth, reset_pts=reset_pts))
        return self.out[-1]


def _batches(proc, video, flush=False):
    outs = [proc(video[i:i + 2]) for i in range(0, len(video), 2)]
    if flush:
        outs.append(proc.flush())
    return [np.asarray(o) for o in outs if o is not None]


@pytest.mark.parametrize("debug_depth", [False, True])
def test_processor_crop_aa_estimator_match_jax(weights, video, monkeypatch, debug_depth):
    """Three batches of 2 letterboxed frames through both processors with
    the crop ``AutoCropDetector`` finds, DepthAA, the EMA scaler (decay
    0.75, buffer 1) and a scene cut at frame 3; the estimator (EMA on,
    reset after frame 2), or the debug depth: every frame >= 50 dB, the
    estimator's state to 1e-5, the convergences not constant."""
    h.patch_fp32(monkeypatch)
    crop = _crop(video)
    dm, flow, sod = _port(weights, ema=1)
    jdm, jflow, jfp = _jax(weights, ema=1)
    cfg = StereoConfig(format=StereoFormat(half_sbs=True))
    jcfg = JConfig(format=JFormat(half_sbs=True))
    spy = jest = None
    if not debug_depth:
        spy = Spy(ce.ConvergenceEstimator(0.5, sod, enable_ema=True))
        jest = j_ce.ConvergenceEstimator(0.5, sod_model=_jitted(JSODV1()),
                                         sod_params=h.jparams(weights["sod"]),
                                         enable_ema=True)
    proc = Iw3FrameProcessor(cfg, dm, flow, edge_dilation=2, crop=crop,
                             scene_boundaries=[BOUNDARY], debug_depth=debug_depth,
                             convergence_estimator=spy)
    jproc = JProcessor(jcfg, jdm, jflow, jfp, edge_dilation=2, crop=crop,
                       scene_boundaries=[BOUNDARY], debug_depth=debug_depth,
                       convergence_estimator=jest)
    got, want = _batches(proc, video), _batches(jproc, video)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 64, 96, 3)
        assert h.psnr(h.u8(g), h.u8(w)) >= 50.0
    if debug_depth:
        g = np.concatenate(got)
        assert (g[..., 0] == g[..., 2]).all() and g.std() > 0.05
    else:
        conv = torch.cat(spy.out).numpy()
        assert conv.shape == (6,) and conv.std() > 1e-3
        assert spy.flags == [i + 1 == BOUNDARY for i in range(6)]
        assert spy.est.convergence_ema == pytest.approx(jest.convergence_ema, abs=1e-5)


def test_estimator_on_lagged_path_diverges_from_jax(weights, video, monkeypatch):
    """A reference fault the port does not copy: on the lagged path (EMA
    lookahead of 3 frames) the JAX processor drops the convergence
    estimator.  The port runs it on the frames it emits, with their own
    reset flags (the cut at frame 3 resets the EMA after frame 2).

    - Without the estimator the port equals JAX with it (>= 50 dB): JAX
      drops it and the rest of the path agrees.
    - With it (divergence 5, so that a convergence moves pixels) the
      port's frames move (below the 50 dB parity bar against JAX), and the
      estimator saw every frame once, in order, with the flags of those
      frames."""
    h.patch_fp32(monkeypatch)
    cfg = StereoConfig(divergence=5.0, format=StereoFormat(half_sbs=True))
    jdm, jflow, jfp = _jax(weights, ema=3, aa=False)
    jest = j_ce.ConvergenceEstimator(0.5, sod_model=_jitted(JSODV1()),
                                     sod_params=h.jparams(weights["sod"]),
                                     enable_ema=True)
    jproc = JProcessor(JConfig(divergence=5.0, format=JFormat(half_sbs=True)),
                       jdm, jflow, jfp,
                       edge_dilation=2, scene_boundaries=[BOUNDARY],
                       convergence_estimator=jest)
    want = np.concatenate(_batches(jproc, video, flush=True))
    assert jest.convergence_ema is None  # never called
    dm, flow, sod = _port(weights, ema=3, aa=False)
    plain = np.concatenate(_batches(Iw3FrameProcessor(
        cfg, dm, flow, edge_dilation=2, scene_boundaries=[BOUNDARY]), video, flush=True))
    assert plain.shape == want.shape == (6, 80, 96, 3)
    assert h.psnr(h.u8(plain), h.u8(want)) >= 50.0
    dm, flow, sod = _port(weights, ema=3, aa=False)
    spy = Spy(ce.ConvergenceEstimator(0.5, sod, enable_ema=True))
    got = np.concatenate(_batches(Iw3FrameProcessor(
        cfg, dm, flow, edge_dilation=2, scene_boundaries=[BOUNDARY],
        convergence_estimator=spy), video, flush=True))
    assert spy.flags == [i + 1 == BOUNDARY for i in range(6)]
    assert got.shape == want.shape
    conv = torch.cat(spy.out).numpy()
    assert np.abs(conv - 0.5).max() > 0.05
    assert h.psnr(h.u8(got), h.u8(want)) < 50.0  # measured 47.0 dB


def _aa_net(weights):
    net = DepthAA().eval()
    from_flax(net, weights["aa"])
    return net


def test_depth_aa_on_depth_anything_matches_jax(weights, video, monkeypatch):
    """``set_depth_aa`` on Any_V2_S: the filter after TTA, before the edge
    dilation, in both packages: depth to 1e-4, and moved by the net."""
    h.patch_fp32(monkeypatch)
    x = video[:2, BARS:-BARS].astype(np.float32) / 255
    dm, jdm = h.depth_models(weights["depth"])
    plain = dm.infer(h.t(x), tta=True, edge_dilation=2).numpy()
    dm.set_depth_aa(_aa_net(weights))
    jdm.set_depth_aa(_jitted(JDepthAA(), clamp=False), h.jparams(weights["aa"]))
    got = dm.infer(h.t(x), tta=True, edge_dilation=2).numpy()
    want = np.asarray(jdm.infer(jnp.asarray(x), tta=True, edge_dilation=2))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(got - plain).max() > 1e-2


def test_depth_aa_on_da3_and_vda_diverges_from_jax(weights, monkeypatch):
    """A reference fault the port does not copy: the JAX DA3 and VDA
    wrappers read ``depth_aa_model``, which nothing sets, so ``--depth-aa``
    (``set_depth_aa``) does nothing there.  The port's wrappers filter
    with the net ``set_depth_aa`` set: their depth is ``depth_aa_infer`` of
    the unfiltered depth (1e-5), while JAX's with the net set equals the
    port's without it (1e-4)."""
    mp = pytest.MonkeyPatch()
    h.add_depth_tables(mp)
    h.add_vitt(mp, jdino, tdino, jvda, tvda)
    try:
        monkeypatch.setattr(j3, "jnp", h.jnp_fp32())
        h.patch_fp32(monkeypatch, jvda)
        net = _aa_net(weights)
        jaa = (_jitted(JDepthAA(), clamp=False), h.jparams(weights["aa"]))
        x = np.random.default_rng(12).random((2, 70, 98, 3)).astype(np.float32)
        # DA3 mono on the tests-only vitt64 trunk
        da3, flat, _jp = h.seeded(t3.DepthAnythingV3Mono("vitt64"),
                                  SEEDED_FILLS["Any_V3_Mono"])
        dm = create_depth_model("Any_V3_Mono", device="cpu", dtype=torch.float32)
        dm.encoder, dm.model, dm.prep_lower_bound = "vitt64", da3, 70
        jdm = j3.DepthAnythingV3MonoModel("Any_V3_Mono")
        jdm.encoder, jdm.prep_lower_bound = "vitt64", 70
        jdm.model, jdm.params = j3.DepthAnythingV3Mono(encoder="vitt64"), h.jparams(flat)
        # windowed VDA on vitt
        vnet = tvda.VideoDepthAnything(encoder="vitt", num_frames=2)
        vflat = tvda.shaped_flax_params(vnet, 0)
        from_flax(vnet, vflat)
        vdm = tvda.VideoDepthAnythingModel("VDA_S", window_size=2, device="cpu",
                                           dtype=torch.float32)
        vdm.model, vdm.prep_lower_bound = vnet.eval(), 70
        jvdm = jvda.VideoDepthAnythingModel("VDA_S", window_size=2)
        jvdm.model = jvda.VideoDepthAnything(encoder="vitt", num_frames=2)
        jvdm.params, jvdm.prep_lower_bound = h.jparams(vflat), 70
        for port, jax_model in ((dm, jdm), (vdm, jvdm)):
            plain = port.infer(h.t(x)).numpy()
            port.set_depth_aa(net)
            jax_model.set_depth_aa(*jaa)
            got = port.infer(h.t(x)).numpy()
            want = np.asarray(jax_model.infer(jnp.asarray(x)))
            np.testing.assert_allclose(want, plain, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(
                got, depth_aa_infer(net, torch.from_numpy(plain)).numpy(),
                rtol=0, atol=1e-5)
            assert np.abs(got - want).max() > 1e-2
    finally:
        mp.undo()
