"""The lagged iw3 frame path of nunif_tpu_torch against the JAX package's
``Iw3FrameProcessor``, on the CPU: the EMA lookahead buffer and its flush,
scene cuts, windowed and streaming Video Depth Anything, and
``mlbw_l2_inpaint_video``'s clip queue carried through the processor.

uint8 frames with their index burnt into the top rows
(``torch_iw3_helpers.indexed_frames``) go through both processors in
batches; the tests count the frames each call returns, read the indexes
back from the half-SBS output, and compare the frames (fp32, both
packages' bf16 casts resolved to fp32: uint8 PSNR >= 50 dB, as the other
frame-path tests).  Depth: Any_V2_S at full width (``shaped_flax_params``)
at a 56 px input; VDA with the tests-only ``vitt`` encoder
(tests/test_torch_vda.py) at a 70 px input.

Two behaviours diverge from the JAX processor on purpose:
- a side model that queues frames (``MLBWInpaintVideo``): the JAX
  processor composes its ``(None, None)`` and raises ``AttributeError``,
  and its ``flush`` never drains the side model, so those frames are lost
  (ROADMAP queue 3); the port carries them;
- scene cuts reset the depth model's temporal state (the window, the
  streaming caches) as well as the EMA; the JAX processor resets only the
  EMA.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nunif_tpu.iw3.mlbw_inpaint as j_mlbw_inpaint
from nunif_tpu.iw3.composition import StereoFormat as JFormat
from nunif_tpu.iw3.depth import dinov2 as jdino
from nunif_tpu.iw3.depth import vda as jvda
from nunif_tpu.iw3.models import light_video_inpaint_v1 as jlv
from nunif_tpu.iw3.models.mlbw import MLBW as JMLBW
from nunif_tpu.iw3.pipeline import StereoConfig as JConfig
from nunif_tpu.iw3.video import Iw3FrameProcessor as JProcessor

from nunif_tpu_torch.iw3.composition import StereoFormat
from nunif_tpu_torch.iw3.depth import dinov2 as tdino
from nunif_tpu_torch.iw3.depth import vda as tvda
from nunif_tpu_torch.iw3.depth.depth_anything import (
    DepthAnything, shaped_flax_params as depth_params)
from nunif_tpu_torch.iw3.mlbw_inpaint import MLBWInpaintVideo, make_mask_mlbw
from nunif_tpu_torch.iw3.models import light_video_inpaint_v1 as tlv
from nunif_tpu_torch.iw3.models import mlbw as tmlbw
from nunif_tpu_torch.iw3.pipeline import StereoConfig, process_image
from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
from nunif_tpu_torch.models import from_flax

import torch_iw3_helpers as h

pytestmark = pytest.mark.usefixtures("two_threads")
two_threads = h.two_threads

HALF_SBS = dict(half_sbs=True)


@pytest.fixture(scope="module")
def depth_weights():
    return depth_params(DepthAnything("vits"), 0)


@pytest.fixture(scope="module")
def video():
    return h.indexed_frames(12)


@pytest.fixture
def fp32(monkeypatch):
    h.patch_fp32(monkeypatch, jvda)
    init = jvda.VideoDepthAnything.init_caches
    monkeypatch.setattr(jvda.VideoDepthAnything, "init_caches",
                        lambda self, B, H, W, dtype=None: init(self, B, H, W,
                                                               jnp.float32))
    h.add_vitt(monkeypatch, jdino, tdino, jvda, tvda)


def _run(proc, video, sizes):
    """Feed the frames in batches of ``sizes``, then flush: (each call's
    frame count, the frames as numpy)."""
    counts, outs, a = [], [], 0
    for n in sizes:
        y = proc(video[a:a + n])
        a += n
        counts.append(0 if y is None else int(y.shape[0]))
        if y is not None:
            outs.append(np.asarray(y))
    y = proc.flush()
    counts.append(0 if y is None else int(y.shape[0]))
    if y is not None:
        outs.append(np.asarray(y))
    return counts, np.concatenate(outs)


def _check_same(got, want, n):
    assert got[0] == want[0], (got[0], want[0])
    assert sum(got[0]) == n
    assert h.read_indexes(got[1]) == list(range(n))
    assert h.psnr(h.u8(got[1]), h.u8(want[1])) >= 50.0, h.psnr(h.u8(got[1]), h.u8(want[1]))


@pytest.mark.parametrize("boundaries", [None, [5]])
def test_ema_lookahead_lag_and_flush_match_jax(depth_weights, video, fp32, boundaries):
    """Any_V2_S with an EMA of decay 0.9 and a lookahead of 4 frames:
    batches of 3 come out 4 frames late, equal to JAX's; the flush returns
    the rest.  A cut at frame 5 flushes the buffer there and restarts the
    EMA, as in JAX."""
    dm, jdm = h.depth_models(depth_weights)
    for m in (dm, jdm):
        m.enable_ema(0.9, buffer_size=4)
    assert dm.get_ema_state() == (0.9, 4)
    cfg = StereoConfig(method="grid_sample", format=StereoFormat(**HALF_SBS))
    jcfg = JConfig(method="grid_sample", format=JFormat(**HALF_SBS))
    got = _run(Iw3FrameProcessor(cfg, dm, edge_dilation=2,
                                 scene_boundaries=boundaries), video, [3, 3, 3, 3])
    want = _run(JProcessor(jcfg, jdm, edge_dilation=2,
                           scene_boundaries=boundaries), video, [3, 3, 3, 3])
    assert got[0] == ([0, 3, 3, 3, 3] if boundaries is None else [0, 5, 1, 3, 3])
    _check_same(got, want, 12)


def _vda(name, net, jnet, jp, **kw):
    port = (tvda.VideoDepthAnythingModel if "Stream" not in name
            else tvda.VideoDepthAnythingStreamingModel)(
        name, device="cpu", dtype=torch.float32, **kw)
    port.model, port.prep_lower_bound = net, 70
    jm = (jvda.VideoDepthAnythingModel if "Stream" not in name
          else jvda.VideoDepthAnythingStreamingModel)(name, **kw)
    jm.model, jm.params, jm.prep_lower_bound = jnet, jp, 70
    return port, jm


def _vda_nets():
    net = tvda.VideoDepthAnything(encoder="vitt", num_frames=4)
    flat = tvda.shaped_flax_params(net, 0)
    from_flax(net, flat)
    return (net.eval().requires_grad_(False),
            jvda.VideoDepthAnything(encoder="vitt", num_frames=4), h.jparams(flat))


@pytest.mark.parametrize("name,kw,counts", [
    ("VDA_S", dict(window_size=4, overlap=2), [0, 4, 2, 2, 2, 1]),
    ("VDA_Stream_S", dict(window_size=4), [2, 2, 2, 2, 3, 0])])
def test_vda_through_processor_matches_jax(video, fp32, name, kw, counts):
    """Windowed VDA (window 4, overlap 2: the first window takes 4 frames,
    each next 2 new ones beside 2 of context, the flush pads the last
    frame's window) and streaming VDA (no lag) through both processors, 11
    frames in batches of 2, 2, 2, 2, 3."""
    port, jm = _vda(name, *_vda_nets(), **kw)
    cfg = StereoConfig(method="grid_sample", format=StereoFormat(**HALF_SBS))
    jcfg = JConfig(method="grid_sample", format=JFormat(**HALF_SBS))
    sizes = [2, 2, 2, 2, 3]
    got = _run(Iw3FrameProcessor(cfg, port, edge_dilation=2), video[:11], sizes)
    want = _run(JProcessor(jcfg, jm, edge_dilation=2), video[:11], sizes)
    assert got[0] == counts
    _check_same(got, want, 11)


@pytest.mark.parametrize("name,kw", [("VDA_S", dict(window_size=4, overlap=2)),
                                     ("VDA_Stream_S", dict(window_size=4))])
def test_scene_cut_resets_vda_state(video, fp32, name, kw):
    """A cut at frame 5 (batches of 3): the frames from 5 on equal a fresh
    model's on those frames alone, the ones before it the frames of a run
    that ends at 5; the JAX processor would carry the window or the caches
    across the cut."""
    nets = _vda_nets()
    cfg = StereoConfig(method="grid_sample", format=StereoFormat(**HALF_SBS))

    def proc(**pkw):
        port, _jm = _vda(name, *nets, **kw)
        return Iw3FrameProcessor(cfg, port, edge_dilation=2, **pkw)
    counts, cut = _run(proc(scene_boundaries=[5]), video, [3, 3, 3, 3])
    assert sum(counts) == 12 and h.read_indexes(cut) == list(range(12))
    _, head = _run(proc(), video[:5], [3, 2])
    _, tail = _run(proc(), video[5:], [1, 3, 3])
    np.testing.assert_allclose(cut, np.concatenate([head, tail]), rtol=0, atol=1e-5)
    _, through = _run(proc(), video, [3, 3, 3, 3])
    assert np.abs(through[5:] - tail).max() > 1e-3  # without the cut, state carries


@pytest.fixture(scope="module")
def inpaint_video():
    net = tlv.LightVideoInpaintV1()
    from_flax(net, tlv.shaped_flax_params(net, 4))
    mask = make_mask_mlbw()
    mparams = tmlbw.shaped_flax_params(mask, 2)
    from_flax(mask, mparams)
    return net.eval(), mask.eval(), mparams


@pytest.mark.parametrize("ema", [False, True])
def test_mlbw_l2_inpaint_video_carried_through_processor(depth_weights, video,
                                                         inpaint_video, fp32, ema):
    """Batches of 5 through mlbw_l2_inpaint_video: nothing until 12 frames
    are queued, then the clip; the flush returns the other 3 (with the EMA
    lookahead: the depth model's 3 held frames go through the side model
    first, then the side model's queue drains).  Every frame once, in
    order, each equal to its frame through the side model fed the same
    clips directly."""
    dm, _jdm = h.depth_models(depth_weights)
    if ema:
        dm.enable_ema(0.9, buffer_size=3)
    net, mask, _ = inpaint_video
    cfg = StereoConfig(method="mlbw_l2_inpaint_video",
                       format=StereoFormat(**HALF_SBS))
    proc = Iw3FrameProcessor(cfg, dm, MLBWInpaintVideo(net, mask), edge_dilation=2)
    counts, out = _run(proc, h.indexed_frames(15), [5, 5, 5])
    assert counts == [0, 0, 12, 3]
    assert h.read_indexes(out) == list(range(15))
    assert proc.flush() is None and proc.side_model._queue == []


def test_queuing_side_model_diverges_from_jax(depth_weights, video, inpaint_video):
    """The JAX processor loses a queuing side model's frames: its first
    batch raises AttributeError (it composes (None, None)) with the frames
    left in the clip queue, and its flush drains only the depth model.
    The port returns every frame, and so does ``process_image``."""
    dm, jdm = h.depth_models(depth_weights)
    net, mask, mparams = inpaint_video
    jside = j_mlbw_inpaint.MLBWInpaintVideo(
        inpaint_model=jlv.LightVideoInpaintV1(),
        inpaint_params=h.jparams(tlv.shaped_flax_params(net, 4)),
        mask_model=JMLBW(num_layers=2, hole_mask=True), mask_params=h.jparams(mparams))
    jproc = JProcessor(JConfig(method="mlbw_l2_inpaint_video",
                               format=JFormat(**HALF_SBS)), jdm, jside, edge_dilation=2)
    with pytest.raises(AttributeError):
        jproc(video[:4])
    assert len(jside._queue) == 4
    assert jproc.flush() is None
    proc = Iw3FrameProcessor(StereoConfig(method="mlbw_l2_inpaint_video",
                                          format=StereoFormat(**HALF_SBS)),
                             dm, MLBWInpaintVideo(net, mask), edge_dilation=2)
    assert proc(video[:4]) is None
    out = proc.flush()
    assert out.shape[0] == 4 and h.read_indexes(out) == [0, 1, 2, 3]
    # process_image (images, the CLI) drains the clip queue the same way
    still = process_image(h.t(video[:4]).float() / 255, proc.cfg, dm,
                          proc.side_model, edge_dilation=2)
    assert h.psnr(h.u8(still.numpy()), h.u8(out.numpy())) >= 50.0
