"""Video Depth Anything in nunif_tpu_torch against the JAX package, on the
CPU: the network in window and streaming mode (cache carry, ring
overflow), ``align_scale_shift``, the windowed wrapper's lag, flush and
``reset_pts``, the streaming wrapper's batched stages, the metric
variant's postprocess, and the factory names.

Both packages get the same weights, drawn with numpy in flax layout
(``vda.shaped_flax_params``: the motion modules' output projections are
not zero, so the temporal path acts).  The encoder is the tests-only
``vitt`` (2 blocks, 64 wide) with a narrow DPT head, added to both
packages' tables for the test; frames are 70x98 (a 5x7 patch grid: at
smaller grids the GroupNorm of the 1x2 level-3 map divides by a
near-zero variance and amplifies fp32 rounding).  Windows of 3-4 frames.
fp32 to 1e-4 (the JAX wrappers' bf16 casts resolved to fp32); bf16: the
port's RMS error against JAX's fp32 output within 1.1x JAX's own bf16
error, as tests/test_torch_depth.py holds Depth-Anything.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.iw3.depth import dinov2 as jdino
from nunif_tpu.iw3.depth import vda as jvda

from nunif_tpu_torch.iw3.depth import create_depth_model
from nunif_tpu_torch.iw3.depth import dinov2 as tdino
from nunif_tpu_torch.iw3.depth import vda as tvda
from nunif_tpu_torch.models import from_flax, load_model, save_model

import torch_iw3_helpers as h

pytestmark = pytest.mark.usefixtures("two_threads")
two_threads = h.two_threads

HW = (70, 98)


@pytest.fixture(scope="module")
def vitt():
    """Both packages' tables with the tests-only encoder."""
    mp = pytest.MonkeyPatch()
    h.add_vitt(mp, jdino, tdino, jvda, tvda)
    yield
    mp.undo()


def _pair(num_frames, max_depth=0.0, seed=0):
    """(port net, JAX net, JAX params, flax-layout weights)."""
    net = tvda.VideoDepthAnything(encoder="vitt", max_depth=max_depth,
                                  num_frames=num_frames)
    flat = tvda.shaped_flax_params(net, seed)
    from_flax(net, flat)
    jnet = jvda.VideoDepthAnything(encoder="vitt", max_depth=max_depth,
                                   num_frames=num_frames)
    return net.eval().requires_grad_(False), jnet, h.jparams(flat), flat


@pytest.fixture(scope="module")
def nets(vitt):
    return _pair(4)


def _jfwd(jnet):
    return jax.jit(lambda p, v: jnet.apply({"params": p}, v).astype(jnp.float32))


def _frames(seed, n, hw=HW):
    return np.random.default_rng(seed).standard_normal((1, n) + hw + (3,)).astype(np.float32)


def test_param_trees_match_jax(nets):
    """The port's tree is JAX's, at vitt and at the published vits; the
    shaped weights give the motion modules' output projections non-zero
    kernels, flax's init zero ones."""
    _net, jnet, _jp, flat = nets
    assert {k: v.shape for k, v in flat.items()} == h.jax_flat_shapes(jnet, (1, 2) + HW + (3,))
    assert np.abs(flat["head/motion_modules_3/proj_out/kernel"]).max() > 0
    vits = tvda.VideoDepthAnything(encoder="vits")
    want = h.jax_flat_shapes(jvda.VideoDepthAnything(encoder="vits"), (1, 2, 28, 28, 3))
    from nunif_tpu_torch.models import to_flax
    assert {k: v.shape for k, v in to_flax(vits).items()} == want
    dm = create_depth_model("VDA_S", device="cpu", dtype=torch.float32).load()
    assert float(dm.model.head.motion_modules_0.proj_out.weight.abs().max()) == 0.0


def test_window_forward_matches_jax(nets):
    """A window of 3 frames; frame 0 run alone differs (temporal mixing)."""
    net, jnet, jp, _ = nets
    x = _frames(1, 3)
    with torch.no_grad():
        got = net(h.t(x)).numpy()
        alone = net(h.t(x[:, :1])).numpy()
    want = np.asarray(_jfwd(jnet)(jp, jnp.asarray(x)))
    assert got.shape == (1, 3) + HW + (1,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(alone[:, 0] - got[:, 0]).max() > 1e-2


def _rms(a, b):
    return float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2)))


def test_window_forward_bf16_within_jax_bf16_error(nets):
    """bf16 (cast at the input, as the wrappers do): the two packages round
    at the same points but in another order inside an op, so the bound is
    as tests/test_torch_depth.py's: the port's RMS error against JAX's
    fp32 output within 1.1x JAX's own bf16 RMS error."""
    net, jnet, jp, _ = nets
    x = _frames(2, 3)
    fwd = _jfwd(jnet)
    want = np.asarray(fwd(jp, jnp.asarray(x)))
    j16 = np.asarray(fwd(jp, jnp.asarray(x, jnp.bfloat16)))
    with torch.no_grad():
        got = net(h.t(x).bfloat16()).float().numpy()
    assert _rms(got, want) <= 1.1 * _rms(j16, want), (_rms(got, want), _rms(j16, want))


def test_streaming_steps_match_jax_through_ring_overflow(nets):
    """Six one-frame steps with a window of 4: the first equals the window
    at T = 1, each carries the caches (outputs and ring buffers against
    JAX's), and past 4 frames the rings shift."""
    net, jnet, jp, _ = nets
    x = _frames(3, 6)
    jc = jnet.init_caches(1, *HW, dtype=jnp.float32)
    tc = net.init_caches(1, *HW, dtype=torch.float32)
    step = jax.jit(lambda p, v, c: jnet.apply({"params": p}, v, caches=c))
    with torch.no_grad():
        first = net(h.t(x[:, :1])).numpy()
        for i in range(6):
            xi = x[:, i:i + 1]
            want, jc = step(jp, jnp.asarray(xi), jc)
            got, tc = net(h.t(xi), caches=tc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
            if i == 0:
                np.testing.assert_array_equal(got.numpy(), first)
            for m in range(4):
                assert tc[m]["n"] == int(jc[m]["n"]) == min(i + 1, 4)
                for ring in ("ring1", "ring2"):
                    np.testing.assert_allclose(tc[m][ring].numpy(),
                                               np.asarray(jc[m][ring]),
                                               rtol=1e-4, atol=1e-4)
        fresh, _ = net(h.t(x[:, 5:6]), caches=net.init_caches(1, *HW, dtype=torch.float32))
    assert np.abs(fresh.numpy() - got.numpy()).max() > 1e-3  # the context acts


def test_align_scale_shift_matches_jax():
    rng = np.random.default_rng(4)
    ref = rng.uniform(1, 2, (2, 8, 8, 1)).astype(np.float32)
    new = ((ref - 0.25) / 2.0 + rng.normal(0, 0.01, ref.shape)).astype(np.float32)
    s, t = tvda.align_scale_shift(h.t(new), h.t(ref))
    js, jt = jvda.align_scale_shift(jnp.asarray(new), jnp.asarray(ref))
    np.testing.assert_allclose([float(s), float(t)], [float(js), float(jt)], rtol=1e-5)
    assert abs(float(s) - 2.0) < 0.05
    # degenerate inputs: a flat new frame keeps s = 1
    s, t = tvda.align_scale_shift(torch.ones(4), h.t(ref[0, 0, :4, 0]))
    assert float(s) == 1.0


@pytest.fixture
def jax_fp32(monkeypatch):
    """The JAX wrappers in fp32: their hard-coded bf16 casts (the window's
    input, the streaming caches) resolved to fp32."""
    h.patch_fp32(monkeypatch, jvda)
    init = jvda.VideoDepthAnything.init_caches
    monkeypatch.setattr(jvda.VideoDepthAnything, "init_caches",
                        lambda self, B, H, W, dtype=None: init(self, B, H, W,
                                                               jnp.float32))


def _wrappers(cls_t, cls_j, name, net, jnet, jp, **kw):
    """The port's and JAX's wrappers of ``name`` around the vitt nets, at a
    preprocess lower bound of 70, in fp32."""
    port = cls_t(name, device="cpu", dtype=torch.float32, **kw)
    port.model, port.prep_lower_bound = net, 70
    jax_model = cls_j(name, **kw)
    jax_model.model, jax_model.params, jax_model.prep_lower_bound = jnet, jp, 70
    return port, jax_model


def _video(seed, n):
    """n frames of 80x110 in [0, 1] with structure (a moving block)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:80, 0:110] / 80.0
    f = []
    for i in range(n):
        a = 0.5 + 0.3 * np.stack([np.sin(3 * xx + 0.3 * i), np.cos(2 * yy),
                                  xx * yy], -1)
        a[20:50, 10 + 5 * i:40 + 5 * i] = 0.9
        f.append(a + 0.05 * rng.standard_normal(a.shape))
    return np.clip(np.stack(f), 0, 1).astype(np.float32)


@pytest.mark.parametrize("reset_at", [None, 2])
def test_windowed_lag_flush_and_reset_pts_match_jax(nets, reset_at, jax_fp32):
    """Window 4, overlap 2, 7 frames one at a time: the normalised depth
    frames come out when JAX's do (never ahead of the input), equal to
    them; the flush pads the last window; a cut after frame 2 flushes
    everything so far and starts afresh."""
    net, jnet, jp, _ = nets
    port, jm = _wrappers(tvda.VideoDepthAnythingModel, jvda.VideoDepthAnythingModel,
                         "VDA_S", net, jnet, jp, window_size=4, overlap=2)
    x = _video(5, 7)
    reset = () if reset_at is None else {reset_at}
    got, want = [], []
    for i in range(7):
        g = port.infer_with_normalize(h.t(x[i:i + 1]), pts=[i], reset_pts=reset,
                                      edge_dilation=2)
        w = jm.infer_with_normalize(jnp.asarray(x[i:i + 1]), pts=[i], reset_pts=reset,
                                    edge_dilation=2)
        assert len(g) == len(w)
        got += g
        want += w
        assert len(got) <= i + 1
        if i == reset_at:
            assert len(got) == i + 1
    got += port.flush_with_normalize(edge_dilation=2)
    want += jm.flush_with_normalize(edge_dilation=2)
    assert len(got) == len(want) == 7
    np.testing.assert_allclose(torch.stack(got).numpy(),
                               np.stack([np.asarray(w) for w in want]),
                               rtol=1e-4, atol=1e-4)
    assert float(torch.stack(got).std()) > 0.05


def test_windowed_infer_whole_clip_matches_jax(nets, jax_fp32):
    net, jnet, jp, _ = nets
    port, jm = _wrappers(tvda.VideoDepthAnythingModel, jvda.VideoDepthAnythingModel,
                         "VDA_S", net, jnet, jp, window_size=4)
    x = _video(6, 3)
    np.testing.assert_allclose(port.infer(h.t(x)).numpy(),
                               np.asarray(jm.infer(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)


def test_streaming_wrapper_batches_match_jax(nets, jax_fp32):
    """Batches of 3 and 2 frames through the streaming wrapper (the
    encoder and head stages batched, the motions frame by frame) against
    JAX's scanned program: no lag, the caches carried across batches."""
    net, jnet, jp, _ = nets
    port, jm = _wrappers(tvda.VideoDepthAnythingStreamingModel,
                         jvda.VideoDepthAnythingStreamingModel, "VDA_Stream_S",
                         net, jnet, jp, window_size=4)
    assert port.stateful_inference
    x = _video(7, 5)
    for a, b in ((0, 3), (3, 5)):
        got = port.infer(h.t(x[a:b]), edge_dilation=2)
        want = jm.infer(jnp.asarray(x[a:b]), edge_dilation=2)
        assert got.shape[0] == b - a
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert port._caches[0]["n"] == 4
    port.reset()
    assert port._caches is None


def test_metric_variant_postprocess_matches_jax(vitt, jax_fp32):
    """VDA_Stream_Metric_S: the sigmoid head at max depth 20, the input
    reflection-padded by 14 a side and cropped after, forced to disparity
    1 / (d + 0.1)."""
    net, jnet, jp, _ = _pair(4, max_depth=20.0, seed=1)
    port, jm = _wrappers(tvda.VideoDepthAnythingStreamingModel,
                         jvda.VideoDepthAnythingStreamingModel,
                         "VDA_Stream_Metric_S", net, jnet, jp, window_size=4)
    port.prep_lower_bound = jm.prep_lower_bound = 70 + 28
    assert port.is_metric() is False and port.metric_depth
    x = _video(8, 2)
    got = port.infer(h.t(x))
    want = jm.infer(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert float(got.min()) > 0
    raw = h.t(np.random.default_rng(9).uniform(0, 20, (1, 40, 50, 1)).astype(np.float32))
    for kw in (dict(force_disparity=True), dict(force_disparity=False)):
        np.testing.assert_allclose(
            tvda.vda_postprocess(raw, 2, True, **kw).numpy(),
            np.asarray(jvda.vda_postprocess(jnp.asarray(raw.numpy()), 2, True, **kw)),
            rtol=1e-5, atol=1e-5)


def test_factory_names_and_checkpoint(tmp_path):
    """The VDA names build the windowed, streaming and metric wrappers;
    a seeded VDA_S written to .nztm loads back through load(checkpoint=)."""
    for name, cls in (("VDA_S", tvda.VideoDepthAnythingModel),
                      ("VDA_Stream_S", tvda.VideoDepthAnythingStreamingModel),
                      ("VDA_Metric_S", tvda.VideoDepthAnythingModel),
                      ("VDA_Stream_Metric_L", tvda.VideoDepthAnythingStreamingModel)):
        dm = create_depth_model(name, device="cpu")
        assert type(dm) is cls and dm.metric_depth == ("Metric" in name)
        assert not dm.is_image_supported()
    net = tvda.VideoDepthAnything(encoder="vits")
    from_flax(net, tvda.shaped_flax_params(net, 2))
    save_model(net, str(tmp_path / "vda.nztm"))
    dm = create_depth_model("VDA_Stream_S", device="cpu").load(
        checkpoint=str(tmp_path / "vda.nztm"))
    w = dm.model.head.motion_modules_3.proj_out.weight
    assert torch.equal(w, net.head.motion_modules_3.proj_out.weight)
    loaded, _meta = load_model(str(tmp_path / "vda.nztm"), device="cpu")
    assert loaded.num_frames == 32 and loaded.encoder == "vits"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_depth_model("ZoeD_N", device="cpu")
