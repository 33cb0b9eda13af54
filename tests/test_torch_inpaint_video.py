"""``mlbw_l2_inpaint_video``'s parts in nunif_tpu_torch against the JAX
package, on the CPU: the 3-D window partition, ``WindowGMLP3d``,
``inpaint.light_video_inpaint_v1`` and ``video_inpaint_infer``, and
``MLBWInpaintVideo``'s clip queue and flush (the frame path through
``Iw3FrameProcessor``: tests/test_torch_iw3_temporal.py).

Inputs and weights are drawn with numpy and given to both packages
(``shaped_flax_params``: the temporal gMLPs' frame-mixing kernels drawn
like dense kernels, so a frame's output depends on the other frames').
fp32 to 1e-4.  ``MLBWInpaintVideo`` is held to the JAX class with the hole
mask in the port's order, as tests/test_torch_inpaint.py does for
``MLBWInpaint`` (the JAX ``postprocess_hole_mask`` masks every pixel).
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

import nunif_tpu.iw3.mlbw_inpaint as j_mlbw_inpaint
from nunif_tpu.iw3.models import light_video_inpaint_v1 as jlv
from nunif_tpu.iw3.models.mlbw import MLBW as JMLBW
from nunif_tpu.modules import permute as jpermute
from nunif_tpu.modules.attention import WindowGMLP3d as JWindowGMLP3d
from nunif_tpu.modules.norm import LayerNormNoBias as JLayerNormNoBias

from nunif_tpu_torch.iw3.mlbw_inpaint import MLBWInpaintVideo, make_mask_mlbw
from nunif_tpu_torch.iw3.models import light_video_inpaint_v1 as tlv
from nunif_tpu_torch.iw3.models import mlbw as tmlbw
from nunif_tpu_torch.models import create_model, from_flax, model_kwargs, to_flax
from nunif_tpu_torch.modules import permute as tpermute
from nunif_tpu_torch.modules.attention import WindowGMLP3d
from nunif_tpu_torch.modules.norm import LayerNormNoBias

import torch_iw3_helpers as h
from torch_iw3_helpers import j_hole_mask_port_order

pytestmark = pytest.mark.usefixtures("two_threads")
two_threads = h.two_threads

SEQ = tlv.SEQ_LEN


@pytest.fixture(scope="module")
def video_net():
    """(port LightVideoInpaintV1, JAX LightVideoInpaintV1, JAX params),
    shaped, at the published base width 96."""
    net = tlv.LightVideoInpaintV1()
    params = tlv.shaped_flax_params(net, 4)
    from_flax(net, params)
    return net.eval(), jlv.LightVideoInpaintV1(), h.jparams(params)


@pytest.fixture(scope="module")
def mask_net():
    net = make_mask_mlbw()
    params = tmlbw.shaped_flax_params(net, 2)
    from_flax(net, params)
    return net.eval(), JMLBW(num_layers=2, hole_mask=True), h.jparams(params)


def _clip(seed, n, hw=(40, 72)):
    """n frames and a mask of a few blobs, (n, H, W, 1) in {0, 1}."""
    rng = np.random.default_rng(seed)
    x = rng.random((n,) + hw + (3,), dtype=np.float32)
    m = np.zeros((n,) + hw + (1,), np.float32)
    for i in range(n):
        for _ in range(3):
            y0, x0 = rng.integers(0, hw[0]), rng.integers(0, hw[1])
            m[i, y0:y0 + 9, x0:x0 + 6] = 1.0
    return x, m


@pytest.mark.parametrize("window", [(2, 3, 4), (12, 1, 1)])
def test_window_partition3_matches_jax(window):
    x = np.random.default_rng(60).random((2, 12, 6, 8, 5), dtype=np.float32)
    got = tpermute.window_partition3(h.t(x), window)
    want = np.asarray(jpermute.window_partition3(jnp.asarray(x), window))
    np.testing.assert_array_equal(got.numpy(), want)
    back = tpermute.window_reverse3(got, window, 12, 6, 8)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("window,shift", [((4, 2, 2), False), ((4, 2, 2), True),
                                          ((12, 1, 1), False)])
def test_window_gmlp3d_matches_jax(window, shift):
    """Unshifted and shifted (the frame axis reflect-padded, H and W
    zero-padded by half a window), with the blocks' scale-only norms."""
    C = 8
    rng = np.random.default_rng(61)
    x = rng.standard_normal((1, 12, 6, 8, C)).astype(np.float32)
    norm1, norm2 = LayerNormNoBias(C), LayerNormNoBias(2 * C)
    mod = WindowGMLP3d(C, window, mlp_ratio=2, shift=shift)

    class JBlock(fnn.Module):
        @fnn.compact
        def __call__(self, t):
            return JWindowGMLP3d(C, window, mlp_ratio=2, shift=shift, name="gmlp")(
                t, JLayerNormNoBias(name="norm1"), JLayerNormNoBias(name="norm2"))

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gmlp, self.norm1, self.norm2 = mod, norm1, norm2

        def forward(self, t):
            return self.gmlp(t, self.norm1, self.norm2)

    block = Block()
    flat = {k: rng.normal(0, 0.5, v.shape).astype(np.float32)
            for k, v in to_flax(block).items()}
    assert {k: v.shape for k, v in flat.items()} == h.jax_flat_shapes(JBlock(), x.shape)
    from_flax(block, flat)
    with torch.no_grad():
        got = block(h.t(x)).numpy()
    want = np.asarray(JBlock().apply({"params": h.jparams(flat)}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_video_inpaint_param_trees_and_names_match_jax():
    for name, jcls in (("inpaint.light_video_inpaint_v1", jlv.LightVideoInpaintV1),
                       ("inpaint.light_video_inpaint_v1_medium",
                        jlv.LightVideoInpaintV1Medium),
                       ("inpaint.light_video_inpaint_v1_large",
                        jlv.LightVideoInpaintV1Large)):
        net, jnet = create_model(name), jcls()
        assert net.model_name == jnet.model_name == name
        assert model_kwargs(net) == {"base_dim": jnet.base_dim,
                                     "lv2_mlp_ratio": jnet.lv2_mlp_ratio}
        want = h.jax_flat_shapes(jnet, (SEQ, 64, 64, 3), mask=(SEQ, 64, 64, 1))
        assert {k: v.shape for k, v in to_flax(net).items()} == want
    small = create_model("inpaint.light_video_inpaint_v1_small")
    assert type(small) is tlv.LightVideoInpaintV1


def test_light_video_inpaint_matches_jax(video_net):
    """One clip of 12 frames at 40x72 (padded inside to 64x128); the
    composite keeps the source outside the mask, and changing frame 0
    changes frame 6's holes (the temporal blocks act)."""
    net, jnet, jp = video_net
    x, m = _clip(62, SEQ)
    with torch.no_grad():
        got = net(h.t(x), mask=h.t(m)).numpy()
    fwd = jax.jit(lambda p, v, mk: jnet.apply({"params": p}, v, mask=mk))
    want = np.asarray(fwd(jp, jnp.asarray(x), jnp.asarray(m)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    keep = np.broadcast_to(m == 0, x.shape)
    np.testing.assert_array_equal(got[keep], x[keep])
    assert np.abs(got - x)[~keep].mean() > 0.05
    x2 = x.copy()
    x2[0] = 1.0 - x2[0]
    with torch.no_grad():
        got2 = net(h.t(x2), mask=h.t(m)).numpy()
    hole6 = np.broadcast_to(m[6] > 0, x[6].shape)
    assert np.abs(got2[6] - got[6])[hole6].max() > 1e-3
    with pytest.raises(ValueError, match="12 frames"):
        net(h.t(x[:5]), mask=h.t(m[:5]))


@pytest.mark.parametrize("n", [5, 13])
def test_video_inpaint_infer_pads_clip_matches_jax(video_net, n):
    """A clip of 5 (or 13) frames, edge-padded to 12 (24) frames, half
    before and half after, with the mask preprocessing."""
    net, jnet, jp = video_net
    x, m = _clip(63 + n, n)
    got = tlv.video_inpaint_infer(net, h.t(x), h.t(m), closing=True,
                                  inner_dilation=1).numpy()
    want = np.asarray(jlv.video_inpaint_infer(jnet, jp, jnp.asarray(x),
                                              jnp.asarray(m), closing=True,
                                              inner_dilation=1))
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_mlbw_inpaint_video_queue_and_flush_match_jax(video_net, mask_net,
                                                      monkeypatch):
    """Batches of 5, 5 and 4 frames: (None, None) until 12 are queued, then
    the 12 (the clip queue keeps the other 3), then the flush returns those
    3 as one clip padded to 12; both eyes against the JAX class with the
    hole mask in the port's order; every frame once, in order."""
    monkeypatch.setattr(j_mlbw_inpaint, "postprocess_hole_mask",
                        j_hole_mask_port_order)
    net, jnet, jp = video_net
    mnet, jmnet, jmp = mask_net
    rng = np.random.default_rng(64)
    x = rng.random((14, 40, 72, 3), dtype=np.float32)
    depth = h.depth_map(rng, 14, 20, 36)
    port = MLBWInpaintVideo(net, mnet)
    jax_side = j_mlbw_inpaint.MLBWInpaintVideo(inpaint_model=jnet, inpaint_params=jp,
                                               mask_model=jmnet, mask_params=jmp)
    got, want = [], []
    for a, b in ((0, 5), (5, 10), (10, 14)):
        g = port.infer(h.t(x[a:b]), h.t(depth[a:b]), 2.0, 0.5)
        w = jax_side.infer(jnp.asarray(x[a:b]), jnp.asarray(depth[a:b]), 2.0, 0.5)
        assert (g[0] is None) == (w[0] is None) == (b < SEQ)
        if g[0] is not None:
            got.append(g)
            want.append(w)
    assert len(port._queue) == 2
    got.append(port.flush())
    want.append(jax_side.flush())
    assert port.flush() == (None, None)
    for eye in (0, 1):
        g = torch.cat([o[eye] for o in got]).numpy()
        w = np.concatenate([np.asarray(o[eye]) for o in want])
        assert g.shape == (14, 40, 72, 3)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    # the right eye of frame 3 is frame 3's own warp, not another frame's
    with torch.no_grad():
        warped, _logits = port._warp(h.t(x[3:4]), h.t(depth[3:4]), 2.0, 0.5,
                                     "both", False)[2:]
    right3 = got[0][1][3:4]
    assert float((right3 - warped).abs().mean()) < float((got[0][1][4:5] - warped).abs().mean())
