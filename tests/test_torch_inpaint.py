"""iw3's inpaint methods in nunif_tpu_torch against the JAX package, on the
CPU: ``inpaint.light_inpaint_v1`` and its preprocessing, the mask-MLBW's
hole mask, ``ForwardInpaint`` (``forward_inpaint``) and ``MLBWInpaint``
(``mlbw_l2_inpaint``); their whole frame path and the CLI:
tests/test_torch_inpaint_frames.py.

Inputs and weights are drawn with numpy and given to both packages
(``shaped_flax_params``).  One divergence is deliberate:
``postprocess_hole_mask`` in the JAX package closes the raw logits, whose
closing clips them to [0, 1], so every sigmoid is >= 0.5 and its mask is
all ones at the 0.15 threshold (``test_hole_mask_diverges_from_jax_on_purpose``
shows it); the port thresholds first and closes the mask.  The tests that
run ``MLBWInpaint`` hold the port to the JAX classes with that one
function replaced by the same steps in the port's order, built from the
JAX package's own resize, sigmoid and morphology.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nunif_tpu.iw3.mlbw_inpaint as j_mlbw_inpaint
from nunif_tpu.iw3.backward_warp import postprocess_hole_mask as j_hole_mask
from nunif_tpu.iw3.forward_inpaint import ForwardInpaint as JForwardInpaint
from nunif_tpu.iw3.models import light_inpaint_v1 as jli
from nunif_tpu.iw3.models.mlbw import MLBW as JMLBW
from nunif_tpu.models import model_kwargs as j_model_kwargs
from nunif_tpu.modules.resize import resize as j_resize

from nunif_tpu_torch.iw3 import backward_warp as tbw
from nunif_tpu_torch.iw3.forward_inpaint import ForwardInpaint
from nunif_tpu_torch.iw3.forward_warp import apply_divergence_forward_warp
from nunif_tpu_torch.iw3.mlbw_inpaint import (MASK_MLBW_THRESHOLD, MLBWInpaint,
                                              make_mask_mlbw)
from nunif_tpu_torch.iw3.models import light_inpaint_v1 as tli
from nunif_tpu_torch.iw3.models import mlbw as tmlbw
from nunif_tpu_torch.models import from_flax, init_flax_default, model_kwargs, to_flax

import torch_iw3_helpers as h
from torch_iw3_helpers import j_hole_mask_port_order


@pytest.fixture
def port_order(monkeypatch):
    monkeypatch.setattr(j_mlbw_inpaint, "postprocess_hole_mask",
                        j_hole_mask_port_order)


@pytest.fixture(scope="module")
def inpaint_net():
    """(port LightInpaintV1, JAX LightInpaintV1, JAX params), shaped."""
    net = tli.LightInpaintV1()
    params = tli.shaped_flax_params(net, 3)
    from_flax(net, params)
    return net.eval(), jli.LightInpaintV1(), h.jparams(params)


@pytest.fixture(scope="module")
def mask_net():
    net = make_mask_mlbw()
    params = tmlbw.shaped_flax_params(net, 2)
    from_flax(net, params)
    return net.eval(), JMLBW(num_layers=2, hole_mask=True), h.jparams(params)


def _masked_case(seed, shape=(2, 70, 100)):
    """Frames and a mask of a few blobs and specks, (B, H, W, 1) in {0, 1}."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape + (3,), dtype=np.float32)
    m = np.zeros(shape + (1,), np.float32)
    for i in range(shape[0]):
        for _ in range(3):
            y0, x0 = rng.integers(0, shape[1]), rng.integers(0, shape[2])
            m[i, y0:y0 + 9, x0:x0 + 5] = 1.0
    m[rng.random(m.shape) < 0.01] = 1.0
    return x, m


def test_light_inpaint_param_tree_and_kwargs_match_jax():
    net, jnet = tli.LightInpaintV1(), jli.LightInpaintV1()
    want = h.jax_flat_shapes(jnet, (1, 64, 64, 3), mask=(1, 64, 64, 1))
    assert {k: v.shape for k, v in to_flax(net).items()} == want
    assert model_kwargs(net) == j_model_kwargs(jnet) == {}
    assert net.model_name == jnet.model_name
    # flax's init by leaf name reaches every leaf (mask token, gMLP's
    # spatial projection); the spatial kernel is uniform on [0, 2e-3 / C)
    init_flax_default(net, torch.Generator().manual_seed(0))
    k = net.enc2_0.gmlp.gmlp.proj_spatial_kernel.detach()
    assert 0 <= float(k.min()) and float(k.max()) < 2e-3 / 192
    assert float(net.enc1.gmlp.gmlp.proj_spatial_bias.detach().min()) == 1.0


@pytest.mark.parametrize("k", [15, 7])
def test_gaussian_blur2d_matches_jax(k):
    x = np.random.default_rng(50).random((2, 20, 33, 1), dtype=np.float32)
    got = tli.gaussian_blur2d(h.t(x), k).numpy()
    want = np.asarray(jli.gaussian_blur2d(jnp.asarray(x), k))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # bf16 in, bf16 out, blurred in fp32 in both
    got16 = tli.gaussian_blur2d(h.t(x).bfloat16(), k)
    want16 = np.asarray(jli.gaussian_blur2d(jnp.asarray(x, jnp.bfloat16), k),
                        np.float32)
    assert got16.dtype == torch.bfloat16
    assert np.abs(got16.float().numpy() - want).max() <= np.abs(want16 - want).max()


@pytest.mark.parametrize("inner,outer", [(0, 0), (2, 3)])
def test_hole_mask_matches_jax_steps(inner, outer):
    """postprocess_hole_mask against the JAX steps in the port's order, on
    logits at the depth map's size resized (corner-anchored) to the
    frame's; the resize alone against JAX's to an ulp."""
    rng = np.random.default_rng(51)
    logits = rng.normal(-3, 2.5, (2, 13, 40, 1)).astype(np.float32)
    got = tbw.postprocess_hole_mask(h.t(logits), (30, 100), MASK_MLBW_THRESHOLD,
                                    inner_dilation=inner, outer_dilation=outer)
    want = j_hole_mask_port_order(jnp.asarray(logits), (30, 100),
                                  MASK_MLBW_THRESHOLD, inner, outer)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bare = tbw.postprocess_hole_mask(h.t(logits), (30, 100), MASK_MLBW_THRESHOLD)
    assert 0.05 < float(bare.mean()) < 0.5
    assert float(got.mean()) > float(bare.mean()) or (inner, outer) == (0, 0)
    from nunif_tpu_torch.modules.resize import resize
    r = resize(h.t(logits), 30, 100, mode="bilinear", antialias=False,
               align_corners=True)
    jr = j_resize(jnp.asarray(logits), 30, 100, mode="bilinear",
                  antialias=False, align_corners=True)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)


def test_hole_mask_diverges_from_jax_on_purpose():
    """The JAX function's mask is all ones at the 0.15 threshold for any
    logits (its closing clips them to [0, 1] before the sigmoid); the
    port's covers the pixels whose probability passes the threshold."""
    logits = np.random.default_rng(52).normal(-3, 2.5, (1, 13, 40, 1)).astype(np.float32)
    want = np.asarray(j_hole_mask(jnp.asarray(logits), (30, 100), 0.15))
    assert want.min() == 1.0
    got = tbw.postprocess_hole_mask(h.t(logits), (30, 100), 0.15)
    share = float((1 / (1 + np.exp(-logits)) > 0.15).mean())
    assert abs(float(got.mean()) - share) < 0.15, (float(got.mean()), share)


@pytest.mark.parametrize("skip_offset", [True, False])
def test_light_inpaint_matches_jax(inpaint_net, skip_offset):
    """The net at fp32 on 70x100 (not a multiple of 64), with and without
    the I2I offset crop; the composite keeps the source outside the mask."""
    net, jnet, jp = inpaint_net
    x, m = _masked_case(53)
    with torch.no_grad():
        got = net(h.t(x), mask=h.t(m), skip_i2i_offset=skip_offset).numpy()
    want = np.asarray(jnet.apply({"params": jp}, jnp.asarray(x),
                                 mask=jnp.asarray(m), skip_i2i_offset=skip_offset))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if skip_offset:
        keep = np.broadcast_to(m == 0, x.shape)
        np.testing.assert_array_equal(got[keep], x[keep])
        assert np.abs(got - x)[~keep].mean() > 0.05  # the holes changed


@pytest.mark.parametrize("closing,inner,outer,base", [
    (False, 0, 0, None), (True, 2, 1, None), (True, 1, 3, 40)])
def test_inpaint_infer_matches_jax(inpaint_net, closing, inner, outer, base):
    net, jnet, jp = inpaint_net
    x, m = _masked_case(54)
    got = tli.inpaint_infer(net, h.t(x), h.t(m), closing=closing,
                            inner_dilation=inner, outer_dilation=outer,
                            base_width=base).numpy()
    want = np.asarray(jli.inpaint_infer(jnet, jp, jnp.asarray(x), jnp.asarray(m),
                                        closing=closing, inner_dilation=inner,
                                        outer_dilation=outer, base_width=base))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("view,max_width,dil", [
    ("both", None, (0, 0)), ("both", 80, (1, 2)), ("left", None, (2, 0)),
    ("right", 81, (0, 1))])
def test_forward_inpaint_matches_jax(inpaint_net, view, max_width, dil):
    """ForwardInpaint.infer end to end: the forward warp with masks, the
    masks closed and grown, the net on each eye (the left flipped), with
    ``inpaint_max_width`` and the dilations."""
    net, jnet, jp = inpaint_net
    rng = np.random.default_rng(55)
    x = rng.random((2, 40, 120, 3), dtype=np.float32)
    depth = h.depth_map(rng, 2, 20, 60)
    kw = dict(synthetic_view=view, inner_dilation=dil[0],
              outer_dilation=dil[1], max_width=max_width)
    got = ForwardInpaint(net).infer(h.t(x), h.t(depth), 8.0, 0.5, **kw)
    want = JForwardInpaint(jnet, jp).infer(jnp.asarray(x), jnp.asarray(depth),
                                           8.0, 0.5, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    if max_width:
        assert got[0].shape[2] == max_width + max_width % 2
    # not degenerate: holes exist and the net changed them
    if view == "both" and max_width is None:
        _l, _r, lmask, _rm = apply_divergence_forward_warp(
            h.t(x), h.t(depth), 8.0, 0.5, return_mask=True, width_base=False)
        holes = lmask > 0
        assert 0.0 < float(holes.float().mean()) < 0.5
        bare = apply_divergence_forward_warp(h.t(x), h.t(depth), 8.0, 0.5,
                                             width_base=False)[0]
        assert float((got[0] - bare).abs()[holes.expand_as(bare)].mean()) > 0.05


@pytest.mark.parametrize("view,dil", [("both", (0, 0)), ("both", (2, 1)),
                                      ("left", (0, 0)), ("right", (1, 0))])
def test_mlbw_inpaint_matches_jax(inpaint_net, mask_net, port_order, view, dil):
    """MLBWInpaint.infer end to end (mask-MLBW warp of each eye, hole mask,
    the net on each eye) against JAX's with the hole mask in the port's
    order."""
    net, jnet, jp = inpaint_net
    mnet, jmnet, jmp = mask_net
    rng = np.random.default_rng(56)
    x = rng.random((2, 40, 120, 3), dtype=np.float32)
    depth = h.depth_map(rng, 2, 20, 60)
    kw = dict(synthetic_view=view, inner_dilation=dil[0], outer_dilation=dil[1])
    got = MLBWInpaint(net, mnet).infer(h.t(x), h.t(depth), 2.0, 0.5, **kw)
    jmi = j_mlbw_inpaint.MLBWInpaint(inpaint_model=jnet, inpaint_params=jp,
                                     mask_model=jmnet, mask_params=jmp)
    want = jmi.infer(jnp.asarray(x), jnp.asarray(depth), 2.0, 0.5, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    if view == "both" and dil == (0, 0):
        warped, logits = tbw.apply_divergence_nn_delta_weight(
            mnet, h.t(x), h.t(depth), 2.0, 0.5, shift=1, return_mask=True)
        holes = tbw.postprocess_hole_mask(logits, (40, 120), MASK_MLBW_THRESHOLD)
        assert 0.0 < float(holes.mean()) < 0.5, float(holes.mean())
        inside = holes.bool().expand_as(warped)
        assert float((got[1] - warped).abs()[inside].mean()) > 0.05
    with pytest.raises(ValueError, match="hole-mask"):
        MLBWInpaint(net, tmlbw.MLBW(num_layers=2))
