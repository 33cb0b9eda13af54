"""iw3's other stereo methods in nunif_tpu_torch against the JAX package, on
the CPU, part by part: MLBW (``mlbw_l2`` / ``l4`` / ``l2s`` / ``l4s``, the
mask-MLBW) and its blended warp, ``row_flow_v2``, the depth-ordered
forward warp (``forward`` / ``forward_fill``) with its hole repairs, and
the modules under them (LayerNormNoBias, box blur, pixel unshuffle, gMLP,
the mask morphology).  The whole frame path of each method and the CLI:
tests/test_torch_iw3_methods_frames.py; the inpaint methods:
tests/test_torch_inpaint.py.

Inputs and weights are drawn with numpy and given to both packages
(``shaped_flax_params``: the deltas move pixels and the layer weights
differ).  The warps run through K3's plain twin, as everything does on the
CPU.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nunif_tpu.iw3 import backward_warp as jbw
from nunif_tpu.iw3 import dilation as jdil
from nunif_tpu.iw3 import forward_warp as jfw
from nunif_tpu.models import create_model as j_create_model
from nunif_tpu.models import model_kwargs as j_model_kwargs
from nunif_tpu.modules import attention as jattn
from nunif_tpu.modules import norm as jnorm
from nunif_tpu.modules import permute as jperm
from nunif_tpu.modules import pool as jpool
import nunif_tpu.iw3.models  # noqa: F401  (registers the JAX iw3 nets)

from nunif_tpu_torch.iw3 import backward_warp as tbw
from nunif_tpu_torch.iw3 import dilation as tdil
from nunif_tpu_torch.iw3 import forward_warp as tfw
from nunif_tpu_torch.models import create_model, from_flax, model_kwargs, to_flax
from nunif_tpu_torch.modules import attention as tattn
from nunif_tpu_torch.modules import norm as tnorm
from nunif_tpu_torch.modules import permute as tperm
from nunif_tpu_torch.modules import pool as tpool

from torch_iw3_helpers import depth_map, jax_flat_shapes, jparams, shaped, t

MLBW_NAMES = ["sbs.mlbw_l2", "sbs.mlbw_l4", "sbs.mlbw_l2s", "sbs.mlbw_l4s",
              "sbs.mask_mlbw_l2"]


# -- parameter trees --------------------------------------------------------

@pytest.mark.parametrize("name", MLBW_NAMES + ["sbs.row_flow_v2"])
def test_param_trees_and_kwargs_match_jax(name):
    model, jmodel = create_model(name), j_create_model(name)
    want = jax_flat_shapes(jmodel, (1, 24, 96, 3))
    assert {k: v.shape for k, v in to_flax(model).items()} == want
    assert model_kwargs(model) == j_model_kwargs(jmodel)
    assert model.model_name == jmodel.model_name


# -- modules at fp32 (and bf16 against JAX's own bf16 error) ----------------

def test_layer_norm_no_bias_matches_jax():
    rng = np.random.default_rng(20)
    x = (rng.standard_normal((2, 5, 7, 48)) * 3 + 1).astype(np.float32)
    scale = rng.normal(1, 0.2, 48).astype(np.float32)
    norm = tnorm.LayerNormNoBias(48)
    from_flax(norm, {"LayerNorm_0/scale": scale})
    jn = jnorm.LayerNormNoBias()
    assert jax_flat_shapes(jn, (1, 48)) == {"LayerNorm_0/scale": (48,)}
    jp = jparams({"LayerNorm_0/scale": scale})
    want = np.asarray(jn.apply({"params": jp}, jnp.asarray(x)))
    with torch.no_grad():
        got = norm(t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # bf16: flax returns fp32 for a bf16 input, the port rounds once to
    # bf16 (ROADMAP queue 3, "LayerNorm dtype"): within JAX's bf16 error
    xb = jnp.asarray(x, jnp.bfloat16)
    want16 = np.asarray(jn.apply({"params": jp}, xb), np.float32)
    with torch.no_grad():
        got16 = norm(t(x).bfloat16())
    assert got16.dtype == torch.bfloat16
    # element by element: JAX's bf16 error plus the port's one rounding of
    # the output to bf16 (at most 2^-8 of the value, bf16's unit roundoff)
    err = np.abs(got16.float().numpy() - want)
    jax_err = np.abs(want16 - want)
    assert (err <= jax_err + np.abs(want16) * 2 ** -8 + 1e-6).all(), \
        (err.max(), jax_err.max())


@pytest.mark.parametrize("k", [3, 7])
def test_box_blur_matches_jax(k):
    x = np.random.default_rng(21).random((2, 9, 13, 3), dtype=np.float32)
    got = tpool.box_blur(t(x), k).numpy()
    want = np.asarray(jpool.box_blur(jnp.asarray(x), k))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pixel_unshuffle_matches_jax():
    x = np.random.default_rng(22).random((2, 8, 12, 3), dtype=np.float32)
    got = tperm.pixel_unshuffle(t(x), 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jperm.pixel_unshuffle(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tperm.pixel_shuffle(got, 4).numpy(), x)


def _rounded_ln():
    import flax.linen as fnn

    class RoundedLN(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.LayerNorm(epsilon=1e-5, use_bias=False)(x).astype(x.dtype)
    return RoundedLN


_RoundedLN = _rounded_ln()


@pytest.mark.parametrize("shift", [False, True])
def test_window_gmlp_matches_jax(shift):
    """WindowGMLP2d (window 8, C 32) with two LayerNormNoBias, and GMLP
    alone, fp32; bf16 within JAX's own bf16 error."""
    rng = np.random.default_rng(23 + shift)
    C, ws = 32, 8

    import flax.linen as fnn

    class JWrap(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            n1 = jnorm.LayerNormNoBias(name="norm1")
            n2 = jnorm.LayerNormNoBias(name="norm2")
            return jattn.WindowGMLP2d(C, ws, mlp_ratio=2, shift=shift,
                                      name="gmlp")(x, n1, n2)

    class JWrap16(fnn.Module):
        """JAX's module with the port's LayerNorm rule: the norms' output
        rounded to x's dtype (flax's LayerNorm returns fp32 for bf16 and so
        runs the rest of the module in fp32)."""
        @fnn.compact
        def __call__(self, x):
            n1, n2 = (_RoundedLN(name=n) for n in ("norm1", "norm2"))
            return jattn.WindowGMLP2d(C, ws, mlp_ratio=2, shift=shift,
                                      name="gmlp")(x, n1, n2)

    class TWrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.norm1 = tnorm.LayerNormNoBias(C)
            self.norm2 = tnorm.LayerNormNoBias(2 * C)
            self.gmlp = tattn.WindowGMLP2d(C, ws, mlp_ratio=2, shift=shift)

        def forward(self, x):
            return self.gmlp(x, self.norm1, self.norm2)

    tmod = TWrap()
    shapes = jax_flat_shapes(JWrap(), (1, 16, 24, C))
    assert {k: v.shape for k, v in to_flax(tmod).items()} == shapes
    flat = {k: (rng.standard_normal(s) * (0.5 if k.endswith("scale") else 0.2)
                + (1.0 if k.endswith("scale") else 0.0)).astype(np.float32)
            for k, s in shapes.items()}
    from_flax(tmod, flat)
    x = rng.standard_normal((2, 16, 24, C)).astype(np.float32)
    jp = {"params": jparams(flat)}
    want = np.asarray(JWrap().apply(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(t(x)).numpy()
        got16 = tmod(t(x).bfloat16()).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # bf16: flax's norm promotes the module to fp32 (error 0.03-0.04
    # here), the port stays bf16 (the settled divergence, ROADMAP queue 3):
    # within JAX's own bf16 error once its norms keep bf16 too
    xb = jnp.asarray(x, jnp.bfloat16)
    want16 = np.asarray(JWrap16().apply(jp, xb), np.float32)
    assert np.abs(got16 - want).max() <= np.abs(want16 - want).max(), \
        (np.abs(got16 - want).max(), np.abs(want16 - want).max())
    # GMLP without norms on (B, N, C)
    g = tattn.GMLP(C, ws * ws, 1)
    gshapes = jax_flat_shapes(jattn.GMLP(C, ws * ws, 1), (1, ws * ws, C))
    assert {k: v.shape for k, v in to_flax(g).items()} == gshapes
    gflat = {k: (rng.standard_normal(s) * 0.2).astype(np.float32)
             for k, s in gshapes.items()}
    from_flax(g, gflat)
    xs = rng.standard_normal((3, ws * ws, C)).astype(np.float32)
    want_g = np.asarray(jattn.GMLP(C, ws * ws, 1).apply(
        {"params": jparams(gflat)}, jnp.asarray(xs)))
    with torch.no_grad():
        np.testing.assert_allclose(g(t(xs)).numpy(), want_g, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("base_width", [None, 17, 40])
def test_mask_morphology_matches_jax(base_width):
    rng = np.random.default_rng(25)
    m = (rng.random((2, 12, 30, 1)) > 0.8).astype(np.float32)
    for fn, kw in ((tdil.mask_closing, {}), (tdil.mask_closing, {"n_iter": 1}),
                   (tdil.dilate_inner, {"n_iter": 3}),
                   (tdil.dilate_outer, {"n_iter": 3}),
                   (tdil.dilate_inner, {"n_iter": 0}),
                   (tdil.dilate_outer, {"n_iter": 2})):
        if fn is not tdil.mask_closing:
            kw = dict(kw, base_width=base_width)
        got = fn(t(m), **kw).numpy()
        want = np.asarray(getattr(jdil, fn.__name__)(jnp.asarray(m), **kw))
        np.testing.assert_array_equal(got, want, err_msg=f"{fn.__name__} {kw}")
    # 30 / 40 * 3 = 2.25 -> 2; 30 / 17 * 3 = 5.29 -> 5 (Python's round)
    grown = tdil.dilate_outer(t(m), 3, base_width=base_width).sum()
    assert float(grown) > float(m.sum())


# -- MLBW and row_flow_v2 ---------------------------------------------------

@pytest.mark.parametrize("name", ["sbs.mlbw_l2", "sbs.mlbw_l4", "sbs.mlbw_l2s",
                                  "sbs.mask_mlbw_l2", "sbs.row_flow_v2"])
def test_stereo_net_matches_jax(name):
    """Deltas, layer weights and hole logits at fp32, on a packed input of
    a width that is not a multiple of 32."""
    model, params = shaped(name)
    rng = np.random.default_rng(30)
    depth = depth_map(rng, 2, 22, 101)
    x = tbw.make_input_tensor(None, t(depth), 2.0, 0.5, 101)
    want = j_create_model(name).apply({"params": jparams(params)},
                                      jnp.asarray(x.numpy()))
    with torch.no_grad():
        got = model(x)
    if name == "sbs.row_flow_v2":
        got, want = (got,), (want,)
    assert len(got) == len(want) == (3 if "mask" in name else
                                     1 if "row_flow" in name else 2)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.shape[:3] == (2, 22, 101)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
    delta = got[0].numpy()
    assert delta.std() > 1.0, delta.std()  # deltas of pixels
    if "mlbw" in name:
        assert got[1].dtype == torch.float32
        assert got[1].numpy().std() > 0.1  # the layers' weights differ


@pytest.mark.parametrize("view", ["both", "left", "right"])
@pytest.mark.parametrize("name", ["sbs.mlbw_l2", "sbs.mlbw_l4s", "sbs.mask_mlbw_l2"])
def test_mlbw_warp_matches_jax(name, view):
    """apply_divergence_nn_LR (both eyes as one [x, flip(x)] batch) and
    apply_divergence_nn_delta_weight with the mask, through K3's twin."""
    model, params = shaped(name)
    jmodel, jp = j_create_model(name), jparams(params)
    rng = np.random.default_rng(31)
    c = rng.random((2, 40, 120, 3), dtype=np.float32)
    depth = depth_map(rng, 2, 20, 60)
    got = tbw.apply_divergence_nn_LR(model, t(c), t(depth), 2.5, 0.4,
                                     synthetic_view=view)
    want = jbw.apply_divergence_nn_LR(jmodel, jp, jnp.asarray(c),
                                      jnp.asarray(depth), 2.5, 0.4,
                                      synthetic_view=view)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    moved = np.abs(got[0 if view != "right" else 1].numpy() - c) > 1 / 255
    assert moved.mean() > 0.1
    if model.hole_mask:
        for shift in (-1, 1):
            z, logits = tbw.apply_divergence_nn_delta_weight(
                model, t(c), t(depth), 2.5, 0.4, shift=shift,
                preserve_screen_border=True, return_mask=True)
            jz, jl = jbw.apply_divergence_nn_delta_weight(
                jmodel, jp, jnp.asarray(c), jnp.asarray(depth), 2.5, 0.4,
                shift=shift, preserve_screen_border=True, return_mask=True)
            np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                       rtol=1e-4, atol=1e-4)


def test_mlbw_warp_per_frame_convergence_matches_jax():
    """Per-frame convergence: the port runs both eyes as one [x, flip(x)]
    batch with the convergence repeated, JAX as two calls; the same eyes."""
    model, params = shaped("sbs.mlbw_l2")
    rng = np.random.default_rng(32)
    c = rng.random((2, 24, 80, 3), dtype=np.float32)
    depth = depth_map(rng, 2, 24, 80)
    conv = np.array([0.2, 0.8], np.float32)
    got = tbw.apply_divergence_nn_LR(model, t(c), t(depth), 2.0, t(conv))
    want = jbw.apply_divergence_nn_LR(j_create_model("sbs.mlbw_l2"),
                                      jparams(params), jnp.asarray(c),
                                      jnp.asarray(depth), 2.0, jnp.asarray(conv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


# -- the forward warp -------------------------------------------------------

# (frame width, divergence): JAX's bounded select (shift 10 px) and its
# scatter-max (W 1400 at divergence 20: shift 140 px > 128)
SHIFTS = {"bounded": (200, 10.0), "scatter": (1400, 20.0)}


def _forward_case(regime, seed):
    """Depth at the frame's size: the warp's own resize is held to JAX's
    in ``test_forward_warp_depth_resize_matches_jax``; a one-ulp
    difference there moves a splat weight, which the blend of two taps
    whose weights both sit near the 1e-5 clip amplifies past 1e-5."""
    W, div = SHIFTS[regime]
    rng = np.random.default_rng(seed)
    c = rng.random((2, 6, W, 3), dtype=np.float32)
    return c, depth_map(rng, 2, 6, W), div


def _assert_forward_equal(got, want, what):
    """Hole masks equal exactly, values within 1e-5.  A differing mask
    pixel is reported with the count (a float tie in the depth key)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, what
        if g.shape[-1] == 1 and len(got) == 4 and i >= 2:  # a mask
            n = int((g != w).sum())
            assert n == 0, f"{what}: {n} mask pixels differ (float tie?)"
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("regime", ["bounded", "scatter"])
@pytest.mark.parametrize("view", ["both", "left", "right"])
@pytest.mark.parametrize("method", ["forward", "forward_fill"])
def test_forward_warp_matches_jax(method, view, regime):
    c, depth, div = _forward_case(regime, 40)
    # the pipeline's call (no mask, base the larger side), and the inpaint
    # methods' (with masks); width_base=True (the frame's width) beside it
    for return_mask, width_base in ((False, False), (True, True)):
        got = tfw.apply_divergence_forward_warp(
            t(c), t(depth), div, 0.5, method=method, synthetic_view=view,
            return_mask=return_mask, width_base=width_base)
        want = jfw.apply_divergence_forward_warp(
            jnp.asarray(c), jnp.asarray(depth), div, 0.5, method=method,
            synthetic_view=view, return_mask=return_mask,
            width_base=width_base)
        _assert_forward_equal(got, want, f"mask {return_mask} "
                              f"width_base {width_base}")
    if return_mask and view == "both":
        holes = float((got[2].numpy() > 0).mean())
        assert 0.0 < holes < 0.5, holes  # the case has disocclusions


@pytest.mark.parametrize("regime", ["bounded", "scatter"])
def test_forward_warp_per_frame_convergence_matches_jax(regime):
    c, depth, div = _forward_case(regime, 41)
    conv = np.array([0.0, 0.9], np.float32)
    got = tfw.apply_divergence_forward_warp(
        t(c), t(depth), div, t(conv), method="forward_fill",
        return_mask=True)
    want = jfw.apply_divergence_forward_warp(
        jnp.asarray(c), jnp.asarray(depth), div, jnp.asarray(conv),
        method="forward_fill", return_mask=True)
    _assert_forward_equal(got, want, "per-frame convergence")


def test_forward_warp_depth_resize_matches_jax():
    """The resize the forward warp applies to a depth map smaller than the
    frame (bilinear, antialias), against JAX's, to an ulp."""
    from nunif_tpu.modules.resize import resize as jresize
    from nunif_tpu_torch.modules.resize import resize as tresize
    depth = depth_map(np.random.default_rng(43), 2, 3, 700)
    got = tresize(t(depth), 6, 1400, mode="bilinear", antialias=True).numpy()
    want = np.asarray(jresize(jnp.asarray(depth), 6, 1400, mode="bilinear",
                              antialias=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
    c = np.random.default_rng(44).random((2, 6, 1400, 3), dtype=np.float32)
    got = tfw.apply_divergence_forward_warp(t(c), t(depth), 2.0, 0.5,
                                            return_mask=True)
    want = tfw.apply_divergence_forward_warp(t(c), t(want), 2.0, 0.5,
                                             return_mask=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _layered(seed):
    """A warped-index row with layered holes (index falls back) and
    undefined pixels (-1), and values with -1 / -2 markers."""
    rng = np.random.default_rng(seed)
    idx = np.cumsum(rng.uniform(0.2, 1.5, (2, 3, 50)), axis=-1)
    back = rng.random((2, 3, 50)) < 0.15
    idx = np.where(back, idx - rng.uniform(2, 6, idx.shape), idx)
    idx = idx.astype(np.float32)[..., None]
    x = rng.random((2, 3, 50, 3), dtype=np.float32)
    x[rng.random((2, 3, 50)) < 0.25] = -1.0
    return idx, x


@pytest.mark.parametrize("sign", [1, -1])
def test_hole_scans_match_jax(sign):
    idx, x = _layered(42)
    for got, want in ((tfw.fill_nearest_x(t(x), sign),
                       jfw.fill_nearest_x(jnp.asarray(x), sign)),
                      (tfw.shift_fill(t(x), sign, flip_sign=True),
                       jfw.shift_fill(jnp.asarray(x), sign, flip_sign=True))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    side, fixed = tfw.fix_layered_holes(t(x), t(idx), sign)
    jside, jfixed = jfw.fix_layered_holes(jnp.asarray(x), jnp.asarray(idx), sign)
    np.testing.assert_array_equal(side.numpy(), np.asarray(jside))
    np.testing.assert_array_equal(fixed.numpy(), np.asarray(jfixed))
    assert (side.numpy() == -2).any()  # the case has layered holes
    left, right = tfw.shift_fill_pack(t(x), t(x[:, :, ::-1]), True)
    jl, jr = jfw.shift_fill_pack(jnp.asarray(x), jnp.asarray(x[:, :, ::-1]), True)
    np.testing.assert_array_equal(left.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(right.numpy(), np.asarray(jr))
    mask = t((x[..., :1] < 0).astype(np.float32))
    np.testing.assert_allclose(
        tfw.blur_blend(t(x), mask).numpy(),
        np.asarray(jfw.blur_blend(jnp.asarray(x), jnp.asarray(mask.numpy()))),
        rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tfw.gen_mask2(side).numpy(),
                                  np.asarray(jfw.gen_mask2(jside)))


def test_shift_fill_flip_sign_stops_at_bound():
    """The alternating fill stops after ``max_tries`` passes, as JAX's
    bounded while_loop does, even where a negative remains."""
    x = -np.ones((1, 1, 9, 1), np.float32)
    x[0, 0, 4] = 0.5
    for tries in (1, 2, 3, 100):
        got = tfw.shift_fill(t(x), 1, flip_sign=True, max_tries=tries)
        want = jfw.shift_fill(jnp.asarray(x), 1, flip_sign=True, max_tries=tries)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # the ends take the zero padding: no negative once the fill is done
        assert (got.numpy() < 0).any() == (tries < 5), tries


