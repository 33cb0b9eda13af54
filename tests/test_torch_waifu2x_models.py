"""waifu2x's cunet / upcunet, swin_unet_v2 (winc_unet) and wgmlp_4x of
nunif_tpu_torch against the JAX package, whole models on the CPU.

Both packages get the same seeded numpy weights (``seeded_flax``: kernels
N(0, 0.5^2 / fan_in), small biases, norm scales near 1, the source
residual at its nearest-neighbour kernel with a 0.1 scale), carried into
the port by ``from_flax``.  cunet / upcunet run at their only width;
swin_unet_v2 and wgmlp_4x at base 32, on 64 px tiles (76 for cunet).  The
1x / 4x models, the 1xs factory and the winc_unet aliases run against JAX
through their reference ``.pth`` checkpoints
(tests/test_torch_waifu2x_pth.py); here the aliases are held to JAX's
registry.  Tolerances: fp32, the pre-clip output to
1e-4 (the same products summed in another order); bf16, the port's error
against JAX's fp32 output within 1.5x JAX's own bf16 error plus one bf16
step of the output (JAX's scale-only LayerNorm returns fp32 for a bf16
input and so runs the rest of a v2 / wgmlp block in fp32, the port stays
in bf16).
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.models import create_model as jax_create_model
from nunif_tpu.models import get_model_names as jax_model_names
from nunif_tpu.models.register import resolve_alias as jax_resolve_alias
from nunif_tpu.models import model_kwargs as jax_model_kwargs
from nunif_tpu.models import unflatten_params
from nunif_tpu.core.dtypes import FP32_POLICY as J_FP32
from nunif_tpu.utils import tiling as jtiling
import nunif_tpu.waifu2x  # noqa: F401  (registers the JAX models)

from nunif_tpu_torch.core.dtypes import FP32_POLICY
from nunif_tpu_torch.models import (create_model, from_flax, get_model_names,
                                    init_flax_default, model_kwargs,
                                    resolve_alias, to_flax)
from nunif_tpu_torch.utils import tiling
import nunif_tpu_torch.waifu2x  # noqa: F401  (registers the port's models)

SMALL = {"base_dim": 32}
# case: (registry name, kwargs, input side, output side)
MODELS = {
    "cunet": ("waifu2x.cunet", {}, 76, 20),
    "upcunet": ("waifu2x.upcunet", {}, 76, 80),
    "swin_unet_v2_2x": ("waifu2x.swin_unet_v2_2x", SMALL, 64, 92),
    "swin_unet_v2_downscaled_1x": ("waifu2x.swin_unet_v2_downscaled",
                                   dict(SMALL, downscale_factor=4), 64, 46),
    "wgmlp_4x": ("waifu2x.wgmlp_4x", SMALL, 64, 184),
}
ALIASES = {"waifu2x.winc_unet_1x": SMALL, "waifu2x.winc_unet_2x": SMALL,
           "waifu2x.winc_unet_4x": SMALL, "waifu2x.swin_unet_1x_v2": SMALL,
           "waifu2x.swin_unet_v2_1xs": {},
           "waifu2x.swin_unet_v2_downscaled": SMALL}
I2I = ("i2i_scale", "i2i_offset", "i2i_blend_size", "i2i_default_tile_size",
       "i2i_default_batch_size", "i2i_tile_constraints")


def seeded_flax(model, seed):
    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in to_flax(model).items():
        if key.endswith("resampling"):
            a = ref
        elif key.endswith("scale_bias"):
            a = np.full(ref.shape, 0.1)
        elif key.endswith("kernel"):
            a = rng.standard_normal(ref.shape) * 0.5 / np.sqrt(
                np.prod(ref.shape[:-1]))
        else:
            a = rng.normal(0.0, 0.02, ref.shape) + key.endswith("scale")
        if key == "unet1/conv_bottom/bias":
            a = a + 0.5
        flat[key] = np.asarray(a, np.float32)
    return flat


def make_pair(case, seed=0):
    name, kw, _size, _side = MODELS[case]
    model = create_model(name, **kw)
    flat = seeded_flax(model, seed)
    from_flax(model, flat)
    model.eval().requires_grad_(False)
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    return model, jax_create_model(name, **kw), params, flat


def pre_clip(out):
    """The model's output before its clip (cunet's train pair: z)."""
    return out[0] if isinstance(out, tuple) else out


_JITTED = {}


def jax_run(jmodel, params, x, dtype=jnp.float32, case=None):
    """The JAX model's pre-clip output; one jitted program per case, so the
    fp32 and bf16 tests of a case compile once each."""
    key = (case, jnp.dtype(dtype).name) if case else None
    fn = _JITTED.get(key) if key else None
    if fn is None:
        fn = jax.jit(lambda p, v: jmodel.apply({"params": p}, v, train=True))
        if key:
            _JITTED[key] = fn
    return np.asarray(pre_clip(fn(params, jnp.asarray(x, dtype)))).astype(
        np.float32)


def test_registry_names_and_aliases():
    """Every waifu2x inference name the JAX package registers is in the
    port (only the training discriminators are not), and the aliases
    resolve to the same canonical names."""
    jax_names = {n for n in jax_model_names()
                 if n.startswith("waifu2x.") and "discriminator" not in n}
    assert jax_names <= set(get_model_names())
    for name, kw in ALIASES.items():
        assert resolve_alias(name) == jax_resolve_alias(name), name
        model, jmodel = create_model(name, **kw), jax_create_model(name, **kw)
        assert model.model_name == jmodel.model_name == resolve_alias(name) \
            or name.endswith("1xs")
        assert model_kwargs(model) == jax_model_kwargs(jmodel), name
        for attr in I2I:
            assert getattr(model, attr) == getattr(jmodel, attr), (name, attr)
    assert resolve_alias("waifu2x.no_such_model") == "waifu2x.no_such_model"


@pytest.mark.parametrize("case", sorted(MODELS))
def test_model_matches_jax(case):
    """Param tree, constructor kwargs, the I2I contract, tile validity and
    the pre-clip fp32 output against the JAX model on the same weights."""
    model, jmodel, params, flat = make_pair(case)
    _name, _kw, size, side = MODELS[case]
    if case.endswith("cunet"):
        # the other trees are held by the .pth tests: both packages load the
        # same converted tree, the port's from_flax takes no extra leaf and
        # JAX's apply misses none
        shapes = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
        jshapes = {"/".join(p.key for p in path): leaf.shape for path, leaf in
                   jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
        assert {k: v.shape for k, v in flat.items()} == jshapes
    assert model_kwargs(model) == jax_model_kwargs(jmodel)
    for attr in I2I:
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    assert [model.is_valid_tile_size(t) for t in range(40, 130)] == \
        [jmodel.is_valid_tile_size(t) for t in range(40, 130)]
    x = np.random.default_rng(1).random((1, size, size, 3), dtype=np.float32)
    want = jax_run(jmodel, params, x, case=case)
    with torch.no_grad():
        got = pre_clip(model(torch.from_numpy(x), train=True)).numpy()
    assert got.shape == want.shape == (1, side, side, 3)
    assert want.std() > 0.01  # not a constant output
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_cunet_train_pair_matches_jax():
    """cunet's train output is (z, UNet1's cropped output), both unclipped."""
    model, jmodel, params, _flat = make_pair("upcunet", seed=2)
    x = np.random.default_rng(2).random((2, 76, 76, 3), dtype=np.float32)
    want = jax.jit(lambda p, v: jmodel.apply({"params": p}, v, train=True))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=True)
        clipped = model(torch.from_numpy(x)).numpy()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    np.testing.assert_allclose(clipped, np.clip(got[0].numpy(), 0, 1))


@pytest.mark.parametrize("case", ["swin_unet_v2_2x", "wgmlp_4x"])
def test_model_bf16_within_jax_bf16_error(case):
    """bf16 policy: the port's error against JAX's fp32 output is within
    1.5x JAX's own bf16 error plus one bf16 step at the output's scale."""
    model, jmodel, params, _flat = make_pair(case, seed=3)
    size = MODELS[case][2]
    x = np.random.default_rng(4).random((1, size, size, 3), dtype=np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ref = jax_run(jmodel, params, x, case=case)
    jerr = np.abs(jax_run(jmodel, params, x, jnp.bfloat16, case=case) - ref).max()
    with torch.no_grad():
        got = pre_clip(model(torch.from_numpy(x).bfloat16(), train=True))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max()
    assert 0 < jerr
    assert err <= 1.5 * jerr + 2.0 ** -8 * np.abs(ref).max()


@pytest.mark.parametrize("case", ["cunet", "upcunet"])
def test_render_matches_jax(case):
    """The tiled renderer over several tiles (seam blending), fp32, uint8
    frames: equal to the JAX renderer's output but for rounding flips."""
    model, jmodel, params, _flat = make_pair(case, seed=4)
    frame = np.random.default_rng(5).integers(0, 256, (72, 100, 3),
                                              dtype=np.uint8)
    tile = MODELS[case][2]
    jprog = jtiling.TiledRenderer(jmodel, params, policy=J_FP32) \
        .frame_program(72, 100, tile_size=tile, batch_size=4)
    want = np.asarray(jprog(params, jnp.asarray(frame)))
    got = tiling.TiledRenderer(model, policy=FP32_POLICY).frame_program(
        72, 100, tile_size=tile, batch_size=4)(frame).numpy()
    assert got.shape == want.shape == (72 * model.i2i_scale,
                                       100 * model.i2i_scale, 3)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got != want).mean() < 1e-3


@pytest.mark.parametrize("name", ["waifu2x.swin_unet_v2_1x",
                                  "waifu2x.swin_unet_v2_4x", "waifu2x.wgmlp_4x"])
def test_flax_init_matches_jax_init_rules(name):
    """``init_flax_default`` sets the leaves as flax's init does: the source
    residual at the JAX package's nearest-neighbour kernel with a zero
    scale, zero biases, unit norm scales; the init output is finite and
    inside [0, 1]."""
    from nunif_tpu.waifu2x.models.swin_unet_v2 import _nearest_resample_kernel
    model = create_model(name, **SMALL)
    init_flax_default(model, torch.Generator().manual_seed(0))
    flat = to_flax(model)
    np.testing.assert_array_equal(flat["unet/to_image/resampling"],
                                  _nearest_resample_kernel(model.i2i_scale))
    np.testing.assert_array_equal(flat["unet/to_image/scale_bias"], [0.0])
    for key, a in flat.items():
        if key.endswith("/bias"):
            assert not a.any(), key
        elif key.endswith("/scale"):
            assert (a == 1).all(), key
    with torch.no_grad():
        y = model(torch.rand(1, 64, 64, 3))
    assert torch.isfinite(y).all() and 0 <= y.min() and y.max() <= 1


@pytest.mark.parametrize("name", [
    "waifu2x.cunet", "waifu2x.upcunet", "waifu2x.swin_unet_v2_1x",
    "waifu2x.swin_unet_v2_2x", "waifu2x.swin_unet_v2_4x",
    "waifu2x.swin_unet_v2_downscaled", "waifu2x.swin_unet_v2_1xs",
    "waifu2x.winc_unet_2x", "waifu2x.wgmlp_4x"])
def test_nztm_round_trip_both_packages(name, tmp_path):
    """A .nztm the port writes loads in the port and in the JAX package as
    the canonical architecture with its kwargs and the same leaves (the
    1xs factory and the aliases record their class's name)."""
    from nunif_tpu.models import flatten_params, load_model as jax_load_model
    from nunif_tpu_torch.models import load_model, save_model
    kw = {} if name.endswith(("cunet", "1xs")) else SMALL
    model = create_model(name, **kw)
    flat = seeded_flax(model, 9)
    from_flax(model, flat)
    path = str(tmp_path / "m.nztm")
    save_model(model, path)
    loaded, meta = load_model(path, device="cpu")
    jmodel, jparams, jmeta = jax_load_model(path)
    assert meta["name"] == jmeta["name"] == model.model_name \
        == loaded.model_name == jmodel.model_name
    assert model_kwargs(loaded) == model_kwargs(model) == jax_model_kwargs(jmodel)
    jflat = flatten_params(jparams)
    for key, a in to_flax(loaded).items():
        np.testing.assert_array_equal(a, flat[key], err_msg=key)
        np.testing.assert_array_equal(np.asarray(jflat[key]), flat[key])
    assert set(jflat) == set(flat)
