"""The waifu2x swin_unet family of nunif_tpu_torch (1x, 4x, 8x, downscaled,
the 4xl factory) against the JAX package, whole models on the CPU (2x with
and without LayerNorm: tests/test_torch_swin_unet.py; the 4x LayerNorm
model through the renderer: tests/test_torch_window_attn.py).

Both packages get the same seeded "tamed" weights (numpy, see
``tamed_flax_params``), so that outputs stay inside (0, 1) and compare the
wiring rather than noise.  Models whose JAX class fixes ``base_dim`` (1x, 8x,
downscaled) run at their full width of 96; the others at 32.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.core.dtypes import FP32_POLICY as J_FP32
from nunif_tpu.models import create_model as jax_create_model
from nunif_tpu.models import load_model as jax_load_model
from nunif_tpu.models import model_kwargs as jax_model_kwargs
from nunif_tpu.models import save_model as jax_save_model
from nunif_tpu.models import flatten_params, unflatten_params
from nunif_tpu.utils import tiling as jtiling
from nunif_tpu.waifu2x import models as jmodels

from nunif_tpu_torch.core.dtypes import FP32_POLICY
from nunif_tpu_torch.models import (create_model, from_flax, load_model,
                                    model_kwargs, save_model, to_flax)
from nunif_tpu_torch.utils import tiling
from nunif_tpu_torch.waifu2x import models as tmodels
from nunif_tpu_torch.waifu2x.models.swin_unet import tamed_flax_params

# case: (class name in both packages, kwargs, output side for a 64x64 input)
MODELS = {
    "1x": ("SwinUNet", {}, 48),
    "4x": ("SwinUNet4x", {"base_dim": 32}, 192),
    "4x_pre_antialias": ("SwinUNet4x", {"base_dim": 32, "pre_antialias": True},
                         192),
    "4x_layer_norm": ("SwinUNet4x", {"base_dim": 32, "layer_norm": True}, 192),
    "8x": ("SwinUNet8x", {}, 384),
    "downscaled_2x": ("SwinUNetDownscaled", {"downscale_factor": 2}, 96),
    "downscaled_1x": ("SwinUNetDownscaled", {"downscale_factor": 4}, 48),
}
I2I = ("i2i_scale", "i2i_offset", "i2i_blend_size", "i2i_default_tile_size",
       "i2i_default_batch_size", "i2i_tile_constraints")


def _pair(case, seed=0):
    cls, kw, _side = MODELS[case]
    model = getattr(tmodels, cls)(**kw)
    flat = tamed_flax_params(model, seed=seed)
    from_flax(model, flat)
    model.eval().requires_grad_(False)
    jmodel = getattr(jmodels, cls)(**kw)
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    return model, jmodel, params, flat


@pytest.mark.parametrize("case", sorted(MODELS))
def test_model_matches_jax(case):
    """Param tree, constructor kwargs, the I2I contract and the pre-clip
    output (fp32; sums in another order, measured <= 3e-7)."""
    model, jmodel, params, flat = _pair(case)
    x = np.random.default_rng(1).random((1, 64, 64, 3), dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, train=True))(params, jnp.asarray(x)))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    jshapes = {"/".join(p.key for p in path): leaf.shape for path, leaf in
               jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    assert {k: v.shape for k, v in flat.items()} == jshapes
    assert model_kwargs(model) == jax_model_kwargs(jmodel)
    for attr in I2I:
        assert getattr(model, attr) == getattr(jmodel, attr), attr
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=True).numpy()
    side = MODELS[case][2]
    assert got.shape == want.shape == (1, side, side, 3)
    assert 0.0 < want.min() and want.max() < 1.0  # tamed: no clipping
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_layer_norm_model_bf16_against_jax():
    """bf16 of the 4x LayerNorm model: the JAX package promotes the stream
    to fp32 in every LayerNorm block, so its bf16 run returns fp32 (asserted,
    so that a change of the reference is noticed); the port stays bf16 and
    is held to JAX's output within its own bf16-vs-fp32 error."""
    model, jmodel, params, _flat = _pair("4x_layer_norm")
    x = np.random.default_rng(1).random((1, 64, 64, 3), dtype=np.float32)
    jout = jax.jit(lambda p, v: jmodel.apply({"params": p}, v, train=True))(
        params, jnp.asarray(x, jnp.bfloat16))
    assert jout.dtype == jnp.float32
    with torch.no_grad():
        got = model(torch.from_numpy(x).bfloat16(), train=True)
        fp32 = model(torch.from_numpy(x), train=True).numpy()
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    own = np.abs(got - fp32).max()
    assert own < 2 / 255
    assert np.abs(got - np.asarray(jout)).max() <= own + 1e-4


@pytest.mark.parametrize("case", ["1x", "downscaled_2x"])
def test_render_scale_1_and_downscaled_match_jax(case):
    """The renderer at scale 1 and on a model without a pre-shuffle head
    (both shuffle inside the model): frame_program over 4 tiles, fp32."""
    model, jmodel, params, _flat = _pair(case, seed=4)
    frame = np.random.default_rng(3).integers(0, 256, (72, 80, 3),
                                              dtype=np.uint8)
    jprog = jtiling.TiledRenderer(jmodel, params, policy=J_FP32) \
        .frame_program(72, 80, tile_size=64, batch_size=4)
    want = np.asarray(jprog(params, jnp.asarray(frame)))
    renderer = tiling.TiledRenderer(model, policy=FP32_POLICY)
    scale = model.i2i_scale
    cfg = tiling.make_tile_config(72, 80, scale, model.i2i_offset, 64,
                                  model.i2i_blend_size)
    assert cfg.n_tiles > 1 and renderer._ps_factor(cfg, (64, 64)) == 1
    got = renderer.frame_program(72, 80, tile_size=64, batch_size=4)(frame)
    assert got.shape == want.shape == (72 * scale, 80 * scale, 3)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    # quantization can flip where the fp32 sums differ in the last bit
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1


def test_registry_names_match_jax():
    names = ("waifu2x.swin_unet_1x", "waifu2x.swin_unet_2x",
             "waifu2x.swin_unet_4x", "waifu2x.swin_unet_8x",
             "waifu2x.swin_unet_downscaled", "waifu2x.swin_unet_4xl")
    for name in names:
        model, jmodel = create_model(name), jax_create_model(name)
        assert model.model_name == jmodel.model_name
        assert model_kwargs(model) == jax_model_kwargs(jmodel), name
    xl = create_model("waifu2x.swin_unet_4xl")
    assert isinstance(xl, tmodels.SwinUNet4x)
    assert (xl.base_dim, xl.layer_norm, xl.model_name) == (
        192, True, "waifu2x.swin_unet_4x")
    # 12 heads of 16 at C = 192, of 32 at C = 384 (swin5 of the 4x trunk)
    assert xl.unet.swin1.block0.num_heads == 12
    assert xl.unet.swin5.block0.dim == 384


@pytest.fixture(scope="module")
def xl():
    model = create_model("waifu2x.swin_unet_4xl")
    flat = tamed_flax_params(model, seed=0)
    from_flax(model, flat)
    return model.eval().requires_grad_(False), flat


def test_4xl_tamed_output_in_range(xl):
    """At full width the tamed weights keep the 4xl's pre-clip output inside
    (0, 1), in fp32 and in bf16, and bf16 stays near fp32."""
    model, _flat = xl
    x = torch.from_numpy(np.random.default_rng(5).random((1, 64, 64, 3),
                                                         dtype=np.float32))
    with torch.no_grad():
        fp32 = model(x, train=True)
        bf16 = model(x.bfloat16(), train=True)
    assert fp32.shape == bf16.shape == (1, 192, 192, 3)
    assert bf16.dtype == torch.bfloat16
    for y in (fp32, bf16.float()):
        assert 0.05 < float(y.min()) and float(y.max()) < 0.95
    assert float((bf16.float() - fp32).abs().max()) < 2 / 255


def test_4xl_checkpoint_round_trip_with_jax(xl, tmp_path):
    """The port's .nztm of the 4xl loads in JAX as swin_unet_4x(base_dim=192,
    layer_norm=True), and the JAX package's file loads in the port."""
    model, flat = xl
    port_path, jax_path = str(tmp_path / "port.nztm"), str(tmp_path / "jax.nztm")
    save_model(model, port_path)
    jmodel, params, meta = jax_load_model(port_path)
    assert meta["name"] == "waifu2x.swin_unet_4x"
    assert isinstance(jmodel, jmodels.SwinUNet4x)
    assert (jmodel.base_dim, jmodel.layer_norm) == (192, True)
    jflat = flatten_params(params)
    assert sorted(jflat) == sorted(flat)
    for key, arr in jflat.items():
        np.testing.assert_array_equal(arr, flat[key], err_msg=key)
    jax_save_model(jax_create_model("waifu2x.swin_unet_4xl"), params, jax_path)
    loaded, meta = load_model(jax_path, device="cpu")
    assert isinstance(loaded, tmodels.SwinUNet4x)
    assert model_kwargs(loaded) == model_kwargs(model)
    for key, arr in to_flax(loaded).items():
        np.testing.assert_array_equal(arr, flat[key], err_msg=key)
