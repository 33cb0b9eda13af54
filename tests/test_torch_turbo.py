"""waifu2x turbo_2x / turbo_4x, upconv_7, vgg_7 and ConvTranspose2dTorch of
nunif_tpu_torch against the JAX package, on the CPU, at small widths (turbo
at dim 16 with 2 blocks).

Both packages get the same seeded numpy weights.  fp32 is held to 1e-4;
bf16 is held to JAX's own bf16 error against its fp32 output (the two
round at the same points, conv then bias add, but sum in another order).
An untrained turbo (zero second convs and tail, the JAX init) is the catrom
upscale, held to a float64 numpy catrom to 1e-6.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from nunif_tpu.core.dtypes import FP32_POLICY as J_FP32
from nunif_tpu.models import load_model as jax_load_model
from nunif_tpu.models import model_kwargs as jax_model_kwargs
from nunif_tpu.models import save_model as jax_save_model
from nunif_tpu.models import unflatten_params
from nunif_tpu.modules.conv import ConvTranspose2dTorch as JaxConvT
from nunif_tpu.utils import tiling as jtiling
from nunif_tpu.waifu2x.models import turbo as jturbo
from nunif_tpu.waifu2x.models import UpConv7 as JaxUpConv7, VGG7 as JaxVGG7

from nunif_tpu_torch.core.dtypes import FP32_POLICY
from nunif_tpu_torch.models import (from_flax, load_model, model_kwargs,
                                    save_model, to_flax)
from nunif_tpu_torch.modules.conv import ConvTranspose2dTorch, conv2d
from nunif_tpu_torch.modules.resize import resize_matrix
from nunif_tpu_torch.utils import tiling
from nunif_tpu_torch.waifu2x.models import turbo
from nunif_tpu_torch.waifu2x.models.upconv_7 import UpConv7, VGG7

SMALL = dict(dim=16, blocks=2)
PAIRS = {
    "turbo_2x": (turbo.Turbo2x, jturbo.Turbo2x, SMALL),
    "turbo_4x": (turbo.Turbo4x, jturbo.Turbo4x, SMALL),
    "upconv_7": (UpConv7, JaxUpConv7, {}),
    "vgg_7": (VGG7, JaxVGG7, {}),
}


def seeded_flax(model, seed, gain=0.5):
    """Seeded numpy weights in flax layout: kernels N(0, gain^2 / fan_in),
    biases N(0, 0.02^2), the tail (turbo) non-zero so that it is tested."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, a in to_flax(model).items():
        if key.endswith("kernel"):
            fan_in = int(np.prod(a.shape[:-1]))
            flat[key] = (rng.standard_normal(a.shape) * gain
                         / np.sqrt(fan_in)).astype(np.float32)
        else:
            flat[key] = (rng.standard_normal(a.shape) * 0.02).astype(np.float32)
    return flat


def make_pair(name, seed=0, gain=0.5, **extra):
    cls, jcls, kw = PAIRS[name]
    model = cls(**kw, **extra)
    flat = seeded_flax(model, seed, gain)
    from_flax(model, flat)
    model.eval().requires_grad_(False)
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    return model, jcls(**kw, **extra), params, flat


def jax_apply(jmodel, params, x, dtype=jnp.float32, train=True):
    return np.asarray(jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, train=train))(params, jnp.asarray(x, dtype))
        .astype(jnp.float32))


@pytest.mark.parametrize("scale", [2, 4])
def test_catrom_kernel_equals_jax(scale):
    np.testing.assert_array_equal(turbo.catrom2x_phase_taps(scale),
                                  jturbo.catrom2x_phase_taps(scale))
    k = turbo.catrom2x_halfres_kernel(3, scale)
    np.testing.assert_array_equal(k, jturbo.catrom2x_halfres_kernel(3, scale))
    # the grouped weight is the same kernel without its zeros
    w = turbo.catrom_grouped_weight(3, scale).numpy()
    ph2 = (2 * scale) ** 2
    for o in range(k.shape[-1]):
        np.testing.assert_array_equal(w[o, 0], k[:, :, o // ph2, o])
        others = np.delete(k[:, :, :, o], o // ph2, axis=-1)
        assert not others.any()


@pytest.mark.parametrize("name", list(PAIRS))
def test_param_tree_and_kwargs_match_jax(name):
    model, jmodel, _params, _flat = make_pair(name)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    jflat = {"/".join(p.key for p in path): leaf.shape for path, leaf in
             jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    assert {k: v.shape for k, v in to_flax(model).items()} == jflat
    assert model_kwargs(model) == jax_model_kwargs(jmodel)


@pytest.mark.parametrize("name,shape", [
    ("turbo_2x", (2, 64, 68)), ("turbo_2x", (1, 63, 65)),
    ("turbo_4x", (2, 64, 68)), ("upconv_7", (2, 40, 44)),
    ("vgg_7", (2, 40, 44))])
def test_model_fp32_matches_jax(name, shape):
    """fp32, unclipped (train=True); turbo also at odd sizes, where the
    stem and base take the explicit (2, 3) pad; He-like gain for the
    leaky-ReLU stacks, which keeps their output away from 0."""
    model, jmodel, params, _flat = make_pair(
        name, gain=0.5 if name.startswith("turbo") else 1.4)
    x = np.random.default_rng(1).random(shape + (3,), dtype=np.float32)
    want = jax_apply(jmodel, params, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=True).numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("name", ["turbo_2x", "turbo_4x"])
def test_pre_shuffle_head_fp32_matches_jax(name):
    """The head layout (H/2, W/2, C*(2s)^2) the renderer blends, clipped,
    channel c*(2s)^2 + ry*2s + rx."""
    model, jmodel, params, _flat = make_pair(name, pre_shuffle_output=True)
    x = np.random.default_rng(2).random((2, 64, 72, 3), dtype=np.float32)
    want = jax_apply(jmodel, params, x, train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        shuffled = model(torch.from_numpy(x), pre_shuffle=False).numpy()
    ph = 2 * model.i2i_scale
    off = model.i2i_offset // ph  # half-res cells
    assert got.shape == want.shape == (2, 32 - 2 * off, 36 - 2 * off,
                                       3 * ph * ph)
    np.testing.assert_allclose(got, want, atol=1e-4)
    from nunif_tpu_torch.modules.permute import pixel_shuffle
    np.testing.assert_array_equal(
        pixel_shuffle(torch.from_numpy(got), ph).numpy(), shuffled)


@pytest.mark.parametrize("name", ["turbo_2x", "turbo_4x", "upconv_7"])
def test_model_bf16_within_jax_bf16_error(name):
    """bf16: the port's max error against JAX's fp32 output is no larger
    than JAX's own bf16 error, its RMS error within 10% of JAX's (both
    round the conv and then the bias add; they sum in other orders)."""
    model, jmodel, params, _flat = make_pair(name, seed=3)
    x = np.random.default_rng(4).random((2, 64, 64, 3), dtype=np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ref = jax_apply(jmodel, params, x)
    jax16 = jax_apply(jmodel, params, x, jnp.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(x).bfloat16(), train=True)
    assert got.dtype == torch.float32 if name.startswith("turbo") \
        else got.dtype == torch.bfloat16
    got = got.float().numpy()
    jerr = np.abs(jax16 - ref)
    err = np.abs(got - ref)
    assert jerr.max() > 0  # bf16 did round
    assert err.max() <= jerr.max()
    assert np.sqrt((err ** 2).mean()) <= 1.1 * np.sqrt((jerr ** 2).mean())


def catrom_f64(x, scale):
    """(B, H, W, C) -> the catrom upscale in float64 (the benchmark's
    matrices, align_corners=False, no antialias)."""
    mh = resize_matrix(x.shape[1], x.shape[1] * scale, "catrom", False)
    mw = resize_matrix(x.shape[2], x.shape[2] * scale, "catrom", False)
    y = np.einsum("oh,bhwc->bowc", mh.astype(np.float64), x.astype(np.float64))
    return np.einsum("pw,bowc->bopc", mw.astype(np.float64), y)


@pytest.mark.parametrize("cls", [turbo.Turbo2x, turbo.Turbo4x])
def test_untrained_turbo_equals_catrom(cls):
    """The JAX init zeroes each block's second conv and the tail, so an
    untrained model is its fp32 catrom base (the offset crop keeps every
    tap inside the tile)."""
    model = turbo.init_untrained(cls(**SMALL), torch.Generator().manual_seed(5))
    assert float(model.stem.weight.detach().abs().max()) > 0
    x = np.random.default_rng(6).random((2, 48, 56, 3), dtype=np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=True).numpy()
    s, o = model.i2i_scale, model.i2i_offset
    want = catrom_f64(x, s)[:, o:48 * s - o, o:56 * s - o]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(64, 68), (32, 32), (130, 6)])
def test_stride2_symmetric_pad_equals_explicit_pad(hw):
    """On even sizes the stem's and base's symmetric pad 2 gives exactly
    the windows of flax's (2, 3) pad; on odd sizes it does not, and the
    model pads explicitly."""
    model, _jmodel, _params, _flat = make_pair("turbo_2x", seed=7)
    h, w = hw
    x = torch.from_numpy(np.random.default_rng(8).random(
        (2, 3, h, w), dtype=np.float32))
    padded = F.pad(x, (2, 3, 2, 3))
    sym = conv2d(x, model.stem, stride=2, padding=2)
    assert torch.equal(sym, conv2d(padded, model.stem, stride=2))
    base = F.conv2d(x, model.base_weight, stride=2, padding=2, groups=3)
    assert torch.equal(base, F.conv2d(padded, model.base_weight, stride=2,
                                      groups=3))
    odd = x[:, :, :h - 1, :w - 1]
    assert conv2d(odd, model.stem, stride=2, padding=2).shape != \
        conv2d(F.pad(odd, (2, 3, 2, 3)), model.stem, stride=2).shape


@pytest.mark.parametrize("k,stride,pad", [(4, 2, 3), (5, 3, 1), (3, 1, 1)])
def test_conv_transpose_torch_matches_jax(k, stride, pad):
    """The JAX kernel (k, k, in, out) is the forward kernel over the
    dilated input, not torch's transposed layout: an fp32 parity test sees
    a missing flip or in / out swap."""
    jmod = JaxConvT(5, k, stride=stride, padding=pad)
    rng = np.random.default_rng(9)
    kernel = rng.standard_normal((k, k, 7, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    x = rng.standard_normal((2, 9, 11, 7)).astype(np.float32)
    want = np.asarray(jmod.apply({"params": {"kernel": jnp.asarray(kernel),
                                             "bias": jnp.asarray(bias)}},
                                 jnp.asarray(x)))
    mod = ConvTranspose2dTorch(7, 5, k, stride=stride, padding=pad)
    from_flax(mod, {"kernel": kernel, "bias": bias})
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, (9 - 1) * stride + k - 2 * pad,
                                       (11 - 1) * stride + k - 2 * pad, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    flipped = ConvTranspose2dTorch(7, 5, k, stride=stride, padding=pad)
    from_flax(flipped, {"kernel": kernel[::-1, ::-1].copy(), "bias": bias})
    with torch.no_grad():
        bad = flipped(torch.from_numpy(x).permute(0, 3, 1, 2))
    if k > 1:
        assert np.abs(bad.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


@pytest.mark.parametrize("name", ["turbo_2x", "upconv_7"])
def test_nztm_round_trip_both_ways(name, tmp_path):
    model, jmodel, params, flat = make_pair(name, seed=10)
    x = np.random.default_rng(11).random((1, 48, 48, 3), dtype=np.float32)
    # JAX writes, the port loads
    jpath = str(tmp_path / "jax.nztm")
    jax_save_model(jmodel, params, jpath)
    loaded, meta = load_model(jpath, device="cpu")
    assert meta["name"] == model.model_name and type(loaded) is type(model)
    for key, arr in to_flax(loaded).items():
        np.testing.assert_array_equal(arr, flat[key], err_msg=key)
    with torch.no_grad():
        assert torch.equal(loaded(torch.from_numpy(x)), model(torch.from_numpy(x)))
    # the port writes, JAX loads
    ppath = str(tmp_path / "port.nztm")
    save_model(model, ppath)
    jloaded, jparams, jmeta = jax_load_model(ppath)
    assert type(jloaded) is type(jmodel) and jmeta["kwargs"] == meta["kwargs"]
    np.testing.assert_allclose(jax_apply(jloaded, jparams, x, train=False),
                               jax_apply(jmodel, params, x, train=False),
                               atol=0)


@pytest.mark.parametrize("name,hw,tile", [("turbo_2x", (70, 90), 64),
                                          ("turbo_4x", (70, 90), 64),
                                          ("upconv_7", (50, 60), 64)])
def test_frame_program_matches_jax(name, hw, tile):
    """The renderer over several tiles in fp32: turbo through the head-layout
    blend (factor 4 / 8) and one shuffle after quantizing, upconv_7 (no
    pre-shuffle head) at full resolution; uint8 frames equal JAX's."""
    model, jmodel, params, _flat = make_pair(name, seed=12, gain=0.3)
    h, w = hw
    frame = np.random.default_rng(13).integers(0, 256, (h, w, 3), dtype=np.uint8)
    renderer = tiling.TiledRenderer(model, policy=FP32_POLICY)
    cfg = tiling.make_tile_config(h, w, model.i2i_scale, model.i2i_offset,
                                  tile, model.i2i_blend_size)
    assert cfg.n_tiles > 1
    ps = renderer._ps_factor(cfg, (tile, tile))
    assert ps == getattr(model, "i2i_ps_factor", 1)
    got = renderer.frame_program(h, w, tile_size=tile, batch_size=3)(frame)
    jprog = jtiling.TiledRenderer(jmodel, params, policy=J_FP32) \
        .frame_program(h, w, tile_size=tile, batch_size=3)
    want = np.asarray(jprog(params, jnp.asarray(frame)))
    assert got.shape == want.shape == (h * model.i2i_scale, w * model.i2i_scale, 3)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999
