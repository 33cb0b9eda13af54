"""waifu2x.swin_unet_2x of nunif_tpu_torch against the JAX package, whole
model, on the CPU (the tiled renderer: tests/test_torch_render.py).

Both packages get the same seeded "tamed" weights (numpy): at default
random init swin_unet is chaotic and a comparison would compare noise, so
the fc2 / attn.proj / to_image kernels are scaled down and the head bias
lifted (``tamed_flax_params``), which keeps the output inside (0, 1).
JAX parameters come from the port's flax-layout arrays, not from a JAX init.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.core.dtypes import BF16_POLICY as J_BF16, FP32_POLICY as J_FP32
from nunif_tpu.models import unflatten_params
from nunif_tpu.waifu2x.models import SwinUNet2x as JaxSwinUNet2x

from nunif_tpu_torch.core.dtypes import BF16_POLICY, FP32_POLICY
from nunif_tpu_torch.models import from_flax, model_kwargs, to_flax
from nunif_tpu_torch.waifu2x.models.swin_unet import (SwinUNet2x,
                                                      tamed_flax_params)

POLICIES = {"fp32": (FP32_POLICY, J_FP32), "bf16": (BF16_POLICY, J_BF16)}


@pytest.fixture(scope="module")
def pair():
    model = SwinUNet2x(base_dim=32)
    flat = tamed_flax_params(model, seed=0)
    from_flax(model, flat)
    model.eval().requires_grad_(False)
    jmodel = JaxSwinUNet2x(base_dim=32)
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    return model, jmodel, params


def test_param_tree_and_kwargs_match_jax(pair):
    model, jmodel, _params = pair
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    jflat = {"/".join(p.key for p in path): leaf.shape for path, leaf in
             jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    assert {k: v.shape for k, v in to_flax(model).items()} == jflat
    from nunif_tpu.models import model_kwargs as jax_model_kwargs
    assert model_kwargs(model) == jax_model_kwargs(jmodel)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_model_matches_jax(pair, dtype):
    model, jmodel, params = pair
    x = np.random.default_rng(1).random((1, 64, 64, 3), dtype=np.float32)
    td = POLICIES[dtype][0].compute_dtype
    jd = POLICIES[dtype][1].compute_dtype
    want = np.asarray(jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, train=True))(params, jnp.asarray(x, jd))
        .astype(jnp.float32))
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(td), train=True).float().numpy()
    assert got.shape == want.shape == (1, 96, 96, 3)
    assert 0.0 < want.min() and want.max() < 1.0  # tamed: no clipping
    if dtype == "fp32":
        # pre-clip output; fp32 sums in another order (measured 1.2e-7)
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        # bf16 rounds at other points in the two packages' plain layers
        # (flax rounds the matmul and then the bias add): measured 3.9e-3,
        # one bf16 step at these magnitudes
        np.testing.assert_allclose(got, want, atol=1e-2)


def test_layer_norm_model_matches_jax():
    """layer_norm=True builds LayerNorm blocks (K4 attention) and matches
    the JAX model in fp32."""
    model = SwinUNet2x(base_dim=32, layer_norm=True)
    flat = tamed_flax_params(model, seed=1)
    from_flax(model, flat)
    model.eval().requires_grad_(False)
    jmodel = JaxSwinUNet2x(base_dim=32, layer_norm=True)
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    assert "unet/swin1/block0/norm1/scale" in flat
    x = np.random.default_rng(2).random((1, 64, 64, 3), dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, train=True))(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=True).numpy()
    assert got.shape == want.shape == (1, 96, 96, 3)
    assert 0.0 < want.min() and want.max() < 1.0  # tamed: no clipping
    np.testing.assert_allclose(got, want, atol=1e-4)


def _stem_conv0_pair(seed):
    """patch_conv0's inputs (bf16-exact image, weights, a bias at std 4)
    and the JAX module's bf16 output; at std 4 a bias rounded to bf16 moves
    about half of the outputs by a rounding step."""
    from nunif_tpu.waifu2x.models.swin_unet import Im2ColConv3x3 as JaxConv
    rng = np.random.default_rng(seed)
    x = rng.random((1, 40, 52, 3), dtype=np.float32)
    kern = rng.normal(0, 0.2, (3, 3, 3, 48)).astype(np.float32)
    bias = rng.normal(0, 4.0, (48,)).astype(np.float32)
    want = np.asarray(JaxConv(48).apply(
        {"params": {"kernel": jnp.asarray(kern), "bias": jnp.asarray(bias)}},
        jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    return x, kern, bias, want


def _bit_equal_share(got, want):
    assert got.shape == want.shape
    return float((got == want).mean())


def test_stem_conv0_bf16_bias_rounds_once_as_jax():
    """The cin = 3 stem conv in bf16 against the JAX module: fp32 sums of
    the bf16 operands, the fp32 bias, one rounding.  The two sum the same
    products in another order, so a rare output lands one rounding step
    apart: >= 99% bit-equal and at most one bf16 step (2^-7 relative).  The
    control, the earlier port's bias rounded to bf16 before the conv, must
    fail the same check."""
    from nunif_tpu_torch.waifu2x.models.swin_unet import Conv3x3
    x, kern, bias, want = _stem_conv0_pair(7)
    conv = Conv3x3(3, 48)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kern).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(x).bfloat16()
        got = conv(xt)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        assert _bit_equal_share(got, want) >= 0.99
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
        # control: the bias rounded to bf16 first, as the port did before
        old = torch.nn.functional.conv2d(
            xt.permute(0, 3, 1, 2), conv.weight.bfloat16(),
            conv.bias.bfloat16()).permute(0, 2, 3, 1).float().numpy()
    assert _bit_equal_share(old, want) < 0.99
