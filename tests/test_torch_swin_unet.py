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


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="K4"):
        SwinUNet2x(base_dim=32, layer_norm=True)
