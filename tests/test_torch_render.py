"""nunif_tpu_torch's tiled renderer against the JAX package's, driving
waifu2x.swin_unet_2x on the CPU: frame_program (multi-tile pre-shuffle blend,
frame_batch, the single-tile path), render and simple_render.

Both packages get the same seeded "tamed" weights (numpy), as in
tests/test_torch_swin_unet.py: at default random init swin_unet is chaotic
and a comparison would compare noise.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nunif_tpu.core.dtypes import BF16_POLICY as J_BF16, FP32_POLICY as J_FP32
from nunif_tpu.models import unflatten_params
from nunif_tpu.utils import tiling as jtiling
from nunif_tpu.waifu2x.models import SwinUNet2x as JaxSwinUNet2x

from nunif_tpu_torch.core.dtypes import BF16_POLICY, FP32_POLICY
from nunif_tpu_torch.models import from_flax
from nunif_tpu_torch.utils import tiling
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


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_frame_program_matches_jax(pair, dtype):
    """40x56 uint8 frame at tile 64: two tiles, pre-shuffle blend."""
    model, jmodel, params = pair
    policy, jpolicy = POLICIES[dtype]
    frame = np.random.default_rng(2).integers(0, 256, (40, 56, 3),
                                              dtype=np.uint8)
    jprog = jtiling.TiledRenderer(jmodel, params, policy=jpolicy) \
        .frame_program(40, 56, tile_size=64, batch_size=4)
    want = np.asarray(jprog(params, jnp.asarray(frame)))
    renderer = tiling.TiledRenderer(model, policy=policy)
    got = renderer.frame_program(40, 56, tile_size=64, batch_size=4)(frame)
    assert got.dtype == torch.uint8 and got.shape == want.shape == (80, 112, 3)
    got = got.numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    if dtype == "fp32":
        # quantization can flip where the fp32 sums differ in the last bit
        assert (diff == 0).mean() >= 0.999 and diff.max() <= 1
    else:
        assert _psnr(got, want) >= 50.0  # the repo's uint8 parity bar


def test_render_matches_jax_fp32(pair):
    """Float render at tile 64 (full-resolution blend, two tiles)."""
    model, jmodel, params = pair
    x = np.random.default_rng(3).random((40, 56, 3), dtype=np.float32)
    want = np.asarray(jtiling.TiledRenderer(jmodel, params, policy=J_FP32)
                      .render(x, tile_size=64, batch_size=4))
    got = tiling.TiledRenderer(model, policy=FP32_POLICY).render(
        x, tile_size=64, batch_size=4)
    assert got.shape == want.shape == (80, 112, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_simple_render_matches_jax_fp32(pair):
    model, jmodel, params = pair
    x = np.random.default_rng(4).random((1, 48, 48, 3), dtype=np.float32)
    want = np.asarray(jtiling.simple_render(jnp.asarray(x), jmodel, params,
                                            policy=J_FP32))
    got = tiling.simple_render(torch.from_numpy(x), model, policy=FP32_POLICY)
    assert got.shape == want.shape == (1, 96, 96, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_frame_batch_equals_single_frames(pair):
    model, _jmodel, _params = pair
    frames = np.random.default_rng(5).integers(0, 256, (2, 40, 56, 3),
                                               dtype=np.uint8)
    renderer = tiling.TiledRenderer(model, policy=FP32_POLICY)
    batched = renderer.frame_program(40, 56, tile_size=64, batch_size=4,
                                     frame_batch=2)(frames)
    single = renderer.frame_program(40, 56, tile_size=64, batch_size=4)
    assert batched.shape == (2, 80, 112, 3)
    for i in range(2):
        assert torch.equal(batched[i], single(frames[i]))


def test_single_tile_preshuffle_matches_render(pair):
    """n_tiles == 1 skips the canvas (the blend weights cancel exactly);
    frame_program's pre-shuffle reorder after quantizing equals quantizing
    the shuffled float render."""
    model, _jmodel, _params = pair
    frame = np.random.default_rng(6).integers(0, 256, (20, 24, 3),
                                              dtype=np.uint8)
    renderer = tiling.TiledRenderer(model, policy=FP32_POLICY)
    one = renderer.frame_program(20, 24, tile_size=64)
    assert tiling.make_tile_config(20, 24, 2, 16, 64, 8).n_tiles == 1
    x = torch.from_numpy(frame).float() / 255.0
    ref = renderer.render(x, tile_size=64)
    torch.testing.assert_close(one(frame), torch.round(ref * 255).to(torch.uint8),
                               rtol=0, atol=1)
