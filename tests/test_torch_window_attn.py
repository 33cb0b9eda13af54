"""K4 (window attention on projected qkv) and the LayerNorm Swin path of
nunif_tpu_torch against the JAX package, on the CPU.

Inputs are made with numpy from a seed and given to both packages.  The JAX
Pallas kernel runs in interpret mode, as the JAX package's own kernel tests
run it; the port runs its plain twin, which the K4 wrapper takes for CPU
tensors.  Relative-position tables are drawn at std 1 (the init's 0.02 would
hide a dropped bias) and qkv at N(0, 1), the scale of layer-normed inputs.

The JAX package's LayerNorm blocks promote a bf16 stream to fp32 (flax
``LayerNorm(dtype=None)`` returns fp32), so its "bf16" model is an fp32
model; the port keeps the block in bf16 (fp32 statistics rounded once).  The
bf16 tests hold the port's bf16 output to JAX's (fp32) output within the
port's own bf16-vs-fp32 error, and assert JAX's dtype, so that a change of
the reference is noticed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from nunif_tpu.core.dtypes import BF16_POLICY as J_BF16, FP32_POLICY as J_FP32
from nunif_tpu.models import unflatten_params
from nunif_tpu.modules import attention as jattn
from nunif_tpu.ops.swin_attention import \
    fused_window_attention as jax_window_attention
from nunif_tpu.utils import tiling as jtiling
from nunif_tpu.waifu2x.models import SwinUNet4x as JaxSwinUNet4x

from nunif_tpu_torch.core.dtypes import BF16_POLICY, FP32_POLICY
from nunif_tpu_torch.models import from_flax, to_flax
from nunif_tpu_torch.modules import attention as tattn
from nunif_tpu_torch.modules.norm import LayerNorm
from nunif_tpu_torch.ops import swin_attention as kernels
from nunif_tpu_torch.utils import tiling
from nunif_tpu_torch.waifu2x.models.swin_unet import (SwinUNet4x,
                                                      tamed_flax_params)

# the JAX package's own bound for its window-attention kernel (fp32)
K4_ATOL = 2e-5


def _qkv_bias(rng, nw, ws, c, heads):
    n = ws * ws
    qkv = rng.standard_normal((nw, n, 3 * c)).astype(np.float32)
    table = rng.standard_normal(((2 * ws - 1) ** 2, heads)).astype(np.float32)
    idx = jattn.relative_position_index(ws, ws).reshape(-1)
    bias = table[idx].reshape(n, n, heads).transpose(2, 0, 1).copy()
    return qkv, bias


# (batch, n_wh, n_ww, window, shift, C, heads): odd window counts, heads of
# 16 and 32, one window row (every window is in the last row); windows 7
# (imagenet swin_t's: N = 49, head dim 32) and 8 (N = 64), the sizes past
# K4's 3-tile attention
CASES = [
    (1, 3, 5, 6, 0, 32, 2), (1, 3, 5, 6, 3, 32, 2), (2, 3, 3, 6, 3, 64, 2),
    (1, 3, 5, 4, 0, 32, 2), (1, 3, 5, 4, 3, 32, 1), (1, 1, 5, 6, 3, 32, 2),
    (1, 2, 3, 7, 0, 64, 2), (2, 2, 3, 7, 3, 96, 3), (1, 2, 2, 8, 4, 64, 2),
    (1, 2, 3, 8, 0, 64, 4),
]


@pytest.mark.parametrize("b,n_wh,n_ww,ws,shift,c,heads", CASES)
def test_window_attention_twin_matches_pallas(b, n_wh, n_ww, ws, shift, c,
                                              heads):
    rng = np.random.default_rng(ws + shift + c)
    nw = b * n_wh * n_ww
    qkv, bias = _qkv_bias(rng, nw, ws, c, heads)
    kw = dict(num_heads=heads, window=ws, shift=shift, n_wh=n_wh, n_ww=n_ww)
    want = np.asarray(jax_window_attention(jnp.asarray(qkv), jnp.asarray(bias),
                                           interpret=True, **kw))
    before = kernels.fused_window_attention.launches
    got = kernels.fused_window_attention(torch.from_numpy(qkv),
                                         torch.from_numpy(bias), **kw)
    assert kernels.fused_window_attention.launches == before  # CPU: the twin
    assert got.dtype == torch.float32 and got.shape == (nw, ws * ws, c)
    np.testing.assert_allclose(got.numpy(), want, atol=K4_ATOL)


def _attn_pair(rng, c, heads, ws, shift):
    port = tattn.ShiftedWindowAttention(c, heads, ws, shift)
    flat = {}
    for key, ref in to_flax(port).items():
        flat[key] = (rng.standard_normal(ref.shape) /
                     (np.sqrt(ref.shape[0]) if key.endswith("kernel") else 1.0)
                     ).astype(np.float32)
    from_flax(port, flat)
    jmod = jattn.ShiftedWindowAttention(c, heads, ws, shift, fused=False)
    return port, jmod, unflatten_params({k: jnp.asarray(v)
                                         for k, v in flat.items()})


@pytest.mark.parametrize("h,w,ws,shift", [
    (18, 30, 6, 0), (18, 30, 6, 3), (12, 20, 4, 0), (12, 20, 4, 3),
    (6, 6, 6, 3)])  # one window: the shift is dropped
def test_shifted_window_attention_matches_jax_module(h, w, ws, shift):
    """The port's module (image form; K4's twin) against the JAX module's
    unfused XLA path with the shifted_window_mask constant."""
    rng = np.random.default_rng(h + w + shift)
    port, jmod, params = _attn_pair(rng, 32, 2, ws, shift)
    x = rng.standard_normal((1, h, w, 32)).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=K4_ATOL)  # measured <= 1.5e-6
    # the window form gives the same as the image form on the rolled image
    xr = np.roll(x, (-shift, -shift), axis=(1, 2)) if (h > ws or w > ws) else x
    xw = xr.reshape(1, h // ws, ws, w // ws, ws, 32).transpose(0, 1, 3, 2, 4, 5)
    wants = np.asarray(jmod.apply({"params": params},
                                  jnp.asarray(xw.reshape(-1, ws * ws, 32)),
                                  windows=(1, h // ws, w // ws)))
    with torch.no_grad():
        gots = port(torch.from_numpy(xw.reshape(-1, ws * ws, 32)),
                    windows=(1, h // ws, w // ws)).numpy()
    np.testing.assert_allclose(gots, wants, atol=K4_ATOL)


@pytest.mark.parametrize("use_bias", [False, True])
def test_layer_norm_matches_flax(use_bias):
    """flax's epsilon (1e-6) and fast variance.  At a mean offset of 1 the
    fp32 sums of the two packages differ by ~5e-6; torch's default epsilon
    (1e-5) would miss by ~1e-4, which the control shows."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((4, 36, 64)) * 0.5 + 1.0).astype(np.float32)
    scale = rng.normal(1.0, 0.1, (64,)).astype(np.float32)
    params = {"scale": jnp.asarray(scale)}
    if use_bias:
        params["bias"] = jnp.asarray(rng.normal(0, 0.1, (64,)).astype(np.float32))
    jln = fnn.LayerNorm(use_bias=use_bias)
    want = np.asarray(jln.apply({"params": params}, jnp.asarray(x)))
    ln = LayerNorm(64, use_bias=use_bias)
    from_flax(ln, {k: np.array(v) for k, v in params.items()})
    with torch.no_grad():
        got = ln(torch.from_numpy(x))
        got_bf16 = ln(torch.from_numpy(x).bfloat16())
        torch_default = torch.nn.functional.layer_norm(
            torch.from_numpy(x), (64,), ln.weight, ln.bias)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert np.abs(torch_default.numpy() - want).max() > 4e-5
    assert got_bf16.dtype == torch.bfloat16  # one rounding, no promotion
    np.testing.assert_allclose(got_bf16.float().numpy(), want, atol=5e-2)


def _block_pair(rng, c, heads, shift, norm):
    port = tattn.SwinTransformerBlock(c, heads, 6, shift_size=shift, norm=norm)
    flat = {}
    for key, ref in to_flax(port).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            a = rng.standard_normal(ref.shape) / np.sqrt(ref.shape[0])
        elif leaf == "scale":
            a = rng.normal(1.0, 0.1, ref.shape)
        elif leaf == "relative_position_bias_table":
            a = rng.standard_normal(ref.shape)
        else:
            a = rng.normal(0.0, 0.1, ref.shape)
        flat[key] = a.astype(np.float32)
    from_flax(port, flat)
    jblock = jattn.SwinTransformerBlock(c, heads, 6, shift_size=shift,
                                        norm=norm)
    return port.eval(), jblock, unflatten_params(
        {k: jnp.asarray(v) for k, v in flat.items()})


@pytest.mark.parametrize("norm", ["layernorm_nobias", "layernorm"])
@pytest.mark.parametrize("shift,skip", [(0, False), (3, False), (3, True)])
def test_layer_norm_block_matches_jax(norm, shift, skip):
    rng = np.random.default_rng(shift + int(skip))
    port, jblock, params = _block_pair(rng, 32, 2, shift, norm)
    jflat = {"/".join(p.key for p in path): leaf.shape for path, leaf in
             jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {k: v.shape for k, v in to_flax(port).items()} == jflat
    x = rng.normal(0, 0.5, (1, 18, 24, 32)).astype(np.float32)
    sk = rng.normal(0, 0.5, x.shape).astype(np.float32) if skip else None
    want = np.asarray(jblock.apply(
        {"params": params}, jnp.asarray(x),
        skip=None if sk is None else jnp.asarray(sk)))
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   skip=None if sk is None else torch.from_numpy(sk)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_layer_norm_block_bf16_against_jax():
    rng = np.random.default_rng(5)
    port, jblock, params = _block_pair(rng, 32, 2, 3, "layernorm_nobias")
    x = rng.normal(0, 0.5, (1, 18, 24, 32)).astype(np.float32)
    jout = jblock.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    # the reference promotes the bf16 stream to fp32 (see module doc)
    assert jout.dtype == jnp.float32
    want = np.asarray(jout)
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16())
        fp32 = port(torch.from_numpy(x)).numpy()
    assert got.dtype == torch.bfloat16
    own = np.abs(got.float().numpy() - fp32).max()  # the port's bf16 error
    assert own < 0.1  # a few bf16 steps of O(4) values
    assert np.abs(got.float().numpy() - want).max() <= own + 1e-3


def test_wrapper_routes_cpu_to_twin_and_rejects_other_devices():
    rng = np.random.default_rng(3)
    qkv, bias = _qkv_bias(rng, 15, 6, 32, 2)
    kw = dict(num_heads=2, window=6, shift=3, n_wh=3, n_ww=5)
    q, b = torch.from_numpy(qkv), torch.from_numpy(bias)
    torch.testing.assert_close(kernels.fused_window_attention(q, b, **kw),
                               kernels.window_attention_plain(q, b, **kw),
                               rtol=0, atol=0)
    meta = torch.empty(q.shape, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.fused_window_attention(meta, b, **kw)


def test_block_norm_names_and_params():
    blk = tattn.SwinTransformerBlock(32, 2, 6, norm="layernorm")
    keys = set(to_flax(blk))
    assert {"norm1/scale", "norm1/bias", "norm2/scale", "norm2/bias"} <= keys
    assert "norm1/bias" not in to_flax(
        tattn.SwinTransformerBlock(32, 2, 6, norm="layernorm_nobias"))
    with pytest.raises(ValueError, match="norm"):
        tattn.SwinTransformerBlock(32, 2, 6, norm="batchnorm")


@pytest.fixture(scope="module")
def ln4x():
    model = SwinUNet4x(base_dim=32, layer_norm=True)
    flat = tamed_flax_params(model, seed=3)
    from_flax(model, flat)
    model.eval().requires_grad_(False)
    jmodel = JaxSwinUNet4x(base_dim=32, layer_norm=True)
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    return model, jmodel, params


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_frame_program_4x_layer_norm_matches_jax(ln4x, dtype):
    """40x56 uint8 frame at tile 64 through the 4x LayerNorm model: two
    tiles, the pre-shuffle blend at scale 4 (offset 32 divides by 4)."""
    model, jmodel, params = ln4x
    policy, jpolicy = {"fp32": (FP32_POLICY, J_FP32),
                       "bf16": (BF16_POLICY, J_BF16)}[dtype]
    frame = np.random.default_rng(2).integers(0, 256, (40, 56, 3),
                                              dtype=np.uint8)
    renderer = tiling.TiledRenderer(model, policy=policy)
    cfg = tiling.make_tile_config(40, 56, 4, 32, 64, 16)
    assert cfg.n_tiles == 2 and renderer._ps_factor(cfg, (64, 64)) == 4
    jprog = jtiling.TiledRenderer(jmodel, params, policy=jpolicy) \
        .frame_program(40, 56, tile_size=64, batch_size=4)
    want = np.asarray(jprog(params, jnp.asarray(frame)))
    got = renderer.frame_program(40, 56, tile_size=64, batch_size=4)(frame)
    assert got.dtype == torch.uint8 and got.shape == want.shape == (160, 224, 3)
    assert _psnr(got.numpy(), want) >= 50.0  # the repo's uint8 parity bar
