"""K6 (window attention on qkv in image layout) of nunif_tpu_torch against
the JAX package, on the CPU: the port of
``tests/test_pallas_attention.py:test_image_kernel_matches_xla_path``.

Inputs are made with numpy from a seed and given to both packages; the
JAX Pallas kernel runs in interpret mode, the port its plain twin (the K6
wrapper takes it for CPU tensors).  Tolerance: fp32 2e-5, the JAX
package's own bound for its window-attention kernels.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.modules.attention import (ShiftedWindowAttention,
                                         relative_position_index)
from nunif_tpu.ops.swin_attention import \
    fused_window_attention_image as jax_window_attention_image

from nunif_tpu_torch.modules.permute import window_partition2
from nunif_tpu_torch.ops import swin_attention as kernels

ATOL = 2e-5
B, H, W, C, HEADS, WS = 2, 18, 30, 48, 6, 6


def _rel_bias(table):
    n = WS * WS
    idx = relative_position_index(WS, WS).reshape(-1)
    return np.asarray(table)[idx].reshape(n, n, HEADS).transpose(2, 0, 1).copy()


@pytest.mark.parametrize("shift", [0, 3])
def test_image_twin_matches_pallas(shift):
    rng = np.random.default_rng(30 + shift)
    qkv = rng.standard_normal((B, H, W, 3 * C)).astype(np.float32)
    bias = _rel_bias(rng.standard_normal(((2 * WS - 1) ** 2, HEADS)))
    bias = bias.astype(np.float32)
    kw = dict(num_heads=HEADS, window=WS, shift=shift)
    want = np.asarray(jax_window_attention_image(
        jnp.asarray(qkv), jnp.asarray(bias), interpret=True, **kw))
    before = kernels.fused_window_attention_image.launches
    got = kernels.fused_window_attention_image(torch.from_numpy(qkv),
                                               torch.from_numpy(bias), **kw)
    assert kernels.fused_window_attention_image.launches == before
    assert got.dtype == torch.float32 and got.shape == (B, H, W, C)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("ws,shift,c,heads", [
    (7, 0, 64, 2), (7, 3, 96, 3), (8, 4, 64, 2), (8, 0, 64, 4)])
def test_image_twin_matches_pallas_windows_7_and_8(ws, shift, c, heads):
    """Windows of 49 (imagenet swin_t's window 7, head dim 32) and 64
    tokens, which the JAX kernel packs two to a 128-token pass."""
    rng = np.random.default_rng(40 + ws + shift)
    h, w, n = 2 * ws, 4 * ws, ws * ws
    qkv = rng.standard_normal((1, h, w, 3 * c)).astype(np.float32)
    table = rng.standard_normal(((2 * ws - 1) ** 2, heads))
    idx = relative_position_index(ws, ws).reshape(-1)
    bias = table[idx].reshape(n, n, heads).transpose(2, 0, 1).astype(np.float32)
    kw = dict(num_heads=heads, window=ws, shift=shift)
    want = np.asarray(jax_window_attention_image(
        jnp.asarray(qkv), jnp.asarray(bias), interpret=True, **kw))
    got = kernels.fused_window_attention_image(torch.from_numpy(qkv),
                                               torch.from_numpy(bias), **kw)
    assert got.shape == (1, h, w, c)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("shift", [0, 3])
def test_image_twin_matches_xla_module_path(shift):
    """As the JAX package's own test: roll, qkv projection, K6, proj, roll
    back, against the unfused module."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    attn = ShiftedWindowAttention(dim=C, num_heads=HEADS, window_size=WS,
                                  shift_size=shift, fused=False)
    params = attn.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(attn.apply(params, jnp.asarray(x)))
    p = jax.tree_util.tree_map(np.asarray, params["params"])
    xs = np.roll(x, (-shift, -shift), axis=(1, 2)) if shift else x
    qkv = xs @ p["qkv"]["kernel"] + p["qkv"]["bias"]
    out = kernels.fused_window_attention_image(
        torch.from_numpy(qkv), torch.from_numpy(
            _rel_bias(p["relative_position_bias_table"]).astype(np.float32)),
        num_heads=HEADS, window=WS, shift=shift).numpy()
    out = out @ p["proj"]["kernel"] + p["proj"]["bias"]
    if shift:
        out = np.roll(out, (shift, shift), axis=(1, 2))
    np.testing.assert_allclose(out, want, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_image_twin_is_window_twin_after_partition(dtype):
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((B, H, W, 3 * C))
                           .astype(np.float32)).to(dtype)
    bias = torch.from_numpy(_rel_bias(rng.standard_normal(
        ((2 * WS - 1) ** 2, HEADS))).astype(np.float32))
    img = kernels.fused_window_attention_image(qkv, bias, num_heads=HEADS,
                                               window=WS, shift=3)
    win = kernels.fused_window_attention(
        window_partition2(qkv, WS), bias, num_heads=HEADS, window=WS, shift=3,
        n_wh=H // WS, n_ww=W // WS)
    assert img.dtype == dtype
    torch.testing.assert_close(window_partition2(img, WS), win, rtol=0,
                               atol=0)


def test_image_wrapper_rejects_other_devices():
    meta = torch.empty((1, 6, 6, 3 * C), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.fused_window_attention_image(
            meta, torch.zeros(HEADS, 36, 36), num_heads=HEADS, window=WS,
            shift=0)
