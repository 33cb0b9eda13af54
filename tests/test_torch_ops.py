"""Kernel twins and layout helpers of nunif_tpu_torch against the JAX package.

Inputs are made with numpy from a seed and given to both packages.  The JAX
Pallas kernels run in interpret mode on the CPU, as the JAX package's own
kernel tests run them; the port runs its plain PyTorch twins, which the
kernel wrappers take for CPU tensors.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nunif_tpu.modules import attention as jattn
from nunif_tpu.modules import permute as jperm
from nunif_tpu.ops.conv3x3 import stem_conv3x3 as jax_stem_conv3x3
from nunif_tpu.ops.swin_attention import \
    fused_swin_block_image as jax_swin_block_image

from nunif_tpu_torch.modules import attention as tattn
from nunif_tpu_torch.modules import permute as tperm
from nunif_tpu_torch.ops import _build
from nunif_tpu_torch.ops import conv3x3 as k2
from nunif_tpu_torch.ops import swin_attention as k1

TORCH_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.mark.parametrize("shape,cin,cout,crop,slope,strip", [
    ((2, 30, 46), 16, 24, 2, 0.1, 8),   # the JAX package's own kernel test
    ((1, 30, 30), 16, 24, 0, None, 4),  # no crop, no activation
    ((1, 30, 38), 48, 96, 6, 0.1, 8),   # patch_conv1's channels and crop
])
def test_stem_conv3x3_twin_matches_pallas(shape, cin, cout, crop, slope, strip):
    rng = np.random.default_rng(11)
    x = rng.normal(0, 0.5, shape + (cin,)).astype(np.float32)
    w = rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32)
    b = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    want = np.asarray(jax_stem_conv3x3(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), crop=crop,
        lrelu_slope=slope, strip=strip, interpret=True))
    got = k2.stem_conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), crop=crop, lrelu_slope=slope)
    assert got.shape == want.shape
    # fp32 sums of the same products in another order: the tolerance the
    # JAX package's own stem test uses
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_stem_conv3x3_twin_bf16_matches_pallas():
    rng = np.random.default_rng(12)
    x = rng.normal(0, 0.5, (1, 30, 38, 48)).astype(np.float32)
    w = rng.normal(0, 0.05, (3, 3, 48, 96)).astype(np.float32)
    b = rng.normal(0, 0.1, (96,)).astype(np.float32)
    want = np.asarray(jax_stem_conv3x3(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b), crop=6,
        lrelu_slope=0.1, interpret=True).astype(jnp.float32))
    got = k2.stem_conv3x3(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                          torch.from_numpy(b), crop=6, lrelu_slope=0.1)
    # both round one fp32 sum to bf16: at most one bf16 step (2^-8 relative)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


def _block_args(rng, c, heads):
    hid = 2 * c
    lec = lambda i, o: (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)  # noqa: E731
    bias = lambda o: rng.normal(0, 0.02, (o,)).astype(np.float32)  # noqa: E731
    ws = [lec(c, 3 * c), bias(3 * c), lec(c, c), bias(c), lec(c, hid),
          bias(hid), lec(hid, c), bias(c)]
    table = rng.normal(0, 0.02, (121, heads)).astype(np.float32)
    idx = jattn.relative_position_index(6, 6).reshape(-1)
    rel = table[idx].reshape(36, 36, heads).transpose(2, 0, 1).copy()
    return ws, rel


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("c,heads,shift,skip", [
    (96, 6, 0, False), (96, 6, 3, False), (96, 6, 0, True),
    (32, 2, 3, False), (32, 2, 0, True), (64, 2, 0, False), (64, 2, 3, False),
])
def test_swin_block_twin_matches_pallas(dtype, c, heads, shift, skip):
    """Port twin on the unpadded image vs the Pallas whole-block kernel
    (rowpack4, pad-shift, interpret mode), cropped back as the JAX caller
    crops it."""
    rng = np.random.default_rng(c + shift + int(skip))
    b, h, w, ws = 1, 24, 30, 6
    x = rng.normal(0, 0.5, (b, h, w, c)).astype(np.float32)
    sk = rng.normal(0, 0.5, (b, h, w, c)).astype(np.float32) if skip else None
    weights, rel = _block_args(rng, c, heads)
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    xj = jnp.asarray(x, jd)
    if shift:
        xj = jnp.pad(xj, ((0, 0), (shift, ws - shift), (shift, ws - shift),
                          (0, 0)))
    want = jax_swin_block_image(
        xj, *map(jnp.asarray, weights), jnp.asarray(rel), num_heads=heads,
        window=ws, shift=shift, attn_variant="rowpack4", shift_mode="pad",
        skip=None if sk is None else jnp.asarray(sk, jd), interpret=True)
    want = np.asarray(want.astype(jnp.float32))[:, shift:shift + h,
                                                 shift:shift + w]
    before = k1.fused_swin_block_image.launches
    got = k1.fused_swin_block_image(
        torch.from_numpy(x).to(td), *map(torch.from_numpy, weights),
        torch.from_numpy(rel), num_heads=heads, window=ws, shift=shift,
        skip=None if sk is None else torch.from_numpy(sk).to(td))
    assert k1.fused_swin_block_image.launches == before  # CPU: twin, no launch
    assert got.dtype == td and got.shape == (b, h, w, c)
    if dtype == "fp32":
        # fp32 sums in another order (measured <= 1.3e-6)
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    else:
        # six bf16 rounding points, and the Pallas kernel rounds unnormalised
        # probabilities where the twin rounds normalised ones: measured
        # <= 2.4e-2 at N(0, 0.5) inputs, i.e. a few bf16 steps of O(2) values
        np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_wrappers_route_cpu_to_twin_and_reject_other_devices():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 0.5, (1, 12, 12, 32)).astype(np.float32))
    weights, rel = _block_args(rng, 32, 2)
    args = [torch.from_numpy(a) for a in weights] + [torch.from_numpy(rel)]
    kw = dict(num_heads=2, window=6, shift=3)
    torch.testing.assert_close(k1.fused_swin_block_image(x, *args, **kw),
                               k1.swin_block_image_plain(x, *args, **kw),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unshifted"):
        k1.fused_swin_block_image(x, *args, num_heads=2, window=6, shift=3,
                                  skip=x)
    meta = torch.empty((1, 12, 12, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.fused_swin_block_image(meta, *args, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        k2.stem_conv3x3(meta, torch.zeros((3, 3, 32, 32)), torch.zeros(32))


def test_relative_bias_and_masks_match_jax():
    rng = np.random.default_rng(4)
    table = rng.normal(0, 0.02, (121, 6)).astype(np.float32)
    np.testing.assert_array_equal(tattn.relative_position_index(6, 6),
                                  jattn.relative_position_index(6, 6))
    np.testing.assert_allclose(
        tattn.expand_relative_bias(torch.from_numpy(table), 6).numpy(),
        np.asarray(jattn.expand_relative_bias(jnp.asarray(table), 6)),
        atol=1e-7)
    for h, w in ((12, 18), (6, 30), (24, 24)):
        np.testing.assert_array_equal(tattn.shifted_window_mask(h, w, 6, 3),
                                      jattn.shifted_window_mask(h, w, 6, 3))


def test_permute_ops_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, 18, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tperm.pixel_shuffle(torch.from_numpy(x), 2).numpy(),
        np.asarray(jperm.pixel_shuffle(jnp.asarray(x), 2)))
    wins = tperm.window_partition(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(
        wins.numpy(), np.asarray(jperm.window_partition(jnp.asarray(x), 6)))
    np.testing.assert_array_equal(
        tperm.window_reverse(wins, 6, 12, 18).numpy(), x)


def test_block_module_caches_relative_bias_per_weight_load():
    blk = tattn.SwinTransformerBlock(32, 2, 6, shift_size=3)
    first = blk.attn.relative_bias()
    assert blk.attn.relative_bias() is first
    with torch.no_grad():
        blk.attn.relative_position_bias_table.add_(1.0)
    second = blk.attn.relative_bias()
    assert second is not first
    torch.testing.assert_close(second, first + 1.0)
    # a LayerNorm block keeps the same cache in its attention module (K4)
    ln = tattn.SwinTransformerBlock(32, 2, 6, norm="layernorm")
    assert ln.attn.relative_bias() is ln.attn.relative_bias()


def test_block_module_packs_kernel_weights_per_weight_load():
    blk = tattn.SwinTransformerBlock(32, 2, 6, shift_size=3)
    first = blk.packed_weights(torch.bfloat16)
    assert blk.packed_weights(torch.bfloat16) is first
    fc2 = blk.mlp.fc2.weight
    torch.testing.assert_close(
        first.mats[3], _build.wgmma_weight_layout(fc2.detach().t().bfloat16(),
                                                  k1.chunk_width(32, 64)),
        rtol=0, atol=0)
    assert all(b.dtype == torch.float32 for b in first.biases)
    with torch.no_grad():
        fc2.mul_(2.0)
    second = blk.packed_weights(torch.bfloat16)
    assert second is not first
    torch.testing.assert_close(second.mats[3].float(), 2 * first.mats[3].float(),
                               rtol=0, atol=0)
    fp32 = blk.packed_weights(torch.float32)
    assert fp32.dtype == torch.float32
    torch.testing.assert_close(fp32.mats[0], blk.attn.qkv.weight.detach().t(),
                               rtol=0, atol=0)
    torch.testing.assert_close(fp32.rel_bias, blk.attn.relative_bias(), rtol=0,
                               atol=0)
    # the twin computes from the raw weights whether or not packed is given
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 0.5, (1, 12, 12, 32)).astype(np.float32))
    kw = dict(num_heads=2, window=6, shift=3)
    torch.testing.assert_close(
        k1.fused_swin_block_image(x, *blk._weights(), packed=fp32, **kw),
        k1.swin_block_image_plain(x, *blk._weights(), **kw), rtol=0, atol=0)
