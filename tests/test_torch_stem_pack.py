"""K2's weight pack and its per-load cache, on the CPU.

The bf16 kernel reads its weights in wgmma's K-major B layout, one column
group after another (``ops/conv3x3.py:pack_stem_weights``).  The kernel
itself runs only on the card (tests/test_torch_cuda.py); here the layout is
held to its documented index formula, the module's cache to its key, and
the twin, which the wrapper takes for CPU tensors with or without a packed
argument, to the JAX package's Pallas kernel in interpret mode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nunif_tpu.ops.conv3x3 import stem_conv3x3 as jax_stem_conv3x3

from nunif_tpu_torch.ops import conv3x3 as k2
from nunif_tpu_torch.waifu2x.models.swin_unet import Im2ColConv3x3


def _kernel(cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.normal(0, 1 / np.sqrt(9 * cin), (3, 3, cin, cout)).astype(np.float32))


@pytest.mark.parametrize("cin,cout,nb", [(48, 96, 96), (96, 192, 96),
                                         (32, 32, 32)])
def test_pack_unpacks_by_index_formula(cin, cout, nb):
    kern = _kernel(cin, cout)
    packed = k2.pack_stem_weights(kern, torch.bfloat16)
    assert k2.column_group(cout) == nb
    assert packed.dtype == torch.bfloat16
    assert tuple(packed.shape) == (cout // nb, 9 * cin // 16, nb // 8, 2, 8, 8)
    # packed[h, ks, nb, kb, r, c] = W[16 ks + 8 kb + c, NB h + 8 nb + r]
    h, ks, n8, kb, r, c = np.indices(packed.shape)
    unpacked = torch.empty((9 * cin, cout), dtype=torch.bfloat16)
    unpacked[torch.from_numpy((16 * ks + 8 * kb + c).ravel()),
             torch.from_numpy((nb * h + 8 * n8 + r).ravel())] = packed.reshape(-1)
    want = kern.reshape(9 * cin, cout).bfloat16()
    assert torch.equal(unpacked, want)


def test_pack_fp32_is_the_plain_matrix():
    kern = _kernel(16, 48)
    packed = k2.pack_stem_weights(kern, torch.float32)
    assert torch.equal(packed, kern.reshape(144, 48))


@pytest.mark.parametrize("cout,nb", [(96, 96), (192, 96), (48, 48), (32, 32),
                                     (16, 16), (64, 32), (80, 16), (144, 48)])
def test_column_group_is_the_widest_that_divides(cout, nb):
    assert k2.column_group(cout) == nb


def test_module_cache_reused_and_rebuilt_after_weight_update():
    conv = Im2ColConv3x3(48, 96, crop=6, lrelu_slope=0.1)
    with torch.no_grad():
        conv.weight.copy_(_kernel(48, 96, seed=1).permute(3, 2, 0, 1))
        conv.bias.normal_()
    first = conv.packed_weights(torch.bfloat16)
    assert conv.packed_weights(torch.bfloat16) is first
    assert first[1].dtype == torch.float32
    assert torch.equal(first[1], conv.bias.detach())
    # another dtype is another entry
    assert conv.packed_weights(torch.float32)[0].dtype == torch.float32
    bf16 = conv.packed_weights(torch.bfloat16)
    assert bf16 is not first and torch.equal(bf16[0], first[0])
    # an in-place update (a weight load) rebuilds the pack
    with torch.no_grad():
        conv.weight.mul_(2.0)
    rebuilt = conv.packed_weights(torch.bfloat16)
    assert rebuilt is not bf16
    assert torch.equal(rebuilt[0], k2.pack_stem_weights(
        conv.weight.permute(2, 3, 1, 0), torch.bfloat16))
    assert conv.packed_weights(torch.bfloat16) is rebuilt
    with torch.no_grad():
        conv.bias.add_(1.0)
    assert torch.equal(conv.packed_weights(torch.bfloat16)[1],
                       conv.bias.detach())


@pytest.mark.parametrize("shape,cin,cout", [
    ((1, 30, 38), 96, 192),  # the 4xl's patch_conv1: two column groups
    ((1, 22, 85), 48, 96),   # Wo = 71: not a multiple of the 64-pixel tile
])
def test_twin_with_packed_matches_pallas(shape, cin, cout):
    rng = np.random.default_rng(13)
    x = rng.normal(0, 0.5, shape + (cin,)).astype(np.float32)
    w = rng.normal(0, 0.05, (3, 3, cin, cout)).astype(np.float32)
    b = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    want = np.asarray(jax_stem_conv3x3(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), crop=6,
        lrelu_slope=0.1, strip=8, interpret=True))
    kern = torch.from_numpy(w)
    packed = (k2.pack_stem_weights(kern, torch.float32), torch.from_numpy(b))
    got = k2.stem_conv3x3(torch.from_numpy(x), kern, torch.from_numpy(b),
                          crop=6, lrelu_slope=0.1, packed=packed)
    assert got.shape == want.shape
    # fp32 sums of the same products in another order (the JAX package's
    # own stem test tolerance)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_module_forward_matches_pallas_bf16():
    """Im2ColConv3x3 (the cached pack is taken on CUDA only) in bf16
    against the Pallas kernel in interpret mode: one rounding of an fp32
    sum on both sides, so at most one bf16 step apart."""
    rng = np.random.default_rng(14)
    x = rng.normal(0, 0.5, (1, 30, 38, 96)).astype(np.float32)
    w = rng.normal(0, 0.05, (3, 3, 96, 192)).astype(np.float32)
    b = rng.normal(0, 0.1, (192,)).astype(np.float32)
    want = np.asarray(jax_stem_conv3x3(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b), crop=6,
        lrelu_slope=0.1, interpret=True).astype(jnp.float32))
    conv = Im2ColConv3x3(96, 192, crop=6, lrelu_slope=0.1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(b))
        got = conv(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)
