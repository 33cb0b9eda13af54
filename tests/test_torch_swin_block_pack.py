"""K1 / K5's weight pack and its per-load cache, on the CPU.

The bf16 kernel (csrc/swin_block.cu) reads each of a block's four matrices
in wgmma's K-major B layout, one column chunk of ``chunk_width(C, hidden)``
after another (``ops/swin_attention.py:pack_weights``), streamed into
shared memory by bulk copies.  The kernel itself runs only on the card
(tests/test_torch_cuda.py); here the layout is held to its documented index
formula, unpacking it gives back the bf16 weights, the block module's cache
to its key, and the twin fed with the weights read back from the pack to the
JAX package's K1 / K5 Pallas kernels in interpret mode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nunif_tpu.modules import attention as jattn
from nunif_tpu.ops.swin_attention import (
    fused_swin_block as jax_swin_block,
    fused_swin_block_image as jax_swin_block_image)

from nunif_tpu_torch.modules.attention import SwinTransformerBlock
from nunif_tpu_torch.ops import _build
from nunif_tpu_torch.ops import swin_attention as k1

NAMES = ("wqkv", "wproj", "wfc1", "wfc2")


def _weights(rng, c, heads, hidden=None):
    """Dense-shaped (in, out) matrices, fp32 biases and the (heads, 36, 36)
    relative bias (table at std 1, so that a dropped bias shows)."""
    hid = hidden or 2 * c
    lec = lambda i, o: (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)  # noqa: E731
    bias = lambda o: rng.normal(0, 0.02, (o,)).astype(np.float32)  # noqa: E731
    ws = [lec(c, 3 * c), bias(3 * c), lec(c, c), bias(c), lec(c, hid),
          bias(hid), lec(hid, c), bias(c)]
    table = rng.standard_normal((121, heads)).astype(np.float32)
    idx = jattn.relative_position_index(6, 6).reshape(-1)
    rel = table[idx].reshape(36, 36, heads).transpose(2, 0, 1).copy()
    return ws, rel


def _pack(ws, rel, dtype=torch.bfloat16):
    return k1.pack_weights(*map(torch.from_numpy, ws), torch.from_numpy(rel),
                           dtype)


def _unpack(packed):
    """(out / nb, in / 16, nb / 8, 2, 8, 8) -> the (in, out) matrix, by
    the inverse permutation of the pack."""
    h, ks, n8, _kb, _r, _c = packed.shape
    nb = 8 * n8
    return packed.permute(1, 3, 5, 0, 2, 4).reshape(16 * ks, h * nb)


@pytest.mark.parametrize("c,nb", [(96, 96), (192, 96)])
def test_pack_follows_index_formula(c, nb):
    ws, rel = _weights(np.random.default_rng(c), c, 6)
    packed = _pack(ws, rel)
    assert k1.chunk_width(c, 2 * c) == nb
    for name, w, m in zip(NAMES, ws[0::2], packed.mats):
        k, n = w.shape
        assert m.dtype == torch.bfloat16, name
        assert tuple(m.shape) == (n // nb, k // 16, nb // 8, 2, 8, 8), name
        assert m.is_contiguous() and m.data_ptr() % 32 == 0, name
        # packed[h, ks, n8, kb, r, c] = W[16 ks + 8 kb + c, nb h + 8 n8 + r]
        h, ks, n8, kb, r, cc = np.indices(m.shape)
        unpacked = torch.empty((k, n), dtype=torch.bfloat16)
        unpacked[torch.from_numpy((16 * ks + 8 * kb + cc).ravel()),
                 torch.from_numpy((nb * h + 8 * n8 + r).ravel())] = m.reshape(-1)
        assert torch.equal(unpacked, torch.from_numpy(w).bfloat16()), name
    # a k16 step of one column chunk is nb * 32 contiguous bytes: the piece
    # the kernel's bulk copies take starts at (h * K / 16 + ks) * nb * 16
    wqkv = packed.mats[0]
    flat = wqkv.reshape(-1)
    ksteps = c // 16
    start = (1 * ksteps + 2) * nb * 16
    assert torch.equal(flat[start:start + nb * 16].reshape(nb // 8, 2, 8, 8),
                       wqkv[1, 2])


@pytest.mark.parametrize("c,heads,hidden", [(96, 6, 192), (192, 6, 384),
                                            (32, 2, 64), (128, 2, 256),
                                            (48, 3, 96)])
def test_unpack_of_pack_is_the_bf16_weights(c, heads, hidden):
    ws, rel = _weights(np.random.default_rng(7), c, heads, hidden)
    packed = _pack(ws, rel)
    for name, w, m in zip(NAMES, ws[0::2], packed.mats):
        assert torch.equal(_unpack(m), torch.from_numpy(w).bfloat16()), name
    for b, pb in zip(ws[1::2], packed.biases):
        assert pb.dtype == torch.float32 and torch.equal(pb, torch.from_numpy(b))
    assert torch.equal(packed.rel_bias, torch.from_numpy(rel))
    # fp32: the plain (in, out) matrices
    fp32 = _pack(ws, rel, torch.float32)
    for w, m in zip(ws[0::2], fp32.mats):
        assert torch.equal(m, torch.from_numpy(w))


@pytest.mark.parametrize("c,hidden,nb", [(96, 192, 96), (192, 384, 96),
                                         (288, 576, 96), (96, 144, 16),
                                         (32, 64, 16), (128, 256, 16),
                                         (48, 96, 16)])
def test_chunk_width_is_96_where_both_widths_allow(c, hidden, nb):
    assert k1.chunk_width(c, hidden) == nb


def test_pack_is_the_shared_wgmma_layout():
    """K1's pack and K2's use one layout function."""
    ws, rel = _weights(np.random.default_rng(3), 96, 6)
    packed = _pack(ws, rel)
    for w, m in zip(ws[0::2], packed.mats):
        assert torch.equal(m, _build.wgmma_weight_layout(
            torch.from_numpy(w).bfloat16(), 96))


def test_module_cache_reused_and_rebuilt_after_weight_update():
    blk = SwinTransformerBlock(96, 6, 6, shift_size=3)
    first = blk.packed_weights(torch.bfloat16)
    assert blk.packed_weights(torch.bfloat16) is first
    assert tuple(first.mats[0].shape) == (3, 6, 12, 2, 8, 8)
    assert torch.equal(_unpack(first.mats[1]),
                       blk.attn.proj.weight.detach().t().bfloat16())
    # another dtype is another entry
    fp32 = blk.packed_weights(torch.float32)
    assert fp32.dtype == torch.float32 and fp32 is not first
    again = blk.packed_weights(torch.bfloat16)
    assert again is not first and torch.equal(again.mats[0], first.mats[0])
    # an in-place update (a weight load) rebuilds the pack
    with torch.no_grad():
        blk.mlp.fc1.weight.mul_(2.0)
    rebuilt = blk.packed_weights(torch.bfloat16)
    assert rebuilt is not again
    assert torch.equal(_unpack(rebuilt.mats[2]),
                       blk.mlp.fc1.weight.detach().t().bfloat16())
    assert blk.packed_weights(torch.bfloat16) is rebuilt


def _twin_weights(packed, ws):
    """The twin's weight arguments read back from a bf16 pack."""
    mats = [_unpack(m).float() for m in packed.mats]
    biases = [torch.from_numpy(b) for b in ws[1::2]]
    return [t for pair in zip(mats, biases) for t in pair]


# The twin on the weights read back from the pack, in bf16, against the
# Pallas kernels in interpret mode in fp32: both round at six points, and
# the Pallas kernel rounds unnormalised probabilities where the twin rounds
# normalised ones, so the port is held to the K1 CPU test's bound (3e-2 at
# N(0, 0.5) inputs, a few bf16 steps of O(2) values) and to fp32 1e-4 in
# fp32 on the same weights rounded to bf16.
@pytest.mark.parametrize("shift,skip", [(0, True), (3, False)])
def test_image_twin_from_pack_matches_pallas(shift, skip):
    rng = np.random.default_rng(20 + shift)
    c, heads, b, h, w, ws_ = 96, 6, 1, 12, 18, 6
    x = rng.normal(0, 0.5, (b, h, w, c)).astype(np.float32)
    sk = rng.normal(0, 0.5, (b, h, w, c)).astype(np.float32) if skip else None
    ws, rel = _weights(rng, c, heads)
    packed = _pack(ws, rel)
    mats_bf16 = [np.asarray(_unpack(m).float()) for m in packed.mats]
    jw = [mats_bf16[0], ws[1], mats_bf16[1], ws[3], mats_bf16[2], ws[5],
          mats_bf16[3], ws[7]]
    xj = jnp.asarray(x)
    if shift:
        xj = jnp.pad(xj, ((0, 0), (shift, ws_ - shift), (shift, ws_ - shift),
                          (0, 0)))
    want = jax_swin_block_image(
        xj, *map(jnp.asarray, jw), jnp.asarray(rel), num_heads=heads,
        window=ws_, shift=shift, attn_variant="rowpack4", shift_mode="pad",
        skip=None if sk is None else jnp.asarray(sk), interpret=True)
    want = np.asarray(want)[:, shift:shift + h, shift:shift + w]
    args = _twin_weights(packed, ws) + [torch.from_numpy(rel)]
    kw = dict(num_heads=heads, window=ws_, shift=shift)
    got32 = k1.fused_swin_block_image(
        torch.from_numpy(x), *args, skip=None if sk is None else torch.from_numpy(sk),
        packed=packed, **kw)
    np.testing.assert_allclose(got32.numpy(), want, atol=1e-4)
    got = k1.fused_swin_block_image(
        torch.from_numpy(x).bfloat16(), *args,
        skip=None if sk is None else torch.from_numpy(sk).bfloat16(),
        packed=packed, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


@pytest.mark.parametrize("mode", ["roll", "pad"])
def test_window_twin_from_pack_matches_pallas(mode):
    rng = np.random.default_rng(30)
    c, heads, n_wh, n_ww = 96, 6, 3, 4
    x = rng.normal(0, 0.5, (n_wh * n_ww, 36, c)).astype(np.float32)
    ws, rel = _weights(rng, c, heads)
    packed = _pack(ws, rel)
    mats_bf16 = [np.asarray(_unpack(m).float()) for m in packed.mats]
    jw = [mats_bf16[0], ws[1], mats_bf16[1], ws[3], mats_bf16[2], ws[5],
          mats_bf16[3], ws[7]]
    kw = dict(num_heads=heads, window=6, shift=3, n_wh=n_wh, n_ww=n_ww,
              shift_mode=mode)
    want = np.asarray(jax_swin_block(jnp.asarray(x), *map(jnp.asarray, jw),
                                     jnp.asarray(rel), interpret=True, **kw))
    args = _twin_weights(packed, ws) + [torch.from_numpy(rel)]
    got32 = k1.fused_swin_block(torch.from_numpy(x), *args, packed=packed, **kw)
    np.testing.assert_allclose(got32.numpy(), want, atol=1e-4)
    got = k1.fused_swin_block(torch.from_numpy(x).bfloat16(), *args,
                              packed=packed, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)
