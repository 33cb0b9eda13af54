"""Hand-written Hopper kernels against their plain PyTorch twins, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  On a machine
with a card, run (``--noconftest`` because tests/conftest.py imports JAX,
which the card's machine does not need):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: fp32 kernels sum the same fp32 products as the twins in another
order (atol 2e-4 on O(1) outputs).  bf16 kernels round at the same points as
the twins, so a difference is a rounding step flipped by the summation
order and its consequences downstream: at most 2^-7 relative at one
rounding, allowed as 1/64 relative + 1e-2 absolute (K2: one rounding) and
0.05 absolute (K1: six rounding points) at N(0, 0.5) inputs.

K1's relative-position bias table is drawn at std 1, not the model's init
std of 0.02: at 0.02 the bias moves the output by less than the bf16
tolerance, so a kernel that dropped it would pass.  A control holds the
kernel run without the bias against the twin run with it and requires the
comparison to fail.

K3 (warp) sums the twin's two non-zero fp32 products with the twin's
roundings: atol 1e-5 (measured 0); its control, the kernel given a zero
delta, must fail.  K7 (attention) rounds the unnormalised probabilities and
rescales online where the twin rounds normalised ones: abs 1e-2 and
relative L2 1e-2 (measured <= 7.8e-3 and 3.1e-3 at N(0, 1) inputs); its
controls must fail: the kernel given only the first N - 29 keys, which
shows that a ragged last key tile counts, and at one full key tile the
kernel given V with its rows permuted, which shows that V's transposed
operand layout counts.

K4 (window attention) rounds at the twin's two points (probabilities,
output): bf16 1/64 relative + 1e-2 absolute, fp32 2e-5 (the JAX package's
own bound) at N(0, 1) qkv.  Its controls: the kernel with the relative bias
zeroed must fail, and for a shifted grid the kernel run unshifted must fail,
which shows that the computed wrap mask counts.

K5 (K1 on window-ordered tokens) has K1's tolerances and controls, plus,
for a shifted grid, the kernel run with the other shift mode must fail.
K6 (K4 in image layout) has K4's.  The probes' tolerances are stated
beside their tests.
"""
import numpy as np
import pytest
import torch

from nunif_tpu_torch.ops import conv3x3 as k2
from nunif_tpu_torch.ops import sdpa as k7
from nunif_tpu_torch.ops import swin_attention as k1
from nunif_tpu_torch.modules import grid_sample as k3
from nunif_tpu_torch.modules.attention import expand_relative_bias

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a, device, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,cin,cout,crop,slope", [
    ((1, 30, 70, 0), 16, 32, 0, None),     # ragged tile edge, no crop/act
    ((2, 37, 131, 0), 48, 96, 6, 0.1),     # stem shape class, odd sizes
    ((1, 20, 20, 0), 32, 48, 2, 0.2),      # Cout not a multiple of 64
    ((1, 40, 150, 0), 96, 192, 6, 0.1),    # 4xl stem: two column groups, Wo 136
    ((1, 200, 300, 0), 48, 96, 6, 0.1),    # blocks walk several tiles and strips
    ((1, 20, 40, 0), 16, 80, 0, None),     # column group 16, Wo < one tile
])
def test_stem_conv3x3_kernel_matches_twin(cuda, dtype, shape, cin, cout, crop,
                                          slope):
    rng = _rng(0)
    b, h, w, _ = shape
    x = _t(rng.normal(0, 0.5, (b, h, w, cin)), cuda, dtype)
    kern = _t(rng.normal(0, 1 / np.sqrt(9 * cin), (3, 3, cin, cout)), cuda)
    bias = _t(rng.normal(0, 0.1, (cout,)), cuda)
    before = k2.stem_conv3x3.launches
    got = k2.stem_conv3x3(x, kern, bias, crop=crop, lrelu_slope=slope)
    torch.cuda.synchronize()
    assert k2.stem_conv3x3.launches == before + 1
    want = k2.stem_conv3x3_plain(x, kern, bias, crop=crop, lrelu_slope=slope)
    assert got.shape == want.shape == (b, h - 2 - 2 * crop, w - 2 - 2 * crop, cout)
    g, wt = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(g, wt, atol=2e-4, rtol=0)
    else:
        assert bool(((g - wt).abs() <= wt.abs() / 64 + 1e-2).all())


def test_stem_conv3x3_module_cached_pack_matches_raw(cuda):
    """The stem module passes weights packed once per weight load; the
    kernel must give the same output as from the raw weights, and a pack
    made for another dtype is refused."""
    from nunif_tpu_torch.waifu2x.models.swin_unet import Im2ColConv3x3
    torch.manual_seed(0)
    conv = Im2ColConv3x3(96, 192, crop=6, lrelu_slope=0.1).to(cuda)
    with torch.no_grad():
        conv.weight.normal_(0, 0.03)
        conv.bias.normal_(0, 0.1)
    x = _t(_rng(4).normal(0, 0.5, (1, 30, 90, 96)), cuda, torch.bfloat16)
    got = conv(x)
    assert conv.packed_weights(torch.bfloat16) is conv._packed
    kern = conv.weight.permute(2, 3, 1, 0)
    want = k2.stem_conv3x3(x, kern, conv.bias, crop=6, lrelu_slope=0.1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not packed for"):
        k2.stem_conv3x3(x, kern, conv.bias, crop=6,
                        packed=conv.packed_weights(torch.float32))


def _block_inputs(rng, c, heads, device):
    hid = 2 * c
    lec = lambda i, o: _t(rng.standard_normal((i, o)) / np.sqrt(i), device)  # noqa: E731
    bias = lambda o: _t(rng.normal(0, 0.02, (o,)), device)  # noqa: E731
    table = _t(rng.standard_normal((121, heads)), device)  # see module doc
    return (lec(c, 3 * c), bias(3 * c), lec(c, c), bias(c), lec(c, hid),
            bias(hid), lec(hid, c), bias(c), expand_relative_bias(table, 6))


K1_ATOL = {torch.bfloat16: 0.05, torch.float32: 2e-4}
# The bf16 kernel's tiles hold 7 windows at C = 96 (256 rows) and 3 at C =
# 192 (128 rows): 20 windows at C = 96 and 14 at C = 192 leave a ragged last
# tile at both sizes.
K1_CASES = [
    (1, 24, 30, 96, 6, 0, False),   # 20 windows: ragged last tile of 7
    (1, 24, 30, 96, 6, 3, False),
    (2, 18, 42, 96, 6, 0, True),   # batch 2, skip
    (1, 12, 18, 192, 6, 3, False),
    (1, 12, 42, 192, 6, 3, False),  # 14 windows: ragged last tile of 3
    (1, 6, 30, 32, 2, 3, False),   # one window row: wrap region in-window
    (1, 12, 12, 128, 2, 3, False),  # head_dim 64
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,c,heads,shift,skip", K1_CASES)
def test_swin_block_kernel_matches_twin(cuda, dtype, b, h, w, c, heads, shift,
                                        skip):
    rng = _rng(1)
    x = _t(rng.normal(0, 0.5, (b, h, w, c)), cuda, dtype)
    sk = _t(rng.normal(0, 0.5, (b, h, w, c)), cuda, dtype) if skip else None
    args = _block_inputs(rng, c, heads, cuda)
    kw = dict(num_heads=heads, window=6, shift=shift, skip=sk)
    before = k1.fused_swin_block_image.launches
    got = k1.fused_swin_block_image(x, *args, **kw)
    torch.cuda.synchronize()
    assert k1.fused_swin_block_image.launches == before + 1
    want = k1.swin_block_image_plain(x, *args, **kw)
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=K1_ATOL[dtype],
                               rtol=0)
    # control: the same comparison must see a kernel that drops the bias
    no_bias = k1.fused_swin_block_image(
        x, *args[:-1], torch.zeros_like(args[-1]), **kw)
    assert float((no_bias.float() - want.float()).abs().max()) > 4 * K1_ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_swin_block_module_packed_weights_match_raw(cuda, dtype):
    """The block module passes weights packed once per weight load; the
    kernel must give the same output as from the raw weights."""
    from nunif_tpu_torch.modules.attention import SwinTransformerBlock
    torch.manual_seed(0)
    blk = SwinTransformerBlock(96, 6, 6, shift_size=3).to(cuda)
    with torch.no_grad():
        blk.attn.relative_position_bias_table.normal_()
    x = _t(_rng(3).normal(0, 0.5, (1, 24, 30, 96)), cuda, dtype)
    got = blk(x)
    assert blk.packed_weights(dtype) is blk._packed
    want = k1.fused_swin_block_image(x, *blk._weights(), num_heads=6,
                                     window=6, shift=3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernels_reject_bad_inputs(cuda):
    x = torch.zeros((1, 20, 20, 24), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        k2.stem_conv3x3(x, torch.zeros((3, 3, 24, 32), device=cuda),
                        torch.zeros(32, device=cuda))
    with pytest.raises(TypeError):
        k2.stem_conv3x3(x.half(), torch.zeros((3, 3, 24, 32), device=cuda),
                        torch.zeros(32, device=cuda))
    x = torch.zeros((1, 12, 14, 32), device=cuda, dtype=torch.bfloat16)
    args = _block_inputs(_rng(2), 32, 2, cuda)
    with pytest.raises(ValueError, match="not a multiple of window"):
        k1.fused_swin_block_image(x, *args, num_heads=2, window=6, shift=0)
    x = torch.zeros((1, 12, 12, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="packed for"):
        k1.fused_swin_block_image(
            x, *args, num_heads=2, window=6, shift=0,
            packed=k1.pack_weights(*args, torch.float32))


# K3 at the iw3 path's shape (both eyes of 8 1080p frames), C from 1 to 8,
# a row whose bytes are not a multiple of 16 (W = 1001, C = 3: the copy
# loop), a row too wide for the ring (C = 8, W = 7680: segments with a
# halo of max_shift + 1) and W = 1; then the older small cases.
# (B, H, W, C, max_shift)
K3_PATH = (16, 1080, 1920, 3, 28)
K3_CASES = [K3_PATH] + [(2, 9, 640, c, 28) for c in range(1, 9)] + [
    (2, 5, 1001, 3, 28), (1, 3, 7680, 8, 28), (2, 3, 1, 3, 4),
    (3, 7, 45, 3, 9), (2, 5, 33, 8, 3), (1, 4, 20, 1, 28), (2, 9, 130, 5, 6)]


@pytest.mark.parametrize("b,h,w,c,max_shift", K3_CASES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_warp_kernel_matches_twin(cuda, b, h, w, c, max_shift, x_dtype):
    rng = _rng(4)
    x = _t(rng.random((b, h, w, c), dtype=np.float32), cuda, x_dtype)
    delta = _t(rng.uniform(-max_shift, max_shift, (b, h, w)).astype(np.float32),
               cuda)
    delta[0, 0, -3:] = max_shift   # gx clipped to W - 1
    delta[0, 1, -1] = 0.0          # gx exactly W - 1
    delta[0, 0, :3] = -max_shift   # gx clipped to 0
    before = k3.warp_x_bounded.launches
    got = k3.warp_x_bounded(x, delta, max_shift)
    torch.cuda.synchronize()
    assert k3.warp_x_bounded.launches == before + 1
    want = k3.warp_x_bounded_plain(x, delta, max_shift)
    assert got.shape == want.shape and got.dtype == x_dtype
    # the twin's two products with its roundings, in x's dtype: fp32 at
    # K3_ATOL (measured 0), bf16 the same value rounded once
    atol = 1e-5 if x_dtype == torch.float32 else 1 / 128
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    # control: the same check must see a kernel that moves nothing
    if w > 1:
        still = k3.warp_x_bounded(x, torch.zeros_like(delta), max_shift)
        assert float((still.float() - want.float()).abs().max()) > 10 * atol


def test_warp_kernel_takes_x_as_it_is(cuda, monkeypatch):
    """fp32 and bf16 x reach the library as they are, with no copy, and the
    output is x's dtype; on bf16 x the fp32 kernel's output rounds to it."""
    x = _t(_rng(5).random((2, 4, 64, 3), dtype=np.float32), cuda)
    delta = _t(_rng(6).uniform(-6, 6, (2, 4, 64)), cuda)
    seen = []
    real = k3.warp_x_bounded_kernel

    def spy(xk, dk, ms):
        seen.append((xk.data_ptr(), xk.dtype))
        return real(xk, dk, ms)

    monkeypatch.setattr(k3, "warp_x_bounded_kernel", spy)
    y32 = k3.warp_x_bounded(x, delta, 6)
    y16 = k3.warp_x_bounded(x.bfloat16(), delta, 6)
    assert seen[0] == (x.data_ptr(), torch.float32) and seen[1][1] == torch.bfloat16
    assert y32.dtype == torch.float32 and y16.dtype == torch.bfloat16
    assert torch.equal(y16, y32.bfloat16())
    half = k3.warp_x_bounded(x.half(), delta, 6)  # through an fp32 copy
    assert half.dtype == torch.float16
    torch.testing.assert_close(half, k3.warp_x_bounded_plain(x.half(), delta, 6),
                               atol=1e-3, rtol=0)


def _flash_inputs(seed, b, heads, n, m, d, device):
    rng = _rng(seed)
    return (_t(rng.standard_normal((b, heads, rows, d)), device, torch.bfloat16)
            for rows in (n, m, m))


def _flash_close(got, want):
    """K7's twin check: abs 1e-2 and relative L2 1e-2, both must hold."""
    diff = got.float() - want.float()
    return float(diff.abs().max()) <= 1e-2 and \
        float(diff.norm() / want.float().norm()) <= 1e-2


# the 128-row query tiles and 128-key tiles: edges at 127 / 128 / 129 and
# 255 / 257, N != M with both ragged, and ViT-L's 16 heads at the path's
# length
@pytest.mark.parametrize("b,heads,n,m,d", [
    (2, 3, 1, 1, 64), (1, 2, 37, 37, 64), (2, 2, 63, 63, 64),
    (1, 1, 64, 64, 64), (2, 3, 65, 65, 64), (1, 2, 197, 197, 64),
    (1, 2, 100, 37, 64), (2, 6, 1373, 1373, 64),
    (1, 2, 127, 127, 64), (1, 2, 128, 128, 64), (1, 2, 129, 129, 64),
    (1, 2, 255, 255, 64), (1, 2, 257, 257, 64), (2, 3, 300, 129, 64),
    (2, 3, 129, 300, 64), (2, 16, 1373, 1373, 64)])
def test_flash_kernel_matches_twin(cuda, b, heads, n, m, d):
    q, k, v = _flash_inputs(5, b, heads, n, m, d, cuda)
    before = k7.sdpa.launches
    got = k7.sdpa(q, k, v)
    torch.cuda.synchronize()
    assert k7.sdpa.launches == before + 1
    want = k7.sdpa_plain(q, k, v)
    assert got.shape == want.shape == (b, heads, n, d)
    assert _flash_close(got, want)
    if m > 29:
        cut = k7.sdpa(q, k[:, :, :m - 29], v[:, :, :m - 29])
        assert not _flash_close(cut, want)


def test_flash_kernel_permuted_v_fails(cuda):
    """V is read as an MN-major (transposed) B operand: at one full key
    tile, the kernel given V with its rows permuted must fail the check
    that the kernel given V passes."""
    q, k, v = _flash_inputs(7, 1, 2, 128, 128, 64, cuda)
    want = k7.sdpa_plain(q, k, v)
    assert _flash_close(k7.sdpa(q, k, v), want)
    perm = torch.from_numpy(_rng(8).permutation(128)).to(cuda)
    assert not _flash_close(k7.sdpa(q, k, v[:, :, perm].contiguous()), want)


def test_flash_kernel_reads_strided_qkv(cuda):
    """q, k, v as views of a (B, N, 3, H, d) projection, as DINOv2's
    attention passes them: the same result as from contiguous copies."""
    from nunif_tpu_torch.iw3.depth.dinov2 import Attention
    rng = _rng(6)
    qkv = _t(rng.standard_normal((2, 200, 3, 6, 64)), cuda, torch.bfloat16)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    got = k7.sdpa(q, k, v)
    want = k7.sdpa(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)
    attn = Attention(384, 6).to(cuda)
    x = _t(rng.standard_normal((2, 200, 384)), cuda, torch.bfloat16)
    before = k7.sdpa.launches
    with torch.no_grad():
        y = attn(x)
        saved = k7.sdpa
        k7.sdpa = k7.sdpa_plain
        try:
            y_twin = attn(x)
        finally:
            k7.sdpa = saved
    assert k7.sdpa.launches == before + 1
    torch.testing.assert_close(y.float(), y_twin.float(), atol=5e-2, rtol=0)


def test_iw3_kernels_reject_bad_inputs(cuda, monkeypatch):
    x = torch.zeros((1, 4, 16, 9), device=cuda)
    with pytest.raises(ValueError, match="C <= 8"):
        k3.warp_x_bounded(x, torch.zeros((1, 4, 16), device=cuda), 4)
    x = torch.zeros((1, 4, 16, 3), device=cuda)
    with pytest.raises(ValueError, match="delta"):
        k3.warp_x_bounded(x, torch.zeros((1, 4, 15), device=cuda), 4)
    with monkeypatch.context() as mp:
        mp.setattr(k3.dtypes, "IMAGE_DTYPE", torch.float32)
        with pytest.raises(TypeError, match="bfloat16"):
            k3.warp_x_bounded(x, torch.zeros((1, 4, 16), device=cuda), 4)
    q = torch.zeros((1, 2, 10, 64), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        k7.sdpa(q, q, q)
    for d in (40, 128):
        q = torch.zeros((1, 2, 10, d), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            k7.sdpa(q, q, q)
    q = torch.zeros((1, 2, 10, 68), device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="strides"):
        k7.sdpa(q, q, q)


K4_TOL = {torch.bfloat16: (1 / 64, 1e-2), torch.float32: (0.0, 2e-5)}
# (batch, n_wh, n_ww, window, shift, C, heads): head dims 16 and 32 (the
# 4xl's), window 4 (N = 16, one query tile), a single window row; window 7
# (N = 49: imagenet swin_t's stages, head dim 32, one window with a wrap
# mask) and window 8 (N = 64), which take the 4-tile attention
K4_CASES = [
    (1, 3, 5, 6, 0, 192, 12), (1, 3, 5, 6, 3, 192, 12),
    (2, 3, 4, 6, 3, 384, 12), (1, 4, 4, 4, 2, 64, 4), (1, 1, 5, 6, 3, 32, 2),
    (2, 2, 3, 7, 0, 96, 3), (1, 2, 3, 7, 3, 192, 6), (1, 1, 1, 7, 3, 768, 24),
    (1, 2, 2, 8, 4, 64, 2), (1, 3, 3, 8, 0, 128, 4),
]


def _k4_inputs(rng, nw, ws, c, heads, device, dtype):
    n = ws * ws
    qkv = _t(rng.standard_normal((nw, n, 3 * c)), device, dtype)
    table = _t(rng.standard_normal(((2 * ws - 1) ** 2, heads)), device)
    return qkv, expand_relative_bias(table, ws)


def _k4_close(got, want, dtype):
    rel, atol = K4_TOL[dtype]
    d = (got.float() - want.float()).abs()
    return bool((d <= want.float().abs() * rel + atol).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n_wh,n_ww,ws,shift,c,heads", K4_CASES)
def test_window_attn_kernel_matches_twin(cuda, dtype, b, n_wh, n_ww, ws, shift,
                                         c, heads):
    nw = b * n_wh * n_ww
    qkv, bias = _k4_inputs(_rng(7), nw, ws, c, heads, cuda, dtype)
    kw = dict(num_heads=heads, window=ws, shift=shift, n_wh=n_wh, n_ww=n_ww)
    before = k1.fused_window_attention.launches
    got = k1.fused_window_attention(qkv, bias, **kw)
    torch.cuda.synchronize()
    assert k1.fused_window_attention.launches == before + 1
    want = k1.window_attention_plain(qkv, bias, **kw)
    assert got.shape == want.shape == (nw, ws * ws, c) and got.dtype == dtype
    assert _k4_close(got, want, dtype)
    # controls: the same check must see a dropped bias and a dropped mask
    assert not _k4_close(k1.fused_window_attention(
        qkv, torch.zeros_like(bias), **kw), want, dtype)
    if shift:
        assert not _k4_close(k1.fused_window_attention(
            qkv, bias, **dict(kw, shift=0)), want, dtype)


# The bf16 kernel's instantiations that K4_CASES leave out: window 8 at head
# dims 16 and 32 with 12 and 6 heads a group (the bias does not fit beside
# the ring and is read from L2), window 5 (a run-time N) and head dims 48
# and 64 (a run-time N, four key tiles).
K4_OTHER_CASES = [
    (1, 2, 2, 8, 4, 192, 12), (1, 2, 2, 8, 0, 192, 6), (1, 2, 3, 5, 2, 64, 4),
    (1, 2, 2, 6, 3, 96, 2), (1, 2, 2, 6, 3, 128, 2),
]


@pytest.mark.parametrize("image", [False, True])
@pytest.mark.parametrize("b,n_wh,n_ww,ws,shift,c,heads", K4_OTHER_CASES)
def test_window_attn_kernel_matches_twin_off_the_paths(cuda, image, b, n_wh,
                                                       n_ww, ws, shift, c,
                                                       heads):
    """K4 / K6 bf16 at the shapes that take the kernel's other
    instantiations, with K4's tolerances and zero-bias control."""
    dtype = torch.bfloat16
    rng = _rng(17)
    qkv = _t(rng.standard_normal((b, n_wh * ws, n_ww * ws, 3 * c)), cuda, dtype)
    bias = expand_relative_bias(
        _t(rng.standard_normal(((2 * ws - 1) ** 2, heads)), cuda), ws)
    kw = dict(num_heads=heads, window=ws, shift=shift)
    if image:
        run = lambda bb: k1.fused_window_attention_image(qkv, bb, **kw)  # noqa: E731
        want = k1.window_attention_image_plain(qkv, bias, **kw)
    else:
        from nunif_tpu_torch.modules.permute import window_partition2
        qw = window_partition2(qkv, ws).contiguous()
        wkw = dict(kw, n_wh=n_wh, n_ww=n_ww)
        run = lambda bb: k1.fused_window_attention(qw, bb, **wkw)  # noqa: E731
        want = k1.window_attention_plain(qw, bias, **wkw)
    got = run(bias)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _k4_close(got, want, dtype)
    assert not _k4_close(run(torch.zeros_like(bias)), want, dtype)


def test_window_attn_kernel_repeats_at_one_address(cuda):
    """K4 / K6 bf16 called again and again on one buffer, with new contents
    each time and on shorter views at the same address: a tensor map kept
    from an earlier launch must be one of the same address and shape, and
    must never stand for the contents."""
    dtype = torch.bfloat16
    rng = _rng(23)
    ws, heads, c, shift = 6, 12, 192, 3
    img = torch.empty((2, 2 * ws, 3 * ws, 3 * c), device=cuda, dtype=dtype)
    win = torch.empty((12, ws * ws, 3 * c), device=cuda, dtype=dtype)
    bias = expand_relative_bias(
        _t(rng.standard_normal(((2 * ws - 1) ** 2, heads)), cuda), ws)
    kw = dict(num_heads=heads, window=ws, shift=shift)
    for _ in range(3):
        img.copy_(_t(rng.standard_normal(img.shape), cuda, dtype))
        win.copy_(_t(rng.standard_normal(win.shape), cuda, dtype))
        for x in (img, img[:1], img):
            got = k1.fused_window_attention_image(x, bias, **kw)
            assert _k4_close(got, k1.window_attention_image_plain(x, bias, **kw),
                             dtype)
        for x, n_wh in ((win, 4), (win[:6], 2), (win[:6], 1), (win, 4)):
            wkw = dict(kw, n_wh=n_wh, n_ww=len(x) // n_wh)
            got = k1.fused_window_attention(x, bias, **wkw)
            assert _k4_close(got, k1.window_attention_plain(x, bias, **wkw),
                             dtype)


@pytest.mark.parametrize("norm", ["none", "layernorm_nobias"])
def test_window_attention_module_runs_kernel(cuda, norm):
    """The attention module passes its qkv projection and cached bias to
    K4 unchanged; a LayerNorm block launches K4 once, a norm-free one
    launches K1 and not K4."""
    from nunif_tpu_torch.modules.attention import (ShiftedWindowAttention,
                                                   SwinTransformerBlock, dense)
    torch.manual_seed(0)
    attn = ShiftedWindowAttention(64, 4, 6, 3).to(cuda)
    xw = _t(_rng(8).normal(0, 1, (15, 36, 64)), cuda, torch.bfloat16)
    with torch.no_grad():
        got = attn(xw, windows=(1, 3, 5))
        want = dense(k1.fused_window_attention(
            dense(xw, attn.qkv), attn.relative_bias(), num_heads=4, window=6,
            shift=3, n_wh=3, n_ww=5), attn.proj)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    blk = SwinTransformerBlock(64, 4, 6, shift_size=3, norm=norm).to(cuda)
    x = _t(_rng(9).normal(0, 1, (1, 18, 30, 64)), cuda, torch.bfloat16)
    before = (k1.fused_window_attention.launches,
              k1.fused_swin_block_image.launches)
    with torch.no_grad():
        y = blk(x)
    torch.cuda.synchronize()
    after = (k1.fused_window_attention.launches,
             k1.fused_swin_block_image.launches)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert bool(y.float().isfinite().all())
    expect = (1, 0) if norm != "none" else (0, 1)
    assert (after[0] - before[0], after[1] - before[1]) == expect


def test_window_attn_rejects_bad_inputs(cuda):
    bias = torch.zeros((2, 36, 36), device=cuda)
    kw = dict(num_heads=2, window=6, shift=3, n_wh=3, n_ww=5)
    qkv = torch.zeros((15, 35, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="window"):
        k1.fused_window_attention(qkv, bias, **kw)
    qkv = torch.zeros((15, 81, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 64"):  # window 9
        k1.fused_window_attention(qkv, torch.zeros((2, 81, 81), device=cuda),
                                  **dict(kw, window=9))
    qkv = torch.zeros((15, 36, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        k1.fused_window_attention(qkv, bias, **dict(kw, num_heads=3))
    flat = torch.zeros(15 * 36 * 96 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        k1.fused_window_attention(flat[1:].view(15, 36, 96), bias, **kw)
    with pytest.raises(TypeError):
        k1.fused_window_attention(qkv.half(), bias, **kw)
    with pytest.raises(ValueError, match="bias"):
        k1.fused_window_attention(qkv, bias[:1], **kw)
    with pytest.raises(ValueError, match="window grid"):
        k1.fused_window_attention(qkv, bias, **dict(kw, n_wh=4))


# K5: K1's block on window-ordered tokens (nw, N, C); its twin rounds at
# K1's points, so K1's tolerances hold.  (batch, n_wh, n_ww, C, heads,
# shift, shift_mode): a window count not a multiple of 4, batch 2, C = 192,
# head dim 64.
K5_CASES = [
    (1, 4, 5, 96, 6, 0, "roll"), (1, 4, 5, 96, 6, 3, "roll"),
    (1, 5, 6, 96, 6, 3, "pad"), (2, 3, 7, 96, 6, 3, "pad"),
    (1, 3, 4, 192, 6, 3, "pad"), (1, 3, 3, 128, 2, 3, "roll"),
    # ragged last tiles: 20 windows at C = 192, 40 (batch 2) at C = 96
    (1, 4, 5, 192, 6, 3, "pad"), (2, 4, 5, 96, 6, 3, "roll"),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n_wh,n_ww,c,heads,shift,mode", K5_CASES)
def test_swin_block_windows_kernel_matches_twin(cuda, dtype, b, n_wh, n_ww, c,
                                                heads, shift, mode):
    rng = _rng(10)
    nw = b * n_wh * n_ww
    x = _t(rng.normal(0, 0.5, (nw, 36, c)), cuda, dtype)
    args = _block_inputs(rng, c, heads, cuda)
    kw = dict(num_heads=heads, window=6, shift=shift, n_wh=n_wh, n_ww=n_ww,
              shift_mode=mode)
    before = k1.fused_swin_block.launches
    got = k1.fused_swin_block(x, *args, **kw)
    torch.cuda.synchronize()
    assert k1.fused_swin_block.launches == before + 1
    want = k1.swin_block_plain(x, *args, **kw)
    assert got.shape == want.shape == x.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=K1_ATOL[dtype],
                               rtol=0)
    # controls: a kernel that drops the bias, or (shifted) applies the other
    # mask, must fail the same comparison
    bad = [k1.fused_swin_block(x, *args[:-1], torch.zeros_like(args[-1]), **kw)]
    if shift:
        other = "roll" if mode == "pad" else "pad"
        bad.append(k1.fused_swin_block(x, *args, **dict(kw, shift_mode=other)))
    for y in bad:
        assert float((y.float() - want.float()).abs().max()) > 4 * K1_ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shift,skip", [(0, True), (3, False)])
def test_swin_block_window_path_matches_k1_path(cuda, monkeypatch, dtype,
                                                shift, skip):
    """NUNIF_TPU_SWIN_IMG=0 runs the block as one K5 launch (pad shift) and
    no K1; its output is K1's up to the masked keys' e^-100 terms and the
    rounding order."""
    from nunif_tpu_torch.modules.attention import SwinTransformerBlock
    torch.manual_seed(0)
    blk = SwinTransformerBlock(96, 6, 6, shift_size=shift).to(cuda)
    with torch.no_grad():
        blk.attn.relative_position_bias_table.normal_()
    rng = _rng(11)
    x = _t(rng.normal(0, 0.5, (2, 24, 30, 96)), cuda, dtype)
    sk = _t(rng.normal(0, 0.5, (2, 24, 30, 96)), cuda, dtype) if skip else None
    with torch.no_grad():
        monkeypatch.setenv("NUNIF_TPU_SWIN_IMG", "1")
        want = blk(x, skip=sk)
        monkeypatch.setenv("NUNIF_TPU_SWIN_IMG", "0")
        before = (k1.fused_swin_block.launches, k1.fused_swin_block_image.launches)
        got = blk(x, skip=sk)
        torch.cuda.synchronize()
    after = (k1.fused_swin_block.launches, k1.fused_swin_block_image.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    assert got.shape == x.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=K1_ATOL[dtype],
                               rtol=0)


# swin_unet_2x's 1080p frame: K1 (C, H, W, shift, skip) on the image path,
# K5 (C, unpadded H, W, shift) on the window path (shifted blocks on the
# grid padded by one window)
K1_MAIN = [(96, 1104, 1920, 0, False), (96, 1104, 1920, 3, False),
           (96, 1104, 1920, 0, True), (192, 552, 960, 0, False),
           (192, 552, 960, 3, False), (192, 276, 480, 0, False),
           (192, 276, 480, 3, False)]
K5_MAIN = [(96, 1104, 1920, 0), (96, 1104, 1920, 3), (192, 552, 960, 0),
           (192, 552, 960, 3), (192, 276, 480, 0), (192, 276, 480, 3)]


@pytest.mark.parametrize("shape", K1_MAIN)
def test_swin_block_kernel_matches_twin_at_main_path_shapes(cuda, shape):
    c, h, w, shift, skip = shape
    rng = _rng(20)
    x = _t(rng.normal(0, 0.5, (1, h, w, c)), cuda, torch.bfloat16)
    sk = _t(rng.normal(0, 0.5, (1, h, w, c)), cuda, torch.bfloat16) if skip else None
    args = _block_inputs(rng, c, 6, cuda)
    kw = dict(num_heads=6, window=6, shift=shift, skip=sk)
    got = k1.fused_swin_block_image(
        x, *args, packed=k1.pack_weights(*args, torch.bfloat16), **kw)
    want = k1.swin_block_image_plain(x, *args, **kw)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=K1_ATOL[torch.bfloat16], rtol=0)
    no_bias = k1.fused_swin_block_image(
        x, *args[:-1], torch.zeros_like(args[-1]), **kw)
    assert float((no_bias.float() - want.float()).abs().max()) > \
        4 * K1_ATOL[torch.bfloat16]


@pytest.mark.parametrize("shape", K5_MAIN)
def test_swin_block_windows_kernel_matches_twin_at_main_path_shapes(cuda, shape):
    c, h, w, shift = shape
    n_wh, n_ww = h // 6 + (shift > 0), w // 6 + (shift > 0)
    rng = _rng(21)
    x = _t(rng.normal(0, 0.5, (n_wh * n_ww, 36, c)), cuda, torch.bfloat16)
    args = _block_inputs(rng, c, 6, cuda)
    kw = dict(num_heads=6, window=6, shift=shift, n_wh=n_wh, n_ww=n_ww,
              shift_mode="pad")
    got = k1.fused_swin_block(
        x, *args, packed=k1.pack_weights(*args, torch.bfloat16), **kw)
    want = k1.swin_block_plain(x, *args, **kw)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=K1_ATOL[torch.bfloat16], rtol=0)
    bad = [k1.fused_swin_block(x, *args[:-1], torch.zeros_like(args[-1]), **kw)]
    if shift:
        bad.append(k1.fused_swin_block(x, *args, **dict(kw, shift_mode="roll")))
    for y in bad:
        assert float((y.float() - want.float()).abs().max()) > \
            4 * K1_ATOL[torch.bfloat16]


@pytest.mark.parametrize("c,hidden,rows", [(96, 192, 256), (192, 384, 128),
                                           (32, 64, 256), (128, 256, 128)])
def test_swin_block_plan_reads_the_pack_it_is_given(cuda, c, hidden, rows):
    """With the pack's column chunks the kernel's tiles are the sizes the
    kernel header states."""
    plan = k1.block_plan(c, hidden, 6)
    assert plan["rows"] == rows and plan["windows"] == rows // 36
    assert plan["stages"] >= 2 and plan["smem"] <= 232448


@pytest.mark.parametrize("shift,skip", [(0, True), (2, False)])
def test_swin_block_kernel_matches_twin_at_window_4(cuda, shift, skip):
    """Windows other than 6 take the kernel's attention with a run-time
    token count (N = 16 here, one 16-key tile)."""
    rng = _rng(22)
    x = _t(rng.normal(0, 0.5, (1, 20, 28, 96)), cuda, torch.bfloat16)
    sk = _t(rng.normal(0, 0.5, (1, 20, 28, 96)), cuda, torch.bfloat16) if skip else None
    args = list(_block_inputs(rng, 96, 6, cuda))
    args[-1] = expand_relative_bias(_t(rng.standard_normal((49, 6)), cuda), 4)
    kw = dict(num_heads=6, window=4, shift=shift, skip=sk)
    got = k1.fused_swin_block_image(x, *args, **kw)
    want = k1.swin_block_image_plain(x, *args, **kw)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=K1_ATOL[torch.bfloat16], rtol=0)
    no_bias = k1.fused_swin_block_image(
        x, *args[:-1], torch.zeros_like(args[-1]), **kw)
    assert float((no_bias.float() - want.float()).abs().max()) > \
        4 * K1_ATOL[torch.bfloat16]


# sha1 of K4, K6 and T2 outputs at the seeded shapes of
# tools/ab_swin_block.py:bitwise_digests, as the PR 8 kernels give them
# (ab_swin_block run against that tree on an H100): K1 / K5's redesign
# shares headers with them and must leave their outputs bit-identical.
PR8_DIGESTS = {"K4": "c1d6d896136d058c2c1bc2689fb528acf4e7ce0b",
               "K6": "07d634b4d21684f6ccd8fe81cb574b0e2ed6c384",
               "T2 P4": "ced2fcab150b83bd7a584660d8022836fa48e7f2",
               "T2 P4qs": "d1776bdaa3475331f57f303679b526e7f4a0176a"}


def test_window_attn_and_t2_outputs_match_recorded_digests(cuda):
    from nunif_tpu_torch.tools.ab_swin_block import bitwise_digests
    assert bitwise_digests() == PR8_DIGESTS


def test_swin_block_windows_rejects_bad_inputs(cuda):
    args = _block_inputs(_rng(12), 32, 2, cuda)
    kw = dict(num_heads=2, window=6, shift=3, n_wh=3, n_ww=4)
    x = torch.zeros((12, 36, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="window grid"):
        k1.fused_swin_block(x[:11], *args, **kw)
    with pytest.raises(ValueError, match="window\\^2"):
        k1.fused_swin_block(torch.zeros((12, 35, 32), device=cuda,
                                        dtype=torch.bfloat16), *args, **kw)
    with pytest.raises(ValueError, match="shift_mode"):
        k1.fused_swin_block(x, *args, shift_mode="wrap", **kw)
    with pytest.raises(ValueError, match="packed for"):
        k1.fused_swin_block(x, *args, packed=k1.pack_weights(*args, torch.float32),
                            **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n_wh,n_ww,ws,shift,c,heads", K4_CASES)
def test_window_attn_image_kernel_matches_twin(cuda, dtype, b, n_wh, n_ww, ws,
                                               shift, c, heads):
    """K6 (image layout) at K4's cases, K4's tolerances and controls."""
    rng = _rng(13)
    qkv = _t(rng.standard_normal((b, n_wh * ws, n_ww * ws, 3 * c)), cuda, dtype)
    bias = expand_relative_bias(
        _t(rng.standard_normal(((2 * ws - 1) ** 2, heads)), cuda), ws)
    kw = dict(num_heads=heads, window=ws, shift=shift)
    before = k1.fused_window_attention_image.launches
    got = k1.fused_window_attention_image(qkv, bias, **kw)
    torch.cuda.synchronize()
    assert k1.fused_window_attention_image.launches == before + 1
    want = k1.window_attention_image_plain(qkv, bias, **kw)
    assert got.shape == want.shape == qkv.shape[:3] + (c,)
    assert _k4_close(got, want, dtype)
    assert not _k4_close(k1.fused_window_attention_image(
        qkv, torch.zeros_like(bias), **kw), want, dtype)
    if shift:
        assert not _k4_close(k1.fused_window_attention_image(
            qkv, bias, **dict(kw, shift=0)), want, dtype)


# The probes T1, T3, T4 against their twins, with the CPU tests' tolerances
# (tests/test_torch_probes.py): T1 exact; T3 bf16 atol 1e-2, int8 2e-2,
# both rtol 2^-7; T4's fill and check output int8 exact, bf16 rtol 1e-3.
@pytest.mark.parametrize("rh,cw", [(8, 8), (4, 16), (2, 4), (8, 2)])
def test_strip_kernels_match_twin(cuda, rh, cw):
    from nunif_tpu_torch.ops import probes
    x = _t(_rng(14).normal(0, 1, (1, 48, 96, 96)), cuda, torch.bfloat16)
    want = probes.strip_plain(x)
    for fn in (probes.strip_pass, probes.strip_relayout):
        before = fn.launches
        got = fn(x, rh, cw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="bf16"):
        probes.strip_pass(x.float(), rh, cw)


# T3 at the tool's shape (tools/microbench_int8_attn.py: 14720 windows of
# N 36, C 96, P 216, vhat 104 wide), at 64 of its windows, and at N 37, P
# 200, vhat 112 wide (a ragged row tile, P not a whole k-step, vhat rows
# copied one at a time): (windows, N, C, P, Cv)
T3_CASES = [(14720, 36, 96, 216, 104), (64, 36, 96, 216, 104),
            (512, 37, 96, 200, 112)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("nw,n,c,p,cv", T3_CASES)
def test_window_dots_kernel_matches_twin(cuda, dtype, nw, n, c, p, cv):
    from nunif_tpu_torch.ops import probes
    rng = _rng(15)
    shapes = ((nw, n, c), (nw, c, p), (nw, p, cv))
    if dtype == torch.int8:
        ins = [torch.from_numpy(rng.integers(-127, 127, s).astype(np.int8)).to(cuda)
               for s in shapes]
    else:
        ins = [_t(rng.uniform(-1, 1, s).astype(np.float32), cuda, dtype)
               for s in shapes]
    before = probes.window_dots.launches
    got = probes.window_dots(*ins)
    torch.cuda.synchronize()
    assert probes.window_dots.launches == before + 1
    want = probes.window_dots_plain(*ins)
    assert got.shape == want.shape == (nw, n, c)
    atol = 1e-2 if dtype == torch.bfloat16 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=2 ** -7)
    assert float((got == want).float().mean()) >= 0.99


def test_window_dots_rejects_shapes_the_kernel_does_not_take(cuda):
    from nunif_tpu_torch.ops import probes

    def run(n, c, p, cv, dtype=torch.bfloat16):
        probes.window_dots(*(torch.zeros(s, device=cuda, dtype=dtype) for s in (
            (2, n, c), (2, c, p), (2, p, cv))))

    for args in ((49, 96, 216, 104), (36, 96, 264, 104), (36, 100, 216, 104),
                 (36, 96, 212, 104), (36, 40, 216, 104, torch.int8)):
        with pytest.raises(ValueError, match="not a shape the kernel takes"):
            run(*args)
    with pytest.raises(ValueError, match="16-byte aligned"):
        q = torch.zeros((2 * 36 * 96 + 4,), device=cuda, dtype=torch.bfloat16)
        probes.window_dots(q[4:].view(2, 36, 96),  # 8 bytes in
                           torch.zeros((2, 96, 216), device=cuda, dtype=torch.bfloat16),
                           torch.zeros((2, 216, 104), device=cuda, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("n,c,p", [(36, 48, 108), (36, 96, 216),
                                   (108, 96, 648)])
def test_window_dots_repeat_kernel_matches_twin(cuda, dtype, n, c, p):
    from nunif_tpu_torch.ops import probes
    rng = _rng(16)
    shapes = ((32, n, c), (32, c, p), (32, p, c))
    if dtype == torch.int8:
        ins = [torch.from_numpy(rng.integers(-127, 127, s).astype(np.int8)).to(cuda)
               for s in shapes]
    else:
        ins = [_t(rng.uniform(0, 1, s), cuda, dtype) for s in shapes]
    before = probes.window_dots_repeat.launches
    got = probes.window_dots_repeat(*ins)
    torch.cuda.synchronize()
    assert probes.window_dots_repeat.launches == before + 1
    want = probes.window_dots_repeat_plain(*ins)
    assert float(want[0, 0]) != 0.0 and bool((got == got[0, 0]).all())
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-3, atol=0)


# T4's check output: every window's o of the last repetition against the
# twin's (int8 exact, bf16 rtol 1e-3, the fill's tolerance), at the three
# shapes above and the tool's padded one (C 128: in bf16 the only plan of
# P split over the cluster with one 64-row tile a window).  The fill
# sees only window 0 of the last block, so a control with one other
# window's khat zeroed passes the fill check and must fail this one.
def _t4_close(got, want, dtype):
    if dtype == torch.int8:
        return torch.equal(got, want)
    return bool(torch.isclose(got, want, rtol=1e-3, atol=0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("n,c,p", [(36, 48, 108), (36, 96, 216),
                                   (108, 96, 648), (36, 128, 256)])
def test_window_dots_repeat_checks_every_window(cuda, dtype, n, c, p):
    from nunif_tpu_torch.ops import probes
    rng = _rng(17)
    shapes = ((32, n, c), (32, c, p), (32, p, c))
    if dtype == torch.int8:
        ins = [torch.from_numpy(rng.integers(-127, 127, s).astype(np.int8)).to(cuda)
               for s in shapes]
    else:
        ins = [_t(rng.uniform(0, 1, s), cuda, dtype) for s in shapes]
    got = torch.empty((32, n, c), dtype=torch.float32, device=cuda)
    fill = probes.window_dots_repeat(*ins, check=got)
    torch.cuda.synchronize()
    want = torch.empty_like(got)
    want_fill = probes.window_dots_repeat_plain(*ins, want)
    assert bool(want.abs().amax(dim=(1, 2)).gt(0).all())  # no window is degenerate
    assert _t4_close(got, want, dtype)
    assert _t4_close(fill, want_fill, dtype)
    khat = ins[1].clone()
    khat[5] = 0  # not the first window of a block
    bad = torch.empty_like(got)
    bad_fill = probes.window_dots_repeat(ins[0], khat, ins[2], check=bad)
    assert _t4_close(bad_fill, want_fill, dtype)  # the fill cannot see it
    assert not _t4_close(bad, want, dtype)


def test_probe_plans_fit_shared_memory(cuda):
    """T4's plan at every shape of its tool and T2's at both tool shapes
    and the tests' C 32: within the 227 KB of a block, with the stages the
    designs need (T4: two windows in flight, or one window of two 64-row
    tiles, or P split over the cluster)."""
    from nunif_tpu_torch.ops import probes
    from nunif_tpu_torch.tools import microbench_mxu_dots as t4
    from nunif_tpu_torch.tools import microbench_swin_pieces as t2
    for _label, n, c, p, int8 in t4.SHAPES:
        plan = probes.window_dots_plan(torch.int8 if int8 else torch.bfloat16, n, c, p)
        assert 0 < plan.smem <= 232448 and plan.stages >= 1, plan
        assert plan.psplit == 2 or plan.mtiles == 2 or plan.stages >= 2, plan
        assert plan.nch * plan.pc >= p and plan.kp >= c and plan.cn >= c, plan
    for c, g in ((96, t2.default_g(96)), (192, t2.default_g(192)), (32, 2)):
        plan = probes.swin_pieces_plan(c, g)
        assert plan.rows == 36 * g and 0 < plan.smem <= 232448, plan
        assert plan.nc == probes.pieces_chunk_width(c), plan
        assert (3 * c) % (2 * plan.nc) == 0 and c % (2 * plan.nc) == 0, plan
    with pytest.raises(ValueError, match="not a shape the kernel takes"):
        probes.swin_pieces_plan(96, 2)


# T2: the piecewise Swin block against its twin at every variant, on the
# tool's check tables (weights N(0, 1 / fan-in), biases N(0, 0.1), bias
# table N(0, 1)): max abs err 0.05 (K1's, for the same six rounding points)
# and at least 95% of elements bit-equal (chip_smoke.py reads 98.9-100% on
# an H100: the bf16 GEMMs sum in fp32 in another order than the twin's,
# which flips ~1% of roundings at C = 192, while int8 sums are exact); for the whole
# attention, a zero bias table and per-window attention (-1000 across
# windows) must fail.
T2_ATOL, T2_BIT_EQUAL = 0.05, 0.95
T2_CASES = [(32, 2, 1, 2, 12, 24), (96, 4, 1, 16, 12, 192),
            (192, 2, 1, 8, 12, 96)]


def _t2_agree(got, want):
    d = (got.float() - want.float()).abs()
    return bool(d.isfinite().all()) and float(d.max()) <= T2_ATOL and \
        float((got == want).float().mean()) >= T2_BIT_EQUAL


@pytest.mark.parametrize("name", ["W", "P0", "P1", "P2", "P3", "P4", "P0q",
                                  "P4q", "P4s", "P4qs"])
@pytest.mark.parametrize("c,g,rh,cw,h,w", T2_CASES)
def test_swin_pieces_kernel_matches_twin(cuda, name, c, g, rh, cw, h, w):
    from nunif_tpu_torch.ops import probes
    from nunif_tpu_torch.tools import microbench_swin_pieces as tool
    v = tool.variant(name)
    wts = tool.weights(c, g, v["dense_int8"], check=True, seed=c, device=cuda)
    x = tool.image(c, h, w, seed=c + 1, device=cuda)
    kw = dict(G=g, rh=rh, cw=cw, **v)
    before = probes.swin_pieces.launches
    got = probes.swin_pieces(x, *wts, **kw)
    torch.cuda.synchronize()
    assert probes.swin_pieces.launches == before + 1
    want = probes.swin_pieces_plain(x, *wts, **kw)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert _t2_agree(got, want)
    if name == "W":
        assert torch.equal(got, x)
    if v["pieces"] == 4:
        bias = wts[8]
        win = torch.arange(g * 36, device=cuda) // 36
        same = (win[:, None] == win[None, :]).repeat(1, c // 16)
        for control in (torch.zeros_like(bias),
                        torch.where(same, bias, torch.full_like(bias, -1000.0))):
            bad = probes.swin_pieces(x, *wts[:8], control, *wts[9:], **kw)
            assert not _t2_agree(bad, want)


def test_swin_pieces_rejects_bad_inputs(cuda):
    from nunif_tpu_torch.ops import probes
    from nunif_tpu_torch.tools import microbench_swin_pieces as tool
    wts = tool.weights(32, 2, False, device=cuda)
    x = tool.image(32, 12, 24, device=cuda)
    with pytest.raises(ValueError, match="groups of"):
        probes.swin_pieces(x, *wts, G=4, rh=1, cw=2, pieces=4)
    with pytest.raises(ValueError, match="bf16"):
        probes.swin_pieces(x.float(), *wts, G=2, rh=1, cw=2, pieces=4)
    with pytest.raises(ValueError, match="int8"):
        probes.swin_pieces(x, *wts, G=2, rh=1, cw=2, pieces=4, dense_int8=True)
    with pytest.raises(ValueError, match="bias"):
        probes.swin_pieces(x, *wts[:8], wts[8][:36], *wts[9:], G=2, rh=1,
                           cw=2, pieces=4)
