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
control, the kernel given only the first N - 29 keys, must fail, which
shows that a ragged last key tile counts.
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


def _block_inputs(rng, c, heads, device):
    hid = 2 * c
    lec = lambda i, o: _t(rng.standard_normal((i, o)) / np.sqrt(i), device)  # noqa: E731
    bias = lambda o: _t(rng.normal(0, 0.02, (o,)), device)  # noqa: E731
    table = _t(rng.standard_normal((121, heads)), device)  # see module doc
    return (lec(c, 3 * c), bias(3 * c), lec(c, c), bias(c), lec(c, hid),
            bias(hid), lec(hid, c), bias(c), expand_relative_bias(table, 6))


K1_ATOL = {torch.bfloat16: 0.05, torch.float32: 2e-4}
K1_CASES = [
    (1, 24, 30, 96, 6, 0, False),
    (1, 24, 30, 96, 6, 3, False),
    (2, 18, 42, 96, 6, 0, True),   # window count not a multiple of 4
    (1, 12, 18, 192, 6, 3, False),
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


@pytest.mark.parametrize("b,h,w,c,max_shift", [
    (3, 7, 45, 3, 9), (2, 5, 33, 8, 3), (1, 4, 20, 1, 28), (2, 9, 130, 5, 6)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_warp_kernel_matches_twin(cuda, b, h, w, c, max_shift, x_dtype):
    rng = _rng(4)
    x = _t(rng.random((b, h, w, c)), cuda, x_dtype)
    delta = _t(rng.uniform(-max_shift, max_shift, (b, h, w)), cuda)
    delta[0, 0, -3:] = max_shift   # gx clipped to W - 1
    delta[0, 1, -1] = 0.0          # gx exactly W - 1
    before = k3.warp_x_bounded.launches
    got = k3.warp_x_bounded(x, delta, max_shift)
    torch.cuda.synchronize()
    assert k3.warp_x_bounded.launches == before + 1
    want = k3.warp_x_bounded_plain(x, delta, max_shift)
    assert got.shape == want.shape and got.dtype == x_dtype
    atol = 1e-5 if x_dtype == torch.float32 else 1 / 128  # one bf16 output step
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    # control: the same check must see a kernel that moves nothing
    still = k3.warp_x_bounded(x, torch.zeros_like(delta), max_shift)
    assert float((still.float() - want.float()).abs().max()) > 10 * atol


@pytest.mark.parametrize("b,heads,n,m,d", [
    (2, 3, 1, 1, 64), (1, 2, 37, 37, 64), (2, 2, 63, 63, 64),
    (1, 1, 64, 64, 64), (2, 3, 65, 65, 64), (1, 2, 197, 197, 64),
    (1, 2, 100, 37, 64), (2, 6, 1373, 1373, 64)])
def test_flash_kernel_matches_twin(cuda, b, heads, n, m, d):
    rng = _rng(5)
    q = _t(rng.standard_normal((b, heads, n, d)), cuda, torch.bfloat16)
    k = _t(rng.standard_normal((b, heads, m, d)), cuda, torch.bfloat16)
    v = _t(rng.standard_normal((b, heads, m, d)), cuda, torch.bfloat16)
    before = k7.sdpa.launches
    got = k7.sdpa(q, k, v)
    torch.cuda.synchronize()
    assert k7.sdpa.launches == before + 1
    want = k7.sdpa_plain(q, k, v)
    assert got.shape == want.shape == (b, heads, n, d)
    diff = got.float() - want.float()
    assert float(diff.abs().max()) <= 1e-2
    assert float(diff.norm() / want.float().norm()) <= 1e-2
    if m > 29:
        cut = k7.sdpa(q, k[:, :, :m - 29], v[:, :, :m - 29])
        ctrl = cut.float() - want.float()
        assert float(ctrl.abs().max()) > 1e-2 or \
            float(ctrl.norm() / want.float().norm()) > 1e-2


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
