"""K5 (the whole Swin block on window-ordered tokens) and the block module's
window path (``NUNIF_TPU_SWIN_IMG=0``) of nunif_tpu_torch against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and given to both packages.  The JAX
Pallas kernel ``fused_swin_block`` runs in interpret mode, as the JAX
package's own kernel tests run it; the port runs its plain twin, which the
K5 wrapper takes for CPU tensors.  The relative-position table is drawn at
std 1 (the init's 0.02 would hide a dropped bias).

Tolerances: fp32 1e-4 (the two packages sum in another order; measured
<= 7.2e-7).  In bf16 the port is held to JAX's fp32 output as closely as
JAX's own bf16 run is: both round at six points, but the Pallas kernel
rounds unnormalised probabilities where the twin rounds normalised ones,
so single elements land one bf16 step apart either way.  The bound is
JAX's bf16 error, RMS within 10% and max within one bf16 step of the
largest output.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nunif_tpu.core.dtypes import BF16_POLICY as J_BF16, FP32_POLICY as J_FP32
from nunif_tpu.models import unflatten_params
from nunif_tpu.modules import attention as jattn
from nunif_tpu.ops.swin_attention import fused_swin_block as jax_swin_block
from nunif_tpu.utils import tiling as jtiling
from nunif_tpu.waifu2x.models import SwinUNet2x as JaxSwinUNet2x

from nunif_tpu_torch.core.dtypes import BF16_POLICY, FP32_POLICY
from nunif_tpu_torch.models import from_flax, to_flax
from nunif_tpu_torch.modules import attention as tattn
from nunif_tpu_torch.ops import swin_attention as kernels
from nunif_tpu_torch.utils import tiling
from nunif_tpu_torch.waifu2x.models.swin_unet import (SwinUNet2x,
                                                      tamed_flax_params)

FP32_ATOL = 1e-4


def _block_args(rng, c, heads):
    hid = 2 * c
    lec = lambda i, o: (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)  # noqa: E731
    bias = lambda o: rng.normal(0, 0.02, (o,)).astype(np.float32)  # noqa: E731
    weights = [lec(c, 3 * c), bias(3 * c), lec(c, c), bias(c), lec(c, hid),
               bias(hid), lec(hid, c), bias(c)]
    table = rng.standard_normal((121, heads)).astype(np.float32)
    idx = jattn.relative_position_index(6, 6).reshape(-1)
    rel = table[idx].reshape(36, 36, heads).transpose(2, 0, 1).copy()
    return weights, rel


def _bf16_within_jax_error(got, want, jax_bf16):
    ours, theirs = got - want, jax_bf16 - want
    rms = lambda d: float(np.sqrt(np.mean(d.astype(np.float64) ** 2)))  # noqa: E731
    assert rms(ours) <= 1.1 * rms(theirs), (rms(ours), rms(theirs))
    step = float(np.abs(want).max()) * 2.0 ** -8
    assert np.abs(ours).max() <= np.abs(theirs).max() + step


# (shift, shift_mode, batch, JAX attn_variant): None is the JAX default
# (wpack4 on window-ordered tokens)
CASES = [
    (0, "roll", 1, None), (3, "roll", 1, None), (3, "pad", 1, None),
    (3, "pad", 2, None), (0, "roll", 2, "perhead"), (3, "roll", 2, "perhead"),
    (3, "pad", 1, "perhead"),
]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shift,mode,batch,variant", CASES)
def test_swin_block_twin_matches_pallas(dtype, shift, mode, batch, variant):
    rng = np.random.default_rng(10 * shift + batch)
    c, heads, n_wh, n_ww = 32, 2, 3, 4
    x = rng.normal(0, 0.5, (batch * n_wh * n_ww, 36, c)).astype(np.float32)
    weights, rel = _block_args(rng, c, heads)
    kw = dict(num_heads=heads, window=6, shift=shift, n_wh=n_wh, n_ww=n_ww,
              shift_mode=mode)

    def jax_run(dt):
        out = jax_swin_block(jnp.asarray(x, dt), *map(jnp.asarray, weights),
                             jnp.asarray(rel), attn_variant=variant,
                             interpret=True, **kw)
        return np.asarray(out.astype(jnp.float32))

    want = jax_run(jnp.float32)
    td = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    before = kernels.fused_swin_block.launches
    got = kernels.fused_swin_block(torch.from_numpy(x).to(td),
                                   *map(torch.from_numpy, weights),
                                   torch.from_numpy(rel), **kw)
    assert kernels.fused_swin_block.launches == before  # CPU: the twin
    assert got.dtype == td and got.shape == x.shape
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL)
    else:
        _bf16_within_jax_error(got.float().numpy(), want,
                               jax_run(jnp.bfloat16))


def test_pad_and_roll_masks_differ_only_where_cropped():
    """On the same window tokens the two masks give different blocks, and
    the pad mask's valid keys are exactly the unpadded image's pixels."""
    n_wh, n_ww, ws, shift = 3, 4, 6, 3
    mask = tattn.padded_window_key_mask(n_wh, n_ww, ws, shift)
    assert mask.shape == (n_wh * n_ww, 1, 36)
    img = np.zeros((n_wh * ws, n_ww * ws), np.float32)
    img[shift:shift + (n_wh - 1) * ws, shift:shift + (n_ww - 1) * ws] = 1
    wins = img.reshape(n_wh, ws, n_ww, ws).transpose(0, 2, 1, 3).reshape(-1, 36)
    np.testing.assert_array_equal(mask[:, 0] == 0, wins == 1)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 0.5, (12, 36, 32)).astype(np.float32))
    weights, rel = _block_args(rng, 32, 2)
    args = [*map(torch.from_numpy, weights), torch.from_numpy(rel)]
    kw = dict(num_heads=2, window=ws, shift=shift, n_wh=n_wh, n_ww=n_ww)
    pad = kernels.fused_swin_block(x, *args, shift_mode="pad", **kw)
    roll = kernels.fused_swin_block(x, *args, shift_mode="roll", **kw)
    assert float((pad - roll).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="shift_mode"):
        kernels.fused_swin_block(x, *args, shift_mode="wrap", **kw)


def _block_pair(rng, c, heads, shift):
    port = tattn.SwinTransformerBlock(c, heads, 6, shift_size=shift)
    flat = {}
    for key, ref in to_flax(port).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            a = rng.standard_normal(ref.shape) / np.sqrt(ref.shape[0])
        elif leaf == "relative_position_bias_table":
            a = rng.standard_normal(ref.shape)
        else:
            a = rng.normal(0.0, 0.1, ref.shape)
        flat[key] = a.astype(np.float32)
    from_flax(port, flat)
    jblock = jattn.SwinTransformerBlock(c, heads, 6, shift_size=shift)
    return port.eval(), jblock, unflatten_params(
        {k: jnp.asarray(v) for k, v in flat.items()})


@pytest.mark.parametrize("shift,skip", [(0, False), (0, True), (3, False),
                                        (3, True)])
def test_window_path_block_matches_image_path_and_jax(monkeypatch, shift,
                                                       skip):
    """The norm-free block with NUNIF_TPU_SWIN_IMG=0 (pad, partition, K5's
    twin, reverse, crop) against the same block with =1 (K1's twin) and the
    JAX module (its roll path on the CPU)."""
    rng = np.random.default_rng(20 + shift + int(skip))
    port, jblock, params = _block_pair(rng, 32, 2, shift)
    x = rng.normal(0, 0.5, (2, 18, 24, 32)).astype(np.float32)
    sk = rng.normal(0, 0.5, x.shape).astype(np.float32) if skip else None
    want = np.asarray(jblock.apply(
        {"params": params}, jnp.asarray(x),
        skip=None if sk is None else jnp.asarray(sk)))
    outs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("NUNIF_TPU_SWIN_IMG", flag)
        with torch.no_grad():
            outs[flag] = port(torch.from_numpy(x), skip=None if sk is None
                              else torch.from_numpy(sk)).numpy()
    assert outs["0"].shape == x.shape
    np.testing.assert_allclose(outs["0"], want, atol=FP32_ATOL)
    np.testing.assert_allclose(outs["0"], outs["1"], atol=FP32_ATOL)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_frame_program_window_path_matches_jax(monkeypatch, dtype):
    """40x56 uint8 frame at tile 64 through swin_unet_2x (base 32) with
    every block on the window path, against the JAX model."""
    model = SwinUNet2x(base_dim=32)
    flat = tamed_flax_params(model, seed=0)
    from_flax(model, flat)
    model.eval().requires_grad_(False)
    jmodel = JaxSwinUNet2x(base_dim=32)
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    policy, jpolicy = {"fp32": (FP32_POLICY, J_FP32),
                       "bf16": (BF16_POLICY, J_BF16)}[dtype]
    frame = np.random.default_rng(2).integers(0, 256, (40, 56, 3),
                                              dtype=np.uint8)
    jprog = jtiling.TiledRenderer(jmodel, params, policy=jpolicy) \
        .frame_program(40, 56, tile_size=64, batch_size=4)
    want = np.asarray(jprog(params, jnp.asarray(frame)))
    monkeypatch.setenv("NUNIF_TPU_SWIN_IMG", "0")
    calls = []
    monkeypatch.setattr(kernels, "fused_swin_block_image",
                        lambda *a, **k: calls.append(1))  # must not run
    got = tiling.TiledRenderer(model, policy=policy).frame_program(
        40, 56, tile_size=64, batch_size=4)(frame)
    assert not calls
    assert got.dtype == torch.uint8 and got.shape == want.shape == (80, 112, 3)
    assert _psnr(got.numpy(), want) >= 50.0  # the repo's uint8 parity bar
