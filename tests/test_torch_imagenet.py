"""imagenet's classifiers in nunif_tpu_torch against the JAX package on the
CPU: SwinT (window-7 LayerNorm Swin blocks on K4's twin, JAX-order patch
merging), VGG11 with FrozenBatchNorm, ``convert_vgg11_bn`` and ``.nztm``
files both ways.

Tolerances: fp32 logits to 1e-4 absolute; the port's bf16 SwinT within
0.05 of JAX's fp32 logits (|logits| up to ~7: the bf16 rounding of the
stream, ~2^-8 relative a step, over 4 blocks and 3 merges; JAX's own bf16
forward lands 0.011 away, and its block norms return fp32 where the
port's round to bf16); the vgg11_bn conversion and the checkpoints'
parameters bit-equal.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nunif_tpu.imagenet  # noqa: F401  (registers the JAX archs)
from nunif_tpu.imagenet.models import FrozenBatchNorm as JaxFrozenBatchNorm
from nunif_tpu.models import create_model as jax_create_model
from nunif_tpu.models.io import load_model as jax_load_model
from nunif_tpu.models.io import save_model as jax_save_model
from nunif_tpu.models.torch_convert import convert_vgg11_bn as jax_convert_vgg11_bn

import nunif_tpu_torch.imagenet.models as imagenet_models
from nunif_tpu_torch.imagenet.models import FrozenBatchNorm, SwinT, VGG11
from nunif_tpu_torch.models import (SoftmaxBaseModel, from_flax,
                                    init_flax_default, load_model, save_model,
                                    to_flax)
from nunif_tpu_torch.models.torch_convert import convert_vgg11_bn, flatten
from nunif_tpu_torch.ops import swin_attention

FP32_ATOL = 1e-4
BF16_ATOL = 0.05
SMALL = dict(depths=(2, 2), heads=(3, 6))  # 56 px: stage 1 at 14x14 (2x2
# windows, its second block shifted), stage 2 at 7x7 (one window, unshifted)


def unflatten(flat):
    root = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = jnp.asarray(v)
    return root


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def seeded_swin_t(seed=0, **kwargs):
    """A SwinT with flax's init drawn from ``seed`` and every norm's scale
    and bias moved off 1 / 0 (so a norm read in the wrong place shows)."""
    model = SwinT(**kwargs)
    init_flax_default(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    flat = {k: (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
            if k.rsplit("/", 1)[-1] in ("scale", "bias") else a
            for k, a in to_flax(model).items()}
    from_flax(model, flat)
    return model.eval().requires_grad_(False), flat


@pytest.fixture(scope="module")
def swin_ref():
    """The small SwinT's weights, input and JAX fp32 logits (one compile)."""
    model, flat = seeded_swin_t(**SMALL)
    x = np.random.default_rng(1).uniform(0, 1, (2, 56, 56, 3)).astype(np.float32)
    jm = jax_create_model("imagenet.swin_t", **SMALL)
    want = np.asarray(jm.apply_fn(unflatten(flat), jnp.asarray(x)))
    return model, flat, x, want


def test_swin_t_fp32_matches_jax(swin_ref):
    model, _flat, x, want = swin_ref
    assert isinstance(model, SoftmaxBaseModel)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)


def test_swin_t_bf16_within_its_rounding(swin_ref):
    model, _flat, x, want = swin_ref
    with torch.no_grad():
        got = model(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    err = float(np.abs(got.float().numpy() - want).max())
    assert 0 < err <= BF16_ATOL, err


def test_swin_t_patch_merge_in_torchvision_order_fails(swin_ref, monkeypatch):
    """Control: torchvision's [x00, x10, x01, x11] concatenation in place
    of JAX's [x00, x01, x10, x11] must fail the fp32 comparison."""
    model, _flat, x, want = swin_ref

    def torchvision_order(t):
        return torch.cat([t[:, 0::2, 0::2], t[:, 1::2, 0::2],
                          t[:, 0::2, 1::2], t[:, 1::2, 1::2]], dim=-1)
    t = torch.arange(2 * 4 * 4 * 3, dtype=torch.float32).reshape(2, 4, 4, 3)
    assert torch.equal(imagenet_models.patch_merge(t), torch.cat(
        [t[:, 0::2, 0::2], t[:, 0::2, 1::2], t[:, 1::2, 0::2],
         t[:, 1::2, 1::2]], dim=-1))
    monkeypatch.setattr(imagenet_models, "patch_merge", torchvision_order)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) > 100 * FP32_ATOL


def test_swin_t_runs_k4_twelve_times(monkeypatch):
    """The default swin_t at 224 px calls K4 once a block, 12 times, at
    N = 49 and head dim 32; the 7x7 stage is unshifted."""
    calls = []
    k4 = swin_attention.fused_window_attention

    def counting(qkv, bias, **kw):
        calls.append((qkv.shape[1], qkv.shape[2] // 3 // kw["num_heads"],
                      kw["shift"], kw["n_wh"]))
        return k4(qkv, bias, **kw)
    monkeypatch.setattr(swin_attention, "fused_window_attention", counting)
    model = SwinT().eval().requires_grad_(False)
    with torch.no_grad():
        y = model(torch.zeros(1, 224, 224, 3))
    assert y.shape == (1, 1000)
    assert len(calls) == 12
    assert {(n, hd) for n, hd, _s, _g in calls} == {(49, 32)}
    assert [(s, g) for _n, _hd, s, g in calls] == [
        (0, 8), (3, 8), (0, 4), (3, 4), (0, 2), (3, 2), (0, 2), (3, 2),
        (0, 2), (3, 2), (0, 1), (0, 1)]


def seeded_vgg_flat(seed=0):
    """VGG11 weights from a seed, scaled so activations stay O(1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, a in to_flax(VGG11()).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            v = rng.standard_normal(a.shape, np.float32) * np.float32(
                np.sqrt(2.0 / np.prod(a.shape[:-1])))
        elif leaf == "var":
            v = rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        else:
            v = rng.normal(0, 0.1, a.shape).astype(np.float32)
        out[key] = v
    return out


def test_vgg11_fp32_matches_jax():
    flat = seeded_vgg_flat()
    x = np.random.default_rng(2).uniform(0, 1, (1, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jax_create_model("imagenet.vgg11").apply_fn(
        unflatten(flat), jnp.asarray(x)))
    model = VGG11()
    from_flax(model, flat)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 1000) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("use_batch_stats", [False, True])
def test_frozen_batch_norm_matches_jax(use_batch_stats):
    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 2.0, (2, 5, 5, 8)).astype(np.float32)
    params = {k: rng.uniform(0.5, 1.5, 8).astype(np.float32)
              for k in ("scale", "bias", "mean", "var")}
    want = np.asarray(JaxFrozenBatchNorm().apply(
        {"params": params}, jnp.asarray(x), use_batch_stats=use_batch_stats))
    bn = FrozenBatchNorm(8)
    from_flax(bn, params)
    got = bn(torch.from_numpy(x), use_batch_stats=use_batch_stats)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


def test_convert_vgg11_bn_matches_jax():
    """A torchvision-keyed vgg11_bn state dict under ``net.``, seeded, with
    the real shapes: both converters' trees bit-equal."""
    rng = np.random.default_rng(4)
    sd = {}
    cin = 3
    convs = [c for c in imagenet_models._VGG11_CFG if c != "M"]
    from nunif_tpu_torch.models.torch_convert import _VGG11_BN_IDX
    for c, (ci, bi) in zip(convs, _VGG11_BN_IDX):
        sd[f"net.features.{ci}.weight"] = rng.standard_normal((c, cin, 3, 3), np.float32)
        sd[f"net.features.{ci}.bias"] = rng.standard_normal(c, np.float32)
        for name in ("weight", "bias", "running_mean", "running_var"):
            sd[f"net.features.{bi}.{name}"] = rng.standard_normal(c, np.float32)
        sd[f"net.features.{bi}.num_batches_tracked"] = np.int64(7)
        cin = c
    for j, (i, o) in zip((0, 3, 6), ((512 * 49, 4096), (4096, 4096), (4096, 1000))):
        sd[f"net.classifier.{j}.weight"] = rng.standard_normal((o, i), np.float32)
        sd[f"net.classifier.{j}.bias"] = rng.standard_normal(o, np.float32)
    got = flatten(convert_vgg11_bn(sd, prefix="net"))
    want = flat_tree(jax_convert_vgg11_bn(sd, prefix="net"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    model = VGG11()
    from_flax(model, got)  # the tree loads: every leaf present, right shape


def test_nztm_round_trip_both_packages(swin_ref, tmp_path):
    """The port's file through JAX's load_model and JAX's through the
    port's: the same architecture and bit-equal parameters."""
    model, flat, x, want = swin_ref
    save_model(model, str(tmp_path / "port.nztm"))
    jm, jparams, jmeta = jax_load_model(str(tmp_path / "port.nztm"))
    assert jmeta["name"] == "imagenet.swin_t"
    assert (tuple(jm.depths), tuple(jm.heads)) == (SMALL["depths"],
                                                   SMALL["heads"])
    jflat = flat_tree(jparams)
    assert sorted(jflat) == sorted(flat)
    assert all(np.array_equal(jflat[k], flat[k]) for k in flat)
    jax_save_model(jm, jparams, str(tmp_path / "jax.nztm"))
    back, meta = load_model(str(tmp_path / "jax.nztm"), device="cpu")
    assert type(back) is SwinT and meta["name"] == "imagenet.swin_t"
    assert (back.depths, back.heads) == (SMALL["depths"], SMALL["heads"])
    back_flat = to_flax(back)
    assert all(np.array_equal(back_flat[k], flat[k]) for k in flat)
    with torch.no_grad():
        np.testing.assert_allclose(back(torch.from_numpy(x)).numpy(), want,
                                   rtol=0, atol=FP32_ATOL)
