"""The feature-net losses of nunif_tpu_torch against the JAX package, on the
CPU: DINOv2 (``modules/dinov2_loss.py``), LPIPS (``modules/lpips.py`` and
``models/torch_convert.convert_vgg16_features``), the local-std mask and
L4SN (``dino/l4sn.py``), and waifu2x's nine feature-net loss names.

DINOv2: ViT-S on 2 x 30^2 and 2 x 42 x 28 images (3 x 3 and 3 x 2 patches
after the reflection pad), the trunk's weights drawn once with numpy
(``seeded_trunk_params``: LayerScale gammas of a trained net's order, so
that the attention reaches the features) and carried across.  The value,
in bf16 as both packages compute it: within 1.5 times JAX's own bf16 error
against its fp32 run, plus one bf16 step of the value (the bar of the
depth models' parity tests).  The input gradient: both packages in fp32
(the port's ``dtype=torch.float32``; the JAX path rebuilt here from its
own pieces at fp32), within 1e-4 of the largest element.

LPIPS (the JAX-initialized VGG trunk and the bundled heads), the VGG
converter, the local-std mask and L4SN: fp32, within 1e-4 (relative to the
largest value, at least 1).
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nunif_tpu.dino.l4sn as jl4sn
import nunif_tpu.modules.dinov2_loss as jdino
from nunif_tpu.models.io import flatten_params, unflatten_params
from nunif_tpu.models.torch_convert import convert_vgg16_features as jax_convert_vgg16
from nunif_tpu.modules.local_std_mask import local_std_mask as jax_local_std_mask
from nunif_tpu.modules.lpips import LPIPS as JaxLPIPS
from nunif_tpu.modules.lpips import lpips_with as jax_lpips_with
from nunif_tpu.modules import losses as JL

import nunif_tpu_torch.dino.l4sn as tl4sn
from nunif_tpu_torch.models import from_flax
from nunif_tpu_torch.models.torch_convert import (_VGG16_CONV_IDX,
                                                  convert_vgg16_features, flatten)
from nunif_tpu_torch.modules import dinov2_loss as tdino
from nunif_tpu_torch.modules import losses as L
from nunif_tpu_torch.modules.local_std_mask import local_std_mask
from nunif_tpu_torch.modules.lpips import LPIPS, lpips_with
from nunif_tpu_torch.waifu2x.training import trainer as ttrainer

TOL = 1e-4
FEATURE_NET_LOSSES = ("l1lpips", "l1lpips_std_mask", "l1lpips_dct24",
                      "l1dinov2", "l1dinov2_10", "yrgb_lbp_dinov2",
                      "l1l4sn", "l1l4sn2", "l1l4sn_swd")


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


def _jparams(flat):
    return {"params": unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})}


@pytest.fixture(scope="module")
def trunk():
    """The seeded ViT-S weights (flax layout) and the JAX extractors, one
    a kind, built once for the file."""
    flat = tdino.seeded_trunk_params("vits", seed=3)
    jparams = _jparams(flat)
    return flat, {kind: jdino.DINOv2Features(
        random_projection=64 if kind == "pool" else None, params=jparams)
        for kind in ("pool", "cosine")}


def _jax_feature_loss(kind, ex, x, y, dtype):
    """JAX's ``dinov2_feature_loss`` from its own pieces at ``dtype`` (the
    JAX function fixes bf16)."""
    x, y = jdino._pad_to_patch(x), jdino._pad_to_patch(y)
    x, y = jdino._normalize_in(x), jdino._normalize_in(y)

    def feats(z):
        fs, (ph, pw) = ex.model.apply(ex.params, z.astype(dtype),
                                      out_indices=ex.index)
        fs = [f.astype(jnp.float32).reshape(f.shape[0], ph, pw, f.shape[-1])
              for f in fs]
        if ex.proj is not None:
            fs = [jnp.einsum("bhwc,cd->bhwd", f, ex.proj) for f in fs]
        return fs
    fx = feats(x)
    fy = [jax.lax.stop_gradient(f) for f in feats(y)]
    inner = jdino._pool_l1_loss if kind == "pool" else jdino._cosine_loss
    return sum(inner(a, b) for a, b in zip(fx, fy)) / len(fx)


def _images(hw, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("kind", ["pool", "cosine"])
@pytest.mark.parametrize("hw", [(30, 30), (42, 28)])
def test_dinov2_loss_value_within_bf16_error(trunk, kind, hw):
    flat, jex = trunk
    x, y = _images(hw, 1)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want16 = float(_jax_feature_loss(kind, jex[kind], jx, jy, jnp.bfloat16))
    want32 = float(_jax_feature_loss(kind, jex[kind], jx, jy, jnp.float32))
    # the helper is JAX's own function at bf16
    jfn = jdino.dinov2_feature_loss(kind=kind, params=jex[kind].params)
    assert float(jfn(jx, jy)) == pytest.approx(want16, rel=1e-6)
    fn = tdino.dinov2_feature_loss(kind=kind, params=flat)
    got = float(fn(torch.from_numpy(x), torch.from_numpy(y)))
    bar = 1.5 * abs(want16 - want32) + abs(want16) * 2.0 ** -8
    assert abs(got - want16) <= bar, (got, want16, want32)
    assert np.isfinite(got) and got > 0


@pytest.mark.parametrize("kind", ["pool", "cosine"])
def test_dinov2_loss_gradient_fp32_matches_jax(trunk, kind):
    flat, jex = trunk
    x, y = _images((30, 30), 2)
    want_v, want_g = jax.jit(jax.value_and_grad(lambda a: _jax_feature_loss(
        kind, jex[kind], a, jnp.asarray(y), jnp.float32)))(jnp.asarray(x))
    fn = tdino.dinov2_feature_loss(kind=kind, params=flat, dtype=torch.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    v = fn(xt, torch.from_numpy(y))
    v.backward()
    assert float(v) == pytest.approx(float(want_v), rel=1e-5)
    g, w = xt.grad.numpy(), np.asarray(want_g)
    np.testing.assert_allclose(g, w, rtol=0, atol=TOL * float(np.abs(w).max()))
    assert float(np.abs(w).max()) > 0


def test_dinov2_with_and_the_target_branch(trunk):
    """``dinov2_with`` adds weight * the feature loss to the base loss; the
    target branch records no graph, the prediction's does (through K7's
    op)."""
    flat, _ = trunk
    x, y = _images((28, 28), 3)
    base = L.clamp_loss_of(L.l1_loss)
    feat = tdino.dinov2_feature_loss("pool", params=flat)
    fn = tdino.dinov2_with(base, "pool", weight=0.1, params=flat)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    want = float(base(xt, yt)) + 0.1 * float(feat(xt, yt))
    assert float(fn(xt, yt)) == pytest.approx(want, rel=1e-6)
    ex = fn.extractor
    assert ex(yt)[0].grad_fn is None
    assert ex(xt.clone().requires_grad_(True))[0].grad_fn is not None
    np.testing.assert_array_equal(tdino.projection_matrix("vits", 64),
                                  jdino._random_projection("vits", 64))


@pytest.fixture(scope="module")
def lpips_params():
    """LPIPS with the JAX package's VGG trunk from flax's init (PRNGKey 0)."""
    jm = JaxLPIPS()
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                 jnp.zeros((1, 32, 32, 3)))
    return jm, jp, {k: np.asarray(v) for k, v in flatten_params(jp["params"]).items()}


def test_lpips_matches_jax(lpips_params):
    jm, jp, flat = lpips_params
    model = LPIPS()
    from_flax(model, flat)
    x, y = _images((36, 40), 4)
    want = jm.apply(jp, jnp.asarray(x), jnp.asarray(y), normalize=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(y), normalize=True)
    _close(got.numpy(), want)
    assert float(want.min()) > 0
    lins = np.load("nunif_tpu/modules/_lpips_lins.npz")
    for i in range(5):
        np.testing.assert_array_equal(getattr(model, f"lin{i}").numpy(), lins[f"lin{i}"])


@pytest.mark.parametrize("std_mask", [False, True])
def test_lpips_with_value_and_gradient_match_jax(lpips_params, std_mask):
    jm, jp, flat = lpips_params
    model = LPIPS()
    from_flax(model, flat)
    model.requires_grad_(False)
    x, y = _images((32, 32), 5)
    base_j, base_t = JL.clamp_loss_of(JL.l1_loss), L.clamp_loss_of(L.l1_loss)
    jfn = jax_lpips_with(base_j, weight=0.4, std_mask=std_mask)
    want_v, want_g = jax.jit(jax.value_and_grad(lambda a: jfn(jp, a, jnp.asarray(y))))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    v = lpips_with(model, base_t, weight=0.4, std_mask=std_mask)(
        xt, torch.from_numpy(y))
    v.backward()
    assert float(v) == pytest.approx(float(want_v), rel=1e-5)
    w = np.asarray(want_g)
    np.testing.assert_allclose(xt.grad.numpy(), w, rtol=0,
                               atol=TOL * float(np.abs(w).max()))


def test_convert_vgg16_features_matches_jax(lpips_params):
    """A seeded torchvision-layout ``vgg16`` state dict converts as the JAX
    converter does, and LPIPS on it equals JAX's."""
    jm, _jp, _flat = lpips_params
    rng = np.random.default_rng(6)
    sd, cin = {}, 3
    for i, t in enumerate(_VGG16_CONV_IDX):
        cout = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)[i]
        sd[f"features.{t}.weight"] = (rng.standard_normal((cout, cin, 3, 3))
                                      / np.sqrt(9 * cin)).astype(np.float32)
        sd[f"features.{t}.bias"] = rng.normal(0, 0.1, (cout,)).astype(np.float32)
        cin = cout
    got = flatten({"net": convert_vgg16_features(sd)})
    want = flatten({"net": jax_convert_vgg16(sd)})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    model = LPIPS()
    from_flax(model, got)
    x, y = _images((32, 32), 7)
    jout = jm.apply(_jparams(want), jnp.asarray(x), jnp.asarray(y), normalize=True)
    with torch.no_grad():
        _close(model(torch.from_numpy(x), torch.from_numpy(y), normalize=True).numpy(),
               jout)


def test_local_std_mask_matches_jax():
    x, y = _images((24, 20), 8)
    want_v, want_g = jax.value_and_grad(lambda a: jnp.sum(
        jax_local_std_mask(a, jnp.asarray(y)) ** 2))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    v = torch.sum(local_std_mask(xt, torch.from_numpy(y)) ** 2)
    v.backward()
    assert float(v) == pytest.approx(float(want_v), rel=1e-5)
    _close(xt.grad.numpy(), want_g)


@pytest.fixture(scope="module")
def l4sn():
    jm = jl4sn.L4SN()
    jp = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    return jm, jp, {k: np.asarray(v) for k, v in flatten_params(jp["params"]).items()}


def test_l4sn_feature_and_head_match_jax(l4sn):
    jm, jp, flat = l4sn
    model = tl4sn.L4SN()
    from_flax(model, flat)
    x, _y = _images((48, 32), 9)
    jfeat = jl4sn.L4SNFeature()
    jf = jfeat.apply({"params": jp["params"]["feature"]}, jnp.asarray(x))
    with torch.no_grad():
        tf = model.feature(torch.from_numpy(x))
        raw = model.feature(torch.from_numpy(x), activation=False)
        logits = model(torch.from_numpy(x))
    jraw = jfeat.apply({"params": jp["params"]["feature"]}, jnp.asarray(x),
                       activation=False)
    for a, b in zip(tf, jf):
        _close(a.numpy(), b)
    for a, b in zip(raw, jraw):
        _close(a.numpy(), b)
    _close(logits.numpy(), jm.apply(jp, jnp.asarray(x)))
    with pytest.raises(ValueError):
        model.feature(torch.zeros(1, 40, 32, 3))


@pytest.mark.parametrize("swd", [0.0, 0.1])
def test_l4sn_feature_loss_matches_jax(l4sn, swd):
    _jm, jp, flat = l4sn
    jfeat = jl4sn.L4SNFeature()
    jfp = jp["params"]["feature"]
    feat = tl4sn.L4SNFeature()
    from_flax(feat, {k[len("feature/"):]: v for k, v in flat.items()
                     if k.startswith("feature/")})
    feat.requires_grad_(False)
    x, y = _images((64, 32), 10)
    want_v, want_g = jax.jit(jax.value_and_grad(lambda a: jl4sn.l4sn_feature_loss(
        jfeat, jfp, a, jnp.asarray(y), weight=2.0, swd_weight=swd)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    v = tl4sn.l4sn_feature_loss(feat, xt, torch.from_numpy(y), weight=2.0,
                                swd_weight=swd)
    v.backward()
    assert float(v) == pytest.approx(float(want_v), rel=1e-5)
    _close(xt.grad.numpy(), want_g)


@pytest.mark.parametrize("name", FEATURE_NET_LOSSES)
def test_feature_net_loss_names_build_and_step(name):
    """Each of the nine names builds (seeded random nets) and gives a
    finite, positive loss with a gradient, on a 32^2 pair."""
    fn = ttrainer.create_criterion(name)
    x, y = _images((32, 32), 11)
    xt = torch.from_numpy(x).requires_grad_(True)
    v = fn(xt, torch.from_numpy(y))
    v.backward()
    assert np.isfinite(float(v)) and float(v) > 0
    assert bool(torch.isfinite(xt.grad).all()) and float(xt.grad.abs().sum()) > 0


def test_waifu2x_cli_trains_on_l1dinov2(tmp_path, capsys):
    """``python -m nunif_tpu_torch.train waifu2x --loss l1dinov2``: one
    epoch at 64 px on the CPU (vgg_7, the DINOv2 trunk through K7's twin)
    with finite losses, and a ``.nztm`` that ``load_model`` reads."""
    import json
    from nunif_tpu_torch.models import load_model
    from nunif_tpu_torch.train import main
    assert main(["waifu2x", "--model-dir", str(tmp_path), "--arch", "waifu2x.vgg_7",
                 "--loss", "l1dinov2", "--device", "cpu", "--size", "64",
                 "--batch-size", "2", "--num-samples", "4", "--max-epoch", "1",
                 "--num-workers", "1", "--synthetic-p", "1.0"]) == 0
    out = capsys.readouterr().out
    epochs = [json.loads(s[len("train: "):]) for s in out.splitlines()
              if s.startswith("train: ")]
    assert len(epochs) == 1 and epochs[0]["steps"] == 2
    assert np.isfinite(epochs[0]["train_loss"]) and not epochs[0]["nan_count"]
    model, meta = load_model(str(tmp_path / "waifu2x_vgg_7.nztm"), device="cpu")
    assert meta["name"] == "waifu2x.vgg_7"


def test_swd_whole_windows_diverges_from_jax():
    """At swin_unet_2x's 192^2 training output L4SN's last level is 12^2,
    not a multiple of the window (8): the JAX function raises, the port
    takes the windows that fit (the top-left 8^2), and where the side is
    a multiple the two agree."""
    rng = np.random.default_rng(12)
    a, b = (rng.normal(0, 1, (2, 12, 12, 4)).astype(np.float32) for _ in range(2))
    with pytest.raises(TypeError):
        jl4sn.window_sliced_wasserstein(jnp.asarray(a), jnp.asarray(b))
    got = float(tl4sn.window_sliced_wasserstein(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jl4sn.window_sliced_wasserstein(jnp.asarray(a[:, :8, :8]),
                                                 jnp.asarray(b[:, :8, :8])))
    assert got == pytest.approx(want, rel=1e-6)
    fn = ttrainer.create_criterion("l1l4sn_swd")
    x, y = _images((192, 192), 13)
    assert np.isfinite(float(fn(torch.from_numpy(x[:1]), torch.from_numpy(y[:1]))))
