"""The port's losses (``nunif_tpu_torch/modules/losses.py``) and the
waifu2x loss table (``waifu2x/training/trainer.py:create_criterion``)
against the JAX package, on the CPU (the feature-net entries:
``test_torch_feature_losses.py``).

Every entry of the table that needs no feature net, and its gradient with
respect to the prediction, is held to JAX in fp32 on numpy-seeded inputs
that cross the clamp bounds: values within 1e-5 relative, gradients
within 1e-5 relative plus 1e-5 of the largest element (the two packages
sum in other orders).  The random augments are compared on the
deterministic path (no generator / no key: a centred translate and a 45
degree rotation) and through explicit angles and offsets: a JAX key and a
``torch.Generator`` give different numbers.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.modules import losses as JL
from nunif_tpu.modules import spectral as jspectral
from nunif_tpu.waifu2x.training import trainer as jtrainer

from nunif_tpu_torch.modules import losses as L
from nunif_tpu_torch.modules import spectral
from nunif_tpu_torch.waifu2x.training import trainer as ttrainer

RNG = np.random.default_rng(11)
X = RNG.uniform(-0.1, 1.1, (2, 24, 24, 3)).astype(np.float32)
Y = np.clip(X + RNG.normal(0, 0.1, X.shape), -0.05, 1.05).astype(np.float32)
X2 = RNG.uniform(-0.1, 1.1, X.shape).astype(np.float32)
# a target of flat 8x8 cells but in one corner
FLAT = np.repeat(np.repeat(Y[:, ::8, ::8], 8, 1), 8, 2)
FLAT[:, :8, :8] = Y[:, :8, :8]

TABLE = ["l1", "y_l1", "charbonnier", "y_charbonnier", "lbp", "lbpm", "lbp5",
         "lbp5m", "yrgb_l1lbp5", "yrgb_l1lbp", "yrgb_flatlbp5", "yrgb_lbp",
         "yrgb_lbp5", "alex11", "y_l1fftgrad", "dct", "dctirm", "dctir24",
         "fft", "ident"]
AUX = ["aux_lbp", "aux_alex11", "aux_charbonnier", "aux_y_charbonnier",
       "aux_lbp_ident"]


def _value_and_grads(name, jax_side):
    """(loss, [d loss / d each prediction]) of table entry ``name``."""
    aux = name in AUX
    preds = [X, X2] if aux else [X]
    if jax_side:
        fn = jtrainer.create_criterion(name)

        def f(*ps):
            return fn(tuple(ps) if aux else ps[0], jnp.asarray(Y))
        v, g = jax.jit(jax.value_and_grad(f, argnums=tuple(range(len(preds)))))(
            *[jnp.asarray(p) for p in preds])
        return float(v), [np.asarray(a) for a in g]
    fn = ttrainer.create_criterion(name)
    ts = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    v = fn(tuple(ts) if aux else ts[0], torch.from_numpy(Y))
    v.backward()
    return float(v.detach()), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("name", TABLE + AUX)
def test_criterion_and_gradient_match_jax(name):
    got, got_g = _value_and_grads(name, False)
    want, want_g = _value_and_grads(name, True)
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-5, abs=1e-7)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))


def test_loss_table_matches_jax():
    """Both tables hold the same names; those this file computes are the
    table but its nine feature-net entries (held in
    ``test_torch_feature_losses.py``), which the port builds now (no name
    refuses); the rng entries are marked."""
    def names(mod):
        with pytest.raises(ValueError) as e:
            mod.create_criterion("bogus")
        return set(eval(str(e.value).split("known: ", 1)[1].rstrip(")")))
    assert names(ttrainer) == names(jtrainer)
    assert set(ttrainer.DEFAULT_LOSSES.items()) == set(jtrainer.DEFAULT_LOSSES.items())
    assert not hasattr(ttrainer, "FEATURE_NET_LOSSES")
    feature_net = {"l1lpips", "l1lpips_std_mask", "l1lpips_dct24", "l1dinov2",
                   "l1dinov2_10", "yrgb_lbp_dinov2", "l1l4sn", "l1l4sn2",
                   "l1l4sn_swd"}
    assert names(ttrainer) - feature_net == set(TABLE + AUX)
    for name in ("dctirm", "dctir24"):
        assert ttrainer.create_criterion(name).needs_rng
        assert jtrainer.create_criterion(name).needs_rng


def test_lbp_filters_bit_equal_to_jax():
    for args in ((64, 1, 3), (64, 1, 5)):
        np.testing.assert_array_equal(L._lbcnn_filters(*args),
                                      JL._lbcnn_filters(*args))
    np.testing.assert_array_equal(L._lbp_kernel(1, 64, 3), JL._lbp_kernel(1, 64, 3))
    np.testing.assert_array_equal(L._dct_basis(24), JL._dct_basis(24))
    np.testing.assert_array_equal(L._alex11_filter(), np.asarray(JL._alex11_filter()))


def test_dft2_psnr_match_jax():
    re, im = spectral.dft2(torch.from_numpy(X))
    jre, jim = jspectral.dft2(jnp.asarray(X))
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=1e-5)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=1e-5)
    for fn in ("psnr", "luminance_psnr"):
        got = float(getattr(L, fn)(torch.from_numpy(X), torch.from_numpy(Y)))
        want = float(getattr(JL, fn)(jnp.asarray(X), jnp.asarray(Y)))
        assert got == pytest.approx(want, rel=1e-5)


def test_augments_match_jax_at_explicit_draws():
    """rotate_expand at given angles and the translate at JAX's own
    offsets; the JAX draws are read out of its key, not reproduced."""
    ang = np.array([0.3, 2.5], np.float32)
    got = L.rotate_expand(torch.from_numpy(X), torch.from_numpy(ang))
    want = JL.rotate_expand(jnp.asarray(X), jnp.asarray(ang))
    assert got.shape == want.shape == (2, 34, 34, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    key = jax.random.PRNGKey(3)
    off = np.asarray(jax.random.randint(key, (2, 2), 0, 25))
    jx, jy = JL.translate_pair(jnp.asarray(X), jnp.asarray(Y), key, size=12)
    tx, ty = L.translate_by(torch.from_numpy(X), torch.from_numpy(Y),
                            torch.from_numpy(off.copy()), size=12)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    # with a generator: one shared offset per instance, in [-size, size]
    g = torch.Generator().manual_seed(0)
    gx, gy = L.translate_pair(torch.from_numpy(X), torch.from_numpy(X), g)
    assert gx.shape == (2, 48, 48, 3) and torch.equal(gx, gy)
    v = L.dctirm_loss()(torch.from_numpy(X), torch.from_numpy(Y), g)
    assert np.isfinite(float(v)) and float(v) > 0


def test_gan_and_misc_losses_match_jax():
    rng = np.random.default_rng(5)
    real = rng.normal(0, 2, (3, 4, 4, 1)).astype(np.float32)
    fake = rng.normal(0, 2, (3, 4, 4, 1)).astype(np.float32)
    mask = (rng.random((3, 4, 4, 1)) < 0.5).astype(np.float32)
    t = torch.from_numpy
    cases = [
        (L.gan_bce_loss(t(real), True), JL.gan_bce_loss(jnp.asarray(real), True)),
        (L.gan_bce_loss(t(fake), False), JL.gan_bce_loss(jnp.asarray(fake), False)),
        (L.gan_hinge_loss_d(t(real), t(fake)), JL.gan_hinge_loss_d(real, fake)),
        (L.gan_hinge_loss_g(t(fake)), JL.gan_hinge_loss_g(fake)),
        (L.gan_softplus_loss_d(t(real), t(fake)), JL.gan_softplus_loss_d(real, fake)),
        (L.gan_softplus_loss_g(t(fake)), JL.gan_softplus_loss_g(fake)),
        (L.gan_mask_hinge_loss_d(t(real), t(fake), t(mask)),
         JL.gan_mask_hinge_loss_d(real, fake, mask)),
        (L.gan_mask_hinge_loss_g(t(fake), t(mask)), JL.gan_mask_hinge_loss_g(fake, mask)),
        (L.huber_loss(t(real), t(fake)), JL.huber_loss(real, fake)),
        (L.l2_loss(t(real), t(fake)), JL.l2_loss(real, fake)),
        (L.dct_loss(window_size=8)(t(X), t(Y)), JL.dct_loss(window_size=8)(X, Y)),
        (L.gradient_loss()(t(X), t(Y)), JL.gradient_loss()(X, Y)),
        (L.gradient_only_loss(diag=True)(t(X), t(Y)),
         JL.gradient_only_loss(diag=True)(X, Y)),
        (L.flat_color_loss(t(X), t(FLAT)), JL.flat_color_loss(X, FLAT)),
        (L.flat_color_weighted_loss(t(X), t(FLAT)),
         JL.flat_color_weighted_loss(X, FLAT)),
    ]
    assert 0 < float(L.get_flat_color_mask(t(FLAT)).mean()) < 1
    for got, want in cases:
        assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-7)
    w = rng.normal(0, 1, (4, 4, 1)).astype(np.float32)
    got = L.r1_regularization(lambda x: (torch.tanh(x) * t(w)).sum((1, 2, 3)), t(real))
    want = JL.r1_regularization(lambda p, x: (jnp.tanh(x) * p).sum((1, 2, 3)),
                                jnp.asarray(w), jnp.asarray(real))
    assert float(got) == pytest.approx(float(want), rel=1e-5)
