"""The GAN discriminators of nunif_tpu_torch against the JAX package, on
the CPU: waifu2x's seven (``waifu2x/models/discriminator.py``) and iw3's
two inpaint discriminators (``iw3/models/discriminator.py``), their
stateless spectral norm and the FFC discriminator's ``FourierUnit``.

Each discriminator's weights are drawn with numpy in flax layout (kernels
lecun-scaled, norm scales N(1, 0.1), biases N(0, 0.1)), written by the
JAX package's ``save_model`` and read by the port's ``load_model`` (the
architecture and its kwargs from the file), and both forwards run fp32 on
the same numpy inputs.  Tolerance: fp32 on both sides, the same function
summed in another order: within 1e-4 of the largest |logit| (and the hole
grids equal).

``ImageToCondition`` averages its features to 4 x 4 as torch's
``AdaptiveAvgPool2d`` does, which the JAX function means to copy: where
the side is not a multiple of 4 torch's windows end at the ceiling, the
JAX function's at the floor (its ``-(-(i + 1) * H) // oh`` is a floor
division), so the two differ there
(``test_adaptive_pool_diverges_from_jax``).  The parity cases use
conditions whose pooled side is a multiple of 4.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nunif_tpu.iw3.models.discriminator as jiw3d
import nunif_tpu.waifu2x.models.discriminator as jw2xd
from nunif_tpu.models import create_model as jax_create_model
from nunif_tpu.models.io import save_model as jax_save_model
from nunif_tpu.models.io import unflatten_params
from nunif_tpu.modules.fourier_unit import FourierUnit as JaxFourierUnit

from nunif_tpu_torch.iw3.models import discriminator as tiw3d
from nunif_tpu_torch.models import create_model, from_flax, load_model, to_flax
from nunif_tpu_torch.models.model import model_kwargs
from nunif_tpu_torch.modules.fourier_unit import FourierUnit
from nunif_tpu_torch.waifu2x.models import discriminator as tw2xd

TOL = 1e-4

# registry name -> (input (H, W), condition (H, W) or None, mask?)
W2X = {
    "waifu2x.l3_discriminator": ((144, 144), None),
    "waifu2x.v1_discriminator": ((136, 144), None),
    "waifu2x.l3v1_discriminator": ((144, 150), None),
    "waifu2x.l3_conditional_discriminator": ((144, 144), (136, 140)),
    "waifu2x.v1_conditional_discriminator": ((144, 150), (152, 150)),
    "waifu2x.l3v1_conditional_discriminator": ((144, 144), (140, 144)),
    "waifu2x.u3_conditional_discriminator": ((60, 52), (56, 52)),
}
IW3 = ("inpaint.ffc_discriminator", "inpaint.l3_conditional_discriminator")


def _shapes(jmodel, *inputs, **kw):
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *[jnp.zeros(s) for s in inputs],
        **{k: jnp.zeros(s) for k, s in kw.items()}))
    return {"/".join(p.key for p in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}


def _draw(shapes, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in shapes.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "scale":
            a = rng.normal(1.0, 0.1, shape)
        else:
            a = rng.normal(0.0, 0.1, shape)
        out[key] = a.astype(np.float32)
    return out


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


def _round_trip(tmp_path, name, jmodel, flat):
    """The JAX-written ``.nztm`` read by the port."""
    path = str(tmp_path / f"{name}.nztm")
    jax_save_model(jmodel, unflatten_params({k: jnp.asarray(v)
                                             for k, v in flat.items()}), path)
    model, meta = load_model(path, device="cpu")
    assert meta["name"] == name and type(model).model_name == name
    assert model_kwargs(model) == meta["kwargs"]
    return model


@pytest.mark.parametrize("name", sorted(W2X))
def test_waifu2x_discriminator_matches_jax(tmp_path, name):
    hw, chw = W2X[name]
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    c = None if chw is None else rng.uniform(0, 1, (2, *chw, 3)).astype(np.float32)
    jm = jax_create_model(name)
    train = name.startswith("waifu2x.u3")
    flat = _draw(_shapes(jm, x.shape, *([] if c is None else [c.shape])), 2)
    model = _round_trip(tmp_path, name, jm, flat)
    for tr in ((False, True) if train else (False,)):
        want = jm.apply({"params": unflatten_params(
            {k: jnp.asarray(v) for k, v in flat.items()})}, jnp.asarray(x),
            None if c is None else jnp.asarray(c), train=tr)
        with torch.no_grad():
            got = model(torch.from_numpy(x),
                        None if c is None else torch.from_numpy(c), train=tr)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g.numpy(), w, f"{name} train={tr}")
    assert tuple(type(model).loss_weights) == tuple(type(jm).loss_weights)


@pytest.mark.parametrize("name", IW3)
def test_inpaint_discriminator_matches_jax(tmp_path, name):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 68, 72, 3)).astype(np.float32)
    c = rng.uniform(0, 1, x.shape).astype(np.float32)
    mask = np.zeros((2, 68, 72, 1), np.float32)
    mask[0, 20:40, 30:34] = 1.0
    mask[1, 50:60, 8:30] = 1.0
    jm = jax_create_model(name)
    flat = _draw(_shapes(jm, x.shape, c=c.shape, mask=mask.shape), 4)
    model = _round_trip(tmp_path, name, jm, flat)
    params = {"params": unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})}
    want, want_grid = jm.apply(params, jnp.asarray(x), c=jnp.asarray(c),
                               mask=jnp.asarray(mask), train=True)
    with torch.no_grad():
        got, grid = model(torch.from_numpy(x), c=torch.from_numpy(c),
                          mask=torch.from_numpy(mask), train=True)
        bare = model(torch.from_numpy(x), c=torch.from_numpy(c))
    _close(got.numpy(), want, name)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(want_grid))
    assert grid.dtype == torch.bool and 0 < int(grid.sum()) < grid.numel()
    _close(bare.numpy(), want, name)


@pytest.mark.parametrize("shape", [(3, 3, 512, 1), (4, 4, 32, 64), (1, 1, 64, 256)])
def test_spectral_sigma_matches_jax(shape):
    """The power iteration's sigma from the OIHW weight equals JAX's from
    the HWIO kernel, and SNConv's forward equals JAX's."""
    rng = np.random.default_rng(5)
    kernel = (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    weight = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    want = float(jw2xd._spectral_sigma(jnp.asarray(kernel)))
    got = float(tw2xd.spectral_sigma(weight))
    assert got == pytest.approx(want, rel=1e-5)
    # sigma of the normalized kernel is ~1 after five iterations
    assert float(tw2xd.spectral_sigma(weight / got)) == pytest.approx(1.0, rel=1e-5)

    kh, kw, cin, cout = shape
    stride = (2, 2) if kh == 4 else (1, 1)
    pad = ((1, 1), (1, 1)) if kh == 4 else "SAME"
    x = rng.uniform(-1, 1, (2, 16, 20, cin)).astype(np.float32)
    jconv = jw2xd.SNConv(cout, (kh, kw), stride, pad)
    bias = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    jy = jconv.apply({"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
                     jnp.asarray(x))
    conv = tw2xd.SNConv(cin, cout, (kh, kw), stride, pad)
    from_flax(conv, {"kernel": kernel, "bias": bias})
    with torch.no_grad():
        _close(conv(torch.from_numpy(x)).numpy(), jy, str(shape))


@pytest.mark.parametrize("cin,cout,residual", [
    (16, 16, False), (8, 16, True), (16, 16, True)])
def test_fourier_unit_matches_jax(cin, cout, residual):
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (2, 12, 10, cin)).astype(np.float32)
    jm = JaxFourierUnit(cin, cout, residual=residual)
    flat = _draw(_shapes(jm, x.shape), 7)
    want = jm.apply({"params": unflatten_params({k: jnp.asarray(v)
                                                 for k, v in flat.items()})},
                    jnp.asarray(x))
    fu = FourierUnit(cin, cout, residual=residual)
    assert set(to_flax(fu)) == set(flat)
    from_flax(fu, flat)
    with torch.no_grad():
        _close(fu(torch.from_numpy(x)).numpy(), want)


def test_mask_grid_matches_jax():
    rng = np.random.default_rng(8)
    mask = (rng.uniform(0, 1, (3, 64, 80, 1)) > 0.97).astype(np.float32)
    want = jiw3d._mask_to_logit_grid(jnp.asarray(mask), (4, 6))
    got = tiw3d.mask_to_logit_grid(torch.from_numpy(mask), (4, 6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tiw3d.mask_to_logit_grid(torch.from_numpy(mask), (5, 6))


def test_every_discriminator_creates_by_name():
    """All nine registry names build in the port with the JAX model's
    kwargs and flax paths."""
    for name in (*W2X, *IW3):
        jm = jax_create_model(name)
        model = create_model(name)
        assert type(model).model_name == name
        from nunif_tpu.models.model import model_kwargs as jax_kwargs
        assert model_kwargs(model) == jax_kwargs(jm), name


def test_adaptive_pool_diverges_from_jax():
    """The port's condition pooling is torch's ``AdaptiveAvgPool2d``
    (overlapping windows, ends rounded up), as the reference's
    ``ImageToCondition`` uses it; the JAX ``adaptive_avg_pool`` ends its
    windows at the floor, so at a side that 4 does not divide it differs,
    and at one it divides the two agree."""
    rng = np.random.default_rng(9)
    for hw, same in (((34, 36), False), ((32, 36), True)):
        x = rng.uniform(0, 1, (2, *hw, 5)).astype(np.float32)
        want = torch.nn.AdaptiveAvgPool2d(4)(
            torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        jax_out = np.asarray(jw2xd.adaptive_avg_pool(jnp.asarray(x), (4, 4)))
        embed = tw2xd.ImageToCondition(8, (4,), 1, in_channels=5)
        got = embed.pool(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert np.allclose(jax_out, want, atol=1e-6) == same
