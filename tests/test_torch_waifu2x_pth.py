"""Reference waifu2x checkpoints in nunif_tpu_torch: ``.pth`` files in the
nunif envelope (state dicts of the reference modules in tests/torchref/)
and the original waifu2x JSON weights, loaded through both packages.

For each family the port's ``load_model`` and the JAX package's
``load_model`` read the same ``.pth``: the converted weights must be equal
leaf for leaf, and the port's output must match the reference torch
module's own output on the same input (fp32, 1e-4; the same products
summed in another order).  The JAX model runs on the port's ``.nztm``
cache of a ``.pth`` (written beside it, read back on the next load).
swin_unet_v2 and wgmlp at base 32, swin_unet_2x at base 48.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from nunif_tpu.models import load_model as jax_load_model
from nunif_tpu.models import flatten_params
from nunif_tpu.models.pth_import import supported_torch_models as jax_supported
from nunif_tpu.waifu2x.models.json_model import load_json_model as jax_load_json
import nunif_tpu.waifu2x  # noqa: F401

from nunif_tpu_torch.models import load_model, to_flax
from nunif_tpu_torch.models.pth_import import supported_torch_models
from nunif_tpu_torch.waifu2x.models.json_model import load_json_model

V2 = dict(base_dim=32, lv2_mlp_ratio=2, lv2_ratio=2)


def _torchref(kind, **kw):
    """A reference module (tests/torchref) with seeded default-init weights
    and, for the source-residual nets, a non-zero residual scale."""
    torch.manual_seed(sum(map(ord, kind)))
    if kind == "cunet":
        from torchref.cunet import CUNet
        return CUNet(**kw).eval()
    if kind == "winc":
        from torchref.winc import SwinUNetV2
        tm = SwinUNetV2(**kw).eval()
    elif kind == "wgmlp":
        from torchref.wgmlp import WGMLP4x
        tm = WGMLP4x(**kw).eval()
    else:
        from torchref.swin_unet import SwinUNet
        return SwinUNet(**kw).eval()
    with torch.no_grad():
        tm.unet.to_image.scale_bias.fill_(0.3)
    return tm


# case: (envelope name, envelope kwargs, reference module kind, its kwargs,
#        input side)
CASES = {
    "cunet": ("waifu2x.cunet", {}, "cunet", dict(scale=1), 76),
    "upcunet": ("waifu2x.upcunet", {}, "cunet", dict(scale=2), 76),
    "winc_unet_1x": ("waifu2x.winc_unet_1x", V2, "winc",
                     dict(V2, scale_factor=1), 64),
    "winc_unet_2x": ("waifu2x.winc_unet_2x", V2, "winc",
                     dict(V2, scale_factor=2), 64),
    "winc_unet_4x": ("waifu2x.winc_unet_4x", V2, "winc",
                     dict(V2, scale_factor=4), 64),
    "swin_unet_1x_v2": ("waifu2x.swin_unet_1x_v2", V2, "winc",
                        dict(V2, scale_factor=1), 64),
    "swin_unet_v2_1xs": (
        "waifu2x.swin_unet_v2_1x",
        dict(V2, lv1_mlp_ratio=1, lv2_mlp_ratio=1, first_layers=1,
             last_layers=1), "winc",
        dict(V2, lv1_mlp_ratio=1, lv2_mlp_ratio=1, first_layers=1,
             last_layers=1, scale_factor=1), 64),
    "wgmlp_4x": ("waifu2x.wgmlp_4x", {"base_dim": 32}, "wgmlp",
                 {"base_dim": 32}, 64),
    "swin_unet_2x": ("waifu2x.swin_unet_2x", {"base_dim": 48}, "swin",
                     dict(base_dim=48, base_layers=2, scale_factor=2), 64),
}


def save_pth(path, name, kwargs, sd):
    torch.save({"nunif_model": 1, "name": name, "kwargs": kwargs,
                "state_dict": sd, "updated_at": "test"}, path)
    return str(path)


def reference_output(tm, x):
    """The reference module's output, before its final clip where the
    module exposes it (``unet``; cunet clips inside)."""
    with torch.no_grad():
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
        y = tm.unet(xt) if hasattr(tm, "unet") else tm(xt)
    return y.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pth_loads_as_in_jax(case, tmp_path):
    """The same .pth through both loaders: equal converted weights, the
    model the envelope names (an alias resolves to its class), and the
    reference module's output."""
    name, kwargs, kind, ref_kw, size = CASES[case]
    tm = _torchref(kind, **ref_kw)
    path = save_pth(tmp_path / f"{case}.pth", name, kwargs, tm.state_dict())
    model, meta = load_model(path, device="cpu")
    assert meta == {"name": name, "kwargs": kwargs, "imported_from": path}
    jmodel, jparams, _jmeta = jax_load_model(_copy(path, tmp_path / "jax.pth"))
    assert model.model_name == jmodel.model_name
    jflat = {k: np.asarray(v) for k, v in flatten_params(jparams).items()}
    flat = to_flax(model)
    assert set(flat) == set(jflat)
    for key in flat:
        np.testing.assert_array_equal(flat[key], jflat[key], err_msg=key)
    x = np.random.default_rng(5).random((1, size, size, 3), dtype=np.float32)
    want = reference_output(tm, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=True)
        got = (got[0] if isinstance(got, tuple) else got).numpy()
    if kind == "cunet":
        got = np.clip(got, 0.0, 1.0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def _copy(src, dst):
    """A second file with the same bytes, so that each package writes its
    own cache beside its own .pth."""
    with open(src, "rb") as f, open(dst, "wb") as g:
        g.write(f.read())
    return str(dst)


@pytest.mark.parametrize("case", ["upcunet", "winc_unet_2x"])
def test_port_cache_loads_in_jax_and_renders_the_same(case, tmp_path):
    """The port's first load writes <path>.nztm; the second reads it; the
    JAX package loads that cache and its model gives the port's output."""
    name, kwargs, kind, ref_kw, size = CASES[case]
    path = save_pth(tmp_path / "m.pth", name, kwargs,
                    _torchref(kind, **ref_kw).state_dict())
    model, _meta = load_model(path, device="cpu")
    assert os.path.exists(path + ".nztm")
    cached, meta2 = load_model(path, device="cpu")
    assert meta2["name"] == model.model_name and "imported_from" not in meta2
    jmodel, jparams, jmeta = jax_load_model(path + ".nztm")
    assert jmeta["name"] == model.model_name
    x = np.random.default_rng(6).random((1, size, size, 3), dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, v: jmodel.apply({"params": p}, v))(
        jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        again = cached(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(again, got)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_supported_names_are_jax_waifu2x_rows():
    """The port imports every waifu2x name the JAX importer takes (the
    other rows: tests/test_torch_pth_rows.py)."""
    assert [n for n in supported_torch_models() if n.startswith("waifu2x.")] \
        == sorted(n for n in jax_supported() if n.startswith("waifu2x."))


def test_pth_without_envelope_or_importer_raises(tmp_path):
    raw = tmp_path / "raw.pth"
    torch.save({"w": torch.zeros(2)}, raw)
    with pytest.raises(ValueError, match="without a nunif envelope"):
        load_model(str(raw), device="cpu")
    odd = save_pth(tmp_path / "odd.pth", "waifu2x.turbo_2x", {}, {})
    with pytest.raises(ValueError, match="no importer"):
        load_model(odd, device="cpu")


def _torch_upconv7():
    return nn.Sequential(
        nn.Conv2d(3, 16, 3), nn.LeakyReLU(0.1), nn.Conv2d(16, 32, 3),
        nn.LeakyReLU(0.1), nn.Conv2d(32, 64, 3), nn.LeakyReLU(0.1),
        nn.Conv2d(64, 128, 3), nn.LeakyReLU(0.1), nn.Conv2d(128, 128, 3),
        nn.LeakyReLU(0.1), nn.Conv2d(128, 256, 3), nn.LeakyReLU(0.1),
        nn.ConvTranspose2d(256, 3, 4, 2, 3))


def _torch_vgg7():
    widths = (3, 32, 32, 64, 64, 128, 128, 3)
    layers = []
    for i in range(7):
        layers += [nn.Conv2d(widths[i], widths[i + 1], 3), nn.LeakyReLU(0.1)]
    return nn.Sequential(*layers[:-1])


@pytest.mark.parametrize("arch", ["waifu2x.upconv_7", "waifu2x.vgg_7"])
def test_upconv7_vgg7_pth(arch, tmp_path):
    """upconv_7 (its deconv into ConvTranspose2dTorch's flipped kernel) and
    vgg_7 .pth files: equal to JAX's conversion and to the torch module."""
    torch.manual_seed(3)
    tm = (_torch_upconv7() if arch.endswith("upconv_7") else _torch_vgg7()).eval()
    sd = {f"net.{k}": v for k, v in tm.state_dict().items()}
    path = save_pth(tmp_path / "a.pth", arch, {}, sd)
    model, _meta = load_model(path, device="cpu")
    _jm, jparams, _ = jax_load_model(_copy(path, tmp_path / "b.pth"))
    jflat = {k: np.asarray(v) for k, v in flatten_params(jparams).items()}
    for key, a in to_flax(model).items():
        np.testing.assert_array_equal(a, jflat[key], err_msg=key)
    x = np.random.default_rng(7).random((1, 40, 40, 3), dtype=np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x.transpose(0, 3, 1, 2))).clamp(0, 1)
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want.numpy().transpose(0, 2, 3, 1),
                               atol=1e-5)


def _json_layers(tm):
    """A lua-waifu2x JSON weight list of the torch module: each conv's
    OIHW weight and bias in network order (the deconv's (I, O, kh, kw))."""
    layers = []
    for m in tm:
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            layers.append({
                "class_name": ("nn.SpatialFullConvolution"
                               if isinstance(m, nn.ConvTranspose2d)
                               else "nn.SpatialConvolutionMM"),
                "weight": m.weight.detach().numpy().tolist(),
                "bias": m.bias.detach().numpy().tolist()})
    return layers


def test_json_model_loads_as_in_jax(tmp_path):
    """The same upconv_7 JSON file through both loaders (the architecture
    guessed from the last layer, a deconv): equal weights; the port's output
    equals the torch module holding those weights."""
    import json
    arch = "waifu2x.upconv_7"
    torch.manual_seed(4)
    tm = _torch_upconv7().eval()
    path = tmp_path / "model.json"
    path.write_text(json.dumps(_json_layers(tm)))
    model = load_json_model(str(path), device="cpu")
    jmodel, jparams = jax_load_json(str(path))
    assert model.model_name == jmodel.model_name == arch
    jflat = {k: np.asarray(v) for k, v in flatten_params(jparams).items()}
    for key, a in to_flax(model).items():
        np.testing.assert_array_equal(a, jflat[key], err_msg=key)
    x = np.random.default_rng(8).random((1, 40, 40, 3), dtype=np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x.transpose(0, 3, 1, 2))).clamp(0, 1)
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want.numpy().transpose(0, 2, 3, 1),
                               atol=1e-5)


def test_json_vgg7_matches_torch(tmp_path):
    """A vgg_7 JSON file (no deconv: the architecture guessed from its last
    layer) gives the torch module's output.  The port only: loading it
    through the JAX package costs a JAX init for the same conv rule that
    the upconv_7 case holds."""
    import json
    torch.manual_seed(5)
    tm = _torch_vgg7().eval()
    path = tmp_path / "noise1_model.json"
    path.write_text(json.dumps(_json_layers(tm)))
    model = load_json_model(str(path), device="cpu")
    assert model.model_name == "waifu2x.vgg_7"
    x = np.random.default_rng(9).random((1, 30, 30, 3), dtype=np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x.transpose(0, 3, 1, 2))).clamp(0, 1)
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want.numpy().transpose(0, 2, 3, 1),
                               atol=1e-5)
