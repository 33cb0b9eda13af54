"""nunif_tpu_torch checkpoints, weight layout and tile grid against the JAX
package, plus the port's import isolation."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nunif_tpu.models import load_model as jax_load_model
from nunif_tpu.models import save_model as jax_save_model
from nunif_tpu.models import unflatten_params
from nunif_tpu.utils import tiling as jtiling
from nunif_tpu.waifu2x.models import SwinUNet2x as JaxSwinUNet2x

from nunif_tpu_torch.models import (NotPortedError, create_model, from_flax,
                                    load_model, model_kwargs, read_checkpoint,
                                    save_model, to_flax)
from nunif_tpu_torch.models.flax_params import flax_key
from nunif_tpu_torch.utils import tiling
from nunif_tpu_torch.waifu2x.models.swin_unet import (SwinUNet2x,
                                                      tamed_flax_params)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def small():
    model = SwinUNet2x(base_dim=32)
    flat = tamed_flax_params(model, seed=7)
    from_flax(model, flat)
    return model.eval().requires_grad_(False), flat


def test_jax_checkpoint_loads_in_port(small, tmp_path):
    model, flat = small
    path = str(tmp_path / "jax.nztm")
    jax_save_model(JaxSwinUNet2x(base_dim=32),
                   unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}),
                   path)
    loaded, meta = load_model(path, device="cpu")
    assert isinstance(loaded, SwinUNet2x) and loaded.base_dim == 32
    assert meta["name"] == "waifu2x.swin_unet_2x"
    assert not loaded.training
    for key, arr in to_flax(loaded).items():
        np.testing.assert_array_equal(arr, flat[key], err_msg=key)
    x = torch.from_numpy(np.random.default_rng(0).random((1, 64, 64, 3),
                                                         dtype=np.float32))
    with torch.no_grad():
        assert torch.equal(loaded(x), model(x))


def test_port_checkpoint_loads_in_jax(small, tmp_path):
    model, flat = small
    path = str(tmp_path / "port.nztm")
    save_model(model, path, train_kwargs={"note": "seeded"})
    jmodel, params, meta = jax_load_model(path)
    assert isinstance(jmodel, JaxSwinUNet2x) and jmodel.base_dim == 32
    assert meta["train_kwargs"] == {"note": "seeded"}
    from nunif_tpu.models import flatten_params
    jflat = flatten_params(params)
    assert sorted(jflat) == sorted(flat)
    for key, arr in jflat.items():
        np.testing.assert_array_equal(arr, flat[key], err_msg=key)


def test_checkpoint_meta_matches_jax_writer(small, tmp_path):
    model, flat = small
    save_model(model, str(tmp_path / "a.nztm"))
    jax_save_model(JaxSwinUNet2x(base_dim=32),
                   unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}),
                   str(tmp_path / "b.nztm"))
    meta_a, flat_a = read_checkpoint(str(tmp_path / "a.nztm"))
    meta_b, flat_b = read_checkpoint(str(tmp_path / "b.nztm"))
    for k in ("nunif_tpu_model", "name", "kwargs"):
        assert meta_a[k] == meta_b[k]
    assert sorted(flat_a) == sorted(flat_b)


def test_load_model_defaults_to_the_card(small, tmp_path, monkeypatch):
    """Without a device the model goes to CUDA; where there is none that is
    an error, never a silent CPU model.  device="cpu" is the CPU."""
    model, _flat = small
    path = str(tmp_path / "m.nztm")
    save_model(model, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(path)
    loaded, _meta = load_model(path, device="cpu")
    assert next(loaded.parameters()).device == torch.device("cpu")


def test_unported_architecture_raises(tmp_path):
    """A checkpoint of an architecture the port lacks (here cunet) raises
    ``NotPortedError``; the bundled turbo_2x checkpoints load."""
    import json
    import zipfile
    path = str(tmp_path / "cunet.nztm")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("__meta__.json", json.dumps(
            {"nunif_tpu_model": 1, "name": "waifu2x.cunet", "kwargs": {}}))
    with pytest.raises(NotPortedError, match="waifu2x.cunet.*not ported"):
        load_model(path, device="cpu")
    bundled = REPO / "models" / "waifu2x" / "turbo" / "scale2x.nztm"
    model, meta = load_model(str(bundled), device="cpu")
    assert meta["name"] == model.model_name == "waifu2x.turbo_2x"
    with pytest.raises(ValueError, match="unknown model"):
        create_model("waifu2x.no_such_model")


def test_flax_layout_mapping(small):
    model, flat = small
    assert flax_key("unet.swin1.block0.attn.qkv.weight") == \
        "unet/swin1/block0/attn/qkv/kernel"
    w = model.unet.swin1.block0.attn.qkv.weight          # Linear (out, in)
    np.testing.assert_array_equal(
        w.numpy().T, flat["unet/swin1/block0/attn/qkv/kernel"])
    k = model.unet.patch_conv1.weight                    # conv OIHW
    np.testing.assert_array_equal(
        k.numpy().transpose(2, 3, 1, 0), flat["unet/patch_conv1/kernel"])
    table = model.unet.swin1.block0.attn.relative_position_bias_table
    np.testing.assert_array_equal(
        table.numpy(), flat["unet/swin1/block0/attn/relative_position_bias_table"])


def test_from_flax_rejects_mismatch(small):
    _model, flat = small
    fresh = SwinUNet2x(base_dim=32)
    missing = dict(flat)
    missing.pop("unet/to_image/proj/bias")
    with pytest.raises(KeyError, match="to_image/proj/bias"):
        from_flax(fresh, missing)
    extra = dict(flat, **{"unet/extra/kernel": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unet/extra/kernel"):
        from_flax(fresh, extra)
    wrong = dict(flat)
    wrong["unet/up1/proj/kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="up1/proj/kernel"):
        from_flax(fresh, wrong)


def test_model_kwargs_round_trip():
    m = SwinUNet2x(base_dim=32, pre_shuffle_output=True)
    kw = model_kwargs(m)
    assert kw == {"in_channels": 3, "out_channels": 3, "base_dim": 32,
                  "layer_norm": False, "pre_shuffle_output": True}
    assert model_kwargs(create_model("waifu2x.swin_unet_2x", **kw)) == kw


@pytest.mark.parametrize("h,w,scale,offset,tile,blend", [
    (40, 56, 2, 16, 64, 8),
    (1080, 1920, 2, 16, (1120, 1936), 8),
    (540, 960, 2, 16, 256, 8),
    (37, 101, 2, 16, (64, 112), 8),
    (300, 200, 4, 32, 160, 16),
    (64, 64, 1, 8, 64, 4),
])
def test_tile_grid_matches_jax(h, w, scale, offset, tile, blend):
    got = tiling.make_tile_config(h, w, scale, offset, tile, blend)
    want = jtiling.make_tile_config(h, w, scale, offset, tile, blend)
    assert got.__dict__ == want.__dict__
    assert (got.n_tiles, got.out_tile_h, got.out_tile_w) == \
        (want.n_tiles, want.out_tile_h, want.out_tile_w)
    np.testing.assert_array_equal(
        tiling.make_blend_filter(scale, offset, tile, blend),
        jtiling.make_blend_filter(scale, offset, tile, blend))


def test_edge_pad_matches_numpy():
    x = np.random.default_rng(1).random((2, 5, 7, 3)).astype(np.float32)
    got = tiling.edge_pad(torch.from_numpy(x), 2, 3, 4, 1).numpy()
    want = np.pad(x, ((0, 0), (2, 3), (4, 1), (0, 0)), mode="edge")
    np.testing.assert_array_equal(got, want)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((REPO / "nunif_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "nunif_tpu")]
    assert not bad


def test_port_imports_without_jax_in_subprocess():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nunif_tpu_torch\n"
        "for m in pkgutil.walk_packages(nunif_tpu_torch.__path__, "
        "'nunif_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'nunif_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('nunif_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    assert int(proc.stdout.split()[1]) >= 20
