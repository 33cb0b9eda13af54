"""Reference ``.pth`` checkpoints of the iw3, inpaint, cliqa and stlizer
rows through the port's ``load_model`` and the JAX package's.

Each state dict comes from tests/torch_pth_states.py: a reference module
of tests/torchref/ (seeded torch init, every BatchNorm given seeded
running statistics and affine terms, so that folding it into the convs is
not the identity), saved in the nunif envelope.  For every row and alias the port's converted weights
must equal the JAX importer's leaf for leaf.  For each converter the
port's model, loaded on the CPU, must give the JAX model's output on the
same input at fp32 within 1e-4 (the same products summed in another
order); the aliases share those converters and classes, so their leaves
carry the check.  Three JAX rows fail, each documented by a
``*_diverges_from_jax`` test: ``iw3.sod_v1`` (its tree lacks the model's
``u2netp`` scope), ``iw3.dsod_v1`` (an alias ``create_model`` does not
know) and ``sbs.mlbw_l2s`` / ``sbs.mlbw_l4s`` (``small`` taken from the
envelope's kwargs).
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.models import flatten_params
from nunif_tpu.models import load_model as jax_load_model
from nunif_tpu.models.pth_import import supported_torch_models as jax_supported
import nunif_tpu.cliqa  # noqa: F401
import nunif_tpu.iw3  # noqa: F401
import nunif_tpu.stlizer.light_outpaint_v1  # noqa: F401

from nunif_tpu_torch.models import load_model, to_flax
from nunif_tpu_torch.models.pth_import import supported_torch_models
from torch_pth_states import ROWS, reference_state, save_pth

ATOL = 1e-4


# the sod rows fail in JAX: the *_diverges_from_jax tests below
JAX_ROWS = sorted(n for n, (_kw, kind, _rk) in ROWS.items() if kind != "sod_v1")


def copy_file(src, dst):
    """A second file with the same bytes, so that each package writes its
    own cache beside its own .pth."""
    with open(src, "rb") as f, open(dst, "wb") as g:
        g.write(f.read())
    return str(dst)


def both_loads(tmp_path, name, seed=0):
    """(port model, JAX model, JAX params) of the row's reference .pth."""
    kwargs, kind, ref_kw = ROWS[name]
    sd, _tm = reference_state(kind, seed, **ref_kw)
    path = save_pth(tmp_path / "m.pth", name, kwargs, sd)
    model, meta = load_model(path, device="cpu")
    assert meta == {"name": name, "kwargs": kwargs, "imported_from": path}
    jmodel, jparams, _ = jax_load_model(copy_file(path, tmp_path / "j.pth"))
    return model, jmodel, jparams


def assert_same_leaves(model, jparams):
    jflat = {k: np.asarray(v) for k, v in flatten_params(jparams).items()}
    flat = to_flax(model)
    assert set(flat) == set(jflat)
    for key in flat:
        np.testing.assert_array_equal(flat[key], jflat[key], err_msg=key)


@pytest.mark.parametrize("name", JAX_ROWS)
def test_pth_row_converts_as_in_jax(name, tmp_path):
    """The row's weights equal the JAX importer's, and the port's model is
    the one the JAX row builds (an alias resolves to its class)."""
    model, jmodel, jparams = both_loads(tmp_path, name)
    assert model.model_name == jmodel.model_name
    assert_same_leaves(model, jparams)
    assert os.path.exists(str(tmp_path / "m.pth") + ".nztm")


def _image(rng, shape):
    return rng.random(shape, dtype=np.float32)


def _mask(rng, shape):
    return (rng.random(shape) > 0.7).astype(np.float32)


# converter: (row that reaches it, inputs (numpy) of one forward)
FORWARDS = {
    "row_flow_v2": ("sbs.row_flow_v2", lambda r: ((_image(r, (1, 24, 70, 3)),), {})),
    "row_flow_v3": ("sbs.row_flow_v3", lambda r: ((_image(r, (1, 24, 70, 3)),), {})),
    "mlbw": ("sbs.mask_mlbw_l2", lambda r: ((_image(r, (1, 24, 70, 3)),), {})),
    "light_inpaint_v1": ("inpaint.light_inpaint_v1", lambda r: (
        (_image(r, (1, 40, 56, 3)),), {"mask": _mask(r, (1, 40, 56, 1))})),
    "light_video_inpaint_v1": ("inpaint.light_video_inpaint_v1", lambda r: (
        (_image(r, (12, 24, 40, 3)),), {"mask": _mask(r, (12, 24, 40, 1))})),
    "depth_aa": ("iw3.depth_aa", lambda r: ((_image(r, (1, 40, 56, 1)),), {})),
    "cliqa_jpeg": ("cliqa.jpeg_quality", lambda r: ((_image(r, (2, 64, 64, 3)),), {})),
    "cliqa_noise": ("cliqa.grain_noise_level", lambda r: ((_image(r, (2, 64, 64, 3)),), {})),
    "cliqa_scale": ("cliqa.scale_factor", lambda r: ((_image(r, (2, 64, 64, 3)),), {})),
    "light_outpaint_v1": ("stlizer.light_outpaint_v1", lambda r: (
        (_image(r, (1, 40, 56, 3)),), {"mask": _mask(r, (1, 40, 56, 1))})),
}


def _outputs(y):
    return [np.asarray(a, np.float32) for a in (y if isinstance(y, tuple) else (y,))]


@pytest.mark.parametrize("converter", sorted(FORWARDS))
def test_pth_row_forward_matches_jax(converter, tmp_path):
    """One forward of the loaded model on the CPU against the JAX model on
    the JAX importer's weights, fp32, atol 1e-4."""
    name, inputs = FORWARDS[converter]
    model, jmodel, jparams = both_loads(tmp_path, name)
    args, kw = inputs(np.random.default_rng(7))
    with torch.no_grad():
        got = _outputs(model(*map(torch.from_numpy, args),
                             **{k: torch.from_numpy(v) for k, v in kw.items()}))
    fwd = jax.jit(lambda p, a, k: jmodel.apply({"params": p}, *a, **k))
    want = _outputs(fwd(jparams, tuple(map(jnp.asarray, args)),
                        {k: jnp.asarray(v) for k, v in kw.items()}))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_supported_names_are_the_jax_rows():
    """The port imports every name the JAX importer lists."""
    assert supported_torch_models() == sorted(jax_supported())


def test_sod_v1_row_diverges_from_jax(tmp_path):
    """iw3.sod_v1: the JAX row's tree is U2NETP's own (``stage1/...``), so
    the JAX model cannot run on it; the port wraps it in the model's
    ``u2netp`` scope, and its leaves are the JAX converter's."""
    sd, _net = reference_state("sod_v1", seed=3)
    path = save_pth(tmp_path / "sod.pth", "iw3.sod_v1", {}, sd)
    model, _meta = load_model(path, device="cpu")
    jmodel, jparams, _ = jax_load_model(copy_file(path, tmp_path / "j.pth"))
    jflat = {k: np.asarray(v) for k, v in flatten_params(jparams).items()}
    assert "stage1/rebnconvin/kernel" in jflat  # the JAX fault: no scope
    with pytest.raises(Exception):
        jmodel.apply({"params": jparams}, jnp.zeros((1, 32, 32, 4)))
    flat = to_flax(model)
    assert set(flat) == {f"u2netp/{k}" for k in jflat}
    for key, a in jflat.items():
        np.testing.assert_array_equal(flat[f"u2netp/{key}"], a, err_msg=key)


def test_dsod_v1_alias_diverges_from_jax(tmp_path):
    """iw3.dsod_v1: the JAX row hands the alias to create_model, which
    raises; the port builds the canonical iw3.sod_v1 and loads the same
    weights as for an iw3.sod_v1 file."""
    sd, _net = reference_state("sod_v1", seed=4)
    path = save_pth(tmp_path / "dsod.pth", "iw3.dsod_v1", {}, sd)
    with pytest.raises(ValueError, match="unknown model"):
        jax_load_model(copy_file(path, tmp_path / "j.pth"))
    model, meta = load_model(path, device="cpu")
    assert model.model_name == "iw3.sod_v1" and meta["name"] == "iw3.dsod_v1"
    canonical, _ = load_model(save_pth(tmp_path / "sod.pth", "iw3.sod_v1", {}, sd),
                              device="cpu")
    ours, theirs = to_flax(model), to_flax(canonical)
    for key in theirs:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


@pytest.mark.parametrize("layers", [2, 4])
def test_mlbw_small_alias_diverges_from_jax(layers, tmp_path):
    """sbs.mlbw_l2s / _l4s in the envelope (no kwargs: the name implies
    small): the JAX converter reads ``small`` from the kwargs only and
    looks for the four blocks of a full MLBW; the port reads it from the
    model and gives the reference module's delta."""
    sd, tm = reference_state("mlbw", seed=5, num_layers=layers, small=True)
    path = save_pth(tmp_path / "s.pth", f"sbs.mlbw_l{layers}s", {}, sd)
    with pytest.raises(KeyError, match="lv2.2"):
        jax_load_model(copy_file(path, tmp_path / "j.pth"))
    model, _meta = load_model(path, device="cpu")
    assert model.small and model.num_layers == layers
    x = np.random.default_rng(8).random((1, 24, 70, 3), dtype=np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))[0].numpy()
        got = model(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got.transpose(0, 3, 1, 2), want, rtol=0, atol=ATOL)
