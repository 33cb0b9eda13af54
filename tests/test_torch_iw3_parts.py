"""Parts of the iw3 frame path of nunif_tpu_torch against the JAX package,
on the CPU: row_flow_v3, composition, mapper, depth scaler and edge
dilation (the whole path: tests/test_torch_iw3.py).

Inputs and weights are drawn with numpy and given to both packages.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.iw3 import dilation as jdil
from nunif_tpu.iw3 import mapper as jmapper
from nunif_tpu.iw3.backward_warp import make_input_tensor as j_make_input
from nunif_tpu.iw3.composition import StereoFormat as JFormat
from nunif_tpu.iw3.composition import postprocess_image as j_postprocess
from nunif_tpu.iw3.depth_scaler import EMAMinMaxScaler as JScaler
from nunif_tpu.iw3.models.row_flow_v3 import RowFlowV3 as JRowFlowV3
from nunif_tpu.models import model_kwargs as j_model_kwargs, unflatten_params

from nunif_tpu_torch.iw3 import dilation as tdil
from nunif_tpu_torch.iw3 import mapper as tmapper
from nunif_tpu_torch.iw3.backward_warp import make_input_tensor
from nunif_tpu_torch.iw3.composition import StereoFormat, postprocess_image
from nunif_tpu_torch.iw3.depth_scaler import EMAMinMaxScaler
from nunif_tpu_torch.iw3.models.row_flow_v3 import RowFlowV3, shaped_flax_params
from nunif_tpu_torch.models import from_flax, model_kwargs, to_flax


@pytest.fixture(scope="module")
def weights():
    return None, shaped_flax_params(RowFlowV3(), 1)


def _jparams(flat):
    return unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


def test_param_trees_and_kwargs_match_jax():
    model = RowFlowV3()
    jmodel = JRowFlowV3()
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 24, 96, 3))))
    jflat = {"/".join(p.key for p in path): leaf.shape for path, leaf in
             jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    assert {k: v.shape for k, v in to_flax(model).items()} == jflat
    assert model_kwargs(model) == j_model_kwargs(jmodel)


def test_row_flow_v3_matches_jax(weights):
    """row_flow_v3 alone, fp32 (as on the path), on a packed depth input."""
    _dflat, fflat = weights
    model = RowFlowV3()
    from_flax(model, fflat)
    rng = np.random.default_rng(8)
    depth = rng.random((2, 30, 100, 1), dtype=np.float32)
    xj = j_make_input(None, jnp.asarray(depth), 2.0, 0.5, 100)
    xt = make_input_tensor(None, torch.from_numpy(depth), 2.0, 0.5, 100)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    want = np.asarray(jax.jit(JRowFlowV3().apply)({"params": _jparams(fflat)}, xj))
    with torch.no_grad():
        got = model(xt).numpy()
    assert got.shape == want.shape == (2, 30, 100, 1)
    assert got.std() > 1.0  # shaped: deltas of pixels, not fractions
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["sbs", "half_sbs", "tb", "half_tb",
                                  "cross_eyed"])
def test_composition_matches_jax(name):
    rng = np.random.default_rng(9)
    left, right = (rng.random((2, 10, 16, 3), dtype=np.float32) for _ in range(2))
    fmt = StereoFormat.from_name(name)
    fmt.ipd_offset, fmt.pad = 10.0, 0.2
    jfmt = JFormat.from_name(name)
    jfmt.ipd_offset, jfmt.pad = 10.0, 0.2
    got = postprocess_image(torch.from_numpy(left), torch.from_numpy(right), fmt)
    want = np.asarray(j_postprocess(jnp.asarray(left), jnp.asarray(right), jfmt))
    assert got.shape == want.shape
    # half formats resize in bf16 in both packages (same rounding points)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["none", "pow2", "softplus", "softplus2",
                                  "mul_1", "mul_3", "inv_mul_1", "inv_mul_3",
                                  "shift_045", "shift_30", "div_25", "div_1",
                                  "mul_1+mul_2=0.3", "softplus:div_6"])
def test_mapper_matches_jax(name):
    d = np.linspace(0, 1, 101, dtype=np.float32).reshape(1, 101)
    got = tmapper.get_mapper(name)(torch.from_numpy(d)).numpy()
    want = np.asarray(jmapper.get_mapper(name)(jnp.asarray(d)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fs,metric", [(0, False), (1.5, False), (-2.25, False),
                                       (2, True), (None, False)])
def test_mapper_name_resolution_matches_jax(fs, metric):
    mapper = "auto" if fs is None else None
    fs = fs or 0
    assert tmapper.resolve_mapper_name(mapper, fs, metric) == \
        jmapper.resolve_mapper_name(mapper, fs, metric)


def test_scaler_matches_jax():
    """update_batch with lookahead and a scene reset, update_values, flush."""
    rng = np.random.default_rng(10)
    frames = rng.random((5, 4, 6, 1), dtype=np.float32) * \
        np.arange(1, 6, dtype=np.float32).reshape(5, 1, 1, 1)
    flags = [False, True, False, False, False]
    ts, js = EMAMinMaxScaler(0.75, 2), JScaler(0.75, 2)
    got = ts.update_batch(torch.from_numpy(frames), reset_flags=flags)
    want = js.update_batch(jnp.asarray(frames), reset_flags=flags)
    got += ts.flush()
    want += js.flush()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    mm = np.stack([frames.min(axis=(1, 2, 3)), frames.max(axis=(1, 2, 3))], -1)
    ts, js = EMAMinMaxScaler(0.9, 1), JScaler(0.9, 1)
    np.testing.assert_allclose(ts.update_values(mm, reset_flags=flags),
                               js.update_values(mm, reset_flags=flags))
    flat = np.full((1, 2, 2, 1), 3.0, np.float32)  # flat range: clip(frame)
    assert float(EMAMinMaxScaler().update_batch(torch.from_numpy(flat))[0].max()) == 1.0


@pytest.mark.parametrize("n", [2, (2, 1), (1, 3), 0])
def test_dilate_edge_matches_jax(n):
    x = np.random.default_rng(11).random((2, 12, 17, 1), dtype=np.float32)
    got = tdil.dilate_edge(torch.from_numpy(x), n).numpy()
    want = np.asarray(jdil.dilate_edge(jnp.asarray(x), n))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tdil.edge_weight(torch.from_numpy(x)).numpy(),
                               np.asarray(jdil.edge_weight(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
