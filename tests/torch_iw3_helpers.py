"""Shared helpers of the iw3 methods' parity tests
(tests/test_torch_iw3_methods*.py, tests/test_torch_inpaint.py): seeded
inputs and weights drawn with numpy for both packages, the fp32 patch, and
the depth models of both packages on the same weights."""
import types

import numpy as np
import torch

import jax
import jax.numpy as jnp

import nunif_tpu.iw3.composition as j_composition
import nunif_tpu.iw3.depth.depth_anything as j_depth_anything
import nunif_tpu.modules.grid_sample as j_grid_sample
from nunif_tpu.models import unflatten_params

from nunif_tpu_torch.core import dtypes
from nunif_tpu_torch.iw3.depth import create_depth_model
from nunif_tpu_torch.iw3.models import mlbw as tmlbw
from nunif_tpu_torch.iw3.models import row_flow_v2 as trf2
from nunif_tpu_torch.models import create_model, from_flax

RESOLUTION = 56  # the depth net's input for 64-row frames (seconds on the CPU)


def jparams(flat):
    return unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


def t(a):
    return torch.from_numpy(np.array(a))


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def u8(x):
    return (np.clip(np.asarray(x, np.float32), 0, 1) * 255 + 0.5).astype(np.uint8)


def jax_flat_shapes(jmodel, *inputs, **kw):
    """{flax path: shape} of a JAX model's parameters for inputs of the
    given shapes (keyword inputs by name)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *[jnp.zeros(s) for s in inputs],
        **{k: jnp.zeros(s) for k, s in kw.items()}))
    return {"/".join(p.key for p in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}


def shaped(name, seed=1):
    """(port stereo net ``name`` with shaped weights, the weights in flax
    layout)."""
    model = create_model(name)
    params = (trf2.shaped_flax_params if name == "sbs.row_flow_v2"
              else tmlbw.shaped_flax_params)(model, seed)
    from_flax(model, params)
    return model.eval().requires_grad_(False), params


def depth_map(rng, b, h, w):
    """Smooth depth with sharp-edged blocks (occlusions) and noise, in
    [0, 1], (b, h, w, 1)."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    d = 0.45 + 0.25 * np.sin(5 * xx + 2 * yy)[None]
    d = np.repeat(d, b, axis=0)
    for i in range(b):
        for _ in range(4):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            d[i, y0:y0 + h // 3, x0:x0 + w // 5] = rng.uniform(0.6, 1.0)
    d = d + 0.02 * rng.standard_normal(d.shape)
    return np.clip(d, 0, 1).astype(np.float32)[..., None]


def frames():
    """Two 64x90 uint8 frames (a width no net pads away): smooth shapes, a
    darker disc, noise; depth has structure under them."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:64, 0:90] / 64.0
    base = np.stack([np.sin(3 * xx + yy), np.cos(2 * yy - xx), xx * yy], -1)
    disc = ((xx - 0.7) ** 2 + (yy - 0.5) ** 2 < 0.05)[..., None]
    f = [(0.5 + 0.3 * np.roll(base, 7 * i, axis=1) - 0.3 * disc
          + 0.1 * rng.standard_normal(base.shape)) for i in range(2)]
    return u8(np.stack(f))


def patch_fp32(monkeypatch):
    """Both packages with their hard-coded bf16 image casts resolved to
    fp32: JAX's ``jnp.bfloat16`` in three modules, the port's
    ``IMAGE_DTYPE`` (as tests/test_torch_iw3.py does)."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    for mod in (j_depth_anything, j_grid_sample, j_composition):
        monkeypatch.setattr(mod, "jnp", proxy)
    monkeypatch.setattr(dtypes, "IMAGE_DTYPE", torch.float32)


def depth_models(dflat):
    """(port fp32 Any_V2_S, JAX Any_V2_S) on the same weights, both at
    ``RESOLUTION``, on the CPU."""
    dm = create_depth_model("Any_V2_S", device="cpu", dtype=torch.float32)
    from_flax(dm.load(resolution=RESOLUTION).model, dflat)
    jdm = j_depth_anything.DepthAnythingModel("Any_V2_S")
    jdm.model = j_depth_anything.DepthAnything(encoder="vits")
    jdm.params = jparams(dflat)
    jdm.prep_lower_bound = RESOLUTION
    return dm, jdm
