"""Shared helpers of the iw3 methods' parity tests
(tests/test_torch_iw3_methods*.py, tests/test_torch_inpaint.py): seeded
inputs and weights drawn with numpy for both packages, the fp32 patch, and
the depth models of both packages on the same weights."""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nunif_tpu.iw3.composition as j_composition
from nunif_tpu.iw3 import dilation as jdil
from nunif_tpu.modules.resize import resize as j_resize
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


def jnp_fp32():
    """A stand-in for ``jax.numpy`` whose ``bfloat16`` is fp32."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.bfloat16 = jnp.float32
    return proxy


def patch_fp32(monkeypatch, *modules):
    """Both packages with their hard-coded bf16 image casts resolved to
    fp32: JAX's ``jnp.bfloat16`` in three modules (and in ``modules``), the
    port's ``IMAGE_DTYPE`` (as tests/test_torch_iw3.py does)."""
    proxy = jnp_fp32()
    for mod in (j_depth_anything, j_grid_sample, j_composition) + modules:
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


def j_hole_mask_port_order(mask_logits, target_hw, threshold,
                           inner_dilation=0, outer_dilation=0):
    """The JAX package's steps of ``postprocess_hole_mask`` in the port's
    order: resize, threshold, close, dilate."""
    base_width = mask_logits.shape[2]
    m = mask_logits.astype(jnp.float32)
    if tuple(m.shape[1:3]) != tuple(target_hw):
        m = j_resize(m, target_hw[0], target_hw[1], mode="bilinear",
                     antialias=False, align_corners=True)
    mask = jdil.mask_closing((jax.nn.sigmoid(m) > threshold).astype(jnp.float32),
                             n_iter=1)
    mask = jdil.dilate_inner(mask, n_iter=inner_dilation, base_width=base_width)
    return jdil.dilate_outer(mask, n_iter=outer_dilation, base_width=base_width)


CODE_BITS, CODE_ROWS = 4, 24  # the frame index, burnt into the top rows


def indexed_frames(n, h=96, w=256, seed=8):
    """n uint8 frames (n, h, w, 3) with structure (smooth colour fields, a
    moving block, noise) whose index i is burnt into the top CODE_ROWS
    rows as CODE_BITS black / white blocks, most significant first."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / h
    out = []
    for i in range(n):
        f = 0.5 + 0.3 * np.stack([np.sin(3 * xx + 0.2 * i), np.cos(2 * yy - xx),
                                  xx * yy / 3], -1)
        f[h // 3:2 * h // 3, 20 + 6 * i:60 + 6 * i] = 0.85
        f = f + 0.03 * rng.standard_normal(f.shape)
        bw = w // CODE_BITS
        for b in range(CODE_BITS):
            f[:CODE_ROWS, b * bw:(b + 1) * bw] = (i >> (CODE_BITS - 1 - b)) & 1
        out.append(f)
    return u8(np.stack(out))


def read_indexes(out):
    """The frame indexes burnt into half-SBS output frames (n, h, w, 3),
    read from the centres of the left eye's code blocks."""
    out = np.asarray(out, np.float32)
    bw = out.shape[2] // 2 // CODE_BITS
    idx = np.zeros(out.shape[0], np.int64)
    for b in range(CODE_BITS):
        c = b * bw + bw // 2
        v = out[:, 4:CODE_ROWS - 4, c - bw // 4:c + bw // 4].mean(axis=(1, 2, 3))
        idx = idx * 2 + (v > 0.5)
    return idx.tolist()


def add_vitt(mp, jdino, tdino, jvda, tvda):
    """Both packages' tables with the tests-only encoder ``vitt`` and a
    narrow DPT head (undone by ``mp.undo()``)."""
    for mod in (jdino, tdino):
        mp.setitem(mod.INTERMEDIATE_LAYER_IDX, "vitt", [0, 1, 1, 1])
    for mod in (jvda, tvda):
        mp.setitem(mod._DPT_CONFIGS, "vitt",
                   dict(features=16, out_channels=(8, 16, 32, 64)))


@pytest.fixture(scope="module")
def two_threads():
    """Two torch threads for a test file, restored after: the runner's
    parallel workers each default to one thread a core, which
    oversubscribes the CPU for the files that run whole networks."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the depth families' tests (tests/test_torch_depth_{families,wrappers,convert}.py)
BEIT_T = dict(embed_dim=64, depth=2, num_heads=4, pretrained_grid=4,
              hooks=(0, 1, 1, 1), neck_channels=(16, 32, 64, 64))
DPT_T = dict(features=16, out_channels=(8, 16, 32, 64))


def add_depth_tables(mp):
    """Both packages' tables with the tests-only ``vitt`` encoder (narrow
    DA / DA3 heads), ``vitt64`` (``vitt`` at one head of 64, the head dim of
    the real trunks, where q's scale 1/8 is exact in bf16: at 32 the two
    packages' twins scale bf16 q differently) and a BEiT ``beit_t`` (2
    blocks, 64 wide, 4 heads, pretrained grid 4), undone by
    ``mp.undo()``."""
    import nunif_tpu.iw3.depth.da3 as jda3
    import nunif_tpu.iw3.depth.dinov2 as jdino
    import nunif_tpu.iw3.depth.midas as jmidas
    import nunif_tpu_torch.iw3.depth.da3 as tda3
    import nunif_tpu_torch.iw3.depth.depth_anything as tda
    import nunif_tpu_torch.iw3.depth.dinov2 as tdino
    import nunif_tpu_torch.iw3.depth.midas as tmidas
    for mod in (jdino, tdino):
        mp.setitem(mod.VIT_CONFIGS, "vitt64", dict(embed_dim=64, depth=2, num_heads=1))
        for name in ("vitt", "vitt64"):
            mp.setitem(mod.INTERMEDIATE_LAYER_IDX, name, [0, 1, 1, 1])
    for mod in (jda3, tda3, j_depth_anything, tda):
        for name in ("vitt", "vitt64"):
            mp.setitem(mod._DPT_CONFIGS, name, DPT_T)
    for mod in (jmidas, tmidas):
        mp.setitem(mod.BEIT_CONFIGS, "beit_t", BEIT_T)


def seeded(model, fills=None, seed=0):
    """(model with ``seeded_weights_``, its flax-layout arrays, JAX params)."""
    from nunif_tpu_torch.iw3.depth.base import seeded_weights_
    from nunif_tpu_torch.models import to_flax
    seeded_weights_(model, torch.Generator().manual_seed(seed), fills=fills)
    model.eval().requires_grad_(False)
    flat = to_flax(model)
    return model, flat, jparams(flat)


def rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def hold_bf16(got16, want32, jax16, slack=1.0, stat="rms"):
    """The port's bf16 error against JAX's fp32 output within ``slack``
    times JAX's own bf16 error: RMS, or with ``stat="mae"`` the mean
    absolute error (for maps whose RMS error is ruled by a few pixels) and
    the largest error within 2x JAX's."""
    if stat == "mae":
        got16, want32, jax16 = (np.asarray(a, np.float64) for a in (got16, want32, jax16))
        err, jax_err = np.abs(got16 - want32).mean(), np.abs(jax16 - want32).mean()
        worst, jax_worst = np.abs(got16 - want32).max(), np.abs(jax16 - want32).max()
        assert worst <= 2 * jax_worst, (worst, jax_worst)
    else:
        err, jax_err = rms(got16, want32), rms(jax16, want32)
    assert err <= slack * jax_err, (err, jax_err)
