"""iw3's other depth families in nunif_tpu_torch against the JAX package, on
the CPU, module by module: the MiDaS BEiT core (the resized relative-
position bias, the attention, ``MidasCore``), ZoeDepth's metric bins head,
``ConditionalLogBinomial`` and ZoeD_NK's router (its logits in fp32 and
bf16, a near-tied batch vote), DepthPro (tiles, the net with its FOV
head), Depth-Anything-V3 mono (``da3_disparity`` in both branches, the
net), the scaler's "max" mode, NULL and the factory.  The wrappers and the
frame path: tests/test_torch_depth_wrappers.py; raw checkpoints:
tests/test_torch_depth_convert.py.

Both packages get the same weights: ``base.seeded_weights_`` fills the
port's net from a seed, and JAX reads the arrays ``to_flax`` gives.  Small
configs added to both packages' tables for the module (undone after,
``torch_iw3_helpers.add_depth_tables``): the ``vitt64`` encoder (2 blocks,
64 wide, one head of 64 as in the real trunks) with a narrow DA3 head, and
a BEiT ``beit_t`` (2 blocks, 64 wide, 4 heads, pretrained grid 4, so the
relative-position bias is resized).
Inputs are seeded numpy arrays.

Tolerances: fp32 to 1e-4 (sums in another order); bf16 (cast at the
input): the port's RMS error against JAX's fp32 output no larger than
JAX's own bf16 RMS error (x 1.1 where the two round the same points in
another order, as tests/test_torch_depth.py).
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.iw3 import depth_scaler as j_scaler
from nunif_tpu.iw3.depth import da3 as j3
from nunif_tpu.iw3.depth import depth_pro as jpro
from nunif_tpu.iw3.depth import factory as jfactory
from nunif_tpu.iw3.depth import midas as jmidas
from nunif_tpu.iw3.depth import null_model as jnull
from nunif_tpu.iw3.depth import zoedepth as jz

from nunif_tpu_torch.iw3 import depth_scaler as t_scaler
from nunif_tpu_torch.iw3.depth import create_depth_model, DEPTH_MODEL_TYPES
from nunif_tpu_torch.iw3.depth import da3 as t3
from nunif_tpu_torch.iw3.depth import depth_pro as tpro
from nunif_tpu_torch.iw3.depth import midas as tmidas
from nunif_tpu_torch.iw3.depth import zoedepth as tz
from nunif_tpu_torch.iw3.depth.base import SEEDED_FILLS as FILLS
from nunif_tpu_torch.models import to_flax

import torch_iw3_helpers as h

pytestmark = pytest.mark.usefixtures("two_threads")
two_threads = h.two_threads

@pytest.fixture(scope="module", autouse=True)
def tables():
    mp = pytest.MonkeyPatch()
    h.add_depth_tables(mp)
    yield
    mp.undo()


_seeded, _rms, _hold_bf16 = h.seeded, h.rms, h.hold_bf16


def _np32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not torch.is_tensor(a) \
        else a.float().numpy()


def _same_tree(flat, jmodel, *inputs):
    assert {k: v.shape for k, v in flat.items()} == h.jax_flat_shapes(jmodel, *inputs)


# --------------------------------------------------------------------------
# MiDaS BEiT core
# --------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [(4, 4), (6, 8), (2, 5), (3, 2)])
def test_beit_bias_table_resize_and_index_match_jax(grid):
    """The pretrained 7x7 table resized as jax.image.resize(bilinear) does
    (grows and shrinks, antialiased), the index as JAX's."""
    gh, gw = grid
    table = np.random.default_rng(1).normal(0, 0.5, (7 * 7 + 3, 4)).astype(np.float32)
    got = tmidas.resize_bias_table(torch.from_numpy(table), 4, gh, gw).numpy()
    if (gh, gw) == (4, 4):
        want = table
    else:
        grid_part = jax.image.resize(jnp.asarray(table[:-3].reshape(7, 7, 4)),
                                     (2 * gh - 1, 2 * gw - 1, 4), method="bilinear")
        want = np.concatenate([np.asarray(grid_part).reshape(-1, 4), table[-3:]])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tmidas.relative_position_index(gh, gw),
                                  jmidas._relative_position_index(gh, gw))


def test_beit_attention_matches_jax():
    """One BEiT attention on a 6x8 grid (bias resized from 4x4): fp32 to
    1e-5; the cached bias is rebuilt after a weight load."""
    m, flat, jp = _seeded(tmidas.BeitAttention(64, 4, 4))
    x = np.random.default_rng(2).standard_normal((2, 49, 64)).astype(np.float32)
    jm = jmidas.BeitAttention(64, 4, 4)
    want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v, (6, 8)))(jp, jnp.asarray(x)))
    got = m(torch.from_numpy(x), (6, 8)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    b0 = m.position_bias(6, 8).clone()
    with torch.no_grad():
        m.relative_position_bias_table.mul_(2.0)
    assert torch.allclose(m.position_bias(6, 8), 2 * b0)


def test_midas_core_matches_jax():
    """MidasCore (tiny BEiT, features 256): relative depth and the six taps
    at fp32 to 1e-4, on a grid that grows the bias in width and one that
    shrinks it in height; bf16 within JAX's own bf16 error."""
    m, flat, jp = _seeded(tmidas.MidasCore("beit_t"), {"output_conv2_2/bias": [1.0]})
    jm = jmidas.MidasCore(backbone="beit_t")
    _same_tree(flat, jm, (1, 64, 96, 3))
    fwd = jax.jit(lambda p, v: jm.apply({"params": p}, v))
    for hw in ((64, 96), (32, 64)):
        x = np.random.default_rng(3).standard_normal((2,) + hw + (3,)).astype(np.float32)
        rel_j, taps_j = fwd(jp, jnp.asarray(x))
        rel_t, taps_t = m(torch.from_numpy(x))
        assert float(rel_t.std()) > 0.1
        np.testing.assert_allclose(rel_t.numpy(), np.asarray(rel_j), rtol=1e-4, atol=1e-4)
        for a, b in zip(taps_t, taps_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)
    j16 = _np32(fwd(jp, jnp.asarray(x, jnp.bfloat16))[0])
    _hold_bf16(m(torch.from_numpy(x).bfloat16())[0].float().numpy(), np.asarray(rel_j), j16)


# --------------------------------------------------------------------------
# ZoeDepth heads and nets
# --------------------------------------------------------------------------

def _zoe_features(rng, B=2, H=32, W=48):
    shapes = [(B, H, W, 32), (B, H // 16, W // 16, 256), (B, H // 16, W // 16, 256),
              (B, H // 8, W // 8, 256), (B, H // 4, W // 4, 256), (B, H // 2, W // 2, 256)]
    return (rng.uniform(0, 1, (B, H, W)).astype(np.float32),
            [rng.standard_normal(s).astype(np.float32) for s in shapes])


def test_bins_head_matches_jax():
    """MetricBinsHead on random taps: seed bins, four attractor levels
    (each resizing the previous centres), the log-binomial expectation."""
    m, flat, jp = _seeded(tz.MetricBinsHead())
    rel, feats = _zoe_features(np.random.default_rng(4))
    jm = jz.MetricBinsHead()
    want = np.asarray(jax.jit(lambda p, r, f: jm.apply({"params": p}, r, f))(
        jp, jnp.asarray(rel), [jnp.asarray(f) for f in feats]))
    got = m(torch.from_numpy(rel), [torch.from_numpy(f) for f in feats]).numpy()
    assert got.shape == (2, 32, 48, 1) and got.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t_bias,atol", [(0.0, 1e-4), (-3.0, 1e-4), (-8.0, 1e-3)])
def test_conditional_log_binomial_matches_jax(t_bias, atol):
    """The distribution over 64 bins as the temperature falls: the mlp's
    fourth channel at +6 and its third at ``t_bias`` give t ~ 5, ~ 0.4 and
    ~ 0.03 (floor 0.0212).  fp32 to 1e-4 (measured 4e-7, 1.2e-5); near the
    floor the logits, O(100), are divided by t, so their fp32 ulps (and the
    2-ulp gap between XLA's CPU lgamma and torch's) grow 40x: 1e-3
    (measured 1.9e-4)."""
    m, flat, jp = _seeded(tz.ConditionalLogBinomial(33, 128, 64, bottleneck=40,
                                                    min_temp=0.0212))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 12, 33)).astype(np.float32)
    cond = rng.standard_normal((2, 4, 6, 128)).astype(np.float32)
    with torch.no_grad():
        m.mlp_conv2.bias[2] = t_bias
        m.mlp_conv2.bias[3] = 6.0
    jp = h.jparams(to_flax(m))
    jm = jz.ConditionalLogBinomial(64, bottleneck=40, min_temp=0.0212)
    want = np.asarray(jax.jit(lambda p, a, c: jm.apply({"params": p}, a, c))(
        jp, jnp.asarray(x), jnp.asarray(cond)))
    got = m(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    if t_bias == -8.0:
        assert got.max() > 0.5  # sharp rows


@pytest.fixture(scope="module")
def nk():
    return _seeded(tz.ZoeDepthNKNet(core="beit_t"), FILLS["ZoeD_N"])


def _router_jax(jp, btl):
    import flax.linen as fnn
    e = jz.PatchTransformerEncoder().apply({"params": jp["patch_transformer"]}, btl)
    logit = fnn.relu(fnn.Dense(128, dtype=e.dtype).apply({"params": jp["mlp_classifier_0"]}, e))
    logit = fnn.Dense(2, dtype=e.dtype).apply({"params": jp["mlp_classifier_2"]}, logit)
    return logit.astype(jnp.float32)  # as the net's vote reads them


def test_nk_router_logits_match_jax_fp32_and_bf16(nk):
    """The patch-transformer router on one bottleneck: fp32 to 1e-5; bf16
    (flax's roundings: two a Dense, q / sqrt(d) and the scores in bf16, the
    softmax's sum over fp32 exps) within JAX's own bf16 error; a softmax in
    fp32 instead would not be."""
    m, flat, jp = nk
    btl = np.random.default_rng(6).standard_normal((4, 3, 4, 256)).astype(np.float32)
    fwd = jax.jit(_router_jax)
    want32 = np.asarray(fwd(jp, jnp.asarray(btl)))
    want16 = _np32(fwd(jp, jnp.asarray(btl, jnp.bfloat16)))
    np.testing.assert_allclose(m.router_logits(torch.from_numpy(btl)).numpy(), want32,
                               rtol=0, atol=1e-5)
    got16 = m.router_logits(torch.from_numpy(btl).bfloat16()).float().numpy()
    _hold_bf16(got16, want32, want16, slack=1.1)
    assert np.abs(got16 - want16).max() <= 4 * np.abs(want16 - want32).max()


@pytest.mark.parametrize("lean", [+1, -1])
def test_nk_near_tied_vote_matches_jax(nk, lean):
    """The batch vote nearly tied (the classifier's bias moved so that the
    summed softmax differs by ~1e-3): both packages pick the same head for
    the whole batch, and the net equals JAX's to 1e-4.  ``lean`` picks the
    side of the tie."""
    m = tz.ZoeDepthNKNet(core="beit_t")
    m.load_state_dict(nk[0].state_dict())
    m.eval().requires_grad_(False)
    x = np.random.default_rng(7).standard_normal((3, 32, 64, 3)).astype(np.float32)
    rel, feats = m.core(torch.from_numpy(x))
    logits = m.router_logits(feats[1])
    vote = torch.softmax(logits.float(), -1).sum(0)
    # shift both logits' gap by a constant: vote[0] - vote[1] ~ lean * 1e-3
    from scipy.optimize import brentq
    gap = lambda c: float(torch.softmax(logits + torch.tensor([c, 0.0]), -1).sum(0).diff())  # noqa: E731
    c = brentq(lambda c: gap(c) + lean * 1e-3, -30, 30)
    with torch.no_grad():
        m.mlp_classifier_2.bias[0] += c
    jp = h.jparams(to_flax(m))
    vote = torch.softmax(m.router_logits(feats[1]).float(), -1).sum(0)
    assert abs(float(vote[0] - vote[1]) - lean * 1e-3) < 1e-4
    jm = jz.ZoeDepthNKNet(core="beit_t")
    want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v))(jp, jnp.asarray(x)))
    got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    d_n = m.bin_head_nyu(rel, feats).numpy()
    d_k = m.bin_head_kitti(rel, feats).numpy()
    picked = d_n if lean > 0 else d_k
    np.testing.assert_array_equal(got, picked)
    assert np.abs(d_n - d_k).max() > 1e-3


# --------------------------------------------------------------------------
# DepthPro
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size,tile,stride,pad", [(512, 128, 96, 2), (256, 128, 64, 4)])
def test_split_and_merge_tiles_match_jax(size, tile, stride, pad):
    x = np.random.default_rng(9).standard_normal((2, size, size, 3)).astype(np.float32)
    got, steps = tpro._split_tiles(torch.from_numpy(x), tile, stride)
    want, jsteps = jpro._split_tiles(jnp.asarray(x), tile, stride)
    assert steps == jsteps
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    feats = np.random.default_rng(10).standard_normal((2 * steps * steps, 8, 8, 5)).astype(np.float32)
    np.testing.assert_array_equal(tpro._merge_tiles(torch.from_numpy(feats), 2, steps, pad).numpy(),
                                  np.asarray(jpro._merge_tiles(jnp.asarray(feats), 2, steps, pad)))


def _pro(tile=128, pos=8):
    return _seeded(tpro.DepthPro(encoder="vitt64", tile_size=tile, pos_embed_size=pos), FILLS["DepthPro"])


def test_depth_pro_net_matches_jax():
    """DepthPro at vitt64 / tile 128 (35 tiles of 8x8 tokens, hooks 0 and 1,
    the FOV head): canonical inverse depth and FOV at fp32 to 1e-4; bf16
    within JAX's own bf16 error (x 1.1)."""
    m, flat, jp = _pro()
    jm = jpro.DepthPro(encoder="vitt64", tile_size=128, pos_embed_size=8)
    _same_tree(flat, jm, (1, 512, 512, 3))
    x = np.random.default_rng(11).standard_normal((1, 512, 512, 3)).astype(np.float32)
    fwd = jax.jit(lambda p, v: tuple(a.astype(jnp.float32) for a in jm.apply({"params": p}, v)))
    (c32, f32), (c16, f16) = fwd(jp, jnp.asarray(x)), fwd(jp, jnp.asarray(x, jnp.bfloat16))
    cid, fov = m(torch.from_numpy(x))
    assert cid.shape == (1, 512, 512, 1) and float(cid.std()) > 0.05
    np.testing.assert_allclose(cid.numpy(), np.asarray(c32), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(fov.numpy(), np.asarray(f32), rtol=1e-5)
    cid16, _fov16 = m(torch.from_numpy(x).bfloat16())
    _hold_bf16(cid16.numpy(), c32, c16, slack=1.1)


# --------------------------------------------------------------------------
# Depth-Anything-V3 mono, the scaler's max mode, NULL
# --------------------------------------------------------------------------

@pytest.mark.parametrize("raw_output", [False, True])
def test_da3_disparity_matches_jax(raw_output):
    """Both branches on three frames: mixed sky, no sky, all sky (fewer
    than 10 non-sky pixels: zeroed, or the raw depth kept)."""
    rng = np.random.default_rng(12)
    depth = rng.uniform(0.5, 20.0, (3, 24, 32)).astype(np.float32)
    sky = rng.uniform(0, 1, (3, 24, 32)).astype(np.float32) ** 2
    sky[1] = 0.1
    sky[2] = 0.9
    sky[2, 0, :5] = 0.0
    want = np.asarray(j3.da3_disparity(jnp.asarray(depth), jnp.asarray(sky),
                                       raw_output=raw_output))
    got = t3.da3_disparity(torch.from_numpy(depth), torch.from_numpy(sky),
                           raw_output=raw_output).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[2] == (depth[2, ..., None] if raw_output else 0)).all()


def test_da3_quantile_row_limit_raises():
    d = torch.ones(1, 1, t3.QUANTILE_MAX_ROW + 1)
    with pytest.raises(ValueError, match="nanquantile"):
        t3.da3_disparity(d, torch.zeros_like(d), raw_output=True)


def test_da3_net_matches_jax():
    m, flat, jp = _seeded(t3.DepthAnythingV3Mono("vitt64"), FILLS["Any_V3_Mono"])
    jm = j3.DepthAnythingV3Mono(encoder="vitt64")
    _same_tree(flat, jm, (1, 70, 98, 3))
    x = np.random.default_rng(13).standard_normal((2, 70, 98, 3)).astype(np.float32)
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v))(jp, jnp.asarray(x))
    got = m(torch.from_numpy(x))
    for key in ("depth", "sky"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4, atol=1e-4)
    sky = got["sky"].numpy() > 0.3
    assert 0.02 < sky.mean() < 0.98  # some sky, some not


@pytest.mark.parametrize("mode", ["max", "minmax"])
def test_scaler_modes_match_jax(mode):
    """EMA scaler (decay 0.5, lookahead 2) in both modes over three batches
    and the flush; "max" ignores the minimum and keeps non-positive maxima
    clipped."""
    rng = np.random.default_rng(14)
    batches = [rng.uniform(-0.5, 3.0, (2, 5, 6, 1)).astype(np.float32) for _ in range(3)]
    batches[1][1] = -1.0  # max <= 0
    ts = t_scaler.EMAMinMaxScaler(decay=0.5, buffer_size=2, mode=mode)
    js = j_scaler.EMAMinMaxScaler(decay=0.5, buffer_size=2, mode=mode)
    for b in batches:
        got = ts.update_batch(torch.from_numpy(b))
        want = js.update_batch(jnp.asarray(b))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    for g, w in zip(ts.flush(), js.flush()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    f = torch.from_numpy(batches[0][0])
    np.testing.assert_allclose(t_scaler.max_normalize(f, 0.0, -1.0).numpy(),
                               np.asarray(j_scaler.max_normalize(jnp.asarray(batches[0][0]), 0.0, -1.0)))


@pytest.mark.parametrize("edge_dilation", [0, 2])
def test_null_model_matches_jax(edge_dilation):
    x = np.random.default_rng(15).uniform(0, 1, (2, 50, 70, 3)).astype(np.float32)
    dm = create_depth_model("NULL", device="cpu").load(resolution=40)
    jdm = jnull.NullDepthModel().load(resolution=40)
    got = dm.infer(torch.from_numpy(x), edge_dilation=edge_dilation).numpy()
    want = np.asarray(jdm.infer(jnp.asarray(x), edge_dilation=edge_dilation))
    assert got.shape == (2, 40, 40, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert dm.infer(torch.from_numpy(x[0])).shape == (40, 40, 1)


# --------------------------------------------------------------------------
# the factory
# --------------------------------------------------------------------------

def test_factory_matches_jax_and_creates_every_type():
    """The same names in the same order; every type builds a wrapper on
    the CPU and reports the JAX wrapper's name and capabilities."""
    assert DEPTH_MODEL_TYPES == list(jfactory.DEPTH_MODEL_TYPES)
    for name in DEPTH_MODEL_TYPES:
        dm = create_depth_model(name, device="cpu")
        jdm = jfactory.create_depth_model(name)
        assert dm.get_name() == jdm.get_name(), name
        assert dm.is_metric() == jdm.is_metric(), name
        assert dm.is_video_supported() == jdm.is_video_supported(), name
    with pytest.raises(ValueError, match="not supported"):
        create_depth_model("MiDaS", device="cpu")
    assert create_depth_model("Any_V3_Mono", device="cpu", raw_output=True).raw_output
