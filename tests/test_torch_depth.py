"""Depth-Anything (DINOv2 + DPT) of nunif_tpu_torch against the JAX package,
on the CPU.

Both packages get the same seeded weights, drawn with numpy in flax layout
(``shaped_flax_params``: the depth map is not flat); JAX parameters come
from the port's arrays, not from a JAX init.  Full width (ViT-S, 384 wide,
12 blocks; DPT 64 features) at small images.  Tolerances, fp32: sums in
another order, measured <= 1e-5 on O(1) outputs.  bf16: the two packages
round at the same points of the network but not always in the same order
(flax rounds a matmul and then its bias add), so the bound is the JAX
package's own bf16 error against its fp32 run.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from nunif_tpu.iw3.depth import dinov2 as jdino
from nunif_tpu.iw3.depth.depth_anything import (
    DepthAnything as JDepthAnything, DepthAnythingModel as JDepthAnythingModel,
    compute_preprocess_size as j_preprocess_size)
from nunif_tpu.iw3.depth.dpt import DPTHead as JDPTHead
from nunif_tpu.models import model_kwargs as j_model_kwargs, unflatten_params

from nunif_tpu_torch.iw3.depth import create_depth_model
from nunif_tpu_torch.iw3.depth.depth_anything import (
    DepthAnything, compute_preprocess_size, shaped_flax_params)
from nunif_tpu_torch.iw3.depth.dinov2 import resize_pos_embed
from nunif_tpu_torch.models import (from_flax, load_model, model_kwargs,
                                    save_model, to_flax)


def _jparams(flat):
    return unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


@pytest.fixture(scope="module")
def pair():
    model = DepthAnything(encoder="vits")
    flat = shaped_flax_params(model, seed=0)
    from_flax(model, flat)
    model.eval().requires_grad_(False)
    return model, flat


@pytest.mark.parametrize("ph,pw", [(28, 49), (7, 9), (4, 6), (40, 52)])
def test_pos_embed_resize_matches_jax_image_resize(ph, pw):
    """jax.image.resize(bicubic) is Keys a = -0.5 with antialiasing when
    downscaling; torch's antialiased bicubic matches it (plain
    F.interpolate bicubic misses by ~1)."""
    grid = np.random.default_rng(1).normal(0, 0.02, (1, 37, 37, 384)) \
        .astype(np.float32) * 50
    want = np.asarray(jax.image.resize(jnp.asarray(grid), (1, ph, pw, 384),
                                       method="bicubic"))
    got = resize_pos_embed(torch.from_numpy(grid), ph, pw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_from_flax_layer_norm_and_conv_transpose():
    """LayerNorm weights are flax ``scale``; ConvTranspose(transpose_kernel)
    kernels (kh, kw, O, I) load as ConvTranspose2d (I, O, kh, kw)."""
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.norm = torch.nn.LayerNorm(6, eps=1e-6)
            self.up = torch.nn.ConvTranspose2d(6, 5, 4, stride=4)

    net = Net()
    rng = np.random.default_rng(2)
    flat = {k: rng.normal(0, 0.5, v.shape).astype(np.float32)
            for k, v in to_flax(net).items()}
    assert sorted(flat) == ["norm/bias", "norm/scale", "up/bias", "up/kernel"]
    assert flat["up/kernel"].shape == (4, 4, 5, 6)
    from_flax(net, flat)
    x = rng.standard_normal((2, 3, 5, 6)).astype(np.float32)
    p = _jparams(flat)
    want_ln = fnn.LayerNorm(epsilon=1e-6).apply({"params": p["norm"]},
                                                jnp.asarray(x))
    want_up = fnn.ConvTranspose(5, (4, 4), strides=(4, 4), padding="VALID",
                                transpose_kernel=True).apply(
        {"params": p["up"]}, jnp.asarray(x))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got_ln = net.norm(xt)
        got_up = net.up(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got_ln.numpy(), np.asarray(want_ln), atol=1e-5)
    np.testing.assert_allclose(got_up.numpy(), np.asarray(want_up), atol=1e-5)
    for k, v in to_flax(net).items():  # and back
        np.testing.assert_array_equal(v, flat[k])


def test_param_tree_and_kwargs_match_jax(pair):
    model, _flat = pair
    jmodel = JDepthAnything(encoder="vits")
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 56, 84, 3))))
    jflat = {"/".join(p.key for p in path): leaf.shape for path, leaf in
             jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    assert {k: v.shape for k, v in to_flax(model).items()} == jflat
    assert model_kwargs(model) == j_model_kwargs(jmodel)


def test_dinov2_and_dpt_head_match_jax(pair):
    """The encoder's four normed intermediate maps, then the DPT head on
    those same features, fp32 at a 56x84 input (4x6 patches)."""
    model, flat = pair
    p = _jparams(flat)
    x = np.random.default_rng(3).standard_normal((2, 56, 84, 3)).astype(np.float32)
    idx = jdino.INTERMEDIATE_LAYER_IDX["vits"]
    jfeats, jhw = jdino.DinoVisionTransformer(**jdino.VIT_CONFIGS["vits"]).apply(
        {"params": p["pretrained"]}, jnp.asarray(x), out_indices=idx)
    with torch.no_grad():
        feats, hw = model.pretrained(torch.from_numpy(x), out_indices=idx)
    assert tuple(hw) == tuple(jhw) == (4, 6)
    for got, want in zip(feats, jfeats):
        # after the final LayerNorm: O(1) values, fp32 sums in another order
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    jhead = JDPTHead(features=64, out_channels=(48, 96, 192, 384))
    want = np.asarray(jhead.apply({"params": p["depth_head"]}, jfeats, jhw))
    with torch.no_grad():
        got = model.depth_head([torch.tensor(np.asarray(f)) for f in jfeats],
                               (4, 6)).numpy()
    assert got.shape == want.shape == (2, 56, 84, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def test_depth_anything_matches_jax(pair):
    """Whole network, full width, in fp32 and bf16 (cast at the input as
    the wrapper does).

    bf16: the two packages round at the same points but in another order
    inside an op, so their bf16 outputs are two roundings of the fp32
    result that are nearly independent.  Held: the port's bf16 is as close
    to the fp32 result as JAX's bf16 (RMS, measured 0.0083 vs 0.0085 at a
    mean depth of 0.97), and port-vs-JAX bf16 is within sqrt(2) of JAX's
    own bf16 error (two independent roundings; measured 0.0096 vs 0.0085).
    """
    model, flat = pair
    p = _jparams(flat)
    jmodel = JDepthAnything(encoder="vits")
    x = np.random.default_rng(4).standard_normal((1, 70, 98, 3)).astype(np.float32)
    fwd = jax.jit(lambda p, v: jmodel.apply({"params": p}, v).astype(jnp.float32))
    want32 = np.asarray(fwd(p, jnp.asarray(x)))
    want16 = np.asarray(fwd(p, jnp.asarray(x, jnp.bfloat16)))
    with torch.no_grad():
        got32 = model(torch.from_numpy(x)).numpy()
        got16 = model(torch.from_numpy(x).bfloat16()).float().numpy()
    assert want32.std() > 0.05 * np.abs(want32).mean()  # not flat
    np.testing.assert_allclose(got32, want32, rtol=1e-4, atol=1e-4)
    jax_err16 = _rms(want16, want32)
    assert _rms(got16, want32) <= 1.1 * jax_err16, (_rms(got16, want32), jax_err16)
    assert _rms(got16, want16) <= np.sqrt(2) * jax_err16, \
        (_rms(got16, want16), jax_err16)


@pytest.mark.parametrize("tta,edge_dilation", [(False, 2), (True, 0), (True, (2, 1))])
def test_depth_model_infer_matches_jax(pair, tta, edge_dilation):
    """The iw3 wrapper: preprocess size, antialiased resize, ImageNet
    normalisation, flip TTA, edge dilation; fp32 on both sides (the JAX
    wrapper casts its input to bf16, so its network runs in fp32 only
    through its model, fed the same preprocessed input)."""
    _model, flat = pair
    dm = create_depth_model("Any_V2_S", device="cpu", dtype=torch.float32)
    dm.load(resolution=56)
    from_flax(dm.model, flat)
    x = np.random.default_rng(5).random((2, 64, 96, 3), dtype=np.float32)
    got = dm.infer(torch.from_numpy(x), tta=tta, edge_dilation=edge_dilation)

    jdm = JDepthAnythingModel("Any_V2_S")
    jdm.model, jdm.params = JDepthAnything(encoder="vits"), _jparams(flat)
    jdm.prep_lower_bound = 56
    h, w = j_preprocess_size(64, 96, 56)
    from nunif_tpu.iw3.depth.depth_anything import batch_preprocess
    from nunif_tpu.iw3.dilation import dilate_edge
    xj = batch_preprocess(jnp.asarray(x), h, w)
    if tta:
        xj = jnp.concatenate([xj, xj[:, :, ::-1]], axis=0)
    out = jdm.model.apply({"params": jdm.params}, xj)
    if tta:
        out = (out[:2] + out[2:, :, ::-1]) * 0.5
    if edge_dilation:
        out = dilate_edge(out, edge_dilation)
    assert got.shape == out.shape == (2, h, w, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw,lb,limit", [((1080, 1920), 392, False),
                                         ((64, 96), 56, False),
                                         ((1920, 1080), 518, False),
                                         ((200, 900), 392, True),
                                         ((300, 300), 224, True)])
def test_preprocess_size_matches_jax(hw, lb, limit):
    assert compute_preprocess_size(*hw, lb, limit_resolution=limit) == \
        j_preprocess_size(*hw, lb, limit_resolution=limit)
    assert compute_preprocess_size(1080, 1920) == (392, 686)  # 28 x 49 patches


def test_checkpoint_round_trip_both_packages(pair, tmp_path):
    """A port-written .nztm loads in the port (through the registry) and
    in the JAX package with the same arrays."""
    from nunif_tpu.models import load_model as j_load_model
    model, flat = pair
    path = str(tmp_path / "depth.nztm")
    save_model(model, path)
    loaded, meta = load_model(path, device="cpu")
    assert meta["name"] == "iw3.depth_anything"
    assert meta["kwargs"] == {"encoder": "vits", "max_depth": 0.0}
    for k, v in to_flax(loaded).items():
        np.testing.assert_array_equal(v, flat[k])
    jmodel, jparams, _meta = j_load_model(path)
    assert isinstance(jmodel, JDepthAnything)
    jflat = {"/".join(p.key for p in path): np.asarray(leaf) for path, leaf in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert sorted(jflat) == sorted(flat)
    dm = create_depth_model("Any_V2_S", device="cpu").load(checkpoint=path)
    np.testing.assert_array_equal(
        dm.model.pretrained.pos_embed.numpy(), flat["pretrained/pos_embed"])


def test_unported_depth_inputs_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_depth_model("DepthPro", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_depth_model("ZoeD_N", device="cpu")
    dm = create_depth_model("Any_V2_S", device="cpu")
    with pytest.raises(NotImplementedError, match=r"\.pth"):
        dm.load(checkpoint="depth_anything_v2_vits.pth")


def test_seeded_init_is_flax_like_and_reproducible():
    a = create_depth_model("Any_V2_S", device="cpu").load(
        generator=torch.Generator().manual_seed(3))
    b = create_depth_model("Any_V2_S", device="cpu").load(
        generator=torch.Generator().manual_seed(3))
    fa, fb = to_flax(a.model), to_flax(b.model)
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert np.all(fa["pretrained/blocks_0/ls1/gamma"] == np.float32(1e-5))
    assert np.all(fa["pretrained/norm/scale"] == 1.0)
    assert abs(fa["pretrained/blocks_0/attn/qkv/kernel"].std()
               - 384 ** -0.5) < 0.01
