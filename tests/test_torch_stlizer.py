"""The stabilizer of nunif_tpu_torch against the JAX package, on the CPU:
SuperPoint (``aux.superpoint``), matching, ``find_transform``'s Adam,
``grad_opt_smoothing``, the warps (the gather and the two-pass shear warp
with K3's plain twin), ``LightOutpaintV1``, ``.nztm`` files either package
wrote, the analysis cache, and ``stabilize_video``: the analysis pass, then
the warp pass of each border from one shared cache file.

Weights are flax's init drawn by the port (``init_flax_default``) and
handed to JAX through the converter.  Tolerances (fp32): dense SuperPoint
scores and descriptors to 1e-4, keypoint sets equal (inputs without ties);
``find_transform`` and ``grad_opt_smoothing`` to 1e-4 relative; the gather
to 1e-5; the two-pass warp to 1e-5 of JAX's two-pass warp and within 8e-3
of the gather inside the envelope (tests/test_stlizer.py's bound: the bf16
taps and the bilinear of a bilinear); ``LightOutpaintV1`` to 1e-4; video
frames (lossless files) >= 50 dB.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.models import save_model as jax_save_model
from nunif_tpu.models.io import load_model as jax_load_model
from nunif_tpu.stlizer import cache as jcache
from nunif_tpu.stlizer import light_outpaint_v1 as jlo
from nunif_tpu.stlizer import pipeline as jpipe
from nunif_tpu.utils import superpoint as jsp
from nunif_tpu.video import VideoOutputConfig as JConfig

from nunif_tpu_torch.models import init_flax_default, load_model, save_model, to_flax
from nunif_tpu_torch.stlizer import cache, pipeline
from nunif_tpu_torch.stlizer.gen_test_video import generate_shaky_video
from nunif_tpu_torch.stlizer.light_outpaint_v1 import LightOutpaintV1, outpaint_infer
from nunif_tpu_torch.utils import superpoint as sp
from nunif_tpu_torch.video import VideoOutputConfig, backend

import torch_iw3_helpers as h

pytestmark = pytest.mark.usefixtures("two_threads")
two_threads = h.two_threads
LOSSLESS = dict(codec="utvideo", pix_fmt="gbrp", audio_copy=False)


def seeded(model, seed=0):
    init_flax_default(model, torch.Generator().manual_seed(seed))
    model.eval().requires_grad_(False)
    return model, h.jparams(to_flax(model))


def image(hh=64, ww=96, seed=0):
    """A smooth image with edges and corners (float32 HWC in [0, 1])."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (hh // 8, ww // 8, 3))
    x = np.kron(base, np.ones((8, 8, 1)))
    yy, xx = np.mgrid[0:hh, 0:ww] / hh
    x = 0.6 * x + 0.4 * (0.5 + 0.5 * np.sin(7 * xx + 3 * yy))[..., None]
    return np.clip(x + 0.02 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)


def test_superpoint_dense_matches_jax():
    """Dense scores (after NMS and the border) and descriptors to 1e-4."""
    model, jp = seeded(sp.SuperPoint(dense_output=True))
    x = image()[None]
    got = model(torch.from_numpy(x))
    want = jax.jit(jsp.SuperPoint(dense_output=True).apply_fn)(jp, jnp.asarray(x))
    for k in ("scores_dense", "descriptors_dense"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert (got["scores_dense"] > 0).float().mean() > 0.002  # not all suppressed


def test_superpoint_keypoints_match_jax():
    """The valid keypoints (no ties among their scores), in order, with
    their scores and descriptors; the invalid ones rank below them."""
    model, jp = seeded(sp.SuperPoint(max_num_keypoints=128))
    x = np.stack([image(seed=1), image(seed=2)])
    got = model(torch.from_numpy(x))
    want = jax.jit(jsp.SuperPoint(max_num_keypoints=128).apply_fn)(jp, jnp.asarray(x))
    for b in range(2):
        v = got["valid"][b].numpy()
        np.testing.assert_array_equal(v, np.asarray(want["valid"][b]))
        assert 10 < v.sum() < 128 and not v[int(v.sum()):].any()
        np.testing.assert_array_equal(got["keypoints"][b].numpy()[v],
                                      np.asarray(want["keypoints"][b])[v])
        for k in ("scores", "descriptors"):
            np.testing.assert_allclose(got[k][b].numpy()[v], np.asarray(want[k][b])[v],
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def test_nms_and_find_match_index_match_jax():
    s = np.zeros((1, 32, 32), np.float32)
    s[0, 10, 10], s[0, 10, 12], s[0, 20, 5] = 1.0, 0.9, 0.5
    s += np.random.default_rng(4).uniform(0, 0.1, s.shape).astype(np.float32)
    np.testing.assert_array_equal(sp.batched_nms(torch.from_numpy(s), 4).numpy(),
                                  np.asarray(jsp.batched_nms(jnp.asarray(s), 4)))
    rng = np.random.default_rng(5)
    K, D = 48, 32
    d = rng.normal(size=(K, D)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d2 = d[rng.permutation(K)] + 0.3 * rng.normal(size=(K, D)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    v1, v2 = rng.uniform(size=K) > 0.2, rng.uniform(size=K) > 0.2
    kp1 = {"descriptors": d, "valid": v1}
    kp2 = {"descriptors": d2, "valid": v2}
    got = sp.find_match_index({k: torch.from_numpy(v) for k, v in kp1.items()},
                              {k: torch.from_numpy(v) for k, v in kp2.items()}, 0.5)
    want = jsp.find_match_index({k: jnp.asarray(v) for k, v in kp1.items()},
                                {k: jnp.asarray(v) for k, v in kp2.items()}, 0.5)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-6, atol=1e-6)
    assert 0 < got[2].sum() < K


def matched_points(seed, B=3, K=64):
    """Matched points under a known shift / rotation with 0.3 px noise, a
    few outliers 200 px off (far past sigma) and a few masked entries."""
    rng = np.random.default_rng(seed)
    center = np.array([160.0, 90.0], np.float32)
    pts = rng.uniform(10, 310, (B, K, 2)).astype(np.float32)
    ang = np.radians(np.array([3.0, -1.5, 0.5]))[:B]
    shift = np.array([[5.0, -3.0], [-8.0, 2.5], [0.5, 0.25]], np.float32)[:B]
    R = np.stack([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]).transpose(2, 0, 1)
    pts2 = np.einsum("bkc,bdc->bkd", pts - center, R) + center + shift[:, None]
    # noise keeps the inliers' residuals off zero, where L1's gradient signs
    # would flip on the last bit
    pts2 += rng.normal(0, 0.3, pts2.shape)
    pts2[:, :5] += 200.0
    mask = np.ones((B, K), bool)
    mask[:, -4:] = False
    return (pts, pts2.astype(np.float32), np.broadcast_to(center, (B, 1, 2)).copy(),
            mask, shift, np.degrees(ang))


@pytest.mark.parametrize("flags", [dict(disable_scale=True), dict(),
                                   dict(disable_rotate=True, disable_scale=True)])
def test_find_transform_matches_jax(flags):
    """Shift, scale and angle to 1e-4 relative of JAX's optax run (50 and
    100 steps); the stabilizer's case recovers the true motion."""
    xy1, xy2, c, m, shift, ang = matched_points(6)
    for it in (50, 100):
        got = sp.find_transform(*(torch.from_numpy(a) for a in (xy1, xy2, c, m)),
                                iteration=it, sigma=2.0, **flags)
        want = jsp.find_transform(*(jnp.asarray(a) for a in (xy1, xy2, c, m)),
                                  iteration=it, sigma=2.0, **flags)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    if flags == dict(disable_scale=True):
        np.testing.assert_allclose(got[0].numpy(), shift, atol=0.2)
        np.testing.assert_allclose(got[2].numpy(), ang, atol=0.1)


def test_grad_opt_and_filters_match_jax():
    """grad_opt_smoothing (400 Adam steps) to 1e-4 relative; the gaussian
    and savgol corrections equal; the scene weight equal."""
    rng = np.random.default_rng(9)
    n = 60
    sx, sy, sa = rng.normal(0, 2, n), rng.normal(0, 1, n), rng.normal(0, 0.3, n)
    scores = rng.uniform(0.4, 0.95, n)
    w = pipeline.calc_scene_weight(scores)
    np.testing.assert_array_equal(w, jpipe.calc_scene_weight(scores))
    for method in ("gaussian", "savgol", "grad_opt"):
        got = pipeline.smooth_trajectory(sx, sy, sa, w, method, 1.0, 30, 320)
        want = jpipe.smooth_trajectory(sx, sy, sa, w, method, 1.0, 30, 320)
        for g, wv in zip(got, want):
            if method == "grad_opt":
                scale = np.abs(wv).max()
                np.testing.assert_allclose(g, wv, rtol=1e-4, atol=1e-4 * scale)
            else:
                np.testing.assert_array_equal(g, wv)


def transform_case(B=2, H=40, W=56):
    x = np.stack([image(H, W, seed=s) for s in range(B)])
    shift = np.array([[3.0, -2.0], [-4.5, 1.25]], np.float32)[:B]
    scale = np.array([1.0, 1.02], np.float32)[:B]
    angle = np.array([0.8, -1.2], np.float32)[:B]
    center = np.array([[W / 2, H / 2]] * B, np.float32)
    return x, shift, scale, angle, center


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_apply_transform_gather_matches_jax(padding_mode):
    args = transform_case()
    got = sp.apply_transform(*(torch.from_numpy(a) for a in args),
                             padding_mode=padding_mode)
    want = jsp.apply_transform(*(jnp.asarray(a) for a in args),
                               padding_mode=padding_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    ident = sp.apply_transform(torch.from_numpy(args[0]), torch.zeros(2, 2),
                               torch.ones(2), torch.zeros(2), torch.from_numpy(args[4]))
    np.testing.assert_allclose(ident.numpy(), args[0], atol=1e-5)


def test_two_pass_warp_matches_jax_and_gather():
    """The shear decomposition with K3's plain twin (the CPU path of
    ``warp_x_bounded``) against JAX's ``_apply_transform_two_pass`` and
    against the gather inside the envelope; the zero transform is the
    identity up to the bf16 taps."""
    args = transform_case(H=64, W=96)
    t = [torch.from_numpy(a) for a in args]
    got = sp.apply_transform_two_pass(*t, max_shift=16).numpy()
    want = np.asarray(jsp._apply_transform_two_pass(*(jnp.asarray(a) for a in args),
                                                    max_shift=16))
    np.testing.assert_allclose(got, want, atol=1e-5)
    gather = sp.apply_transform(*t, padding_mode="border").numpy()
    m = 8  # the rotated corners' wedges clamp per axis, not in 2-D
    np.testing.assert_allclose(got[:, m:-m, m:-m], gather[:, m:-m, m:-m], atol=8e-3)
    ident = sp.apply_transform_two_pass(t[0], torch.zeros(2, 2), torch.ones(2),
                                        torch.zeros(2), t[4], max_shift=8)
    np.testing.assert_allclose(ident.numpy(), args[0], atol=4e-3)


def test_light_outpaint_matches_jax():
    """The net (a size that pads to 64) and ``outpaint_infer`` (run at a
    smaller size, composited at full size) to 1e-4."""
    model, jp = seeded(LightOutpaintV1(), seed=3)
    jmodel = jlo.LightOutpaintV1()
    x = image(56, 72, seed=4)[None]
    mask = np.zeros((1, 56, 72, 1), np.float32)
    mask[:, :6], mask[:, :, -9:] = 1.0, 1.0
    x = x * (1 - mask)
    got = model(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want = np.asarray(jlo._jitted_outpaint(jmodel)(jp, jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(got - x)[mask[..., 0] > 0].mean() > 1e-3  # the borders filled
    got = outpaint_infer(model, torch.from_numpy(x), torch.from_numpy(mask), max_size=64)
    want = jlo.outpaint_infer(jmodel, jp, jnp.asarray(x), jnp.asarray(mask), max_size=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_checkpoints_load_across_packages(tmp_path):
    """SuperPoint and LightOutpaintV1 written by the JAX package's
    ``save_model`` load into the port with the same weights, and the port's
    files load into JAX (TransNetV2: tests/test_torch_shot_boundary.py)."""
    # JAX's writer on a JAX init (SuperPoint) and on seeded weights handed
    # over as JAX params (LightOutpaintV1, whose flax init compiles slowly)
    sp_params = jax.jit(jsp.SuperPoint().init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 1)))["params"]
    for jmodel, params in ((jsp.SuperPoint(), sp_params),
                           (jlo.LightOutpaintV1(), seeded(LightOutpaintV1(), 5)[1])):
        path = str(tmp_path / "j.nztm")
        jax_save_model(jmodel, params, path)
        model, meta = load_model(path, device="cpu")
        assert meta["name"] == jmodel.model_name
        flat = to_flax(model)
        for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(p.key for p in k)
            np.testing.assert_array_equal(flat.pop(key), np.asarray(v), err_msg=key)
        assert not flat
    for model in (seeded(sp.SuperPoint())[0], seeded(LightOutpaintV1())[0]):
        path = str(tmp_path / "t.nztm")
        save_model(model, path)
        _jm, jparams, meta = jax_load_model(path)
        assert meta["name"] == model.model_name
        flat = to_flax(model)
        for k, v in jax.tree_util.tree_flatten_with_path(jparams)[0]:
            key = "/".join(p.key for p in k)
            np.testing.assert_array_equal(flat.pop(key), np.asarray(v), err_msg=key)
        assert not flat


def test_cache_read_across_packages(tmp_path):
    src = tmp_path / "v.mp4"
    src.write_bytes(b"fake video")
    d = str(tmp_path / "cache")
    kw = dict(shift_x=np.arange(3.0), shift_y=np.zeros(3), angle=np.ones(3),
              scene_weight=np.ones(3), fps=8.0, resize_scale=2.0, center=(48, 32))
    jcache.save_cache(str(src), d, **kw)
    got = cache.load_cache(str(src), d)
    np.testing.assert_array_equal(got["shift_x"], kw["shift_x"])
    assert float(got["fps"]) == 8.0 and tuple(got["center"]) == (48, 32)
    cache.save_cache(str(src), d, **{**kw, "fps": 4.0})
    assert float(jcache.load_cache(str(src), d)["fps"]) == 4.0
    assert cache.load_cache(str(tmp_path / "nope.mp4"), d) is None


@pytest.fixture(scope="module")
def shaky(tmp_path_factory):
    """A 12-frame shaky clip of a 64 x 96 image at 8 fps, lossless, from
    the port's generator (the JAX generator's trajectory)."""
    d = tmp_path_factory.mktemp("shaky")
    src = str(d / "shaky.mkv")
    n, traj = generate_shaky_video([image(seed=7)], src, noise_scale=3.0, fps=8,
                                   seconds_per_image=1.5, device="cpu",
                                   config=VideoOutputConfig(**LOSSLESS))
    assert n == 12
    from nunif_tpu.stlizer.gen_test_video import make_shake_trajectory
    for a, b in zip(traj, make_shake_trajectory(12, 3.0)):
        np.testing.assert_array_equal(a, b)
    return src


def _read(path):
    with backend.VideoReader(path) as r:
        return np.stack([f for f, _ in r])


def test_analysis_pass_matches_jax(shaky):
    """The match scores of each frame to 1e-6 (the keypoints and matches
    equal), the shifts and angles within 0.05 px and 0.05 degrees: seeded
    SuperPoint descriptors are alike (mean match similarity ~0.97), so
    almost every pair of points matches and ``find_transform``'s L1 Adam
    runs on a flat, ragged objective where last-bit differences move its
    end point by hundredths of a pixel (on well-posed matches it holds
    1e-4: ``test_find_transform_matches_jax``)."""
    model, jp = seeded(sp.SuperPoint(max_num_keypoints=pipeline.MAX_KEYPOINTS))
    got = pipeline.analysis_pass(shaky, 64, 4, 30.0, model)
    want = jpipe._analysis_pass(shaky, 64, 4, 30.0, superpoint_params=jp)
    np.testing.assert_allclose(got[3], want[3], atol=1e-6)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, atol=0.05)
    assert got[4:] == want[4:]


@pytest.mark.parametrize("border,debug", [("black", False), ("crop", False),
                                          ("expand", False), ("black", True)])
def test_warp_pass_from_shared_cache_matches_jax(tmp_path, shaky, border, debug):
    """The JAX package analyses the clip and writes the cache; the port's
    warp pass reads it: decoded frames >= 50 dB of JAX's (lossless)."""
    d = str(tmp_path / "cache")
    _m, jp = seeded(sp.SuperPoint(max_num_keypoints=pipeline.MAX_KEYPOINTS))
    kw = dict(resolution=64, batch_size=4, border=border, debug=debug, cache_dir=d)
    jpipe.stabilize_video(shaky, str(tmp_path / "j.mkv"), superpoint_params=jp,
                          video_config=JConfig(**LOSSLESS), **kw)
    info = pipeline.stabilize_video(shaky, str(tmp_path / "t.mkv"), device="cpu",
                                    video_config=VideoOutputConfig(**LOSSLESS), **kw)
    got, want = _read(str(tmp_path / "t.mkv")), _read(str(tmp_path / "j.mkv"))
    assert got.shape == want.shape and info["frames"] == 12
    assert h.psnr(got, want) >= 50.0
