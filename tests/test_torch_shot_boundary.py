"""Scene detection and the letterbox pre-pass of nunif_tpu_torch against the
JAX package, on the CPU: TransNetV2 (``aux.transnetv2``) on seeded weights
through the flax converter and a ``.nztm`` both packages read, its windowed
scores, the histogram detector, the boundary cache read across the two
packages, and ``autocrop_analyze_video``.

Tolerances: TransNetV2's logits and scores in fp32 to 1e-4 (absolute and
relative); boundaries, crops and histogram scores equal.  One divergence
is on purpose: the port's detector retimes the frames as the engine does,
where the JAX detector ignores ``max_fps``.  Clips are lossless (utvideo,
gbrp, .mkv) at 8 fps, whose pts both packages' retimers place exactly
(tests/test_torch_video.py).
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nunif_tpu.iw3 import scene_boundary_cache as jcache
from nunif_tpu.models import load_model as jax_load_model
from nunif_tpu.utils import autocrop as jautocrop
from nunif_tpu.utils import shot_boundary as jsb
from nunif_tpu.utils import transnetv2 as jtn

from nunif_tpu_torch.iw3 import scene_boundary_cache as cache
from nunif_tpu_torch.models import init_flax_default, save_model, to_flax
from nunif_tpu_torch.utils import autocrop, shot_boundary as sb
from nunif_tpu_torch.utils.transnetv2 import TransNetV2
from nunif_tpu_torch.video import VideoOutputConfig, generate_video

import torch_iw3_helpers as h

pytestmark = pytest.mark.usefixtures("two_threads")
two_threads = h.two_threads
LOSSLESS = VideoOutputConfig(codec="utvideo", pix_fmt="gbrp", audio_copy=False)


@pytest.fixture(scope="module")
def transnet(tmp_path_factory):
    """(port TransNetV2 with flax's init from seed 0, JAX params, .nztm)."""
    model = TransNetV2()
    init_flax_default(model, torch.Generator().manual_seed(0))
    model.eval().requires_grad_(False)
    path = str(tmp_path_factory.mktemp("tn") / "transnetv2.nztm")
    save_model(model, path)
    return model, h.jparams(to_flax(model)), path


def shots(n, cuts, h_=54, w=96, seed=0, bars=0):
    """n uint8 frames whose colour scheme changes at each cut, a moving
    block, noise; ``bars`` black rows top and bottom."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h_, 0:w] / h_
    out, scene = [], 0
    for i in range(n):
        scene += i in cuts
        a = 1.3 * scene + 0.5
        f = 0.5 + 0.35 * np.stack([np.sin(3 * xx * a + 0.1 * i), np.cos(2 * yy - a * xx),
                                   np.sin(a + xx * yy)], -1)
        f[h_ // 3:2 * h_ // 3, 5 + 2 * i % 60:25 + 2 * i % 60] = 0.9 - 0.3 * (scene % 2)
        f = np.clip(f + 0.02 * rng.standard_normal(f.shape), 0, 1)
        if bars:
            f[:bars] = f[-bars:] = 0.0
        out.append((f * 255 + 0.5).astype(np.uint8))
    return np.stack(out)


def write(path, frames, fps=8):
    generate_video(path, iter(frames), frames.shape[2], frames.shape[1], fps=fps,
                   config=LOSSLESS)
    return path


def test_jax_checkpoint_loads_into_port(tmp_path):
    """A TransNetV2 written by the JAX package's ``save_model`` (flax's
    init) loads into the port with the same weights (5-D conv kernels in
    DHWIO)."""
    import jax
    from nunif_tpu.models import save_model as jax_save_model
    from nunif_tpu_torch.models import load_model
    jmodel = jtn.TransNetV2()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(2),
                                  jnp.zeros((1, 100, 27, 48, 3)))["params"]
    path = str(tmp_path / "j.nztm")
    jax_save_model(jmodel, params, path)
    model, meta = load_model(path, device="cpu")
    assert meta["name"] == "aux.transnetv2"
    flat = to_flax(model)
    for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(p.key for p in k)
        np.testing.assert_array_equal(flat.pop(key), np.asarray(v), err_msg=key)
    assert not flat


def test_transnetv2_forward_matches_jax(transnet):
    """100 frames of 27 x 48 (values 0-255): both logits to 1e-4, fp32."""
    model, jp, _ = transnet
    x = np.random.default_rng(1).uniform(0, 255, (1, 100, 27, 48, 3)).astype(np.float32)
    x[:, 50:] = x[:, 50:] * 0.3  # a cut: the histogram band sees it
    one, many = model(torch.from_numpy(x))
    jone, jmany = jtn.TransNetV2().apply_fn(jp, jnp.asarray(x))
    for got, want in ((one, jone), (many, jmany)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert np.asarray(jone).std() > 1e-3  # the heads do not read constant


def test_transnet_windowed_scores_and_boundaries_match_jax(tmp_path, transnet):
    """130 frames in three windows: the scores of the middles to 1e-4; the
    detector on the .nztm (loaded by each package's loader) gives the same
    boundaries at a threshold in the widest gap of the scores."""
    model, jp, path = transnet
    frames = shots(130, {40, 90})
    small = np.stack([sb._resize_small(f) for f in frames])
    np.testing.assert_array_equal(small, np.stack([jsb._resize_small(f) for f in frames]))
    scores = sb._transnet_scores(small, model)
    jm, jparams, _ = jax_load_model(path)
    want = jsb._transnet_scores(small, jm, jparams)
    np.testing.assert_allclose(scores, want, rtol=1e-4, atol=1e-4)
    s = np.sort(scores[1:])
    gap = np.argmax(np.diff(s))
    threshold = float((s[gap] + s[gap + 1]) / 2)
    src = write(str(tmp_path / "clip.mkv"), frames)
    got = sb.detect_boundaries(src, threshold=threshold, min_frames=3,
                               checkpoint=path, device="cpu")
    assert got == jsb.detect_boundaries(src, threshold=threshold, min_frames=3,
                                        checkpoint=path)
    assert got == sb.boundaries_from_scores(scores, threshold, 3)


def test_histogram_detector_matches_jax(tmp_path):
    """Cuts at 9 and 21 of 30 frames: equal scores and boundaries (at the
    CLI's threshold 0.3 and the default 0.4)."""
    frames = shots(30, {9, 21})
    small = np.stack([sb._resize_small(f) for f in frames])
    np.testing.assert_array_equal(sb._hist_diff_scores(small), jsb._hist_diff_scores(small))
    src = write(str(tmp_path / "clip.mkv"), frames)
    for threshold in (0.3, 0.4):
        got = sb.detect_boundaries(src, threshold=threshold, min_frames=5)
        assert got == jsb.detect_boundaries(src, threshold=threshold, min_frames=5)
    assert got == [9, 21]


def test_detector_retimes_as_the_engine_diverges_from_jax(tmp_path):
    """A 16 fps source with a cut at frame 12 under ``max_fps`` 8: the
    engine keeps every other frame, so the processor's frame 6 starts the
    new shot.  The port's detector says 6; the JAX detector counts source
    frames and says 12 (it takes ``max_fps`` and never uses it)."""
    src = write(str(tmp_path / "clip.mkv"), shots(24, {12}), fps=16)
    assert sb.detect_boundaries(src, threshold=0.3, min_frames=2, max_fps=8) == [6]
    assert jsb.detect_boundaries(src, threshold=0.3, min_frames=2, max_fps=8) == [12]
    # at or under the source's rate the two agree
    assert sb.detect_boundaries(src, threshold=0.3, min_frames=2, max_fps=30) == [12]


def test_scene_cache_read_across_packages(tmp_path):
    """Each package finds the other's cache (the same file name and JSON);
    the cached detector returns it without decoding."""
    src = write(str(tmp_path / "clip.mkv"), shots(30, {9, 21}))
    d = str(tmp_path / "cache")
    os.makedirs(d)
    assert cache.get_cache_path(src, 30.0, d) == jcache.get_cache_path(src, 30.0, d)
    jcache.save_cache(src, [9, 21], 30.0, d)
    assert cache.load_cache(src, 30.0, d) == [9, 21]
    assert cache.load_cache(src, 24.0, d) is None
    cache.save_cache(src, [4], 24.0, d)
    assert jcache.load_cache(src, 24.0, d) == [4]
    assert cache.detect_boundaries_cached(src, 30.0, cache_dir=d) == [9, 21]
    assert cache.detect_boundaries_cached(src, 60.0, cache_dir=d, device="cpu") == [9, 21]
    assert jcache.load_cache(src, 60.0, d) == [9, 21]


@pytest.mark.parametrize("mode", ["black", "black_tb", "flat"])
def test_autocrop_analyze_video_matches_jax(tmp_path, mode):
    """A clip with 10-row black bars: the same slices as the JAX pre-pass
    (and the bars found in the black modes); 90 frames sample every 2nd."""
    src = write(str(tmp_path / "bars.mkv"), shots(90, {30}, bars=10))
    got = autocrop.autocrop_analyze_video(src, mode=mode)
    assert got == jautocrop.autocrop_analyze_video(src, mode=mode)
    if mode.startswith("black"):
        assert got[0] == slice(10, 44)
