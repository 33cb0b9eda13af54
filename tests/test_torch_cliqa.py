"""cliqa in nunif_tpu_torch against nunif_tpu/cliqa on the CPU.

The same flax-layout weights, drawn with numpy, go into both packages.
Tolerances:
  * forward at fp32: every output within 1e-4 absolute of JAX's (the same
    products summed in another order), all three models under both
    ``norm`` modes;
  * forward at bf16 (x in bf16, so every conv runs in bf16 and each
    GroupNorm in fp32, rounded once): the port's largest error against
    JAX's fp32 output within 1.5 x JAX's own bf16 error plus one bf16 step
    at the output's magnitude;
  * patch choice: the same indexes, in the same order, as JAX's (host
    numpy in both packages);
  * predictors: quality, subsampling probability and PSNR within 1e-4;
    the resize quality, an int truncated from (1 - factor) x 100, equal,
    on an input whose factor is not within 1e-3 of a hundredth;
  * the filter CLI: both CLIs keep the same files under the same names.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from nunif_tpu.cliqa import filter_cli as jcli
from nunif_tpu.cliqa import utils as jutils
from nunif_tpu.models import create_model as jax_create_model
from nunif_tpu.models import unflatten_params

from nunif_tpu_torch.cliqa import filter_cli as tcli
from nunif_tpu_torch.cliqa import utils as tutils
from nunif_tpu_torch.models import create_model, from_flax, save_model, to_flax

NAMES = ("cliqa.jpeg_quality", "cliqa.grain_noise_level", "cliqa.scale_factor")
ATOL = 1e-4


def flax_weights(model, seed):
    """Seeded flax-layout arrays for ``model``: lecun-normal kernels, small
    biases, GroupNorm scales near 1."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in to_flax(model).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            a = rng.standard_normal(ref.shape) / math.sqrt(math.prod(ref.shape[:-1]))
        elif leaf == "scale":
            a = 1.0 + rng.normal(0.0, 0.1, ref.shape)
        else:
            a = rng.normal(0.0, 0.1, ref.shape)
        flat[key] = a.astype(np.float32)
    return flat


def both(name, norm, seed=0):
    """(port model on the CPU, jitted JAX forward) on the same weights."""
    model = create_model(name, norm=norm)
    flat = flax_weights(model, seed)
    from_flax(model, flat)
    model.eval().requires_grad_(False)
    jmodel = jax_create_model(name, norm=norm)
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    return model, jax.jit(lambda x: jmodel.apply({"params": params}, x)), flat


def outputs(y):
    return [np.asarray(jnp.asarray(a, jnp.float32)) if not torch.is_tensor(a)
            else a.float().numpy() for a in (y if isinstance(y, tuple) else (y,))]


@pytest.fixture(scope="module")
def patches():
    return np.random.default_rng(1).random((3, 64, 64, 3), dtype=np.float32)


@pytest.mark.parametrize("norm", ["gn", "none"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, norm, patches):
    model, fwd, _ = both(name, norm)
    with torch.no_grad():
        got = outputs(model(torch.from_numpy(patches)))
    want = outputs(fwd(jnp.asarray(patches)))
    assert [g.shape for g in got] == [w.shape for w in want] == \
        [(3, 1)] * len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    # bf16: the port within 1.5 x JAX's own bf16 error plus one bf16 step
    with torch.no_grad():
        got16 = outputs(model(torch.from_numpy(patches).bfloat16()))
    jax16 = outputs(fwd(jnp.asarray(patches, jnp.bfloat16)))
    for g, j, w in zip(got16, jax16, want):
        step = 2.0 ** (math.floor(math.log2(float(np.abs(w).max()))) - 7)
        assert np.abs(g - w).max() <= 1.5 * np.abs(j - w).max() + step


def test_norm_names_and_shapes_match_jax():
    """Both norm modes hold flax's tree: the same paths and shapes."""
    for name in NAMES:
        for norm in ("gn", "none"):
            model = create_model(name, norm=norm)
            jmodel = jax_create_model(name, norm=norm)
            params = jax.eval_shape(lambda: jmodel.init(
                jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
            want = {k: tuple(v.shape) for k, v in flatten_dict(params, sep="/").items()}
            assert {k: v.shape for k, v in to_flax(model).items()} == want
    with pytest.raises(ValueError, match="norm"):
        create_model("cliqa.scale_factor", norm="bn")


@pytest.mark.parametrize("hw", [(300, 520), (96, 200)])
def test_patch_choice_matches_jax(hw):
    """The grid, the reflect pad under 128 px and the top-k order (std and
    TV scores) are JAX's, patch for patch."""
    rng = np.random.default_rng(hw[0])
    im = rng.random(hw + (3,), dtype=np.float32) * np.linspace(
        0.1, 1.0, hw[1], dtype=np.float32)[None, :, None]
    for score in ("std_score", "tv_score"):
        for k in (1, 3, 8):
            want = jutils.extract_patches(im, k, score_fn=getattr(jutils, score))
            got = tutils.extract_patches(im, k, score_fn=getattr(tutils, score))
            np.testing.assert_array_equal(got, want)
    grid = tutils.patch_grid(im)
    idx = tutils.patch_indexes(grid, 3)
    np.testing.assert_array_equal(grid[idx], jutils.extract_patches(im, 3))


def test_predictors_match_jax():
    im = np.random.default_rng(2).random((260, 390, 3), dtype=np.float32)
    im[:, :130] *= 0.2
    for name, fn in (("cliqa.jpeg_quality", "predict_jpeg_quality"),
                     ("cliqa.grain_noise_level", "predict_grain_noise_psnr"),
                     ("cliqa.scale_factor", "predict_resize_quality")):
        model, _fwd, flat = both(name, "gn", seed=3)
        jmodel = jax_create_model(name, norm="gn")
        params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
        got = getattr(tutils, fn)(model, im, num_patches=4)
        want = getattr(jutils, fn)(jmodel, params, im, num_patches=4)
        if fn == "predict_resize_quality":
            patches = tutils.extract_patches(im, 4, score_fn=tutils.tv_score)
            with torch.no_grad():
                factor = float(model(torch.from_numpy(patches)).min())
            frac = (factor - 1.0) * 100 % 1.0
            assert 1e-3 < frac < 1 - 1e-3, factor  # away from a boundary
            assert isinstance(got, int) and got == want
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _images(root):
    """Five synthetic images of several noise levels, one under 128 px, and
    a .tif that the cliqa CLI does not list (the JAX set)."""
    os.makedirs(root)
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:200, 0:260] / 260.0
    base = np.stack([yy, xx, (xx + yy) / 2], -1)
    for i, sigma in enumerate((0.0, 0.02, 0.05, 0.1)):
        a = np.clip(base + rng.normal(0, sigma, base.shape), 0, 1)
        Image.fromarray((a * 255).astype(np.uint8)).save(
            os.path.join(root, f"im{i}.png"))
    Image.fromarray((base[:90, :110] * 255).astype(np.uint8)).save(
        os.path.join(root, "small.png"))
    Image.fromarray((base * 255).astype(np.uint8)).save(
        os.path.join(root, "skip.tif"))


def test_filter_cli_keeps_what_jax_keeps(tmp_path):
    """One checkpoint (written by the port, read by both), a threshold
    between the images' scores: the same files kept under the same
    score-prefixed names; the .tif is not listed."""
    src = str(tmp_path / "src")
    _images(src)
    assert [os.path.basename(f) for f in tcli.listdir_images(src)] == \
        ["im0.png", "im1.png", "im2.png", "im3.png", "small.png"]
    model = create_model("cliqa.grain_noise_level", norm="gn")
    from_flax(model, flax_weights(model, 5))
    model.eval()
    # move the head's bias so that the predicted levels straddle 25 dB
    from nunif_tpu_torch.utils.pil_io import load_image
    xs = [load_image(f)[0][..., :3] for f in tcli.listdir_images(src)]
    with torch.no_grad():
        raw = [float(model(torch.from_numpy(tutils.extract_patches(x, 8))).mean())
               for x in xs]
        model.noise_level_output.out.bias += 25.0 - float(np.median(raw))
    ckpt = str(tmp_path / "noise.nztm")
    save_model(model, ckpt)
    scores = sorted(tcli.score("noise", model, x, 8) for x in xs)
    gap = int(np.argmax(np.diff(scores)))
    threshold = (scores[gap] + scores[gap + 1]) / 2
    kept = {}
    for pkg, main in (("port", tcli.main), ("jax", jcli.main)):
        dst = tmp_path / pkg
        argv = ["noise", "-i", src, "-o", str(dst), "--filter", str(threshold),
                "--checkpoint", ckpt, "--score-prefix"]
        assert main(argv + (["--device", "cpu"] if pkg == "port" else [])) == 0
        kept[pkg] = sorted(os.listdir(dst))
    assert kept["port"] == kept["jax"]
    assert 0 < len(kept["port"]) < 5
