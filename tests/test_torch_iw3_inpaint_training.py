"""iw3's inpaint training in nunif_tpu_torch against the JAX package, on the
CPU: the dataset (the same arrays for a seed, from a directory of images
and synthesized), the reconstruction losses (values and gradients within
1e-5 relative), the generator's input, and ``python -m
nunif_tpu_torch.train inpaint`` in recon, ``l3c`` and ``ffc`` modes (and
the video net), one epoch at 64 px, each writing a ``.nztm`` that the
port's ``load_model`` loads.

A reference fault: with ``--ema-decay`` the JAX GAN loop keeps the
generator's EMA but exports its trained parameters every epoch; the port
exports the EMA, as its PSNR trainer (and the JAX one) does
(``test_gan_export_takes_the_ema_diverges_from_jax``).
"""
import argparse
import importlib.util
import json
import os
import pathlib

import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.iw3.training.inpaint import dataset as jds
from nunif_tpu.iw3.training.inpaint import trainer as jtrainer
from nunif_tpu.models import create_model as jax_create_model
from nunif_tpu.models.io import flatten_params
from nunif_tpu.utils.image_loader import list_images as jax_list_images

from nunif_tpu_torch.iw3.training.inpaint import dataset as tds
from nunif_tpu_torch.iw3.training.inpaint import trainer as ttrainer
from nunif_tpu_torch.models import load_model, read_checkpoint, to_flax
from nunif_tpu_torch.train import create_parser, main
from nunif_tpu_torch.utils.image_loader import list_images

REPO = pathlib.Path(__file__).resolve().parents[1]
CLI = ["--device", "cpu", "--size", "64", "--batch-size", "2",
       "--num-samples", "4", "--max-epoch", "1", "--num-workers", "1"]


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("inpaint_images")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(((90, 120), (64, 70), (50, 200))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / f"{i}.png")
    (root / "notes.txt").write_text("not an image")
    return str(root)


@pytest.mark.parametrize("source", ["dir", "synthetic"])
def test_image_dataset_equals_jax(image_dir, source):
    d = image_dir if source == "dir" else None
    for training in (True, False):
        a = jds.InpaintDataset(d, size=48, num_samples=5, seed=3, training=training)
        b = tds.InpaintDataset(d, size=48, num_samples=5, seed=3, training=training)
        for ja, tb in zip(a.batches(2), b.batches(2), strict=True):
            assert set(ja) == set(tb) == {"y", "mask"}
            for k in ja:
                np.testing.assert_array_equal(tb[k], ja[k])
    assert list_images(image_dir) == jax_list_images(image_dir)
    assert len(list_images(image_dir)) == 3


@pytest.mark.parametrize("source", ["dir", "synthetic"])
def test_video_dataset_equals_jax(image_dir, source):
    d = image_dir if source == "dir" else None
    a = jds.VideoInpaintDataset(d, size=40, num_samples=2, seed=4)
    b = tds.VideoInpaintDataset(d, size=40, num_samples=2, seed=4)
    for ja, tb in zip(a.batches(), b.batches(), strict=True):
        assert tb["y"].shape == (12, 40, 40, 3) and tb["mask"].shape == (12, 40, 40, 1)
        for k in ja:
            np.testing.assert_array_equal(tb[k], ja[k])


def test_hole_mask_equals_jax():
    for seed in range(4):
        want = jds.make_hole_mask(np.random.default_rng(seed), 64)
        got = tds.make_hole_mask(np.random.default_rng(seed), 64)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < got.size


def _pair(seed, n=12):
    rng = np.random.default_rng(seed)
    z = rng.uniform(-0.1, 1.1, (n, 24, 24, 3)).astype(np.float32)
    y = rng.uniform(0, 1, z.shape).astype(np.float32)
    return z, y


@pytest.mark.parametrize("what", ["temporal", "image", "video"])
def test_recon_losses_match_jax(what):
    z, y = _pair(1)
    if what == "temporal":
        jf, tf = jtrainer.temporal_gradient_loss, ttrainer.temporal_gradient_loss
    else:
        jf = jtrainer.make_recon_loss(what == "video")
        tf = ttrainer.make_recon_loss(what == "video")
    want_v, want_g = jax.value_and_grad(lambda a: jf(a, jnp.asarray(y)))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    v = tf(zt, torch.from_numpy(y))
    v.backward()
    assert float(v) == pytest.approx(float(want_v), rel=1e-5)
    w = np.asarray(want_g)
    np.testing.assert_allclose(zt.grad.numpy(), w, rtol=1e-5,
                               atol=1e-5 * float(np.abs(w).max()))


def test_mask_inputs_match_jax():
    z, y = _pair(2, n=2)
    mask = (z[..., :1] > 0.7).astype(np.float32)
    want = jtrainer._mask_inputs({"y": jnp.asarray(y), "mask": jnp.asarray(mask)})
    got = ttrainer._mask_inputs({"y": torch.from_numpy(y), "mask": torch.from_numpy(mask)})
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _run(capsys, model_dir, *extra):
    assert main(["inpaint", "--model-dir", str(model_dir), *CLI, *extra]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("mode", ["recon", "l3c", "ffc"])
def test_cli_one_epoch_writes_a_loadable_model(tmp_path, capsys, mode):
    extra = [] if mode == "recon" else ["--discriminator", mode,
                                        "--generator-start-step", "1"]
    out = _run(capsys, tmp_path, *extra)
    tag = "train: " if mode == "recon" else "inpaint_gan: "
    lines = [json.loads(s[len(tag):]) for s in out.splitlines() if s.startswith(tag)]
    assert len(lines) == 1 and lines[0]["steps"] == 2 and lines[0]["device"] == "cpu"
    if mode == "recon":
        assert np.isfinite(lines[0]["train_loss"]) and lines[0]["eval_psnr"] > 0
    else:
        assert lines[0]["finite"] and not lines[0]["exported_ema"]
        with open(tmp_path / "gan_steps.csv") as f:
            rows = [r.strip().split(",") for r in f][1:]
        weights = [float(r[-1]) for r in rows]
        assert [int(r[1]) for r in rows] == [0, 1]
        assert weights[0] == 0.0 and 1e-4 <= weights[1] <= 10.0   # warmup, clamp
    model, meta = load_model(str(tmp_path / "inpaint_light_inpaint_v1.nztm"),
                             device="cpu")
    assert meta["name"] == "inpaint.light_inpaint_v1"
    x = torch.rand(1, 64, 64, 3)
    mask = torch.zeros(1, 64, 64, 1)
    mask[:, 20:40, 10:14] = 1.0
    with torch.no_grad():
        y = model(x * (1 - mask), mask=mask)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


def test_cli_video_net_gan(tmp_path, capsys):
    out = _run(capsys, tmp_path, "--arch", "inpaint.light_video_inpaint_v1",
               "--discriminator", "l3c", "--num-samples", "1")
    line = json.loads(next(s for s in out.splitlines()
                           if s.startswith("inpaint_gan: "))[len("inpaint_gan: "):])
    assert line["samples"] == 12 and line["finite"]
    load_model(str(tmp_path / "inpaint_light_video_inpaint_v1.nztm"), device="cpu")


def _load_root_train():
    spec = importlib.util.spec_from_file_location("_root_train", REPO / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gan_export_takes_the_ema_diverges_from_jax(tmp_path, capsys):
    """At ``--ema-decay 1.0`` the EMA stays at the initial weights.  The
    port's export is the EMA, so it equals the generator's start; the JAX
    loop exports its trained parameters, which moved off its start."""
    ema = ["--discriminator", "l3c", "--ema-decay", "1.0", "--num-samples", "2"]
    _run(capsys, tmp_path / "port", *ema)
    targs = create_parser().parse_args(["inpaint", "--model-dir", "m", "--device",
                                        "cpu", "--seed", "71"])
    start = to_flax(ttrainer.create_generator(targs, torch.device("cpu")))
    _meta, got = read_checkpoint(str(tmp_path / "port" / "inpaint_light_inpaint_v1.nztm"))
    for k in start:
        np.testing.assert_array_equal(got[k], start[k])

    root = argparse.ArgumentParser()
    jtrainer.register_train(root.add_subparsers(),
                            _load_root_train().create_default_parser())
    jargs = root.parse_args(
        ["inpaint", "--model-dir", str(tmp_path / "jax"), "--data-dir",
         str(tmp_path / "none"), "--size", "64", "--batch-size", "2",
         "--max-epoch", "1", *ema])
    assert jargs.handler(jargs) == 0
    jm = jax_create_model("inpaint.light_inpaint_v1")
    shape = (2, 64, 64, 3)
    jstart = flatten_params(jm.init(jax.random.PRNGKey(jargs.seed), jnp.zeros(shape),
                                    mask=jnp.zeros(shape[:-1] + (1,)),
                                    train=True)["params"])
    _meta, jgot = read_checkpoint(str(tmp_path / "jax" / "inpaint_light_inpaint_v1.nztm"))
    moved = max(float(np.abs(jgot[k] - np.asarray(jstart[k])).max()) for k in jstart)
    assert moved > 1e-5
    assert os.path.exists(tmp_path / "port" / "gan_steps.csv")


def test_masked_psnr_matches_jax():
    from nunif_tpu.iw3.training.inpaint.benchmark import masked_psnr as jmasked
    from nunif_tpu_torch.iw3.training.inpaint.benchmark import masked_psnr
    z, y = _pair(3, n=3)
    mask = np.zeros(z.shape[:-1] + (1,), np.float32)
    mask[0, 4:9] = 1.0
    mask[2, :, 3:5] = 1.0          # sample 1: no hole
    want = np.asarray(jmasked(jnp.asarray(z), jnp.asarray(y), jnp.asarray(mask)))
    got = masked_psnr(torch.from_numpy(z), torch.from_numpy(y),
                      torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_benchmark_of_a_jax_checkpoint_matches_jax(tmp_path):
    """The benchmark on a ``.nztm`` the JAX package wrote (shaped seeded
    weights): the mean masked PSNR within 1e-3 dB of the JAX benchmark's."""
    from nunif_tpu.iw3.training.inpaint.benchmark import benchmark_main as jbench
    from nunif_tpu.models.io import save_model as jax_save_model
    from nunif_tpu.models.io import unflatten_params
    from nunif_tpu_torch.iw3.models.light_inpaint_v1 import (LightInpaintV1,
                                                             shaped_flax_params)
    from nunif_tpu_torch.iw3.training.inpaint.benchmark import benchmark_main
    flat = shaped_flax_params(LightInpaintV1(), seed=4)
    path = str(tmp_path / "inpaint.nztm")
    jax_save_model(jax_create_model("inpaint.light_inpaint_v1"),
                   unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}), path)
    kw = dict(checkpoint=path, size=64, num_samples=8, batch_size=4)
    want = jbench(**kw)
    got = benchmark_main(**kw, device="cpu")
    assert got["masked_psnr"] == pytest.approx(want["masked_psnr"], abs=1e-3)
    assert 5.0 < got["masked_psnr"] < 60.0
