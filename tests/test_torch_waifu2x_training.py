"""waifu2x training in nunif_tpu_torch against the JAX package, on the CPU:
the generators, the degradations and the dataset (the same pairs for a
seed), one swin_unet_2x train step, the CLI (a tiny vgg_7 run that
improves and exports a ``.nztm`` which JAX's ``load_model`` renders
within 50 dB of the port), the CLIs' flag sets and the training-data
tiles.

The dataset draws its degradations from the global ``random`` and, in
training, each pair's own generator from the dataset's; the tests seed
the global generator before each pair on both sides.

The train step: swin_unet_2x at base 32 on a batch of 2 x 64^2, the
tamed weights with the relative-position tables at std 1, loss ``lbp``,
the JAX parameters carried across.  fp32: loss and gradients within 1e-4
relative (measured 1.8e-6); after one Adam step the update of all
parameters together within 1e-4 relative, each element within 2 lr
(Adam's first update is lr g / (|g| + eps): where a gradient element is
near eps, a 1e-6 difference moves it by up to a sign; measured one of
2048 elements of a kernel at 9e-4 lr).  bf16 (the port's
rounding points, fp32 loss on the fp32 output): the loss and the
gradient of all parameters together within 1.5x JAX's own bf16 error
against JAX's fp32 run (measured 1.15x and 1.11x; one tensor alone, the
head's bias, 1.70x).
"""
import argparse
import importlib.util
import os
import pathlib
import random
import subprocess
import sys

import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from nunif_tpu.models import unflatten_params
from nunif_tpu.models.io import load_model as jax_load_model
from nunif_tpu.utils.tiling import TiledRenderer as JaxTiledRenderer
from nunif_tpu.waifu2x.models import SwinUNet2x as JaxSwinUNet2x
from nunif_tpu.waifu2x.training import dataset as jds, degrade as jdeg
from nunif_tpu.waifu2x.training import generators as jgen
from nunif_tpu.waifu2x.training import trainer as jtrainer

from nunif_tpu_torch import create_training_data as t_ctd, train as t_train
from nunif_tpu_torch.addon import load_addons
from nunif_tpu_torch.models import from_flax, load_model
from nunif_tpu_torch.models.flax_params import _to_flax_layout, flax_keys
from nunif_tpu_torch.training.optimizers import create_optimizer
from nunif_tpu_torch.utils.tiling import TiledRenderer
from nunif_tpu_torch.waifu2x.models.swin_unet import SwinUNet2x, tamed_flax_params
from nunif_tpu_torch.waifu2x.training import dataset as tds, degrade as tdeg
from nunif_tpu_torch.waifu2x.training import generators as tgen
from nunif_tpu_torch.waifu2x.training import trainer as ttrainer

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", sorted(tgen.GENERATORS))
def test_generators_equal_jax(name):
    for seed in (1, 7):
        np.testing.assert_array_equal(np.asarray(tgen.GENERATORS[name](96, seed=seed)),
                                      np.asarray(jgen.GENERATORS[name](96, seed=seed)))
    np.testing.assert_array_equal(np.asarray(tgen.gen_random(64, seed=3)),
                                  np.asarray(jgen.gen_random(64, seed=3)))


def test_degradations_equal_jax():
    im = jgen.gen_shapes(96, seed=2)
    arr = np.asarray(im, np.float32) / 255.0
    for mode, blur, aa in (("catrom", 1.0, True), ("lanczos", 1.05, True),
                           ("triangle", 0.95, False), ("box", 1.0, True)):
        np.testing.assert_array_equal(tdeg._matrix_resize(arr, 40, 48, mode, blur, aa),
                                      jdeg._matrix_resize(arr, 40, 48, mode, blur, aa))
    for style, level in (("art", 3), ("photo", 2), ("photo", 1)):
        for seed in range(6):
            outs = []
            for mod in (tdeg, jdeg):
                random.seed(seed)
                x, _y = mod.RandomJPEGNoise(style, level)(im, im)
                d = mod.RandomDownscale(2, resize_step_p=0.3,
                                        resize_no_antialias_p=0.3)
                x, _y = d(x, x)
                outs.append(np.asarray(x))
            np.testing.assert_array_equal(*outs)
    np.testing.assert_array_equal(np.load(tdeg.os.path.join(
        tdeg.os.path.dirname(tdeg.__file__), "_qtables.npz"))["qtables"],
        np.load(jdeg.os.path.join(jdeg.os.path.dirname(jdeg.__file__),
                                  "_qtables.npz"))["qtables"])


@pytest.mark.parametrize("training,noise", [(True, -1), (True, 1), (False, 2)])
def test_dataset_pairs_equal_jax(tmp_path, training, noise):
    for i in range(2):
        jgen.gen_shapes(160, seed=i).save(tmp_path / f"{i}.png")
    kw = dict(model_offset=16, scale_factor=2, tile_size=32, noise_level=noise,
              style="art", synthetic_p=0.5, num_samples=4, training=training,
              seed=71, da_unsharpmask_p=0.5, da_grayscale_p=0.3)
    t = tds.Waifu2xDataset(str(tmp_path), **kw)
    j = jds.Waifu2xDataset(str(tmp_path), **kw)
    for index in range(4):
        pairs = []
        for ds in (t, j):
            random.seed(100 + index)
            pairs.append(ds.sample_pair(index))
        (tx, ty), (jx, jy) = pairs
        assert tx.shape == (32, 32, 3) and ty.shape == (32, 32, 3)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


@pytest.fixture(scope="module")
def step_case():
    """The port model, the JAX model and parameters, one batch, and JAX's
    loss and gradients in fp32 and bf16 (each compiled once)."""
    model = SwinUNet2x(base_dim=32)
    flat = tamed_flax_params(model, seed=0)
    rng = np.random.default_rng(5)
    for k in flat:
        if k.endswith("relative_position_bias_table"):
            flat[k] = rng.standard_normal(flat[k].shape).astype(np.float32)
    from_flax(model, flat)
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    jmodel = JaxSwinUNet2x(base_dim=32)
    x = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    y = np.random.default_rng(1).random((2, 96, 96, 3), dtype=np.float32)
    loss = jtrainer.create_criterion("lbp")
    want = {}
    for name, dt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        f = jax.jit(jax.value_and_grad(lambda p: loss(jmodel.apply(
            {"params": p}, jnp.asarray(x, dt), train=True).astype(jnp.float32),
            jnp.asarray(y))))
        v, g = f(params)
        want[name] = (float(v), _tree_flat(g))
    return model, flat, params, x, y, want


def _tree_flat(tree):
    return {"/".join(p.key for p in path): np.asarray(v, np.float32) for path, v
            in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_step(model, x, y, dtype):
    model.zero_grad(set_to_none=True)
    v = ttrainer.create_criterion("lbp")(
        model(torch.from_numpy(x).to(dtype), train=True).float(), torch.from_numpy(y))
    v.backward()
    keys = flax_keys(model)
    return float(v.detach()), {keys[n]: _to_flax_layout(n, p.grad.numpy())
                               for n, p in model.named_parameters()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_swin_unet_2x_train_step_fp32_matches_jax(step_case):
    model, flat, params, x, y, want = step_case
    from_flax(model, flat)
    loss, grads = _port_step(model, x, y, torch.float32)
    jloss, jgrads = want["fp32"]
    assert loss == pytest.approx(jloss, rel=1e-4)
    assert set(grads) == set(jgrads)
    for k in jgrads:
        assert _rel(grads[k], jgrads[k]) < 1e-4, k
    # one Adam step on each side
    lr = 1e-4
    opt = create_optimizer("adam", model, lambda step: lr)
    opt.step({n: p.grad for n, p in model.named_parameters()})
    tx = optax.adam(lr)
    new = _tree_flat(jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(
        unflatten_params({k: jnp.asarray(v) for k, v in jgrads.items()}), params))
    keys = flax_keys(model)
    ours = {keys[n]: _to_flax_layout(n, p.detach().numpy()) - flat[keys[n]]
            for n, p in model.named_parameters()}
    theirs = {k: new[k] - flat[k] for k in new}
    for k in theirs:
        assert np.abs(ours[k] - theirs[k]).max() <= 2 * lr, k
    cat = lambda d: np.concatenate([d[k].ravel() for k in sorted(d)])  # noqa: E731
    assert _rel(cat(ours), cat(theirs)) < 1e-4
    from_flax(model, flat)


def test_swin_unet_2x_train_step_bf16_within_jax_bf16_error(step_case):
    model, flat, _params, x, y, want = step_case
    from_flax(model, flat)
    loss, grads = _port_step(model, x, y, torch.bfloat16)
    (l32, g32), (l16, g16) = want["fp32"], want["bf16"]
    assert abs(loss - l32) <= 1.5 * abs(l16 - l32)

    def cat(d):
        return np.concatenate([d[k].ravel() for k in sorted(d)])
    assert _rel(cat(grads), cat(g32)) <= 1.5 * _rel(cat(g16), cat(g32))


def _args(model_dir, **kw):
    ns = argparse.Namespace(
        arch="waifu2x.vgg_7", style="art", noise_level=-1, size=64, loss=None,
        synthetic_p=1.0, da_unsharpmask_p=0.0, da_grayscale_p=0.0,
        bicubic_only=False, deblur=0, data_dir=None, model_dir=str(model_dir),
        batch_size=4, num_samples=16, max_epoch=2, optimizer="adam",
        learning_rate=2e-4, weight_decay=0.0, scheduler="none",
        backward_steps=1, ema_decay=None, num_workers=2, seed=71, resume=False,
        hard_example="linear", hard_example_scale=4.0, device="cpu")
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def test_cli_tiny_fit_improves_and_exports(tmp_path):
    """``python -m nunif_tpu_torch.train waifu2x --device cpu`` on vgg_7:
    the eval Y-PSNR rises, the best model is exported, and JAX's
    ``load_model`` renders it within 50 dB of the port."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "nunif_tpu_torch.train", "waifu2x", "--arch",
         "waifu2x.vgg_7", "--synthetic-p", "1.0", "--size", "64",
         "--batch-size", "4", "--num-samples", "16", "--max-epoch", "2",
         "--learning-rate", "2e-4", "--num-workers", "2", "--model-dir",
         str(tmp_path), "--device", "cpu"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json
    epochs = [json.loads(line[len("train: "):]) for line in proc.stdout.splitlines()
              if line.startswith("train: ")]
    assert [e["epoch"] for e in epochs] == [0, 1]
    assert all(np.isfinite(e["train_loss"]) for e in epochs)
    assert epochs[1]["eval_y_psnr"] > epochs[0]["eval_y_psnr"]
    path = tmp_path / "waifu2x_vgg_7.nztm"
    assert path.exists() and (tmp_path / "waifu2x_vgg_7.ckpt").exists()
    model, meta = load_model(str(path), device="cpu")
    assert meta["train_kwargs"]["seed"] == 71
    jmodel, jparams, _jmeta = jax_load_model(str(path))
    x = np.asarray(jgen.gen_shapes(48, seed=9), np.float32) / 255.0
    with torch.no_grad():
        got = TiledRenderer(model).render(torch.from_numpy(x), tile_size=32).numpy()
    want = np.asarray(JaxTiledRenderer(jmodel, jparams).render(x, tile_size=32))
    a, b = (np.clip(got, 0, 1) * 255).round(), (np.clip(want, 0, 1) * 255).round()
    mse = float(np.mean((a - b) ** 2))
    assert mse == 0 or 10 * np.log10(255 ** 2 / mse) >= 50.0


def test_resume_and_cuda_request(tmp_path):
    """--resume continues from the checkpoint; --device cuda raises
    without a card instead of training on the CPU."""
    ttrainer.Waifu2xTrainerApp(_args(tmp_path, max_epoch=1)).fit()
    app = ttrainer.Waifu2xTrainerApp(_args(tmp_path, max_epoch=2, resume=True))
    assert app.trainer.last_epoch == 1 and app.trainer.optimizer.count == 4
    app.fit()
    assert app.trainer.last_epoch == 2 and app.trainer.optimizer.count == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrainer.Waifu2xTrainerApp(_args(tmp_path, device="cuda"))


def _load_root(name):
    spec = importlib.util.spec_from_file_location(f"_root_{name}", REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(default_parser, register):
    root = argparse.ArgumentParser()
    sub = root.add_subparsers()
    p = register(sub, default_parser)
    return {s.lstrip("-") for a in p._actions for s in a.option_strings
            if s.startswith("--")} - {"help"}


def test_cli_flags_match_jax():
    """The port's parsers have the JAX parsers' flags but
    ``JAX_FLAGS_NOT_IN_PORT``, plus ``PORT_ONLY_FLAGS``."""
    jtrain, jctd = _load_root("train"), _load_root("create_training_data")
    ours = _flags(t_train.create_default_parser(), ttrainer.register_train)
    theirs = _flags(jtrain.create_default_parser(), jtrainer.register_train)
    assert theirs - ours == set(t_train.JAX_FLAGS_NOT_IN_PORT)
    assert ours - theirs == set(t_train.PORT_ONLY_FLAGS)
    assert _flags(t_ctd.create_default_parser(), ttrainer.register_create_training_data) \
        == _flags(jctd.create_default_parser(), jtrainer.register_create_training_data)
    assert [m.__name__ for m, _fn in load_addons("train")] == [
        "nunif_tpu_torch.waifu2x.training.trainer",
        "nunif_tpu_torch.iw3.training.sbs.trainer",
        "nunif_tpu_torch.iw3.training.inpaint.trainer",
        "nunif_tpu_torch.iw3.training.sod", "nunif_tpu_torch.iw3.training.depth_aa",
        "nunif_tpu_torch.iw3.training.da3mono", "nunif_tpu_torch.stlizer.training",
        "nunif_tpu_torch.cliqa.training", "nunif_tpu_torch.imagenet.training"]
    args = t_train.create_parser().parse_args(["waifu2x", "--model-dir", "m"])
    assert (args.arch, args.size, args.batch_size, args.optimizer, args.device) == \
        ("waifu2x.swin_unet_2x", 104, 16, "adam", "cuda")
    assert args.handler is ttrainer.train_main


def test_create_training_data_equals_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for i in range(3):
        jgen.gen_text_image(100 + 20 * i, seed=i).save(src / f"{i}.png")
    assert t_ctd.main(["waifu2x", "-i", str(src), "-o", str(tmp_path / "t"),
                       "--size", "48", "--eval-rate", "0.3"]) == 0
    jtrainer.create_training_data_main(argparse.Namespace(
        dataset_dir=str(src), data_dir=str(tmp_path / "j"), size=48, eval_rate=0.3))
    for split in ("train", "eval"):
        names = sorted(os.listdir(tmp_path / "j" / split))
        assert names and sorted(os.listdir(tmp_path / "t" / split)) == names
        for n in names:
            from PIL import Image
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / "t" / split / n)),
                np.asarray(Image.open(tmp_path / "j" / split / n)))
