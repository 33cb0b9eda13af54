"""The sod, depth_aa, da3mono, stlizer outpaint and cliqa trainers in
nunif_tpu_torch against the JAX package, on the CPU: their datasets (equal
batches for a seed), their losses and every parameter gradient through
the nets (fp32), ``DA3MonoDisparity`` and its converter, the
``find_mapper`` fits and curves, ``sample_frames``, each trainer's CLI for
one tiny epoch, and the addon list.

Tolerances: datasets, converted parameters, the quantile indexes and
the fits' grid picks are equal (the fits' sample positions within one
fp32 rounding, the curves within 1e-6); DA3MonoDisparity's forward within 1e-5
(fp32); a loss within 1e-4 relative and each gradient element within
rtol 1e-4 and an atol of 1e-6 x the largest gradient magnitude of the
net's parameters plus both packages' own fp32 errors in that tensor,
measured against the port's float64 gradient (``torch_grad_check.hold``); a fit's error
within 1e-5 relative (1000 fp32 terms summed in another order, at sample
positions up to one rounding apart).
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
from PIL import Image

import jax
import jax.numpy as jnp
import optax

import nunif_tpu.cliqa  # noqa: F401  (registers the JAX archs)
import nunif_tpu.iw3  # noqa: F401
import nunif_tpu.stlizer.light_outpaint_v1  # noqa: F401
from nunif_tpu.cliqa import training as jcliqa
from nunif_tpu.iw3.models import da3mono_disparity as jda3m
from nunif_tpu.iw3.training import da3mono as jda3, depth_aa as jdaa
from nunif_tpu.iw3.training import find_mapper as jmapper, sod as jsod
from nunif_tpu.models import create_model as jax_create_model
from nunif_tpu.models.io import flatten_params, load_model as jax_load_model
from nunif_tpu.models.torch_convert import convert_da3mono_disparity as jax_convert
from nunif_tpu.modules import losses as JL
from nunif_tpu.modules.resize import resize as jresize
from nunif_tpu.stlizer import training as jst

from nunif_tpu_torch.addon import ADDON_MODULES, load_addons
from nunif_tpu_torch.cliqa import training as tcliqa
from nunif_tpu_torch.iw3.models import da3mono_disparity as tda3m
from nunif_tpu_torch.iw3.training import da3mono as tda3, depth_aa as tdaa
from nunif_tpu_torch.iw3.training import find_mapper as tmapper, sod as tsod
from nunif_tpu_torch.models import create_model, from_flax, init_flax_default, load_model, to_flax
from nunif_tpu_torch.models.torch_convert import convert_da3mono_disparity, flatten
from nunif_tpu_torch.stlizer import training as tst
from nunif_tpu_torch.train import create_parser, main as train_main

import torch_grad_check as gc
import torch_iw3_helpers as h

REPO = pathlib.Path(__file__).resolve().parents[1]


def _seeded(name, seed=0, **kw):
    model = create_model(name, **kw)
    init_flax_default(model, torch.Generator().manual_seed(seed))
    return model, to_flax(model)


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _equal_batches(a, b, n=None):
    pairs = list(zip(a, b, strict=True))
    assert pairs and (n is None or len(pairs) == n)
    for ja, tb in pairs:
        assert set(ja) == set(tb)
        for k in ja:
            np.testing.assert_array_equal(tb[k], ja[k])


# ------------------------------------------------------------------ da3mono
def test_quantile_indexes_equal_jax():
    for n in (64, 65, 100, 256, 4096, 16384, 129600, 921600):
        want = np.asarray(jnp.linspace(1, n - 2, tda3m.FEAT_DIM - 2).astype(jnp.int32))
        np.testing.assert_array_equal(tda3m.quantile_indexes(n).numpy(), want)


def test_da3mono_disparity_matches_jax():
    model, flat = _seeded("iw3.da3mono_disparity")
    rng = np.random.default_rng(3)
    depth = rng.uniform(1, 4, (3, 24, 40, 1)).astype(np.float32)
    depth[0, :6] = depth[0].max()                 # a sky at the maximum
    want = np.asarray(jax_create_model("iw3.da3mono_disparity").apply_fn(
        h.jparams(flat), jnp.asarray(depth)))
    with torch.no_grad():
        got = model(torch.from_numpy(depth)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tda3m.extract_features(torch.from_numpy(depth)).numpy(),
        np.asarray(jda3m.extract_features(jnp.asarray(depth))))


def test_convert_da3mono_disparity_matches_jax():
    rng = np.random.default_rng(4)
    sd = {}
    for i, (o, n) in zip((0, 2, 4), ((128, 64), (128, 128), (2, 128))):
        sd[f"mlp.{i}.weight"] = torch.from_numpy(rng.standard_normal((o, n)).astype(np.float32))
        sd[f"mlp.{i}.bias"] = torch.from_numpy(rng.standard_normal(o).astype(np.float32))
    got = flatten(convert_da3mono_disparity(sd))
    want = flatten(jax_convert({k: v.numpy() for k, v in sd.items()}))
    assert set(got) == set(want) == set(to_flax(create_model("iw3.da3mono_disparity")))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_da3mono_dataset_loss_and_gradients_match_jax():
    """The batches equal JAX's but at each map's nearest point, which JAX
    leaves at 0 and the port floors at MIN_DEPTH (its target there follows
    from the floored depth)."""
    a = jda3.DA3MonoDataset(size=32, num_samples=6, seed=5)
    b = tda3.DA3MonoDataset(size=32, num_samples=6, seed=5)
    pairs = list(zip(a.batches(3), b.batches(3), strict=True))
    assert len(pairs) == 2
    for ja, tb in pairs:
        near = ja["x"] < tda3.MIN_DEPTH
        assert near.any() and near.mean() < 0.01
        assert not ja["x"][near].any() and np.all(tb["x"][near] == np.float32(tda3.MIN_DEPTH))
        for k in ("x", "y"):
            np.testing.assert_array_equal(tb[k][~near], ja[k][~near])
    batch = next(b.batches(3))
    model, flat = _seeded("iw3.da3mono_disparity", seed=1)
    jm = jax_create_model("iw3.da3mono_disparity")
    jb = _j(batch)
    want = gc.jax_loss_and_grads(flat, lambda p: jda3.normalized_mse(
        jm.apply_fn(p, jb["x"], train=True), jb["y"]))
    tb = _t(batch)
    gc.hold(model, lambda m, dt: tda3.normalized_mse(m(tb["x"].to(dt), train=True),
                                                   tb["y"].to(dt)), want)
    x, y = jb["x"], jb["y"]
    assert float(tda3.normalized_psnr(tb["x"], tb["y"])) == pytest.approx(
        float(jda3.normalized_psnr(x, y)), rel=1e-5)


def test_da3mono_zero_depth_diverges_from_jax():
    """At the JAX trainer's defaults (flax's init from seed 71, its first
    batch) the net's ReLU shift is 0 where a map reaches distance 0, the
    disparity there is infinite and the loss NaN, so every step is
    skipped; the port's floored maps give a finite loss at the same
    weights."""
    jm = jax_create_model("iw3.da3mono_disparity")
    params = jm.init_params(jax.random.PRNGKey(71), (1, 128, 128, 1))
    jb = next(jda3.DA3MonoDataset(size=128, num_samples=16, seed=71).batches(16))
    jz = jm.apply_fn(params, jnp.asarray(jb["x"]))
    assert np.isnan(float(jda3.normalized_mse(jz, jnp.asarray(jb["y"]))))
    model = create_model("iw3.da3mono_disparity")
    from_flax(model, {k: np.asarray(v) for k, v in flatten_params(params).items()})
    tb = _t(next(tda3.DA3MonoDataset(size=128, num_samples=16, seed=71).batches(16)))
    with torch.no_grad():
        loss = float(tda3.normalized_mse(model(tb["x"]), tb["y"]))
    assert np.isfinite(loss) and loss > 0


# ----------------------------------------------------------------- depth_aa
@pytest.fixture(scope="module")
def depth_aa_case():
    a = jdaa.DepthAADataset(size=48, num_samples=4, seed=6)
    b = tdaa.DepthAADataset(size=48, num_samples=4, seed=6)
    batches = list(b.batches(2))
    _equal_batches(a.batches(2), batches, n=2)
    model, flat = _seeded("iw3.depth_aa", seed=2)
    return model, flat, batches[0]


@pytest.mark.parametrize("kind", ["dct", "l1", "lbp"])
def test_depth_aa_loss_and_gradients_match_jax(depth_aa_case, kind):
    model, flat, batch = depth_aa_case
    jm = jax_create_model("iw3.depth_aa")
    jb, tb = _j(batch), _t(batch)
    jc, tc = jdaa.make_criterion(kind), tdaa.make_criterion(kind)
    want = gc.jax_loss_and_grads(flat, lambda p: jc(jm.apply_fn(p, jb["x"], train=True),
                                                  jb["y"]))
    gc.hold(model, lambda m, dt: tc(m(tb["x"].to(dt), train=True), tb["y"].to(dt)), want)


# ---------------------------------------------------------------------- sod
def test_sod_dataset_equals_jax(tmp_path):
    rng = np.random.default_rng(7)
    for split in ("img", "mask"):
        (tmp_path / split).mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(
            tmp_path / "img" / f"{i}.png")
        Image.fromarray(rng.integers(0, 256, (40, 50), dtype=np.uint8)).save(
            tmp_path / "mask" / f"{i}.png")
    for d in (str(tmp_path), str(tmp_path / "none")):
        a = jsod.SODDataset(d, size=32, num_samples=4, seed=8)
        b = tsod.SODDataset(d, size=32, num_samples=4, seed=8)
        _equal_batches(a.batches(2), b.batches(2), n=2)


def test_sod_loss_and_gradients_match_jax():
    """SODV1's seven training maps at its internal 192 px against a 64 px
    target, resized to them (bilinear, antialiased), through multi_bce."""
    batch = next(tsod.SODDataset(None, size=64, num_samples=2, seed=9).batches(2))
    model, flat = _seeded("iw3.sod_v1", seed=3)
    jm = jax_create_model("iw3.sod_v1")
    jb, tb = _j(batch), _t(batch)

    def jloss(p):
        out = jm.apply_fn(p, jb["x"], train=True)
        y = jresize(jb["y"], out[0].shape[1], out[0].shape[2], mode="bilinear",
                    antialias=True)
        return jsod.multi_bce(out, y)
    want = gc.jax_loss_and_grads(flat, jloss)
    gc.hold(model, lambda m, dt: tsod.sod_loss(m(tb["x"].to(dt), train=True),
                                             tb["y"].to(dt)), want)
    outs = model(tb["x"], train=True)
    assert len(outs) == 7 and all(tuple(o.shape[1:3]) == (192, 192) for o in outs)


# ------------------------------------------------------------------ stlizer
def test_outpaint_dataset_equals_jax(tmp_path):
    rng = np.random.default_rng(10)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (30, 45, 3), dtype=np.uint8)).save(
            tmp_path / f"{i}.png")
    for d in (str(tmp_path), None):
        a = jst.OutpaintDataset(d, size=32, num_samples=4, seed=11)
        b = tst.OutpaintDataset(d, size=32, num_samples=4, seed=11)
        _equal_batches(a.batches(2), b.batches(2), n=2)
    for seed in range(5):
        np.testing.assert_array_equal(tst.make_border_mask(np.random.default_rng(seed), 40),
                                      jst.make_border_mask(np.random.default_rng(seed), 40))


def test_outpaint_loss_and_gradients_match_jax():
    batch = next(tst.OutpaintDataset(None, size=64, num_samples=2, seed=12).batches(2))
    model, flat = _seeded("stlizer.light_outpaint_v1", seed=4)
    jm = jax_create_model("stlizer.light_outpaint_v1")
    jb, tb = _j(batch), _t(batch)
    dct = JL.dct_loss(window_size=8, clamp=True, yrgb=False)

    def jloss(p):
        out, z = jm.apply_fn(p, jb["y"] * (1.0 - jb["mask"]), mask=jb["mask"], train=True)
        return JL.clamp_loss_of(JL.l1_loss)(out, jb["y"]) + dct(z, jb["y"]) * 0.5
    want = gc.jax_loss_and_grads(flat, jloss)
    loss = tst.make_outpaint_loss()

    def tloss(m, dt):
        y, mask = tb["y"].to(dt), tb["mask"].to(dt)
        out, z = m(y * (1.0 - mask), mask, train=True)
        return loss(out, z, y)
    gc.hold(model, tloss, want)


# -------------------------------------------------------------------- cliqa
@pytest.mark.parametrize("kind", ["jpeg", "noise", "resize"])
def test_cliqa_dataset_loss_and_gradients_match_jax(tmp_path, kind):
    rng = np.random.default_rng(13)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)).save(
            tmp_path / f"{i}.png")
    for d, p in ((str(tmp_path), 0.5), (None, 1.0)):
        a = jcliqa.CliqaDataset(d, kind, patch_size=32, num_samples=4, synthetic_p=p, seed=14)
        b = tcliqa.CliqaDataset(d, kind, patch_size=32, num_samples=4, synthetic_p=p, seed=14)
        _equal_batches(a.batches(2), b.batches(2), n=2)
    batch = next(tcliqa.CliqaDataset(str(tmp_path), kind, patch_size=64, num_samples=2,
                                     seed=15).batches(2))
    arch = tcliqa.ARCHS[kind]
    model, flat = _seeded(arch, seed=5)
    jm = jax_create_model(arch)
    jb, tb = _j(batch), _t(batch)

    def jloss(p):    # the JAX trainer's loss_fn
        out = jm.apply_fn(p, jb["x"], train=True)
        if kind == "jpeg":
            quality, subsampling = out
            return jnp.mean(jnp.abs(quality[:, 0] - jb["y"][:, 0])) + jnp.mean(
                optax.sigmoid_binary_cross_entropy(subsampling[:, 0], jb["y"][:, 1]))
        return jnp.mean(jnp.abs(out[:, 0] - jb["y"][:, 0]))
    want = gc.jax_loss_and_grads(flat, jloss)
    loss, evaluate = tcliqa.make_cliqa_loss(kind)
    gc.hold(model, lambda m, dt: loss(m(tb["x"].to(dt), train=True), tb["y"].to(dt)), want)
    out = jm.apply_fn(h.jparams(flat), jb["x"])
    jeval = jnp.mean(jnp.abs((out[0] if kind == "jpeg" else out)[:, 0] - jb["y"][:, 0]))
    with torch.no_grad():
        got = evaluate(model(tb["x"]), tb["y"])
    assert float(got) == pytest.approx(float(jeval), rel=1e-4)


# --------------------------------------------------------------- find_mapper
def test_find_mapper_fits_and_curves_equal_jax(tmp_path):
    # the sample positions: XLA's fused evaluation; a few end one fp32
    # rounding away at a non-integer start
    np.testing.assert_allclose(tmapper.linspace(0.2, 1, 1000).numpy(),
                               np.asarray(jnp.linspace(0.2, 1, 1000)), rtol=2 ** -23, atol=0)
    np.testing.assert_array_equal(tmapper.linspace(0, 1, 1000).numpy(),
                                  np.asarray(jnp.linspace(0, 1, 1000)))
    for got, want in ((tmapper.fit_softplus_v1_to_v2(6.0, 40, 40),
                       jmapper.fit_softplus_v1_to_v2(6.0, 40, 40)),
                      (tmapper.fit_softplus_to_hardplus(2.0, n_bias=200),
                       jmapper.fit_softplus_to_hardplus(2.0, n_bias=200)),
                      (tmapper.fit_inv_softplus(0.515, 12.0, 2.0, n_bias=100, n_scale=40),
                       jmapper.fit_inv_softplus(0.515, 12.0, 2.0, n_bias=100, n_scale=40))):
        err = [k for k in want if k in ("mae", "mse")][0]
        assert {k: v for k, v in got.items() if k != err} == \
            {k: v for k, v in want.items() if k != err}
        # the inverse fit's best score is NaN in both at this grid (a scale
        # whose curve saturates: 0 / 0), and argmin picks it in both
        np.testing.assert_allclose(got[err], want[err], rtol=1e-5)
    names = ["none", "mul_2", "inv_mul_1"]
    tmapper.dump_curves(names, str(tmp_path / "t.csv"), n=50)
    jmapper.dump_curves(names, str(tmp_path / "j.csv"), n=50)
    t_lines = (tmp_path / "t.csv").read_text().splitlines()
    j_lines = (tmp_path / "j.csv").read_text().splitlines()
    assert t_lines[0] == j_lines[0] == "x," + ",".join(names) and len(t_lines) == 51
    # the curves: fp32 exp / log of two libraries, a few roundings apart
    np.testing.assert_allclose(np.loadtxt(t_lines[1:], delimiter=","),
                               np.loadtxt(j_lines[1:], delimiter=","), rtol=1e-6, atol=1e-7)


def test_sample_frames_writes_named_frames(tmp_path):
    """As the JAX test: skipped where the video backend is absent."""
    from nunif_tpu.iw3.training.sample_frames import md5_name as jmd5
    from nunif_tpu_torch.iw3.training.sample_frames import md5_name, sample_frames
    assert md5_name("a.mp4") == jmd5("a.mp4")
    from nunif_tpu_torch.video import backend
    if not backend.available():
        pytest.skip("native video backend unavailable")
    path = str(tmp_path / "in.mp4")
    w = backend.VideoWriter(path, 64, 48, fps_num=12)
    for i in range(24):
        f = np.zeros((48, 64, 3), np.uint8)
        f[..., 0] = int(255 * i / 23)
        w.write(f)
    w.close()
    n = sample_frames(path, str(tmp_path / "out"), samples=6, rotate=1)
    files = sorted(os.listdir(tmp_path / "out"))
    assert n == len(files) and 4 <= n <= 8
    assert all(f.startswith(md5_name("in.mp4") + "_") for f in files)
    assert Image.open(tmp_path / "out" / files[0]).size == (48, 64)


# ---------------------------------------------------------------------- CLI
CLI = ["--device", "cpu", "--batch-size", "2", "--num-samples", "4",
       "--max-epoch", "1"]
TRAINERS = {"sod": ("iw3_sod_v1.nztm", ["--size", "64"]),
            "depth_aa": ("iw3_depth_aa.nztm", ["--size", "48"]),
            "da3mono": ("iw3_da3mono_disparity.nztm", ["--size", "32"]),
            "stlizer_outpaint": ("stlizer_light_outpaint_v1.nztm", ["--size", "64"]),
            "cliqa": ("cliqa_jpeg_quality.nztm", ["--size", "64", "--synthetic-p", "1.0"])}


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_cli_one_epoch_writes_a_loadable_model(tmp_path, capsys, name):
    file, extra = TRAINERS[name]
    assert train_main([name, "--model-dir", str(tmp_path), "--data-dir",
                       str(tmp_path / "none"), *CLI, *extra]) == 0
    lines = [json.loads(s[len("train: "):]) for s in capsys.readouterr().out.splitlines()
             if s.startswith("train: ")]
    assert len(lines) == 1 and lines[0]["steps"] == 2 and lines[0]["device"] == "cpu"
    assert np.isfinite(lines[0]["train_loss"]) and np.isfinite(lines[0]["eval_score"])
    model, meta = load_model(str(tmp_path / file), device="cpu")
    assert meta["name"] == model.model_name
    if name == "da3mono":       # the JAX loader reads it to the same weights
        _jm, jp, _jmeta = jax_load_model(str(tmp_path / file))
        jflat = flatten_params(jp)
        for k, v in to_flax(model).items():
            np.testing.assert_array_equal(v, np.asarray(jflat[k]))
        # the benchmark: JAX's model and metric on the port's (floored) maps
        score = tda3.benchmark_main(str(tmp_path / file), size=32, n=8, device="cpu")
        want = [float(-jda3.normalized_psnr(_jm.apply_fn(jp, jnp.asarray(b["x"])),
                                            jnp.asarray(b["y"])))
                for b in tda3.DA3MonoDataset(size=32, num_samples=8, seed=137).batches(4)]
        assert score == pytest.approx(sum(want) / len(want), rel=1e-4)


def _load_root_train():
    spec = importlib.util.spec_from_file_location("_root_train", REPO / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(register, default_parser):
    p = register(argparse.ArgumentParser().add_subparsers(), default_parser)
    return {s.lstrip("-") for a in p._actions for s in a.option_strings
            if s.startswith("--")} - {"help"}


def test_addons_and_flags_match_jax():
    """Nine trainers in the JAX list's order, each with the JAX
    subcommand's flags but ``--steps-per-dispatch``, plus ``--device``."""
    from nunif_tpu.addon import ADDON_MODULES as JAX_ADDONS, load_addons as jax_load_addons
    from nunif_tpu_torch import train as t_train
    assert ADDON_MODULES == [m.replace("nunif_tpu.", "nunif_tpu_torch.", 1)
                             for m in JAX_ADDONS]
    mods = load_addons("train")
    assert [m.__name__ for m, _fn in mods] == ADDON_MODULES and len(mods) == 9
    assert [m.__name__ for m, _fn in load_addons("create_training_data")] == [
        "nunif_tpu_torch.waifu2x.training.trainer",
        "nunif_tpu_torch.iw3.training.sbs.trainer"]
    jroot = _load_root_train()
    for (tm, tfn), (jm, jfn) in zip(mods, jax_load_addons("train"), strict=True):
        ours = _flags(tfn, t_train.create_default_parser())
        theirs = _flags(jfn, jroot.create_default_parser())
        assert theirs - ours == set(t_train.JAX_FLAGS_NOT_IN_PORT), tm.__name__
        assert ours - theirs == set(t_train.PORT_ONLY_FLAGS), tm.__name__
    names = set(create_parser()._subparsers._group_actions[0].choices)
    assert names == {"waifu2x", "sbs", "inpaint", "sod", "depth_aa", "da3mono",
                     "stlizer_outpaint", "cliqa", "imagenet"}
    args = create_parser().parse_args(["cliqa", "--model-dir", "m"])
    assert (args.kind, args.size, args.device) == ("jpeg", 128, "cuda")


@pytest.mark.parametrize("name", ["sbs", "imagenet", "sod", "depth_aa", "da3mono",
                                  "stlizer_outpaint", "cliqa"])
def test_trainers_default_to_the_card(tmp_path, monkeypatch, name):
    """Without CUDA each new trainer raises at its default ``--device``
    instead of training on the CPU; so do the sbs data command, the mask
    threshold sweep and da3mono's benchmark."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main([name, "--model-dir", str(tmp_path), "--data-dir", str(tmp_path)])
    if name == "sbs":
        from nunif_tpu_torch import create_training_data as t_ctd
        from nunif_tpu_torch.iw3.training.sbs.find_mask_threshold import sweep
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_ctd.main(["sbs", "-i", "synthetic", "-o", str(tmp_path / "d")])
        (tmp_path / "r").mkdir()
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "r" / "0.png")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sweep(str(tmp_path / "r"), str(tmp_path / "r"), "none.nztm")
    if name == "da3mono":
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tda3.benchmark_main()
