"""The waifu2x image path of nunif_tpu_torch against the JAX package, on
the CPU: TTA, the alpha border pad, grain, ``Waifu2x.convert`` with RGBA
and TTA, gray images, the 16-bit PNG writer, the CLI at its defaults on the
bundled turbo zoo, and the shipped ``scale2x`` on the eval set.

Where the JAX package draws noise from ``jax.random``, both packages get the
same numpy noise.  Tensors are held to 1e-6 (pure elementwise maths) or
1e-4 (a model in fp32); uint8 frames to 50 dB.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nunif_tpu.core.dtypes import FP32_POLICY as J_FP32
from nunif_tpu.models import save_model as jax_save_model
from nunif_tpu.models import unflatten_params
from nunif_tpu.models.io import load_model as jax_load_model
from nunif_tpu.transforms import tta as jtta
from nunif_tpu.utils import alpha as jalpha
from nunif_tpu.utils import pil_io as jpil_io
from nunif_tpu.utils import rgb_noise as jnoise
from nunif_tpu.utils.tiling import TiledRenderer as JaxRenderer
from nunif_tpu.waifu2x import runtime as jruntime
from nunif_tpu.waifu2x.benchmark import _np_resize, psnr
from nunif_tpu.waifu2x.models import turbo as jturbo
from nunif_tpu.waifu2x.training import generators as G

from nunif_tpu_torch.core.dtypes import FP32_POLICY
from nunif_tpu_torch.models import load_model, to_flax
from nunif_tpu_torch.transforms import tta
from nunif_tpu_torch.utils import alpha, pil_io, rgb_noise
from nunif_tpu_torch.utils.tiling import TiledRenderer
from nunif_tpu_torch.waifu2x import benchmark as bench
from nunif_tpu_torch.waifu2x import cli
from nunif_tpu_torch.waifu2x.models import turbo
from nunif_tpu_torch.waifu2x.runtime import Waifu2x, default_model_dir

HERE = os.path.dirname(os.path.abspath(__file__))
EVAL_NPZ = os.path.join(HERE, "torch_data", "w2x_eval_256.npz")
# tools/make_eval_set.py's SPEC: (name, generator, seed)
EVAL_SPEC = [
    ("screentone_a", G.gen_screentone, 900001),
    ("screentone_b", G.gen_screentone, 900002),
    ("dots_a", G.gen_dot_grid, 900003),
    ("dots_b", G.gen_dot_grid, 900004),
    ("text_a", G.gen_text_image, 900005),
    ("text_b", G.gen_text_image, 900006),
    ("shapes_a", G.gen_shapes, 900007),
    ("shapes_b", G.gen_shapes, 900008),
    ("gradient_a", G.gen_gradient, 900009),
    ("gradient_b", G.gen_gradient, 900010),
]


def test_tta_matches_jax():
    x = np.random.default_rng(0).random((2, 5, 7, 3), dtype=np.float32)
    splits = tta.tta_split(torch.from_numpy(x))
    jsplits = jtta.tta_split(jnp.asarray(x))
    assert len(splits) == len(jsplits) == 8
    for got, want in zip(splits, jsplits):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # outputs of a 2x "model" (nearest) on each transform, offset so the
    # mean lands above 1 and the clip is seen
    outs = [s.repeat_interleave(2, -3).repeat_interleave(2, -2) * 1.3
            for s in splits]
    merged = tta.tta_merge(outs).numpy()
    np.testing.assert_allclose(
        merged, np.asarray(jtta.tta_merge([jnp.asarray(o.numpy())
                                           for o in outs])), atol=1e-6)
    np.testing.assert_allclose(
        merged, np.clip(np.repeat(np.repeat(x, 2, -3), 2, -2) * 1.3, 0, 1),
        atol=1e-6)
    assert merged.max() == 1.0


@pytest.mark.parametrize("offset", [1, 7, 16])
def test_alpha_border_pad_matches_jax(offset):
    rng = np.random.default_rng(offset)
    rgb = rng.random((37, 45, 3), dtype=np.float32)
    yy, xx = np.mgrid[:37, :45]
    a = np.where((yy - 18) ** 2 + (xx - 20) ** 2 < 120, 1.0, 0.0)
    a = np.where((yy > 30) & (xx > 35), 0.5, a).astype(np.float32)[..., None]
    got = alpha.alpha_border_pad(torch.from_numpy(rgb), torch.from_numpy(a),
                                 offset).numpy()
    want = np.asarray(jalpha.alpha_border_pad(jnp.asarray(rgb), jnp.asarray(a),
                                              offset))
    np.testing.assert_allclose(got, want, atol=1e-6)
    # opaque pixels keep their colour; transparent ones near them change
    opaque = a[..., 0] > 0
    np.testing.assert_array_equal(got[opaque], rgb[opaque])
    assert np.abs(got[~opaque] - rgb[~opaque]).max() > 0.1


@pytest.mark.parametrize("light_decay", [True, False])
def test_apply_rgb_noise_matches_jax_on_shared_noise(light_decay):
    rng = np.random.default_rng(3)
    rgb = rng.random((1, 24, 30, 3), dtype=np.float32)
    noise = rng.standard_normal((1, 24, 30, 3)).astype(np.float32)
    got = rgb_noise.apply_rgb_noise(torch.from_numpy(rgb),
                                    torch.from_numpy(noise), strength=0.35,
                                    light_decay=light_decay).numpy()
    want = np.asarray(jnoise.apply_rgb_noise(
        jnp.asarray(rgb), jnp.asarray(noise), strength=0.35,
        light_decay=light_decay))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(got - rgb).max() > 0.05


def test_rgb_noise_like_structure():
    """Level 2 is 0.5 * a full-res draw + 0.5 * a half-res draw repeated
    over 2x2 pixels (variance 0.5), from the caller's generator; odd sizes
    are covered too."""
    base = torch.zeros((2, 64, 90, 3))
    got = rgb_noise.rgb_noise_like(base, generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    full = torch.randn(base.shape, generator=gen)
    half = torch.randn((2, 32, 45, 3), generator=gen)
    want = 0.5 * full + 0.5 * half.repeat_interleave(2, 1).repeat_interleave(2, 2)
    assert torch.equal(got, want)
    assert abs(float(got.var()) - 0.5) < 0.03
    one = rgb_noise.rgb_noise_like(base, level=1,
                                   generator=torch.Generator().manual_seed(7))
    assert torch.equal(one, full) and abs(float(one.var()) - 1.0) < 0.05
    odd = rgb_noise.rgb_noise_like(torch.zeros((31, 17, 3)))
    assert odd.shape == (31, 17, 3)
    with pytest.raises(ValueError, match="level"):
        rgb_noise.rgb_noise_like(base, level=3)


def test_eval_fixture_equals_generator():
    """tests/torch_data/w2x_eval_256.npz is tools/make_eval_set.py's set at
    256 px, as uint8 arrays (the card has no JAX package to generate it)."""
    data = np.load(EVAL_NPZ)
    assert list(data.files) == [name for name, _fn, _seed in EVAL_SPEC]
    for name, fn, seed in EVAL_SPEC:
        np.testing.assert_array_equal(data[name],
                                      np.asarray(fn(size=256, seed=seed)),
                                      err_msg=name)
        assert data[name].shape == (256, 256, 3) and data[name].dtype == np.uint8


def test_shipped_scale2x_matches_jax_and_beats_catrom():
    """The bundled scale2x at 128 px on two eval-set images
    (tests/test_waifu2x_runtime.py's check), at the default bf16 policy:
    the port's uint8 frame is >= 50 dB against JAX's, and it beats catrom
    by > 0.1 dB on the mean."""
    path = os.path.join(default_model_dir(), "scale2x.nztm")
    model, _meta = load_model(path, device="cpu")
    jmodel, jparams, _ = jax_load_model(path)
    renderer, jrenderer = TiledRenderer(model), JaxRenderer(jmodel, jparams)
    gains, frame_psnr = [], []
    for fn, seed in ((G.gen_text_image, 900005), (G.gen_shapes, 900007)):
        hr = np.asarray(fn(size=128, seed=seed), np.float32)[..., :3] / 255.0
        lr = _np_resize(hr, 64, 64)
        sr = renderer.render(lr, tile_size=64, batch_size=1).numpy()
        jsr = np.asarray(jrenderer.render(lr, tile_size=64, batch_size=1))
        frame_psnr.append(psnr(np.round(sr * 255) / 255,
                               np.round(jsr * 255) / 255))
        up = _np_resize(lr, 128, 128, mode="catrom", antialias=False)
        gains.append(psnr(sr, hr) - psnr(up, hr))
    assert min(frame_psnr) >= 50.0, frame_psnr
    assert float(np.mean(gains)) > 0.1, gains


def test_shipped_scale2x_eval_scores_match_jax(tmp_path):
    """The benchmark protocol on the fixture (two images, on arrays, no
    PIL): the port's scores equal the JAX package's within 0.05 dB, and
    the benchmark CLI scores turbo through ``--model-file`` alike."""
    import csv
    from PIL import Image
    data = np.load(EVAL_NPZ)
    names = ["dots_a", "gradient_a"]
    images = [(n, data[n].astype(np.float32) / 255.0) for n in names]
    path = os.path.join(default_model_dir(), "scale2x.nztm")
    model, _meta = load_model(path, device="cpu")
    rows, _secs = bench.score_images(images, TiledRenderer(model), scale=2,
                                     baseline=True)
    for n in names:
        Image.fromarray(data[n]).save(tmp_path / f"{n}.png")
    out = tmp_path / "scores.csv"
    assert bench.main(["-i", str(tmp_path), "--model-file", path,
                       "--baseline", "--device", "cpu", "-o", str(out)]) == 0
    with open(out) as f:
        by_file = {r["file"]: r for r in csv.DictReader(f)}
    for row in rows:
        cli_row = by_file[row["file"] + ".png"]
        assert abs(float(cli_row["psnr"]) - row["psnr"]) < 1e-3
    jmodel, jparams, _ = jax_load_model(path)
    jrenderer = JaxRenderer(jmodel, jparams)
    for row, (_n, hr) in zip(rows, images):
        lr = _np_resize(hr, 128, 128)
        sr = np.asarray(jrenderer.render(lr))
        assert abs(row["psnr"] - psnr(sr, hr)) < 0.05
        up = _np_resize(lr, 256, 256, mode="catrom", antialias=False)
        assert abs(row["catrom_psnr"] - psnr(up, hr)) < 1e-3
    means = bench.mean_scores(rows)
    assert set(means) == {"psnr", "y_psnr", "catrom_psnr", "catrom_y_psnr",
                          "lanczos_psnr", "lanczos_y_psnr", "bilinear_psnr",
                          "bilinear_y_psnr"}


@pytest.fixture(scope="module")
def small_turbo_dir(tmp_path_factory):
    """A small turbo_2x written by the JAX package as scale2x.nztm and
    noise0_scale2x.nztm (seeded numpy weights, tail non-zero), plus a
    directory with only the noise0 file."""
    d = tmp_path_factory.mktemp("w2x_turbo")
    model = turbo.Turbo2x(dim=16, blocks=1)
    rng = np.random.default_rng(21)
    flat = {k: (rng.standard_normal(a.shape) * (0.05 if k.endswith("kernel")
                                               else 0.01)).astype(np.float32)
            for k, a in to_flax(model).items()}
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    jmodel = jturbo.Turbo2x(dim=16, blocks=1)
    for stem in ("scale2x", "noise0_scale2x"):
        jax_save_model(jmodel, params, str(d / f"{stem}.nztm"))
    only_noise = d / "only_noise"
    only_noise.mkdir()
    jax_save_model(jmodel, params, str(only_noise / "noise0_scale2x.nztm"))
    return d


def _rgba(h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((h, w, 3), dtype=np.float32)
    yy, xx = np.mgrid[:h, :w]
    a = np.clip(1.2 - np.hypot(yy - h / 2, xx - w / 3) / (h / 2), 0, 1)
    a = np.where(a < 0.3, 0.0, a).astype(np.float32)[..., None]
    return x, a


@pytest.mark.parametrize("method,sub,tta_on", [
    ("scale", "", True), ("noise_scale", "", False),
    ("noise_scale", "only_noise", True)])
def test_convert_rgba_tta_matches_jax(small_turbo_dir, method, sub, tta_on):
    """convert in fp32 on an RGBA image: the border pad, 8-way TTA, the
    alpha upscale by the scale slot's model (with a scale2x file) or
    bilinear (without one), against the JAX runtime."""
    d = str(small_turbo_dir / sub)
    x, a = _rgba(40, 52, seed=22)
    noise = 0 if method.startswith("noise") else None
    w2x = Waifu2x(d, policy=FP32_POLICY, device="cpu")
    rgb, out_a = w2x.convert(x, a, method=method, noise_level=noise,
                             tile_size=64, batch_size=4, tta=tta_on)
    jw2x = jruntime.Waifu2x(d, policy=J_FP32)
    jrgb, ja = jw2x.convert(x, a, method=method, noise_level=noise,
                            tile_size=64, batch_size=4, tta=tta_on)
    assert rgb.shape == (80, 104, 3) and out_a.shape == (80, 104, 1)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=1e-4)
    np.testing.assert_allclose(out_a.numpy(), np.asarray(ja), atol=1e-4)
    assert (("scale", None) in w2x._slots) == (sub == "")
    if tta_on:
        plain, _ = w2x.convert(x, a, method=method, noise_level=noise,
                               tile_size=64, batch_size=4)
        assert np.abs(plain.numpy() - rgb.numpy()).max() > 1e-3


def test_grayscale_runs_on_replicated_rgb(small_turbo_dir):
    """A 1-channel image into the 3-channel model: the JAX runtime feeds it
    to the model as it is and fails; the port runs its 3-channel
    replication and returns the mean of the output's channels."""
    g = np.random.default_rng(23).random((30, 34, 1), dtype=np.float32)
    with pytest.raises(Exception):
        jruntime.Waifu2x(str(small_turbo_dir), policy=J_FP32).convert(
            g, None, method="scale", tile_size=64)
    w2x = Waifu2x(str(small_turbo_dir), policy=FP32_POLICY, device="cpu")
    got, _ = w2x.convert(g, None, method="scale", tile_size=64)
    rgb, _ = w2x.convert(np.repeat(g, 3, -1), None, method="scale", tile_size=64)
    assert got.shape == (60, 68, 1)
    torch.testing.assert_close(got, rgb.mean(-1, keepdim=True))
    assert float(rgb.std(-1).max()) > 1e-3  # the channels differ


def test_runtime_load_all_warmup_has_file(small_turbo_dir):
    w2x = Waifu2x(str(small_turbo_dir), device="cpu")
    assert w2x.has_model_file("scale", None)
    assert w2x.has_model_file("noise_scale", 0)
    assert not w2x.has_model_file("noise_scale", 1)
    w2x.load_model_all()
    assert sorted(w2x._slots) == [("noise_scale", 0), ("scale", None)]
    w2x.warmup(tile_size=64)


def decode_png(data: bytes):
    """(header dict, samples (H, W, C)) of a PNG written with filter 0 on
    every row, by zlib and struct alone."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body)
        chunks.append((tag, body))
        pos += 12 + n
    w, h, depth, ctype, _c, _f, interlace = struct.unpack(">IIBBBBB",
                                                          chunks[0][1])
    assert chunks[0][0] == b"IHDR" and chunks[-1][0] == b"IEND"
    channels = {0: 1, 4: 2, 2: 3, 6: 4}[ctype]
    raw = zlib.decompress(b"".join(b for t, b in chunks if t == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(h, -1)
    assert (rows[:, 0] == 0).all() and interlace == 0
    dt = ">u2" if depth == 16 else "u1"
    samples = rows[:, 1:].copy().view(dt).reshape(h, w, channels)
    return dict(depth=depth, ctype=ctype, tags=[t for t, _ in chunks]), samples


@pytest.mark.parametrize("channels", [3, 4, 2])
def test_16bit_png_decodes_to_16bit_samples(tmp_path, channels):
    x = np.random.default_rng(24).random((13, 17, channels), dtype=np.float32)
    x[0, 0] = 0.0
    x[0, 1] = 1.0
    path = str(tmp_path / "x.png")
    pil_io.save_image(x, path, bit_depth=16)
    with open(path, "rb") as f:
        head, got = decode_png(f.read())
    assert head["depth"] == 16 and head["ctype"] == {2: 4, 3: 2, 4: 6}[channels]
    np.testing.assert_array_equal(got, np.floor(x * 65535 + 0.5).astype(np.uint16))
    assert got.max() == 65535 and len(np.unique(got)) > 255
    from PIL import Image
    with Image.open(path) as im:
        assert im.size == (17, 13)


def test_16bit_gray_png_and_icc(tmp_path):
    """One gray channel keeps PIL's I;16; a profile still describing the
    pixels goes into an iCCP chunk, none after a conversion to sRGB."""
    from PIL import Image
    x = np.random.default_rng(25).random((9, 11, 1), dtype=np.float32)
    path = str(tmp_path / "g.png")
    pil_io.save_image(x, path, bit_depth=16)
    with Image.open(path) as im:
        assert im.mode == "I;16"
        np.testing.assert_array_equal(
            np.asarray(im), np.floor(x[..., 0] * 65535 + 0.5).astype(np.uint16))
    rgb = x.repeat(3, -1)
    for srgb, tags in ((False, True), (True, False)):
        meta = pil_io.ImageMeta(icc_profile=b"not a real profile", srgb=srgb)
        pil_io.save_image(rgb, path, meta, bit_depth=16)
        with open(path, "rb") as f:
            head, _ = decode_png(f.read())
        assert (b"iCCP" in head["tags"]) == tags


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
def test_load_image_gray_matches_jax(tmp_path, mode):
    from PIL import Image
    rng = np.random.default_rng(26)
    shape = {"RGB": (15, 19, 3), "RGBA": (15, 19, 4), "L": (15, 19)}[mode]
    path = str(tmp_path / "in.png")
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(path)
    got, _meta = pil_io.load_image(path, color="gray")
    want, _jmeta = jpil_io.load_image(path, color="gray")
    assert got.shape == want.shape == (15, 19, 2 if mode == "RGBA" else 1)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_cli_defaults_run_bundled_noise0(tmp_path, caplog):
    """Only -i / -o (and the CPU): noise_scale -n 0 from the bundled zoo's
    noise0_scale2x.nztm writes a 2x image equal to convert's."""
    import logging
    from PIL import Image
    src, out = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    arr = np.random.default_rng(27).integers(0, 256, (20, 26, 3), dtype=np.uint8)
    Image.fromarray(arr).save(src)
    with caplog.at_level(logging.INFO, logger="nunif_tpu_torch.waifu2x"):
        assert cli.main(["-i", src, "-o", out, "--device", "cpu"]) == 0
    assert "bundled model dir" in caplog.text
    w2x = Waifu2x(default_model_dir(), device="cpu")
    want, _ = w2x.convert(arr.astype(np.float32) / 255.0, method="noise_scale",
                          noise_level=0)
    with Image.open(out) as im:
        assert im.size == (52, 40) and im.mode == "RGB"
        got = np.asarray(im)
    np.testing.assert_array_equal(got, pil_io.quantize(want.numpy(), 8))


def test_cli_image_flags(small_turbo_dir, tmp_path):
    """--tta, an RGBA input, --grain, --grayscale, --style and --depth 16
    run; --style picks <model-dir>/<style> when it exists."""
    from PIL import Image
    src = str(tmp_path / "in.png")
    x, a = _rgba(24, 30, seed=28)
    Image.fromarray(pil_io.quantize(np.concatenate([x, a], -1), 8)).save(src)
    common = ["-i", src, "--model-dir", str(small_turbo_dir), "--method",
              "scale", "--tile-size", "64", "--device", "cpu"]
    out16 = str(tmp_path / "o16.png")
    assert cli.main(common + ["-o", out16, "--tta", "--grain", "--depth",
                              "16", "--style", "art"]) == 0
    with open(out16, "rb") as f:
        head, samples = decode_png(f.read())
    assert head["depth"] == 16 and samples.shape == (48, 60, 4)
    outg = str(tmp_path / "og.png")
    assert cli.main(common + ["-o", outg, "--grayscale"]) == 0
    with Image.open(outg) as im:
        assert im.mode == "LA" and im.size == (60, 48)
    # grain changes the image, seeded by the image index
    plain, grain = str(tmp_path / "p.png"), str(tmp_path / "g.png")
    cli.main(common + ["-o", plain])
    cli.main(common + ["-o", grain, "--grain", "--grain-strength", "0.5"])
    with Image.open(plain) as p, Image.open(grain) as g:
        assert np.abs(np.asarray(p, int) - np.asarray(g, int)).max() > 5
    # --style: a style subdirectory replaces the model dir
    styled = tmp_path / "zoo"
    (styled / "photo").mkdir(parents=True)
    os.symlink(small_turbo_dir / "scale2x.nztm", styled / "photo" / "scale2x.nztm")
    args = cli.create_parser().parse_args(
        ["-i", src, "-o", plain, "--model-dir", str(styled), "--style", "photo",
         "--device", "cpu"])
    assert cli._build_runtime(args).model_dir == str(styled / "photo")
    args.style = "art"
    assert cli._build_runtime(args).model_dir == str(styled)


def test_frame_phases_are_profiler_ranges(small_turbo_dir):
    """A profiled turbo frame holds the renderer's ranges and the fp32
    base's (``chip_smoke.py`` splits the card's frame by them); outside a
    profile ``phase`` opens no range."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile
    from nunif_tpu_torch.core.profiling import phase
    model, _meta = load_model(str(small_turbo_dir / "scale2x.nztm"), device="cpu")
    program = TiledRenderer(model).frame_program(40, 60, tile_size=64,
                                                 batch_size=4)
    frame = np.random.default_rng(29).integers(0, 256, (40, 60, 3), np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = program(frame)
        with phase("inside") as ctx:
            assert ctx is not None
    keys = {e.key for e in prof.key_averages()}
    assert {"render.pad", "render.tiles", "render.model", "turbo.base",
            "render.blend", "render.quantize", "inside"} <= keys
    assert y.shape == (80, 120, 3)
    assert isinstance(phase("outside"), contextlib.nullcontext)
