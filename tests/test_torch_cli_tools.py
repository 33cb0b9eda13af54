"""The port's generic CLI tools and module entry points against the JAX
package's on the CPU (``nunif_tpu_torch/cli/`` against ``nunif_tpu/cli/``).

Each tool runs through both packages' ``main`` on the same ``.nztm``
files, written by the port.  Held: stdout text equal for
``count_parameters``, ``diff_image``, ``show_train_args`` and
``convert_model_alias``; ``merge_model``'s parameters bit-equal; ``i2i``'s
uint8 images at PSNR >= 50 dB (both render in bf16, summing in other
orders); ``segment_video``'s segments equal in number and frames.  Then the
flag tables of both CLIs (``cli_compat``), and ``python -m`` of the
entry points.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from nunif_tpu.cli import (convert_model_alias as jax_convert_model_alias,
                           count_parameters as jax_count_parameters,
                           diff_image as jax_diff_image, i2i as jax_i2i,
                           merge_model as jax_merge_model,
                           show_train_args as jax_show_train_args)

from nunif_tpu_torch.cli import (convert_model_alias, count_parameters,
                                 diff_image, i2i, list_device, merge_model,
                                 show_train_args)
from nunif_tpu_torch.models import (create_model, from_flax, read_checkpoint,
                                    save_model, to_flax)
from nunif_tpu_torch.waifu2x.models.swin_unet import tamed_flax_params

PSNR_MIN = 50.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    mse = (d * d).mean()
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def stdout_of(main, argv):
    """(return code, stdout) of a tool's ``main``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def seeded(name, path, seed=0, train_kwargs=None):
    """A registered model with seeded weights (kernels ~ 1/sqrt(fan-in),
    the rest small), written by the port to ``path``."""
    import nunif_tpu_torch.waifu2x  # noqa: F401  (registers the waifu2x archs)
    model = create_model(name)
    rng = np.random.default_rng(seed)
    flat = {}
    for key, a in to_flax(model).items():
        if key.endswith("kernel"):
            std = 1.0 / np.sqrt(np.prod(a.shape[:-1]))
            flat[key] = (rng.standard_normal(a.shape) * std).astype(np.float32)
        else:
            flat[key] = (rng.normal(0, 0.02, a.shape)
                         + 0.5 * key.startswith("ConvTranspose")).astype(np.float32)
    from_flax(model, flat)
    save_model(model, str(path), train_kwargs=train_kwargs)
    return str(path)


def write_png(path, h=40, w=48, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    img = np.stack([yy, xx, (yy + xx) / 2], -1) + rng.normal(0, 0.05, (h, w, 3))
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_tools")
    out = {"dir": d,
           "upconv": seeded("waifu2x.upconv_7", d / "upconv.nztm",
                            train_kwargs={"lr": 1e-4, "arch": "upconv_7"}),
           "upconv_b": seeded("waifu2x.upconv_7", d / "upconv_b.nztm", seed=1),
           "a": write_png(d / "a.png", seed=0),
           "b": write_png(d / "b.png", seed=1)}
    swin = create_model("waifu2x.swin_unet_2x")
    from_flax(swin, tamed_flax_params(swin, seed=0))
    save_model(swin, str(d / "swin.nztm"))
    out["swin"] = str(d / "swin.nztm")
    return out


@pytest.mark.parametrize("arch", ["waifu2x.upconv_7", "waifu2x.vgg_7",
                                  "waifu2x.turbo_2x", "sbs.row_flow_v3"])
def test_count_parameters_arch_matches_jax(arch):
    import nunif_tpu_torch.iw3  # noqa: F401  (registers the sbs archs)
    rc, got = stdout_of(count_parameters.main, ["--arch", arch, "--device", "cpu"])
    jrc, want = stdout_of(jax_count_parameters.main, ["--arch", arch])
    assert rc == jrc == 0
    assert got == want


@pytest.mark.parametrize("key", ["upconv", "swin"])
def test_count_parameters_model_file_matches_jax(files, key):
    rc, got = stdout_of(count_parameters.main,
                        ["-m", files[key], "--device", "cpu"])
    jrc, want = stdout_of(jax_count_parameters.main, ["-m", files[key]])
    assert rc == jrc == 0
    assert got == want and got.count("\n") > 10


def test_diff_image_matches_jax(files, tmp_path):
    args = [files["a"], files["b"]]
    rc, got = stdout_of(diff_image.main, args + ["--save", str(tmp_path / "p.png")])
    jrc, want = stdout_of(jax_diff_image.main, args + ["--save", str(tmp_path / "j.png")])
    assert rc == jrc == 0 and got == want and "PSNR" in got
    assert np.array_equal(np.asarray(Image.open(tmp_path / "p.png")),
                          np.asarray(Image.open(tmp_path / "j.png")))
    write_png(tmp_path / "small.png", h=8, w=8)
    assert diff_image.main([files["a"], str(tmp_path / "small.png")]) == \
        jax_diff_image.main([files["a"], str(tmp_path / "small.png")]) == 1


def test_show_train_args_matches_jax(files):
    rc, got = stdout_of(show_train_args.main, ["-m", files["upconv"]])
    jrc, want = stdout_of(jax_show_train_args.main, ["-m", files["upconv"]])
    assert rc == jrc == 0 and got == want
    assert json.loads(got)["train_kwargs"] == {"lr": 1e-4, "arch": "upconv_7"}


@pytest.mark.parametrize("weights", [None, ["0.7", "0.3"]])
def test_merge_model_bit_equal_to_jax(files, tmp_path, weights):
    argv = ["-i", files["upconv"], files["upconv_b"]]
    if weights:
        argv += ["--weights", *weights]
    assert merge_model.main(argv + ["-o", str(tmp_path / "p.nztm")]) == 0
    assert jax_merge_model.main(argv + ["-o", str(tmp_path / "j.nztm")]) == 0
    meta, got = read_checkpoint(str(tmp_path / "p.nztm"))
    jmeta, want = read_checkpoint(str(tmp_path / "j.nztm"))
    assert meta["name"] == jmeta["name"] == "waifu2x.upconv_7"
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        assert np.array_equal(got[k], want[k]), k


def test_convert_model_alias_matches_jax(files, tmp_path):
    rc, got = stdout_of(convert_model_alias.main,
                        ["-i", files["upconv"], "-o", str(tmp_path / "p.nztm"),
                         "--device", "cpu"])
    jrc, want = stdout_of(jax_convert_model_alias.main,
                          ["-i", files["upconv"], "-o", str(tmp_path / "j.nztm")])
    assert rc == jrc == 0 and got == want
    meta, flat = read_checkpoint(str(tmp_path / "p.nztm"))
    _meta, src = read_checkpoint(files["upconv"])
    assert meta["train_kwargs"] == {"lr": 1e-4, "arch": "upconv_7"}
    assert all(np.array_equal(flat[k], src[k]) for k in src)


@pytest.mark.parametrize("tta", [False, True])
def test_i2i_matches_jax(files, tmp_path, tta):
    argv = ["-m", files["upconv"], "-i", files["a"], "--tile-size", "32",
            "--batch-size", "4"] + (["--tta"] if tta else [])
    assert i2i.main(argv + ["-o", str(tmp_path / "p.png"), "--device", "cpu"]) == 0
    assert jax_i2i.main(argv + ["-o", str(tmp_path / "j.png")]) == 0
    got = np.asarray(Image.open(tmp_path / "p.png"))
    want = np.asarray(Image.open(tmp_path / "j.png"))
    assert got.shape == want.shape == (80, 96, 3)
    assert psnr(got, want) >= PSNR_MIN


def test_i2i_directory_swin_unet_matches_jax(files, tmp_path):
    """A directory of images through swin_unet_2x (K1 / K2's twins here)."""
    src = tmp_path / "src"
    src.mkdir()
    write_png(src / "x.png", h=32, w=36, seed=3)
    write_png(src / "y.jpg", h=30, w=34, seed=4)
    (src / "notes.txt").write_text("not an image")
    argv = ["-m", files["swin"], "-i", str(src), "--tile-size", "64"]
    assert i2i.main(argv + ["-o", str(tmp_path / "p"), "--device", "cpu"]) == 0
    assert jax_i2i.main(argv + ["-o", str(tmp_path / "j")]) == 0
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "j")) == ["x.png", "y.png"]
    for name in ("x.png", "y.png"):
        got = np.asarray(Image.open(tmp_path / "p" / name))
        want = np.asarray(Image.open(tmp_path / "j" / name))
        assert got.shape == want.shape and psnr(got, want) >= PSNR_MIN


def test_list_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert list_device.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"GPU{i}")
    assert list_device.main([]) == 0
    assert capsys.readouterr().out == "0: GPU0 (cuda)\n1: GPU1 (cuda)\n"


def test_tools_default_to_cuda(files, tmp_path):
    """Without --device the tools ask for the card, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        i2i.main(["-m", files["upconv"], "-i", files["a"],
                  "-o", str(tmp_path / "o.png")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        count_parameters.main(["--arch", "waifu2x.upconv_7"])


def test_segment_video_matches_jax(tmp_path):
    """Two shots of 12 and 14 frames: both tools cut at the same frame and
    write the same frame counts (histogram detector)."""
    from nunif_tpu_torch.video import VideoReader, available
    if not available():
        pytest.skip("the native video library is not available")
    from nunif_tpu.cli import segment_video as jax_segment_video
    from nunif_tpu_torch.cli import segment_video
    from nunif_tpu_torch.video import VideoOutputConfig, generate_video

    def frames():
        rng = np.random.default_rng(0)
        a = (rng.uniform(size=(48, 64, 3)) * 80).astype(np.uint8)
        b = (rng.uniform(size=(48, 64, 3)) * 80 + 170).astype(np.uint8)
        for i in range(26):
            yield np.roll(a if i < 12 else b, i % 3, axis=1)

    src = str(tmp_path / "clip.mp4")
    generate_video(src, frames(), 64, 48, fps=8,
                   config=VideoOutputConfig(audio_copy=False))
    argv = ["-i", src, "--min-frames", "4"]
    assert segment_video.main(argv + ["-o", str(tmp_path / "p"),
                                      "--device", "cpu"]) == 0
    assert jax_segment_video.main(argv + ["-o", str(tmp_path / "j")]) == 0

    def counts(d):
        out = []
        for f in sorted(os.listdir(d)):
            with VideoReader(os.path.join(d, f)) as r:
                out.append((f, sum(1 for _ in r)))
        return out
    got, want = counts(tmp_path / "p"), counts(tmp_path / "j")
    assert got == want and [n for _f, n in got] == [12, 14]


def _parser_flags(parser):
    return {s[2:] for a in parser._actions for s in a.option_strings
            if s.startswith("--")}


def _cli(app):
    if app == "waifu2x":
        from nunif_tpu.waifu2x.cli import create_parser as jax_parser
        from nunif_tpu_torch.waifu2x import cli_compat
        from nunif_tpu_torch.waifu2x.cli import create_parser
        return create_parser(), jax_parser(), cli_compat, \
            cli_compat.REFERENCE_WAIFU2X_FLAGS
    from nunif_tpu.iw3.cli import create_parser as jax_parser
    from nunif_tpu_torch.iw3 import cli_compat
    from nunif_tpu_torch.iw3.cli import create_parser
    return create_parser(), jax_parser(), cli_compat, \
        cli_compat.REFERENCE_IW3_FLAGS


@pytest.mark.parametrize("app", ["waifu2x", "iw3"])
def test_reference_flag_coverage(app):
    """Each reference flag is in the port's parser, renamed or not
    applicable, as tests/test_cli_coverage.py holds the JAX CLIs."""
    ours, _jax, compat, reference = _cli(app)
    flags = _parser_flags(ours)
    missing = [f for f in reference if f not in flags
               and f not in compat.NOT_APPLICABLE
               and compat.RENAMED.get(f) not in flags]
    assert not missing, f"unhandled reference flags: {missing}"
    assert all(reason for reason in compat.NOT_APPLICABLE.values())


@pytest.mark.parametrize("app", ["waifu2x", "iw3"])
def test_jax_flags_in_port(app):
    """Every flag of the JAX parser is in the port's, or has a reason; the
    port's own flags are listed."""
    ours, jax_parser, compat, _reference = _cli(app)
    flags, jax_flags = _parser_flags(ours), _parser_flags(jax_parser)
    assert sorted(jax_flags - flags) == sorted(compat.JAX_FLAGS_NOT_IN_PORT)
    assert sorted(flags - jax_flags) == sorted(compat.PORT_ONLY_FLAGS)


def test_waifu2x_cli_compat_copies_jax_tables():
    from nunif_tpu.waifu2x import cli_compat as jax_compat
    from nunif_tpu_torch.waifu2x import cli_compat
    assert cli_compat.REFERENCE_WAIFU2X_FLAGS == jax_compat.REFERENCE_WAIFU2X_FLAGS
    assert sorted(cli_compat.NOT_APPLICABLE) == sorted(jax_compat.NOT_APPLICABLE)
    assert cli_compat.RENAMED == jax_compat.RENAMED
    assert not any("JAX" in r or "jit" in r for r in cli_compat.NOT_APPLICABLE.values())


@pytest.mark.parametrize("module", [
    "nunif_tpu_torch.waifu2x", "nunif_tpu_torch.iw3", "nunif_tpu_torch.gui",
    "nunif_tpu_torch.cli.i2i", "nunif_tpu_torch.cli.export_model"])
def test_python_m_help(module):
    proc = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "usage:" in proc.stdout and "--device" in proc.stdout
    assert "jax" not in proc.stderr.lower()


def test_python_m_waifu2x_equals_cli_main(files, tmp_path):
    """``python -m nunif_tpu_torch.waifu2x`` writes what ``cli.main`` does."""
    from nunif_tpu_torch.waifu2x import cli
    d = tmp_path / "models"
    d.mkdir()
    os.link(files["upconv"], d / "scale2x.nztm")
    argv = ["-i", files["a"], "--method", "scale", "--model-dir", str(d),
            "--device", "cpu", "--tile-size", "32"]
    proc = subprocess.run([sys.executable, "-m", "nunif_tpu_torch.waifu2x",
                           *argv, "-o", str(tmp_path / "m.png")], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert cli.main(argv + ["-o", str(tmp_path / "c.png")]) == 0
    assert np.array_equal(np.asarray(Image.open(tmp_path / "m.png")),
                          np.asarray(Image.open(tmp_path / "c.png")))
