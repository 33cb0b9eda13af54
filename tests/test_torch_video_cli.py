"""The video paths of nunif_tpu_torch's CLIs against the JAX package's, on
the CPU: iw3 (``process_video_full``: row_flow_v3, the EMA lookahead, scene
detection with its cache read across the packages, the letterbox crop) and
waifu2x (the bundled ``scale2x``, with and without ``--rotate-left``), and
the iw3 CLI's file rules (``--metadata filename``, ``--resume``, ``--yes``,
``--skip-error``, ``--scene-detect-only``, a directory of images and
videos).

Clips are lossless (utvideo, gbrp, .mkv) at 8 fps, so neither engine adds
a rounding.  iw3 runs both CLIs in fp32 (the port's depth model built fp32,
both packages' bf16 casts resolved to fp32: ``torch_iw3_helpers.
patch_fp32``) on the same seeded ``.nztm`` nets (Any_V2_S at a 56-pixel
depth input, row_flow_v3); waifu2x at the CLIs' defaults; grain off (its
noise cannot equal ``jax.random``'s).  Decoded frames >= 50 dB.  One
divergence on purpose: ``--depth 16`` reads a 16-bit source at 16 bits
and the JAX CLI divides those samples by 255.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import os

import numpy as np
import pytest
import torch

from nunif_tpu.core import compile_cache as j_compile_cache
from nunif_tpu.iw3 import cli as jcli
from nunif_tpu.iw3 import scene_boundary_cache as jcache
from nunif_tpu.utils.autocrop import autocrop_analyze_video as j_autocrop
from nunif_tpu.waifu2x import cli as jw2x

from nunif_tpu_torch.iw3 import cli
from nunif_tpu_torch.iw3 import depth as tdepth
from nunif_tpu_torch.iw3.depth.depth_anything import DepthAnything
from nunif_tpu_torch.iw3.depth.depth_anything import shaped_flax_params as depth_params
from nunif_tpu_torch.iw3.models.row_flow_v3 import RowFlowV3
from nunif_tpu_torch.iw3.models.row_flow_v3 import shaped_flax_params as flow_params
from nunif_tpu_torch.models import from_flax, save_model
from nunif_tpu_torch.utils.autocrop import autocrop_analyze_video
from nunif_tpu_torch.video import VideoOutputConfig, backend, engine, generate_video
from nunif_tpu_torch.waifu2x import cli as w2x
from nunif_tpu_torch.waifu2x.runtime import default_model_dir

import torch_iw3_helpers as h

pytestmark = pytest.mark.usefixtures("two_threads")
two_threads = h.two_threads
LOSSLESS = ["--video-codec", "utvideo", "--pix-fmt", "gbrp"]


def write(path, frames, fps=8, **cfg):
    cfg = {"codec": "utvideo", "pix_fmt": "gbrp", "audio_copy": False, **cfg}
    generate_video(path, iter(frames), frames.shape[2], frames.shape[1], fps=fps,
                   config=VideoOutputConfig(**cfg))
    return path


def read(path, rgb48=False):
    with backend.VideoReader(path, rgb48=rgb48) as r:
        return np.stack([f for f, _ in r])


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The nets as .nztm files, a 12-frame clip with its indexes burnt in,
    and a 12-frame clip with a cut at 6 and 8-row black bars."""
    d = tmp_path_factory.mktemp("video_cli")
    for name, net, params in (("depth", DepthAnything("vits"), depth_params),
                              ("flow", RowFlowV3(), flow_params)):
        from_flax(net, params(net, 0 if name == "depth" else 1))
        save_model(net, str(d / f"{name}.nztm"))
    write(str(d / "clip.mkv"), h.indexed_frames(12, h=64, w=128))
    cut = h.indexed_frames(12, h=64, w=128)
    cut[6:] = cut[6:] // 3
    cut[:, :8] = cut[:, -8:] = 0
    write(str(d / "cut.mkv"), cut)
    return d


@pytest.fixture
def fp32(monkeypatch):
    h.patch_fp32(monkeypatch)
    create = tdepth.create_depth_model
    monkeypatch.setattr(tdepth, "create_depth_model",
                        lambda name, **kw: create(name, dtype=torch.float32, **kw))
    monkeypatch.setattr(j_compile_cache, "enable_persistent_cache",
                        lambda *a, **k: None)


def iw3_args(ckpt, src, out, extra=()):
    return (["-i", str(src), "-o", str(out), "--half-sbs", "--yes",
             "--resolution", str(h.RESOLUTION),
             "--depth-checkpoint", str(ckpt / "depth.nztm"),
             "--stereo-checkpoint", str(ckpt / "flow.nztm")] + LOSSLESS + list(extra))


IW3_CASES = {"row_flow_v3": ("clip", []),
             "ema_lookahead": ("clip", ["--ema-normalize", "--ema-buffer", "4"]),
             # the cut scores 0.255 (the burnt-in codes and the bars keep the
             # histograms alike), the other frames <= 0.04
             "scene_detect_autocrop": ("cut", ["--ema-normalize", "--ema-buffer", "1",
                                               "--scene-detect", "--autocrop",
                                               "--scene-detect-threshold", "0.2"])}


@pytest.mark.parametrize("case", list(IW3_CASES))
def test_iw3_cli_video_matches_jax(tmp_path, ckpt, fp32, case):
    """The same clip through both CLIs: as many frames, >= 50 dB.  With
    scene detection, JAX's run writes the boundary cache and the port's
    reads it (the histogram detector finds the cut at 6 in both); the
    letterbox crop is the same."""
    name, extra = IW3_CASES[case]
    src = ckpt / f"{name}.mkv"
    extra = extra + (["--scene-cache-dir", str(tmp_path)] if "--scene-detect" in extra
                     else [])
    assert jcli.main(iw3_args(ckpt, src, tmp_path / "j.mkv", extra)) == 0
    if "--scene-detect" in extra:
        assert jcache.load_cache(str(src), 30.0, str(tmp_path)) == [6]
        crop = autocrop_analyze_video(str(src))
        assert crop == j_autocrop(str(src)) and crop[0] == slice(8, 56)
    assert cli.main(iw3_args(ckpt, src, tmp_path / "t.mkv", extra + ["--device", "cpu"])) == 0
    got, want = read(str(tmp_path / "t.mkv")), read(str(tmp_path / "j.mkv"))
    assert got.shape == want.shape and len(got) == 12
    assert h.psnr(got, want) >= 50.0


def test_iw3_cli_file_rules(tmp_path, ckpt, caplog):
    """``--metadata filename`` names the output as the JAX CLI does;
    ``--resume`` skips it; without ``--yes`` an existing output stays;
    ``--skip-error`` flags a broken input in both packages, the next run
    skips it; ``--scene-detect-only`` writes no video; a directory of an
    image and a video converts both."""
    import logging
    caplog.set_level(logging.INFO, logger="nunif_tpu_torch.iw3")
    clip = str(ckpt / "clip.mkv")
    common = ["--half-sbs", "--resolution", str(h.RESOLUTION), "--device", "cpu",
              "--depth-checkpoint", str(ckpt / "depth.nztm"),
              "--stereo-checkpoint", str(ckpt / "flow.nztm")] + LOSSLESS
    out = tmp_path / "o.mkv"
    assert cli.main(["-i", clip, "-o", str(out), "--metadata", "-d", "1.5"] + common) == 0
    named = tmp_path / "o_row_flow_v3_d1.5_c0.5.mkv"
    assert os.listdir(tmp_path) == [named.name]
    mtime = os.path.getmtime(named)
    assert cli.main(["-i", clip, "-o", str(out), "--metadata", "-d", "1.5",
                     "--resume"] + common) == 0
    assert cli.main(["-i", clip, "-o", str(named)] + common) == 0
    assert os.path.getmtime(named) == mtime and "use --yes" in caplog.text
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    for main, extra in ((cli.main, common), (jcli.main, common[:3] + common[5:])):
        dst = str(tmp_path / f"bad_{main.__module__.split('.')[0]}.mkv")
        assert main(["-i", str(bad), "-o", dst, "--skip-error", "--half-sbs"] + extra) == 0
        assert engine.has_error_flag(dst) and not os.path.exists(dst)
        with open(engine.error_flag_path(dst)) as f:
            assert f.read().startswith("OSError: vio_reader_open")
    dst = str(tmp_path / "bad_nunif_tpu_torch.mkv")
    os.unlink(bad)
    assert cli.main(["-i", str(bad), "-o", dst, "--skip-error"] + common) == 0
    assert "skip (error flag)" in caplog.text
    caches = tmp_path / "scenes"
    caches.mkdir()
    assert cli.main(["-i", clip, "-o", str(tmp_path / "x.mkv"), "--scene-detect-only",
                     "--scene-cache-dir", str(caches)] + common) == 0
    assert not os.path.exists(tmp_path / "x.mkv") and len(os.listdir(caches)) == 1
    from PIL import Image
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    Image.fromarray(h.frames()[0]).save(mixed / "a.png")
    os.symlink(clip, mixed / "b.mkv")
    assert cli.main(["-i", str(mixed), "-o", str(tmp_path / "out"), "--video-format",
                     "mkv"] + common) == 0
    assert sorted(os.listdir(tmp_path / "out")) == ["a.png", "b.mkv"]
    assert read(str(tmp_path / "out" / "b.mkv")).shape == (12, 64, 128, 3)


@pytest.fixture
def jax_cache_off(monkeypatch):
    monkeypatch.setattr(j_compile_cache, "enable_persistent_cache",
                        lambda *a, **k: None)


@pytest.mark.parametrize("rotate", [[], ["--rotate-left"]])
def test_waifu2x_cli_video_matches_jax(tmp_path, ckpt, jax_cache_off, rotate):
    """The bundled ``scale2x`` (``--method scale``) over 6 frames, both
    CLIs at their defaults otherwise: the same geometry, >= 50 dB."""
    src = write(str(tmp_path / "in.mkv"), h.indexed_frames(6, h=40, w=56))
    common = ["-i", src, "--method", "scale", "--model-dir", default_model_dir(),
              "--yes"] + LOSSLESS + rotate
    assert jw2x.main(common + ["-o", str(tmp_path / "j.mkv")]) == 0
    assert w2x.main(common + ["-o", str(tmp_path / "t.mkv"), "--device", "cpu"]) == 0
    got, want = read(str(tmp_path / "t.mkv")), read(str(tmp_path / "j.mkv"))
    assert got.shape == want.shape == ((6, 112, 80, 3) if rotate else (6, 80, 112, 3))
    assert h.psnr(got, want) >= 50.0


def test_waifu2x_depth16_video_diverges_from_jax(tmp_path, jax_cache_off):
    """``--depth 16`` on a 16-bit source (8-bit frames times 257): both
    read it at 16 bits; the port scales by 65535, so its frames equal its
    8-bit run of the same frames to the 8-bit rounding (>= 45 dB at 8
    bits); the JAX CLI divides by 255 (ROADMAP queue 3), and its frames
    are another picture (< 20 dB)."""
    frames = h.indexed_frames(3, h=24, w=32)
    src = write(str(tmp_path / "in16.mkv"), frames.astype(np.uint16) * 257,
                codec="ffv1", pix_fmt="gbrp16le")
    common = ["--method", "scale", "--model-dir", default_model_dir(), "--device", "cpu"]
    assert w2x.main(["-i", write(str(tmp_path / "in8.mkv"), frames), "-o",
                     str(tmp_path / "t8.mkv")] + common + LOSSLESS) == 0
    deep = ["-i", src, "--depth", "16", "--video-codec", "ffv1", "--pix-fmt", "gbrp16le"]
    assert w2x.main(deep + common + ["-o", str(tmp_path / "t.mkv")]) == 0
    assert jw2x.main(deep + common[:-2] + ["-o", str(tmp_path / "j.mkv")]) == 0
    ref = read(str(tmp_path / "t8.mkv"))
    got, want = read(str(tmp_path / "t.mkv"), True), read(str(tmp_path / "j.mkv"), True)
    assert got.dtype == np.uint16 and got.shape == (3, 48, 64, 3)
    assert h.psnr((got / 257.0 + 0.5).astype(np.uint8), ref) >= 45.0
    assert h.psnr((want / 257.0 + 0.5).astype(np.uint8), ref) < 20.0
