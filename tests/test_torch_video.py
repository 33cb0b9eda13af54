"""The video runtime of nunif_tpu_torch against the JAX package's, on the
CPU: the ctypes binding (frames and pts of a file written by either
package), the retimer on VFR pts lists, the encoder options, the engine
(trim and seek, suspend, the error flag, the temporary file on error, 10-bit
and rgb48, the callback's result kinds) and the HDR tone map, alone and as
the engine's branch for HDR input.

Files are written losslessly (utvideo, gbrp, in .mkv) where frames are
compared, so the engine adds nothing, at 8 fps, whose pts (multiples of
0.125 s) both retimers place exactly.  Tolerances: equal frames and pts;
the tone map within 1 LSB of JAX's (both are fp32 elementwise maths, whose
pow / exp may round their last bit differently).

One divergence is on purpose: the JAX retimer compares float pts with the
exact tick times, so pts that round a hair past a tick (a 12 fps Matroska
file's 1 ms pts, or i / 30 in floating point) duplicate one frame and drop
a later one; the port's counts a pts within ``TICK_EPS`` of a tick as on
it, and emits each frame once.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import os
import threading
import time
from fractions import Fraction

import numpy as np
import pytest
import torch

from nunif_tpu import video as jvideo
from nunif_tpu.video import backend as jbackend
from nunif_tpu.video import engine as jengine
from nunif_tpu.video import hdr as jhdr

from nunif_tpu_torch import video
from nunif_tpu_torch.video import backend, engine, hdr

LOSSLESS = dict(codec="utvideo", pix_fmt="gbrp")


@pytest.fixture(scope="module", autouse=True)
def _backend():
    if not backend.available():
        pytest.skip("the native video library does not load here")


def frames_of(n, h=48, w=64, seed=0, dtype=np.uint8):
    """n structured frames: colour ramps that move, noise, the index in
    the red channel's first row."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / h
    maxv = 65535 if dtype == np.uint16 else 255
    out = []
    for i in range(n):
        f = 0.5 + 0.3 * np.stack([np.sin(3 * xx + 0.3 * i), np.cos(2 * yy - xx),
                                  xx * yy / 2], -1)
        f = np.clip(f + 0.03 * rng.standard_normal(f.shape), 0, 1)
        out.append((f * maxv + 0.5).astype(dtype))
    return np.stack(out)


def write(pkg, path, frames, fps=8, **cfg):
    mod = jvideo if pkg == "jax" else video
    mod.generate_video(path, iter(frames), frames.shape[2], frames.shape[1],
                       fps=fps, config=mod.VideoOutputConfig(**{**LOSSLESS, **cfg}))
    return path


def read(mod, path, rgb48=False):
    with mod.VideoReader(path, rgb48=rgb48) as r:
        got = [(f.copy(), pts) for f, pts in r]
    return np.stack([f for f, _ in got]), [p for _, p in got]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_backend_reads_what_jax_reads(tmp_path, writer):
    """A file written by either package decodes to the same frames and pts
    through both bindings, and to the frames written (lossless); the color
    info agrees."""
    src = frames_of(9)
    p = write(writer, str(tmp_path / "a.mkv"), src)
    got, pts = read(backend, p)
    want, jpts = read(jbackend, p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, src)
    assert pts == jpts
    with backend.VideoReader(p) as r, jbackend.VideoReader(p) as jr:
        for k in ("width", "height", "fps", "nb_frames", "color_trc",
                  "colorspace", "color_range", "is_hdr"):
            assert getattr(r, k) == getattr(jr, k), k
    assert backend.encoder_available("utvideo") and not backend.encoder_available("nope")
    assert backend.version() == jbackend._load().vio_version().decode()
    with pytest.raises(IOError):
        backend.VideoReader(str(tmp_path / "missing.mkv"))


# (output fps, pts) on a grid of 1 / 64 s, which floats hold exactly
PTS_LISTS = {
    "backwards and repeated": (8, [0.0, 0.125, 0.25, 0.0625, 0.0625, 0.5, 0.625]),
    "negative pts": (8, [-1.0, 0.125, -1.0, 0.375, 0.3125, 1.0]),
    "downsample 32 -> 8": (8, [i / 32 for i in range(32)]),
    "upsample 8 -> 16": (16, [i / 8 for i in range(10)]),
    "VFR": (16, list(np.cumsum(np.random.default_rng(3).integers(1, 12, 40)) / 64)),
}


def retime(mod, fps, pts_list):
    r = mod.FixedFPSRetimer(Fraction(fps))
    out = []
    for i, pts in enumerate(pts_list):
        out.extend(r(i, pts))
    return out + r.flush()


@pytest.mark.parametrize("name", list(PTS_LISTS))
def test_retimer_matches_jax(name):
    fps, pts_list = PTS_LISTS[name]
    assert retime(engine, fps, pts_list) == retime(jengine, fps, pts_list)


def test_retimer_rounded_pts_diverges_from_jax():
    """pts a hair past a tick: 12 fps with pts rounded to 1 ms (Matroska),
    and i / 30 s retimed to 10 fps.  JAX's retimer repeats frame 1 and drops
    frame 2 (then every third frame); the port's emits frame i at tick i,
    and the latest frame at or before each tick."""
    ms12 = [round(i / 12 * 1000) / 1000 for i in range(12)]
    assert retime(engine, 12, ms12) == list(range(12))
    assert retime(jengine, 12, ms12)[:4] == [0, 1, 1, 3]
    thirds = [i / 30.0 for i in range(30)]
    assert retime(engine, 10, thirds) == list(range(0, 30, 3)) + [29]
    assert retime(jengine, 10, thirds)[:3] == [0, 2, 5]


# the flag combinations of tests/test_video.py, and each option alone
ENCODER_CASES = [
    dict(colorspace="bt601-tv"), dict(colorspace="bt709"),
    dict(colorspace="bt601-pc"), dict(pix_fmt="yuv420p10le"),
    dict(colorspace="copy", source_colorspace=1),
    dict(colorspace="copy", source_colorspace=5),
    dict(colorspace="copy", source_colorspace=2),
    dict(colorspace="auto"), dict(colorspace="unspecified"),
    dict(bitrate="8M"), dict(bitrate="750k"), dict(bitrate="1200"),
    dict(tune=("film", "animation")), dict(profile_level="4.1"),
    dict(keyframe_interval=2.5),
    dict(colorspace="bt709-pc", bitrate="2.5M", tune=("grain",),
         profile_level="5.1", keyframe_interval=0.1),
]


@pytest.mark.parametrize("case", range(len(ENCODER_CASES)))
def test_encoder_opts_match_jax(case):
    kw = ENCODER_CASES[case]
    ours, theirs = engine.VideoOutputConfig(**kw), jengine.VideoOutputConfig(**kw)
    assert ours.rgb48 == theirs.rgb48
    for fps in (Fraction(30), Fraction(30000, 1001)):
        assert ours.encoder_opts(fps) == theirs.encoder_opts(fps)
    assert engine.guess_fps(type("R", (), {"fps": 59.94})(), 30.0) == \
        jengine.guess_fps(type("R", (), {"fps": 59.94})(), 30.0)


def _process(mod, src, dst, callback, **kw):
    cfg = kw.pop("config", None) or mod.VideoOutputConfig(
        audio_copy=False, max_fps=128, **LOSSLESS)
    if mod is engine:
        kw.setdefault("device", "cpu")
    return mod.process_video(src, dst, callback, config=cfg, **kw)


def test_trim_and_seek_match_jax(tmp_path):
    """start / end time: both engines keep the same frames (a keyframe
    seek, then the pts trim), and so does an identity run."""
    src = write("port", str(tmp_path / "in.mkv"), frames_of(32), fps=8)
    with backend.VideoReader(src) as r:
        r.seek(2.0)
        _f, pts = next(iter(r))
        assert pts <= 2.0 + 1e-3
    for trim in (dict(), dict(start_time=1.0, end_time=3.0), dict(start_time=1.5)):
        outs = []
        for mod in (engine, jengine):
            dst = str(tmp_path / f"{mod.__name__}.mkv")
            _process(mod, src, dst, lambda b: b, batch_size=4, **trim)
            outs.append(read(backend, dst)[0])
        np.testing.assert_array_equal(outs[0], outs[1])
        if trim == dict(start_time=1.0, end_time=3.0):
            assert 14 <= len(outs[0]) <= 18


def test_result_kinds_and_flush(tmp_path):
    """The callback may return a CPU tensor (float or uint8), numpy (float
    or uint8) or None, with the rest from ``flush_callback``: the same
    file every time, equal to JAX's engine on numpy floats; the run's
    stage times come back."""
    src = write("port", str(tmp_path / "in.mkv"), frames_of(10))
    want = str(tmp_path / "jax.mkv")
    _process(jengine, src, want, lambda b: 1.0 - b.astype(np.float32) / 255.0,
             batch_size=4)
    want = read(backend, want)[0]
    kinds = {
        "tensor float": lambda b: 1.0 - torch.from_numpy(b).float() / 255.0,
        "tensor uint8": lambda b: engine.quantize(
            1.0 - torch.from_numpy(b).float() / 255.0, torch.uint8),
        "numpy float": lambda b: 1.0 - b.astype(np.float32) / 255.0,
    }
    for name, fn in kinds.items():
        dst = str(tmp_path / "o.mkv")
        stats = _process(engine, src, dst, fn, batch_size=4)
        np.testing.assert_array_equal(read(backend, dst)[0], want, err_msg=name)
        assert stats["frames_in"] == stats["frames_out"] == 10
        assert all(stats[k] >= 0 for k in ("decode_s", "callback_s", "first_callback_s",
                                           "device_wait_s", "encode_s", "wall_s"))
        assert stats["first_callback_s"] <= stats["callback_s"]
    queue = []

    def holding(b):
        queue.append(1.0 - b.astype(np.float32) / 255.0)
        return None

    dst = str(tmp_path / "flush.mkv")
    _process(engine, src, dst, holding, batch_size=4,
             flush_callback=lambda: np.concatenate(queue))
    np.testing.assert_array_equal(read(backend, dst)[0], want)


def test_error_cleans_tmp_and_flags(tmp_path):
    """A callback error, or a writer error (frames changing size), raises
    without a deadlock and leaves neither output nor temporary file; the
    error-flag helpers behave as JAX's."""
    src = write("port", str(tmp_path / "in.mkv"), frames_of(40))
    dst = str(tmp_path / "out.mkv")

    def bad(batch):
        raise RuntimeError("boom")

    sizes = iter(range(40))

    def changing(batch):  # the second batch is a pixel narrower
        return batch[:, :, :batch.shape[2] - (next(sizes) > 0)]

    for fn, err in ((bad, RuntimeError), (changing, ValueError)):
        with pytest.raises(err):
            _process(engine, src, dst, fn, batch_size=1)
        assert os.listdir(tmp_path) == ["in.mkv"]
    for mod in (engine, jengine):
        out = str(tmp_path / f"{mod.__name__}.mp4")
        assert not mod.has_error_flag(out)
        mod.write_error_flag(out, RuntimeError("boom"))
        assert mod.has_error_flag(out)
        with open(mod.error_flag_path(out)) as f:
            assert f.read() == "RuntimeError: boom\n"
        mod.clear_error_flag(out)
        assert not mod.has_error_flag(out)


def test_suspend_event(tmp_path):
    """The engine blocks while the suspend event is cleared."""
    src = write("port", str(tmp_path / "in.mkv"), frames_of(16))
    suspend = threading.Event()
    done = []

    def run():
        _process(engine, src, str(tmp_path / "o.mkv"), lambda b: b,
                 batch_size=4, suspend_event=suspend)
        done.append(True)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.5)
    assert not done
    suspend.set()
    t.join(timeout=30)
    assert not t.is_alive() and done


def test_10bit_and_rgb48_round_trip(tmp_path):
    """yuv420p10le promotes to a 16-bit staging surface in both packages;
    16-bit frames written by either package decode alike; an rgb48 gbrp16
    file through the port's engine with a float callback equals JAX's."""
    assert engine.VideoOutputConfig(pix_fmt="yuv420p10le").rgb48
    src = frames_of(6, dtype=np.uint16)
    for pkg in ("jax", "port"):
        p = write(pkg, str(tmp_path / f"{pkg}10.mp4"), src, codec="libx264",
                  pix_fmt="yuv420p10le", crf=16)
        got, pts = read(backend, p, rgb48=True)
        want, jpts = read(jbackend, p, rgb48=True)
        assert got.dtype == np.uint16 and pts == jpts
        np.testing.assert_array_equal(got, want)
        # 4:2:0 chroma on noisy frames: a mean error of a few percent
        assert np.abs(got.astype(int) - src).mean() < 2500
    p = write("port", str(tmp_path / "in16.mkv"), src, codec="ffv1",
              pix_fmt="gbrp16le")
    np.testing.assert_array_equal(read(backend, p, rgb48=True)[0], src)
    outs = []
    for mod in (engine, jengine):
        dst = str(tmp_path / f"{mod.__name__}16.mkv")
        cfg = mod.VideoOutputConfig(audio_copy=False, codec="ffv1",
                                    pix_fmt="gbrp16le", max_fps=128)
        _process(mod, p, dst, lambda b: b.astype(np.float32) / 65535.0 * 0.5,
                 batch_size=4, config=cfg)
        outs.append(read(backend, dst, rgb48=True)[0])
    np.testing.assert_array_equal(outs[0], outs[1])


HDR_CASES = [(trc, mode, cs) for trc in (hdr.TRC_PQ, hdr.TRC_HLG)
             for mode in ("hable", "bt2390") for cs in ("bt709", "bt601")
             if mode == "hable" or cs == "bt709"]


@pytest.mark.parametrize("trc,mode,cs", HDR_CASES)
@pytest.mark.parametrize("out16", [False, True])
def test_hdr2sdr_frames_match_jax(trc, mode, cs, out16):
    """uint16 and uint8 HDR frames through both tone maps: 8-bit output
    within 1 LSB of JAX's, at most 1% of the samples off by one; 16-bit
    output within the same 1 LSB of 8 bits (257), since XLA's CPU pow / exp
    and torch's differ in their last bits and the bt2390 soft clip
    amplifies that near black (up to 34 / 65535 seen)."""
    rng = np.random.default_rng(trc + out16)
    for x in (rng.integers(0, 65536, (2, 16, 24, 3), dtype=np.uint16),
              rng.integers(0, 256, (2, 16, 24, 3), dtype=np.uint8)):
        kw = dict(trc=trc, peak_nits=1000.0 if trc == hdr.TRC_PQ else 600.0,
                  out_uint16=out16, mode=mode, output_colorspace=cs)
        got = hdr.hdr2sdr_frames(torch.from_numpy(x), **kw).numpy()
        want = np.asarray(jhdr.hdr2sdr_frames(x, **kw))
        assert got.dtype == want.dtype
        d = np.abs(got.astype(np.int64) - want)
        if out16:
            assert d.max() <= 257, d.max()
        else:
            assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())


def test_hdr_anchors_and_peak():
    assert float(hdr.pq_eotf(torch.tensor(0.0))) < 1e-3
    assert abs(float(hdr.pq_eotf(torch.tensor(1.0))) - 10000.0) < 1.0
    assert abs(float(hdr.pq_eotf(torch.tensor(0.5806888810416109))) - 203.0) < 2.0
    for mmax, cll in ((4000.0, 0), (0.0, 800), (0.0, 0), (150.0, 100)):
        r = type("R", (), dict(master_max_luminance=mmax, max_cll=cll))()
        assert hdr.choose_peak_nits(r) == jhdr.choose_peak_nits(r)


def test_engine_hdr_branch_matches_jax(tmp_path, monkeypatch):
    """A file marked HDR (its reader's trc set to PQ in both packages: no
    PQ-tagged file can be written here) is re-read at 16 bits and tone
    mapped before the callback: the decoded outputs are within 1 LSB of
    JAX's, for an identity callback and for a float one."""
    src = write("port", str(tmp_path / "in.mkv"), frames_of(6))

    def pq_reader(cls):
        class PQ(cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.color_trc = 16
        return PQ

    monkeypatch.setattr(backend, "VideoReader", pq_reader(backend.VideoReader))
    monkeypatch.setattr(jbackend, "VideoReader", pq_reader(jbackend.VideoReader))
    seen = []
    callbacks = {
        "identity": (lambda b: (seen.append(b), b)[1], lambda b: b),
        "float": (lambda b: b.float() / 255.0 * 0.5,
                  lambda b: np.asarray(b).astype(np.float32) / 255.0 * 0.5),
    }
    for name, (ours, theirs) in callbacks.items():
        outs = []
        for mod, fn in ((engine, ours), (jengine, theirs)):
            dst = str(tmp_path / f"{mod.__name__}.mkv")
            _process(mod, src, dst, fn, batch_size=4)
            outs.append(read(backend, dst)[0].astype(int))
        assert np.abs(outs[0] - outs[1]).max() <= 1, name
    assert torch.is_tensor(seen[0]) and seen[0].dtype == torch.uint8
