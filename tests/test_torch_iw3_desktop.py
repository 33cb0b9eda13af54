"""iw3's desktop stream, capture socket, player and LUT tool in
nunif_tpu_torch against nunif_tpu on the CPU.

* Desktop frames: two 64x96 frames through the port's ``DesktopRenderer``
  (Any_V2_S at resolution 56 and row_flow_v3 on shaped seeded weights, the
  depth EMA carried from frame to frame) against the JAX ``run_pipeline``'s
  steps on the same weights, fp32 in both packages (their bf16 image
  casts resolved to fp32): the uint8 SBS frames within 1 of each other
  and >= 50 dB.  The streaming loop then runs from a synthetic source and
  from the capture socket (NULL depth, forward_fill), as JAX's tests run
  it: half-SBS JPEGs of the source's width, and five stage times a frame.
* Capture source: the raw TCP and JPEG-over-Unix round trips, a bad magic
  followed by a good grabber, with the JAX tests' checks, against both
  packages; four faults of the JAX module that the port does not copy.
* Player: the same replies (status, headers but Date, body) from both
  servers on one media root: the library with a zip gallery, both pages,
  a zip entry, a range request, a missing subtitle stream, traversal.
* haldclut2cube: the .cube text identical to JAX's, resampled and not.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import io
import json
import os
import socket
import struct
import threading
import time
import types
import urllib.error
import urllib.request
import zipfile
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp

import nunif_tpu.iw3.capture_source as jcap
import nunif_tpu.iw3.haldclut2cube as jlut
import nunif_tpu.iw3.player as jplayer
from nunif_tpu.iw3.composition import StereoFormat as JFormat
from nunif_tpu.iw3.composition import postprocess_image as j_postprocess
from nunif_tpu.iw3.models.row_flow_v3 import RowFlowV3 as JRowFlowV3
from nunif_tpu.iw3.pipeline import StereoConfig as JConfig
from nunif_tpu.iw3.pipeline import apply_divergence as j_apply_divergence

import nunif_tpu_torch.iw3.capture_source as tcap
import nunif_tpu_torch.iw3.haldclut2cube as tlut
import nunif_tpu_torch.iw3.player as tplayer
from nunif_tpu_torch.iw3 import desktop
from nunif_tpu_torch.iw3.composition import StereoFormat
from nunif_tpu_torch.iw3.depth.depth_anything import (
    DepthAnything, shaped_flax_params as depth_params)
from nunif_tpu_torch.iw3.models.row_flow_v3 import (
    RowFlowV3, shaped_flax_params as flow_params)
from nunif_tpu_torch.iw3.pipeline import StereoConfig
from nunif_tpu_torch.models import from_flax

import torch_iw3_helpers as h

CAPS = {"port": tcap, "jax": jcap}


def u8_frames():
    """Two 64x96 uint8 frames: smooth shapes, a moving disc and noise."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:64, 0:96] / 64.0
    base = np.stack([np.sin(3 * xx + yy), np.cos(2 * yy - xx), xx * yy], -1)
    disc = ((xx - 0.7) ** 2 + (yy - 0.5) ** 2 < 0.05)[..., None]
    return h.u8(np.stack([0.5 + 0.3 * np.roll(base, 9 * i, axis=1) - 0.3 * disc
                          + 0.1 * rng.standard_normal(base.shape) for i in range(2)]))


def test_desktop_frames_match_jax_steps(monkeypatch):
    """Both frames of the port's renderer (EMA decay 0.75, buffer 1) against
    the JAX pipeline's steps, fp32: within one uint8 step, >= 50 dB."""
    h.patch_fp32(monkeypatch)
    dflat = depth_params(DepthAnything("vits"), 0)
    fflat = flow_params(RowFlowV3(), 1)
    dm, jdm = h.depth_models(dflat)
    flow = RowFlowV3()
    from_flax(flow, fflat)
    flow.eval().requires_grad_(False)
    renderer = desktop.DesktopRenderer(
        dm, flow, StereoConfig(method="row_flow_v3", divergence=2.0,
                               convergence=0.5, format=StereoFormat(half_sbs=True)),
        "cpu")
    jdm.enable_ema(decay=0.75, buffer_size=1)
    jcfg = JConfig(method="row_flow_v3", divergence=2.0, convergence=0.5,
                   format=JFormat(half_sbs=True))
    jflow, jfp = JRowFlowV3(), h.jparams(fflat)
    for frame in u8_frames():
        got, times = renderer(frame)
        assert set(times) == {"depth", "warp_compose", "host_read"}
        x = jnp.asarray(frame[None].astype(np.float32) / 255.0)
        d = jnp.stack(jdm.minmax_normalize(jdm.infer(x, edge_dilation=2)))
        left, right = j_apply_divergence(d, x, jcfg, jflow, jfp)
        sbs = j_postprocess(left, right, jcfg.format)
        want = (np.clip(np.asarray(sbs[0], np.float32), 0, 1) * 255 + 0.5
                ).astype(np.uint8)
        assert got.shape == want.shape == (64, 96, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert h.psnr(got, want) >= 50.0
        assert np.abs(got.astype(int) - frame.astype(int)).mean() > 2  # it warps


def _stream_args(**kw):
    return types.SimpleNamespace(**dict(dict(
        input=None, depth_model="NULL", depth_checkpoint=None,
        stereo_checkpoint=None, method="forward_fill", divergence=2.0,
        convergence=0.5, resolution=98, full_sbs=False, stream_fps=1000.0,
        quality=85, device="cpu", max_frames=None), **kw))


def _run_until(state, source, args, frames=2):
    stop = threading.Event()
    t = threading.Thread(target=desktop.run_pipeline,
                         args=(state, source, args, stop), daemon=True)
    t.start()
    deadline = time.time() + 120
    while state._seq < frames and time.time() < deadline and t.is_alive():
        time.sleep(0.05)
    stop.set()
    t.join(30)
    assert state._seq >= frames


@pytest.mark.parametrize("source_kind", ["pattern", "capture"])
def test_stream_loop_produces_half_sbs_jpegs(source_kind):
    """The loop from the synthetic source and from frames pushed over the
    capture socket: half-SBS JPEGs keep the source's width; each frame has
    its five stage times; ``max_frames`` stops the loop at that count."""
    state = desktop.StreamingState()
    if source_kind == "pattern":
        source = desktop.FrameSource(None, width=128, height=72)
        _run_until(state, source, _stream_args(max_frames=3), frames=3)
        assert state._seq == 3
    else:
        source = tcap.SocketFrameSource(("127.0.0.1", 0), timeout=30.0)
        frames = np.random.default_rng(1).integers(0, 255, (8, 72, 128, 3),
                                                    dtype=np.uint8)
        threading.Thread(target=tcap.FileGrabber(source.bound_address).push,
                         args=(frames,), daemon=True).start()
        try:
            _run_until(state, source, _stream_args())
        finally:
            source.close()
    data, _ = state.wait_frame(-1)
    assert Image.open(io.BytesIO(data)).size == (128, 72)
    assert all(set(t) == set(desktop.STAGES) for t in state.frame_ms)


def _mjpeg_parts(url, n):
    """The first n JPEG parts of an MJPEG stream."""
    parts = []
    with urllib.request.urlopen(url, timeout=60) as r:
        assert r.headers["Content-Type"] == \
            f"multipart/x-mixed-replace; boundary={desktop.BOUNDARY}"
        while len(parts) < n:
            assert r.readline().strip() == f"--{desktop.BOUNDARY}".encode()
            headers = {}
            for line in iter(r.readline, b"\r\n"):
                k, v = line.decode().split(":", 1)
                headers[k.strip()] = v.strip()
            parts.append(r.read(int(headers["Content-Length"])))
            assert r.readline() == b"\r\n"
    return parts


def test_desktop_main_serves_mjpeg(monkeypatch):
    """``main`` with --max-frames: /stream sends JPEG parts, / the page."""
    monkeypatch.setattr(desktop, "ThreadingHTTPServer", _PortZeroServer)
    done = threading.Thread(target=desktop.main, args=([
        "--port", "0", "--max-frames", "40", "--stream-fps", "20",
        "--device", "cpu", "--resolution", "98"],), daemon=True)
    done.start()
    url = _PortZeroServer.url.get(timeout=60)
    parts = _mjpeg_parts(url + "/stream", 2)
    assert all(Image.open(io.BytesIO(p)).size == (960, 540) for p in parts)
    assert b"/stream" in urllib.request.urlopen(url + "/", timeout=30).read()
    done.join(120)
    assert not done.is_alive()


class _PortZeroServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that reports its URL once bound."""
    import queue
    url = queue.Queue()

    def __init__(self, addr, handler):
        super().__init__(addr, handler)
        _PortZeroServer.url.put(f"http://127.0.0.1:{self.server_address[1]}")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_capture_raw_tcp_round_trip(pkg):
    cap = CAPS[pkg]
    src = cap.SocketFrameSource(("127.0.0.1", 0), timeout=20.0)
    try:
        rng = np.random.default_rng(0)
        frames = [rng.integers(0, 255, (36, 64, 3), dtype=np.uint8) for _ in range(3)]
        t = threading.Thread(target=cap.FileGrabber(src.bound_address).push,
                             args=(frames,), daemon=True)
        t.start()
        f = src.next_frame()
        assert f.shape == (36, 64, 3) and f.dtype == np.uint8
        t.join(10)
        f2, seq = src.wait_new_frame(0)
        deadline = time.time() + 10
        while seq < 3 and time.time() < deadline:
            f2, seq = src.wait_new_frame(seq)
        assert seq == 3
        np.testing.assert_array_equal(src.next_frame(), frames[-1])
    finally:
        src.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_capture_jpeg_unix_round_trip(pkg, tmp_path):
    cap = CAPS[pkg]
    addr = str(tmp_path / "cap.sock")
    src = cap.SocketFrameSource(addr, timeout=20.0)
    try:
        frame = np.full((24, 32, 3), 128, np.uint8)
        t = threading.Thread(target=cap.FileGrabber(addr, fmt=cap.FMT_JPEG).push,
                             args=([frame],), daemon=True)
        t.start()
        f = src.next_frame()
        t.join(10)
        assert f.shape == (24, 32, 3)
        assert np.abs(f.astype(int) - 128).max() <= 3
    finally:
        src.close()
    assert not os.path.exists(addr)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_capture_bad_magic_then_a_good_grabber(pkg):
    cap = CAPS[pkg]
    src = cap.SocketFrameSource(("127.0.0.1", 0), timeout=20.0)
    try:
        s = socket.create_connection(src.bound_address)
        s.sendall(b"NOTMAGIC" + b"\0" * 16)
        s.close()
        ok = []

        def push():
            deadline = time.time() + 10
            while time.time() < deadline:
                try:
                    cap.FileGrabber(src.bound_address).push([np.zeros((8, 8, 3), np.uint8)])
                    ok.append(True)
                    return
                except OSError:
                    time.sleep(0.1)

        t = threading.Thread(target=push, daemon=True)
        t.start()
        f = src.next_frame()
        t.join(10)
        assert ok and f.shape == (8, 8, 3)
    finally:
        src.close()


def test_capture_parse_address_matches_jax():
    for spec in ("unix:/tmp/x.sock", "listen:1304", "10.0.0.2:99", ":7"):
        assert tcap.parse_capture_address(spec) == jcap.parse_capture_address(spec)


def test_wait_new_frame_timeout_diverges_from_jax():
    """No newer frame within the timeout: JAX returns the stale frame and
    its old sequence number, the port raises TimeoutError."""
    out = {}
    for pkg, cap in CAPS.items():
        src = cap.SocketFrameSource(("127.0.0.1", 0), timeout=0.3)
        try:
            cap.FileGrabber(src.bound_address).push([np.zeros((4, 4, 3), np.uint8)])
            src.next_frame()
            try:
                out[pkg] = src.wait_new_frame(1)[1]
            except TimeoutError:
                out[pkg] = "timeout"
        finally:
            src.close()
    assert out == {"jax": 1, "port": "timeout"}


def test_uncapped_jpeg_length_diverges_from_jax():
    """A JPEG stream whose length prefix names 64 MiB for an 8x8 frame: the
    JAX server reads on, waiting for the payload; the port drops the
    connection at once, and a good grabber then gets through."""
    closed = {}
    for pkg, cap in CAPS.items():
        src = cap.SocketFrameSource(("127.0.0.1", 0), timeout=20.0)
        try:
            s = socket.create_connection(src.bound_address)
            s.sendall(cap.MAGIC + struct.pack("<IIII", 8, 8, 3, cap.FMT_JPEG)
                      + struct.pack("<I", 1 << 26))
            s.settimeout(1.0)
            try:
                closed[pkg] = s.recv(1) == b""
            except socket.timeout:
                closed[pkg] = False
            s.close()
            if pkg == "port":
                t = threading.Thread(target=cap.FileGrabber(src.bound_address).push,
                                     args=([np.zeros((8, 8, 3), np.uint8)],), daemon=True)
                t.start()
                assert src.next_frame().shape == (8, 8, 3)
                t.join(10)
        finally:
            src.close()
    assert closed == {"jax": False, "port": True}
    assert tcap.max_jpeg_bytes(8, 8) < 1 << 26


def test_push_streams_a_live_source_diverges_from_jax():
    """A grabber fed by a generator that waits, after its first frame, for
    the source to have received it: the port sends that frame at once; the
    JAX grabber lists the whole generator before it sends anything, so
    the wait runs out."""
    seen_in_time = {}
    for pkg, cap in CAPS.items():
        src = cap.SocketFrameSource(("127.0.0.1", 0), timeout=5.0)
        seen = threading.Event()

        def live(seen=seen, pkg=pkg):
            yield np.zeros((4, 4, 3), np.uint8)
            seen_in_time[pkg] = seen.wait(timeout=2.0)
            yield np.ones((4, 4, 3), np.uint8)
        t = threading.Thread(target=cap.FileGrabber(src.bound_address).push,
                             args=(live(),), daemon=True)
        t.start()
        try:
            src.next_frame()
            seen.set()
            t.join(10)
        finally:
            src.close()
    assert seen_in_time == {"jax": False, "port": True}


class _ChunkConn:
    """A socket stand-in that hands out ``data`` a few bytes a call and
    records how it was asked."""

    def __init__(self, data, chunk=7):
        self.data, self.pos, self.chunk = data, 0, chunk
        self.recv_sizes, self.into_buffers = [], []

    def recv(self, n):
        self.recv_sizes.append(n)
        out = self.data[self.pos:self.pos + min(n, self.chunk)]
        self.pos += len(out)
        return out

    def recv_into(self, view, n):
        self.into_buffers.append(view.obj)
        k = min(n, self.chunk, len(self.data) - self.pos)
        view[:k] = self.data[self.pos:self.pos + k]
        self.pos += k
        return k


def test_recv_exact_one_buffer_diverges_from_jax():
    """Reading n bytes in small chunks: JAX's ``_recv_exact`` concatenates
    a new bytes object per chunk (quadratic in n); the port receives every
    chunk into one preallocated buffer of n bytes and returns it."""
    data = bytes(range(256)) * 40
    jconn, tconn = _ChunkConn(data), _ChunkConn(data)
    assert jcap._recv_exact(jconn, len(data)) == data
    assert len(jconn.recv_sizes) == -(-len(data) // 7)  # one concat a chunk
    got = tcap._recv_exact(tconn, len(data))
    assert got == data and not tconn.recv_sizes
    assert all(b is got for b in tconn.into_buffers)
    with pytest.raises(ConnectionError):
        tcap._recv_exact(_ChunkConn(b"abc"), 4)


@pytest.fixture(scope="module")
def media_root(tmp_path_factory):
    from nunif_tpu_torch.video.engine import VideoOutputConfig, generate_video
    root = tmp_path_factory.mktemp("media")
    generate_video(str(root / "clip_LRH.mp4"),
                   (np.full((48, 64, 3), 16 * i, np.uint8) for i in range(4)),
                   64, 48, fps=8, config=VideoOutputConfig(audio_copy=False))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="PNG")
    (root / "img_sbs.png").write_bytes(buf.getvalue())
    (root / "sub").mkdir()
    (root / "sub" / "b_TB.jpg").write_bytes(buf.getvalue())
    with zipfile.ZipFile(root / "gallery.zip", "w") as zf:
        zf.writestr("a.png", buf.getvalue())
        zf.writestr("sub/b.png", buf.getvalue())
        zf.writestr("notes.txt", b"ignored")
    return str(root)


def _serve(make_handler, root):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(root))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _fetch(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, hdrs, body = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, body = e.code, e.headers, e.read()
    return status, {k: v for k, v in hdrs.items() if k not in ("Date", "Server")}, body


def test_player_replies_match_jax(media_root):
    assert tplayer.list_media(media_root) == jplayer.list_media(media_root)
    for name in ("clip_LRH.mp4", "a_rgbd.png", "x.TB.mkv", "full_sbs.png", "z.png"):
        assert tplayer.detect_stereo_format(name) == jplayer.detect_stereo_format(name)
    servers = [_serve(tplayer.make_handler, media_root),
               _serve(jplayer.make_handler, media_root)]
    try:
        requests = [("/", None), ("/flat", None), ("/api/library", None),
                    ("/media/gallery.zip/sub/b.png", None),
                    ("/media/gallery.zip/missing.png", None),
                    ("/media/img_sbs.png", None), ("/media/sub/b_TB.jpg", None),
                    ("/media/clip_LRH.mp4", {"Range": "bytes=10-99"}),
                    ("/media/clip_LRH.mp4", {"Range": "bytes=100-"}),
                    ("/media/clip_LRH.mp4", None),
                    ("/subtitles/clip_LRH.mp4", None),
                    ("/media/../../etc/passwd", None),
                    ("/media/%2e%2e/%2e%2e/etc/hostname", None), ("/nothing", None)]
        for path, headers in requests:
            port, jax_ = (_fetch(url + path, headers) for _srv, url in servers)
            assert port == jax_, path
        status, hdrs, body = _fetch(servers[0][1] + "/media/clip_LRH.mp4",
                                    {"Range": "bytes=10-99"})
        assert status == 206 and len(body) == 90
        assert hdrs["Content-Range"].startswith("bytes 10-99/")
        assert json.loads(_fetch(servers[0][1] + "/api/library")[2]) == \
            tplayer.list_media(media_root)
    finally:
        for srv, _url in servers:
            srv.shutdown()


def _hald(path, level=4, seed=0):
    """A level-``level`` HaldCLUT (level^3 px square) bent by a seeded curve."""
    n = level * level
    b, g, r = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    lut = np.stack([r, g, b], -1).reshape(-1, 3) / (n - 1)
    lut = lut ** np.random.default_rng(seed).uniform(0.7, 1.4, 3)
    side = level ** 3
    Image.fromarray((lut.reshape(side, side, 3) * 255 + 0.5).astype(np.uint8)).save(path)


@pytest.mark.parametrize("size", [33, 0, 16])
def test_haldclut2cube_text_matches_jax(tmp_path, size):
    src = str(tmp_path / "film.png")
    _hald(src)
    outs = [mod.convert(src, str(tmp_path / name), size=size)
            for mod, name in ((tlut, "port"), (jlut, "jax"))]
    texts = [open(p, encoding="utf-8").read() for p in outs]
    assert texts[0] == texts[1]
    assert f"LUT_3D_SIZE {size or 16}\n" in texts[0]
    strip = str(tmp_path / "strip.png")
    Image.open(src).resize((100, 1)).save(strip)  # 100 px: not a cube
    for mod in (tlut, jlut):
        with pytest.raises(ValueError, match="perfect cube"):
            mod.parse_hald(strip)


def test_haldclut2cube_cli(tmp_path, capsys):
    src = str(tmp_path / "film.png")
    _hald(src, seed=1)
    tlut.main(["-i", src, "-o", str(tmp_path / "out"), "-s", "9"])
    assert "saved" in capsys.readouterr().out
    lines = open(tmp_path / "out" / "film.cube", encoding="utf-8").read().splitlines()
    assert lines[:3] == [tlut.CUBE_HEADER.strip(), 'TITLE "film"', "LUT_3D_SIZE 9"]
    assert len(lines) == 4 + 9 ** 3
