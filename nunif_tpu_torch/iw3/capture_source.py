"""iw3 desktop capture source: frames pushed over a local socket
(counterpart of ``nunif_tpu/iw3/capture_source.py``).

A grabber process, running where the screen is, connects over TCP or a
Unix domain socket and pushes frames; the desktop pipeline takes the
newest one (drop-late: a slow consumer sees the latest frame, never a
backlog).

Wire protocol ``IW3CAP01`` (integers little-endian uint32):

    handshake (grabber -> server, once):
        8 bytes magic  b"IW3CAP01"
        u32 width, u32 height, u32 channels (must be 3), u32 format
            format 0 = raw RGB24 rows (width * height * 3 bytes a frame)
            format 1 = JPEG
    frames (repeated):
        u32 payload_length, payload bytes

The server replies nothing; closing the connection ends the stream and a
new grabber may connect.  ``FileGrabber`` pushes numpy frames or a video
file through the same socket (the test double, and the template for a
real screen grabber).

Four faults of the JAX module are not copied.  ``FileGrabber.push`` sends
each frame as its iterable yields it (the JAX one lists the whole
iterable first, so a live source, which never ends, never sends);
``wait_new_frame`` raises ``TimeoutError`` when no newer frame comes in
time (the JAX one returns the stale frame and its old sequence number);
the receive loop fills one
preallocated buffer (the JAX one grows a bytes object, quadratic in the
payload); and a length prefix is checked before the payload is read: a raw
frame must be exactly width x height x 3 bytes and a JPEG at most
``max_jpeg_bytes(width, height)``, with each side at most ``MAX_SIDE``
(the JAX one reads any length the socket names).
"""
from __future__ import annotations

import io
import itertools
import logging
import os
import socket
import struct
import threading

import numpy as np

logger = logging.getLogger("nunif_tpu_torch.iw3")

MAGIC = b"IW3CAP01"
FMT_RAW = 0
FMT_JPEG = 1
MAX_SIDE = 16384


def max_jpeg_bytes(width: int, height: int) -> int:
    """The largest JPEG payload taken for a frame: its raw size plus 1 MiB
    of headers and markers (a JPEG at quality 100 stays below that)."""
    return width * height * 3 + (1 << 20)


def _recv_exact(conn: socket.socket, n: int) -> bytearray:
    """Exactly n bytes, received into one buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = conn.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionError("capture stream closed")
        got += k
    return buf


class SocketFrameSource:
    """Frame source fed by an external grabber over a socket.

    ``address``: ``("127.0.0.1", port)`` for TCP (port 0 picks a free one;
    ``bound_address`` tells it) or a filesystem path for a Unix domain
    socket.  ``next_frame()`` blocks until the first frame arrives, then
    returns the newest frame received.
    """

    def __init__(self, address, timeout: float = 30.0):
        self.address = address
        self.timeout = timeout
        self._lock = threading.Condition()
        self._frame = None
        self._seq = 0
        self._closed = False
        if isinstance(address, str):
            try:
                os.unlink(address)
            except OSError:
                pass
            self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._server.bind(address)
        else:
            self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._server.bind(tuple(address))
        self._server.listen(1)
        self.bound_address = self._server.getsockname()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while not self._closed:
            try:
                conn, peer = self._server.accept()
            except OSError:
                return
            logger.info("capture grabber connected: %s", peer)
            try:
                self._stream_from(conn)
            except (ConnectionError, OSError) as e:
                logger.info("capture grabber disconnected: %s", e)
            finally:
                conn.close()

    def _stream_from(self, conn: socket.socket):
        magic = bytes(_recv_exact(conn, 8))
        if magic != MAGIC:
            raise ConnectionError(f"bad capture magic {magic!r}")
        w, h, c, fmt = struct.unpack("<IIII", _recv_exact(conn, 16))
        if c != 3 or fmt not in (FMT_RAW, FMT_JPEG) or not (
                0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE):
            raise ConnectionError(f"unsupported capture header {(w, h, c, fmt)}")
        raw_len = w * h * 3
        jpeg_cap = max_jpeg_bytes(w, h)
        while True:
            (n,) = struct.unpack("<I", _recv_exact(conn, 4))
            if fmt == FMT_RAW and n != raw_len:
                raise ConnectionError(f"raw frame length {n} != {raw_len}")
            if fmt == FMT_JPEG and not 0 < n <= jpeg_cap:
                raise ConnectionError(f"JPEG frame length {n} outside "
                                      f"1..{jpeg_cap} for {w}x{h}")
            payload = _recv_exact(conn, n)
            if fmt == FMT_RAW:
                frame = np.frombuffer(payload, np.uint8).reshape(h, w, 3)
            else:
                from PIL import Image
                frame = np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))
            with self._lock:
                self._frame = frame
                self._seq += 1
                self._lock.notify_all()

    def next_frame(self) -> np.ndarray:
        """The newest frame (blocks until the first one arrives)."""
        with self._lock:
            if self._frame is None and not self._lock.wait_for(
                    lambda: self._frame is not None or self._closed,
                    timeout=self.timeout):
                raise TimeoutError("no capture frames received")
            if self._frame is None:
                raise ConnectionError("capture source closed")
            return self._frame

    def wait_new_frame(self, last_seq: int):
        """(frame, seq) of a frame newer than ``last_seq``; raises
        ``TimeoutError`` if none comes within ``timeout`` and
        ``ConnectionError`` if the source closes first."""
        with self._lock:
            if not self._lock.wait_for(
                    lambda: self._seq > last_seq or self._closed,
                    timeout=self.timeout):
                raise TimeoutError(f"no capture frame after {last_seq} within "
                                   f"{self.timeout} s")
            if self._seq <= last_seq:
                raise ConnectionError("capture source closed")
            return self._frame, self._seq

    def close(self):
        self._closed = True
        with self._lock:
            self._lock.notify_all()
        try:
            self._server.close()
        finally:
            if isinstance(self.address, str):
                try:
                    os.unlink(self.address)
                except OSError:
                    pass


class FileGrabber:
    """Pushes numpy frames or a video file through the capture socket."""

    def __init__(self, address, fmt: int = FMT_RAW):
        self.address = address
        self.fmt = fmt

    def _connect(self) -> socket.socket:
        if isinstance(self.address, str):
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(self.address)
        else:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.connect(tuple(self.address))
        return s

    def push(self, frames) -> int:
        """Send an iterable of (H, W, 3) uint8 frames, each as it comes (a
        generator may be endless); returns the count sent."""
        it = iter(frames)
        try:
            first = next(it)
        except StopIteration:
            return 0
        h, w, c = first.shape
        conn = self._connect()
        try:
            conn.sendall(MAGIC + struct.pack("<IIII", w, h, c, self.fmt))
            n = 0
            for frame in itertools.chain([first], it):
                if frame.shape != (h, w, c) or frame.dtype != np.uint8:
                    raise ValueError(f"frame {n}: {frame.shape} {frame.dtype}, "
                                     f"expected {(h, w, c)} uint8")
                if self.fmt == FMT_RAW:
                    payload = np.ascontiguousarray(frame).tobytes()
                else:
                    from PIL import Image
                    buf = io.BytesIO()
                    Image.fromarray(frame).save(buf, format="JPEG", quality=95)
                    payload = buf.getvalue()
                conn.sendall(struct.pack("<I", len(payload)) + payload)
                n += 1
            return n
        finally:
            conn.close()

    def push_video(self, path: str, max_frames: int = None) -> int:
        from ..video.backend import VideoReader

        def frames():
            reader = VideoReader(path)
            try:
                for i, (frame, _pts) in enumerate(reader):
                    if max_frames is not None and i >= max_frames:
                        return
                    yield frame
            finally:
                reader.close()
        return self.push(frames())


def parse_capture_address(spec: str):
    """``"unix:/path"`` -> the path; ``"listen:PORT"`` / ``"HOST:PORT"`` ->
    (host, port)."""
    if spec.startswith("unix:"):
        return spec[len("unix:"):]
    if spec.startswith("listen:"):
        return ("127.0.0.1", int(spec[len("listen:"):]))
    host, _, port = spec.rpartition(":")
    return (host or "127.0.0.1", int(port))
