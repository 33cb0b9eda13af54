"""iw3 desktop: a realtime 2D -> 3D MJPEG streaming server (counterpart of
``nunif_tpu/iw3/desktop.py``).

Frame source (a looped video file, a synthetic pattern, or frames pushed
over the ``IW3CAP01`` capture socket, ``capture_source.py``) -> depth with
an EMA of its min / max (decay 0.75, buffer 1) -> stereo warp at batch 1 ->
SBS composition -> JPEG -> a ``multipart/x-mixed-replace`` HTTP stream.
The frame goes to the card as uint8 and comes back as the uint8 SBS frame;
each frame's stage times (capture wait, depth, warp / compose, host read,
JPEG encode) are kept on the ``StreamingState``.  With ``--depth-model
Any_V2_S --method row_flow_v3`` a frame runs the DINOv2 flash attention
kernel 12 times and the horizontal warp kernel once.

Usage:
  python -m nunif_tpu_torch.iw3.desktop --input some.mp4 --port 1303
  python -m nunif_tpu_torch.iw3.desktop --capture listen:1304 --port 1303
The networks run on the card (``--device cpu`` on the CPU).
"""
from __future__ import annotations

import argparse
import collections
import io
import logging
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

logger = logging.getLogger("nunif_tpu_torch.iw3")

BOUNDARY = "iw3desktopframe"
STAGES = ("capture_wait", "depth", "warp_compose", "host_read", "jpeg_encode")

INDEX_HTML = """<!doctype html>
<html><head><title>iw3 desktop (nunif_tpu_torch)</title></head>
<body style="margin:0;background:#000">
<img src="/stream" style="width:100%"></body></html>"""


class FrameSource:
    """A looped video file, or a synthetic moving gradient."""

    def __init__(self, path=None, width=960, height=540):
        self.path = path
        self.width = width
        self.height = height
        self._reader = None
        self._t = 0

    def next_frame(self) -> np.ndarray:
        if self.path:
            from ..video.backend import VideoReader
            while True:
                if self._reader is None:
                    self._reader = VideoReader(self.path)
                try:
                    frame, _ = next(self._reader)
                    return frame
                except StopIteration:
                    self._reader.close()
                    self._reader = None
        self._t += 1
        yy, xx = np.mgrid[0:self.height, 0:self.width]
        r = ((xx + self._t * 4) % 256).astype(np.uint8)
        g = ((yy + self._t * 2) % 256).astype(np.uint8)
        b = np.full_like(r, 96)
        return np.stack([r, g, b], axis=-1)


# stage times of this many frames are kept for the statistics
KEEP_TIMES = 1000


class StreamingState:
    """The latest JPEG frame behind a condition variable, the FPS estimate
    and the last ``KEEP_TIMES`` frames' stage times (ms)."""

    def __init__(self):
        self._lock = threading.Condition()
        self._data = None
        self._seq = 0
        self.fps_estimate = 0.0
        self.frame_ms = collections.deque(maxlen=KEEP_TIMES)

    def set_frame_data(self, jpeg: bytes, times=None):
        with self._lock:
            self._data = jpeg
            self._seq += 1
            if times is not None:
                self.frame_ms.append(times)
            self._lock.notify_all()

    def wait_frame(self, last_seq, timeout=5.0):
        with self._lock:
            if self._seq == last_seq:
                self._lock.wait(timeout)
            return self._data, self._seq


def make_handler(state: StreamingState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug("desktop: " + fmt, *args)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path != "/stream":
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type",
                             f"multipart/x-mixed-replace; boundary={BOUNDARY}")
            self.end_headers()
            seq = -1
            try:
                while True:
                    data, seq = state.wait_frame(seq)
                    if data is None:
                        continue
                    self.wfile.write(
                        f"--{BOUNDARY}\r\nContent-Type: image/jpeg\r\n"
                        f"Content-Length: {len(data)}\r\n\r\n".encode())
                    self.wfile.write(data)
                    self.wfile.write(b"\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass

    return Handler


def _sync(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class DesktopRenderer:
    """One uint8 frame (H, W, 3) -> its uint8 SBS frame on the host, with
    the JAX pipeline's steps: depth at edge dilation 2, the EMA min-max
    normalisation, ``apply_divergence``, ``postprocess_image``, and
    ``clip(x, 0, 1) * 255 + 0.5`` truncated, in fp32."""

    def __init__(self, depth_model, side_model, cfg, device):
        self.depth_model = depth_model
        self.side_model = side_model
        self.cfg = cfg
        self.device = torch.device(device)
        depth_model.enable_ema(decay=0.75, buffer_size=1)  # flicker reduction

    @torch.no_grad()
    def sbs(self, frame: np.ndarray):
        """The SBS frame as a uint8 tensor on the device, or None while the
        depth normalisation holds the frame back; the stage times (ms) of
        depth and warp / compose."""
        from .composition import postprocess_image
        from .pipeline import apply_divergence
        t0 = time.perf_counter()
        x = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)
        x = x[None].float() / 255.0
        normalized = self.depth_model.minmax_normalize(
            self.depth_model.infer(x, edge_dilation=2))  # reads the host
        t1 = time.perf_counter()
        if not normalized:
            return None, {"depth": (t1 - t0) * 1e3}
        left, right = apply_divergence(
            torch.stack(normalized), x, self.cfg, self.side_model,
            metric_depth=self.depth_model.is_metric())
        sbs = postprocess_image(left, right, self.cfg.format)[0]
        out = (sbs.float().clamp(0, 1) * 255 + 0.5).to(torch.uint8)
        _sync(out)
        t2 = time.perf_counter()
        return out, {"depth": (t1 - t0) * 1e3, "warp_compose": (t2 - t1) * 1e3}

    def __call__(self, frame: np.ndarray):
        """(uint8 SBS frame (H, W', 3) numpy, stage times in ms), or None."""
        out, times = self.sbs(frame)
        if out is None:
            return None
        t0 = time.perf_counter()
        arr = out.cpu().numpy()
        times["host_read"] = (time.perf_counter() - t0) * 1e3
        return arr, times


def build_renderer(args, device) -> DesktopRenderer:
    """The renderer of the parsed flags: the depth model (its checkpoint or
    flax's seeded init) in bf16, the stereo model of ``--method``."""
    from .cli import create_stereo_model
    from .composition import StereoFormat
    from .depth import create_depth_model
    from .pipeline import StereoConfig
    depth_model = create_depth_model(args.depth_model, device=device,
                                     dtype=torch.bfloat16)
    depth_model.load(resolution=args.resolution, checkpoint=args.depth_checkpoint)
    side_model = create_stereo_model(args.method, args.stereo_checkpoint,
                                     device=device)
    cfg = StereoConfig(method=args.method, divergence=args.divergence,
                       convergence=args.convergence,
                       format=StereoFormat(half_sbs=not args.full_sbs))
    return DesktopRenderer(depth_model, side_model, cfg, device)


def encode_jpeg(arr: np.ndarray, quality: int) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def run_pipeline(state: StreamingState, source, args,
                 stop_event: threading.Event, renderer=None):
    """Capture -> render -> JPEG -> ``state``, paced to ``--stream-fps``,
    until ``stop_event`` is set or ``--max-frames`` frames are out."""
    from ..core.device import resolve_device
    if renderer is None:
        renderer = build_renderer(args, resolve_device(getattr(args, "device", "cuda")))
    max_frames = getattr(args, "max_frames", None)
    t_start = time.time()
    n = 0
    frame_interval = 1.0 / args.stream_fps
    while not stop_event.is_set() and (max_frames is None or n < max_frames):
        t_frame = time.perf_counter()
        frame = source.next_frame()
        wait_ms = (time.perf_counter() - t_frame) * 1e3
        rendered = renderer(frame)
        if rendered is None:
            continue
        arr, times = rendered
        t0 = time.perf_counter()
        data = encode_jpeg(arr, args.quality)
        times["jpeg_encode"] = (time.perf_counter() - t0) * 1e3
        times["capture_wait"] = wait_ms
        state.set_frame_data(data, {k: times[k] for k in STAGES})
        n += 1
        if n % 30 == 0:
            state.fps_estimate = n / (time.time() - t_start)
            print(f"Estimated FPS = {state.fps_estimate:.2f}", file=sys.stderr)
        dt = time.perf_counter() - t_frame
        if dt < frame_interval:
            time.sleep(frame_interval - dt)


def create_parser():
    p = argparse.ArgumentParser(prog="iw3.desktop", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--input", default=None,
                   help="video file looped as the frame source "
                        "(default: synthetic test pattern)")
    p.add_argument("--capture", default=None, metavar="ADDR",
                   help="accept frames from a host-side grabber over a "
                        "socket instead of --input: 'listen:PORT', "
                        "'HOST:PORT' or 'unix:/path' (protocol IW3CAP01, "
                        "see iw3/capture_source.py)")
    p.add_argument("--bind", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1303)
    p.add_argument("--depth-model", default="NULL")
    p.add_argument("--depth-checkpoint", default=None)
    p.add_argument("--stereo-checkpoint", default=None)
    p.add_argument("--method", default="forward_fill")
    p.add_argument("--divergence", type=float, default=2.0)
    p.add_argument("--convergence", type=float, default=0.5)
    p.add_argument("--resolution", type=int, default=None)
    p.add_argument("--full-sbs", action="store_true")
    p.add_argument("--stream-fps", type=float, default=15.0)
    p.add_argument("--quality", type=int, default=90)
    p.add_argument("--max-frames", type=int, default=None,
                   help="stop after N frames (testing)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the networks (default cuda; fails "
                        "without CUDA)")
    return p


def main(argv=None):
    args = create_parser().parse_args(argv)
    state = StreamingState()
    if args.capture:
        from .capture_source import SocketFrameSource, parse_capture_address
        source = SocketFrameSource(parse_capture_address(args.capture))
        print(f"iw3 desktop: capture socket listening on "
              f"{source.bound_address}", file=sys.stderr)
    else:
        source = FrameSource(args.input)
    stop = threading.Event()
    worker = threading.Thread(target=run_pipeline,
                              args=(state, source, args, stop), daemon=True)
    worker.start()
    server = ThreadingHTTPServer((args.bind, args.port), make_handler(state))
    print(f"iw3 desktop: http://{args.bind}:{server.server_address[1]}/",
          file=sys.stderr)
    try:
        if args.max_frames:
            # serve in the background so /stream stays reachable, until
            # the worker has put out N frames
            st = threading.Thread(target=server.serve_forever, daemon=True)
            st.start()
            worker.join()
            server.shutdown()
        else:
            server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        server.server_close()
        if args.capture:
            source.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
