"""Video engine: decode -> batch -> callback on the device -> encode
(counterpart of ``nunif_tpu/video/engine.py``).

``process_video`` runs a batch callback over the (retimed) frames of a
file and encodes what it returns into ``<output>.tmp<ext>``, renamed to the
output once the file is complete.  Two host threads overlap the work:

- the calling thread decodes, batches, calls the callback (which enqueues
  its kernels and returns), and hands each result to the writer: a float
  result on the card is quantised there, with the JAX engine's rounding
  ``floor(clip(x, 0, 1) * maxv + 0.5)``, copied without blocking into
  pinned host memory, and a CUDA event recorded behind the copy;
- the writer thread waits on that event (not on the device or the default
  stream, which would hold it behind the next batch's kernels too) and
  encodes the frames.

The callback gets a uint8 (uint16 with ``rgb48``) numpy batch (B, H, W, 3),
or, for HDR input, the tone-mapped batch as a tensor on ``device``; it may
return a CUDA tensor, a CPU tensor, a numpy array, or None (or fewer frames
than it got) while it holds frames back; ``flush_callback()`` drains it at
the end of the stream.  ``process_video`` returns the run's stage times
(``stats``): decode, callback issue (and the first call's alone), device
wait, encode, and the wall time.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from fractions import Fraction
from typing import Callable, Optional

import numpy as np
import torch

from . import backend

logger = logging.getLogger("nunif_tpu_torch.video")

KNOWN_CODECS = ["libx264", "libx265", "libvpx-vp9", "mpeg4", "utvideo"]


def pix_fmt_requires_16bit(pix_fmt: str) -> bool:
    """Formats deeper than 8 bits get a 16-bit RGB staging surface, so the
    precision survives the RGB -> YUV conversion."""
    return pix_fmt in {
        "yuv420p10le", "p010le",
        "yuv422p10le", "yuv444p10le",
        "yuv420p12le", "yuv422p12le", "yuv444p12le",
        "yuv444p16le",
        "gbrp16le", "gbrp12le", "gbrp10le", "rgb48le",
    }


@dataclasses.dataclass
class VideoOutputConfig:
    """Encoder settings (software encoders)."""
    fps: Optional[Fraction] = None     # None: the source's, capped at max_fps
    codec: str = "libx264"
    pix_fmt: str = "yuv420p"
    preset: str = "ultrafast"
    crf: int = 20
    max_fps: float = 30.0
    rgb48: bool = False
    audio_copy: bool = True
    output_width: Optional[int] = None
    output_height: Optional[int] = None
    hdr_tonemap: bool = True           # BT.2020 PQ / HLG in -> SDR
    bitrate: Optional[str] = None       # e.g. "8M"
    tune: tuple = ()
    profile_level: Optional[str] = None
    keyframe_interval: Optional[float] = None  # seconds
    # auto | copy | bt709[-tv|-pc] | bt601[-tv|-pc]
    colorspace: str = "auto"
    # the source's AVCOL_SPC_*, filled in by process_video for "copy"
    source_colorspace: Optional[int] = None

    def __post_init__(self):
        if pix_fmt_requires_16bit(self.pix_fmt):
            self.rgb48 = True

    def _colorspace_opts(self) -> list:
        cs = (self.colorspace or "auto").lower()
        if cs in ("auto", "unspecified", ""):
            return []  # the native writer tags by output height
        if cs == "copy":
            if self.source_colorspace == 1:        # AVCOL_SPC_BT709
                cs = "bt709"
            elif self.source_colorspace in (5, 6):  # BT470BG / SMPTE170M
                cs = "bt601"
            else:
                return []
        parts = cs.split("-")
        opts = [f"colorspace={parts[0]}"]
        if len(parts) > 1:
            opts.append(f"range={'pc' if parts[1] == 'pc' else 'tv'}")
        return opts

    def encoder_opts(self, fps: Fraction) -> str:
        """``k=v,...`` for the native writer's option hook."""
        opts = self._colorspace_opts()
        if self.bitrate:
            b = str(self.bitrate).strip().upper()
            mult = 1
            if b.endswith("M"):
                mult, b = 1_000_000, b[:-1]
            elif b.endswith("K"):
                mult, b = 1_000, b[:-1]
            opts.append(f"b={int(float(b) * mult)}")
        if self.tune:
            opts.append(f"tune={self.tune[0]}")
        if self.profile_level:
            opts.append(f"level={self.profile_level}")
        if self.keyframe_interval:
            opts.append(f"gop={max(1, int(float(fps) * self.keyframe_interval))}")
        return ",".join(opts)


# a pts this fraction of a tick past a tick's time counts as on it:
# containers round pts (Matroska to 1 ms, up to 0.03 of a tick at 60 fps)
TICK_EPS = 0.05


class FixedFPSRetimer:
    """Duplicate / drop frames onto a fixed output tick grid: each tick
    takes the latest source frame with pts <= the tick's time (ffmpeg's
    ``fps=`` filter).  Non-monotonic or repeated pts move one tick forward.

    A pts up to ``TICK_EPS`` of a tick past a tick's time counts as on it.
    The JAX retimer compares exactly, so a 12 fps Matroska file (pts
    rounded to 1 ms) comes out with its second frame twice and a later
    one dropped; here every frame comes out once."""

    def __init__(self, out_fps: Fraction):
        self.out_fps = Fraction(out_fps)
        self.tick = 0
        self.last_frame = None
        self.last_pts = None

    def __call__(self, frame, pts):
        """The frames to emit for this input frame."""
        out = []
        if self.last_frame is None:
            self.last_frame = frame
            self.last_pts = pts if pts >= 0 else 0.0
            return out
        t = pts if pts >= 0 else self.last_pts + 1.0 / float(self.out_fps)
        if t <= self.last_pts:
            t = self.last_pts + 1.0 / float(self.out_fps)
        while self.tick + TICK_EPS < t * self.out_fps:
            out.append(self.last_frame)
            self.tick += 1
        self.last_frame = frame
        self.last_pts = t
        return out

    def flush(self):
        if self.last_frame is None:
            return []
        out = [self.last_frame]
        self.last_frame = None
        self.tick += 1
        return out


def guess_fps(reader, max_fps: float) -> Fraction:
    src = (Fraction(reader.fps).limit_denominator(1001) if reader.fps > 0
           else Fraction(30))
    if float(src) > max_fps:
        return Fraction(max_fps).limit_denominator(1001)
    return src


def error_flag_path(output_path: str) -> str:
    """The ``<out>.error.flag`` sidecar of a failed conversion."""
    return output_path + ".error.flag"


def write_error_flag(output_path: str, error: Exception):
    try:
        with open(error_flag_path(output_path), "w", encoding="utf-8") as f:
            f.write(f"{type(error).__name__}: {error}\n")
    except OSError:
        pass


def has_error_flag(output_path: str) -> bool:
    return os.path.exists(error_flag_path(output_path))


def clear_error_flag(output_path: str):
    try:
        os.unlink(error_flag_path(output_path))
    except OSError:
        pass


def _to_uint(arr: np.ndarray, dtype) -> np.ndarray:
    if np.issubdtype(arr.dtype, np.floating):
        maxv = 65535.0 if dtype == np.uint16 else 255.0
        return (np.clip(arr, 0.0, 1.0) * maxv + 0.5).astype(dtype)
    return arr.astype(dtype)


def quantize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float frames in [0, 1] -> ``dtype`` (uint8 or uint16) on x's device,
    rounded as the JAX engine rounds on the host: clip, scale, add 0.5,
    truncate (three separate passes, so no fused multiply-add changes a
    rounding)."""
    maxv = 65535.0 if dtype == torch.uint16 else 255.0
    return x.float().clamp(0.0, 1.0).mul(maxv).add(0.5).to(dtype)


_SENTINEL = object()


class _Results:
    """The hand-off between the calling thread and the writer thread: the
    caller puts results (quantised, and on their way to the host), the
    writer takes (host frames, CUDA event or None)."""

    def __init__(self, rgb48: bool):
        self.np_dtype = np.uint16 if rgb48 else np.uint8
        self.dtype = torch.uint16 if rgb48 else torch.uint8
        self.queue = queue.Queue(maxsize=8)

    def put(self, res):
        if res is None:
            return
        if not torch.is_tensor(res):
            arr = np.asarray(res)
            if arr.dtype != self.np_dtype:
                arr = _to_uint(arr, self.np_dtype)
            self.queue.put((arr, None))
            return
        if res.is_floating_point():
            res = quantize(res, self.dtype)
        elif res.dtype != self.dtype:
            res = res.to(self.dtype)
        if not res.is_cuda:
            self.queue.put((res.contiguous().numpy(), None))
            return
        host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
        host.copy_(res, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(res.device))
        self.queue.put((host, event))

    def close(self):
        self.queue.put(_SENTINEL)


def _reader(input_path, config: VideoOutputConfig, device, batch_callback):
    """(reader, callback): for HDR input the reader re-opened at 16 bits and
    the callback behind the SDR tone map on ``device``."""
    reader = backend.VideoReader(input_path, rgb48=config.rgb48)
    config.source_colorspace = reader.colorspace
    if not (config.hdr_tonemap and reader.is_hdr):
        return reader, batch_callback
    from ..core.device import resolve_device
    from . import hdr
    if not reader.rgb48:
        reader.close()
        reader = backend.VideoReader(input_path, rgb48=True)
    trc = reader.color_trc if reader.color_trc in (hdr.TRC_PQ, hdr.TRC_HLG) \
        else hdr.TRC_PQ
    peak = hdr.choose_peak_nits(reader)
    dev = resolve_device(device)
    logger.info("HDR input (trc=%d, peak=%.0f nits): tone mapping to SDR",
                trc, peak)

    def tone_mapped(batch):
        frames = torch.from_numpy(batch).to(dev, non_blocking=True)
        return batch_callback(hdr.hdr2sdr_frames(
            frames, trc=trc, peak_nits=peak, out_uint16=config.rgb48))
    return reader, tone_mapped


def process_video(input_path: str, output_path: str,
                  batch_callback: Callable,
                  batch_size: int = 4,
                  config: Optional[VideoOutputConfig] = None,
                  stop_event: Optional[threading.Event] = None,
                  suspend_event: Optional[threading.Event] = None,
                  progress_callback: Optional[Callable] = None,
                  flush_callback: Optional[Callable] = None,
                  start_time: Optional[float] = None,
                  end_time: Optional[float] = None,
                  device="cuda") -> dict:
    """Run ``batch_callback`` over every frame of ``input_path`` (retimed to
    ``config.fps``, else the source's capped at ``config.max_fps``) and
    encode its results into ``output_path``; returns the stage times.

    ``stop_event`` (set) ends the stream early; ``suspend_event`` pauses
    while cleared.  ``start_time`` / ``end_time`` (seconds): keyframe seek,
    then the frames outside [start, end] are dropped by pts.  ``device``
    runs the HDR tone map (no other use).  The writer opens at the first
    result's size (a callback may change the geometry); on error the
    temporary file is removed and the error raised.
    """
    config = config or VideoOutputConfig()
    reader, batch_callback = _reader(input_path, config, device, batch_callback)
    out_fps = config.fps or guess_fps(reader, config.max_fps)
    tmp_path = output_path + ".tmp" + os.path.splitext(output_path)[1]
    results = _Results(config.rgb48)
    # first_callback_s: the first call alone (one-time set-up of the
    # device's libraries and kernels falls there), also in callback_s
    stats = dict(frames_in=0, frames_out=0, decode_s=0.0, callback_s=0.0,
                 first_callback_s=None, device_wait_s=0.0, encode_s=0.0)
    writer = None
    write_error = []

    def writer_loop():
        nonlocal writer
        while True:
            item = results.queue.get()
            if item is _SENTINEL:
                return
            if write_error:
                continue  # drain, so that the calling thread never blocks
            try:
                arr, event = item
                if event is not None:
                    t0 = time.perf_counter()
                    event.synchronize()
                    stats["device_wait_s"] += time.perf_counter() - t0
                if torch.is_tensor(arr):
                    arr = arr.numpy()
                t0 = time.perf_counter()
                if writer is None:
                    h, w = arr.shape[1:3]
                    writer = backend.VideoWriter(
                        tmp_path, config.output_width or w,
                        config.output_height or h,
                        fps_num=out_fps.numerator, fps_den=out_fps.denominator,
                        codec=config.codec, pix_fmt=config.pix_fmt,
                        preset=config.preset, crf=config.crf,
                        rgb48=config.rgb48,
                        audio_source=input_path if config.audio_copy else None,
                        extra_opts=config.encoder_opts(out_fps))
                for frame in arr:
                    writer.write(frame)
                stats["encode_s"] += time.perf_counter() - t0
                stats["frames_out"] += len(arr)
            except Exception as e:  # raised in the calling thread
                write_error.append(e)

    wt = threading.Thread(target=writer_loop, daemon=True)
    retimer = FixedFPSRetimer(out_fps)
    batch = []

    def call(fn, *args):
        t0 = time.perf_counter()
        results.put(fn(*args))
        dt = time.perf_counter() - t0
        stats["callback_s"] += dt
        if stats["first_callback_s"] is None:
            stats["first_callback_s"] = dt

    def submit(frames):
        for f in frames:
            batch.append(f)
            if len(batch) >= batch_size:
                call(batch_callback, np.stack(batch))
                batch.clear()

    t_start = time.perf_counter()
    wt.start()
    try:
        if start_time:
            reader.seek(start_time)
        frames = iter(reader)
        while True:
            t0 = time.perf_counter()
            try:
                frame, pts = next(frames)
            except StopIteration:
                break
            finally:
                stats["decode_s"] += time.perf_counter() - t0
            if stop_event is not None and stop_event.is_set():
                break
            if suspend_event is not None:
                suspend_event.wait()
            if write_error:
                raise write_error[0]
            if start_time and 0 <= pts < start_time:
                continue  # the keyframe seek's overshoot
            if end_time is not None and pts > end_time >= 0:
                break
            # the retimer's ticks start at 0: rebase pts onto the trim
            submit(retimer(frame, pts - start_time if start_time and pts >= 0
                           else pts))
            stats["frames_in"] += 1
            if progress_callback:
                progress_callback(stats["frames_in"], reader.nb_frames)
        submit(retimer.flush())
        if batch:
            call(batch_callback, np.stack(batch))
        if flush_callback is not None:
            call(flush_callback)
        results.close()
        wt.join()
        if write_error:
            raise write_error[0]
        if writer is None:
            raise RuntimeError("no frames produced")
        writer.close()
        os.replace(tmp_path, output_path)
    except BaseException:
        if wt.is_alive():
            write_error.append(RuntimeError("aborted"))
            results.close()
            wt.join()
        try:
            if writer is not None:
                writer.close()
        except IOError:
            pass
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
        raise
    finally:
        reader.close()
    stats["wall_s"] = time.perf_counter() - t_start
    logger.info("process_video: %s -> %s (%d frames in, %d out, %.2f s)",
                input_path, output_path, stats["frames_in"],
                stats["frames_out"], stats["wall_s"])
    return stats


def generate_video(output_path: str, frame_generator,
                   width: int, height: int, fps=30,
                   config: Optional[VideoOutputConfig] = None) -> int:
    """Encode the frames of a generator (HWC uint8 / uint16, floats in [0,
    1], numpy or tensors); returns the frame count."""
    config = config or VideoOutputConfig()
    fps = Fraction(fps)
    writer = backend.VideoWriter(
        output_path, width, height, fps_num=fps.numerator,
        fps_den=fps.denominator, codec=config.codec, pix_fmt=config.pix_fmt,
        preset=config.preset, crf=config.crf, rgb48=config.rgb48,
        extra_opts=config.encoder_opts(fps))
    dtype = np.uint16 if config.rgb48 else np.uint8
    n = 0
    with writer:
        for frame in frame_generator:
            if torch.is_tensor(frame):
                if frame.is_floating_point():
                    frame = quantize(frame, torch.uint16 if config.rgb48
                                     else torch.uint8)
                frame = frame.cpu().numpy()
            frame = np.asarray(frame)
            if frame.dtype != dtype:
                frame = _to_uint(frame, dtype)
            writer.write(frame)
            n += 1
    return n
