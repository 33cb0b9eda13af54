"""ctypes binding to the native video I/O service ``native/video_io.cpp``
(counterpart of ``nunif_tpu/video/backend.py``, the same signatures; its
own binding, since importing the JAX package's imports JAX).

The library links libavformat / libavcodec / libavutil / libswscale.  If
``native/libnunif_video.so`` is missing, the first use builds it with
``sh native/build.sh``; if that build fails, or the library does not load
(its libav libraries are not installed), every entry point raises
``VideoBackendUnavailable`` with the linker's message.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger("nunif_tpu_torch.video")

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libnunif_video.so")
_lib = None
_lib_lock = threading.Lock()

_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_double_p = ctypes.POINTER(ctypes.c_double)
_u8_p = ctypes.POINTER(ctypes.c_uint8)
# (name, argtypes, restype) of every entry point of the library
_SIGNATURES = (
    ("vio_reader_open", [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                         ctypes.c_int], ctypes.c_void_p),
    ("vio_reader_info", [ctypes.c_void_p, _c_int_p, _c_int_p, _c_double_p,
                         _c_double_p, ctypes.POINTER(ctypes.c_longlong),
                         _c_int_p], ctypes.c_int),
    ("vio_reader_next", [ctypes.c_void_p, _u8_p, _c_double_p], ctypes.c_int),
    ("vio_reader_color_info", [ctypes.c_void_p, _c_int_p, _c_int_p, _c_int_p,
                               _c_int_p, _c_double_p, _c_double_p, _c_int_p],
     ctypes.c_int),
    ("vio_reader_seek", [ctypes.c_void_p, ctypes.c_double], ctypes.c_int),
    ("vio_extract_subtitles", [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
    ("vio_reader_close", [ctypes.c_void_p], None),
    ("vio_writer_open", [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                         ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
                         ctypes.c_char_p, ctypes.c_int], ctypes.c_void_p),
    ("vio_writer_write", [ctypes.c_void_p, _u8_p], ctypes.c_int),
    ("vio_writer_close", [ctypes.c_void_p], ctypes.c_int),
    ("vio_encoder_available", [ctypes.c_char_p], ctypes.c_int),
    ("vio_version", [], ctypes.c_char_p),
)


class VideoBackendUnavailable(RuntimeError):
    pass


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(LIB_PATH):
            build = os.path.join(NATIVE_DIR, "build.sh")
            if not os.path.exists(build):
                raise VideoBackendUnavailable(f"{build} not found")
            logger.info("building the native video library...")
            proc = subprocess.run(["sh", build], capture_output=True, text=True)
            if proc.returncode != 0:
                raise VideoBackendUnavailable(
                    f"native build failed: {proc.stderr[-500:]}")
        try:
            lib = ctypes.CDLL(LIB_PATH)
        except OSError as e:  # the library's libav dependencies are missing
            raise VideoBackendUnavailable(str(e)) from e
        for name, argtypes, restype in _SIGNATURES:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return _lib


def available() -> bool:
    try:
        _load()
        return True
    except VideoBackendUnavailable:
        return False


def version() -> str:
    return _load().vio_version().decode()


def encoder_available(name: str) -> bool:
    return bool(_load().vio_encoder_available(name.encode()))


def extract_subtitles(path: str, out_vtt_path: str) -> int:
    """Extract the best text subtitle stream to a WebVTT file; returns the
    cue count (0: no subtitle stream)."""
    lib = _load()
    err = ctypes.create_string_buffer(512)
    n = lib.vio_extract_subtitles(path.encode(), out_vtt_path.encode(), err, 512)
    if n < 0:
        raise IOError(f"extract_subtitles({path}): {err.value.decode()}")
    return n


class VideoReader:
    """Iterate (frame HWC uint8, or uint16 with ``rgb48``, pts seconds).

    Color info: ``color_trc`` (AVColorTransferCharacteristic: 16 PQ, 18
    HLG), ``color_primaries`` (9 BT.2020), ``colorspace``, ``color_range``
    and the HDR metadata (``master_max_luminance`` / ``_min``, ``max_cll``;
    0 when absent).  The display-matrix rotation is applied on decode, as
    ffmpeg's autorotate does, unless ``apply_rotation=False``."""

    def __init__(self, path: str, rgb48: bool = False,
                 apply_rotation: bool = True):
        lib = _load()
        err = ctypes.create_string_buffer(512)
        self._h = lib.vio_reader_open(path.encode(), int(rgb48), err, 512)
        if not self._h:
            raise IOError(f"vio_reader_open({path}): {err.value.decode()}")
        self._lib = lib
        self.rgb48 = rgb48
        w, h, rot = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        fps, dur = ctypes.c_double(), ctypes.c_double()
        nf = ctypes.c_longlong()
        lib.vio_reader_info(self._h, w, h, fps, dur, nf, rot)
        self.width, self.height = w.value, h.value
        self.fps = fps.value
        self.duration = dur.value
        self.nb_frames = nf.value
        self.rotation = rot.value
        self._dtype = np.uint16 if rgb48 else np.uint8
        trc, pri, spc, rng, cll = (ctypes.c_int() for _ in range(5))
        mmax, mmin = ctypes.c_double(), ctypes.c_double()
        lib.vio_reader_color_info(self._h, trc, pri, spc, rng, mmax, mmin, cll)
        self.color_trc = trc.value
        self.color_primaries = pri.value
        self.colorspace = spc.value
        self.color_range = rng.value
        self.master_max_luminance = mmax.value
        self.master_min_luminance = mmin.value
        self.max_cll = cll.value
        self._src_w, self._src_h = self.width, self.height
        self._rot_k = 0
        if apply_rotation and self.rotation:
            self._rot_k = round(self.rotation / 90) % 4
            if self._rot_k in (1, 3):
                self.width, self.height = self.height, self.width

    @property
    def is_hdr(self) -> bool:
        """PQ / HLG transfer or BT.2020 primaries: the frames need the SDR
        tone map."""
        return self.color_trc in (16, 18) or self.color_primaries == 9

    def __iter__(self):
        return self

    def __next__(self):
        buf = np.empty((self._src_h, self._src_w, 3), self._dtype)
        pts = ctypes.c_double()
        ret = self._lib.vio_reader_next(
            self._h, buf.ctypes.data_as(_u8_p), pts)
        if ret == 0:
            raise StopIteration
        if ret < 0:
            raise IOError(f"decode error {ret}")
        if self._rot_k:
            buf = np.ascontiguousarray(np.rot90(buf, k=self._rot_k))
        return buf, pts.value

    def seek(self, seconds: float):
        """Keyframe-backward seek: iteration resumes at the nearest keyframe
        at or before ``seconds`` (callers drop the frames before it)."""
        ret = self._lib.vio_reader_seek(self._h, float(seconds))
        if ret < 0:
            raise IOError(f"seek error {ret}")

    def close(self):
        if self._h:
            self._lib.vio_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False


class VideoWriter:
    """Encode HWC uint8 frames (uint16 with ``rgb48``); ``audio_source``
    copies that file's audio stream; ``extra_opts`` is a ``k=v,...``
    string of encoder options (``VideoOutputConfig.encoder_opts``)."""

    def __init__(self, path: str, width: int, height: int,
                 fps_num: int, fps_den: int = 1, codec: str = "libx264",
                 pix_fmt: str = "yuv420p", preset: str = "medium",
                 crf: int = 20, rgb48: bool = False,
                 audio_source: str | None = None, extra_opts: str = ""):
        lib = _load()
        err = ctypes.create_string_buffer(512)
        self._h = lib.vio_writer_open(
            path.encode(), width, height, fps_num, fps_den, codec.encode(),
            pix_fmt.encode(), preset.encode(), crf, int(rgb48),
            (audio_source or "").encode(), (extra_opts or "").encode(), err, 512)
        if not self._h:
            raise IOError(f"vio_writer_open({path}): {err.value.decode()}")
        self._lib = lib
        self.width, self.height = width, height
        self._dtype = np.uint16 if rgb48 else np.uint8

    def write(self, frame: np.ndarray):
        if frame.shape != (self.height, self.width, 3) or frame.dtype != self._dtype:
            raise ValueError(f"frame {frame.shape} {frame.dtype} does not fit "
                             f"{(self.height, self.width, 3)} {np.dtype(self._dtype)}")
        frame = np.ascontiguousarray(frame)
        ret = self._lib.vio_writer_write(self._h, frame.ctypes.data_as(_u8_p))
        if ret < 0:
            raise IOError(f"encode error {ret}")

    def close(self):
        if self._h:
            ret = self._lib.vio_writer_close(self._h)
            self._h = None
            if ret < 0:
                raise IOError(f"mux close error {ret}")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        return False
