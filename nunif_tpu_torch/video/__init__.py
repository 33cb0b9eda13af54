"""Video runtime: the native libav decode / encode service and the batched
device pipeline (counterpart of ``nunif_tpu/video``)."""
from .engine import (
    VideoOutputConfig, FixedFPSRetimer, process_video, generate_video,
    guess_fps, KNOWN_CODECS,
    error_flag_path, write_error_flag, has_error_flag, clear_error_flag,
)
from .backend import VideoReader, VideoWriter, available, encoder_available
