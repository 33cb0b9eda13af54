"""The whole iw3 frame path of nunif_tpu_torch for the MLBW methods
(``mlbw_l2`` / ``l4`` / ``l2s`` / ``l4s``) against the JAX package's
``Iw3FrameProcessor`` on the CPU: uint8 frames -> Any_V2_S -> MLBW ->
half-SBS, fp32, uint8 PSNR >= 50 dB (the check and its fixtures:
tests/test_torch_iw3_methods_frames.py).
"""
import pytest

from test_torch_iw3_methods_frames import (  # noqa: F401  (fixtures)
    check_frame_path, depth_weights, fp32, frames)


@pytest.mark.parametrize("method", ["mlbw_l2", "mlbw_l4", "mlbw_l2s", "mlbw_l4s"])
def test_frame_path_matches_jax(method, depth_weights, frames, fp32):
    """Iw3FrameProcessor and process_image on the same frames against the
    JAX Iw3FrameProcessor: uint8 PSNR >= 50 dB."""
    check_frame_path(method, depth_weights, frames)
