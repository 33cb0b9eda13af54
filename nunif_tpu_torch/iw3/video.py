"""iw3 frame-batch processing (counterpart of ``Iw3FrameProcessor`` in
``nunif_tpu/iw3/video.py``).

A batch of uint8 frames goes in, composed stereo frames come out, but not
always as many: three queues can hold frames back.
- The depth model's: an EMA scaler with a lookahead buffer (``ema_buffer
  > 1``) or windowed Video Depth Anything (``infer_with_normalize``)
  returns fewer normalised depth frames than it was given.  The processor
  keeps the preprocessed frames in an RGB queue until their depth comes.
- The side model's: ``MLBWInpaintVideo`` inpaints whole clips of 12
  frames and returns ``(None, None)`` until one is ready, then possibly
  more frames than the batch.  The processor composes whatever it returns.
- ``flush`` drains the depth model, passes its frames through the side
  model, then drains the side model.  Every frame put in comes out once,
  in order; ``__call__`` and ``flush`` return None while nothing is ready.

Depth paths: stateless (EMA off: preprocess -> depth -> per-frame min-max
-> stereo with no host synchronisation); EMA with buffer 1
(``update_values``: the (B, 2) stats read back once a batch); and the
lagged path above, which also serves the stateful streaming VDA
(``stateful_inference``).  ``scene_boundaries`` (frame indexes where a
shot begins) resets the EMA after the frame before each cut, and, unlike
the JAX processor, the depth model's temporal state too (the windowed
VDA's window, the streaming VDA's caches).

Options: ``crop`` (slice_tb, slice_lr), e.g. ``utils.autocrop.
AutoCropDetector``'s, cuts the letterbox off before the frames leave the
host; ``debug_depth`` outputs the normalised depth, resized to the frame
and spread to three channels, in place of the stereo frame (no warp runs);
``convergence_estimator`` (a ``ConvergenceEstimator``) gives each frame its
convergence from the frame and its normalised depth, both resized to 192.
Unlike the JAX processor, which drops the estimator on the lagged path,
the estimator runs on whatever frames come out, with their own reset
flags.  Device meshes (``mesh``) raise ``NotImplementedError``.

``process_video_full`` runs a video file through the processor on the
engine (``video.engine.process_video``, the processor's ``flush`` as its
``flush_callback``), after the optional pre-passes: scene detection (with
its cache) and the letterbox analysis.
"""
from __future__ import annotations

import numpy as np
import torch

from ..modules.resize import resize
from .composition import postprocess_image
from .depth_scaler import frame_stats
from .pipeline import (SOD_INPUT_SIZE, StereoConfig, apply_divergence,
                       debug_depth_image, preprocess_image, resize_depth_for)


class Iw3FrameProcessor:
    """Batch callback: uint8 frames (B, H, W, 3) -> composed stereo frames
    (n, H', W', 3) float in [0, 1] on the depth model's device, or None."""

    def __init__(self, cfg: StereoConfig, depth_model, side_model=None,
                 tta=False, edge_dilation=0, scene_boundaries=None, crop=None,
                 mesh=None, debug_depth=False, convergence_estimator=None):
        if mesh is not None:
            raise NotImplementedError(
                "Iw3FrameProcessor(mesh=...): device meshes are not ported "
                "to nunif_tpu_torch yet (ROADMAP queue 1, multi-device)")
        self.cfg = cfg
        self.depth_model = depth_model
        self.side_model = side_model
        self.tta = tta
        self.edge_dilation = edge_dilation
        self.scene_boundaries = (frozenset(int(b) for b in scene_boundaries)
                                 if scene_boundaries else frozenset())
        self.crop = crop
        self.debug_depth = debug_depth
        self.convergence_estimator = convergence_estimator
        self.device = depth_model.device
        self._frame_idx = 0
        self._rgb_queue = []  # preprocessed frames waiting for their depth
        self._flag_queue = []  # and their reset flags

    def _reset_flags(self, n: int):
        """flags[i]: frame i is the last of its shot (frame i + 1 is a
        scene boundary), so the state resets after it."""
        start = self._frame_idx
        self._frame_idx += n
        return [start + i + 1 in self.scene_boundaries for i in range(n)]

    def _stereo(self, depth, im, flags):
        """Normalised depth (n, h, w, 1), frames and their reset flags ->
        composed frames (or the debug depth), or None while the side model
        queues them."""
        if self.debug_depth:
            return debug_depth_image(depth, im)
        convergence = None
        if self.convergence_estimator is not None:
            size = SOD_INPUT_SIZE
            convergence = self.convergence_estimator(
                resize(im, size, size, mode="bilinear", antialias=False),
                resize(depth, size, size, mode="bilinear", antialias=False),
                reset_pts=list(flags))
        depth = resize_depth_for(depth, im, self.cfg)
        left, right = apply_divergence(depth, im, self.cfg, self.side_model,
                                       metric_depth=self.depth_model.is_metric(),
                                       convergence=convergence)
        if left is None:
            return None
        return postprocess_image(left, right, self.cfg.format)

    def _infer(self, x, flags):
        """Depth of the batch; a stateful model's state resets after each
        flagged frame, so the batch runs in pieces split there."""
        dm = self.depth_model
        cuts = [i + 1 for i, f in enumerate(flags) if f]
        if not getattr(dm, "stateful_inference", False) or not cuts:
            return dm.infer(x, tta=self.tta, edge_dilation=self.edge_dilation)
        parts = []
        for a, b in zip([0] + cuts, cuts + [x.shape[0]]):
            if a < b:
                parts.append(dm.infer(x[a:b], tta=self.tta,
                                      edge_dilation=self.edge_dilation))
            if b in cuts:
                dm.reset_state()
        return torch.cat(parts)

    @torch.no_grad()
    def __call__(self, batch_u8):
        if self.crop is not None:  # on the host, before the upload
            batch_u8 = batch_u8[:, self.crop[0], self.crop[1]]
        if not torch.is_tensor(batch_u8):
            batch_u8 = torch.from_numpy(np.ascontiguousarray(batch_u8))
        start = self._frame_idx
        flags = self._reset_flags(batch_u8.shape[0])
        u8 = batch_u8.to(self.device)
        x = preprocess_image(u8.float() * (1.0 / 255.0), self.cfg)
        dm = self.depth_model
        scaler = dm.scaler
        if (not hasattr(dm, "infer_with_normalize")
                and not getattr(dm, "stateful_inference", False)
                and scaler.buffer_size == 1):
            depth = dm.infer(x, tta=self.tta, edge_dilation=self.edge_dilation)
            if scaler.decay == 0:
                # stateless per-frame min-max, no host synchronisation
                stats = frame_stats(depth)
                mins, maxs = stats[:, 0], stats[:, 1]
            else:
                consts = scaler.update_values(frame_stats(depth).cpu().numpy(),
                                              reset_flags=flags)
                c = torch.from_numpy(consts).to(self.device, torch.float32)
                mins, maxs = c[:, 0], c[:, 1]
            d = scaler.normalize(depth, mins.reshape(-1, 1, 1, 1),
                                 maxs.reshape(-1, 1, 1, 1))
            return self._stereo(d, x, flags)
        self._rgb_queue.extend(x)
        self._flag_queue.extend(flags)
        if hasattr(dm, "infer_with_normalize"):
            # windowed temporal models (VDA): output lags by the window
            normalized = dm.infer_with_normalize(
                x, pts=range(start, start + len(flags)),
                reset_pts={start + i for i, f in enumerate(flags) if f},
                edge_dilation=self.edge_dilation)
        else:
            normalized = dm.minmax_normalize(self._infer(x, flags),
                                             reset_ema=flags)
        return self._emit(normalized)

    def _emit(self, normalized):
        """Stereo for the first len(normalized) queued frames."""
        if not normalized:
            return None
        n = len(normalized)
        rgbs, self._rgb_queue = self._rgb_queue[:n], self._rgb_queue[n:]
        flags, self._flag_queue = self._flag_queue[:n], self._flag_queue[n:]
        return self._stereo(torch.stack(normalized), torch.stack(rgbs), flags)

    @torch.no_grad()
    def flush(self):
        """The frames still queued: the depth model's first (through the
        side model), then the side model's; None if there are none."""
        dm = self.depth_model
        if hasattr(dm, "flush_with_normalize"):
            normalized = dm.flush_with_normalize(edge_dilation=self.edge_dilation)
        else:
            normalized = dm.flush_minmax_normalize()
        outs = [self._emit(normalized)]
        self._rgb_queue, self._flag_queue = [], []
        side_flush = getattr(self.side_model, "flush", None)
        if side_flush is not None:
            left, right = side_flush(inner_dilation=self.cfg.mask_inner_dilation,
                                     outer_dilation=self.cfg.mask_outer_dilation)
            if left is not None:
                outs.append(postprocess_image(left, right, self.cfg.format))
        outs = [o for o in outs if o is not None]
        return torch.cat(outs) if outs else None


def process_video_full(input_path: str, output_path: str, cfg: StereoConfig,
                       depth_model, side_model=None, tta=False, edge_dilation=0,
                       batch_size=4, video_config=None, ema_normalize=False,
                       ema_decay=0.75, ema_buffer=30, scene_detect=False,
                       scene_detect_threshold=0.3, scene_min_frames=10,
                       scene_detect_checkpoint=None, scene_cache_dir=None,
                       scene_cache_disable=False, autocrop=False,
                       autocrop_mode="black", start_time=None, end_time=None,
                       stop_event=None, suspend_event=None, mesh=None,
                       debug_depth=False, convergence_mode="constant",
                       sod_model=None):
    """Convert a video file to stereo; returns the engine's stage times.

    ``ema_normalize`` turns the depth model's EMA min-max scaler on (its
    lookahead ``ema_buffer`` delays the output), else off.
    ``scene_detect``: the cuts (TransNetV2 from ``scene_detect_checkpoint``,
    else the histogram detector; cached unless ``scene_cache_disable``)
    reset the EMA and the depth model's temporal state.  ``autocrop``: the
    letterbox found on sampled frames is cut off every frame.
    ``convergence_mode="sod_v1"``: a per-frame convergence from
    ``sod_model`` (an ``iw3.sod_v1`` net; None: seeded), its EMA on."""
    from ..video import engine
    if ema_normalize:
        depth_model.enable_ema(decay=ema_decay, buffer_size=ema_buffer)
    else:
        depth_model.disable_ema()
    video_config = video_config or engine.VideoOutputConfig()
    device = depth_model.device
    scene_boundaries = None
    if scene_detect:
        if scene_cache_disable:
            from ..utils.shot_boundary import detect_boundaries
            scene_boundaries = detect_boundaries(
                input_path, threshold=scene_detect_threshold,
                min_frames=scene_min_frames, checkpoint=scene_detect_checkpoint,
                max_fps=video_config.max_fps, device=device)
        else:
            from .scene_boundary_cache import detect_boundaries_cached
            scene_boundaries = detect_boundaries_cached(
                input_path, max_fps=video_config.max_fps,
                threshold=scene_detect_threshold, min_frames=scene_min_frames,
                checkpoint=scene_detect_checkpoint, cache_dir=scene_cache_dir,
                device=device)
    crop = None
    if autocrop:
        from ..utils.autocrop import autocrop_analyze_video
        slice_tb, slice_lr = autocrop_analyze_video(input_path, mode=autocrop_mode)
        if slice_tb != slice(None) or slice_lr != slice(None):
            crop = (slice_tb, slice_lr)
    estimator = None
    if convergence_mode == "sod_v1":
        from .convergence_estimator import ConvergenceEstimator
        if sod_model is None:
            from ..models import create_model, init_flax_default
            from . import models  # noqa: F401  (registers the iw3 nets)
            with torch.device(device):
                sod_model = create_model("iw3.sod_v1")
            init_flax_default(sod_model, torch.Generator(device=device).manual_seed(0))
            sod_model.eval().requires_grad_(False)
        estimator = ConvergenceEstimator(cfg.convergence, sod_model, enable_ema=True)
    proc = Iw3FrameProcessor(cfg, depth_model, side_model, tta=tta,
                             edge_dilation=edge_dilation,
                             scene_boundaries=scene_boundaries, crop=crop,
                             mesh=mesh, debug_depth=debug_depth,
                             convergence_estimator=estimator)
    stats = engine.process_video(
        input_path, output_path, proc, batch_size=batch_size,
        config=video_config, flush_callback=proc.flush, start_time=start_time,
        end_time=end_time, stop_event=stop_event, suspend_event=suspend_event,
        device=device)
    depth_model.reset()
    return stats
