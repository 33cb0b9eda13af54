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
VDA's window, the streaming VDA's caches).  Crop, device meshes and the
convergence estimator raise ``NotImplementedError``; decoding and encoding
video (``process_video_full``) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .composition import postprocess_image
from .depth_scaler import frame_stats
from .pipeline import StereoConfig, apply_divergence, preprocess_image, resize_depth_for


class Iw3FrameProcessor:
    """Batch callback: uint8 frames (B, H, W, 3) -> composed stereo frames
    (n, H', W', 3) float in [0, 1] on the depth model's device, or None."""

    def __init__(self, cfg: StereoConfig, depth_model, side_model=None,
                 tta=False, edge_dilation=0, scene_boundaries=None, crop=None,
                 mesh=None, convergence_estimator=None):
        unported = {"crop": crop, "mesh": mesh,
                    "convergence_estimator": convergence_estimator}
        for name, value in unported.items():
            if value is not None:
                raise NotImplementedError(
                    f"Iw3FrameProcessor({name}=...) is not ported to "
                    "nunif_tpu_torch yet (ROADMAP queue 1)")
        self.cfg = cfg
        self.depth_model = depth_model
        self.side_model = side_model
        self.tta = tta
        self.edge_dilation = edge_dilation
        self.scene_boundaries = (frozenset(int(b) for b in scene_boundaries)
                                 if scene_boundaries else frozenset())
        self.device = depth_model.device
        self._frame_idx = 0
        self._rgb_queue = []  # preprocessed frames waiting for their depth

    def _reset_flags(self, n: int):
        """flags[i]: frame i is the last of its shot (frame i + 1 is a
        scene boundary), so the state resets after it."""
        start = self._frame_idx
        self._frame_idx += n
        return [start + i + 1 in self.scene_boundaries for i in range(n)]

    def _stereo(self, depth, im):
        """Normalised depth (n, h, w, 1) and frames -> composed frames, or
        None while the side model queues them."""
        depth = resize_depth_for(depth, im, self.cfg)
        left, right = apply_divergence(depth, im, self.cfg, self.side_model,
                                       metric_depth=self.depth_model.is_metric())
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
            return self._stereo(d, x)
        self._rgb_queue.extend(x)
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
        return self._stereo(torch.stack(normalized), torch.stack(rgbs))

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
        self._rgb_queue = []
        side_flush = getattr(self.side_model, "flush", None)
        if side_flush is not None:
            left, right = side_flush(inner_dilation=self.cfg.mask_inner_dilation,
                                     outer_dilation=self.cfg.mask_outer_dilation)
            if left is not None:
                outs.append(postprocess_image(left, right, self.cfg.format))
        outs = [o for o in outs if o is not None]
        return torch.cat(outs) if outs else None
