"""iw3 frame-batch processing (counterpart of ``Iw3FrameProcessor`` in
``nunif_tpu/iw3/video.py``).

Two paths are ported, both with a depth scaler of buffer size 1:
- stateless (EMA off): preprocess -> depth -> per-frame min-max ->
  stereo -> composition with no host synchronisation;
- EMA (``update_values``): the (B, 2) per-frame stats are read back once a
  batch, the host advances the EMA, and the constants normalise the batch.
Every method of ``pipeline.apply_divergence`` runs, its side model passed
through (a row_flow / MLBW net, ``ForwardInpaint``, ``MLBWInpaint``); the
forward and inpaint methods get depth at the preprocess resolution, as in
JAX.  The lookahead buffer, Video Depth Anything, the convergence
estimator, device meshes, crop and scene cuts raise
``NotImplementedError``; decoding and encoding video
(``process_video_full``) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .composition import postprocess_image
from .depth_scaler import frame_stats
from .pipeline import StereoConfig, apply_divergence, preprocess_image, resize_depth_for


class Iw3FrameProcessor:
    """Batch callback: uint8 frames (B, H, W, 3) -> composed stereo frames
    (B, H', W', 3) float in [0, 1] on the depth model's device."""

    def __init__(self, cfg: StereoConfig, depth_model, side_model=None,
                 tta=False, edge_dilation=0, scene_boundaries=None, crop=None,
                 mesh=None, convergence_estimator=None):
        unported = {"scene_boundaries": scene_boundaries, "crop": crop,
                    "mesh": mesh, "convergence_estimator": convergence_estimator}
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
        self.device = depth_model.device

    def _compose(self, depth, im):
        depth = resize_depth_for(depth, im, self.cfg)
        left, right = apply_divergence(depth, im, self.cfg, self.side_model,
                                       metric_depth=self.depth_model.is_metric())
        return postprocess_image(left, right, self.cfg.format)

    @torch.no_grad()
    def __call__(self, batch_u8):
        if self.depth_model.get_ema_buffer_size() != 1:
            raise NotImplementedError(
                "the EMA lookahead buffer (ema_buffer > 1) is not ported to "
                "nunif_tpu_torch yet (ROADMAP queue 1)")
        if not torch.is_tensor(batch_u8):
            batch_u8 = torch.from_numpy(np.ascontiguousarray(batch_u8))
        u8 = batch_u8.to(self.device)
        x = preprocess_image(u8.float() * (1.0 / 255.0), self.cfg)
        depth = self.depth_model.infer(x, tta=self.tta,
                                       edge_dilation=self.edge_dilation)
        scaler = self.depth_model.scaler
        if scaler.decay == 0:
            # stateless per-frame min-max, no host synchronisation
            stats = frame_stats(depth)
            mins, maxs = stats[:, 0], stats[:, 1]
        else:
            consts = scaler.update_values(frame_stats(depth).cpu().numpy())
            c = torch.from_numpy(consts).to(self.device, torch.float32)
            mins, maxs = c[:, 0], c[:, 1]
        d = scaler.normalize(depth, mins.reshape(-1, 1, 1, 1),
                             maxs.reshape(-1, 1, 1, 1))
        return self._compose(d, x)
