"""Saliency-guided per-frame convergence (counterpart of
``nunif_tpu/iw3/convergence_estimator.py``).

SOD saliency over (rgb, depth); the 10% and 90% depth quantiles of the
salient region (saliency > 0.5) map the user's convergence in [0, 1] onto
a depth position; for video an EMA smooths it, reset after each frame
flagged as the last of its shot.  The EMA reads the (B,) positions back
to the host once a batch.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

logger = logging.getLogger("nunif_tpu_torch.iw3")


def depth_position_from_ratio(saliency_map, depth, pos):
    """saliency (B, H, W, 1), depth (B, H, W, 1), pos a float -> (B,)
    positions in [0, 1].  The quantiles sort the masked depth with +inf in
    place of the unmasked pixels and take indexes round(0.1 n) and
    round(0.9 n) of n = count - 1 (round half to even); an empty mask gives
    0.5, a flat one (range < 1e-6) its 10% quantile."""
    B = depth.shape[0]
    d = depth.reshape(B, -1).float()
    m = saliency_map.reshape(B, -1) > 0.5
    cnt = m.sum(dim=1)
    s = torch.sort(torch.where(m, d, torch.full_like(d, float("inf"))), dim=1).values
    n = (cnt - 1).clamp(min=0).float()
    q01 = s.gather(1, torch.round(n * 0.1).long()[:, None])[:, 0]
    q09 = s.gather(1, torch.round(n * 0.9).long()[:, None])[:, 0]
    q_range = q09 - q01
    center = (q01 + q09) / 2
    q_pos = torch.where(q_range < 1e-6, q01, center + (pos - 0.5) * q_range * 3.0)
    q_pos = torch.where(cnt > 0, q_pos, torch.full_like(q_pos, 0.5))
    return q_pos.clamp(0.0, 1.0)


class ConvergenceEstimator:
    """``sod_model``: an ``iw3.sod_v1`` net on the frames' device (seeded
    by the caller without a checkpoint, as ``cli.create_sod_model`` does).
    ``__call__(rgb, depth, reset_pts)`` -> (B,) fp32 convergences on the
    input's device; ``mask_share`` holds the last batch's share of salient
    pixels."""

    def __init__(self, convergence: float, sod_model, enable_ema: bool = False,
                 decay: float = 0.9):
        self.model = sod_model
        self.convergence = convergence
        self.enable_ema = enable_ema
        self.decay = decay
        self.convergence_ema = None
        self.mask_share = None

    def reset(self, enable_ema=None, decay=None):
        if enable_ema is not None:
            self.enable_ema = enable_ema
        if decay is not None:
            self.decay = decay
        self.convergence_ema = None

    @torch.no_grad()
    def __call__(self, rgb, depth, reset_pts=None):
        """rgb (B, H, W, 3), depth (B, H, W, 1) normalised."""
        saliency = self.model(torch.cat([rgb, depth], dim=-1))
        self.mask_share = (saliency > 0.5).float().mean()
        z_pos = depth_position_from_ratio(saliency, depth, self.convergence)
        if not self.enable_ema:
            return z_pos
        reset_pts = reset_pts or [False] * depth.shape[0]
        out = []
        for i, p in enumerate(z_pos.cpu().numpy().tolist()):
            if self.convergence_ema is None:
                self.convergence_ema = p
            else:
                self.convergence_ema = (self.decay * self.convergence_ema
                                        + (1 - self.decay) * p)
            out.append(self.convergence_ema)
            if reset_pts[i]:
                self.convergence_ema = None
        return torch.from_numpy(np.asarray(out, np.float32)).to(z_pos.device)
