"""Depth model base: lifecycle and the EMA min-max normalisation hooks
(counterpart of ``nunif_tpu/iw3/depth/base.py``; the DepthAA filter and
the 16-bit depth PNG round trip are not ported yet).

With a lookahead buffer (``buffer_size > 1``) the scaler holds frames back:
``minmax_normalize`` returns fewer frames than it was given and
``flush_minmax_normalize`` the rest.  ``reset`` clears the scaler and any
temporal state of the model (``reset_state``)."""
from __future__ import annotations

from abc import ABCMeta, abstractmethod

import torch

from ...core.device import resolve_device
from ..depth_scaler import EMAMinMaxScaler


class BaseDepthModel(metaclass=ABCMeta):
    def __init__(self, model_type, device="cuda", dtype=torch.bfloat16):
        self.model = None
        self.model_type = model_type
        self.device = resolve_device(device)
        self.dtype = dtype  # the network's compute dtype
        self.scaler = self.create_depth_scaler()
        self.limit_resolution = False

    def create_depth_scaler(self):
        return EMAMinMaxScaler(decay=0, buffer_size=1)

    def loaded(self):
        return self.model is not None

    @classmethod
    @abstractmethod
    def get_name(cls):
        ...

    @classmethod
    @abstractmethod
    def supported(cls, model_type):
        ...

    @abstractmethod
    def is_metric(self):
        ...

    @abstractmethod
    def load_model(self, model_type, resolution=None, **kwargs):
        ...

    def load(self, resolution=None, limit_resolution=False, **kwargs):
        self.limit_resolution = limit_resolution
        self.model = self.load_model(self.model_type, resolution=resolution,
                                     **kwargs)
        return self

    @abstractmethod
    def infer(self, x, **kwargs):
        ...

    # EMA normalisation hooks
    def enable_ema(self, decay, buffer_size=None):
        self.scaler.reset(decay=decay, buffer_size=buffer_size)

    def get_ema_state(self):
        return self.scaler.decay, self.scaler.buffer_size

    def disable_ema(self):
        self.scaler.reset(decay=0, buffer_size=1)

    def reset_ema(self, decay=None, buffer_size=None):
        self.scaler.reset(decay=decay, buffer_size=buffer_size)

    def reset_state(self):
        """Clear the model's temporal state (none here)."""

    def reset(self):
        self.reset_ema()
        self.reset_state()

    def get_ema_buffer_size(self):
        return self.scaler.buffer_size

    def minmax_normalize(self, depth, reset_ema=None):
        """depth (B, H, W, 1) -> list of normalised frames; one
        device-to-host read for the batch."""
        if depth.dim() != 4:
            raise ValueError(f"depth must be (B, H, W, 1), got {tuple(depth.shape)}")
        if reset_ema is not None and len(reset_ema) != depth.shape[0]:
            raise ValueError("reset_ema needs one flag per frame")
        return self.scaler.update_batch(depth, reset_flags=reset_ema)

    def flush_minmax_normalize(self, return_minmax=False):
        """The frames the lookahead buffer still holds, normalised."""
        return self.scaler.flush(return_minmax=return_minmax)
