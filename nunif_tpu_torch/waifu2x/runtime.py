"""waifu2x runtime: model slots + convert (counterpart of
``nunif_tpu/waifu2x/runtime.py``).

Each slot holds (model, TiledRenderer).  Not ported yet: 8-way TTA, alpha
upscaling and ``resize``; asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import DEFAULT_POLICY, Policy
from ..models import load_model
from ..utils.tiling import TiledRenderer

METHODS = ("scale", "scale4x", "noise", "noise_scale", "noise_scale4x")

# model-dir file stems, mirroring the reference naming convention
_FILE_STEMS = {
    ("scale", None): "scale2x",
    ("scale4x", None): "scale4x",
    **{("noise", n): f"noise{n}" for n in range(4)},
    **{("noise_scale", n): f"noise{n}_scale2x" for n in range(4)},
    **{("noise_scale4x", n): f"noise{n}_scale4x" for n in range(4)},
}

CHECKPOINT_EXT = ".nztm"


def default_model_dir() -> Optional[str]:
    """The bundled model zoo (``models/waifu2x/turbo`` at the repository
    root), or None.  Its checkpoints are ``waifu2x.turbo_2x``, which the port
    does not have yet: loading one raises ``NotPortedError``."""
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "models", "waifu2x", "turbo")
    return d if os.path.isdir(d) else None


def _slot_key(method: str, noise_level):
    return (method, noise_level if method.startswith("noise") else None)


class Waifu2x:
    def __init__(self, model_dir: str, policy: Policy = DEFAULT_POLICY,
                 device="cuda"):
        self.model_dir = model_dir
        self.policy = policy
        self.device = resolve_device(device)
        self._slots = {}  # (method, noise_level) -> (model, renderer)

    def model_path(self, method: str, noise_level: Optional[int]) -> str:
        stem = _FILE_STEMS[_slot_key(method, noise_level)]
        return os.path.join(self.model_dir, stem + CHECKPOINT_EXT)

    def load_model(self, method: str, noise_level: Optional[int] = None):
        key = _slot_key(method, noise_level)
        if key in self._slots:
            return self._slots[key]
        path = self.model_path(*key)
        if not os.path.exists(path):
            present = sorted(
                f[:-len(CHECKPOINT_EXT)] for f in os.listdir(self.model_dir)
                if f.endswith(CHECKPOINT_EXT)) if os.path.isdir(
                    self.model_dir) else []
            raise FileNotFoundError(
                f"no checkpoint for method={method!r} noise_level="
                f"{noise_level!r}: {path} does not exist (checkpoints in "
                f"{self.model_dir!r}: {present or 'none'})")
        model, _meta = load_model(path, device=self.device)
        self._slots[key] = (model, TiledRenderer(model, policy=self.policy))
        return self._slots[key]

    def set_slot(self, method: str, noise_level, model):
        """Install an in-memory model (tests, random init, converted)."""
        model = model.to(self.device).eval().requires_grad_(False)
        self._slots[_slot_key(method, noise_level)] = (
            model, TiledRenderer(model, policy=self.policy))

    def render(self, x, method: str, noise_level: Optional[int] = None,
               tile_size=None, batch_size=None) -> torch.Tensor:
        _model, renderer = self.load_model(method, noise_level)
        return renderer.render(x, tile_size=tile_size, batch_size=batch_size)

    def convert(self, x, alpha=None, method: str = "scale",
                noise_level: Optional[int] = None, tile_size=None,
                batch_size=None, tta: bool = False):
        """x (H, W, 3) float32 in [0, 1]; alpha (H, W, 1) or None.

        Returns (rgb, alpha) at the output scale as fp32 tensors on the
        runtime's device; alpha is None when none was given and all ones
        when it was blank.
        """
        if method not in METHODS:
            raise ValueError(f"method {method!r} not in {METHODS}")
        if method not in ("scale", "scale4x") and not (
                noise_level is not None and 0 <= noise_level < 4):
            raise ValueError(f"method {method!r} needs noise_level 0..3")
        if tta:
            raise NotImplementedError("tta is not ported to nunif_tpu_torch yet")
        blank_alpha = alpha is None or bool(np.all(np.asarray(alpha) >= 1.0))
        if not blank_alpha:
            raise NotImplementedError(
                "non-blank alpha is not ported to nunif_tpu_torch yet")
        model, renderer = self.load_model(method, noise_level)
        rgb = renderer.render(x, tile_size=tile_size, batch_size=batch_size)
        out_alpha = None
        if alpha is not None:
            out_alpha = torch.ones((rgb.shape[0], rgb.shape[1], 1),
                                   dtype=torch.float32, device=rgb.device)
        return rgb, out_alpha
