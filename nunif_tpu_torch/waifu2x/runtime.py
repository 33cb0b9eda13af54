"""waifu2x runtime: model slots + convert (counterpart of
``nunif_tpu/waifu2x/runtime.py``).

Each slot holds (model, TiledRenderer), loaded lazily from a model
directory (by default the bundled turbo_2x zoo).  ``convert`` runs the
alpha border pad, 8-way TTA and the alpha upscale (by the ``scale`` /
``scale4x`` slot when it exists, else bilinear) as the JAX runtime does.
A 1-channel image into a 3-channel model runs on its 3-channel replication
and returns the mean of the three output channels (the JAX runtime feeds
the 1-channel image to the model and fails).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..core.device import resolve_device
from ..core.dtypes import DEFAULT_POLICY, Policy
from ..models import load_model
from ..modules.resize import resize
from ..transforms.tta import tta_render
from ..utils.alpha import alpha_border_pad
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
    root: ``waifu2x.turbo_2x`` checkpoints ``scale2x``, ``noise0_scale2x``,
    ``noise1_scale2x`` and ``noise3_scale2x``), or None."""
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

    def has_model_file(self, method: str, noise_level: Optional[int]) -> bool:
        return os.path.exists(self.model_path(method, noise_level))

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

    def load_model_all(self, load_4x: bool = True):
        """Load every slot whose checkpoint is in the model directory."""
        for method, noise in _FILE_STEMS:
            if (load_4x or not method.endswith("4x")) and \
                    self.has_model_file(method, noise):
                self.load_model(method, noise)

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
        """x (H, W, 3) or (H, W, 1) float32 in [0, 1]; alpha (H, W, 1) or
        None.

        Returns (rgb, alpha) at the output scale as fp32 tensors on the
        runtime's device, rgb with x's channels; alpha is None when none was
        given and all ones when it was blank.
        """
        if method not in METHODS:
            raise ValueError(f"method {method!r} not in {METHODS}")
        if method not in ("scale", "scale4x") and not (
                noise_level is not None and 0 <= noise_level < 4):
            raise ValueError(f"method {method!r} needs noise_level 0..3")
        model, renderer = self.load_model(method, noise_level)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        gray = x.shape[-1] == 1 and getattr(model, "in_channels", 3) == 3
        if gray:
            x = x.expand(-1, -1, 3)
        if alpha is not None:
            alpha = torch.as_tensor(alpha, dtype=torch.float32,
                                    device=self.device)
        blank_alpha = alpha is None or bool((alpha >= 1.0).all())
        if not blank_alpha:
            x = alpha_border_pad(x, alpha, int(model.i2i_offset))
        if tta:
            rgb = tta_render(renderer, x, tile_size, batch_size)
        else:
            rgb = renderer.render(x, tile_size=tile_size, batch_size=batch_size)
        if gray:
            rgb = rgb.mean(dim=-1, keepdim=True)
        out_alpha = None
        if alpha is not None:
            out_alpha = self._scale_alpha(alpha, blank_alpha, method,
                                          int(model.i2i_scale), tile_size,
                                          batch_size)
        return rgb, out_alpha

    def _scale_alpha(self, alpha, blank, method, scale, tile_size,
                     batch_size):
        """alpha (H, W, 1) at the output scale: as it is at scale 1, ones
        when blank, else through the scale slot's model (on its 3-channel
        replication, mean of the output) or, without one, bilinear."""
        h, w = alpha.shape[0] * scale, alpha.shape[1] * scale
        if scale == 1:
            return alpha
        if blank:
            return torch.ones((h, w, 1), dtype=torch.float32,
                              device=alpha.device)
        skey = ("scale4x", None) if method.endswith("4x") else ("scale", None)
        if skey in self._slots or self.has_model_file(*skey):
            _model, srenderer = self.load_model(*skey)
            up = srenderer.render(alpha.expand(-1, -1, 3), tile_size=tile_size,
                                  batch_size=batch_size)
            return up.mean(dim=-1, keepdim=True)
        return resize(alpha, h, w, mode="bilinear", antialias=False)

    @torch.inference_mode()
    def warmup(self, methods=None, tile_size=None, batch_size=None):
        """Render one zero tile through each loaded slot (or the given
        (method, noise_level) keys), so that cuDNN picks its algorithms
        before the first image."""
        for key in (methods or list(self._slots)):
            model, renderer = self._slots[key]
            t = model.find_valid_tile_size(tile_size)
            x = torch.zeros((t, t, getattr(model, "in_channels", 3)),
                            device=self.device)
            renderer.render(x, tile_size=t, batch_size=batch_size)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
