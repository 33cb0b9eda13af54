"""Film-grain RGB noise on NHWC tensors (counterpart of
``nunif_tpu/utils/rgb_noise.py``).

The draws come from a ``torch.Generator`` the caller passes, so they cannot
equal ``jax.random``'s; ``apply_rgb_noise`` is a pure function of the noise.
"""
from __future__ import annotations

from typing import Optional

import torch


def rgb_noise_like(base: torch.Tensor, level: int = 2,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Standard normal noise of base's shape (..., H, W, C); level 2 mixes
    in a half-resolution draw repeated over 2x2 pixels (each half weighted
    0.5, so the variance is 0.5).  The half-res draw covers odd sizes too
    (ceil(H / 2) rows, cropped), where the JAX package's does not fit."""
    if level not in (1, 2):
        raise ValueError(f"level must be 1 or 2, not {level}")
    kw = dict(generator=generator, dtype=base.dtype, device=base.device)
    noise = torch.randn(base.shape, **kw)
    if level == 2:
        h, w = base.shape[-3], base.shape[-2]
        small = torch.randn(base.shape[:-3] + ((h + 1) // 2, (w + 1) // 2,
                                               base.shape[-1]), **kw)
        up = small.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
        noise = noise * 0.5 + up[..., :h, :w, :] * 0.5
    return noise


def apply_rgb_noise(rgb: torch.Tensor, noise: torch.Tensor,
                    strength: float = 0.2, gamma: float = 2.2,
                    light_decay: bool = True,
                    light_decay_strength: float = 0.8) -> torch.Tensor:
    """Grain in gamma space, proportional to the light (luminance-correlated)
    and, with ``light_decay``, fading in bright regions."""
    if not 0 <= light_decay_strength <= 1:
        raise ValueError("light_decay_strength must be in [0, 1]")
    out = rgb ** gamma
    correlated = noise * out
    if light_decay:
        decay = ((1.0 - out) * light_decay_strength
                 + (1.0 - light_decay_strength)) ** gamma
    else:
        decay = 1.0
    out = out + correlated * (decay * strength)
    return out.clamp(0.0, 1.0) ** (1.0 / gamma)
