"""iw3.sod_v1, salient object detection for the convergence estimator,
NHWC (counterpart of ``nunif_tpu/iw3/models/sod_v1.py``): U2NETP over
[rgb, depth, sqrt(depth), depth^2], resized to 192 x 192 with antialias
and its fused map resized back to the input without."""
from __future__ import annotations

import math

import numpy as np
import torch

from ...models import I2IBaseModel, from_flax, register_model, to_flax
from ...modules.resize import resize
from ...utils.u2netp import U2NETP

SOD_SIZE = 192


@register_model
class SODV1(I2IBaseModel):
    model_name = "iw3.sod_v1"
    i2i_scale = 1
    i2i_offset = 0
    i2i_blend_size = 0
    i2i_in_channels = 4

    def __init__(self):
        super().__init__()
        self.u2netp = U2NETP(in_ch=6)

    def forward(self, x, train: bool = False):
        """x (B, H, W, 4): rgb + normalised depth, any size -> saliency
        (B, H, W, 1) in [0, 1] (the seven maps at 192 when training)."""
        rgb, depth = x[..., :3], x[..., 3:4]
        h = torch.cat([rgb, depth, depth ** 0.5, depth ** 2], dim=-1)
        if tuple(h.shape[1:3]) != (SOD_SIZE, SOD_SIZE):
            h = resize(h, SOD_SIZE, SOD_SIZE, mode="bilinear", antialias=True)
        outs = self.u2netp(h)
        if train:
            return outs
        d0 = outs[0]
        if d0.shape[1:3] != x.shape[1:3]:
            d0 = resize(d0, x.shape[1], x.shape[2], mode="bilinear",
                        antialias=False)
        return d0.clamp(0.0, 1.0)


def shaped_flax_params(model: SODV1, seed: int, calibration=None) -> dict:
    """Seeded random weights in flax layout (numpy, shared by both
    packages) whose saliency marks part of a frame: lecun-normal kernels
    clipped at 2 std, N(0, 0.02) biases, ``outconv``'s kernel scaled by 20
    (at the plain draw the saliency stays within 0.44-0.61), and, given a
    ``calibration`` input (B, H, W, 4), ``outconv``'s bias moved so that
    the median saliency over it is 0.5 (about half the pixels salient).
    Loads the weights into ``model``."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in to_flax(model).items():
        if key.rsplit("/", 1)[-1] == "kernel":
            std = math.sqrt(1.0 / math.prod(ref.shape[:-1])) / 0.8796256610342398
            a = np.clip(rng.standard_normal(ref.shape), -2.0, 2.0) * std
            if key == "u2netp/outconv/kernel":
                a = a * 20.0
        else:
            a = rng.normal(0.0, 0.02, ref.shape)
        flat[key] = a.astype(np.float32)
    from_flax(model, flat)
    if calibration is not None:
        with torch.no_grad():
            logit = model(calibration.float(), train=True)[0].clamp(1e-6, 1 - 1e-6)
            logit = torch.log(logit / (1 - logit)).median()
        flat["u2netp/outconv/bias"] = (
            flat["u2netp/outconv/bias"] - float(logit)).astype(np.float32)
        from_flax(model, flat)
    return flat
