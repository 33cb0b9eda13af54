"""L4SN, a 4-level spectral-norm feature network, NHWC (counterpart of
``nunif_tpu/dino/l4sn.py``).

A pyramid of stride-2 spectral-norm convs (``SNConv``, the stateless
5-step power iteration of the waifu2x discriminators) with a feature tap
after each level, and the window sliced-Wasserstein distance; waifu2x's
``l1l4sn`` / ``l1l4sn2`` / ``l1l4sn_swd`` losses are L1 over the four
taps (plus that distance on the last).  Plain PyTorch on cuDNN.
"""
from __future__ import annotations

import torch
from torch import nn

from ..models import Model, register_model
from ..modules.attention import dense
from ..modules.conv import leaky_relu
from ..modules.permute import window_partition
from ..waifu2x.models.discriminator import SNConv

C1, C2, C3, C4, C5 = 32, 64, 128, 256, 512
FEAT_DIMS = [C2, C3, C4, C5]
_DOWN = dict(kernel_size=(4, 4), strides=(2, 2), padding=((1, 1), (1, 1)))


@register_model
class L4SNFeature(Model):
    """x (B, H, W, 3) in [0, 1], H and W multiples of 16 -> the four level
    outputs (LeakyReLU(0.2) applied unless ``activation`` is False)."""
    model_name = "dino.l4sn_feature"

    def __init__(self):
        super().__init__()
        self.l1_0 = SNConv(3, C1)
        self.l1_2 = SNConv(C1, C2, **_DOWN)
        self.l1_4 = SNConv(C2, C2)
        self.l2_0 = SNConv(C2, C3, **_DOWN)
        self.l2_2 = SNConv(C3, C3)
        self.l3_0 = SNConv(C3, C4, **_DOWN)
        self.l3_2 = SNConv(C4, C4)
        self.l4_0 = SNConv(C4, C5, **_DOWN)
        self.l4_2 = SNConv(C5, C5)

    def forward(self, x, train: bool = False, activation: bool = True):
        if x.shape[1] % 16 or x.shape[2] % 16:
            raise ValueError(f"L4SNFeature: H, W must be multiples of 16, "
                             f"got {tuple(x.shape[1:3])}")
        x = (x - 0.5) / 0.5
        h = leaky_relu(self.l1_0(x), 0.2)
        h = leaky_relu(self.l1_2(h), 0.2)
        x1 = self.l1_4(h)
        h = leaky_relu(self.l2_0(leaky_relu(x1, 0.2)), 0.2)
        x2 = self.l2_2(h)
        h = leaky_relu(self.l3_0(leaky_relu(x2, 0.2)), 0.2)
        x3 = self.l3_2(h)
        h = leaky_relu(self.l4_0(leaky_relu(x3, 0.2)), 0.2)
        x4 = self.l4_2(h)
        feats = [x1, x2, x3, x4]
        return [leaky_relu(f, 0.2) for f in feats] if activation else feats


@register_model
class L4SN(Model):
    """Classifier head over ``L4SNFeature``: the mean of the last level,
    one dense layer."""
    model_name = "dino.l4sn"

    def __init__(self, num_classes: int = 1):
        super().__init__()
        self.num_classes = num_classes
        self.feature = L4SNFeature()
        self.fc = nn.Linear(C5, num_classes)

    def forward(self, x, train: bool = False):
        h = self.feature(x, activation=True)[-1].mean(dim=(1, 2))
        return dense(h, self.fc)


def window_sliced_wasserstein(x, y, window_size: int = 8):
    """Mean L1 between the sorted activations of each window.  The maps are
    cut to whole windows first (their top-left part): the JAX function
    reshapes them as they are, which raises where a side is not a multiple
    of the window, as L4SN's last level of swin_unet_2x's 192^2 training
    output is (12^2; ROADMAP queue 3)."""
    window_size = min(window_size, x.shape[1], x.shape[2])
    h = x.shape[1] - x.shape[1] % window_size
    w = x.shape[2] - x.shape[2] % window_size
    x, y = x[:, :h, :w], y[:, :h, :w]
    xw = window_partition(x, window_size)
    yw = window_partition(y, window_size)
    n, w, _, c = xw.shape
    xs = torch.sort(xw.reshape(n, w * w, c), dim=1).values
    ys = torch.sort(yw.reshape(n, w * w, c), dim=1).values
    return torch.mean(torch.abs(xs - ys))


def l4sn_feature_loss(model: L4SNFeature, x, y, weight: float = 1.0,
                      swd_weight: float = 0.0):
    """L1 over the four feature levels, plus ``swd_weight`` times the window
    sliced-Wasserstein distance of the last, times ``weight``.  The target
    branch is not detached, as in the JAX function (the network is frozen:
    nothing reads a gradient there)."""
    fx = model(x)
    fy = model(y)
    loss = sum(torch.mean(torch.abs(a - b)) for a, b in zip(fx, fy)) / len(fx)
    if swd_weight > 0:
        loss = loss + swd_weight * window_sliced_wasserstein(fx[-1], fy[-1])
    return loss * weight
