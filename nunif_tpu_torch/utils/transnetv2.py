"""TransNetV2 shot-boundary detector, ``aux.transnetv2`` (counterpart of
``nunif_tpu/utils/transnetv2.py``; soCzech/TransNetV2, MIT).

Input (B, T, 27, 48, 3) frames with values 0-255 as floats, channels last
as in the JAX package; the 3-D convs run on NCDHW views.  Stacked dilated
(2+1)-D conv blocks with average pooling, the frame-similarity and
colour-histogram features over a band of 101 frames, ``fc1`` (D = 1024)
and two heads: returns the (one_hot, many_hot) logits, (B, T, 1) each.
BatchNorm (eval) folds into the convs when weights are converted; flax
paths as the JAX module's (``SDDCNN_i/DDCNN_j/conv_d<d>/conv1``, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models import Model, register_model


class Conv3DConfigurable(nn.Module):
    """(2+1)-D conv: 1x3x3 spatial (no bias), then 3x1x1 temporal at
    dilation ``d``."""

    def __init__(self, in_channels: int, filters: int, dilation_rate: int):
        super().__init__()
        d = dilation_rate
        self.conv1 = nn.Conv3d(in_channels, 2 * filters, (1, 3, 3),
                               padding=(0, 1, 1), bias=False)
        self.conv2 = nn.Conv3d(2 * filters, filters, (3, 1, 1),
                               padding=(d, 0, 0), dilation=(d, 1, 1))

    def forward(self, x):  # NCDHW
        return self.conv2(self.conv1(x))


class DilatedDCNNV2(nn.Module):
    """Four dilation rates (1, 2, 4, 8), concatenated."""

    def __init__(self, in_channels: int, filters: int, activation: bool = True):
        super().__init__()
        self.activation = activation
        for d in (1, 2, 4, 8):
            setattr(self, f"conv_d{d}", Conv3DConfigurable(in_channels, filters, d))

    def forward(self, x):
        x = torch.cat([getattr(self, f"conv_d{d}")(x) for d in (1, 2, 4, 8)], dim=1)
        return F.relu(x) if self.activation else x


class StackedDDCNNV2(nn.Module):
    """``n_blocks`` dilated blocks with a residual shortcut, then a 1x2x2
    average pool that floors odd sizes (27 -> 13)."""

    def __init__(self, in_channels: int, n_blocks: int, filters: int):
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            setattr(self, f"DDCNN_{i}", DilatedDCNNV2(
                in_channels if i == 0 else 4 * filters, filters,
                activation=(i != n_blocks - 1)))

    def forward(self, x):
        shortcut = None
        for i in range(self.n_blocks):
            x = getattr(self, f"DDCNN_{i}")(x)
            if shortcut is None:
                shortcut = x
        x = F.relu(x) + shortcut
        return F.avg_pool3d(x, (1, 2, 2))


def _lookup(similarities, lookup_window: int):
    """The (B, T, lookup_window) band of a (B, T, T) similarity matrix
    around its diagonal, zero beyond the ends."""
    B, T, _ = similarities.shape
    half = (lookup_window - 1) // 2
    padded = F.pad(similarities, (half, half))
    idx = (torch.arange(lookup_window, device=similarities.device)[None, :]
           + torch.arange(T, device=similarities.device)[:, None])
    return torch.gather(padded, 2, idx[None].expand(B, T, lookup_window))


@register_model
class TransNetV2(Model):
    """forward(frames (B, T, 27, 48, 3), 0-255) -> (one_hot, many_hot)
    logits, (B, T, 1) each."""
    model_name = "aux.transnetv2"

    def __init__(self, F: int = 16, L: int = 3, S: int = 2, D: int = 1024,
                 lookup_window: int = 101):
        super().__init__()
        self.F, self.L, self.S, self.D = F, L, S, D
        self.lookup_window = lookup_window
        cin = 3
        for i in range(L):
            filters = F * 2 ** i
            setattr(self, f"SDDCNN_{i}", StackedDDCNNV2(cin, S, filters))
            cin = 4 * filters
        pooled = sum(4 * F * 2 ** i for i in range(L))
        flat = cin * (27 // 2 ** L) * (48 // 2 ** L)
        self.frame_sim_projection = nn.Linear(pooled, 128)
        self.frame_sim_fc = nn.Linear(lookup_window, 128)
        self.color_hist_fc = nn.Linear(lookup_window, 128)
        self.fc1 = nn.Linear(128 + 128 + flat, D)
        self.cls_layer1 = nn.Linear(D, 1)
        self.cls_layer2 = nn.Linear(D, 1)

    def forward(self, inputs):
        x = inputs.float().permute(0, 4, 1, 2, 3)  # NCDHW
        block_features = []
        for i in range(self.L):
            x = getattr(self, f"SDDCNN_{i}")(x)
            block_features.append(x)
        B, T = x.shape[0], x.shape[2]
        flat = x.permute(0, 2, 3, 4, 1).reshape(B, T, -1)  # flax's (H, W, C) order
        sim = self._frame_similarity(block_features)
        hist = self._color_histograms(inputs)
        x = F.relu(self.fc1(torch.cat([hist, sim, flat], dim=2)))
        return self.cls_layer1(x), self.cls_layer2(x)

    def _frame_similarity(self, block_features):
        pooled = torch.cat([f.mean(dim=(3, 4)).transpose(1, 2)
                            for f in block_features], dim=-1)  # (B, T, C)
        x = self.frame_sim_projection(pooled)
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        band = _lookup(torch.einsum("btc,bsc->bts", x, x), self.lookup_window)
        return F.relu(self.frame_sim_fc(band))

    def _color_histograms(self, frames):
        """512-bin RGB histograms (3 bits a channel) and their banded
        similarity."""
        B, T, H, W, _ = frames.shape
        f = torch.clamp(frames, 0, 255).to(torch.int64)
        bins = ((f[..., 0] >> 5) << 6) + ((f[..., 1] >> 5) << 3) + (f[..., 2] >> 5)
        bins = bins.reshape(B * T, H * W)
        hist = torch.zeros((B * T, 512), dtype=torch.float32, device=frames.device)
        hist.scatter_add_(1, bins, torch.ones_like(bins, dtype=torch.float32))
        hist = hist.reshape(B, T, 512)
        hist = hist / (torch.linalg.vector_norm(hist, dim=-1, keepdim=True) + 1e-12)
        band = _lookup(torch.einsum("btc,bsc->bts", hist, hist), self.lookup_window)
        return F.relu(self.color_hist_fc(band))
