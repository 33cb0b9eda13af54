"""MiDaS DPT-BEiT core, NHWC: the relative-depth backbone of ZoeD_N / K /
NK (counterpart of ``nunif_tpu/iw3/depth/midas.py``).  MiDaS is this core
only; it is no depth model type of its own.

A BEiT ViT (patch 16, class token, no absolute position embedding; q and v
biases, no k bias; a relative-position bias per block; LayerScale gammas),
the DPT neck (project readout of the class token, 1x1 projections, the
4x / 2x transposed convs, the stride-2 conv), RefineNet fusion and the
MiDaS output head.  ``MidasCore`` returns the relative depth and the taps
ZoeDepth's metric head reads.

The BEiT attention is plain PyTorch, as the JAX package leaves it to XLA:
it adds a bias to the scores, which kernel K7 does not take.  Rounding as
JAX's: q * hd^-0.5 rounded to x's dtype, fp32 scores plus the fp32 bias,
an fp32 softmax rounded to x's dtype, fp32 P V rounded to x's dtype.  The
bias of a patch grid is the pretrained 2-D table resized bilinearly
(antialiased when it shrinks, as ``jax.image.resize``) and gathered by the
relative-position index; it is cached per grid and rebuilt when the table's
storage or version changes (a weight load).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.dtypes import cast_param
from ...modules.attention import dense
from ...modules.resize import resize
from .dinov2 import layer_norm
from .dpt import FeatureFusionBlock, _interp, conv, conv_transpose

BEIT_CONFIGS = {
    # pretrained at 384 with patch 16: a 24 x 24 grid
    "beit_l_384": dict(embed_dim=1024, depth=24, num_heads=16,
                       pretrained_grid=24, hooks=(5, 11, 17, 23),
                       neck_channels=(256, 512, 1024, 1024)),
    "beit_b_384": dict(embed_dim=768, depth=12, num_heads=12,
                       pretrained_grid=24, hooks=(2, 5, 8, 11),
                       neck_channels=(96, 192, 384, 768)),
}


@functools.lru_cache(maxsize=16)
def relative_position_index(gh: int, gw: int) -> np.ndarray:
    """BEiT's relative position index with the three class-token entries:
    (1 + gh*gw, 1 + gh*gw) into a table of (2gh-1)(2gw-1) + 3 rows."""
    coords = np.stack(np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += gh - 1
    rel[:, :, 1] += gw - 1
    rel[:, :, 0] *= 2 * gw - 1
    n = gh * gw
    num_rel = (2 * gh - 1) * (2 * gw - 1)
    index = np.zeros((n + 1, n + 1), np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num_rel        # cls -> all
    index[0:, 0] = num_rel + 1    # all -> cls
    index[0, 0] = num_rel + 2     # cls -> cls
    return index


def resize_bias_table(table: torch.Tensor, pg: int, gh: int, gw: int) -> torch.Tensor:
    """The ((2pg-1)^2 + 3, heads) table -> ((2gh-1)(2gw-1) + 3, heads) fp32:
    the grid part resized bilinearly as ``jax.image.resize`` (antialiased
    when it shrinks), the three class-token rows kept."""
    table = table.float()
    if (gh, gw) == (pg, pg):
        return table
    heads = table.shape[1]
    grid = table[:-3].reshape(1, 2 * pg - 1, 2 * pg - 1, heads)
    grid = resize(grid, 2 * gh - 1, 2 * gw - 1, mode="bilinear", antialias=True)
    return torch.cat([grid.reshape(-1, heads), table[-3:]], dim=0)


class BeitAttention(nn.Module):
    """Flax leaf names: ``qkv_kernel`` (C, 3C) in flax layout, ``q_bias``,
    ``v_bias``, ``relative_position_bias_table``, ``proj``."""

    def __init__(self, dim: int, num_heads: int, pretrained_grid: int):
        super().__init__()
        self.num_heads = num_heads
        self.pretrained_grid = pg = pretrained_grid
        self.qkv_kernel = nn.Parameter(torch.zeros(dim, 3 * dim))
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * pg - 1) ** 2 + 3, num_heads))
        self.proj = nn.Linear(dim, dim)
        self._bias_key = None
        self._bias = None

    def position_bias(self, gh: int, gw: int) -> torch.Tensor:
        """(1, heads, N, N) fp32 for a gh x gw grid, cached."""
        t = self.relative_position_bias_table
        key = (gh, gw, t.data_ptr(), t.device, t._version)
        if key != self._bias_key:
            with torch.no_grad():
                table = resize_bias_table(t, self.pretrained_grid, gh, gw)
                index = torch.from_numpy(relative_position_index(gh, gw)).to(t.device)
                n = index.shape[0]
                self._bias = table[index.reshape(-1)].reshape(n, n, -1) \
                    .permute(2, 0, 1).unsqueeze(0).contiguous()
            self._bias_key = key
        return self._bias

    def forward(self, x: torch.Tensor, grid_hw) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = x @ cast_param(self.qkv_kernel, x.dtype)
        q, k, v = qkv.split(C, dim=-1)
        q = q + cast_param(self.q_bias, x.dtype)
        v = v + cast_param(self.v_bias, x.dtype)
        q, k, v = (t.reshape(B, N, H, hd).transpose(1, 2) for t in (q, k, v))
        # the scale rounded to x's dtype first, as a weakly typed JAX scalar
        q = q * torch.tensor(hd ** -0.5, dtype=x.dtype, device=x.device)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores + self.position_bias(*grid_hw)
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.matmul(attn.float(), v.float()).to(x.dtype)
        return dense(out.transpose(1, 2).reshape(B, N, C), self.proj)


class BeitBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, pretrained_grid: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.gamma_1 = nn.Parameter(torch.full((dim,), 0.1))
        self.gamma_2 = nn.Parameter(torch.full((dim,), 0.1))
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = BeitAttention(dim, num_heads, pretrained_grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, hidden)
        self.mlp_fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, grid_hw) -> torch.Tensor:
        h = self.attn(layer_norm(x, self.norm1), grid_hw)
        x = x + cast_param(self.gamma_1, x.dtype) * h
        h = dense(F.gelu(dense(layer_norm(x, self.norm2), self.mlp_fc1)), self.mlp_fc2)
        return x + cast_param(self.gamma_2, x.dtype) * h


class BeitBackbone(nn.Module):
    """Returns the hooked blocks' token maps (with the class token)."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 pretrained_grid: int, hooks, patch_size: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.depth = depth
        self.hooks = tuple(hooks)
        self.patch_size = patch_size
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        for i in range(depth):
            self.add_module(f"blocks_{i}", BeitBlock(embed_dim, num_heads,
                                                     pretrained_grid))

    def forward(self, x: torch.Tensor):
        B, H, W, _ = x.shape
        ps = self.patch_size
        gh, gw = H // ps, W // ps
        tokens = conv(x, self.patch_embed, stride=ps).reshape(B, gh * gw, self.embed_dim)
        cls = cast_param(self.cls_token, x.dtype).expand(B, 1, self.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1)
        outputs = {}
        for i in range(self.depth):
            tokens = getattr(self, f"blocks_{i}")(tokens, (gh, gw))
            if i in self.hooks:
                outputs[i] = tokens
        return [outputs[i] for i in self.hooks], (gh, gw)


class MidasCore(nn.Module):
    """BEiT backbone + DPT neck.  x (B, H, W, 3) normalised (mean / std
    0.5), H and W multiples of 32 -> (relative depth (B, H, W), taps
    [out32 (H), rn4 (H/32), r4 (H/16), r3 (H/8), r2 (H/4), r1 (H/2)])."""

    def __init__(self, backbone: str = "beit_l_384", features: int = 256):
        super().__init__()
        cfg = dict(BEIT_CONFIGS[backbone])
        nc = cfg.pop("neck_channels")
        C = cfg["embed_dim"]
        self.pretrained = BeitBackbone(**cfg)
        for i in range(4):
            self.add_module(f"readout_{i}", nn.Linear(2 * C, C))
            self.add_module(f"projects_{i}", nn.Conv2d(C, nc[i], 1))
        self.resize_0 = nn.ConvTranspose2d(nc[0], nc[0], 4, stride=4)
        self.resize_1 = nn.ConvTranspose2d(nc[1], nc[1], 2, stride=2)
        self.resize_3 = nn.Conv2d(nc[3], nc[3], 3, stride=2)
        for i in range(4):
            self.add_module(f"layer{i + 1}_rn",
                            nn.Conv2d(nc[i], features, 3, bias=False))
        self.refinenet4 = FeatureFusionBlock(features, fuse=False)
        self.refinenet3 = FeatureFusionBlock(features)
        self.refinenet2 = FeatureFusionBlock(features)
        self.refinenet1 = FeatureFusionBlock(features)
        self.output_conv1 = nn.Conv2d(features, features // 2, 3)
        self.output_conv2_0 = nn.Conv2d(features // 2, 32, 3)
        self.output_conv2_2 = nn.Conv2d(32, 1, 1)

    def forward(self, x: torch.Tensor):
        B, H, W, _ = x.shape
        feats, (gh, gw) = self.pretrained(x)
        levels = []
        for i, tokens in enumerate(feats):
            patch = tokens[:, 1:]
            # project readout: the class token concatenated onto every token
            t = torch.cat([patch, tokens[:, :1].expand_as(patch)], dim=-1)
            t = F.gelu(dense(t, getattr(self, f"readout_{i}")))
            t = conv(t.reshape(B, gh, gw, -1), getattr(self, f"projects_{i}"))
            if i == 0:
                t = conv_transpose(t, self.resize_0, 4)
            elif i == 1:
                t = conv_transpose(t, self.resize_1, 2)
            elif i == 3:
                t = conv(t, self.resize_3, stride=2, padding=1)
            levels.append(t)
        rn = [conv(levels[i], getattr(self, f"layer{i + 1}_rn"), padding=1)
              for i in range(4)]
        r4 = self.refinenet4(rn[3], out_hw=rn[2].shape[1:3])
        r3 = self.refinenet3(r4, rn[2], out_hw=rn[1].shape[1:3])
        r2 = self.refinenet2(r3, rn[1], out_hw=rn[0].shape[1:3])
        r1 = self.refinenet1(r2, rn[0])
        h = _interp(conv(r1, self.output_conv1, padding=1), H, W)
        out32 = F.relu(conv(h, self.output_conv2_0, padding=1))
        rel = F.relu(conv(out32, self.output_conv2_2))[..., 0]
        return rel, [out32, rn[3], r4, r3, r2, r1]
