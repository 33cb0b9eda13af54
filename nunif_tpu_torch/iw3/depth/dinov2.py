"""DINOv2 vision transformer encoder, NHWC input (counterpart of
``nunif_tpu/iw3/depth/dinov2.py``).

Patch-14 (DepthPro: patch-16) conv embedding, class token, learned position embedding resized
bicubically to the patch grid, pre-norm blocks with LayerScale and an exact
GELU MLP, final LayerNorm on the requested intermediate outputs.  The
attention of every block runs kernel K7 (``ops/sdpa.py``) on CUDA.  Module
and parameter names follow the flax tree (``models.flax_params``).
Compute runs in x's dtype; LayerNorm statistics, scores and softmax in fp32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.dtypes import cast_param
from ...modules.attention import dense
from ...ops import sdpa as _k7


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax ``LayerNorm(dtype=x.dtype)``: fp32 statistics, one rounding."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        qkv = dense(x, self.qkv).reshape(B, N, 3, self.num_heads, hd)
        # strided (B, H, N, d) views: the kernel reads them in place
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        out = _k7.sdpa(q, k, v, scale=hd ** -0.5)
        return dense(out.transpose(1, 2).reshape(B, N, C), self.proj)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * cast_param(self.gamma, x.dtype)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, hidden)
        self.mlp_fc2 = nn.Linear(hidden, dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(layer_norm(x, self.norm1)))
        h = F.gelu(dense(layer_norm(x, self.norm2), self.mlp_fc1))
        return x + self.ls2(dense(h, self.mlp_fc2))


def resize_pos_embed(grid: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(1, S, S, C) fp32 grid -> (1, ph, pw, C): ``jax.image.resize(...,
    "bicubic")``, i.e. Keys cubic (a = -0.5) with antialiasing when
    downscaling, which is torch's antialiased bicubic."""
    y = F.interpolate(grid.permute(0, 3, 1, 2), size=(ph, pw), mode="bicubic",
                      antialias=True, align_corners=False)
    return y.permute(0, 2, 3, 1)


class DinoVisionTransformer(nn.Module):
    """Returns the requested intermediate patch-token maps.
    x: (B, H, W, 3) with H, W multiples of patch_size."""

    def __init__(self, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, patch_size: int = 14,
                 pos_embed_size: int = 37):
        super().__init__()
        self.embed_dim = embed_dim
        self.depth = depth
        self.patch_size = patch_size
        self.pos_embed_size = pos_embed_size
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + pos_embed_size ** 2, embed_dim))
        for i in range(depth):
            self.add_module(f"blocks_{i}", Block(embed_dim, num_heads))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self._pos_key = None
        self._pos = None

    def position_embedding(self, ph: int, pw: int) -> torch.Tensor:
        """(1, 1 + ph*pw, C) fp32, resized again only when the grid or the
        embedding's storage or version changes (a weight load)."""
        p = self.pos_embed
        key = (ph, pw, p.data_ptr(), p.device, p._version)
        if key != self._pos_key:
            s = self.pos_embed_size
            with torch.no_grad():
                grid = p[:, 1:].float().reshape(1, s, s, self.embed_dim)
                if (ph, pw) != (s, s):
                    grid = resize_pos_embed(grid, ph, pw)
                self._pos = torch.cat(
                    [p[:, :1].float(), grid.reshape(1, ph * pw, -1)], dim=1)
            self._pos_key = key
        return self._pos

    def forward(self, x: torch.Tensor, out_indices: Sequence[int] = (),
                raw_indices: Sequence[int] = ()):
        """out_indices: block outputs with the final norm applied;
        raw_indices: block outputs without it (DepthPro's latents),
        appended after the normed ones.  Class token dropped."""
        B, H, W, _ = x.shape
        ps = self.patch_size
        ph, pw = H // ps, W // ps
        patches = F.conv2d(x.permute(0, 3, 1, 2),
                           cast_param(self.patch_embed.weight, x.dtype),
                           cast_param(self.patch_embed.bias, x.dtype), stride=ps)
        tokens = patches.flatten(2).transpose(1, 2)  # (B, n, C)
        cls = cast_param(self.cls_token, x.dtype).expand(B, 1, self.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1) \
            + self.position_embedding(ph, pw).to(x.dtype)
        keep = set(out_indices) | set(raw_indices)
        outputs = {}
        for i in range(self.depth):
            tokens = getattr(self, f"blocks_{i}")(tokens)
            if i in keep:
                outputs[i] = tokens
        feats = ([layer_norm(outputs[i], self.norm)[:, 1:] for i in out_indices]
                 + [outputs[i][:, 1:] for i in raw_indices])
        return feats, (ph, pw)


VIT_CONFIGS = {
    "vitt": dict(embed_dim=64, depth=2, num_heads=2),  # tests only
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
}
INTERMEDIATE_LAYER_IDX = {
    "vits": [2, 5, 8, 11],
    "vitb": [2, 5, 8, 11],
    "vitl": [4, 11, 17, 23],
}
