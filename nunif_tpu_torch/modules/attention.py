"""Swin window-attention blocks on NHWC tensors (counterpart of
``nunif_tpu/modules/attention.py``).

Swin blocks: with ``norm="none"`` the whole block is kernel K1, or K5 on
window-ordered tokens when ``NUNIF_TPU_SWIN_IMG`` is not "1" (as in the JAX
module); with a LayerNorm the block runs on window-ordered tokens and its
attention is kernel K4 (all in ``ops/swin_attention.py``).
``WindowScoreBias`` and ``WindowMHA2d`` (row_flow_v3's and MLBW's
rectangular-window attention) and ``GMLP`` / ``WindowGMLP2d`` /
``WindowGMLP3d`` (the inpaint nets' token mixers, in space and in time)
are plain PyTorch, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import cast_param
from ..ops import _build, swin_attention as _kernels
from .norm import LayerNorm
from .permute import (window_partition2, window_partition3, window_reverse2,
                      window_reverse3)


@functools.lru_cache(maxsize=32)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(wh*ww, wh*ww) index into a ((2wh-1)*(2ww-1),) bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).copy()
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def expand_relative_bias(table: torch.Tensor, ws: int) -> torch.Tensor:
    """(T, heads) bias table -> (heads, N, N) by a plain index gather."""
    n = ws * ws
    idx = torch.from_numpy(relative_position_index(ws, ws).reshape(-1))
    rel = table[idx.to(table.device)]
    return rel.reshape(n, n, -1).permute(2, 0, 1).contiguous()


@functools.lru_cache(maxsize=32)
def shifted_window_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(num_windows, N, N) float32: 0 for pairs in the same region of the
    cyclically shifted image, -100 for pairs that wrapped around."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    nh, nw = h // window, w // window
    wins = img.reshape(nh, window, nw, window).transpose(0, 2, 1, 3)
    wins = wins.reshape(nh * nw, window * window)
    diff = wins[:, :, None] != wins[:, None, :]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def padded_window_key_mask(n_wh: int, n_ww: int, window: int,
                           shift: int) -> np.ndarray:
    """(n_wh*n_ww, 1, N) float32 for the window grid of an image padded by
    ``shift`` top-left and ``window - shift`` bottom-right: -100 for keys
    outside the unpadded image, 0 inside (the JAX kernel's pad-shift
    mask)."""
    t = np.arange(window * window)
    row = np.arange(n_wh)[:, None, None] * window - shift + t // window
    col = np.arange(n_ww)[None, :, None] * window - shift + t % window
    valid = ((row >= 0) & (row < (n_wh - 1) * window)
             & (col >= 0) & (col < (n_ww - 1) * window))
    return np.where(valid, 0.0, -100.0).astype(np.float32).reshape(
        n_wh * n_ww, 1, window * window)


class ShiftedWindowAttention(nn.Module):
    """Swin V1 (shifted-)window MHA with relative position bias (flax path
    ``attn``; reference ``ShiftedWindowAttention``).

    ``forward(x)`` takes an image (B, H, W, C); ``forward(xw, windows=(b,
    nh, nw))`` takes the windows of the rolled image (b*nh*nw, N, C) and
    returns that layout.  qkv and proj are Linear layers; the attention is
    kernel K4 on windows and kernel K6 on the image form, which rolls,
    projects and attends in image layout without a window partition (the
    flow of the JAX package's image-kernel test; its module partitions and
    runs K4, the same function).  The norm-free block reads only the
    parameters: K1 or K5 computes its whole block."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 6,
                 shift_size: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        n_rel = (2 * window_size - 1) ** 2
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(n_rel, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self._rel_key = None
        self._rel_bias = None

    def kernel_layout(self, dtype=None) -> list:
        """[the (heads, N, N) fp32 bias that K4 / K6 read]."""
        return [expand_relative_bias(
            self.relative_position_bias_table.detach().float(), self.window_size)]

    def relative_bias(self) -> torch.Tensor:
        """(heads, N, N) fp32 bias, gathered again only when the table's
        storage or version changes (a weight load).  Under ``torch.export``
        the buffer that ``models/export.py`` registered, else gathered in
        the trace.  While autograd records a table that needs a gradient
        (training), gathered in the graph on every call, so the gradient
        reaches the table."""
        if torch.compiler.is_compiling():
            return (_build.frozen_layout(self) or self.kernel_layout())[0]
        t = self.relative_position_bias_table
        if torch.is_grad_enabled() and t.requires_grad:
            return expand_relative_bias(t.float(), self.window_size)
        key = (t.data_ptr(), t.device, t._version)
        if key != self._rel_key:
            with torch.no_grad():
                self._rel_bias = self.kernel_layout()[0]
            self._rel_key = key
        return self._rel_bias

    def forward(self, x: torch.Tensor, windows=None) -> torch.Tensor:
        ws = self.window_size
        if windows is not None:
            b, nh, nw = windows
            shift = self.shift_size if (nh > 1 or nw > 1) else 0
            out = _kernels.fused_window_attention(
                dense(x, self.qkv), self.relative_bias(),
                num_heads=self.num_heads, window=ws, shift=shift, n_wh=nh,
                n_ww=nw)
            return dense(out, self.proj)
        _b, h, w, _c = x.shape
        shift = self.shift_size if (h > ws or w > ws) else 0
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        out = _kernels.fused_window_attention_image(
            dense(x, self.qkv).contiguous(), self.relative_bias(),
            num_heads=self.num_heads, window=ws, shift=shift)
        out = dense(out, self.proj)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        return out


class MLPBlock(nn.Module):
    """The block MLP, Linear-GELU(exact)-Linear in x's dtype (flax path
    ``mlp``)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(F.gelu(dense(x, self.fc1), approximate="none"), self.fc2)


NORMS = ("none", "layernorm_nobias", "layernorm")


class SwinTransformerBlock(nn.Module):
    """Swin V1 block: x + attn(norm1(x)); x + mlp(norm2(x)).

    ``norm="none"`` (waifu2x swin_unet's default) runs the whole block as
    one K1 launch on CUDA; with ``NUNIF_TPU_SWIN_IMG`` set to anything but
    "1" it runs the JAX module's window path instead: skip add, pad by
    shift / window - shift when shifted, window partition, K5 with the pad
    key mask, window reverse, crop.  With a LayerNorm the block runs as the
    JAX module path does: skip add, roll, window partition, norm1, attention
    (K4), residual, norm2, MLP, residual, window reverse, roll back, the
    stream kept in window order in between."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 6,
                 shift_size: int = 0, mlp_ratio: float = 2.0,
                 norm: str = "none"):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm {norm!r} not in {NORMS}")
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm = norm
        if norm != "none":
            self.norm1 = LayerNorm(dim, use_bias=norm == "layernorm")
            self.norm2 = LayerNorm(dim, use_bias=norm == "layernorm")
        self.attn = ShiftedWindowAttention(dim, num_heads, window_size,
                                           shift_size)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))
        self._packed_key = None
        self._packed = None

    def _weights(self):
        """K1's weight arguments: Dense-shaped matrices, biases, rel bias."""
        a, m = self.attn, self.mlp
        return (a.qkv.weight.t(), a.qkv.bias, a.proj.weight.t(), a.proj.bias,
                m.fc1.weight.t(), m.fc1.bias, m.fc2.weight.t(), m.fc2.bias,
                a.relative_bias())

    def kernel_layout(self, dtype: torch.dtype) -> list:
        """K1 / K5's form of the weights for x of ``dtype``
        (``pack_weights``, as ``packed_list``); [] for a block with a norm,
        which runs K4."""
        if self.norm != "none":
            return []
        return _kernels.packed_list(_kernels.pack_weights(
            *(w.detach() for w in self._weights()), dtype))

    def packed_weights(self, dtype: torch.dtype):
        """K1's form of the weights for x of ``dtype``, packed again only
        when a parameter's storage or version changes (a weight load).
        Under ``torch.export`` the buffers that ``models/export.py``
        registered, or None: the kernel's op then packs them."""
        if torch.compiler.is_compiling():
            return _kernels.packed_of(_build.frozen_layout(self))
        key = (dtype,) + tuple((p.data_ptr(), p.device, p._version)
                               for p in self.parameters())
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = _kernels.packed_of(self.kernel_layout(dtype))
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None):
        """x (B, H, W, C); ``skip`` is added to x before the block."""
        b, h, w, _c = x.shape
        ws = self.window_size
        shift = self.shift_size if (h > ws or w > ws) else 0
        if self.norm == "none":
            # packed weights are the kernel's; the CPU twin reads the raw ones
            packed = self.packed_weights(x.dtype) if x.is_cuda else None
            if os.environ.get("NUNIF_TPU_SWIN_IMG", "1") != "1":
                return self._window_path(x, skip, shift, packed)
            if skip is not None and shift:
                x = x + skip
                skip = None
            return _kernels.fused_swin_block_image(
                x.contiguous(), *self._weights(), num_heads=self.num_heads,
                window=ws, shift=shift, skip=skip, packed=packed)
        if skip is not None:
            x = x + skip
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        xw = window_partition2(x, ws)
        xw = xw + self.attn(self.norm1(xw), windows=(b, h // ws, w // ws))
        xw = xw + self.mlp(self.norm2(xw))
        x = window_reverse2(xw, ws, h, w)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        return x

    def _window_path(self, x, skip, shift, packed):
        """The norm-free block on window-ordered tokens (K5), as
        ``nunif_tpu/modules/attention.py:308-329``."""
        _b, h, w, _c = x.shape
        ws = self.window_size
        if skip is not None:
            x = x + skip
        nh, nw = h // ws, w // ws
        if shift:
            x = F.pad(x, (0, 0, shift, ws - shift, shift, ws - shift))
            nh, nw = nh + 1, nw + 1
        y = _kernels.fused_swin_block(
            window_partition2(x, ws).contiguous(), *self._weights(),
            num_heads=self.num_heads, window=ws, shift=shift, n_wh=nh,
            n_ww=nw, shift_mode="pad", packed=packed)
        y = window_reverse2(y, ws, nh * ws, nw * ws)
        if shift:
            y = y[:, shift:shift + h, shift:shift + w]
        return y.contiguous()


class SwinTransformerBlocks(nn.Module):
    """Stack of blocks with alternating shift; ``skip`` goes to block 0."""

    def __init__(self, dim: int, num_heads: int, num_layers: int,
                 window_size: int = 6, norm: str = "none"):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"block{i}", SwinTransformerBlock(
                dim, num_heads, window_size,
                shift_size=0 if i % 2 == 0 else window_size // 2, norm=norm))

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None):
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x, skip=skip if i == 0 else None)
        return x


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """Linear in x's dtype (fp32 params cast to the compute dtype), as a
    flax ``Dense(dtype=x.dtype)``."""
    bias = None if layer.bias is None else cast_param(layer.bias, x.dtype)
    return F.linear(x, cast_param(layer.weight, x.dtype), bias)


@functools.lru_cache(maxsize=32)
def window_score_bias_input(window_size, device=torch.device("cpu")):
    """(index (n*n,) int64, normalised unique position deltas (u, 2) fp32)
    of a (wh, ww) window (reduction 1), on ``device``."""
    wh, ww = window_size
    n = wh * ww
    pos = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"),
                   axis=2).reshape(n, 2)
    delta = (pos[:, None, :] - pos[None, :, :]).reshape(n * n, 2)
    uniq = sorted({tuple(p) for p in delta.tolist()})
    lookup = {d: i for i, d in enumerate(uniq)}
    index = np.array([lookup[tuple(d)] for d in delta.tolist()], np.int64)
    uniq = np.array(uniq, np.float32)
    return (torch.from_numpy(index).to(device),
            torch.from_numpy(uniq / np.abs(uniq).max()).to(device))


class WindowScoreBias(nn.Module):
    """Learned relative attention score bias of a rectangular window: a
    two-layer GELU MLP on the normalised position deltas (flax paths
    ``to_bias_0``, ``to_bias_2``).  Returns (n, n), or (heads, n, n) when
    ``num_heads`` is set; always fp32."""

    def __init__(self, window_size, hidden_dim=None, num_heads=None):
        super().__init__()
        self.window_size = tuple(window_size)
        wh, ww = self.window_size
        hidden = hidden_dim or int((wh * ww) ** 0.5) * 2
        self.num_heads = num_heads
        self.to_bias_0 = nn.Linear(2, hidden)
        self.to_bias_2 = nn.Linear(hidden, num_heads or 1)

    def forward(self):
        wh, ww = self.window_size
        n = wh * ww
        index, delta = window_score_bias_input(self.window_size,
                                               self.to_bias_0.weight.device)
        delta = delta.to(self.to_bias_0.weight.dtype)
        b = self.to_bias_2(F.gelu(self.to_bias_0(delta)))[index]
        if self.num_heads is None:
            return b.reshape(n, n)
        return b.t().reshape(self.num_heads, n, n)


class WindowMHA2d(nn.Module):
    """Multi-head attention inside (wh, ww) windows, NHWC (flax paths
    ``qkv_proj``, ``head_proj``).  ``shift`` pads by half a window with
    zeros (not a cyclic roll) so windows straddle the original borders.
    bf16 rounding points follow the JAX module: qkv, q * scale, the
    probabilities, the attention output and the head projection."""

    def __init__(self, in_channels: int, num_heads: int, window_size=(4, 4),
                 qkv_dim=None, shift=(False, False)):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        self.shift = tuple(shift)
        self.qkv_dim = qkv_dim or in_channels // num_heads
        self.qkv_proj = nn.Linear(in_channels, self.qkv_dim * num_heads * 3)
        self.head_proj = nn.Linear(self.qkv_dim * num_heads, in_channels)

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        wh, ww = self.window_size
        sh, sw = self.shift
        pad_h = wh // 2 if sh else 0
        pad_w = ww // 2 if sw else 0
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, pad_w, pad_w, pad_h, pad_h))
        B, H, W, C = x.shape
        n, d, heads = wh * ww, self.qkv_dim, self.num_heads
        qkv = dense(window_partition2(x, (wh, ww)), self.qkv_proj)
        q, k, v = (t.reshape(-1, n, heads, d).permute(0, 2, 1, 3)
                   for t in qkv.chunk(3, dim=-1))
        attn = torch.einsum("bhnd,bhmd->bhnm", (q * d ** -0.5).float(),
                            k.float())
        if attn_mask is not None:
            m = attn_mask if attn_mask.dim() == 3 else attn_mask[None]
            attn = attn + m[None].float()
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("bhnm,bhmd->bhnd", attn.float(),
                           v.float()).to(x.dtype)
        out = out.permute(0, 2, 1, 3).reshape(-1, n, heads * d)
        out = window_reverse2(dense(out, self.head_proj), (wh, ww), H, W)
        if pad_h or pad_w:
            out = out[:, pad_h:H - pad_h, pad_w:W - pad_w, :]
        return out


class GMLP(nn.Module):
    """gMLP token mixer on (B, N, C) (flax paths ``proj_in``,
    ``proj_spatial_kernel``, ``proj_spatial_bias``, ``proj_out``): x +
    proj_out(u * (W v + b)), where (u, v) is the split of GELU(exact)
    proj_in(norm1(x)), v goes through norm2, and W (N, N) mixes the tokens.
    In x's dtype."""

    def __init__(self, embed_dim: int, seq_len: int, mlp_ratio: int = 1):
        super().__init__()
        self.embed_dim = embed_dim
        hidden = int(embed_dim * mlp_ratio * 2)
        self.proj_in = nn.Linear(embed_dim, hidden)
        self.proj_spatial_kernel = nn.Parameter(torch.zeros(seq_len, seq_len))
        self.proj_spatial_bias = nn.Parameter(torch.ones(seq_len))
        self.proj_out = nn.Linear(hidden // 2, embed_dim)

    def forward(self, x: torch.Tensor, norm1=None, norm2=None) -> torch.Tensor:
        shortcut = x
        if norm1 is not None:
            x = norm1(x)
        u, v = F.gelu(dense(x, self.proj_in), approximate="none").chunk(2, dim=-1)
        if norm2 is not None:
            v = norm2(v)
        v = torch.einsum("mn,bnc->bmc",
                         cast_param(self.proj_spatial_kernel, v.dtype), v)
        v = v + cast_param(self.proj_spatial_bias, v.dtype)[None, :, None]
        return dense(u * v, self.proj_out) + shortcut


class WindowGMLP2d(nn.Module):
    """``GMLP`` inside square windows of an NHWC image (flax path
    ``gmlp``); ``shift`` pads by half a window with zeros, as
    ``WindowMHA2d`` does."""

    def __init__(self, in_channels: int, window_size: int, mlp_ratio: int = 2,
                 shift: bool = False):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.gmlp = GMLP(in_channels, window_size * window_size, mlp_ratio)

    def forward(self, x: torch.Tensor, norm1=None, norm2=None) -> torch.Tensor:
        ws = self.window_size
        pad = ws // 2 if self.shift else 0
        if pad:
            x = F.pad(x, (0, 0, pad, pad, pad, pad))
        _b, H, W, _c = x.shape
        out = window_reverse2(self.gmlp(window_partition2(x, ws), norm1, norm2),
                              ws, H, W)
        if pad:
            out = out[:, pad:H - pad, pad:W - pad, :]
        return out


class WindowGMLP3d(nn.Module):
    """``GMLP`` inside (wd, wh, ww) windows of an NDHWC clip (flax path
    ``gmlp``); ``shift`` pads by half a window: H and W with zeros, D (the
    frame axis) by reflection."""

    def __init__(self, in_channels: int, window_size=(4, 4, 4),
                 mlp_ratio: int = 2, shift: bool = False):
        super().__init__()
        self.window_size = (tuple(window_size)
                            if isinstance(window_size, (tuple, list))
                            else (window_size,) * 3)
        self.shift = shift
        self.gmlp = GMLP(in_channels, math.prod(self.window_size), mlp_ratio)

    def forward(self, x: torch.Tensor, norm1=None, norm2=None) -> torch.Tensor:
        window = self.window_size
        pd, ph, pw = (s // 2 if self.shift else 0 for s in window)
        if ph or pw:
            x = F.pad(x, (0, 0, pw, pw, ph, ph))
        if pd:
            # reflect-pad the frame axis (torch reflects only trailing axes)
            x = torch.cat([x[:, 1:pd + 1].flip(1), x,
                           x[:, -pd - 1:-1].flip(1)], dim=1)
        _b, D, H, W, _c = x.shape
        out = window_reverse3(self.gmlp(window_partition3(x, window), norm1, norm2),
                              window, D, H, W)
        if pd or ph or pw:
            out = out[:, pd:D - pd, ph:H - ph, pw:W - pw, :]
        return out
