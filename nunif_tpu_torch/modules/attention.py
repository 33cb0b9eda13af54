"""Swin window-attention blocks on NHWC tensors (counterpart of
``nunif_tpu/modules/attention.py``).

Swin blocks: only ``norm="none"`` is ported: its whole block is kernel K1
(``ops/swin_attention.py``).  Blocks with a LayerNorm need the attention-only
kernel K4, which is not ported yet.  ``WindowScoreBias`` and ``WindowMHA2d``
(row_flow_v3's rectangular-window attention) are plain PyTorch, as the JAX
package leaves them to XLA.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtypes import cast_param
from ..ops import swin_attention as _k1


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


class WindowAttention(nn.Module):
    """Parameters of the Swin V1 window attention (flax path ``attn``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 6):
        super().__init__()
        n_rel = (2 * window_size - 1) ** 2
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(n_rel, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class MLP(nn.Module):
    """Parameters of the block MLP, Linear-GELU-Linear (flax path ``mlp``)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinTransformerBlock(nn.Module):
    """Swin V1 block with norm="none": x + attn(x); x + mlp(x), in one K1
    launch on CUDA (its plain twin on the CPU)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 6,
                 shift_size: int = 0, mlp_ratio: float = 2.0,
                 norm: str = "none"):
        super().__init__()
        if norm != "none":
            raise NotImplementedError(
                f"SwinTransformerBlock(norm={norm!r}) needs the window-attention "
                "kernel K4, which is not ported yet")
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.mlp = MLP(dim, int(dim * mlp_ratio))
        self._rel_key = None
        self._rel_bias = None
        self._packed_key = None
        self._packed = None

    def relative_bias(self) -> torch.Tensor:
        """(heads, N, N) fp32 bias, gathered again only when the table's
        storage or version changes (a weight load)."""
        t = self.attn.relative_position_bias_table
        key = (t.data_ptr(), t.device, t._version)
        if key != self._rel_key:
            with torch.no_grad():
                self._rel_bias = expand_relative_bias(
                    t.detach().float(), self.window_size)
            self._rel_key = key
        return self._rel_bias

    def _weights(self):
        """K1's weight arguments: Dense-shaped matrices, biases, rel bias."""
        a, m = self.attn, self.mlp
        return (a.qkv.weight.t(), a.qkv.bias, a.proj.weight.t(), a.proj.bias,
                m.fc1.weight.t(), m.fc1.bias, m.fc2.weight.t(), m.fc2.bias,
                self.relative_bias())

    def packed_weights(self, dtype: torch.dtype):
        """The kernel's form of the weights for x of ``dtype``, packed again
        only when a parameter's storage or version changes (a weight load)."""
        key = (dtype,) + tuple((p.data_ptr(), p.device, p._version)
                               for p in self.parameters())
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = _k1.pack_weights(
                    *(w.detach() for w in self._weights()), dtype)
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None):
        """x (B, H, W, C); ``skip`` is added to x before the block."""
        _b, h, w, _c = x.shape
        ws = self.window_size
        shift = self.shift_size if (h > ws or w > ws) else 0
        if skip is not None and shift:
            x = x + skip
            skip = None
        # packed weights are the kernel's; the CPU twin reads the raw ones
        packed = self.packed_weights(x.dtype) if x.is_cuda else None
        return _k1.fused_swin_block_image(
            x.contiguous(), *self._weights(), num_heads=self.num_heads,
            window=ws, shift=shift, skip=skip, packed=packed)


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
        from .permute import window_partition2, window_reverse2
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
