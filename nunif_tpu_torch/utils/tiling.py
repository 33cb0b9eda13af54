"""Tiled inference with seam blending (counterpart of
``nunif_tpu/utils/tiling.py``), eager PyTorch.

The grid math (``make_tile_config``, ``make_blend_filter``) is the JAX
package's, so both packages cut the same tiles.  The blend is sum(w*y) /
sum(w) on an fp32 canvas.  A single-tile grid skips the canvas (the weights
cancel).  Where the tile geometry aligns with the model's pre-shuffle factor,
tiles are blended in the head's (H/s, W/s, C*s*s) layout and the sub-pixel
reorder runs once, after uint8 quantization; where it does not align, the
model shuffles itself and the blend runs at full resolution.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.dtypes import DEFAULT_POLICY, Policy


@dataclasses.dataclass(frozen=True)
class TileConfig:
    scale: int
    offset: int
    tile_h: int
    tile_w: int
    blend_size: int
    h_blocks: int
    w_blocks: int
    input_tile_step_h: int
    input_tile_step_w: int
    output_tile_step_h: int
    output_tile_step_w: int
    pad: tuple  # (left, right, top, bottom) on the input
    y_h: int
    y_w: int
    y_buffer_h: int
    y_buffer_w: int

    @property
    def n_tiles(self) -> int:
        return self.h_blocks * self.w_blocks

    @property
    def out_tile_h(self) -> int:
        return self.tile_h * self.scale - self.offset * 2

    @property
    def out_tile_w(self) -> int:
        return self.tile_w * self.scale - self.offset * 2


def _as_hw(tile_size):
    if isinstance(tile_size, (tuple, list)):
        return int(tile_size[0]), int(tile_size[1])
    return int(tile_size), int(tile_size)


def make_tile_config(height: int, width: int, scale: int, offset: int,
                     tile_size, blend_size: int) -> TileConfig:
    """Tile grid for an image; ``tile_size`` is an int or (tile_h, tile_w)."""
    tile_h, tile_w = _as_hw(tile_size)
    input_offset = math.ceil(offset / scale)
    input_blend_size = math.ceil(blend_size / scale)
    step_h = tile_h - (input_offset * 2 + input_blend_size)
    step_w = tile_w - (input_offset * 2 + input_blend_size)
    if step_h <= 0 or step_w <= 0:
        raise ValueError("tile_size too small for offset/blend")

    h_blocks = w_blocks = input_h = input_w = 0
    while input_h < height + input_offset * 2:
        input_h = h_blocks * step_h + tile_h
        h_blocks += 1
    while input_w < width + input_offset * 2:
        input_w = w_blocks * step_w + tile_w
        w_blocks += 1

    return TileConfig(
        scale=scale, offset=offset, tile_h=tile_h, tile_w=tile_w,
        blend_size=blend_size,
        h_blocks=h_blocks, w_blocks=w_blocks,
        input_tile_step_h=step_h, input_tile_step_w=step_w,
        output_tile_step_h=step_h * scale,
        output_tile_step_w=step_w * scale,
        pad=(input_offset, input_w - (width + input_offset),
             input_offset, input_h - (height + input_offset)),
        y_h=height * scale, y_w=width * scale,
        y_buffer_h=input_h * scale, y_buffer_w=input_w * scale,
    )


def make_blend_filter(scale: int, offset: int, tile_size,
                      blend_size: int) -> np.ndarray:
    """(out_tile_h, out_tile_w) fp32 weights: 1 inside, ramping down
    linearly over ``blend_size`` border pixels."""
    tile_h, tile_w = _as_hw(tile_size)
    out_h = tile_h * scale - offset * 2
    out_w = tile_w * scale - offset * 2

    def ramp(n):
        r = np.ones((n,), dtype=np.float32)
        for i in range(blend_size):
            value = 1.0 - (1.0 / (blend_size + 1)) * (i + 1)
            d = blend_size - 1 - i
            r[d] = value
            r[n - 1 - d] = value
        return r
    return np.minimum(ramp(out_h)[:, None], ramp(out_w)[None, :])


def edge_pad(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Replicate-pad the H and W axes of (..., H, W, C)."""
    h, w = x.shape[-3], x.shape[-2]
    rows = torch.arange(-top, h + bottom, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=x.device).clamp(0, w - 1)
    return x.index_select(-3, rows).index_select(-2, cols)


_DTYPES = {"uint8": torch.uint8, "uint16": torch.uint16,
           "float32": torch.float32}


def _quantize(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.uint8:
        return torch.round(y * 255.0).to(torch.uint8)
    if dtype == torch.uint16:
        return torch.round(y * 65535.0).to(torch.uint16)
    return y


class TiledRenderer:
    """Render arbitrarily sized images through an I2I model by tiles.

    The model holds its weights and runs on its parameters' device; tiles go
    through it in batches of ``batch_size`` in the policy's compute dtype.
    """

    def __init__(self, model, policy: Policy = DEFAULT_POLICY):
        self.model = model
        self.policy = policy

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _tile_hw(self, tile_size):
        model = self.model
        if isinstance(tile_size, (tuple, list)):
            return (model.find_valid_tile_size(tile_size[0]),
                    model.find_valid_tile_size(tile_size[1]))
        t = model.find_valid_tile_size(tile_size)
        return (t, t)

    def _ps_factor(self, cfg: TileConfig, tile_hw) -> int:
        """Pre-shuffle factor s > 1 when the model can emit its head layout
        and every tile and step aligns to s; 1 otherwise (the model then
        shuffles itself)."""
        model = self.model
        if (not hasattr(model, "pre_shuffle_output") or model.i2i_scale <= 1
                or model.i2i_offset % model.i2i_scale):
            return 1
        s = int(getattr(model, "i2i_ps_factor", model.i2i_scale))
        aligned = (cfg.out_tile_h % s == 0 and cfg.out_tile_w % s == 0
                   and cfg.output_tile_step_h % s == 0
                   and cfg.output_tile_step_w % s == 0)
        return s if aligned else 1

    def _apply(self, xb: torch.Tensor, ps: int) -> torch.Tensor:
        if hasattr(self.model, "pre_shuffle_output"):
            return self.model(xb, pre_shuffle=ps > 1)
        return self.model(xb)

    def _render_padded(self, xp: torch.Tensor, cfg: TileConfig, tile_hw,
                       batch_size: int, out_channels: int, ps: int):
        """xp (F, Hp, Wp, C) fp32, padded to the grid.  Returns the clipped
        fp32 canvas (F, Hb/s, Wb/s, C_out*s*s) — for a single tile the tile
        output itself — which covers the (y_h, y_w) extent."""
        dt = self.policy.compute_dtype
        s = ps
        n_frames = xp.shape[0]
        if cfg.n_tiles == 1:
            return self._apply(xp.to(dt), s).float().clamp(0.0, 1.0)

        th, tw = tile_hw
        origins = [(i * cfg.input_tile_step_h, j * cfg.input_tile_step_w)
                   for i in range(cfg.h_blocks) for j in range(cfg.w_blocks)]
        n = len(origins)
        tiles = torch.stack([xp[f, oy:oy + th, ox:ox + tw]
                             for f in range(n_frames) for oy, ox in origins])
        outs = torch.cat([self._apply(tiles[i:i + batch_size].to(dt), s).float()
                          for i in range(0, len(tiles), batch_size)])
        outs = outs.reshape(n_frames, n, *outs.shape[1:])

        blend = torch.from_numpy(make_blend_filter(
            cfg.scale, cfg.offset, tile_hw, cfg.blend_size)).to(xp.device)
        oth, otw = cfg.out_tile_h // s, cfg.out_tile_w // s
        # blend weights in head-channel order: channel c*s*s + dy*s + dx
        # carries blend[y*s + dy, x*s + dx]
        b2 = blend.reshape(oth, s, otw, s).permute(0, 2, 1, 3).reshape(
            oth, otw, s * s)
        blend_c = b2.repeat(1, 1, out_channels)
        pixels = torch.zeros((n_frames, cfg.y_buffer_h // s,
                              cfg.y_buffer_w // s, out_channels * s * s),
                             dtype=torch.float32, device=xp.device)
        weights = torch.zeros((cfg.y_buffer_h // s, cfg.y_buffer_w // s, s * s),
                              dtype=torch.float32, device=xp.device)
        for t, (oy, ox) in enumerate(origins):
            y0, x0 = oy * cfg.scale // s, ox * cfg.scale // s
            pixels[:, y0:y0 + oth, x0:x0 + otw] += outs[:, t] * blend_c
            weights[y0:y0 + oth, x0:x0 + otw] += b2
        wfull = weights.repeat(1, 1, out_channels)
        return (pixels / wfull.clamp_min(1e-6)).clamp(0.0, 1.0)

    @torch.inference_mode()
    def render(self, x, tile_size=None, batch_size=None) -> torch.Tensor:
        """x (H, W, C) float in [0, 1] -> (H*scale, W*scale, C_out) fp32 on
        the model's device.  ``tile_size``: int or (tile_h, tile_w)."""
        model = self.model
        tile_hw = self._tile_hw(tile_size)
        batch_size = int(batch_size or model.i2i_default_batch_size)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        h, w, c = x.shape
        cfg = make_tile_config(h, w, model.i2i_scale, model.i2i_offset,
                               tile_hw, model.i2i_blend_size)
        left, right, top, bottom = cfg.pad
        xp = edge_pad(x, top, bottom, left, right)[None]
        out_channels = getattr(model, "out_channels", c)
        y = self._render_padded(xp, cfg, tile_hw, batch_size, out_channels, 1)
        return y[0, :cfg.y_h, :cfg.y_w, :]

    def frame_program(self, h: int, w: int, c: int = 3, tile_size=None,
                      batch_size=None, in_dtype="uint8", out_dtype="uint8",
                      frame_batch: int = 1):
        """Fixed-geometry render: pad -> tiles -> model -> blend -> crop ->
        quantize, uint8 in and out by default.

        Returns ``program(frame)``: (h, w, c) -> (h*scale, w*scale, C_out),
        or with ``frame_batch`` > 1 (fb, h, w, c) -> (fb, h*scale, w*scale,
        C_out); the frame may be a tensor or an ndarray, and the result is a
        tensor on the model's device.  The JAX program also takes the params;
        here they live in the model.
        """
        model = self.model
        tile_hw = self._tile_hw(tile_size)
        batch_size = int(batch_size or model.i2i_default_batch_size)
        cfg = make_tile_config(h, w, model.i2i_scale, model.i2i_offset,
                               tile_hw, model.i2i_blend_size)
        left, right, top, bottom = cfg.pad
        out_channels = getattr(model, "out_channels", c)
        ps = self._ps_factor(cfg, tile_hw)
        fb = int(frame_batch)
        in_dt, out_dt = _DTYPES[in_dtype], _DTYPES[out_dtype]

        @torch.inference_mode()
        def program(frame):
            x = torch.as_tensor(frame, device=self.device)
            if x.dtype != in_dt:
                raise TypeError(f"frame dtype {x.dtype}, program takes {in_dt}")
            expect = (h, w, c) if fb == 1 else (fb, h, w, c)
            if tuple(x.shape) != expect:
                raise ValueError(f"frame shape {tuple(x.shape)} != {expect}")
            if fb == 1:
                x = x[None]
            if in_dt == torch.uint8:
                x = x.float() * (1.0 / 255.0)
            elif in_dt == torch.uint16:
                x = x.float() * (1.0 / 65535.0)
            x = edge_pad(x, top, bottom, left, right)
            y = self._render_padded(x, cfg, tile_hw, batch_size,
                                    out_channels, ps)
            if ps > 1:
                y = _quantize(y, out_dt)
                hs, ws_ = y.shape[1], y.shape[2]
                y = y.reshape(fb, hs, ws_, out_channels, ps, ps)
                y = y.permute(0, 1, 4, 2, 5, 3).reshape(
                    fb, hs * ps, ws_ * ps, out_channels)
                y = y[:, :cfg.y_h, :cfg.y_w, :]
            else:
                y = _quantize(y[:, :cfg.y_h, :cfg.y_w, :], out_dt)
            y = y.contiguous()
            return y if fb > 1 else y[0]

        return program


@torch.inference_mode()
def simple_render(x, model, policy: Policy = DEFAULT_POLICY) -> torch.Tensor:
    """Whole-image render, replicate-padded by ceil(offset/scale) so the
    output is H*scale.  x (H, W, C) or (B, H, W, C) on the model's device."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    if model.i2i_offset > 0:
        p = math.ceil(model.i2i_offset / model.i2i_scale)
        x = edge_pad(x, p, p, p, p)
    y = model(x.to(policy.compute_dtype)).float()
    return y[0] if squeeze else y
