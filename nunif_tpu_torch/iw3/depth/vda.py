"""Video Depth Anything (VDA), the temporal depth estimator (counterpart of
``nunif_tpu/iw3/depth/vda.py``), NHWC.

The network is Depth-Anything's DINOv2 encoder (kernel K7 in every block,
on CUDA) and DPT head with four temporal "motion modules": levels 2 and 3
of the resize pyramid and fusion paths 4 and 3 each go through an
AnimateDiff-style transformer over the frame axis (sinusoidal positions,
two attention blocks, a GEGLU feed-forward, a zero-initialised output
projection).  The temporal attention is plain PyTorch with fp32 scores, as
the JAX package leaves it to XLA.

- ``VideoDepthAnythingModel`` (``VDA_*``) runs windows of 32 frames that
  overlap by 10: the output lags the input by up to a window; each window's
  output is aligned (least squares, scale and shift) to the previous
  window's on the shared frames; ``flush_with_normalize`` pads the last
  window by repeating its last frame.
- ``VideoDepthAnythingStreamingModel`` (``VDA_Stream_*``) has no lag: each
  motion module keeps ring buffers of the last 32 frames' attention inputs,
  and a new frame attends to them.  A batch runs the encoder and every
  head stage once over all its frames, and only the motion modules frame
  by frame.
"""
from __future__ import annotations

import logging
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models import Model, init_flax_default, register_model
from ...modules.attention import dense
from ...modules.norm import LayerNorm
from ...modules.pad import crop2d, reflection_pad2d
from ..dilation import dilate_edge, edge_dilation_is_enabled
from .base import BaseDepthModel
from .depth_anything import batch_preprocess, compute_preprocess_size
from .dinov2 import INTERMEDIATE_LAYER_IDX, VIT_CONFIGS, DinoVisionTransformer
from .dpt import DPTHead

logger = logging.getLogger("nunif_tpu_torch.iw3")

NAME_MAP = {
    "VDA_S": "vits", "VDA_B": "vitb", "VDA_L": "vitl",
    "VDA_Metric": "vitl",
    "VDA_Metric_S": "vits", "VDA_Metric_B": "vitb", "VDA_Metric_L": "vitl",
}
STREAM_NAME_MAP = {
    "VDA_Stream_S": "vits", "VDA_Stream_B": "vitb", "VDA_Stream_L": "vitl",
    "VDA_Stream_Metric_S": "vits", "VDA_Stream_Metric_B": "vitb",
    "VDA_Stream_Metric_L": "vitl",
}
METRIC_DEPTH_TYPES = {
    "VDA_Metric", "VDA_Metric_S", "VDA_Metric_B", "VDA_Metric_L",
    "VDA_Stream_Metric_S", "VDA_Stream_Metric_B", "VDA_Stream_Metric_L",
}
METRIC_PADDING = 14  # reflection padding of the metric models' input
INFER_LEN = 32       # frames in a window
OVERLAP = 10         # frames shared by consecutive windows

_DPT_CONFIGS = {
    "vits": dict(features=64, out_channels=(48, 96, 192, 384)),
    "vitb": dict(features=128, out_channels=(96, 192, 384, 768)),
    "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024)),
}


def sinusoidal_pe(T: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal positional table (T, dim)."""
    pos = np.arange(T, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64)
                 * (-math.log(10000.0) / dim))
    pe = np.zeros((T, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)[:, : pe[:, 1::2].shape[1]]
    return pe


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm`` on NHWC: statistics over (H, W, C / G) in fp32
    with the fast variance E[x^2] - E[x]^2, the result rounded once to x's
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        g = x.float().reshape(B, H * W, self.num_groups, C // self.num_groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = ((g * g).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        G = self.num_groups
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(G, C // G)
        y = (g - mean) * mul + self.bias.reshape(G, C // G)
        return y.reshape(B, H, W, C).to(x.dtype)


class TemporalAttention(nn.Module):
    """Multi-head attention over the frame axis: q (B, Tq, C), kv (B, Tk,
    C); ``mask`` (Tk,) bool, True where a key is valid."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, q_in, kv_in, mask=None):
        B, Tq, _ = q_in.shape
        Tk = kv_in.shape[1]
        hd = self.dim // self.num_heads

        def heads(t, n):
            return t.reshape(B, n, self.num_heads, hd).transpose(1, 2)
        q = heads(dense(q_in, self.to_q), Tq)
        k = heads(dense(kv_in, self.to_k), Tk)
        v = heads(dense(kv_in, self.to_v), Tk)
        # fp32 scores of the compute-dtype operands, softmax in fp32
        scores = torch.matmul((q * (hd ** -0.5)).float(), k.float().transpose(-1, -2))
        if mask is not None:
            scores = scores.masked_fill(~mask, -1e30)
        attn = torch.softmax(scores, dim=-1).to(q_in.dtype)
        out = torch.matmul(attn.float(), v.float()).to(q_in.dtype)
        return dense(out.transpose(1, 2).reshape(B, Tq, self.dim), self.to_out)


class TemporalModule(nn.Module):
    """AnimateDiff-style temporal transformer on a feature map.

    ``forward(x)``: x (B, T, H, W, C), attention over all T frames.
    ``forward(x, cache)``: x (B, 1, H, W, C), the new frame attends to ring
    buffers of the previous frames' attention inputs; returns (out, the new
    cache).  The buffers are left-aligned: while they fill, the new frame
    goes to index n (so its position matches window mode for the first
    ``max_len`` frames); once full they shift by one and the new frame
    takes the last slot."""

    def __init__(self, dim: int, num_heads: int = 8, max_len: int = INFER_LEN):
        super().__init__()
        self.dim, self.num_heads, self.max_len = dim, num_heads, max_len
        self.norm = GroupNorm(min(32, dim), dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.attn1_norm = LayerNorm(dim)
        self.attn2_norm = LayerNorm(dim)
        self.attn1 = TemporalAttention(dim, num_heads)
        self.attn2 = TemporalAttention(dim, num_heads)
        self.ff_norm = LayerNorm(dim)
        # GEGLU feed-forward
        self.ff_proj = nn.Linear(dim, dim * 8)
        self.ff_out = nn.Linear(dim * 4, dim)
        self.proj_out = nn.Linear(dim, dim)
        self._pe = {}

    def pe(self, T, dtype, device):
        key = (T, dtype, device)
        if key not in self._pe:
            self._pe[key] = torch.from_numpy(
                sinusoidal_pe(self.max_len, self.dim)[:T]).to(device, dtype)
        return self._pe[key]

    def ff(self, t):
        a, g = dense(self.ff_norm(t), self.ff_proj).chunk(2, dim=-1)
        # the gate in fp32, rounded once (as XLA fuses it)
        u = a.float() * F.gelu(g.float(), approximate="none")
        return dense(u.to(t.dtype), self.ff_out)

    @staticmethod
    def _norm_pe(norm, t, pe):
        """norm(t) + pe in fp32, rounded once (as XLA fuses it)."""
        return (norm(t.float()) + pe.float()).to(t.dtype)

    def forward(self, x, cache=None):
        B, T, H, W, C = x.shape
        h = dense(self.norm(x.reshape(B * T, H, W, C)), self.proj_in)
        # (B, T, H, W, C) -> (B*H*W, T, C): the frame axis inner
        h = h.reshape(B, T, H * W, C).transpose(1, 2).reshape(B * H * W, T, C)
        new_cache = None
        if cache is None:
            pe = self.pe(T, x.dtype, x.device)
            a = self._norm_pe(self.attn1_norm, h, pe)
            h = h + self.attn1(a, a)
            a = self._norm_pe(self.attn2_norm, h, pe)
            h = h + self.attn2(a, a)
        else:
            if T != 1:
                raise ValueError("a streaming step takes one frame")
            ring1, ring2, n = cache["ring1"], cache["ring2"], cache["n"]
            Tc = ring1.shape[1]
            full, idx = n >= Tc, min(n, Tc - 1)
            valid = torch.arange(Tc, device=x.device) <= idx
            pe = self.pe(Tc, x.dtype, x.device)

            def push(ring, new):
                ring = torch.roll(ring, -1, dims=1) if full else ring.clone()
                ring[:, idx] = new[:, 0]
                return ring
            ring1 = push(ring1, h)
            h = h + self.attn1(self._norm_pe(self.attn1_norm, h, pe[idx]),
                               self._norm_pe(self.attn1_norm, ring1, pe), mask=valid)
            ring2 = push(ring2, h)
            h = h + self.attn2(self._norm_pe(self.attn2_norm, h, pe[idx]),
                               self._norm_pe(self.attn2_norm, ring2, pe), mask=valid)
            new_cache = {"ring1": ring1, "ring2": ring2, "n": min(n + 1, Tc)}
        h = dense(h + self.ff(h), self.proj_out)
        h = h.reshape(B, H * W, T, C).transpose(1, 2).reshape(B, T, H, W, C)
        out = x + h
        return out if cache is None else (out, new_cache)


def _lvl3_hw(ph, pw):
    """Output size of the stride-2 ``resize_3`` conv (k 3, s 2, p 1)."""
    return (ph - 1) // 2 + 1, (pw - 1) // 2 + 1


class DPTHeadTemporal(DPTHead):
    """The DPT head with a motion module after levels 2 and 3 and after
    fusion paths 4 and 3.  ``forward(feats, patch_hw, T)`` runs a window of
    T frames (feats: 4 token maps (B*T, N, C)) -> (B, T, H, W, 1); with
    ``caches`` (T == 1) it returns (depth, new caches)."""

    def __init__(self, features: int, out_channels, in_dim: int,
                 max_depth: float = 0.0, num_frames: int = INFER_LEN):
        super().__init__(features, out_channels, in_dim, max_depth=max_depth)
        dims = (out_channels[2], out_channels[3], features, features)
        for i, d in enumerate(dims):
            self.add_module(f"motion_modules_{i}",
                            TemporalModule(d, max_len=num_frames))

    def motion(self, i, x, cache=None):
        return getattr(self, f"motion_modules_{i}")(x, cache=cache)

    def mid(self, levels):
        """Levels (after motions 0 and 1) -> (rn, fusion path 4)."""
        rn = self.rn(levels)
        return rn, self.refinenet4(rn[3], out_hw=rn[2].shape[1:3])

    def p3(self, p4, rn2, out_hw):
        return self.refinenet3(p4, rn2, out_hw=out_hw)

    def forward(self, feats, patch_hw, T, caches=None):
        ph, pw = patch_hw
        BT = feats[0].shape[0]
        B = BT // T
        new_caches = [None] * 4

        def motion(i, x):
            t = x.reshape(B, T, *x.shape[1:])
            if caches is None:
                t = self.motion(i, t)
            else:
                t, new_caches[i] = self.motion(i, t, caches[i])
            return t.reshape(BT, *x.shape[1:])

        levels = self.levels(feats, patch_hw)
        levels[2] = motion(0, levels[2])
        levels[3] = motion(1, levels[3])
        rn, p4 = self.mid(levels)
        p3 = self.p3(motion(2, p4), rn[2], rn[1].shape[1:3])
        out = self.final(motion(3, p3), rn[1], rn[0], patch_hw)
        out = out.reshape(B, T, ph * 14, pw * 14, 1)
        return out if caches is None else (out, new_caches)


@register_model
class VideoDepthAnything(Model):
    """The VDA network.  x (B, T, H, W, 3) preprocessed and normalised, H
    and W multiples of 14 -> depth or disparity (B, T, H, W, 1)."""
    model_name = "iw3.video_depth_anything"

    def __init__(self, encoder: str = "vits", max_depth: float = 0.0,
                 num_frames: int = INFER_LEN):
        super().__init__()
        if encoder not in _DPT_CONFIGS:
            raise ValueError(f"unknown encoder {encoder!r}")
        self.encoder, self.max_depth, self.num_frames = encoder, max_depth, num_frames
        cfg = VIT_CONFIGS[encoder]
        self.pretrained = DinoVisionTransformer(**cfg)
        self.head = DPTHeadTemporal(in_dim=cfg["embed_dim"], max_depth=max_depth,
                                    num_frames=num_frames, **_DPT_CONFIGS[encoder])

    def encode(self, x):
        """Frames (N, H, W, 3) -> (4 token maps, patch grid)."""
        return self.pretrained(x, out_indices=INTERMEDIATE_LAYER_IDX[self.encoder])

    def forward(self, x, caches=None, train: bool = False):
        B, T, H, W, _ = x.shape
        feats, patch_hw = self.encode(x.reshape(B * T, H, W, 3))
        return self.head(feats, patch_hw, T, caches=caches)

    def init_caches(self, B, H, W, dtype=torch.bfloat16, device="cpu"):
        """Empty streaming ring buffers for inputs of H x W."""
        ph, pw = H // 14, W // 14
        l3h, l3w = _lvl3_hw(ph, pw)
        cfg = _DPT_CONFIGS[self.encoder]
        specs = [(ph * pw, cfg["out_channels"][2]),
                 (l3h * l3w, cfg["out_channels"][3]),
                 (ph * pw, cfg["features"]),
                 (2 * ph * 2 * pw, cfg["features"])]
        return [{"ring1": torch.zeros((B * n, self.num_frames, c), dtype=dtype,
                                      device=device),
                 "ring2": torch.zeros((B * n, self.num_frames, c), dtype=dtype,
                                      device=device),
                 "n": 0}
                for n, c in specs]


def zero_motion_out(model: VideoDepthAnything):
    """The motion modules' output projections at flax's init (zeros): a
    fresh module adds nothing, so VDA starts as per-frame Depth-Anything."""
    with torch.no_grad():
        for i in range(4):
            getattr(model.head, f"motion_modules_{i}").proj_out.weight.zero_()


def shaped_flax_params(model: VideoDepthAnything, seed: int) -> dict:
    """Seeded random weights in flax layout under which the depth map is
    not flat and the temporal path acts: ``depth_anything.
    shaped_flax_params``'s draw, whose lecun-normal kernels include the
    motion modules' ``proj_out`` (flax's init makes those zero, and VDA
    then equals per-frame Depth-Anything)."""
    from .depth_anything import shaped_flax_params as shaped
    return shaped(model, seed, head="head")


# ---------------------------------------------------------------------------
# pre- and postprocessing
# ---------------------------------------------------------------------------

def vda_preprocess(x, lower_bound, metric_depth, limit_resolution=False):
    """x (B, H, W, 3) in [0, 1] -> resized, normalised, and
    reflection-padded by ``METRIC_PADDING`` for the metric models."""
    _B, H, W, _ = x.shape
    if metric_depth:
        out_h, out_w = compute_preprocess_size(
            H, W, lower_bound - METRIC_PADDING * 2,
            limit_resolution=limit_resolution)
        x = reflection_pad2d(batch_preprocess(x, out_h, out_w),
                             (METRIC_PADDING,) * 4)
    else:
        out_h, out_w = compute_preprocess_size(
            H, W, lower_bound, limit_resolution=limit_resolution)
        x = batch_preprocess(x, out_h, out_w)
    return x


def vda_postprocess(out, edge_dilation, metric_depth, force_disparity=True,
                    max_dist=None):
    """Raw net output (B, H, W, 1) -> fp32 depth in the disparity
    convention (metric depth as 1 / (d + 0.1) unless ``force_disparity``
    is off, then negated as ZoeDepth's)."""
    out = torch.nan_to_num(out.float())
    if max_dist is not None:
        out = out.clamp(max=max_dist)
    if metric_depth and force_disparity:
        out = 1.0 / (out + 0.1)
    if metric_depth:
        out = crop2d(out, (METRIC_PADDING,) * 4)
    is_disparity = (not metric_depth) or force_disparity
    if edge_dilation_is_enabled(edge_dilation):
        out = (dilate_edge(out, edge_dilation) if is_disparity
               else -dilate_edge(-out, edge_dilation))
    return out if is_disparity else -out


def align_scale_shift(new, ref, eps=1e-6):
    """Least-squares (s, t), fp32 tensors on the inputs' device, so that
    new * s + t fits ref; s = 1 where it is not finite or not above eps."""
    x = new.reshape(-1).float()
    y = ref.reshape(-1).float()
    mx, my = x.mean(), y.mean()
    vx = x - mx
    s = (vx * (y - my)).sum() / ((vx * vx).sum() + eps)
    s = torch.where(s.isfinite() & (s > eps), s, torch.ones_like(s))
    t = my - s * mx
    t = torch.where(t.isfinite(), t, torch.zeros_like(t))
    return s, t


# ---------------------------------------------------------------------------
# iw3-facing wrappers
# ---------------------------------------------------------------------------

class _VDACommon(BaseDepthModel):
    def __init__(self, model_type, name_map, window_size, device, dtype):
        super().__init__(model_type, device=device, dtype=dtype)
        self.encoder = name_map[model_type]
        self.metric_depth = model_type in METRIC_DEPTH_TYPES
        self.force_disparity = True
        self.prep_lower_bound = 392
        self.window_size = window_size

    def is_metric(self):
        return self.metric_depth and not self.force_disparity

    def is_image_supported(self):
        return False

    def load_model(self, model_type, resolution=None, checkpoint=None,
                   generator=None, **kwargs):
        """``checkpoint``: a ``.nztm`` file; without one the weights are
        flax's init drawn from ``generator`` (default: seed 0), the motion
        modules' output projections zero."""
        from ...models import load_model
        self.prep_lower_bound = resolution or 392
        if self.prep_lower_bound % 14 != 0:
            self.prep_lower_bound += 14 - self.prep_lower_bound % 14
        if checkpoint is not None:
            model, _meta = load_model(checkpoint, device=self.device)
            if not isinstance(model, VideoDepthAnything):
                raise ValueError(f"{checkpoint}: not an iw3.video_depth_anything "
                                 f"checkpoint ({type(model).__name__})")
            return model
        logger.warning("VideoDepthAnything: no checkpoint given; random init "
                       "(structure/benchmark use only)")
        model = VideoDepthAnything(encoder=self.encoder,
                                   max_depth=20.0 if self.metric_depth else 0.0,
                                   num_frames=self.window_size)
        init_flax_default(model, generator or torch.Generator().manual_seed(0))
        zero_motion_out(model)
        return model.eval().requires_grad_(False).to(self.device)

    def _preprocess(self, x):
        return vda_preprocess(x.float(), self.prep_lower_bound, self.metric_depth,
                              limit_resolution=self.limit_resolution)

    def _postprocess(self, out, edge_dilation):
        return vda_postprocess(out, edge_dilation=edge_dilation,
                               metric_depth=self.metric_depth,
                               force_disparity=self.force_disparity)


class VideoDepthAnythingModel(_VDACommon):
    """Windowed VDA.  The output lags the input by up to a window: feed it
    through ``infer_with_normalize`` and end with ``flush_with_normalize``
    (``video.Iw3FrameProcessor`` does)."""

    def __init__(self, model_type="VDA_S", window_size=INFER_LEN,
                 overlap=OVERLAP, device="cuda", dtype=torch.bfloat16):
        super().__init__(model_type, NAME_MAP, window_size, device, dtype)
        self.overlap = min(overlap, max(window_size - 1, 1))
        self.reset_state()

    @classmethod
    def get_name(cls):
        return "VideoDepthAnything"

    @classmethod
    def supported(cls, model_type):
        return model_type in NAME_MAP

    def reset_state(self):
        self._pending = []  # preprocessed frames (H, W, 3) of the next window
        self._ctx_in = []   # the last `overlap` inputs of the previous window
        self._ctx_out = []  # their aligned raw outputs

    def window_forward(self, frames):
        """Preprocessed frames (T, H, W, 3) -> raw outputs (T, H, W, 1) fp32."""
        return self.model(frames.to(self.dtype)[None])[0].float()

    def _run_window(self):
        """One window (the context, the pending frames, the last frame
        repeated up to the window); the aligned raw outputs of the pending
        frames."""
        n_ctx, n_new = len(self._ctx_in), len(self._pending)
        frames = self._ctx_in + self._pending
        frames = frames + [frames[-1]] * (self.window_size - len(frames))
        out = self.window_forward(torch.stack(frames))
        if n_ctx:
            s, t = align_scale_shift(out[:n_ctx], torch.stack(self._ctx_out))
            out = out * s + t
        new_out = list(out[n_ctx:n_ctx + n_new])
        keep = min(self.overlap, n_ctx + n_new)
        self._ctx_in = (self._ctx_in + self._pending)[-keep:]
        self._ctx_out = (self._ctx_out + new_out)[-keep:]
        self._pending = []
        return new_out

    def _emit(self, raw_frames, edge_dilation):
        """Postprocess and EMA-normalise raw output frames."""
        if not raw_frames:
            return []
        out = self._postprocess(torch.stack(raw_frames), edge_dilation)
        return self.scaler.update_batch(out)

    @torch.no_grad()
    def infer_with_normalize(self, x, pts=None, reset_pts=(), edge_dilation=0,
                             **kwargs):
        """x (B, H, W, 3) in [0, 1] -> the normalised depth frames that are
        ready (possibly none).  After a frame whose pts is in ``reset_pts``
        everything so far is flushed and the state reset."""
        B = x.shape[0]
        pts = list(range(B)) if pts is None else list(pts)
        reset_pts = set(reset_pts)
        x = self._preprocess(x)
        outputs = []
        for i in range(B):
            self._pending.append(x[i])
            if len(self._pending) >= self.window_size - len(self._ctx_in):
                outputs += self._emit(self._run_window(), edge_dilation)
            if pts[i] in reset_pts:
                outputs += self.flush_with_normalize(edge_dilation=edge_dilation)
                self.reset()
        return outputs

    @torch.no_grad()
    def flush_with_normalize(self, edge_dilation=0, **kwargs):
        outputs = []
        if self._pending:
            outputs += self._emit(self._run_window(), edge_dilation)
        outputs += self.flush_minmax_normalize()
        self.reset_state()
        return outputs

    @torch.no_grad()
    def infer(self, x, edge_dilation=0, **kwargs):
        """A whole clip (B, H, W, 3) (or one frame) as one window of B frames,
        no alignment: fp32 depth."""
        batch = x.dim() == 4
        if not batch:
            x = x[None]
        self.reset_state()
        out = self._postprocess(self.window_forward(self._preprocess(x)),
                                edge_dilation)
        return out if batch else out[0]


class VideoDepthAnythingStreamingModel(_VDACommon):
    """Streaming VDA: no output lag; the temporal context lives in the
    motion modules' ring buffers (``reset_state`` clears them)."""

    # infer carries state from call to call (Iw3FrameProcessor routes
    # stateful models to its lagged path, split at scene cuts)
    stateful_inference = True

    def __init__(self, model_type="VDA_Stream_S", window_size=INFER_LEN,
                 device="cuda", dtype=torch.bfloat16):
        super().__init__(model_type, STREAM_NAME_MAP, window_size, device, dtype)
        self.reset_state()

    @classmethod
    def get_name(cls):
        return "VideoDepthAnythingStreaming"

    @classmethod
    def supported(cls, model_type):
        return model_type in STREAM_NAME_MAP

    def reset_state(self):
        self._caches = None
        self._cache_hw = None

    def _motion_frames(self, i, seq):
        """Motion module i over frames (T, h, w, c), one step a frame."""
        head, out = self.model.head, []
        for t in range(seq.shape[0]):
            y, self._caches[i] = head.motion(i, seq[t][None, None], self._caches[i])
            out.append(y[0, 0])
        return torch.stack(out)

    def stream(self, frames):
        """Preprocessed frames (T, H, W, 3) -> raw outputs (T, H, W, 1) fp32:
        the encoder and the head's stages batched over the T frames, the
        motion modules frame by frame."""
        h, w = frames.shape[1:3]
        if self._caches is None or self._cache_hw != (h, w):
            self._caches = self.model.init_caches(1, h, w, dtype=self.dtype,
                                                  device=frames.device)
            self._cache_hw = (h, w)
        head = self.model.head
        feats, patch_hw = self.model.encode(frames.to(self.dtype))
        levels = head.levels(feats, patch_hw)
        levels[2] = self._motion_frames(0, levels[2])
        levels[3] = self._motion_frames(1, levels[3])
        rn, p4 = head.mid(levels)
        p3 = head.p3(self._motion_frames(2, p4), rn[2], rn[1].shape[1:3])
        out = head.final(self._motion_frames(3, p3), rn[1], rn[0], patch_hw)
        return out.float()

    @torch.no_grad()
    def infer(self, x, edge_dilation=0, **kwargs):
        """x (B, H, W, 3) or (H, W, 3) in [0, 1] -> fp32 depth, no lag."""
        batch = x.dim() == 4
        if not batch:
            x = x[None]
        out = self._postprocess(self.stream(self._preprocess(x)), edge_dilation)
        return out if batch else out[0]
