"""ZoeDepth, the metric depth estimator, and its iw3 wrapper, NHWC
(counterpart of ``nunif_tpu/iw3/depth/zoedepth.py``).

- ZoeD_N / ZoeD_K: the MiDaS BEiT-L core (``midas.MidasCore``) and a
  metric bins head: seed bin centres from the bottleneck, refined by four
  attractor layers, and the expectation under a conditional log-binomial
  distribution over the bins.
- ZoeD_NK: one core, two bins heads (NYU, KITTI) and a patch-transformer
  router.  Both heads run; the softmax of the router's logits is summed
  over the batch and picks one head for every frame of the batch, so a
  frame's depth depends on the other frames in its batch (as in the JAX
  package; no host read).
- ZoeD_Any_N / ZoeD_Any_K: a Depth-Anything core (DINOv2-L, kernel K7 in
  every block on CUDA, and the DPT head's taps) under the bins head.

The BEiT attention and the router's attention (flax
``MultiHeadDotProductAttention``, head dim 32) are plain PyTorch, as in the
JAX package.  The router rounds where flax does, since its batch vote is
a discrete choice: every Dense and 1x1 Conv rounds its product and then
its bias add; q / sqrt(d) (sqrt(d) rounded first) and the scores round to
x's dtype; the softmax rounds the difference to the max, sums the fp32
exps of it (under jit XLA drops the rounding between the exp and the
reduce) and divides the rounded exp by the rounded sum.  XLA also drops
some other roundings where it fuses (a LayerNorm reads the unrounded sum
of its input's last add), so the two agree to bf16's own error, not
bitwise.  The log-binomial coefficients use ``torch.lgamma`` (correctly
rounded in fp32), where XLA's CPU lgamma is up to 2 ulps away (3e-5 at
lgamma(64)); the logits then differ by 3e-5 / temperature.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.dtypes import cast_param
from ...models import Model, register_model
from ...modules.norm import LayerNorm
from ...modules.pad import crop2d, reflection_pad2d
from ...modules.resize import resize
from ..dilation import dilate_edge, edge_dilation_is_enabled
from .base import BaseDepthModel, load_depth_net
from .dinov2 import INTERMEDIATE_LAYER_IDX, VIT_CONFIGS, DinoVisionTransformer
from .dpt import DPTHead, conv, conv_f32
from .midas import MidasCore


def _resize_ac(x, h, w):
    return resize(x, h, w, mode="bilinear", antialias=False, align_corners=True)


class _Conv2(nn.Module):
    """conv1 (1x1) -> ReLU -> conv2 (1x1), in x's dtype."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, mid, 1)
        self.conv2 = nn.Conv2d(mid, cout, 1)

    def forward(self, x):
        return conv(F.relu(conv(x, self.conv1)), self.conv2)

    def softplus(self, x):
        """softplus of the second conv in fp32 (its sum kept unrounded)."""
        return F.softplus(conv_f32(F.relu(conv(x, self.conv1)), self.conv2))


Projector = _Conv2


class SeedBinRegressorUnnormed(_Conv2):
    """Initial bin centres (softplus, fp32) from the bottleneck."""
    forward = _Conv2.softplus


def inv_attractor(dx, alpha=300.0, gamma=2):
    """dx / (1 + alpha * |dx|^gamma)."""
    return dx / (1.0 + alpha * dx.abs() ** gamma)


class AttractorLayerUnnormed(_Conv2):
    """Moves each bin centre toward K attractors predicted per pixel: dx
    (B, h, w, n_bins, K) in fp32, its inverse attractor meaned over K."""

    def __init__(self, in_dim: int, n_attractors: int, mlp_dim: int = 128,
                 alpha: float = 1000.0, gamma: float = 2.0):
        super().__init__(in_dim, mlp_dim, n_attractors)
        self.alpha, self.gamma = alpha, gamma

    def forward(self, b_embedding, b_prev):
        A = self.softplus(b_embedding)
        hh, ww = A.shape[1:3]
        if tuple(b_prev.shape[1:3]) != (hh, ww):
            b_prev = _resize_ac(b_prev, hh, ww)
        dx = A[..., None, :] - b_prev[..., :, None]
        return b_prev + inv_attractor(dx, self.alpha, self.gamma).mean(-1)


@functools.lru_cache(maxsize=8)
def _log_binomial_coef(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float32)
    coef = (torch.lgamma(torch.tensor(float(n))) - torch.lgamma(k + 1)
            - torch.lgamma(n - k))
    return coef.to(device)


class ConditionalLogBinomial(nn.Module):
    """Per-pixel log-binomial distribution over the bins, conditioned on the
    last decoder feature and the bin embedding; fp32 after the MLP."""

    def __init__(self, in_dim: int, cond_dim: int, n_bins: int = 64,
                 bottleneck: int = 96, p_eps: float = 1e-4,
                 max_temp: float = 50.0, min_temp: float = 1e-7):
        super().__init__()
        self.n_bins, self.p_eps = n_bins, p_eps
        self.max_temp, self.min_temp = max_temp, min_temp
        self.mlp_conv1 = nn.Conv2d(in_dim + cond_dim, bottleneck, 1)
        self.mlp_conv2 = nn.Conv2d(bottleneck, 4, 1)

    def forward(self, x, cond):
        if tuple(cond.shape[1:3]) != tuple(x.shape[1:3]):
            cond = _resize_ac(cond, x.shape[1], x.shape[2])
        h = torch.cat([x, cond.to(x.dtype)], dim=-1)
        h = F.softplus(conv_f32(F.gelu(conv(h, self.mlp_conv1)), self.mlp_conv2))
        p = (h[..., 0] + self.p_eps) / (h[..., 0] + h[..., 1] + 2 * self.p_eps)
        t = (h[..., 2] + 1e-4) / (h[..., 2] + h[..., 3] + 2e-4)
        t = (self.max_temp - self.min_temp) * t + self.min_temp
        n = self.n_bins
        k = torch.arange(n, dtype=torch.float32, device=h.device)
        logits = (_log_binomial_coef(n, h.device)
                  + k * torch.log(p)[..., None]
                  + (n - 1 - k) * torch.log1p(-p)[..., None])
        return torch.softmax(logits / t[..., None], dim=-1)


class MetricBinsHead(nn.Module):
    """Seed bins -> attractor refinement -> log-binomial expectation:
    (rel (B, H, W), taps) -> metric depth (B, H, W, 1) fp32."""

    def __init__(self, n_bins: int = 64, emb_dim: int = 128,
                 btlnck_features: int = 256, core_features: int = 256,
                 n_attractors=(16, 8, 4, 1), attractor_alpha: float = 1000.0,
                 min_temp: float = 0.0212, max_temp: float = 50.0):
        super().__init__()
        bf = btlnck_features
        self.conv2 = nn.Conv2d(core_features, bf, 1)
        self.seed_bin_regressor = SeedBinRegressorUnnormed(bf, bf, n_bins)
        self.seed_projector = Projector(bf, emb_dim, emb_dim)
        for i, k in enumerate(n_attractors):
            self.add_module(f"projectors_{i}", Projector(core_features, emb_dim, emb_dim))
            self.add_module(f"attractors_{i}", AttractorLayerUnnormed(
                emb_dim, k, alpha=attractor_alpha))
        self.conditional_log_binomial = ConditionalLogBinomial(
            33, emb_dim, n_bins, bottleneck=(33 + emb_dim) // 4,
            max_temp=max_temp, min_temp=min_temp)

    def forward(self, rel_depth, features):
        out32, btlnck, *x_blocks = features
        x = conv(btlnck, self.conv2)
        b_centers = self.seed_bin_regressor(x)
        emb = self.seed_projector(x)
        for i, feat in enumerate(x_blocks):
            emb = getattr(self, f"projectors_{i}")(feat)
            b_centers = getattr(self, f"attractors_{i}")(emb, b_centers)
        rel = rel_depth[..., None] if rel_depth.dim() == 3 else rel_depth
        if tuple(rel.shape[1:3]) != tuple(out32.shape[1:3]):
            rel = _resize_ac(rel, out32.shape[1], out32.shape[2])
        last = torch.cat([out32, rel.to(out32.dtype)], dim=-1)
        probs = self.conditional_log_binomial(last, emb)
        if tuple(b_centers.shape[1:3]) != tuple(probs.shape[1:3]):
            b_centers = _resize_ac(b_centers, probs.shape[1], probs.shape[2])
        return (probs * b_centers).sum(-1, keepdim=True)


def _dense_two_roundings(x, layer):
    """flax ``Dense(dtype=x.dtype)`` (or a 1x1 ``Conv``, given an
    ``nn.Conv2d``): the product rounded to x's dtype, then the bias added
    and rounded again.  The router keeps both roundings, since its vote
    picks a head for the batch."""
    w = cast_param(layer.weight, x.dtype)
    return x @ w.reshape(w.shape[0], -1).t() + cast_param(layer.bias, x.dtype)


class DenseGeneral(nn.Module):
    """A flax ``DenseGeneral`` kernel and bias kept in flax layout (``fan_in``
    for ``init_flax_default``)."""

    def __init__(self, kernel_shape, bias_shape, fan_in: int):
        super().__init__()
        self.fan_in = fan_in
        self.weight = nn.Parameter(torch.zeros(kernel_shape))
        self.bias = nn.Parameter(torch.zeros(bias_shape))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(dtype=x.dtype)`` self-attention,
    every step rounded to x's dtype where flax rounds it."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        hd = dim // num_heads
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((dim, num_heads, hd), (num_heads, hd), dim))
        self.out = DenseGeneral((num_heads, hd, dim), (dim,), dim)

    def forward(self, x):
        dt = x.dtype

        def proj(layer):
            y = torch.einsum("bnc,chd->bnhd", x, cast_param(layer.weight, dt))
            return y + cast_param(layer.bias, dt)

        q, k, v = proj(self.query), proj(self.key), proj(self.value)
        depth = q.shape[-1]
        q = q / torch.tensor(math.sqrt(depth), dtype=torch.float32).to(dt)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        # XLA under jit: the exp of the rounded difference stays fp32 for the
        # sum; the quotient is the rounded exp over the rounded sum
        e = torch.exp((s - s.amax(-1, keepdim=True)).float())
        p = e.to(dt) / e.sum(-1, keepdim=True).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return torch.einsum("bqhd,hdc->bqc", o, cast_param(self.out.weight, dt)) \
            + cast_param(self.out.bias, dt)


@functools.lru_cache(maxsize=8)
def sinusoidal_positions(n: int, dim: int) -> np.ndarray:
    pos = np.arange(n)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-math.log(10000.0) / dim))
    pe = np.zeros((n, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)[:, :pe[:, 1::2].shape[1]]
    return pe


class PatchTransformerEncoder(nn.Module):
    """A small transformer over the bottleneck's patches; its class
    embedding routes ZoeD_NK's domain vote."""

    def __init__(self, in_dim: int = 256, emb_dim: int = 128,
                 num_layers: int = 4, num_heads: int = 4):
        super().__init__()
        self.emb_dim, self.num_layers = emb_dim, num_layers
        self.embedding_conv = nn.Conv2d(in_dim, emb_dim, 1)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, emb_dim))
        for i in range(num_layers):
            self.add_module(f"ln1_{i}", LayerNorm(emb_dim))
            self.add_module(f"attn_{i}", MultiHeadDotProductAttention(emb_dim, num_heads))
            self.add_module(f"ln2_{i}", LayerNorm(emb_dim))
            self.add_module(f"fc1_{i}", nn.Linear(emb_dim, emb_dim * 4))
            self.add_module(f"fc2_{i}", nn.Linear(emb_dim * 4, emb_dim))

    def forward(self, x):
        B, H, W, _ = x.shape
        t = _dense_two_roundings(x.reshape(B, H * W, -1), self.embedding_conv)
        cls = cast_param(self.cls_token, t.dtype).expand(B, 1, self.emb_dim)
        t = torch.cat([cls, t], dim=1)
        pe = torch.from_numpy(sinusoidal_positions(t.shape[1], self.emb_dim))
        t = t + pe.to(t.device, t.dtype)[None]
        for i in range(self.num_layers):
            t = t + getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(t))
            h = getattr(self, f"ln2_{i}")(t)
            h = F.relu(_dense_two_roundings(h, getattr(self, f"fc1_{i}")))
            t = t + _dense_two_roundings(h, getattr(self, f"fc2_{i}"))
        return t[:, 0]


class DepthAnythingCore(nn.Module):
    """DINOv2 + DPT head exposing MiDaS-style taps (ZoeD_Any_*)."""

    def __init__(self, encoder: str = "vitl"):
        super().__init__()
        self.encoder = encoder
        cfg = VIT_CONFIGS[encoder]
        self.pretrained = DinoVisionTransformer(**cfg)
        self.depth_head = DPTHead(features=256, out_channels=(256, 512, 1024, 1024),
                                  in_dim=cfg["embed_dim"])

    def forward(self, x):
        feats, patch_hw = self.pretrained(
            x, out_indices=INTERMEDIATE_LAYER_IDX[self.encoder])
        rel, features = self.depth_head(feats, patch_hw, return_features=True)
        return rel[..., 0], features


def _core(core: str):
    if core.startswith("dinov2"):
        return DepthAnythingCore(core.split("_")[1])
    return MidasCore(backbone=core)


@register_model
class ZoeDepthNet(Model):
    """Single-head ZoeDepth (ZoeD_N / K, ZoeD_Any_*).  x (B, H, W, 3)
    normalised (mean / std 0.5), H and W multiples of 32 (BEiT) or 14
    (Depth-Anything core) -> metric depth (B, H, W, 1) fp32."""
    model_name = "iw3.zoedepth"

    def __init__(self, core: str = "beit_l_384", n_bins: int = 64):
        super().__init__()
        self.core_name, self.n_bins = core, n_bins
        self.core = _core(core)
        self.bin_head = MetricBinsHead(n_bins)

    def constructor_kwargs(self):
        # ``core`` is the submodule's name too (the flax tree's)
        return {"core": self.core_name, "n_bins": self.n_bins}

    def forward(self, x, train: bool = False):
        return self.bin_head(*self.core(x))


@register_model
class ZoeDepthNKNet(Model):
    """ZoeD_NK: both bins heads run; the batch's summed router vote picks
    one for every frame (``is_nyu * d_n + (1 - is_nyu) * d_k``)."""
    model_name = "iw3.zoedepth_nk"

    def __init__(self, core: str = "beit_l_384", n_bins: int = 64):
        super().__init__()
        self.core_name, self.n_bins = core, n_bins
        self.core = MidasCore(backbone=core)
        self.patch_transformer = PatchTransformerEncoder()
        self.mlp_classifier_0 = nn.Linear(128, 128)
        self.mlp_classifier_2 = nn.Linear(128, 2)
        self.bin_head_nyu = MetricBinsHead(n_bins)
        self.bin_head_kitti = MetricBinsHead(n_bins)

    constructor_kwargs = ZoeDepthNet.constructor_kwargs

    def router_logits(self, btlnck):
        """(B, 2) fp32: the last Dense's product rounded, its bias add not
        (XLA keeps it unrounded, since the softmax casts it to fp32)."""
        cls_emb = self.patch_transformer(btlnck)
        h = F.relu(_dense_two_roundings(cls_emb, self.mlp_classifier_0))
        dt = h.dtype
        w = cast_param(self.mlp_classifier_2.weight, dt)
        return (h @ w.t()).float() + cast_param(self.mlp_classifier_2.bias, dt).float()

    def forward(self, x, train: bool = False):
        rel, features = self.core(x)
        vote = torch.softmax(self.router_logits(features[1]), dim=-1).sum(0)
        is_nyu = (vote[0] >= vote[1]).float()
        d_n = self.bin_head_nyu(rel, features)
        d_k = self.bin_head_kitti(rel, features)
        return is_nyu * d_n + (1.0 - is_nyu) * d_k


# ---------------------------------------------------------------------------
# the iw3 wrapper
# ---------------------------------------------------------------------------

MODEL_TYPES = {
    "ZoeD_N": ("beit_l_384", "single"),
    "ZoeD_K": ("beit_l_384", "single"),
    "ZoeD_NK": ("beit_l_384", "nk"),
    "ZoeD_Any_N": ("dinov2_vitl", "single"),
    "ZoeD_Any_K": ("dinov2_vitl", "single"),
}
DEPTH_ANYTHING_TYPES = {"ZoeD_Any_N", "ZoeD_Any_K"}


def zoe_preprocess_shape(H, W, h_height, v_height, mod):
    """(frame_h, frame_w, pad_h, pad_w) of the resize and reflection pad."""
    target_height = h_height if W > H else v_height
    if target_height < H:
        new_h = target_height
        new_w = int(new_h / H * W)
        if new_w % mod != 0:
            new_w += mod - new_w % mod
        if new_h % mod != 0:
            new_h += mod - new_h % mod
    else:
        new_h, new_w = H, W
        new_w -= new_w % mod
        new_h -= new_h % mod

    pad_src_h = int((H * 0.5) ** 0.5 * 3)
    pad_src_w = int((W * 0.5) ** 0.5 * 3)
    pad_scale_h = pad_src_h / (H + pad_src_h * 2)
    pad_scale_w = pad_src_w / (W + pad_src_w * 2)
    if new_h > new_w:
        pad_h = round(new_h * pad_scale_h)
        frame_h = new_h - pad_h * 2
        frame_w = int(W * (frame_h / H))
        frame_w += frame_w % 2
        pad_w = (new_h - frame_w) // 2
    else:
        pad_h = round(new_h * pad_scale_h)
        pad_w = round(new_w * pad_scale_w)
        frame_h = new_h - pad_h * 2
        frame_w = new_w - pad_w * 2
    return frame_h, frame_w, pad_h, pad_w


def zoe_preprocess(x, h_height, v_height, mod):
    """x (B, H, W, 3) in [0, 1] -> (antialiased bilinear shrink, reflection
    pad, clip, (x - 0.5) / 0.5; pad_h, pad_w)."""
    B, H, W, _ = x.shape
    frame_h, frame_w, pad_h, pad_w = zoe_preprocess_shape(H, W, h_height, v_height, mod)
    x = resize(x, frame_h, frame_w, mode="bilinear", antialias=True)
    x = reflection_pad2d(x, (pad_w, pad_w, pad_h, pad_h)).clamp(0.0, 1.0)
    return (x - 0.5) / 0.5, pad_h, pad_w


class ZoeDepthModel(BaseDepthModel):
    """iw3-facing wrapper: preprocess, the network in the compute dtype,
    flip TTA in one batch, ``nan_to_num``, the pad cropped, then the
    negated depth (dilated when asked): a disparity-like map.
    ``is_metric()`` is True, so the mapper takes its metric branch."""

    def __init__(self, model_type="ZoeD_N", device="cuda", dtype=torch.bfloat16):
        super().__init__(model_type, device=device, dtype=dtype)
        self.core, self.head_kind = MODEL_TYPES[model_type]
        self.prep_mod = 14 if model_type in DEPTH_ANYTHING_TYPES else 32
        self.prep_h_height = 392 if self.prep_mod == 14 else 384
        self.prep_v_height = 518 if self.prep_mod == 14 else 512

    @classmethod
    def get_name(cls):
        return "ZoeDepth"

    @classmethod
    def supported(cls, model_type):
        return model_type in MODEL_TYPES

    def is_metric(self):
        return True

    def load_model(self, model_type, resolution=None, checkpoint=None,
                   generator=None, **kwargs):
        """``checkpoint``: a ``.nztm`` file (as in the JAX package, no raw
        upstream checkpoint); without one, flax's init drawn from
        ``generator``."""
        if resolution is not None:
            if resolution % self.prep_mod != 0:
                resolution += self.prep_mod - resolution % self.prep_mod
            self.prep_h_height = self.prep_v_height = resolution
        cls = ZoeDepthNKNet if self.head_kind == "nk" else ZoeDepthNet
        return load_depth_net(checkpoint, self.device, cls,
                              lambda: cls(core=self.core), generator=generator)

    @torch.no_grad()
    def infer(self, x, tta=False, edge_dilation=0, **kwargs):
        """x (B, H, W, 3) or (H, W, 3) in [0, 1] -> the negated metric
        depth (B, h, w, 1) fp32 at the preprocessed frame size."""
        batch = x.dim() == 4
        if not batch:
            x = x[None]
        B = x.shape[0]
        xp, pad_h, pad_w = zoe_preprocess(x.float(), self.prep_h_height,
                                          self.prep_v_height, self.prep_mod)
        xp = xp.to(self.dtype)
        if tta:
            xp = torch.cat([xp, xp.flip(2)], dim=0)
        out = torch.nan_to_num(self.model(xp).float())
        if tta:
            out = (out[:B] + out[B:].flip(2)) * 0.5
        out = crop2d(out, (pad_w, pad_w, pad_h, pad_h))
        if edge_dilation_is_enabled(edge_dilation):
            out = dilate_edge(-out, edge_dilation)
        else:
            out = -out
        return out if batch else out[0]
