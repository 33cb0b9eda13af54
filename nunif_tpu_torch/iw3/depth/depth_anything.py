"""Depth-Anything v1/v2 depth estimator and its iw3 wrapper (counterpart
of ``nunif_tpu/iw3/depth/depth_anything.py``).

``DepthAnything`` is the network (DINOv2 encoder + DPT head, NHWC input
already resized to multiples of 14 and ImageNet-normalised).
``DepthAnythingModel`` is the iw3-facing wrapper: preprocess size, resize
and normalisation, the cast to the compute dtype, flip TTA batched into
one forward pass, edge dilation and metric inversion.
"""
from __future__ import annotations

import functools
import logging
import math

import numpy as np
import torch

from ...models import Model, init_flax_default, register_model, to_flax
from ...modules.resize import resize
from ..dilation import dilate_edge, edge_dilation_is_enabled
from .base import BaseDepthModel
from .dinov2 import INTERMEDIATE_LAYER_IDX, VIT_CONFIGS, DinoVisionTransformer
from .dpt import DPTHead

logger = logging.getLogger("nunif_tpu_torch.iw3")

MIN_RESOLUTION = 224

NAME_MAP = {
    "Any_S": "vits", "Any_B": "vitb", "Any_L": "vitl",
    "Any_V2_S": "v2_vits", "Any_V2_B": "v2_vitb", "Any_V2_L": "v2_vitl",
    "Any_V2_N_S": "hypersim_s", "Any_V2_N_B": "hypersim_b", "Any_V2_N_L": "hypersim_l",
    "Any_V2_K_S": "vkitti_s", "Any_V2_K_B": "vkitti_b", "Any_V2_K_L": "vkitti_l",
    "Any_V2_N": "hypersim_l", "Any_V2_K": "vkitti_l",
    "Distill_Any_S": "distill_any_depth_s",
    "Distill_Any_B": "distill_any_depth_b",
    "Distill_Any_L": "distill_any_depth_l",
}

_DPT_CONFIGS = {
    "vits": dict(features=64, out_channels=(48, 96, 192, 384)),
    "vitb": dict(features=128, out_channels=(96, 192, 384, 768)),
    "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024)),
}

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


@register_model
class DepthAnything(Model):
    """DINOv2 encoder + DPT head; (B, H, W, 3) -> (B, H, W, 1)."""
    model_name = "iw3.depth_anything"

    def __init__(self, encoder: str = "vits", max_depth: float = 0.0):
        super().__init__()
        if encoder not in _DPT_CONFIGS:
            raise ValueError(f"unknown encoder {encoder!r}")
        self.encoder = encoder
        self.max_depth = max_depth
        cfg = VIT_CONFIGS[encoder]
        self.pretrained = DinoVisionTransformer(**cfg)
        self.depth_head = DPTHead(in_dim=cfg["embed_dim"], max_depth=max_depth,
                                  **_DPT_CONFIGS[encoder])

    def forward(self, x, train: bool = False):
        feats, patch_hw = self.pretrained(
            x, out_indices=INTERMEDIATE_LAYER_IDX[self.encoder])
        return self.depth_head(feats, patch_hw)


def shaped_flax_params(model: DepthAnything, seed: int,
                       head: str = "depth_head") -> dict:
    """Seeded random weights in flax layout (numpy, so both packages can be
    given the same arrays) under which the depth map is not degenerate.

    The base draw is flax's init (lecun-normal kernels clipped at 2 std,
    N(0, 0.02) position embedding), with three changes:
    - biases, LayerNorm scales and shifts are drawn N(0, 0.02) around their
      init (0, 1, 0) and the class token N(0, 0.02), so that no path is
      exactly symmetric;
    - LayerScale gammas are 0.1 instead of 1e-5: at 1e-5 the blocks add
      nothing and the features are the patch embedding alone;
    - ``depth_head/output_conv2_2/bias`` is 1.0 and its kernel scaled by
      0.5: the head ends in a ReLU, and at a zero bias about half the
      pixels are clipped to 0 and the normalised depth is half flat.  With
      the shift the ReLU output is positive and varies with the image.
    ``head``: the DPT head's flax name (``head`` in Video Depth Anything).
    """
    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in to_flax(model).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            std = math.sqrt(1.0 / math.prod(ref.shape[:-1])) / 0.8796256610342398
            a = np.clip(rng.standard_normal(ref.shape), -2.0, 2.0) * std
        elif leaf == "scale":
            a = 1.0 + rng.normal(0.0, 0.02, ref.shape)
        elif leaf == "gamma":
            a = np.full(ref.shape, 0.1)
        else:  # bias, cls_token, pos_embed
            a = rng.normal(0.0, 0.02, ref.shape)
        if key == f"{head}/output_conv2_2/bias":
            a = np.ones(ref.shape)
        elif key == f"{head}/output_conv2_2/kernel":
            a = a * 0.5
        flat[key] = a.astype(np.float32)
    return flat


def compute_preprocess_size(H, W, lower_bound=392, max_aspect_ratio=4,
                            limit_resolution=False):
    """Depth input size: the short side scaled to ``lower_bound``, the
    aspect capped, both sides multiples of 14."""
    ensure = 14
    if limit_resolution and lower_bound > min(W, H):
        lower_bound = min(W, H)
        lower_bound -= lower_bound % ensure
        lower_bound = max(lower_bound, MIN_RESOLUTION)
    scale_factor = lower_bound / (W if W < H else H)
    new_h, new_w = int(H * scale_factor), int(W * scale_factor)
    if new_h < new_w:
        new_w = min(new_w, int(max_aspect_ratio * new_h))
    else:
        new_h = min(new_h, int(max_aspect_ratio * new_w))
    new_h -= new_h % ensure
    new_w -= new_w % ensure
    return max(new_h, lower_bound), max(new_w, lower_bound)


def batch_preprocess(x, out_h, out_w):
    """Resize (antialiased bilinear) and ImageNet-normalise; x NHWC [0, 1]."""
    if tuple(x.shape[1:3]) != (out_h, out_w):
        x = resize(x, out_h, out_w, mode="bilinear", antialias=True)
    x = x.clamp(0.0, 1.0)
    mean, std = _imagenet_stats(x.dtype, x.device)
    return (x - mean) / std


@functools.lru_cache(maxsize=8)
def _imagenet_stats(dtype, device):
    return (torch.tensor(_IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(_IMAGENET_STD, dtype=dtype, device=device))


class DepthAnythingModel(BaseDepthModel):
    """iw3-facing wrapper of ``DepthAnything``.

    ``device``: where the network runs (``cuda`` raises without CUDA);
    ``dtype``: its compute dtype (bf16, as the JAX package; fp32 for the
    CPU parity lane).
    """

    def __init__(self, model_type="Any_V2_S", device="cuda",
                 dtype=torch.bfloat16):
        super().__init__(model_type, device=device, dtype=dtype)
        name = NAME_MAP[model_type]
        if name.startswith("hypersim"):
            self.encoder, self.max_depth = "vit" + name[-1], 20.0
        elif name.startswith("vkitti"):
            self.encoder, self.max_depth = "vit" + name[-1], 80.0
        elif name.startswith("distill_any_depth"):
            self.encoder, self.max_depth = "vit" + name[-1], 0.0
        else:
            self.encoder, self.max_depth = name.replace("v2_", ""), 0.0
        self.prep_lower_bound = 392

    @classmethod
    def get_name(cls):
        return "DepthAnything"

    @classmethod
    def supported(cls, model_type):
        return model_type in NAME_MAP

    def is_metric(self):
        return self.max_depth > 0

    def load_model(self, model_type, resolution=None, checkpoint=None,
                   generator=None, **kwargs):
        """``checkpoint``: a ``.nztm`` file; without one the weights are
        flax's init drawn from ``generator`` (default: seed 0)."""
        from ...models import load_model
        self.prep_lower_bound = resolution or 392
        if self.prep_lower_bound % 14 != 0:
            self.prep_lower_bound += 14 - self.prep_lower_bound % 14
        if checkpoint is not None and str(checkpoint).endswith(".pth"):
            raise NotImplementedError(
                "reading raw .pth depth checkpoints is not ported to "
                "nunif_tpu_torch yet (ROADMAP queue 1: the models/torch_convert "
                "path); convert to .nztm with the JAX package first")
        if checkpoint is not None:
            model, _meta = load_model(checkpoint, device=self.device)
            if not isinstance(model, DepthAnything):
                raise ValueError(f"{checkpoint}: not an iw3.depth_anything "
                                 f"checkpoint ({type(model).__name__})")
            return model
        logger.warning("DepthAnything: no checkpoint given; random init "
                       "(structure/benchmark use only)")
        model = DepthAnything(encoder=self.encoder, max_depth=self.max_depth)
        init_flax_default(model, generator or torch.Generator().manual_seed(0))
        return model.eval().requires_grad_(False).to(self.device)

    @torch.no_grad()
    def infer(self, x, tta=False, edge_dilation=0, **kwargs):
        """x (B, H, W, 3) or (H, W, 3) NHWC in [0, 1] -> fp32 depth at the
        preprocess size, (B, h, w, 1)."""
        batch = x.dim() == 4
        if not batch:
            x = x[None]
        B, H, W, _ = x.shape
        out_h, out_w = compute_preprocess_size(
            H, W, self.prep_lower_bound, limit_resolution=self.limit_resolution)
        x = batch_preprocess(x.float(), out_h, out_w).to(self.dtype)
        if tta:
            x = torch.cat([x, x.flip(2)], dim=0)
        out = torch.nan_to_num(self.model(x).float())
        if tta:
            out = (out[:B] + out[B:].flip(2)) * 0.5
        if edge_dilation_is_enabled(edge_dilation):
            if not self.is_metric():
                out = dilate_edge(out, edge_dilation)
            else:
                out = -dilate_edge(-out, edge_dilation)
        if self.is_metric():
            out = -out  # zoedepth-compatible inversion
        return out if batch else out[0]
