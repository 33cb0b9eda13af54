"""DINOv2 perceptual feature losses (counterpart of
``nunif_tpu/modules/dinov2_loss.py``).

``DINOv2Features`` taps four blocks of the port's DINOv2 ViT
(``iw3/depth/dinov2.py``, the trunk of the depth models): inputs are
reflection-padded to a multiple of 14 and ImageNet-normalized, the trunk
runs in bf16 (every block's attention is kernel K7, ``ops/sdpa.py``, whose
backward is its twin's vector-Jacobian product), the features come back
fp32, optionally through the seeded 64-channel random projection
(``numpy.random.default_rng(0)``, so both packages draw the same matrix).
The loss math is fp32, and the target branch runs without autograd.

``dinov2_feature_loss(kind)``: "pool" (projection, x + 3x3 mean pool, L1)
or "cosine" (full width, 1 - cosine); the mean over the four taps.
``dinov2_with``: base loss + weight * feature loss, waifu2x's
``l1dinov2``, ``l1dinov2_10`` and ``yrgb_lbp_dinov2``.

The trunk's weights are the caller's flax-layout tree; without one it is
the flax initialisation drawn from a seeded ``torch.Generator`` (no
pretrained DINOv2 checkpoint is in the repository), a fixed random feature
projector, which gives a training signal but not the reference's numbers.
"""
from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from ..models import from_flax, init_flax_default
from .pad import reflection_pad2d

logger = logging.getLogger("nunif_tpu_torch.modules.dinov2_loss")

PATCH = 14
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
LAYER_INDEX = {"vits": (2, 5, 8, 11), "vitb": (2, 5, 8, 11),
               "vitl": (4, 11, 17, 23)}
DIMS = {"vits": 384, "vitb": 768, "vitl": 1024}


def pad_to_patch(x):
    """Reflection-pad H, W up to multiples of 14, split evenly."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = (-h) % PATCH, (-w) % PATCH
    if ph or pw:
        x = reflection_pad2d(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return x


def projection_matrix(model_type: str, dim: int) -> np.ndarray:
    """The seeded (C, dim) gaussian 1x1 projection, scaled by C^-0.5 / 14."""
    feat = DIMS[model_type]
    rng = np.random.default_rng(0)
    proj = rng.standard_normal((feat, dim)).astype(np.float32)
    return proj * (feat ** -0.5) * (1.0 / 14.0)


def seeded_trunk_params(model_type: str = "vits", seed: int = 0) -> dict:
    """Seeded numpy weights {flax path: array} for the trunk under which
    every block acts, shared by both packages: kernels N(0, 1 / fan_in),
    norm scales N(1, 0.1), biases, the class token and the position
    embedding N(0, 0.02), LayerScale gammas uniform in [0.1, 0.5] (flax's
    1e-5 leaves the blocks, and so the attention, out of the features;
    a pretrained DINOv2 ViT-S's gammas are of this order)."""
    from ..iw3.depth.dinov2 import VIT_CONFIGS, DinoVisionTransformer
    from ..models import to_flax
    rng = np.random.default_rng(seed)
    out = {}
    for key, ref in to_flax(DinoVisionTransformer(**VIT_CONFIGS[model_type])).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            a = rng.standard_normal(ref.shape) / np.sqrt(np.prod(ref.shape[:-1]))
        elif leaf == "scale":
            a = rng.normal(1.0, 0.1, ref.shape)
        elif leaf == "gamma":
            a = rng.uniform(0.1, 0.5, ref.shape)
        else:
            a = rng.normal(0.0, 0.02, ref.shape)
        out[key] = a.astype(np.float32)
    return out


class DINOv2Features:
    """Frozen intermediate-feature extractor: x (B, H, W, 3) with H, W
    multiples of 14 -> four (B, H / 14, W / 14, C) fp32 maps.

    ``params``: a flax-layout tree {path: array} of the trunk; None draws
    flax's initialisation from seed 0.  ``dtype``: the trunk's compute
    dtype (bf16, the JAX module's; fp32 only on the CPU, where the tests
    hold the gradient to JAX's).  The trunk moves to the device of its
    first input."""

    def __init__(self, model_type="vits", index=None, random_projection=None,
                 params=None, dtype=torch.bfloat16):
        from ..iw3.depth.dinov2 import VIT_CONFIGS, DinoVisionTransformer
        self.model = DinoVisionTransformer(**VIT_CONFIGS[model_type])
        self.index = tuple(index) if index else LAYER_INDEX[model_type]
        self.dtype = dtype
        if params is None:
            logger.warning("DINOv2Features: seeded random trunk (no pretrained "
                           "DINOv2 checkpoint in the repository)")
            init_flax_default(self.model, torch.Generator().manual_seed(0))
        else:
            from_flax(self.model, params)
        self.model.eval().requires_grad_(False)
        self.proj_np = (projection_matrix(model_type, random_projection)
                        if random_projection else None)
        self.proj = None

    def _to(self, device):
        if next(self.model.parameters()).device != device:
            self.model.to(device)
            self.proj = None
        if self.proj_np is not None and self.proj is None:
            self.proj = torch.from_numpy(self.proj_np).to(device)

    def __call__(self, x):
        self._to(x.device)
        feats, (ph, pw) = self.model(x.to(self.dtype), out_indices=self.index)
        feats = [f.float().reshape(f.shape[0], ph, pw, f.shape[-1])
                 for f in feats]
        if self.proj is not None:
            feats = [torch.einsum("bhwc,cd->bhwd", f, self.proj) for f in feats]
        return feats


def normalize_in(x):
    mean = torch.tensor(_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def cosine_loss(a, b):
    a32, b32 = a.float(), b.float()
    num = torch.sum(a32 * b32, dim=-1)
    den = torch.linalg.vector_norm(a32, dim=-1) * torch.linalg.vector_norm(b32, dim=-1)
    return torch.mean(1.0 - num / torch.clamp(den, min=1e-8))


def pool_l1_loss(a, b, kernel_size=3):
    """L1 of x + mean_pool(x) (stride 1, SAME, padded cells not counted)."""
    def pool(x):
        p = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel_size, stride=1,
                         padding=kernel_size // 2, count_include_pad=False)
        return x + p.permute(0, 2, 3, 1)
    return torch.mean(torch.abs(pool(a) - pool(b)))


def dinov2_feature_loss(kind="pool", model_type="vits", normalize=True,
                        params=None, dtype=torch.bfloat16):
    """fn(x, y): the mean over the four taps of the "pool" (64-channel
    projection, pooled L1) or "cosine" loss; the target branch without
    autograd."""
    extractor = DINOv2Features(
        model_type=model_type,
        random_projection=64 if kind == "pool" else None,
        params=params, dtype=dtype)
    inner = pool_l1_loss if kind == "pool" else cosine_loss

    def wrapped(x, y):
        x, y = pad_to_patch(x), pad_to_patch(y)
        if normalize:
            x, y = normalize_in(x), normalize_in(y)
        fx = extractor(x)
        with torch.no_grad():
            fy = extractor(y)
        total = sum(inner(a, b) for a, b in zip(fx, fy))
        return total / len(fx)
    wrapped.extractor = extractor
    return wrapped


def dinov2_with(base_loss, kind="pool", weight=1.0, model_type="vits",
                params=None, dtype=torch.bfloat16):
    """base_loss(x, y) + weight * the DINOv2 feature loss."""
    feat = dinov2_feature_loss(kind=kind, model_type=model_type,
                               params=params, dtype=dtype)

    def wrapped(x, y):
        return base_loss(x, y) + weight * feat(x, y)
    wrapped.extractor = feat.extractor
    return wrapped
