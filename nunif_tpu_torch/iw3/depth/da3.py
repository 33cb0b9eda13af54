"""Depth-Anything-V3 monocular depth and its iw3 wrapper, NHWC (counterpart
of ``nunif_tpu/iw3/depth/da3.py``).

The network is a DINOv2 trunk (kernel K7 in every block on CUDA) and a DPT
head with a 2-channel output: softplus depth and sigmoid sky.
``da3_disparity`` turns them into a sky-weighted disparity (shift 0.2, sky
faded out, frames with fewer than 10 non-sky pixels zeroed), or, with
``raw_output``, into depth whose sky is filled with the 0.99 quantile of
the non-sky depth.  ``Any_V3_Mono`` normalises by the max only,
``Any_V3_Mono_01`` by min-max.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...models import Model, register_model
from ..depth_scaler import EMAMinMaxScaler
from ..dilation import dilate_edge, edge_dilation_is_enabled
from .base import BaseDepthModel, load_depth_net
from .depth_anything import batch_preprocess, compute_preprocess_size
from .dinov2 import INTERMEDIATE_LAYER_IDX, VIT_CONFIGS, DinoVisionTransformer
from .dpt import DPTHead

NAME_MAP = {
    "Any_V3_Mono": "da3mono-large",
    "Any_V3_Mono_01": "da3mono-large",
}
_DPT_CONFIGS = {
    "vits": dict(features=64, out_channels=(48, 96, 192, 384)),
    "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024)),
}
# torch.nanquantile sorts at most 2^24 elements a row
QUANTILE_MAX_ROW = 2 ** 24


@register_model
class DepthAnythingV3Mono(Model):
    """x (B, H, W, 3) preprocessed and normalised -> {"depth", "sky"}
    (B, H, W) fp32: positive distance and a sky probability."""
    model_name = "iw3.da3_mono"

    def __init__(self, encoder: str = "vitl"):
        super().__init__()
        self.encoder = encoder
        cfg = VIT_CONFIGS[encoder]
        self.pretrained = DinoVisionTransformer(**cfg)
        self.depth_head = DPTHead(in_dim=cfg["embed_dim"], out_dim=2,
                                  **_DPT_CONFIGS[encoder])

    def forward(self, x, train: bool = False):
        feats, patch_hw = self.pretrained(
            x, out_indices=INTERMEDIATE_LAYER_IDX[self.encoder])
        out = self.depth_head(feats, patch_hw)
        return {"depth": F.softplus(out[..., 0]), "sky": torch.sigmoid(out[..., 1])}


def da3_disparity(depth, sky, sky_thresh=0.3, raw_output=False, shift=0.2):
    """depth, sky (B, H, W) -> (B, H, W, 1) fp32."""
    depth, sky = depth.float(), sky.float()
    sky_mask = sky > sky_thresh
    sky_weight = (sky.clamp(sky_thresh, 1.0) - sky_thresh) / (1.0 - sky_thresh)
    all_sky = ((~sky_mask).sum(dim=(1, 2)) < 10)[:, None, None]
    if not raw_output:
        disp = (1.0 / (depth + shift)) * (1.0 - sky_weight)
        disp = torch.where(all_sky, torch.zeros_like(disp), disp)
    else:
        rows = torch.where(sky_mask, torch.full_like(depth, float("nan")), depth)
        rows = rows.reshape(depth.shape[0], -1)
        if rows.shape[1] > QUANTILE_MAX_ROW:
            raise ValueError(
                f"da3_disparity(raw_output=True): {rows.shape[1]} pixels an image; "
                f"torch.nanquantile takes at most {QUANTILE_MAX_ROW}")
        q = torch.nan_to_num(torch.nanquantile(rows, 0.99, dim=1))[:, None, None]
        disp = torch.minimum(depth * (1.0 - sky_weight) + sky_weight * q, q)
        disp = torch.where(all_sky, depth, disp)
    return disp[..., None]


class DepthAnythingV3MonoModel(BaseDepthModel):
    """iw3-facing wrapper: preprocess as Depth-Anything, the network in the
    compute dtype, ``da3_disparity``, ``nan_to_num``, flip TTA, then the edge
    dilation (on the negated map with ``raw_output``).  The DepthAA
    post-filter is not ported."""

    def __init__(self, model_type="Any_V3_Mono", raw_output=False,
                 device="cuda", dtype=torch.bfloat16):
        self.model_type = model_type  # read by create_depth_scaler
        super().__init__(model_type, device=device, dtype=dtype)
        self.encoder = "vitl"
        self.prep_lower_bound = 392
        self.raw_output = raw_output

    def create_depth_scaler(self):
        mode = "max" if self.model_type == "Any_V3_Mono" else "minmax"
        return EMAMinMaxScaler(decay=0, buffer_size=1, mode=mode)

    @classmethod
    def get_name(cls):
        return "DepthAnythingV3Mono"

    @classmethod
    def supported(cls, model_type):
        return model_type in NAME_MAP

    def is_metric(self):
        return False

    def load_model(self, model_type, resolution=None, checkpoint=None,
                   raw_output=None, generator=None, **kwargs):
        """``checkpoint``: a ``.nztm`` file or a raw ``.pth`` / ``.pt`` /
        ``.safetensors`` of the upstream layout; without one, flax's init
        drawn from ``generator``."""
        from ...models.torch_convert import convert_da3mono
        if raw_output is not None:
            self.raw_output = raw_output
        self.prep_lower_bound = resolution or 392
        if self.prep_lower_bound % 14 != 0:
            self.prep_lower_bound += 14 - self.prep_lower_bound % 14
        build = lambda: DepthAnythingV3Mono(encoder=self.encoder)  # noqa: E731
        return load_depth_net(
            checkpoint, self.device, DepthAnythingV3Mono, build,
            lambda sd: (build(), convert_da3mono(sd, self.encoder)), generator)

    @torch.no_grad()
    def infer(self, x, tta=False, edge_dilation=0, **kwargs):
        """x (B, H, W, 3) or (H, W, 3) in [0, 1] -> (B, h, w, 1) fp32 at the
        preprocess size."""
        batch = x.dim() == 4
        if not batch:
            x = x[None]
        B, H, W, _ = x.shape
        out_h, out_w = compute_preprocess_size(
            H, W, self.prep_lower_bound, limit_resolution=self.limit_resolution)
        x = batch_preprocess(x.float(), out_h, out_w).to(self.dtype)
        if tta:
            x = torch.cat([x, x.flip(2)], dim=0)
        out = self.model(x)
        out = torch.nan_to_num(da3_disparity(out["depth"], out["sky"],
                                             raw_output=self.raw_output))
        if tta:
            out = (out[:B] + out[B:].flip(2)) * 0.5
        # the net set_depth_aa set (the JAX wrapper reads an attribute
        # nothing sets: ROADMAP queue 3)
        out = self.apply_depth_aa(out)
        if edge_dilation_is_enabled(edge_dilation):
            if not self.raw_output:
                out = dilate_edge(out, edge_dilation)
            else:
                out = -dilate_edge(-out, edge_dilation)
        return out if batch else out[0]
