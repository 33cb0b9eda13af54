"""DepthPro, the multi-scale monocular depth estimator, and its iw3
wrapper, NHWC (counterpart of ``nunif_tpu/iw3/depth/depth_pro.py``).

The input (S x S, S = 4 x tile) makes a three-level pyramid (bilinear, no
antialias): 5 x 5 overlapping tiles at full size (stride 0.75 tile), 3 x 3
at half size (stride 0.5 tile) and the quarter-size image, 35 tiles a
frame.  One patch ViT (DINOv2-L at patch 16) runs once over all 35 x B
tiles, so every block is one K7 launch at (35 B, 16, 577, 64) on CUDA; an
image ViT and the field-of-view ViT run on the quarter image.  Tiles are
merged by cropping their overlap (no averaging).  Project-upsample blocks,
a multi-resolution conv decoder and the head give the canonical inverse
depth; the FOV network gives the field of view, and the wrapper turns both
into a disparity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...models import Model, register_model
from ...modules.attention import dense
from ...modules.resize import resize
from ..dilation import dilate_edge, edge_dilation_is_enabled
from .base import BaseDepthModel, load_depth_net
from .dinov2 import VIT_CONFIGS, DinoVisionTransformer
from .dpt import conv, conv_f32, conv_transpose

# wrapper: the ViT tile size of each type
NAME_MAP = {"DepthPro": 384, "DepthPro_S": 256}
DIMS_ENCODER = (256, 512, 1024, 1024)
HOOK_BLOCK_IDS = (5, 11)
DECODER_FEATURES = 256


def _split_tiles(x, tile: int, stride: int):
    """Row-major tile grid stacked on the batch axis as [tile 0 of every
    frame, tile 1 of every frame, ...]; (tiles, steps)."""
    size = x.shape[1]
    steps = (size - tile + stride - 1) // stride + 1 if size > tile else 1
    tiles = [x[:, j * stride:j * stride + tile, i * stride:i * stride + tile]
             for j in range(steps) for i in range(steps)]
    return torch.cat(tiles, dim=0), steps


def _merge_tiles(feats, B: int, steps: int, padding: int):
    """The inverse of ``_split_tiles`` on feature maps: interior edges lose
    ``padding`` tokens, then the tiles are concatenated."""
    rows = []
    idx = 0
    for j in range(steps):
        row = []
        for i in range(steps):
            t = feats[B * idx:B * (idx + 1)]
            h, w = t.shape[1:3]
            t = t[:, padding if j else 0:h - padding if j != steps - 1 else h,
                  padding if i else 0:w - padding if i != steps - 1 else w]
            row.append(t)
            idx += 1
        rows.append(torch.cat(row, dim=2))
    return torch.cat(rows, dim=1)


class _ProjectUpsample(nn.Module):
    """1x1 conv (no bias), then N 2x2 stride-2 transposed convs (no bias)."""

    def __init__(self, dim_in: int, dim_int: int, dim_out: int, upsample_layers: int):
        super().__init__()
        self.n = upsample_layers
        self.proj = nn.Conv2d(dim_in, dim_int, 1, bias=False)
        for i in range(upsample_layers):
            self.add_module(f"up{i}", nn.ConvTranspose2d(
                dim_int if i == 0 else dim_out, dim_out, 2, stride=2, bias=False))

    def forward(self, x):
        x = conv(x, self.proj)
        for i in range(self.n):
            x = conv_transpose(x, getattr(self, f"up{i}"), 2)
        return x


class _ResidualBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3)
        self.conv2 = nn.Conv2d(features, features, 3)

    def forward(self, x):
        h = conv(F.relu(x), self.conv1, padding=1)
        return x + conv(F.relu(h), self.conv2, padding=1)


class _FusionBlock(nn.Module):
    """Optional skip (``resnet1``), ``resnet2``, optional 2x transposed conv,
    1x1 out conv."""

    def __init__(self, features: int, fuse: bool = True, deconv: bool = True):
        super().__init__()
        if fuse:
            self.resnet1 = _ResidualBlock(features)
        self.resnet2 = _ResidualBlock(features)
        if deconv:
            self.deconv = nn.ConvTranspose2d(features, features, 2, stride=2, bias=False)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x0, x1=None):
        x = x0 if x1 is None else x0 + self.resnet1(x1)
        x = self.resnet2(x)
        if hasattr(self, "deconv"):
            x = conv_transpose(x, self.deconv, 2)
        return conv(x, self.out_conv)


@register_model
class DepthPro(Model):
    """x (B, S, S, 3), S = 4 x tile_size, normalised (mean / std 0.5) ->
    (canonical inverse depth (B, S, S, 1) fp32, field of view in degrees
    (B,) fp32)."""
    model_name = "iw3.depth_pro"

    def __init__(self, encoder: str = "vitl", tile_size: int = 384,
                 use_fov_head: bool = True, pos_embed_size: int = 24):
        super().__init__()
        self.encoder, self.tile_size = encoder, tile_size
        self.use_fov_head, self.pos_embed_size = use_fov_head, pos_embed_size
        cfg = dict(VIT_CONFIGS[encoder], patch_size=16, pos_embed_size=pos_embed_size)
        C = cfg["embed_dim"]
        depth = cfg["depth"]
        self.hooks = HOOK_BLOCK_IDS if depth > max(HOOK_BLOCK_IDS) else (0, depth - 1)
        d0, d1, d2, d3 = DIMS_ENCODER if encoder == "vitl" else (C // 4, C // 2, C, C)
        df = DECODER_FEATURES if encoder == "vitl" else C // 4
        self.patch_encoder = DinoVisionTransformer(**cfg)
        self.image_encoder = DinoVisionTransformer(**cfg)
        self.upsample_latent0 = _ProjectUpsample(C, d0, df, 3)
        self.upsample_latent1 = _ProjectUpsample(C, d0, d0, 2)
        self.upsample0 = _ProjectUpsample(C, d1, d1, 1)
        self.upsample1 = _ProjectUpsample(C, d2, d2, 1)
        self.upsample2 = _ProjectUpsample(C, d3, d3, 1)
        self.upsample_lowres = nn.ConvTranspose2d(C, d3, 2, stride=2)
        self.fuse_lowres = nn.Conv2d(2 * d3, d3, 1)
        for i, cin in ((1, d0), (2, d1), (3, d2), (4, d3)):
            self.add_module(f"conv{i}", nn.Conv2d(cin, df, 3, bias=False))
        for i in range(5):
            self.add_module(f"fusion{i}", _FusionBlock(df, fuse=i != 4, deconv=i != 0))
        self.head_conv0 = nn.Conv2d(df, df // 2, 3)
        self.head_up1 = nn.ConvTranspose2d(df // 2, df // 2, 2, stride=2)
        self.head_conv2 = nn.Conv2d(df // 2, 32, 3)
        self.head_conv4 = nn.Conv2d(32, 1, 1)
        if use_fov_head:
            self.fov_encoder = DinoVisionTransformer(**cfg)
            self.fov_proj = nn.Linear(C, df // 2)
            self.fov_downsample = nn.Conv2d(df, df // 2, 3)
            self.fov_head0 = nn.Conv2d(df // 2, df // 4, 3)
            self.fov_head2 = nn.Conv2d(df // 4, df // 8, 3)
            self.fov_head4 = nn.Conv2d(df // 8, 1, 6)

    def forward(self, x, train: bool = False):
        B, S = x.shape[0], x.shape[1]
        p = self.tile_size
        if S != 4 * p:
            raise ValueError(f"DepthPro takes {4 * p} x {4 * p} inputs, got {S}")
        grid = p // 16
        depth = self.patch_encoder.depth
        C = self.patch_encoder.embed_dim

        x1 = resize(x, S // 2, S // 2, mode="bilinear", antialias=False)
        x2 = resize(x, S // 4, S // 4, mode="bilinear", antialias=False)
        hi, n_hi = _split_tiles(x, p, int(p * 0.75))
        mid, n_mid = _split_tiles(x1, p, p // 2)
        tiles = torch.cat([hi, mid, x2], dim=0)          # (35 B, p, p, 3)
        final, lat0, lat1 = (f.reshape(-1, grid, grid, C) for f in self.patch_encoder(
            tiles, out_indices=(depth - 1,), raw_indices=self.hooks)[0])
        bh = B * n_hi * n_hi
        bm = bh + B * n_mid * n_mid
        # half the tiles' overlap cropped at each interior edge
        p_hi, p_mid = grid // 8, grid // 4
        x_lat0 = _merge_tiles(lat0[:bh], B, n_hi, p_hi)
        x_lat1 = _merge_tiles(lat1[:bh], B, n_hi, p_hi)
        x0_f = _merge_tiles(final[:bh], B, n_hi, p_hi)
        x1_f = _merge_tiles(final[bh:bm], B, n_mid, p_mid)
        x2_f = final[bm:]
        g = self.image_encoder(x2, out_indices=(depth - 1,))[0][0].reshape(B, grid, grid, C)

        x_lat0 = self.upsample_latent0(x_lat0)
        x_lat1 = self.upsample_latent1(x_lat1)
        x0_f = self.upsample0(x0_f)
        x1_f = self.upsample1(x1_f)
        x2_f = self.upsample2(x2_f)
        g = conv_transpose(g, self.upsample_lowres, 2)
        g = conv(torch.cat([x2_f, g], dim=-1), self.fuse_lowres)

        f = conv(g, self.conv4, padding=1)
        lowres_features = f
        f = self.fusion4(f)
        f = self.fusion3(f, conv(x1_f, self.conv3, padding=1))
        f = self.fusion2(f, conv(x0_f, self.conv2, padding=1))
        f = self.fusion1(f, conv(x_lat1, self.conv1, padding=1))
        f = self.fusion0(f, x_lat0)

        h = conv(f, self.head_conv0, padding=1)
        h = conv_transpose(h, self.head_up1, 2)
        h = F.relu(conv(h, self.head_conv2, padding=1))
        canonical_inverse_depth = F.relu(conv_f32(h, self.head_conv4))
        if not self.use_fov_head:
            return canonical_inverse_depth, torch.full((B,), 60.0, device=x.device)

        ft = self.fov_encoder(x2, out_indices=(depth - 1,))[0][0]
        ft = dense(ft, self.fov_proj).reshape(B, grid, grid, -1)
        # torch Conv2d(stride 2, padding 1) alignment
        lr = F.relu(conv(lowres_features, self.fov_downsample, stride=2, padding=1))
        z = ft.to(lr.dtype) + lr
        z = F.relu(conv(z, self.fov_head0, stride=2, padding=1))
        z = F.relu(conv(z, self.fov_head2, stride=2, padding=1))
        if z.shape[1] != 6:
            # the 6 x 6 VALID conv assumes tile 384; other tiles resize to it
            z = resize(z, 6, 6, mode="bilinear", antialias=False)
        return canonical_inverse_depth, conv_f32(z, self.fov_head4).reshape(B)


class DepthProModel(BaseDepthModel):
    """iw3-facing wrapper: a square bilinear resize to 4 x tile, (x - 0.5) /
    0.5, the network in the compute dtype (flip TTA in one batch), then
    disparity = canonical inverse depth * W / f_px with f_px = 0.5 W /
    tan(fov / 2) in fp32, clamped to [1e-4, 1e4], resized back when the
    frame is smaller, dilated.  Forced disparity: no sign inversion;
    ``--resolution`` is ignored; images only."""

    def __init__(self, model_type="DepthPro", device="cuda", dtype=torch.bfloat16):
        super().__init__(model_type, device=device, dtype=dtype)
        self.force_disparity = True
        self.tile_size = NAME_MAP[model_type]
        self.img_size = self.tile_size * 4
        self.encoder = "vitl"

    @classmethod
    def get_name(cls):
        return "DepthPro"

    @classmethod
    def supported(cls, model_type):
        return model_type in NAME_MAP

    def is_metric(self):
        return not self.force_disparity

    def is_video_supported(self):
        return False

    def load_model(self, model_type, resolution=None, checkpoint=None,
                   generator=None, **kwargs):
        """``checkpoint``: a ``.nztm`` file or a raw ``.pth`` / ``.pt`` /
        ``.safetensors`` of Apple's layout (its position-embedding grid
        read from the file); without one, flax's init drawn from
        ``generator``."""
        from ...models.torch_convert import convert_depth_pro

        def convert(sd):
            tree = convert_depth_pro(sd, self.encoder)
            n_pos = tree["patch_encoder"]["pos_embed"].shape[1] - 1
            return DepthPro(encoder=self.encoder, tile_size=self.tile_size,
                            pos_embed_size=int(round(n_pos ** 0.5))), tree
        return load_depth_net(
            checkpoint, self.device, DepthPro,
            lambda: DepthPro(encoder=self.encoder, tile_size=self.tile_size),
            convert, generator)

    @torch.no_grad()
    def infer(self, x, tta=False, edge_dilation=0, **kwargs):
        """x (B, H, W, 3) or (H, W, 3) in [0, 1] -> disparity (B, h, w, 1)
        fp32: the frame size, or 4 x tile where the frame is larger."""
        batch = x.dim() == 4
        if not batch:
            x = x[None]
        B, H, W, _ = x.shape
        xp = resize(x.float(), self.img_size, self.img_size, mode="bilinear",
                    antialias=False)
        xp = ((xp.clamp(0, 1) - 0.5) / 0.5).to(self.dtype)
        if tta:
            xp = torch.cat([xp, xp.flip(2)], dim=0)
        cid, fov_deg = self.model(xp)
        cid = torch.nan_to_num(cid.float())
        f_px = 0.5 * W / torch.tan(0.5 * torch.deg2rad(fov_deg))
        inv = (cid * (W / f_px)[:, None, None, None]).clamp(1e-4, 1e4)
        if tta:
            inv = (inv[:B] + inv[B:].flip(2)) * 0.5
        if H < inv.shape[1] or W < inv.shape[2]:
            inv = resize(inv, H, W, mode="bilinear", antialias=False)
        if edge_dilation_is_enabled(edge_dilation):
            inv = dilate_edge(inv, edge_dilation)
        return inv if batch else inv[0]
