"""waifu2x GAN discriminators, the l3 / v1 / u3 families, NHWC
(counterpart of ``nunif_tpu/waifu2x/models/discriminator.py``).

Inputs are normalized to [-1, 1] and center-cropped to a multiple of 8; a
conditional discriminator embeds the low-resolution condition image
(``ImageToCondition``, or ``ImageToConditionPatch8`` for u3c) and adds it
to its feature maps.  Multi-head discriminators return a tuple of logit
maps and carry their ``loss_weights``.

Spectral norm is the JAX package's stateless one: sigma is estimated on
every forward by 5 power iterations from a fixed start vector
(``spectral_sigma``), a pure function of the kernel, so a step needs no
``u`` buffer and the gradient flows through sigma.  Module names give the
flax paths (``first_layer``, ``features_0``, ``classifier_5``,
``to_cond/fc_0_2``, ``l3/...``, ``v1/...``), so a ``.nztm`` that the JAX
package wrote loads here.  Plain PyTorch: the JAX models reach no Pallas
kernel, their convolutions run on cuDNN.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...core.dtypes import cast_param
from ...models import Model, register_model
from ...modules.attention import dense
from ...modules.conv import conv2d_nhwc, leaky_relu
from ...modules.norm import GroupNorm
from ...modules.pad import crop2d, reflection_pad2d, replication_pad2d
from .cunet import SEBlock


def normalize(x):
    return x * 2.0 - 1.0


def modcrop(x, n):
    """Center-crop H, W to multiples of n."""
    H, W = x.shape[1:3]
    dh, dw = H % n, W % n
    if dh == 0 and dw == 0:
        return x
    return crop2d(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


def fit_to_size(x, cond):
    """Reflection-pad (or center-crop) cond to x's H, W."""
    dh = x.shape[1] - cond.shape[1]
    dw = x.shape[2] - cond.shape[2]
    if dh == 0 and dw == 0:
        return cond
    if dh < 0 or dw < 0:
        return crop2d(cond, ((-dw) // 2, (-dw) - (-dw) // 2,
                             (-dh) // 2, (-dh) - (-dh) // 2))
    return reflection_pad2d(cond, (dw // 2, dw - dw // 2,
                                   dh // 2, dh - dh // 2))


def se_nhwc(block: SEBlock, x):
    """cunet's (NCHW) squeeze-and-excitation block on an NHWC tensor."""
    return block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


POWER_ITERATIONS = 5


def spectral_sigma(weight):
    """Largest singular value of the conv kernel as the (kh kw I, O) matrix
    of its HWIO layout, by POWER_ITERATIONS steps from the fixed start
    ones(O) / sqrt(O), in fp32.  ``weight`` is OIHW: its (O, I kh kw)
    flattening is that matrix transposed with its rows permuted, which
    leaves every v of the iteration and sigma unchanged."""
    w = weight.float().flatten(1)
    v = torch.full((w.shape[0],), 1.0 / math.sqrt(w.shape[0]),
                   dtype=torch.float32, device=w.device)
    for _ in range(POWER_ITERATIONS):
        u = w.t() @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        v = w @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
    return torch.dot(u, w.t() @ v)


def _same_pads(n, k, s):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SNConv(nn.Module):
    """Conv2d with the stateless spectral normalization: the kernel divided
    by ``spectral_sigma`` on every call, then cast to x's dtype.
    ``padding``: "SAME", "VALID" or ((top, bottom), (left, right))."""

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3),
                 strides=(1, 1), padding="SAME"):
        super().__init__()
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self.padding = padding
        self.weight = nn.Parameter(torch.zeros(features, in_channels, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        w = self.weight / spectral_sigma(self.weight)
        kh, kw = w.shape[2:]
        if self.padding == "SAME":
            (pt, pb), (pl, pr) = (_same_pads(x.shape[1], kh, self.strides[0]),
                                  _same_pads(x.shape[2], kw, self.strides[1]))
        elif self.padding == "VALID":
            pt = pb = pl = pr = 0
        else:
            (pt, pb), (pl, pr) = self.padding
        y = x.permute(0, 3, 1, 2)
        if (pt, pl) != (pb, pr):
            y = F.pad(y, (pl, pr, pt, pb))
            pt = pl = 0
        y = F.conv2d(y, w.to(x.dtype), self.bias.to(x.dtype), self.strides,
                     (pt, pl))
        return y.permute(0, 2, 3, 1)


def group_norm(channels: int, groups: int = 32) -> GroupNorm:
    """flax ``GroupNorm(num_groups)``: epsilon 1e-6, statistics in fp32."""
    return GroupNorm(groups, channels, eps=1e-6)


class ResBlockGNLReLU(nn.Module):
    """3x3 conv, GroupNorm(32), LeakyReLU(0.2), 3x3 conv, GroupNorm, plus
    the shortcut (1x1 conv and GroupNorm where the width changes),
    LeakyReLU(0.2)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_0 = nn.Conv2d(in_channels, out_channels, 3)
        self.gn_1 = group_norm(out_channels)
        self.conv_3 = nn.Conv2d(out_channels, out_channels, 3)
        self.gn_4 = group_norm(out_channels)
        if in_channels != out_channels:
            self.identity_conv = nn.Conv2d(in_channels, out_channels, 1)
            self.identity_gn = group_norm(out_channels)
        else:
            self.identity_conv = None

    def forward(self, x):
        h = leaky_relu(self.gn_1(conv2d_nhwc(x, self.conv_0, padding=1)), 0.2)
        h = self.gn_4(conv2d_nhwc(h, self.conv_3, padding=1))
        sc = x if self.identity_conv is None else \
            self.identity_gn(conv2d_nhwc(x, self.identity_conv))
        return leaky_relu(h + sc, 0.2)


class ImageToCondition(nn.Module):
    """The condition image -> one (B, 1, 1, C) embedding a head: [-1, 1],
    avg-pool by ``scale_factor``, 3x3 conv, GroupNorm(4), ReLU, adaptive
    average to 4x4, a dense aggregate over (h, w, c), then per output a
    two-layer MLP."""

    def __init__(self, embed_dim: int, outputs, scale_factor: int,
                 in_channels: int = 3):
        super().__init__()
        self.scale_factor = scale_factor
        self.outputs = tuple(outputs)
        self.features_1 = nn.Conv2d(in_channels, embed_dim, 3)
        self.features_2 = group_norm(embed_dim, 4)
        self.aggregate = nn.Linear(embed_dim * 16, embed_dim)
        for i, out_c in enumerate(self.outputs):
            self.add_module(f"fc_{i}_0", nn.Linear(embed_dim, embed_dim))
            self.add_module(f"fc_{i}_2", nn.Linear(embed_dim, out_c))

    @staticmethod
    def pool(x):
        """(B, H, W, C) -> (B, 4, 4, C), torch's ``AdaptiveAvgPool2d``: the
        reference's, and what the JAX function means to copy (its windows
        end at the floor where 4 does not divide a side, torch's at the
        ceiling; ROADMAP queue 3)."""
        return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)

    def forward(self, x):
        B = x.shape[0]
        x = normalize(x)
        if self.scale_factor > 1:
            s = self.scale_factor
            x = F.avg_pool2d(x.permute(0, 3, 1, 2), s, s).permute(0, 2, 3, 1)
        x = conv2d_nhwc(replication_pad2d(x, (1, 1, 1, 1)), self.features_1)
        x = self.pool(torch.relu(self.features_2(x)))
        x = dense(x.reshape(B, -1), self.aggregate)
        conds = []
        for i, out_c in enumerate(self.outputs):
            h = torch.relu(dense(x, getattr(self, f"fc_{i}_0")))
            h = dense(h, getattr(self, f"fc_{i}_2"))
            conds.append(h.reshape(B, 1, 1, out_c))
        return conds


class Discriminator(Model):
    loss_weights = (1.0,)


@register_model
class L3Discriminator(Discriminator):
    """PatchGAN of three stride-2 4x4 convs with SE blocks and a GN residual
    block; logits cropped by 8."""
    model_name = "waifu2x.l3_discriminator"

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 negative_slope: float = 0.2, conditional: bool = False,
                 scale_factor: int = 4):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.negative_slope = negative_slope
        self.conditional = conditional
        self.scale_factor = scale_factor
        if conditional:
            self.to_cond = ImageToCondition(32, (64, 256), scale_factor)
        self.first_layer = nn.Conv2d(in_channels, 64, 4)
        self.features_0 = group_norm(64)
        self.features_2 = nn.Conv2d(64, 128, 4)
        self.features_3 = group_norm(128)
        self.features_5 = SEBlock(128)
        self.features_6 = nn.Conv2d(128, 256, 4)
        self.classifier_0 = group_norm(256)
        self.classifier_2 = SEBlock(256)
        self.classifier_3 = ResBlockGNLReLU(256, 512)
        self.classifier_4 = SEBlock(512)
        self.classifier_5 = SNConv(512, out_channels, (3, 3))

    def forward(self, x, c=None, scale_factor=None, train: bool = False):
        slope = self.negative_slope
        x = modcrop(x, 8)
        cond = self.to_cond(fit_to_size(x, c)) if self.conditional else None
        x = normalize(x)
        h = conv2d_nhwc(replication_pad2d(x, (1, 1, 1, 1)), self.first_layer,
                        stride=2)
        if cond is not None:
            h = h + cond[0]
        h = leaky_relu(self.features_0(h), slope)
        h = conv2d_nhwc(h, self.features_2, stride=2, padding=1)
        h = leaky_relu(self.features_3(h), slope)
        h = se_nhwc(self.features_5, h)
        h = conv2d_nhwc(h, self.features_6, stride=2, padding=1)
        if cond is not None:
            h = h + cond[1]
        h = leaky_relu(self.classifier_0(h), slope)
        h = se_nhwc(self.classifier_2, h)
        h = self.classifier_3(h)
        h = se_nhwc(self.classifier_4, h)
        h = self.classifier_5(h)
        return crop2d(h, (8, 8, 8, 8))


@register_model
class V1Discriminator(Discriminator):
    """A shallow PatchGAN (one stride-2 conv); logits cropped by 32."""
    model_name = "waifu2x.v1_discriminator"

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 negative_slope: float = 0.2, conditional: bool = False,
                 scale_factor: int = 4):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.negative_slope = negative_slope
        self.conditional = conditional
        self.scale_factor = scale_factor
        if conditional:
            self.to_cond = ImageToCondition(32, (64, 128), scale_factor)
        self.first_layer = nn.Conv2d(in_channels, 64, 3)
        self.features_0 = group_norm(64)
        self.features_2 = nn.Conv2d(64, 64, 4)
        self.features_3 = group_norm(64)
        self.features_5 = nn.Conv2d(64, 128, 3)
        self.classifier_0 = group_norm(128)
        self.classifier_2 = SEBlock(128)
        self.classifier_3 = SNConv(128, out_channels, (3, 3))

    def forward(self, x, c=None, scale_factor=None, train: bool = False):
        slope = self.negative_slope
        x = modcrop(x, 8)
        cond = self.to_cond(fit_to_size(x, c)) if self.conditional else None
        x = normalize(x)
        h = conv2d_nhwc(replication_pad2d(x, (1, 1, 1, 1)), self.first_layer)
        if cond is not None:
            h = h + cond[0]
        h = leaky_relu(self.features_0(h), slope)
        h = conv2d_nhwc(h, self.features_2, stride=2, padding=1)
        h = leaky_relu(self.features_3(h), slope)
        h = conv2d_nhwc(h, self.features_5, padding=1)
        if cond is not None:
            h = h + cond[1]
        h = leaky_relu(self.classifier_0(h), slope)
        h = se_nhwc(self.classifier_2, h)
        h = self.classifier_3(h)
        return crop2d(h, (32, 32, 32, 32))


@register_model
class L3ConditionalDiscriminator(L3Discriminator):
    model_name = "waifu2x.l3_conditional_discriminator"

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 negative_slope: float = 0.2, conditional: bool = True,
                 scale_factor: int = 4):
        super().__init__(in_channels, out_channels, negative_slope,
                         conditional, scale_factor)


@register_model
class V1ConditionalDiscriminator(V1Discriminator):
    model_name = "waifu2x.v1_conditional_discriminator"

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 negative_slope: float = 0.2, conditional: bool = True,
                 scale_factor: int = 4):
        super().__init__(in_channels, out_channels, negative_slope,
                         conditional, scale_factor)


@register_model
class L3V1Discriminator(Discriminator):
    """(l3 logits, v1 logits), loss weights (0.8, 0.2)."""
    model_name = "waifu2x.l3v1_discriminator"
    loss_weights = (0.8, 0.2)

    def __init__(self, in_channels: int = 3, out_channels: int = 1):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.l3 = L3Discriminator(out_channels=out_channels)
        self.v1 = V1Discriminator(out_channels=out_channels)

    def forward(self, x, c=None, scale_factor=None, train: bool = False):
        return self.l3(x, c, scale_factor), self.v1(x, c, scale_factor)


@register_model
class L3V1ConditionalDiscriminator(Discriminator):
    """Conditional l3 and v1, loss weights (0.8, 0.2)."""
    model_name = "waifu2x.l3v1_conditional_discriminator"
    loss_weights = (0.8, 0.2)

    def __init__(self, in_channels: int = 3, out_channels: int = 1,
                 scale_factor: int = 4):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.scale_factor = scale_factor
        self.l3 = L3Discriminator(out_channels=out_channels, conditional=True,
                                  scale_factor=scale_factor)
        self.v1 = V1Discriminator(out_channels=out_channels, conditional=True,
                                  scale_factor=scale_factor)

    def forward(self, x, c=None, scale_factor=None, train: bool = False):
        return self.l3(x, c, scale_factor), self.v1(x, c, scale_factor)


# --------------------------------------------------------------------------
# U3C: the U-net conditional discriminator
# --------------------------------------------------------------------------

def to_y(x):
    """BT.601 luminance, (B, H, W, 1)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return torch.sum(x * w, dim=-1, keepdim=True)


def modpad(x, n):
    """Replication-pad bottom / right so H, W are multiples of n."""
    H, W = x.shape[1:3]
    ph = (n - H % n) % n
    pw = (n - W % n) % n
    if ph or pw:
        x = replication_pad2d(x, (0, pw, 0, ph))
    return x


class ResBlockSNLReLU(nn.Module):
    """Spectral-norm residual block: two replication-padded 3x3 SNConvs,
    a 1x1 SNConv shortcut where the width changes, LeakyReLU(0.2)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_0 = SNConv(in_channels, out_channels, (3, 3), padding="VALID")
        self.conv_2 = SNConv(out_channels, out_channels, (3, 3), padding="VALID")
        self.identity = (SNConv(in_channels, out_channels, (1, 1), padding="VALID")
                         if in_channels != out_channels else None)

    def forward(self, x):
        h = leaky_relu(self.conv_0(replication_pad2d(x, (1, 1, 1, 1))), 0.2)
        h = self.conv_2(replication_pad2d(h, (1, 1, 1, 1)))
        if self.identity is not None:
            x = self.identity(x)
        return leaky_relu(h + x, 0.2)


class ImageToConditionPatch8(nn.Module):
    """The condition at 1/8 resolution: [-1, 1], antialiased bilinear to
    1/4, a 3x3 conv, a stride-2 conv with GroupNorm, SE, a GN residual
    block, then per output two 1x1 SNConvs."""

    def __init__(self, embed_dim: int, outputs, in_channels: int = 4):
        super().__init__()
        self.outputs = tuple(outputs)
        self.features_0 = nn.Conv2d(in_channels, embed_dim, 3, bias=False)
        self.down_conv = nn.Conv2d(embed_dim, embed_dim, 3, bias=False)
        self.down_gn = group_norm(embed_dim)
        self.se = SEBlock(embed_dim)
        self.res = ResBlockGNLReLU(embed_dim, embed_dim)
        for i, out_c in enumerate(self.outputs):
            self.add_module(f"fc_{i}_0", SNConv(embed_dim, embed_dim, (1, 1),
                                                padding="VALID"))
            self.add_module(f"fc_{i}_2", SNConv(embed_dim, out_c, (1, 1),
                                                padding="VALID"))

    def forward(self, x):
        from ...modules.resize import resize
        x = normalize(x)
        x = resize(x, x.shape[1] // 4, x.shape[2] // 4, mode="bilinear",
                   antialias=True)
        h = conv2d_nhwc(replication_pad2d(x, (1, 1, 1, 1)), self.features_0)
        h = leaky_relu(h, 0.2)
        s = self.down_gn(conv2d_nhwc(h, self.down_conv, stride=2, padding=1))
        h = se_nhwc(self.se, leaky_relu(s, 0.2))
        h = self.res(h)
        outs = []
        for i in range(len(self.outputs)):
            z = leaky_relu(getattr(self, f"fc_{i}_0")(h), 0.2)
            outs.append(getattr(self, f"fc_{i}_2")(z))
        return outs


def _up(x, layer: nn.ConvTranspose2d):
    """flax ``ConvTranspose(2x2, stride 2, transpose_kernel=True)``, no
    bias, as torch's transposed conv (the weight's 4-D rule,
    ``models/flax_params.py``)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                           cast_param(layer.weight, x.dtype), stride=2)
    return y.permute(0, 2, 3, 1)


@register_model
class U3ConditionalDiscriminator(Discriminator):
    """U-net conditional discriminator with two patch heads (full-resolution
    z2, 1/8 z1), loss weights (0.9, 0.1); in training the heads are cropped
    by 8 and 2."""
    model_name = "waifu2x.u3_conditional_discriminator"
    loss_weights = (0.9, 0.1)

    def __init__(self, out_channels: int = 1):
        super().__init__()
        self.out_channels = out_channels
        self.to_cond = ImageToConditionPatch8(64, (256,))
        self.enc1_0 = nn.Conv2d(4, 32, 3, bias=False)
        self.enc1_2 = SNConv(32, 64, (4, 4), (2, 2), padding="VALID")
        self.enc2 = SNConv(64, 128, (4, 4), (2, 2), padding="VALID")
        self.enc3 = SNConv(128, 256, (4, 4), (2, 2), padding="VALID")
        self.enc4_0 = ResBlockSNLReLU(256, 256)
        self.enc4_1 = ResBlockSNLReLU(256, 256)
        self.class1_0 = ResBlockSNLReLU(256, 256)
        self.class1_1 = SNConv(256, out_channels, (3, 3), padding="VALID")
        self.up1 = nn.ConvTranspose2d(256, 128, 2, stride=2, bias=False)
        self.enc2_proj = SNConv(128, 128, (1, 1), padding="VALID")
        self.dec1 = ResBlockSNLReLU(128, 128)
        self.up2 = nn.ConvTranspose2d(128, 64, 2, stride=2, bias=False)
        self.enc1_proj = SNConv(64, 64, (1, 1), padding="VALID")
        self.dec2 = ResBlockSNLReLU(64, 64)
        self.class2_0 = ResBlockSNLReLU(64, 64)
        self.class2_1 = SNConv(64, out_channels, (3, 3), padding="VALID")

    def forward(self, x, c=None, scale_factor=None, train: bool = False):
        if c is None:
            raise ValueError("u3c is conditional: it needs c")
        pad = (1, 1, 1, 1)
        x = torch.cat([x, to_y(x)], dim=-1)
        c = torch.cat([c, to_y(c)], dim=-1)
        c = fit_to_size(x, c)
        x = modpad(x, 16)
        c = modpad(c, 16)
        cond = self.to_cond(c)
        x = normalize(x)
        h = leaky_relu(conv2d_nhwc(replication_pad2d(x, pad), self.enc1_0), 0.2)
        x1 = leaky_relu(self.enc1_2(replication_pad2d(h, pad)), 0.2)
        x2 = leaky_relu(self.enc2(replication_pad2d(x1, pad)), 0.2)
        x3 = leaky_relu(self.enc3(replication_pad2d(x2, pad)), 0.2)
        x3 = x3 + cond[0].to(x3.dtype)
        x3 = self.enc4_1(self.enc4_0(x3))
        z1 = self.class1_1(replication_pad2d(self.class1_0(x3), pad))
        x4 = leaky_relu(_up(x3, self.up1), 0.2)
        x4 = self.dec1(x4 + self.enc2_proj(x2))
        x5 = leaky_relu(_up(x4, self.up2), 0.2)
        x5 = self.dec2(x5 + self.enc1_proj(x1))
        z2 = self.class2_1(replication_pad2d(self.class2_0(x5), pad))
        if train:
            return crop2d(z2, (8,) * 4), crop2d(z1, (2,) * 4)
        return z2, z1
