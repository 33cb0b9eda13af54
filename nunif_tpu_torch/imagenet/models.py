"""imagenet classifier archs on NHWC tensors (counterpart of
``nunif_tpu/imagenet/models.py``).

``VGG11`` is torchvision's vgg11_bn topology, so torchvision-pretrained
weights convert without loss (``models/torch_convert.convert_vgg11_bn``).
``SwinT`` is the swin-t classifier on the port's LayerNorm Swin blocks,
whose window attention is kernel K4 (12 launches a forward at the default
depths).  Flax paths: ``conv{k}``, ``bn{k}`` (``scale``, ``bias``, ``mean``,
``var``), ``fc{j}``; ``patch_embed``, ``patch_norm``, ``stage{i}``,
``merge_norm{i}``, ``merge{i}``, ``norm``, ``head``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models import SoftmaxBaseModel, register_model
from ..modules.attention import SwinTransformerBlocks, dense
from ..modules.conv import conv2d, conv2d_nhwc
from ..modules.norm import LayerNorm


class FrozenBatchNorm(nn.Module):
    """BatchNorm whose running statistics are parameters (``mean``,
    ``var``), as in the JAX module, so ``.nztm`` files and parameter counts
    agree: y = (x - mean) * rsqrt(var + eps) * scale + bias in fp32 (float64
    stays float64), rounded to x's dtype.  ``use_batch_stats`` normalises by
    the batch's own statistics (biased variance) instead."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor, use_batch_stats: bool = False):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean, var = self.mean, self.var
        if use_batch_stats:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=axes)
            var = xf.var(dim=axes, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return y.to(x.dtype)


# torchvision vgg cfg "A": output channels per conv, "M" a 2x2 max pool
_VGG11_CFG = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
              "M")


@register_model
class VGG11(SoftmaxBaseModel):
    """torchvision vgg11_bn: cfg-A conv / BN / ReLU features, the 7x7
    average pool, a three-layer classifier."""
    model_name = "imagenet.vgg11"

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.num_classes = num_classes
        cin, k = 3, 0
        for c in _VGG11_CFG:
            if c == "M":
                continue
            self.add_module(f"conv{k}", nn.Conv2d(cin, c, 3))
            self.add_module(f"bn{k}", FrozenBatchNorm(c))
            cin, k = c, k + 1
        self.fc0 = nn.Linear(512 * 7 * 7, 4096)
        self.fc1 = nn.Linear(4096, 4096)
        self.fc2 = nn.Linear(4096, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x (B, H, W, 3) -> logits (B, num_classes) in x's dtype."""
        x = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
        k = 0
        for c in _VGG11_CFG:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            y = conv2d(x, getattr(self, f"conv{k}"), padding=1)
            y = getattr(self, f"bn{k}")(y.permute(0, 2, 3, 1),
                                        use_batch_stats=train)
            x = F.relu(y).permute(0, 3, 1, 2)
            k += 1
        # AdaptiveAvgPool2d((7, 7)): the identity at 224 px; a larger
        # multiple of 7 is average-pooled down to 7x7
        h, w = x.shape[2], x.shape[3]
        if (h, w) != (7, 7):
            assert h % 7 == 0 and w % 7 == 0, (h, w)
            x = F.avg_pool2d(x.float(), (h // 7, w // 7)).to(x.dtype)
        # torch's flatten is CHW-major: converted classifier weights were
        # trained on C*7*7 order
        x = x.reshape(x.shape[0], -1)
        x = F.relu(dense(x, self.fc0))
        x = F.relu(dense(x, self.fc1))
        return dense(x, self.fc2)


def patch_merge(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), each 2x2 patch's pixels
    concatenated as [x00, x01, x10, x11] (row, column): the JAX module's
    reshape / transpose order, not torchvision's [x00, x10, x01, x11]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


@register_model
class SwinT(SoftmaxBaseModel):
    """swin-t classifier: 4x4 patch embedding, four stages of window-7
    LayerNorm Swin blocks (K4) with patch merging between them, the final
    norm, the mean over H and W, the head.

    ``patch_norm`` and ``merge_norm{i}`` run in x's dtype (fp32 statistics,
    one rounding), as the JAX module's ``LayerNorm(dtype=x.dtype)``; the
    block norms keep the port's settled divergence from flax's
    ``LayerNorm(dtype=None)``, which returns fp32 for a bf16 input (the
    port rounds them to x's dtype).  Head dim is 32 at every stage and N =
    49; the 7x7 stage runs unshifted.  On the card the forward runs bf16:
    in fp32 K4 takes its slower fp32 kernel."""
    model_name = "imagenet.swin_t"

    def __init__(self, num_classes: int = 1000, embed_dim: int = 96,
                 depths=(2, 2, 6, 2), heads=(3, 6, 12, 24),
                 window_size: int = 7):
        super().__init__()
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.heads = tuple(heads)
        self.window_size = window_size
        self.patch_embed = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.patch_norm = LayerNorm(embed_dim)
        dim = embed_dim
        for i, (depth, nh) in enumerate(zip(self.depths, self.heads)):
            self.add_module(f"stage{i}", SwinTransformerBlocks(
                dim, nh, depth, window_size=window_size, norm="layernorm"))
            if i < len(self.depths) - 1:
                self.add_module(f"merge_norm{i}", LayerNorm(4 * dim))
                self.add_module(f"merge{i}", nn.Linear(4 * dim, 2 * dim,
                                                       bias=False))
                dim *= 2
        self.norm = LayerNorm(dim)
        self.head = nn.Linear(dim, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x (B, H, W, 3), H / 4 / 2^i a multiple of the window at each
        stage i (224 px at the defaults) -> logits (B, num_classes) in x's
        dtype."""
        x = conv2d_nhwc(x, self.patch_embed, stride=4).contiguous()
        x = self.patch_norm(x)
        for i in range(len(self.depths)):
            x = getattr(self, f"stage{i}")(x)
            if i < len(self.depths) - 1:
                x = getattr(self, f"merge_norm{i}")(patch_merge(x))
                x = dense(x, getattr(self, f"merge{i}"))
        x = self.norm(x)
        x = x.float().mean(dim=(1, 2)).to(x.dtype)
        return dense(x, self.head)
