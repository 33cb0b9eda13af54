"""K7: scaled-dot-product attention (counterpart of ``nunif_tpu/ops/sdpa.py``).

Replaces ``nunif_tpu/ops/sdpa.py:_flash``, which runs JAX's shipped Pallas
TPU flash-attention kernel for the DINOv2 trunks of the depth models.  The
Hopper kernel is ``csrc/flash_attn.cu``: persistent blocks of three
warpgroups walk (128-query tile, head, batch) items; a producer warpgroup
brings Q and K / V tiles of 128 keys by TMA through a ring of shared
memory, and two consumer warpgroups run S = Q K^T and O += P V on wgmma;
its header notes what bounds it on the H100 and what its design does
about that.  On iw3's main path it runs every DINOv2
block: (8, 6, 1373, 64) bf16 at a 392x686 depth input, 12 launches a batch
of 8 frames.

``sdpa`` takes its plain twin ``sdpa_plain`` only for CPU tensors; for a
CUDA tensor it launches the kernel at every sequence length or raises.  It
calls the custom op ``torch.ops.nunif_tpu_torch.sdpa`` (CPU kernel: the
twin; CUDA kernel: the launch; a fake kernel for shapes), which
``torch.export`` records as one node.  Its backward is the twin's
vector-Jacobian product (``_build.register_twin_vjp``) on either device:
the JAX package cannot differentiate its Pallas call (``_flash`` passes
forward block sizes only), so it has no backward kernel to port.  On the
DINOv2 feature loss (``modules/dinov2_loss.py``) the training forward of
swin_unet_2x's 192^2 output runs it at (16, 6, 197, 64), 24 launches: 12
on the output branch, which the backward goes through, and 12 on the
detached target branch.
"""
from __future__ import annotations

import torch

from . import _build


def sdpa_plain(q, k, v, *, scale=None):
    """Plain PyTorch twin of ``sdpa``, the semantics of ``_xla_sdpa``:
    q * scale rounded to q's dtype, fp32 scores and softmax, probabilities
    rounded to q's dtype, fp32 P V rounded to q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = q.dtype
    attn = torch.einsum("bhnd,bhmd->bhnm", (q * scale).float(), k.float())
    attn = torch.softmax(attn, dim=-1).to(dt)
    return torch.einsum("bhnm,bhmd->bhnd", attn.float(), v.float()).to(dt)


def _check_operand(name, t, b, h, d):
    if t.dim() != 4 or t.shape[0] != b or t.shape[1] != h or t.shape[3] != d:
        raise ValueError(f"sdpa: {name} {tuple(t.shape)} does not fit "
                         f"(B={b}, H={h}, *, d={d})")
    if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"sdpa: {name} needs a contiguous last dimension, "
                         f"strides that are multiples of 8 and a 16-byte "
                         f"aligned start, got strides {t.stride()}")


def _out_layout(q):
    """An empty (B, H, N, d) view of a contiguous (B, N, H, d) tensor, the
    layout the out projection reads."""
    B, H, N, d = q.shape
    return torch.empty_strided((B, H, N, d), (N * H * d, d, H * d, 1),
                               dtype=q.dtype, device=q.device)


def sdpa(q, k, v, *, scale=None):
    """softmax(q @ k^T * scale) @ v for q (B, H, N, d), k and v (B, H, M, d).

    Output (B, H, N, d) in q's dtype, a view of a (B, N, H, d) contiguous
    tensor, the layout the out projection reads.  On CUDA: bf16 only and
    d = 64 (the head dim of DINOv2 ViT-S/B/L); q, k and v may be strided
    views (e.g. of a (B, N, 3, H, d) qkv projection).
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sdpa: unsupported device {q.device}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _sdpa_op(q, k, v, float(scale))


@torch.library.custom_op("nunif_tpu_torch::sdpa", mutates_args=(),
                         device_types="cpu")
def _sdpa_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             scale: float) -> torch.Tensor:
    out = _out_layout(q)
    out.copy_(sdpa_plain(q, k, v, scale=scale))
    return out


@_sdpa_op.register_kernel("cuda")
def _sdpa_cuda(q, k, v, scale):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"sdpa: the kernel takes bfloat16, {name} is "
                            f"{t.dtype}")
        if t.device != q.device:
            raise ValueError(f"sdpa: {name} on {t.device}, q on {q.device}")
    if q.dim() != 4:
        raise ValueError(f"sdpa: q must be (B, H, N, d), got {tuple(q.shape)}")
    B, H, N, d = q.shape
    if d != 64:
        raise ValueError(f"sdpa: head dim {d}: the kernel is built for 64")
    _check_operand("q", q, B, H, d)
    _check_operand("k", k, B, H, d)
    _check_operand("v", v, B, H, d)
    M = k.shape[2]
    if v.shape[2] != M:
        raise ValueError(f"sdpa: k has {M} keys, v {v.shape[2]}")
    out = _out_layout(q)
    rc = _build.library().nunif_flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, N, M, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], float(scale), _build.stream_ptr(q.device))
    _build.check(rc, "sdpa")
    sdpa.launches += 1
    return out


@_sdpa_op.register_fake
def _(q, k, v, scale):
    return _out_layout(q)


_build.register_twin_vjp(
    _sdpa_op, 3, lambda a, q, k, v: sdpa_plain(q, k, v, scale=a[0]))

sdpa.launches = 0
