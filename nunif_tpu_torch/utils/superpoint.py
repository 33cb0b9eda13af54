"""SuperPoint keypoints and descriptors, and the robust transform
estimation and warp of the stabilizer (counterpart of
``nunif_tpu/utils/superpoint.py``).

- ``SuperPoint`` (``aux.superpoint``): VGG backbone (channels 64, 64, 128,
  128, 256), the 65-way detector softmax, ``batched_nms``, a static top-k
  with a validity mask (a stable sort: ties keep the lower index, as XLA's
  top-k does), descriptors sampled at the keypoints.  NHWC input in [0, 1].
- ``find_match_index``: cosine matching with validity masks.
- ``find_transform``: shift / scale / angle by 50 steps of Adam (b1 0.5,
  b2 0.9, a cosine-decay schedule with alpha 1e-3, the sigma outlier mask
  on the detached error), written out as optax computes it: the roundings
  of ``torch.optim.Adam`` differ, and 50 steps amplify them.
- ``apply_transform``: the backward affine warp.  On the card, with border
  padding, C <= 8 and ``max_shift <= TWO_PASS_MAX_SHIFT``, it runs as the
  exact two-pass shear decomposition on K3 (``modules.grid_sample.
  warp_x_bounded``: two launches); otherwise as a gather
  (``F.grid_sample``, ``align_corners=True``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..models import Model, register_model
from ..modules.grid_sample import grid_sample


class VGGBlock(nn.Module):
    """conv -> relu -> the eval BatchNorm as an affine after the relu
    (``bn_scale``, ``bn_bias``; it cannot fold into the conv)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              padding=kernel_size // 2)
        self.bn_scale = nn.Parameter(torch.ones(out_channels))
        self.bn_bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):  # NCHW
        x = self.conv(x)
        if self.relu:
            x = F.relu(x)
        return x * self.bn_scale[:, None, None] + self.bn_bias[:, None, None]


def _max_pool_same(x, r: int):
    """Stride-1 max pool of (B, H, W) over a (2r + 1)^2 window."""
    return F.max_pool2d(x[:, None], 2 * r + 1, stride=1, padding=r)[:, 0]


def batched_nms(scores, nms_radius: int):
    """Non-maximum suppression of (B, H, W) scores within ``nms_radius``."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == _max_pool_same(scores, nms_radius)
    for _ in range(2):
        supp_mask = _max_pool_same(max_mask.to(scores.dtype), nms_radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max = supp_scores == _max_pool_same(supp_scores, nms_radius)
        max_mask = max_mask | (new_max & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


@register_model
class SuperPoint(Model):
    """forward(image (B, H, W, 1 or 3) in [0, 1]) -> dict(keypoints (B, K,
    2) xy, scores (B, K), valid (B, K), descriptors (B, K, D) L2-normalised);
    with ``dense_output`` dict(scores_dense (B, H, W), descriptors_dense
    (B, H / 8, W / 8, D))."""
    model_name = "aux.superpoint"

    def __init__(self, nms_radius: int = 4, max_num_keypoints: int = 1024,
                 detection_threshold: float = 0.005, remove_borders: int = 4,
                 descriptor_dim: int = 256,
                 channels: tuple = (64, 64, 128, 128, 256),
                 dense_output: bool = False):
        super().__init__()
        self.nms_radius = nms_radius
        self.max_num_keypoints = max_num_keypoints
        self.detection_threshold = detection_threshold
        self.remove_borders = remove_borders
        self.descriptor_dim = descriptor_dim
        self.channels = tuple(channels)
        self.dense_output = dense_output
        cin = 1
        for i, c in enumerate(self.channels[:-1]):
            setattr(self, f"backbone_{i}_0", VGGBlock(cin, c, 3))
            setattr(self, f"backbone_{i}_1", VGGBlock(c, c, 3))
            cin = c
        c_last = self.channels[-1]
        stride = 2 ** (len(self.channels) - 2)
        self.descriptor_0 = VGGBlock(cin, c_last, 3)
        self.descriptor_1 = VGGBlock(c_last, descriptor_dim, 1, relu=False)
        self.detector_0 = VGGBlock(cin, c_last, 3)
        self.detector_1 = VGGBlock(c_last, stride ** 2 + 1, 1, relu=False)

    def forward(self, image):
        image = image.float()
        if image.shape[-1] == 3:
            w = torch.tensor([0.299, 0.587, 0.114], device=image.device)
            image = (image * w).sum(dim=-1, keepdim=True)
        stride = 2 ** (len(self.channels) - 2)
        x = image.permute(0, 3, 1, 2)
        n = len(self.channels) - 1
        for i in range(n):
            x = getattr(self, f"backbone_{i}_1")(getattr(self, f"backbone_{i}_0")(x))
            if i < n - 1:
                x = F.max_pool2d(x, 2, 2)
        desc = self.descriptor_1(self.descriptor_0(x)).permute(0, 2, 3, 1)
        desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-12)
        det = self.detector_1(self.detector_0(x)).permute(0, 2, 3, 1)
        scores = torch.softmax(det, dim=-1)[..., :-1]
        b, h, w_, _ = scores.shape
        scores = scores.reshape(b, h, w_, stride, stride).permute(0, 1, 3, 2, 4)
        scores = batched_nms(scores.reshape(b, h * stride, w_ * stride), self.nms_radius)
        pad = self.remove_borders
        if pad:
            inner = torch.zeros_like(scores, dtype=torch.bool)
            inner[:, pad:-pad, pad:-pad] = True
            scores = torch.where(inner, scores, torch.full_like(scores, -1.0))
        if self.dense_output:
            return {"scores_dense": scores, "descriptors_dense": desc}
        H, W = scores.shape[1:]
        k = min(self.max_num_keypoints, H * W)
        top_scores, idx = torch.sort(scores.reshape(b, H * W), dim=1,
                                     descending=True, stable=True)
        top_scores, idx = top_scores[:, :k], idx[:, :k]
        keypoints = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
        valid = top_scores > self.detection_threshold
        # descriptors at the keypoints: bilinear, align_corners=False
        kp_norm = (keypoints + 0.5) / torch.tensor([W, H], dtype=torch.float32,
                                                   device=keypoints.device)
        grid = (kp_norm * 2 - 1).reshape(b, 1, k, 2)
        d = grid_sample(desc, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False).reshape(b, k, self.descriptor_dim)
        d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
        return {"keypoints": keypoints, "scores": top_scores, "valid": valid,
                "descriptors": d}


def find_match_index(kp1, kp2, threshold: float = 0.5):
    """Cosine matching of two single-image keypoint dicts ((K, 2), (K,),
    (K, D)): (index1 (K,), index2 (K,), match_valid (K,), scores (K,))."""
    sim = kp1["descriptors"] @ kp2["descriptors"].T
    sim = torch.where(kp2["valid"][None, :], sim, torch.full_like(sim, -1.0))
    match_index = sim.argmax(dim=-1)  # the first of equal maxima, as jnp.argmax
    max_sim = sim.gather(1, match_index[:, None])[:, 0]
    valid = (max_sim > threshold) & kp1["valid"]
    index1 = torch.arange(sim.shape[0], device=sim.device)
    return index1, match_index, valid, max_sim


def _cosine_lr(lr: float, step: int, steps: int, device):
    """optax's ``lr * cosine_decay_schedule(1.0, steps, alpha=1e-3)(step)``
    in its fp32 order of operations."""
    f32 = dict(dtype=torch.float32, device=device)
    count = torch.tensor(float(min(step, steps)), **f32)
    cosine = 0.5 * (1 + torch.cos(torch.tensor(math.pi, **f32) * count
                                  / torch.tensor(float(steps), **f32)))
    decayed = torch.tensor(1 - 1e-3, **f32) * cosine + torch.tensor(1e-3, **f32)
    return torch.tensor(lr, **f32) * decayed


class Adam:
    """optax.adam's update, written out: first and second moments,
    bias-corrected by 1 - b^count in fp32, ``mu_hat / (sqrt(nu_hat) +
    eps)``, times minus the step's learning rate (``step(grads, lrs)``,
    one rate a parameter)."""

    def __init__(self, params, b1: float, b2: float, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def step(self, params, grads, lrs):
        self.count += 1
        out = []
        for i, (p, g, lr) in enumerate(zip(params, grads, lrs)):
            self.mu[i] = (1 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * g ** 2 + self.b2 * self.nu[i]
            c = torch.tensor(float(self.count), dtype=torch.float32, device=g.device)
            bc1 = 1 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                             device=g.device), c)
            bc2 = 1 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                             device=g.device), c)
            update = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2) + self.eps)
            out.append(p + (-lr) * update)
        return out


def find_transform(xy1, xy2, center, mask, iteration: int = 50,
                   lr_translation: float = 0.1, lr_scale_rotation: float = 0.1,
                   sigma: float = 2.0, disable_shift=False,
                   disable_scale=False, disable_rotate=False):
    """Robust shift / scale / angle of each batch item: xy1, xy2 (B, K, 2)
    matched points, center (B, 1, 2), mask (B, K) bool.  Returns (shift
    (B, 2) px, scale (B,), angle (B,) degrees)."""
    B, K, _ = xy1.shape
    mask2 = mask[..., None]
    xy1 = (xy1 - center) * mask2
    xy2 = (xy2 - center) * mask2
    norm_scale = torch.clamp(torch.nan_to_num(xy1).abs().amax(
        dim=(1, 2), keepdim=True), min=1e-6)
    xy1 = xy1 / norm_scale
    xy2 = xy2 / norm_scale
    dev = xy1.device
    t = torch.zeros((B, 1, 2), device=dev)
    s = torch.ones((B, 1, 1), device=dev)
    r = torch.zeros((B, 1, 1), device=dev)
    m = mask2.float().expand(B, K, 2)
    cnt = torch.clamp(m.sum(dim=(1, 2), keepdim=True), min=1.0)
    opt = Adam((t, s, r), b1=0.5, b2=0.9)
    disabled = (disable_shift, disable_scale, disable_rotate)

    def loss_fn(t, s, r, use_outlier):
        rcos, rsin = torch.cos(r), torch.sin(r)
        xy = torch.cat([xy1[..., :1] * rcos - xy1[..., 1:] * rsin,
                        xy1[..., :1] * rsin + xy1[..., 1:] * rcos], dim=2)
        err = (xy * s + t - xy2).abs()
        if use_outlier:  # the sigma mask on the detached error
            e = err.detach()
            mean = (e * m).sum(dim=(1, 2), keepdim=True) / cnt
            std = torch.sqrt(((e - mean) ** 2 * m).sum(dim=(1, 2), keepdim=True) / cnt)
            w = m * (((e - mean) / (std + 1e-12)) < sigma)
        else:
            w = m
        return (err * w).sum() / torch.clamp(w.sum(), min=1.0)

    for i in range(iteration):
        with torch.enable_grad():
            ps = [p.detach().requires_grad_(True) for p in (t, s, r)]
            grads = torch.autograd.grad(loss_fn(*ps, i > 0), ps)
        grads = [torch.zeros_like(g) if off else g
                 for g, off in zip(grads, disabled)]
        lr_t = _cosine_lr(lr_translation, i, iteration, dev)
        lr_sr = _cosine_lr(lr_scale_rotation, i, iteration, dev)
        t, s, r = opt.step((t, s, r), grads, (lr_t, lr_sr, lr_sr))
    shift = (t * norm_scale).reshape(B, 2)
    angle = r.reshape(B)
    angle = torch.rad2deg(torch.atan2(torch.sin(angle), torch.cos(angle)))
    return shift, s.reshape(B), angle


# the largest displacement the two-pass warp takes (the stabilizer's margin,
# padding 0.05, is ~96 px at 1080p); beyond it apply_transform gathers
TWO_PASS_MAX_SHIFT = 128


def apply_transform(x, shift, scale, angle_deg, center,
                    padding_mode: str = "border", max_shift: int = 48):
    """Backward affine warp of x (B, H, W, C): shift (B, 2) px, scale (B,),
    angle_deg (B,), center (B, 2).  The zero transform is the identity
    (align_corners=True)."""
    B, H, W, C = x.shape
    if (x.is_cuda and padding_mode == "border" and C <= 8
            and max_shift <= TWO_PASS_MAX_SHIFT):
        return apply_transform_two_pass(x, shift, scale, angle_deg, center,
                                        max_shift)
    dev = x.device
    center = center.reshape(B, 1, 1, 2).float()
    shift = -shift.reshape(B, 1, 1, 2).float()
    inv_scale = (1.0 / scale.float()).reshape(B, 1, 1, 1)
    angle = -torch.deg2rad(angle_deg.float()).reshape(B, 1, 1, 1)
    py, px = torch.meshgrid(torch.linspace(0, H - 1, H, device=dev),
                            torch.linspace(0, W - 1, W, device=dev), indexing="ij")
    px = px[None, ..., None] - center[..., 0:1]
    py = py[None, ..., None] - center[..., 1:2]
    asin, acos = torch.sin(angle), torch.cos(angle)
    grid = torch.cat([px * acos - py * asin, px * asin + py * acos], dim=3) * inv_scale
    grid = grid + (shift + center)
    axis_scale = torch.tensor([W - 1, H - 1], dtype=torch.float32,
                              device=dev).reshape(1, 1, 1, 2)
    grid = grid / (axis_scale * 0.5) - 1.0
    return grid_sample(x, grid, mode="bilinear", padding_mode=padding_mode,
                       align_corners=True)


def apply_transform_two_pass(x, shift, scale, angle_deg, center, max_shift: int):
    """The backward affine warp as two bounded horizontal warps (K3) and
    two transposes, exact where D != 0 and the displacements stay within
    ``max_shift`` px (they are clamped to it):
        pass 1  h[i, j] = x[i, q(i, j)],  q = A(j - cx) + (B/D)(i - C(j - cx) - F) + E
        pass 2  out[i, j] = h[sy(i, j), j],  sy = C(j - cx) + D(i - cy) + F
    with the backward map sx = A(j - cx) + B(i - cy) + E, sy as above."""
    from ..modules.grid_sample import warp_x_bounded
    Bn, H, W, _ = x.shape
    dev = x.device
    k = 1.0 / scale.float()
    ang = -torch.deg2rad(angle_deg.float())
    asin, acos = torch.sin(ang), torch.cos(ang)
    A, Bc = acos * k, -asin * k
    Cc, D = asin * k, acos * k
    cx, cy = center[:, 0].float(), center[:, 1].float()
    E = cx - shift[:, 0].float()
    Fv = cy - shift[:, 1].float()

    def bc(v):
        return v.reshape(Bn, 1, 1)

    jj = torch.arange(W, dtype=torch.float32, device=dev).reshape(1, 1, W)
    ii = torch.arange(H, dtype=torch.float32, device=dev).reshape(1, H, 1)
    jcx = jj - bc(cx)
    q = bc(A) * jcx + bc(Bc / D) * (ii - bc(Cc) * jcx - bc(Fv)) + bc(E)
    d1 = torch.clamp(q - jj, -max_shift, max_shift)
    h = warp_x_bounded(x, d1, max_shift)
    # pass 2 on the transposed image: rows are x's columns
    jj_t = torch.arange(H, dtype=torch.float32, device=dev).reshape(1, 1, H)  # i
    ii_t = torch.arange(W, dtype=torch.float32, device=dev).reshape(1, W, 1)  # j
    sy_t = bc(Cc) * (ii_t - bc(cx)) + bc(D) * (jj_t - bc(cy)) + bc(Fv)
    d2 = torch.clamp(sy_t - jj_t, -max_shift, max_shift)
    out_t = warp_x_bounded(h.transpose(1, 2), d2, max_shift)
    return out_t.transpose(1, 2)
