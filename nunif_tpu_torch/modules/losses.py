"""Losses on NHWC tensors (counterpart of ``nunif_tpu/modules/losses.py``).

Plain functions and small factory closures of signature ``loss(pred,
target) -> scalar``, differentiable by autograd; the reference's module
wrappers are combinators (``clamp_loss_of``, ``luminance_weighted`` ...),
as in the JAX package.  The fixed filters are the JAX package's: the LBP
filters from ``np.random.default_rng(seed)`` (bit-equal), AlexNet's first
layer from ``_alex11.npy`` (a copy of the JAX package's file), the DCT and
DFT bases from numpy.

Random-augmented losses (``dctirm``, ``dctir24``) take a
``torch.Generator`` where the JAX package takes a PRNG key; the two give
different numbers, so they agree only on the deterministic path (no
generator: a fixed 45 degree rotation and a centred translate) and on
explicit angles and offsets (``rotate_expand``, ``translate_by``).
The GAN losses are plain functions that the GAN step
(``training/gan.py``) calls.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

LUMINANCE_WEIGHT = (0.29891, 0.58661, 0.11448)


def _const(a, like: torch.Tensor) -> torch.Tensor:
    """numpy constant ``a`` as an fp32 tensor on ``like``'s device."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(like.device)


# ---------------------------------------------------------------- primitives
def l1_loss(x, y):
    return torch.mean(torch.abs(x - y))


def l2_loss(x, y):
    return torch.mean((x - y) ** 2)


def charbonnier_loss(x, y, eps=1.0e-3):
    return torch.mean(torch.sqrt((x - y) ** 2 + eps * eps))


def huber_loss(x, y, delta=1.0):
    d = torch.abs(x - y)
    return torch.mean(torch.where(d <= delta, 0.5 * d * d,
                                  delta * (d - 0.5 * delta)))


def psnr(x, y):
    """Negative PSNR, an eval criterion (smaller is better)."""
    mse = torch.mean((x.clamp(0, 1) - y.clamp(0, 1)) ** 2)
    return -10.0 * torch.log10(1.0 / (mse + 1.0e-6))


def _to_luminance(x):
    if x.shape[-1] == 3:
        return torch.sum(x * _const(LUMINANCE_WEIGHT, x), dim=-1, keepdim=True)
    return x


def luminance_psnr(x, y):
    """Negative Y-PSNR (smaller is better)."""
    mse = torch.mean((_to_luminance(x).clamp(0, 1)
                      - _to_luminance(y).clamp(0, 1)) ** 2)
    return -10.0 * torch.log10(1.0 / (mse + 1.0e-6))


# ------------------------------------------------------------- combinators
def clamp_loss_of(loss_fn, min_value=0.0, max_value=1.0, eta=0.001,
                  clamp_l1=False):
    """The loss of clamped values plus eta times the unclamped term (L1 with
    ``clamp_l1``)."""
    def wrapped(x, y):
        clip = loss_fn(x.clamp(min_value, max_value),
                       y.clamp(min_value, max_value))
        noclip = l1_loss(x, y) if clamp_l1 else loss_fn(x, y)
        return clip + noclip * eta
    return wrapped


def channel_weighted(loss_fn, weights):
    """The loss of each channel alone, weighted."""
    weights = tuple(weights)

    def wrapped(x, y):
        return sum(loss_fn(x[..., i:i + 1], y[..., i:i + 1]) * w
                   for i, w in enumerate(weights))
    return wrapped


def luminance_weighted(loss_fn):
    return channel_weighted(loss_fn, LUMINANCE_WEIGHT)


def average_weighted(loss_fn, in_channels=3):
    return channel_weighted(loss_fn, [1.0 / in_channels] * in_channels)


def multiscale_loss(loss_fn, scale_factors=(1, 2), weights=None):
    """The loss averaged over box-downscaled pyramids."""
    from .resize import resize
    weights = weights or [1.0 / len(scale_factors)] * len(scale_factors)

    def wrapped(x, y):
        total = 0.0
        for s, w in zip(scale_factors, weights):
            if s == 1:
                total += loss_fn(x, y) * w
            else:
                h, wd = x.shape[-3] // s, x.shape[-2] // s
                total += loss_fn(resize(x, h, wd, mode="box"),
                                 resize(y, h, wd, mode="box")) * w
        return total
    return wrapped


def auxiliary_loss(loss_fns, weights):
    """Deep supervision: a loss for each output of a tuple."""
    def wrapped(preds, target):
        if not isinstance(preds, (tuple, list)):
            raise TypeError("auxiliary_loss takes a tuple of outputs")
        return sum(fn(p, target) * w
                   for p, fn, w in zip(preds, loss_fns, weights))
    return wrapped


# ------------------------------------------------------------------- LBP
@functools.lru_cache(maxsize=64)
def _lbcnn_filters(out_channels: int, in_channels: int, kernel_size: int,
                   sparsity: float = 0.9, seed: int = 71) -> np.ndarray:
    """Random +-1 sparse binary filters, HWIO (the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    f = rng.binomial(1, 0.5, (out_channels, in_channels, kernel_size,
                              kernel_size)).astype(np.float32) * 2 - 1
    f[rng.uniform(size=f.shape) > sparsity] = 0
    return f.transpose(2, 3, 1, 0)


@functools.lru_cache(maxsize=64)
def _lbp_kernel(in_channels: int, out_channels: int, kernel_size: int,
                seed: int = 71) -> np.ndarray:
    """The LBP kernel, HWIO: filter 0 replaced by a scaled identity."""
    k = _lbcnn_filters(out_channels, in_channels, kernel_size,
                       seed=seed).copy()
    k[..., 0] = 0
    k[kernel_size // 2, kernel_size // 2, :, 0] = 0.5 * kernel_size ** 2
    return k / kernel_size


def _grouped_conv(x, kernel_hwio, groups):
    """VALID conv of NHWC x with an HWIO kernel, ``groups`` groups, in x's
    dtype."""
    w = _const(kernel_hwio, x).permute(3, 2, 0, 1).to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, groups=groups)
    return y.permute(0, 2, 3, 1)


def lbp_loss(in_channels=1, out_channels=64, kernel_size=3, seed=71,
             base_loss=charbonnier_loss):
    """Local-binary-pattern conv loss: ``base_loss`` of the two images'
    responses to the fixed LBP filters."""
    ks = _lbp_kernel(in_channels, out_channels - out_channels % in_channels,
                     kernel_size, seed=seed)

    def wrapped(x, y):
        return base_loss(_grouped_conv(x, ks, in_channels),
                         _grouped_conv(y, ks, in_channels))
    return wrapped


def ylbp_loss(kernel_size=3, out_channels=64):
    inner = luminance_weighted(lbp_loss(1, out_channels, kernel_size))
    return clamp_loss_of(inner, clamp_l1=True)


def _rgb_to_yrgb(x, y_clamp=True):
    xc = x.clamp(0, 1) if y_clamp else x
    y = torch.sum(xc * _const(LUMINANCE_WEIGHT, x), dim=-1, keepdim=True)
    return torch.cat([y, x], dim=-1)


def yrgb_lbp_loss(kernel_size=5):
    inner = clamp_loss_of(
        average_weighted(lbp_loss(1, 64, kernel_size), in_channels=4),
        clamp_l1=True)

    def wrapped(x, y):
        return inner(_rgb_to_yrgb(x), _rgb_to_yrgb(y))
    return wrapped


# ------------------------------------------------------------------- DCT/FFT
@functools.lru_cache(maxsize=16)
def _dct_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis (n, n)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    b = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * np.sqrt(2.0 / n)
    b[0] *= 1.0 / np.sqrt(2.0)
    return b.astype(np.float32)


def dct2(x):
    """2-D DCT over the spatial dims of (..., H, W, C), fp32."""
    h, w = x.shape[-3], x.shape[-2]
    shape = x.shape
    xb = x.float().reshape((-1,) + tuple(shape[-3:]))
    y = torch.einsum("oh,bhwc->bowc", _const(_dct_basis(h), x), xb)
    y = torch.einsum("pw,bowc->bopc", _const(_dct_basis(w), x), y)
    return y.reshape(shape)


def _pad_hw(x, top, bottom, left, right):
    return F.pad(x, (0, 0, left, right, top, bottom))


def _window_partition_pad(x, window):
    """(B, H, W, C) -> (n, window, window, C) windows, zero padded (centred)
    to a multiple of the window."""
    b, h, w, c = x.shape
    ph = (-h) % window
    pw = (-w) % window
    if ph or pw:
        x = _pad_hw(x, ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)
    hh, ww = x.shape[1] // window, x.shape[2] // window
    x = x.reshape(b, hh, window, ww, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)


def dct_loss(window_size=8, base_loss=l1_loss, clamp=False, yrgb=True):
    """Windowed DCT loss; RGB inputs go to YRGB first; ``clamp`` compares
    the DCTs of clamped windows plus 0.001 x the unclamped L1."""
    def one(x, y):
        xw = _window_partition_pad(x, window_size)
        yw = _window_partition_pad(y, window_size)
        if clamp:
            noclip = l1_loss(x, y)
            clip = base_loss(dct2(xw.clamp(0, 1)), dct2(yw.clamp(0, 1)))
            return clip + noclip * 0.001
        return base_loss(dct2(xw), dct2(yw))

    def wrapped(x, y):
        if yrgb and x.shape[-1] == 3:
            x, y = _rgb_to_yrgb(x), _rgb_to_yrgb(y)
        return one(x, y)
    return wrapped


def fft_loss(window_size=8, amp_weight=1.0, phase_weight=1.0, clamp=True):
    """Windowed DFT amplitude + phase loss."""
    from .spectral import dft2

    def wrapped(x, y):
        if clamp:
            x, y = x.clamp(0, 1), y.clamp(0, 1)
        xr, xi = dft2(_window_partition_pad(x, window_size))
        yr, yi = dft2(_window_partition_pad(y, window_size))
        ax = torch.sqrt(xr ** 2 + xi ** 2 + 1e-12)
        ay = torch.sqrt(yr ** 2 + yi ** 2 + 1e-12)
        amp = torch.mean(torch.abs(ax - ay))
        phase = torch.mean(torch.sqrt(
            (xr / (ax + 1e-8) - yr / (ay + 1e-8)) ** 2
            + (xi / (ax + 1e-8) - yi / (ay + 1e-8)) ** 2 + 1e-12))
        return amp * amp_weight + phase * phase_weight
    return wrapped


def gradient_loss(base_loss=l1_loss):
    """``base_loss`` of the images and of their finite differences."""
    def grads(x):
        return x[:, 1:] - x[:, :-1], x[:, :, 1:] - x[:, :, :-1]

    def wrapped(x, y):
        xgx, xgy = grads(x)
        ygx, ygy = grads(y)
        return base_loss(x, y) + base_loss(xgx, ygx) + base_loss(xgy, ygy)
    return wrapped


# ------------------------------------------------------------------- GAN
def sigmoid_bce(logits, labels):
    """Binary cross-entropy on logits (the JAX package's
    ``optax_sigmoid_bce``)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def gan_bce_loss(logits, is_real: bool):
    labels = torch.ones_like(logits) if is_real else torch.zeros_like(logits)
    return torch.mean(sigmoid_bce(logits, labels))


def gan_hinge_loss_d(real_logits, fake_logits):
    return torch.mean(F.relu(1.0 - real_logits)) + \
        torch.mean(F.relu(1.0 + fake_logits))


def gan_hinge_loss_g(fake_logits):
    return -torch.mean(fake_logits)


def gan_softplus_loss_d(real_logits, fake_logits):
    return torch.mean(F.softplus(-real_logits)) + \
        torch.mean(F.softplus(fake_logits))


def gan_softplus_loss_g(fake_logits):
    return torch.mean(F.softplus(-fake_logits))


def r1_regularization(disc_fn, real, gamma=10.0):
    """R1 penalty gamma / 2 E ||d D(x) / dx||^2 (``disc_fn(x)`` the
    discriminator's logits; the JAX function takes ``(disc_fn, params,
    real)``).  Differentiable: the gradient is taken with a graph."""
    real = real.detach().requires_grad_(True)
    g, = torch.autograd.grad(disc_fn(real).sum(), real, create_graph=True)
    return 0.5 * gamma * torch.mean(torch.sum(g ** 2, dim=(1, 2, 3)))


# --------------------------------------------------------------------------
# Alex11: AlexNet's first-layer 11x11 filters (grayscale-projected,
# L2-normalised, filter 31 the identity) on each channel; Charbonnier on
# the responses, the channel maximum, the mean.
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _alex11_filter() -> np.ndarray:
    return np.load(os.path.join(os.path.dirname(__file__), "_alex11.npy"))


def alex11_loss(in_channels=3, eps=1.0e-3):
    kernel = _alex11_filter()  # (11, 11, 1, 64) HWIO

    def conv(x):
        c = x.shape[-1]
        return _grouped_conv(x, np.tile(kernel, (1, 1, 1, c)), c)

    def loss_fn(x, y):
        fy = conv(x * 2.0 - 1.0)
        ft = conv(y * 2.0 - 1.0)
        d = torch.sqrt((fy.float() - ft.float()) ** 2 + eps ** 2)
        return torch.mean(torch.amax(d, dim=-1))
    return loss_fn


# --------------------------------------------------------------------------
# Flat color loss: L2 masked to the cells whose target is one flat color.
# --------------------------------------------------------------------------

def get_flat_color_mask(y, size=8, eps=1e-5):
    y = y.detach()
    b, h, w, c = y.shape
    ph = (size - h % size) % size
    pw = (size - w % size) % size
    yp = _pad_hw(y, ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)
    hp, wp = yp.shape[1:3]
    cells = yp.reshape(b, hp // size, size, wp // size, size, c)
    center = cells[:, :, :1, :, :1, :]
    diff_max = torch.abs(cells - center).amax(dim=(2, 4, 5))
    mask = (diff_max < eps).to(y.dtype)
    mask = mask.reshape(b, hp // size, 1, wp // size, 1, 1).expand(
        b, hp // size, size, wp // size, size, 1).reshape(b, hp, wp, 1)
    return mask[:, ph // 2:ph // 2 + h, pw // 2:pw // 2 + w]


def flat_color_loss(input, target, size=8):
    mask = get_flat_color_mask(target, size=size)
    return torch.mean(((input - target) ** 2) * mask)


def flat_color_weighted_loss(input, target, size=8):
    return torch.mean(torch.abs(input - target)) + \
        flat_color_loss(input, target, size=size)


# --------------------------------------------------------------------------
# trivial wrappers
# --------------------------------------------------------------------------

def identity_loss():
    """The model's output is the loss."""
    def loss_fn(x, y=None):
        return torch.mean(x)
    return loss_fn


def weighted_loss(loss_fns, weights):
    """Sum of weighted losses on the same (x, y)."""
    def loss_fn(x, y):
        return sum(w * f(x, y) for f, w in zip(loss_fns, weights))
    return loss_fn


# --------------------------------------------------------------------------
# Masked hinge GAN loss: only patch logits over the inpainting hole count.
# --------------------------------------------------------------------------

def _masked_mean(x, mask):
    m = mask.float()
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def gan_mask_hinge_loss_d(real_logits, fake_logits, mask):
    real = _masked_mean(torch.clamp(real_logits.float() - 1, max=0.0), mask)
    fake = _masked_mean(torch.clamp(-fake_logits.float() - 1, max=0.0), mask)
    return -(real + fake)


def gan_mask_hinge_loss_g(fake_logits, mask):
    return -_masked_mean(fake_logits.float(), mask)


# --------------------------------------------------------------------------
# Differentiable pair augments and the augmented DCT losses.  As in the
# JAX package, a rotation expands to the static diagonal bound (the
# reference expands to each angle's own bounding box).
# --------------------------------------------------------------------------

def rotate_expand(x, angle, out_hw=None):
    """Rotate (B, H, W, C) by ``angle`` (radians, (B,) or a scalar) about
    the image centre; bilinear, zeros padding, the output expanded to the
    diagonal bound (or ``out_hw``)."""
    from .grid_sample import grid_sample
    b, h, w, _c = x.shape
    angle = torch.as_tensor(angle, dtype=torch.float32,
                            device=x.device).expand(b)
    if out_hw is None:
        d = int(np.ceil(np.sqrt(h * h + w * w)))
        oh = ow = d + (d % 2)
    else:
        oh, ow = out_hw
    yy = torch.arange(oh, dtype=torch.float32, device=x.device) - (oh - 1) / 2.0
    xx = torch.arange(ow, dtype=torch.float32, device=x.device) - (ow - 1) / 2.0
    gy, gx = torch.meshgrid(yy, xx, indexing="ij")
    ca = torch.cos(angle)[:, None, None]
    sa = torch.sin(angle)[:, None, None]
    ix = ca * gx + sa * gy          # output -> input (inverse rotation)
    iy = -sa * gx + ca * gy
    nx = ix / max((w - 1) / 2.0, 1.0)
    ny = iy / max((h - 1) / 2.0, 1.0)
    grid = torch.stack([nx, ny], dim=-1)
    return grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                       align_corners=True)


def translate_by(x, y, offsets, size=12):
    """Both images padded by 2 ``size`` zeros on each side, then cropped to
    (H + 2 size, W + 2 size) at ``offsets`` (B, 2) (row, column) in [0, 2
    size]: a shift of both by the same offset."""
    b, h, w, _c = x.shape
    p = 2 * size
    xp = _pad_hw(x, p, p, p, p)
    yp = _pad_hw(y, p, p, p, p)
    oh, ow = h + 2 * size, w + 2 * size
    rows = [(int(r), int(c)) for r, c in offsets.tolist()]
    return (torch.stack([xp[i, r:r + oh, c:c + ow] for i, (r, c) in enumerate(rows)]),
            torch.stack([yp[i, r:r + oh, c:c + ow] for i, (r, c) in enumerate(rows)]))


def translate_pair(x, y, generator=None, size=12, instance_random=True):
    """Shift both images by one random integer offset in [-size, size] per
    instance (or per batch), the canvas expanded by ``size`` each side.
    Without a generator, centred (no shift), the reference's eval path."""
    b = x.shape[0]
    if generator is None:
        off = torch.full((b, 2), size, dtype=torch.int64)
    else:
        n = b if instance_random else 1
        off = torch.randint(0, 2 * size + 1, (n, 2), generator=generator,
                            device=generator.device).cpu().expand(b, 2)
    return translate_by(x, y, off, size=size)


def _dct_window_loss(x, y, window_size, base_loss, clamp, overlap):
    def one(xw, yw):
        if clamp:
            noclip = l1_loss(xw, yw)
            clip = base_loss(dct2(xw.clamp(0, 1)), dct2(yw.clamp(0, 1)))
            return clip + noclip * 0.001
        return base_loss(dct2(xw), dct2(yw))

    if window_size is None:
        return one(x, y)
    l1v = one(_window_partition_pad(x, window_size),
              _window_partition_pad(y, window_size))
    if not overlap:
        return l1v
    p = window_size // 2
    l2v = one(_window_partition_pad(_pad_hw(x, p, p, p, p), window_size),
              _window_partition_pad(_pad_hw(y, p, p, p, p), window_size))
    return (l1v + l2v) * 0.5


def _uniform_angles(generator, n):
    return torch.rand((n,), generator=generator,
                      device=generator.device).cpu() * (2 * np.pi)


def dct_loss_ex(window_size=None, base_loss=l1_loss, clamp=False,
                overlap=False, rotate=None, yrgb=True):
    """DCT loss with the reference's options: ``window_size=None`` the
    whole image; ``overlap`` averages in a half-window-shifted pass;
    ``rotate`` in {None, "diag", "batch_random", "instance_random"} adds the
    loss of the rotated pair.  Returns fn(x, y, generator=None); the random
    rotations draw their angles from the generator (without one, 45
    degrees), and the fn is marked ``needs_rng``."""
    def wrapped(x, y, generator=None):
        if yrgb and x.shape[-1] == 3:
            x, y = _rgb_to_yrgb(x), _rgb_to_yrgb(y)
        loss1 = _dct_window_loss(x, y, window_size, base_loss, clamp, overlap)
        if rotate is None:
            return loss1
        b = x.shape[0]
        if generator is None or rotate == "diag":
            ang = torch.full((b,), np.pi / 4)
        elif rotate == "instance_random":
            ang = _uniform_angles(generator, b)
        else:
            ang = _uniform_angles(generator, 1).expand(b)
        loss2 = _dct_window_loss(rotate_expand(x, ang), rotate_expand(y, ang),
                                 window_size, base_loss, clamp, overlap)
        return loss1 * 0.5 + loss2

    wrapped.needs_rng = rotate in ("batch_random", "instance_random")
    return wrapped


def weighted_loss_ex(loss_fns, weights, preprocess_pair=None):
    """Weighted sum of losses on one pair, ``preprocess_pair`` (a possibly
    random augment) run once first; sub-losses marked ``needs_rng`` get the
    generator too."""
    def loss_fn(x, y, generator=None):
        if preprocess_pair is not None:
            x, y = preprocess_pair(x, y, generator)
        total = 0.0
        for f, w in zip(loss_fns, weights):
            if getattr(f, "needs_rng", False):
                total += w * f(x, y, generator)
            else:
                total += w * f(x, y)
        return total

    loss_fn.needs_rng = True
    return loss_fn


def dctirm_loss(rotate=True, translate=True):
    fns = (dct_loss_ex(window_size=4, clamp=True),
           dct_loss_ex(window_size=24, clamp=True,
                       rotate="instance_random" if rotate else None),
           dct_loss_ex(window_size=None, clamp=True))
    pre = (lambda x, y, g: translate_pair(x, y, g, size=12)) \
        if translate else None
    return weighted_loss_ex(fns, (0.2, 0.2, 0.6), preprocess_pair=pre)


def dctir24_loss():
    return weighted_loss_ex(
        (dct_loss_ex(window_size=24, clamp=True, rotate="batch_random",
                     overlap=True),),
        (1.0,),
        preprocess_pair=lambda x, y, g: translate_pair(x, y, g, size=12))


# --------------------------------------------------------------------------
# Gradient / FFT composites
# --------------------------------------------------------------------------

def gradient_only_loss(diag=False, base_loss=l1_loss):
    """Finite differences against the detached neighbour, averaged over
    directions."""
    def grads(x):
        out = [x[:, 1:, 1:] - x[:, :-1, 1:].detach(),
               x[:, 1:, 1:] - x[:, 1:, :-1].detach()]
        if diag:
            out.append(x[:, 1:, 1:] - x[:, :-1, :-1].detach())
            out.append(x[:, 1:, 1:-1] - x[:, :-1, 2:].detach())
        return out

    def wrapped(x, y):
        gx, gy = grads(x), grads(y)
        return sum(base_loss(a, b) for a, b in zip(gx, gy)) / len(gx)
    return wrapped


def fft_ri_loss():
    """L1 over (real, imag) of the whole-image DFT (ortho)."""
    from .spectral import dft2

    def wrapped(x, y):
        xr, xi = dft2(x)
        yr, yi = dft2(y)
        return 0.5 * (torch.mean(torch.abs(xr - yr))
                      + torch.mean(torch.abs(xi - yi)))
    return wrapped


def yrgb_l1_lbp_loss(kernel_size=3, weight=0.4):
    lbp = yrgb_lbp_loss(kernel_size=kernel_size)
    l1 = clamp_loss_of(l1_loss)

    def wrapped(x, y):
        return l1(x, y) + lbp(x, y) * weight
    return wrapped


def yrgb_flat_lbp_loss(kernel_size=5, weight=0.4):
    lbp = yrgb_lbp_loss(kernel_size=kernel_size)
    flat = clamp_loss_of(flat_color_weighted_loss)

    def wrapped(x, y):
        return flat(x, y) + lbp(x, y) * weight
    return wrapped


def yrgb_l1_fft_gradient_loss(fft_weight=0.1, grad_weight=0.1, diag=False):
    l1 = clamp_loss_of(l1_loss)
    fft = fft_ri_loss()
    grad = clamp_loss_of(gradient_only_loss(diag=diag))

    def wrapped(x, y):
        x, y = _rgb_to_yrgb(x), _rgb_to_yrgb(y)
        return l1(x, y) + fft(x, y) * fft_weight + grad(x, y) * grad_weight
    return wrapped
