"""The stabilizer's passes (counterpart of ``nunif_tpu/stlizer/pipeline.py``):

1. keypoints (SuperPoint at ``resolution`` on the short side) and
   frame-to-frame matching, on the device;
2. each frame's shift and angle by ``find_transform``, batched over the
   clip on the device;
3. the trajectory smoothed on the host (gaussian / savgol filters, or the
   ``grad_opt`` objective: 400 Adam steps, on the CPU: three short 1-D
   series), each frame weighted by ``calc_scene_weight``;
4. the warp of every frame (``apply_transform``) with a border policy:
   black, crop, expand or outpaint (``light_outpaint_v1``), and ``--debug``
   (source | stabilised).

Passes 1-2 are cached in ``cache.py``'s ``.npz``, the JAX package's format.
The CLI's borders all fill with zeros, so the warp takes the gather
(``apply_transform``'s two-pass path on K3 needs border padding); black
is what a black border means.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..modules.resize import resize
from .cache import load_cache, save_cache

logger = logging.getLogger("nunif_tpu_torch.stlizer")

DEFAULT_RESOLUTION = 320
ANGLE_MAX_HARD = 90.0
KEYPOINT_COSINE_THRESHOLD = 0.65
MAX_KEYPOINTS = 512
BORDERS = ("black", "crop", "expand", "outpaint")


def calc_scene_weight(mean_match_scores):
    """A low mean match score (a likely scene change) weighs the frame's
    motion down; the first and last frames weigh 0."""
    score = np.asarray(mean_match_scores, np.float32)
    weight = np.clip((score - 0.5) / (0.75 - 0.5), 0, 1)
    weight = np.where(weight < 0.65, weight ** 2, weight)
    if len(weight):
        weight[0] = 0.0
        weight[-1] = 0.0
    return weight


def gaussian_kernel1d(kernel_size: int) -> np.ndarray:
    # torchvision's get_gaussian_kernel1d sigma
    sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    x = np.arange(kernel_size) - (kernel_size - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def savgol_kernel1d(kernel_size: int) -> np.ndarray:
    from scipy.signal import savgol_coeffs
    return savgol_coeffs(kernel_size, polyorder=2)


def smooth1d(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    pad = (len(kernel) - 1) // 2
    xp = np.pad(x, (pad, pad), mode="edge")
    return np.convolve(xp, kernel[::-1], mode="valid")


def conv1d_smoothing(tx, ty, ta, method, smoothing_seconds, fps):
    """The per-frame corrections (smoothed - path) of a gaussian or
    savgol filter over ``smoothing_seconds``."""
    ks = int(smoothing_seconds * float(fps))
    if ks % 2 == 0:
        ks += 1
    ks = max(ks, 3)
    kernel = (gaussian_kernel1d(ks) if method == "gaussian"
              else savgol_kernel1d(ks))
    return (smooth1d(tx, kernel) - tx, smooth1d(ty, kernel) - ty,
            smooth1d(ta, kernel) - ta)


def grad_opt_smoothing(tx, ty, ta, scene_weight, resolution,
                       iteration=400, penalty_weight=1e-3):
    """The path minimising its first / second / third differences
    (weighted by the scene weight) plus ``penalty_weight`` times its
    distance to the camera path: ``iteration`` steps of Adam (lr 0.05) as
    optax computes them, in fp32 on the CPU.  Returns the corrections."""
    from ..utils.superpoint import Adam
    rw = resolution / DEFAULT_RESOLUTION

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    targets = (f32(np.pad(tx, (0, 3), mode="edge") * rw),
               f32(np.pad(ty, (0, 3), mode="edge") * rw),
               f32(np.pad(ta, (0, 3), mode="edge")))
    sw = f32(np.pad(scene_weight, (0, 3)))

    def loss_fn(ps):
        total = 0.0
        for x, t in zip(ps, targets):
            f1 = x[1:] - x[:-1]
            f2 = f1[1:] - f1[:-1]
            f3 = f2[1:] - f2[:-1]
            g = ((f1 ** 2 * sw[:f1.shape[0]]).mean()
                 + (f2 ** 2 * sw[:f2.shape[0]]).mean()
                 + (f3 ** 2 * sw[:f3.shape[0]]).mean())
            total = total + g / 9.0 + ((x - t) ** 2).mean() * penalty_weight
        return total

    ps = [t.clone() for t in targets]
    opt = Adam(ps, b1=0.9, b2=0.999)
    lr = torch.tensor(0.05, dtype=torch.float32)
    for _ in range(iteration):
        with torch.enable_grad():
            leaves = [p.requires_grad_(True) for p in ps]
            grads = torch.autograd.grad(loss_fn(leaves), leaves)
        ps = opt.step([p.detach() for p in ps], grads, (lr, lr, lr))
    px, py, pa = (p.numpy() for p in ps)
    return px[:-3] / rw - tx, py[:-3] / rw - ty, pa[:-3] - ta


def smooth_trajectory(shift_x, shift_y, angle, scene_weight, method,
                      smoothing_seconds, fps, resolution):
    """Per-frame corrections of the cumulative path."""
    sx = np.asarray(shift_x) * scene_weight
    sy = np.asarray(shift_y) * scene_weight
    an = np.clip(np.asarray(angle), -ANGLE_MAX_HARD, ANGLE_MAX_HARD) * scene_weight
    tx, ty, ta = sx.cumsum(), sy.cumsum(), an.cumsum()
    if method in {"gaussian", "savgol"}:
        return conv1d_smoothing(tx, ty, ta, method, smoothing_seconds, fps)
    if method == "grad_opt":
        return grad_opt_smoothing(tx, ty, ta, scene_weight, resolution,
                                  penalty_weight=2e-3 / smoothing_seconds)
    raise ValueError(method)


def seeded_superpoint(device, seed: int = 0):
    """``SuperPoint(max_num_keypoints=512)`` with flax's init drawn from
    ``seed`` (keypoints without meaning: tests and smoke runs only)."""
    from ..models import init_flax_default
    from ..utils.superpoint import SuperPoint
    with torch.device(device):
        model = SuperPoint(max_num_keypoints=MAX_KEYPOINTS)
    init_flax_default(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


@torch.no_grad()
def analysis_pass(input_path, resolution, batch_size, max_fps, superpoint,
                  iteration=50):
    """Passes 1 and 2: (shift_x, shift_y, angle, match scores) a frame,
    frame 0 the identity, and (fps, resize_scale, center, frames)."""
    from ..utils.superpoint import find_match_index, find_transform
    from ..video import backend
    from ..video.engine import FixedFPSRetimer, guess_fps
    device = next(superpoint.parameters()).device
    reader = backend.VideoReader(input_path)
    fps = guess_fps(reader, max_fps)
    retimer = FixedFPSRetimer(fps)
    scale = resolution / min(reader.width, reader.height)
    rh = int(reader.height * scale) // 8 * 8
    rw = int(reader.width * scale) // 8 * 8
    resize_scale = 1.0 / scale
    center = (rw / 2, rh / 2)
    prev = None
    scores, pairs1, pairs2, masks = [], [], [], []

    def detect(frames):
        nonlocal prev
        x = torch.from_numpy(np.stack(frames)).to(device).float() / 255.0
        kp = superpoint(resize(x, rh, rw, mode="bilinear", antialias=True))
        for i in range(len(frames)):
            cur = {k: v[i] for k, v in kp.items()}
            if prev is not None:
                _i1, i2, valid, sims = find_match_index(
                    prev, cur, threshold=KEYPOINT_COSINE_THRESHOLD)
                scores.append(sims.mean())
                pairs1.append(prev["keypoints"])
                pairs2.append(cur["keypoints"][i2])
                masks.append(valid)
            prev = cur

    batch = []
    n_frames = 0
    try:
        for frame, pts in reader:
            for f in retimer(frame, pts):
                batch.append(f)
                n_frames += 1
                if len(batch) >= batch_size:
                    detect(batch)
                    batch = []
        for f in retimer.flush():
            batch.append(f)
            n_frames += 1
        if batch:
            detect(batch)
    finally:
        reader.close()
    if not pairs1:
        return (np.zeros(0), np.zeros(0), np.zeros(0), np.zeros(0),
                float(fps), resize_scale, center, n_frames)
    B = len(pairs1)
    ctr = torch.tensor(center, dtype=torch.float32, device=device).reshape(
        1, 1, 2).expand(B, 1, 2)
    shift, _scale, ang = find_transform(
        torch.stack(pairs1), torch.stack(pairs2), ctr, torch.stack(masks),
        iteration=iteration, sigma=2.0, disable_scale=True)
    shift, ang = shift.cpu().numpy(), ang.cpu().numpy()
    match = torch.stack(scores).cpu().numpy().astype(np.float64)
    return (np.concatenate([[0.0], shift[:, 0]]),
            np.concatenate([[0.0], shift[:, 1]]),
            np.concatenate([[0.0], ang]), np.concatenate([[0.0], match]),
            float(fps), resize_scale, center, n_frames)


def default_cache_dir() -> str:
    root = os.environ.get("NUNIF_TPU_HOME", os.path.join(
        os.path.expanduser("~"), ".cache", "nunif_tpu"))
    d = os.path.join(root, "stlizer_cache")
    os.makedirs(d, exist_ok=True)
    return d


def _warp_bound(fx, fy, fa, resize_scale, H, W) -> int:
    """The displacement bound of the warp from the trajectory's extremes,
    rounded up to a multiple of 8."""
    diag = 0.5 * float(np.hypot(H, W))
    mx = (max(float(np.max(np.abs(fx))), float(np.max(np.abs(fy)))) * resize_scale
          + abs(np.sin(np.radians(float(np.max(np.abs(fa)))))) * diag)
    return int(max(8, -(-int(mx + 1) // 8) * 8))


def stabilize_video(input_path, output_path, *, resolution=DEFAULT_RESOLUTION,
                    smoothing=2.0, filter_name="gaussian", border="black",
                    padding=0.05, batch_size=8, max_fps=30.0,
                    cache_dir=None, use_cache=True, iteration=50,
                    debug=False, superpoint=None, video_config=None,
                    outpaint_model=None, progress_callback=None,
                    device="cuda", seed=0):
    """Stabilise ``input_path`` into ``output_path``; returns {"frames",
    "fps", "stats": the warp pass's stage times}.  ``superpoint``: a
    ``SuperPoint`` module (default: seeded from ``seed``, with a warning);
    ``outpaint_model``: a ``LightOutpaintV1`` for ``border="outpaint"``
    (default: seeded)."""
    from ..core.device import resolve_device
    from ..utils.superpoint import apply_transform
    from ..video import engine
    if border not in BORDERS:
        raise ValueError(f"border {border!r} not in {BORDERS}")
    device = resolve_device(device)
    if use_cache and cache_dir is None:
        cache_dir = default_cache_dir()
    if not use_cache:
        cache_dir = None
    cached = load_cache(input_path, cache_dir) if cache_dir else None
    if cached is not None:
        logger.info("stlizer: using the cached analysis")
        shift_x, shift_y = cached["shift_x"], cached["shift_y"]
        angle, scene_weight = cached["angle"], cached["scene_weight"]
        fps, resize_scale = float(cached["fps"]), float(cached["resize_scale"])
        center = tuple(cached["center"])
    else:
        if superpoint is None:
            logger.warning("stlizer: SuperPoint random init (no checkpoint); "
                           "keypoints are meaningless, smoke use only")
            superpoint = seeded_superpoint(device, seed)
        (shift_x, shift_y, angle, scores, fps, resize_scale, center,
         _n) = analysis_pass(input_path, resolution, batch_size, max_fps,
                             superpoint, iteration=iteration)
        scene_weight = calc_scene_weight(scores)
        if cache_dir:
            save_cache(input_path, cache_dir, shift_x=shift_x, shift_y=shift_y,
                       angle=angle, scene_weight=scene_weight, fps=fps,
                       resize_scale=resize_scale, center=center)
    if len(shift_x) == 0:
        raise RuntimeError("no frames analyzed")
    fx, fy, fa = smooth_trajectory(shift_x, shift_y, angle, scene_weight,
                                   filter_name, smoothing, fps, resolution)
    cx, cy = center[0] * resize_scale, center[1] * resize_scale
    if border == "outpaint" and outpaint_model is None:
        from ..models import create_model, init_flax_default
        from . import light_outpaint_v1  # noqa: F401  (registers the net)
        with torch.device(device):
            outpaint_model = create_model("stlizer.light_outpaint_v1")
        init_flax_default(outpaint_model,
                          torch.Generator(device=device).manual_seed(seed))
        outpaint_model.eval().requires_grad_(False)
        logger.warning("stlizer outpaint: random init (no checkpoint); "
                       "structure / smoke use only")
    index = [0]

    @torch.no_grad()
    def callback(batch_u8):
        B = batch_u8.shape[0]
        i = index[0]
        index[0] += B
        x = torch.as_tensor(batch_u8).to(device).float() / 255.0
        H, W = x.shape[1:3]
        c0, c1 = cx, cy
        if border == "expand":
            pad_px = int(max(H, W) * padding)
            x = torch.nn.functional.pad(x, (0, 0, pad_px, pad_px, pad_px, pad_px))
            c0, c1 = cx + pad_px, cy + pad_px
        at = [min(i + j, len(fx) - 1) for j in range(B)]
        shifts = torch.tensor([[fx[k] * resize_scale, fy[k] * resize_scale]
                               for k in at], dtype=torch.float32, device=device)
        angles = torch.tensor([fa[k] for k in at], dtype=torch.float32,
                              device=device)
        centers = torch.tensor([[c0, c1]], dtype=torch.float32,
                               device=device).expand(B, 2)
        ones = torch.ones((B,), device=device)
        # every border of the CLI fills with zeros: the gather path
        y = apply_transform(x, shifts, ones, angles, centers, padding_mode="zeros",
                            max_shift=_warp_bound(fx, fy, fa, resize_scale, H, W))
        if border == "crop":
            crop_px = int(max(H, W) * padding)
            y = y[:, crop_px:H - crop_px, crop_px:W - crop_px]
        elif border == "outpaint":
            from .light_outpaint_v1 import outpaint_infer
            valid = apply_transform(torch.ones_like(x[..., :1]), shifts, ones,
                                    angles, centers, padding_mode="zeros")
            mask = (valid < 0.999).to(x.dtype)
            y = outpaint_infer(outpaint_model, torch.clamp(y, 0.0, 1.0) * (1 - mask),
                               mask)
        if debug:  # source | stabilised
            src = x
            if src.shape[1:3] != y.shape[1:3]:
                src = resize(src, y.shape[1], y.shape[2], mode="bilinear",
                             antialias=False)
            y = torch.cat([src, y], dim=2)
        return torch.clamp(y, 0.0, 1.0)

    stats = engine.process_video(
        input_path, output_path, callback, batch_size=batch_size,
        config=video_config or engine.VideoOutputConfig(max_fps=max_fps),
        progress_callback=progress_callback, device=device)
    return {"frames": len(shift_x), "fps": fps, "stats": stats}
