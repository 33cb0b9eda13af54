"""Training-time degradations (host-side PIL / numpy), copied from
``nunif_tpu/waifu2x/training/degrade.py`` (with its ``_qtables.npz``);
``_matrix_resize`` takes the port's ``modules/resize.py`` matrices.

Behavioral parity target:
  * JPEG noise levels: reference waifu2x/training/jpeg_noise.py (NR_RATE
    apply probabilities, per-style quality tables, multi-pass compression,
    4:2:0/4:4:4 chroma-subsampling coin, sharpen-noise variants)
  * random downscale: reference waifu2x/training/dataset.py:44-146
    (filter-type lottery incl. no-antialias and two-step resizes, blur
    jitter).  The reference drives ImageMagick; here the same filters come
    from the framework's own resize matrices (modules/resize.py) + PIL —
    the "blur" parameter scales the filter support exactly like IM's
    -define filter:blur.
"""
from __future__ import annotations

import os
import random
from io import BytesIO

import numpy as np
from PIL import Image, ImageFilter

# reference jpeg_noise.py:11-25
NR_RATE = {
    "art": {0: 0.65, 1: 0.65, 2: 0.65, 3: 0.95},
    "photo": {0: 0.3, 1: 0.6, 2: 0.9, 3: 0.9},
}
JPEG_CHROMA_SUBSAMPLING_RATE = 0.5

EVAL_QUALITY = {
    "art": {0: [90], 1: [75], 2: [53, 46], 3: [53, 46]},
    "photo": {0: [90], 1: [80], 2: [60, 90], 3: [60, 90]},
}

# reference dataset.py INTERPOLATION_MODES (box/sinc/lanczos/triangle/catrom)
INTERPOLATION_MODES = ["box", "lanczos", "triangle", "catrom"]
INTERPOLATION_MODE_WEIGHTS = [1, 1, 1, 1]


def add_jpeg_noise(im: Image.Image, quality: int, subsampling: str):
    # reference jpeg_noise.py:78-86
    assert im.mode == "RGB"
    with BytesIO() as buff:
        im.save(buff, format="jpeg", quality=int(quality),
                subsampling=subsampling)
        buff.seek(0)
        out = Image.open(buff)
        out.load()
        return out


def choose_jpeg_quality(style: str, noise_level: int, rng=random):
    """reference jpeg_noise.py:98-157."""
    qualities = []
    if style == "art":
        if noise_level == 0:
            qualities.append(rng.randint(85, 95))
        elif noise_level == 1:
            qualities.append(rng.randint(65, 85))
        elif noise_level in {2, 3}:
            r = rng.uniform(0, 1)
            if r > 0.4:
                qualities.append(rng.randint(27, 70))
            elif r > 0.1:
                q1 = rng.randint(37, 95) if rng.uniform(0, 1) < 0.05 \
                    else rng.randint(37, 70)
                qualities += [q1, q1 - rng.randint(5, 10)]
            else:
                q1 = rng.randint(52, 95) if rng.uniform(0, 1) < 0.05 \
                    else rng.randint(52, 70)
                qualities += [q1, q1 - rng.randint(5, 15), q1 - rng.randint(15, 25)]
    elif style == "photo":
        if noise_level == 0:
            qualities.append(rng.randint(85, 95))
        elif noise_level == 1:
            qualities.append(rng.randint(37, 70) if rng.uniform(0, 1) < 0.5
                             else rng.randint(90, 98))
        elif noise_level in {2, 3}:
            q1 = rng.randint(52, 95) if rng.uniform(0, 1) < 0.05 \
                else rng.randint(37, 70)
            qualities.append(q1)
            if rng.uniform(0, 1) < 0.2:
                qualities.append(rng.randint(70, 90) if noise_level == 2
                                 else rng.randint(37, 90))
    else:
        raise NotImplementedError(style)
    return qualities


def sharpen_noise(original: Image.Image, noisy: Image.Image,
                  strength: float = 0.1):
    """Amplify the JPEG artifact difference (reference jpeg_noise.py:201-211)."""
    a = np.asarray(original, np.float32)
    b = np.asarray(noisy, np.float32)
    out = np.clip(b + (b - a) * strength, 0, 255).astype(np.uint8)
    return Image.fromarray(out)


_QTABLES = None


def _load_qtables():
    """104 sampled real-world JPEG quantization tables, converted from the
    reference's bundled _qtables_1.pth (reference jpeg_noise.py:44-45)."""
    global _QTABLES
    if _QTABLES is None:
        path = os.path.join(os.path.dirname(__file__), "_qtables.npz")
        arr = np.load(path)["qtables"]
        _QTABLES = [[arr[i, 0].tolist(), arr[i, 1].tolist()]
                    for i in range(arr.shape[0])]
    return _QTABLES


def add_jpeg_noise_qtable(im: Image.Image) -> Image.Image:
    """JPEG-compress with a random real-world qtable
    (reference jpeg_noise.py:88-94)."""
    buf = BytesIO()
    im.save(buf, format="jpeg", qtables=random.choice(_load_qtables()),
            subsampling="4:2:0")
    buf.seek(0)
    out = Image.open(buf)
    out.load()
    return out


class RandomJPEGNoise:
    """reference jpeg_noise.py:222-290 incl. the real-qtable branch (photo
    style, noise levels 2-3, p=0.25)."""

    def __init__(self, style: str, noise_level: int):
        assert noise_level in {0, 1, 2, 3} and style in {"art", "photo"}
        self.style = style
        self.noise_level = noise_level

    def __call__(self, x: Image.Image, y: Image.Image):
        original_x = x
        if random.uniform(0, 1) > NR_RATE[self.style][self.noise_level]:
            min_level = -1
            if self.style == "art":
                noise_level = random.randint(min_level, self.noise_level - 1)
            else:
                cand = list(range(min_level, self.noise_level))
                prob = list(range(1, len(cand) + 1))
                noise_level = random.choices(cand, prob, k=1)[0]
            if noise_level == -1:
                return x, y
        else:
            noise_level = self.noise_level

        if (self.style == "photo" and noise_level in {2, 3}
                and random.uniform(0, 1) < 0.25):
            # real-world qtable branch (reference jpeg_noise.py:250-266)
            x = add_jpeg_noise_qtable(x)
            strength_factor = 1.0 if noise_level == 3 else 0.75
            if random.uniform(0, 1) < 0.5 and random.uniform(0, 1) < 0.25:
                x = sharpen_noise(original_x, x,
                                  strength=random.uniform(0.05, 0.2)
                                  * strength_factor)
            return x, y

        qualities = choose_jpeg_quality(self.style, noise_level)
        subsampling = ("4:2:0" if random.uniform(0, 1) < JPEG_CHROMA_SUBSAMPLING_RATE
                       else "4:4:4")
        for i, quality in enumerate(qualities):
            x = add_jpeg_noise(x, quality=quality, subsampling=subsampling)
            if (i == 0 and self.style == "photo" and noise_level in {2, 3}
                    and random.uniform(0, 1) < 0.2):
                x = sharpen_noise(original_x, x,
                                  strength=random.uniform(0.05, 0.2))
        return x, y


def _pil_filter(name: str):
    return {
        "box": Image.Resampling.BOX,
        "triangle": Image.Resampling.BILINEAR,
        "lanczos": Image.Resampling.LANCZOS,
        "sinc": Image.Resampling.LANCZOS,
        "catrom": Image.Resampling.BICUBIC,
    }[name]


_KERNEL_NAMES = {"box": "box", "triangle": "bilinear", "lanczos": "lanczos",
                 "sinc": "lanczos", "catrom": "catrom"}


def _matrix_resize(arr: np.ndarray, out_h: int, out_w: int, mode: str,
                   blur: float = 1.0, antialias: bool = True):
    """Downscale via the framework resize matrices with IM-style blur
    (scales filter support)."""
    from ...modules.resize import resize_matrix
    mode = _KERNEL_NAMES.get(mode, mode)
    h, w, _ = arr.shape
    mh = resize_matrix(h, out_h, mode, antialias)
    mw = resize_matrix(w, out_w, mode, antialias)
    if blur != 1.0:
        # approximate IM's filter:blur by widening with a small gaussian
        sigma = abs(blur - 1.0) * 2.0
        im = Image.fromarray(np.clip(arr * 255, 0, 255).astype(np.uint8))
        if blur > 1.0:
            im = im.filter(ImageFilter.GaussianBlur(radius=sigma))
        arr = np.asarray(im, np.float32) / 255.0
        if blur < 1.0:
            arr2 = np.clip(arr + (arr - np.asarray(
                Image.fromarray((arr * 255).astype(np.uint8)).filter(
                    ImageFilter.GaussianBlur(radius=sigma)), np.float32) / 255.0),
                0, 1)
            arr = arr2
    out = np.einsum("oh,hwc->owc", mh, arr)
    out = np.einsum("pw,owc->opc", mw, out)
    return np.clip(out, 0.0, 1.0)


class RandomDownscale:
    """reference dataset.py:88-146 — random filter lottery with blur jitter,
    optional two-step resize and no-antialias branches."""

    def __init__(self, scale_factor: int, blur_shift: float = 0,
                 resize_blur_p: float = 0.1, resize_blur_range: float = 0.05,
                 resize_step_p: float = 0.0, resize_no_antialias_p: float = 0.0,
                 interpolation=None, training: bool = True):
        assert scale_factor in {1, 2, 4, 8}
        self.scale_factor = scale_factor
        self.blur_shift = blur_shift
        self.resize_blur_p = resize_blur_p
        self.resize_blur_range = (-resize_blur_range, resize_blur_range)
        self.resize_step_p = resize_step_p
        self.resize_no_antialias_p = resize_no_antialias_p
        self.interpolation = interpolation
        self.training = training

    def __call__(self, x: Image.Image, y: Image.Image):
        if self.scale_factor == 1:
            return x, y
        w, h = x.size
        assert w % self.scale_factor == 0 and h % self.scale_factor == 0
        ow, oh = w // self.scale_factor, h // self.scale_factor
        if self.interpolation is None:
            mode = random.choices(INTERPOLATION_MODES,
                                  INTERPOLATION_MODE_WEIGHTS, k=1)[0]
            fixed = False
        else:
            mode = self.interpolation
            fixed = True

        if self.scale_factor == 8:
            return x.resize((ow, oh), _pil_filter(mode)), y

        blur = 1.0
        if self.training and random.uniform(0, 1) < self.resize_blur_p:
            blur = 1 + random.uniform(self.resize_blur_range[0] + self.blur_shift,
                                      self.resize_blur_range[1] + self.blur_shift)
        arr = np.asarray(x, np.float32) / 255.0
        if (self.training and not fixed and self.resize_step_p > 0
                and random.uniform(0, 1) < self.resize_step_p):
            scale = h / oh
            s1 = random.uniform(1, scale)
            arr = _matrix_resize(arr, int(h / s1), int(w / s1), mode, 1.0)
            arr = _matrix_resize(arr, oh, ow, mode, blur)
        elif (self.training and not fixed
              and random.uniform(0, 1) < self.resize_no_antialias_p):
            mode2 = random.choice(["triangle", "catrom"])
            arr = _matrix_resize(arr, oh, ow, mode2, 1.0, antialias=False)
        else:
            arr = _matrix_resize(arr, oh, ow, mode, blur)
        x = Image.fromarray((arr * 255 + 0.5).astype(np.uint8))
        return x, y


class RandomUnsharpMask:
    """reference dataset.py da_unsharpmask (PIL UnsharpMask)."""

    def __call__(self, im: Image.Image):
        radius = random.uniform(0.75, 3.0)
        percent = random.randint(50, 200)
        threshold = random.randint(0, 4)
        return im.filter(ImageFilter.UnsharpMask(
            radius=radius, percent=percent, threshold=threshold))
