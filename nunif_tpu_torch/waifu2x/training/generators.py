"""Synthetic training-image generators (host-side PIL / numpy), copied from
``nunif_tpu/waifu2x/training/generators.py`` so that a seed gives the same
images in both packages.

Behavioral parity target: reference waifu2x/training/screentone_generator.py,
dot_generator.py, text_image_generator.py — procedural screentone/halftone,
dot-grid and text-like images mixed into training so the model learns
high-frequency patterns without needing a dataset (also used here to
smoke-test training end-to-end with zero external data).
"""
from __future__ import annotations

import random

import numpy as np
from PIL import Image, ImageDraw


def _rand_color(rng, grayscale_p=0.5):
    if rng.random() < grayscale_p:
        v = rng.randint(0, 255)
        return (v, v, v)
    return tuple(rng.randint(0, 255) for _ in range(3))


def gen_screentone(size: int = 640, seed=None) -> Image.Image:
    """Halftone-style dot screen (reference screentone_generator.py)."""
    rng = random.Random(seed)
    bg = _rand_color(rng)
    fg = _rand_color(rng)
    im = Image.new("RGB", (size, size), bg)
    draw = ImageDraw.Draw(im)
    pitch = rng.randint(4, 24)
    radius = max(1, int(pitch * rng.uniform(0.2, 0.45)))
    phase = rng.random() < 0.5
    for yi, y in enumerate(range(-pitch, size + pitch, pitch)):
        offset = (pitch // 2) if (phase and yi % 2 == 1) else 0
        for x in range(-pitch, size + pitch, pitch):
            cx = x + offset
            draw.ellipse((cx - radius, y - radius, cx + radius, y + radius),
                         fill=fg)
    if rng.random() < 0.5:
        im = im.rotate(rng.uniform(-45, 45), resample=Image.BILINEAR,
                       fillcolor=bg)
    return im


def gen_dot_grid(size: int = 640, seed=None) -> Image.Image:
    """1-4px dot/line grid patterns (reference dot_generator.py)."""
    rng = random.Random(seed)
    bg = _rand_color(rng)
    fg = _rand_color(rng)
    im = Image.new("RGB", (size, size), bg)
    draw = ImageDraw.Draw(im)
    cell = rng.randint(2, 8)
    dot = rng.randint(1, max(1, cell // 2))
    kind = rng.choice(["dots", "hlines", "vlines", "checker"])
    for y in range(0, size, cell):
        for x in range(0, size, cell):
            if kind == "dots":
                draw.rectangle((x, y, x + dot - 1, y + dot - 1), fill=fg)
            elif kind == "hlines":
                draw.rectangle((0, y, size, y + dot - 1), fill=fg)
                break
            elif kind == "vlines" and y == 0:
                draw.rectangle((x, 0, x + dot - 1, size), fill=fg)
            elif kind == "checker" and ((x // cell + y // cell) % 2 == 0):
                draw.rectangle((x, y, x + cell - 1, y + cell - 1), fill=fg)
    return im


def gen_text_image(size: int = 640, seed=None) -> Image.Image:
    """Text-like glyph strokes (reference text_image_generator.py, without
    font dependencies: random short strokes and boxes mimic glyph edges)."""
    rng = random.Random(seed)
    bg = _rand_color(rng)
    fg = _rand_color(rng)
    im = Image.new("RGB", (size, size), bg)
    draw = ImageDraw.Draw(im)
    line_h = rng.randint(10, 32)
    stroke = max(1, line_h // 10)
    y = rng.randint(0, line_h)
    while y < size - line_h:
        x = rng.randint(0, line_h)
        while x < size - line_h:
            glyph_w = rng.randint(line_h // 2, line_h)
            n_strokes = rng.randint(2, 6)
            for _ in range(n_strokes):
                x0 = x + rng.randint(0, glyph_w)
                y0 = y + rng.randint(0, line_h)
                x1 = x + rng.randint(0, glyph_w)
                y1 = y + rng.randint(0, line_h)
                draw.line((x0, y0, x1, y1), fill=fg, width=stroke)
            x += glyph_w + stroke * 2
        y += int(line_h * rng.uniform(1.2, 1.8))
    return im


def gen_shapes(size: int = 640, seed=None) -> Image.Image:
    """Anti-aliased vector art: overlapping ellipses/polygons/lines/arcs
    rendered at 2x and LANCZOS-downscaled, over a flat or gradient
    background.  Teaches the SR model clean anti-aliased edge
    reconstruction — the dominant content of line art / anime frames
    (the reference trains on real art; this is the zero-dataset stand-in)."""
    rng = random.Random(seed)
    ss = 2
    big = size * ss
    bg = _rand_color(rng, grayscale_p=0.3)
    im = Image.new("RGB", (big, big), bg)
    draw = ImageDraw.Draw(im)
    if rng.random() < 0.4:  # vertical gradient background
        c2 = _rand_color(rng, grayscale_p=0.3)
        for y in range(big):
            t = y / max(big - 1, 1)
            col = tuple(int(a + (b - a) * t) for a, b in zip(bg, c2))
            draw.line((0, y, big, y), fill=col)
    n = rng.randint(8, 40)
    for _ in range(n):
        fg = _rand_color(rng, grayscale_p=0.3)
        kind = rng.choice(["ellipse", "poly", "line", "arc", "rect"])
        cx, cy = rng.randint(0, big), rng.randint(0, big)
        r = rng.randint(big // 40, big // 3)
        if kind == "ellipse":
            rx, ry = r, int(r * rng.uniform(0.3, 1.0))
            outline = rng.random() < 0.3
            if outline:
                draw.ellipse((cx - rx, cy - ry, cx + rx, cy + ry),
                             outline=fg, width=rng.randint(ss, 4 * ss))
            else:
                draw.ellipse((cx - rx, cy - ry, cx + rx, cy + ry), fill=fg)
        elif kind == "poly":
            k = rng.randint(3, 7)
            pts = [(cx + rng.randint(-r, r), cy + rng.randint(-r, r))
                   for _ in range(k)]
            draw.polygon(pts, fill=fg)
        elif kind == "line":
            x1, y1 = cx + rng.randint(-r, r), cy + rng.randint(-r, r)
            draw.line((cx, cy, x1, y1), fill=fg,
                      width=rng.randint(ss, 5 * ss))
        elif kind == "arc":
            a0 = rng.uniform(0, 360)
            draw.arc((cx - r, cy - r, cx + r, cy + r), a0,
                     a0 + rng.uniform(40, 300), fill=fg,
                     width=rng.randint(ss, 4 * ss))
        else:
            w2 = rng.randint(big // 40, r)
            draw.rectangle((cx, cy, cx + r, cy + w2), fill=fg)
    if rng.random() < 0.3:
        im = im.rotate(rng.uniform(-30, 30), resample=Image.BILINEAR,
                       fillcolor=bg)
    return im.resize((size, size), Image.LANCZOS)


def gen_gradient(size: int = 640, seed=None) -> Image.Image:
    """Smooth multi-stop radial/linear gradients (banding/flat-region
    fidelity: SR must not invent texture in smooth areas)."""
    rng = random.Random(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    if rng.random() < 0.5:
        ang = rng.uniform(0, 2 * np.pi)
        t = xx * np.cos(ang) + yy * np.sin(ang)
    else:
        cx, cy = rng.random(), rng.random()
        t = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    t = (t - t.min()) / max(t.max() - t.min(), 1e-6)
    c0 = np.asarray(_rand_color(rng, 0.3), np.float32)
    c1 = np.asarray(_rand_color(rng, 0.3), np.float32)
    img = c0[None, None] * (1 - t[..., None]) + c1[None, None] * t[..., None]
    return Image.fromarray(img.round().astype(np.uint8))


GENERATORS = {
    "screentone": gen_screentone,
    "dot": gen_dot_grid,
    "text": gen_text_image,
    "shapes": gen_shapes,
    "gradient": gen_gradient,
}

# shapes dominates the mix: anti-aliased edges are what 2x SR must learn;
# the pattern generators cover the aliased/high-frequency tail
_WEIGHTS = {"screentone": 1.0, "dot": 1.0, "text": 2.0, "shapes": 5.0,
            "gradient": 1.0}


def gen_random(size: int = 640, seed=None) -> Image.Image:
    rng = random.Random(seed)
    names = list(GENERATORS)
    name = rng.choices(names, weights=[_WEIGHTS[n] for n in names])[0]
    return GENERATORS[name](size, seed=rng.randint(0, 2 ** 31))
