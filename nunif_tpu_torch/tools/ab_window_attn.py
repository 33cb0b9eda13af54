"""K4 and K6 of two source trees on one card, in turns: the window attention
(``ops/swin_attention.py:fused_window_attention``) and its image-layout form
(``fused_window_attention_image``), bf16, at the eight shapes of the
swin_unet_4xl 540p frame, imagenet swin_t's eight stage shapes (window 7,
batch 64) and one window-8 shape, with seeded inputs; and K1 / K5 (the
fused Swin block, which shares K4 / K6's attention body) at the swin_unet_2x
frame's shapes of ``tools/ab_swin_block.py``.

Each tree runs in a process of its own (each builds its own kernels under
its ``build/``), in the order A B B A.  Prints, for each run, ms a shape,
the K4 frame sum (launches a frame times ms), and the medians by tree of
the K4, K6, K1 and K5 frame sums and of each shape, with the share of the
shape's least time (bytes over 3.35 TB/s: qkv read once, the output and
the bias once); the host time of one K4, K1 and K2 call (the wrapper's
checks, its dispatch, the tensor maps and the launch, at one window or
one 8x8 tile), with autograd on and under ``torch.inference_mode`` (as
the renderer calls them); and whether every output (a
sha1 of each) and ``ab_swin_block.bitwise_digests`` are the same in both
trees.  Exits 1 if an output differs between the trees.

Usage: python -m nunif_tpu_torch.tools.ab_window_attn ROOT_A ROOT_B
(card only; ROOT_* are checkouts that hold ``nunif_tpu_torch/``)
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

HEADS, WS = 12, 6
# K4 / K6 at the 4xl's 540p shapes (C, H, W, shift) and launches a frame
# (chip_smoke.py:K4_FRAME)
FRAME = {(192, 576, 960, 0): 1, (192, 576, 960, 3): 1,
         (384, 288, 480, 0): 2, (384, 288, 480, 3): 2,
         (384, 144, 240, 0): 3, (384, 144, 240, 3): 3,
         (384, 576, 960, 0): 1, (384, 576, 960, 3): 1}
# (C, H = W, shift, window, batch): swin_t's stages, then window 8
# (chip_smoke.py:SWIN_T, WINDOW8)
WIDE = [(96, 56, 0, 7, 64), (96, 56, 3, 7, 64), (192, 28, 0, 7, 64),
        (192, 28, 3, 7, 64), (384, 14, 0, 7, 64), (384, 14, 3, 7, 64),
        (768, 7, 0, 7, 64), (768, 7, 3, 7, 64), (128, 64, 4, 8, 8)]
HBM_BYTES_PER_S = 3.35e12


def bound_ms(tokens, c, heads, n):
    """Least time of one launch: qkv read once, out written once (bf16),
    the fp32 bias read once."""
    return (tokens * 4 * c * 2 + heads * n * n * 4) / HBM_BYTES_PER_S * 1e3


def _sha1(torch, y) -> str:
    import hashlib
    bits = y.contiguous().view(torch.int16)
    return hashlib.sha1(bits.cpu().numpy().tobytes()).hexdigest()


def child(root: str) -> dict:
    """Time K4 / K6 (and K1 / K5) of the tree at ``root`` at every shape;
    {key: {"ms", "sha1"}}, the host time of a K4, K1 and K2 call and the
    digests."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from nunif_tpu_torch.modules.attention import expand_relative_bias
    from nunif_tpu_torch.modules.permute import window_partition2
    from nunif_tpu_torch.ops import conv3x3 as k2
    from nunif_tpu_torch.ops import swin_attention as k4
    from nunif_tpu_torch.tools import ab_swin_block, time_ms
    assert k4.__file__ == os.path.join(root, "nunif_tpu_torch", "ops",
                                       "swin_attention.py"), k4.__file__
    rng = np.random.default_rng(0)
    out = {}

    def run(key, fn, **extra):
        y = fn()
        out[key] = dict(ms=time_ms(fn, 5), sha1=_sha1(torch, y), **extra)
        del y

    shapes = [(c, h, w, shift, WS, 1) for c, h, w, shift in FRAME] + \
        [(c, hw, hw, shift, ws, b) for c, hw, shift, ws, b in WIDE]
    for c, h, w, shift, ws, batch in shapes:
        heads = HEADS if ws == 6 else c // 32
        qkv = torch.from_numpy(rng.standard_normal(
            (batch, h, w, 3 * c), dtype=np.float32)).to("cuda", torch.bfloat16)
        bias = expand_relative_bias(torch.from_numpy(rng.standard_normal(
            ((2 * ws - 1) ** 2, heads)).astype(np.float32)).to("cuda"), ws)
        qw = window_partition2(qkv, ws).contiguous()
        shape = (c, h, w, shift) if ws == 6 else (c, h, w, shift, ws, batch)
        least = bound_ms(batch * h * w, c, heads, ws * ws)
        run(f"K4 {shape}", lambda: k4.fused_window_attention(
            qw, bias, num_heads=heads, window=ws, shift=shift, n_wh=h // ws,
            n_ww=w // ws), bound_ms=least)
        run(f"K6 {shape}", lambda: k4.fused_window_attention_image(
            qkv, bias, num_heads=heads, window=ws, shift=shift), bound_ms=least)
        del qkv, qw
        torch.cuda.empty_cache()
    # host time of one call: one window (K2: one 8x8 tile), so the enqueue
    # bounds the loop
    def host_us(call):
        call()
        torch.cuda.synchronize()
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(500):
                call()
            host.append((time.perf_counter() - t0) / 500 * 1e6)
            torch.cuda.synchronize()
        return statistics.median(host)

    qkv = torch.zeros((1, 36, 3 * 192), device="cuda", dtype=torch.bfloat16)
    bias = torch.zeros((HEADS, 36, 36), device="cuda")
    weights = ab_swin_block.block_weights(torch, rng, 96)
    x1 = torch.zeros((1, 6, 6, 96), device="cuda", dtype=torch.bfloat16)
    packed1 = k4.pack_weights(*weights, torch.bfloat16)
    x2 = torch.zeros((1, 10, 10, 48), device="cuda", dtype=torch.bfloat16)
    kern = torch.zeros((3, 3, 48, 96), device="cuda")
    b2 = torch.zeros((96,), device="cuda")
    packed2 = (k2.pack_stem_weights(kern, torch.bfloat16), b2)
    calls = {
        "K4": lambda: k4.fused_window_attention(
            qkv, bias, num_heads=HEADS, window=6, shift=3, n_wh=1, n_ww=1),
        "K1": lambda: k4.fused_swin_block_image(
            x1, *weights, num_heads=6, window=6, shift=0, packed=packed1),
        "K2": lambda: k2.stem_conv3x3(
            x2, kern, b2, crop=0, lrelu_slope=0.1, packed=packed2)}
    out["host_us"] = {k: host_us(call) for k, call in calls.items()}
    # as the renderer and the model runtimes call them
    with torch.inference_mode():
        out["host_us"].update({f"{k} inference": host_us(call)
                               for k, call in calls.items()})
    # K1 / K5 at the 2x frame's shapes
    for c, h, w, shift, with_skip in ab_swin_block.SHAPES:
        weights = ab_swin_block.block_weights(torch, rng, c)
        x = torch.from_numpy(rng.normal(0, 0.5, (1, h, w, c)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        skip = torch.from_numpy(rng.normal(0, 0.5, (1, h, w, c)).astype(
            np.float32)).to("cuda", torch.bfloat16) if with_skip else None
        kw = dict(num_heads=6, window=6, shift=shift, skip=skip,
                  packed=k4.pack_weights(*weights, torch.bfloat16))
        run(f"K1 {(c, h, w, shift, with_skip)}",
            lambda: k4.fused_swin_block_image(x, *weights, **kw))
        del x, skip
        torch.cuda.empty_cache()
    for c, h, w, shift in ab_swin_block.K5_SHAPES:
        n_wh, n_ww = h // 6 + (shift > 0), w // 6 + (shift > 0)
        weights = ab_swin_block.block_weights(torch, rng, c)
        x = torch.from_numpy(rng.normal(0, 0.5, (n_wh * n_ww, 36, c)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        kw = dict(num_heads=6, window=6, shift=shift, n_wh=n_wh, n_ww=n_ww,
                  shift_mode="pad",
                  packed=k4.pack_weights(*weights, torch.bfloat16))
        run(f"K5 {(c, h, w, shift)}",
            lambda: k4.fused_swin_block(x, *weights, **kw))
        del x
        torch.cuda.empty_cache()
    out["digests"] = ab_swin_block.bitwise_digests()
    return out


def frame_sum(shapes: dict, label: str, launches: dict) -> float:
    return sum(shapes[f"{label} {k}"]["ms"] * n for k, n in launches.items())


def main(root_a: str, root_b: str) -> int:
    from nunif_tpu_torch.tools.ab_swin_block import K5_SHAPES, SHAPES, run_turns
    runs = run_turns(__file__, root_a, root_b,
                     {f"K4 {k}": n for k, n in FRAME.items()})
    tables = {"K4": FRAME, "K6": FRAME,
              "K1": {k: n for k, n in SHAPES.items()}, "K5": K5_SHAPES}
    for label in ("A", "B"):
        mine = [s for lab, s, _f in runs if lab == label]
        sums = {k: [frame_sum(s, k, t) for s in mine] for k, t in tables.items()}
        print(f"{label}: frame sums, median of {len(mine)}: " + ", ".join(
            f"{k} {statistics.median(v):.3f} ms {[round(x, 3) for x in v]}"
            for k, v in sums.items()))
        print(f"{label}: host time a call, median of {len(mine)}: " + ", ".join(
            f"{k} {statistics.median(s['host_us'][k] for s in mine):.1f} us"
            for k in ("K4", "K1", "K2", "K4 inference", "K1 inference",
                      "K2 inference")))
    keys = [k for k, v in runs[0][1].items() if isinstance(v, dict) and "ms" in v]
    for key in keys:
        if "bound_ms" not in runs[0][1][key]:
            continue
        b = runs[0][1][key]["bound_ms"]
        med = {lab: statistics.median(s[key]["ms"] for l2, s, _f in runs if l2 == lab)
               for lab in ("A", "B")}
        print(f"{key}: A {med['A']:.4f} B {med['B']:.4f} ms, bound {b:.4f} ms "
              f"(A {100 * b / med['A']:.1f}%, B {100 * b / med['B']:.1f}%)")
    ok = True
    for key in keys:
        same = len({s[key]["sha1"] for _l, s, _f in runs}) == 1
        ok &= same
        if not same:
            print(f"{key}: outputs DIFFER between the trees")
    digests = {json.dumps(s["digests"], sort_keys=True) for _l, s, _f in runs}
    ok &= len(digests) == 1
    print(f"outputs of K4 / K6 / K1 / K5 at all {len(keys)} shapes and the "
          f"digests {runs[0][1]['digests']}: identical in every run of both "
          f"trees: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])))
    else:
        sys.exit(main(os.path.abspath(sys.argv[1]),
                      os.path.abspath(sys.argv[2])))
