"""K1 and K5 of two source trees on one card, in turns: the image-layout
Swin block (``ops/swin_attention.py:fused_swin_block_image``) at the seven
bf16 shapes of the swin_unet_2x 1080p frame, and the block on
window-ordered tokens (``fused_swin_block``) at the six shapes of the same
frame's window path (``NUNIF_TPU_SWIN_IMG=0``: shifted blocks on the grid
padded by one window, shift mode "pad"), with seeded weights.

Each tree runs in a process of its own (each builds its own kernels under
its ``build/``), in the order A B B A.  Prints ms a shape and the K1 frame
sum (launches a frame times ms) for each run, the medians by tree and the
K5 frame sums; then, from the first run of each tree, the largest
difference between the two trees' outputs at each shape and the share of
bit-equal elements; and whether K4, K6 and T2, which neither tree's K1 / K5
change touches, give bit-identical outputs in both trees (a digest of each
at one seeded shape, ``bitwise_digests``), and whether the two builds'
K4 / K6 machine code is the same (``cuobjdump -sass`` of each tree's
library, where the toolkit has it).  Exits 1 if the digests differ or an
output difference exceeds K1's bf16 tolerance (0.05).

Usage: python -m nunif_tpu_torch.tools.ab_swin_block ROOT_A ROOT_B
(card only; ROOT_* are checkouts that hold ``nunif_tpu_torch/``; the
outputs of the first run of each tree are kept under ROOT_B's
``build/ab_swin_block/`` while the tool runs)
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys

# (C, H, W, shift, skip) and launches a frame, as chip_smoke.py counts them
SHAPES = {(96, 1104, 1920, 0, False): 1, (96, 1104, 1920, 3, False): 2,
          (96, 1104, 1920, 0, True): 1, (192, 552, 960, 0, False): 2,
          (192, 552, 960, 3, False): 2, (192, 276, 480, 0, False): 3,
          (192, 276, 480, 3, False): 3}
# K5 on the window path: (C, unpadded H, W, shift) and launches a frame
K5_SHAPES = {(96, 1104, 1920, 0): 2, (96, 1104, 1920, 3): 2,
             (192, 552, 960, 0): 2, (192, 552, 960, 3): 2,
             (192, 276, 480, 0): 3, (192, 276, 480, 3): 3}
K1_ATOL = 0.05


def block_weights(torch, rng, c, heads=6):
    """A block's seeded Dense-shaped weights and (heads, 36, 36) bias."""
    import numpy as np
    from nunif_tpu_torch.modules.attention import expand_relative_bias

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda")
    hid = 2 * c
    return [t(rng.standard_normal((c, 3 * c)) / np.sqrt(c)),
            t(rng.normal(0, 0.02, (3 * c,))),
            t(rng.standard_normal((c, c)) / np.sqrt(c)),
            t(rng.normal(0, 0.02, (c,))),
            t(rng.standard_normal((c, hid)) / np.sqrt(c)),
            t(rng.normal(0, 0.02, (hid,))),
            t(rng.standard_normal((hid, c)) / np.sqrt(hid)),
            t(rng.normal(0, 0.02, (c,))),
            expand_relative_bias(t(rng.standard_normal((121, heads))), 6)]


def _sha1(torch, y) -> str:
    bits = y.contiguous().view(torch.int16 if y.element_size() == 2 else torch.int32)
    return hashlib.sha1(bits.cpu().numpy().tobytes()).hexdigest()


def bitwise_digests() -> dict:
    """sha1 of K4 (C 192, 12 heads, an 8 x 10 grid rolled by 3), K6 (the
    same in image layout) and T2 (the tool's P4 and P4qs at C 96, G 4, on a
    48 x 192 image with its check weights) outputs at seeded inputs."""
    import numpy as np
    import torch
    from nunif_tpu_torch.modules.attention import expand_relative_bias
    from nunif_tpu_torch.ops import probes
    from nunif_tpu_torch.ops import swin_attention as k4
    from nunif_tpu_torch.tools import microbench_swin_pieces as t2
    rng = np.random.default_rng(5)
    c, heads, n_wh, n_ww = 192, 12, 8, 10
    qkv = torch.from_numpy(rng.standard_normal(
        (n_wh * n_ww, 36, 3 * c), dtype=np.float32)).to("cuda", torch.bfloat16)
    bias = expand_relative_bias(torch.from_numpy(rng.standard_normal(
        (121, heads)).astype(np.float32)).to("cuda"), 6)
    out = {"K4": _sha1(torch, k4.fused_window_attention(
        qkv, bias, num_heads=heads, window=6, shift=3, n_wh=n_wh, n_ww=n_ww))}
    img = qkv.view(n_wh, n_ww, 6, 6, 3 * c).permute(0, 2, 1, 3, 4).reshape(
        1, n_wh * 6, n_ww * 6, 3 * c).contiguous()
    out["K6"] = _sha1(torch, k4.fused_window_attention_image(
        img, bias, num_heads=heads, window=6, shift=3))
    x = t2.image(96, 48, 192)
    for name in ("P4", "P4qs"):
        v = t2.variant(name)
        wts = t2.weights(96, 4, v["dense_int8"], check=True)
        packed = probes.pack_pieces(*wts[:8], *wts[9:], dense_int8=v["dense_int8"])
        out[f"T2 {name}"] = _sha1(torch, probes.swin_pieces(
            x, *wts, packed=packed, G=4, rh=1, cw=t2.default_cw(96), **v))
    torch.cuda.synchronize()
    return out


def window_attn_sass(root: str) -> dict | None:
    """{kernel: SASS instructions} of K4 / K6 (``window_attn_kernel``) in
    the library built under ``root``; None without cuobjdump or a build."""
    import glob
    import re
    libs = glob.glob(os.path.join(root, "build", "nunif_tpu_torch", "*.so"))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if len(libs) != 1 or not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", libs[0]], capture_output=True,
                          text=True).stdout
    out, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            # the anonymous namespace's tag differs between builds
            key = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", m.group(1)) \
                if "window_attn_kernel" in m.group(1) else None
            if key:
                out[key] = []
        elif key and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            out[key].append(line.split(";")[0].strip())
    return out


def child(root: str, save: str | None) -> dict:
    """Time K1 and K5 of the tree at ``root`` at every shape; ms a shape,
    the outputs saved under ``save`` when given, and bitwise_digests()."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from nunif_tpu_torch.ops import swin_attention as k1
    from nunif_tpu_torch.tools import time_ms
    assert k1.__file__ == os.path.join(root, "nunif_tpu_torch", "ops",
                                       "swin_attention.py"), k1.__file__
    rng = np.random.default_rng(0)

    def keep(key, y):
        if save:
            torch.save(y.cpu(), os.path.join(save, f"{len(out)}.pt"))
        out[key] = dict(ms=None, file=f"{len(out)}.pt")

    out = {}
    for c, h, w, shift, with_skip in SHAPES:
        weights = block_weights(torch, rng, c)
        x = torch.from_numpy(rng.normal(0, 0.5, (1, h, w, c)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        skip = torch.from_numpy(rng.normal(0, 0.5, (1, h, w, c)).astype(
            np.float32)).to("cuda", torch.bfloat16) if with_skip else None
        kw = dict(num_heads=6, window=6, shift=shift, skip=skip,
                  packed=k1.pack_weights(*weights, torch.bfloat16))
        key = str((c, h, w, shift, with_skip))
        keep(key, k1.fused_swin_block_image(x, *weights, **kw))
        out[key]["ms"] = time_ms(lambda: k1.fused_swin_block_image(x, *weights, **kw), 5)
        del x, skip
        torch.cuda.empty_cache()
    for c, h, w, shift in K5_SHAPES:
        n_wh, n_ww = h // 6 + (shift > 0), w // 6 + (shift > 0)
        weights = block_weights(torch, rng, c)
        x = torch.from_numpy(rng.normal(0, 0.5, (n_wh * n_ww, 36, c)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        kw = dict(num_heads=6, window=6, shift=shift, n_wh=n_wh, n_ww=n_ww,
                  shift_mode="pad", packed=k1.pack_weights(*weights, torch.bfloat16))
        key = f"K5 {(c, h, w, shift)}"
        keep(key, k1.fused_swin_block(x, *weights, **kw))
        out[key]["ms"] = time_ms(lambda: k1.fused_swin_block(x, *weights, **kw), 5)
        del x
        torch.cuda.empty_cache()
    out["digests"] = bitwise_digests()
    return out


def run_turns(script: str, root_a: str, root_b: str, launches: dict,
              child_args=lambda label, turn: []):
    """Run ``script --child ROOT [args]`` for the trees in the order A B B
    A, each in a process of its own started in its tree.  A child prints a
    JSON object {str(shape): {"ms": ...}} as its last line (other keys
    whose value has no "ms" are carried through).  Prints ms a shape and the
    frame sum (``launches[shape]`` times ms) for each run and the medians
    by tree; returns [(label, shapes, frame sum)], or exits with a failing
    child's code."""
    runs = []
    for turn, (label, root) in enumerate((("A", root_a), ("B", root_b),
                                          ("B", root_b), ("A", root_a))):
        res = subprocess.run([sys.executable, script, "--child", root,
                              *child_args(label, turn)],
                             cwd=root, capture_output=True, text=True)
        if res.returncode:
            print(res.stdout, res.stderr, file=sys.stderr)
            sys.exit(res.returncode)
        shapes = json.loads(res.stdout.strip().splitlines()[-1])
        frame = sum(shapes[str(k)]["ms"] * n for k, n in launches.items())
        runs.append((label, shapes, frame))
        print(f"{label} ({root}): frame sum {frame:.3f} ms; "
              + ", ".join(f"{k} {v['ms']:.3f}" for k, v in shapes.items()
                          if isinstance(v, dict) and "ms" in v),
              flush=True)
    for label in ("A", "B"):
        frames = [f for lab, _s, f in runs if lab == label]
        print(f"{label}: frame sums {[round(f, 3) for f in frames]}, median "
              f"{statistics.median(frames):.3f} ms")
    return runs


def main(root_a: str, root_b: str) -> int:
    import torch
    save_dir = os.path.join(root_b, "build", "ab_swin_block")
    saved = {"A": os.path.join(save_dir, "a"), "B": os.path.join(save_dir, "b")}
    for d in saved.values():
        os.makedirs(d, exist_ok=True)
    try:
        runs = run_turns(__file__, root_a, root_b, SHAPES,
                         lambda label, turn: [saved[label]] if turn < 2 else [])
        for label in ("A", "B"):
            k5 = [sum(s[f"K5 {k}"]["ms"] * n for k, n in K5_SHAPES.items())
                  for lab, s, _f in runs if lab == label]
            print(f"{label}: K5 frame sums {[round(f, 3) for f in k5]}, "
                  f"median {statistics.median(k5):.3f} ms")
        ok = True
        first = {label: s for label, s, _f in runs[:2]}
        for key, v in first["A"].items():
            if key == "digests":
                continue
            a = torch.load(os.path.join(saved["A"], v["file"])).cuda().float()
            b = torch.load(os.path.join(saved["B"], first["B"][key]["file"])).cuda().float()
            d = (a - b).abs()
            err = float(d.max())
            ok &= bool(d.isfinite().all()) and err <= K1_ATOL
            print(f"{key}: max abs difference A vs B {err:.6g}, bit-equal "
                  f"{float((d == 0).float().mean()):.4f}")
            del a, b, d
        same = all(s["digests"] == runs[0][1]["digests"] for _l, s, _f in runs)
        print(f"K4 / K6 / T2 digests: {runs[0][1]['digests']}; identical in "
              f"every run of both trees: {same}")
        sass_a, sass_b = window_attn_sass(root_a), window_attn_sass(root_b)
        if sass_a is None or sass_b is None:
            print("K4 / K6 machine code: not compared (no cuobjdump or build)")
        else:
            for k in sorted(sass_a):
                print(f"K4 / K6 {k}: {len(sass_a[k])} instructions, identical "
                      f"in both builds: {sass_a[k] == sass_b.get(k)}")
        return 0 if ok and same else 1
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2],
                               sys.argv[3] if len(sys.argv) > 3 else None)))
    else:
        sys.exit(main(os.path.abspath(sys.argv[1]),
                      os.path.abspath(sys.argv[2])))
