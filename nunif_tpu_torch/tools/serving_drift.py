"""Whether the port's web server on swin_unet_2x answers with the renderer's
pixels round after round, and, where it does not, what moved.

The check is ``chip_smoke.py``'s "waifu2x serving" one: the server on a
seeded swin_unet_2x ``.nztm`` (127.0.0.1, port 0, in a thread), three
POST /api of 1920x1080 PNGs (one, then two at once), each reply held
exactly against the renderer on the decoded input, and the renderer's
output for the first image held against itself before and after the
requests.  Here it runs for ``--rounds`` rounds (new images each round, so
no reply comes from the cache) in fresh processes, ``--procs`` of them for
each set: ``kernels`` (K1 and K2 launched) and ``twins`` (K1 / K2's plain
PyTorch versions in their place).  With ``--renders-first`` each process
first runs the phase's five model renders (``chip_smoke.serving_renders``),
as the smoke does before its web server.

While the main thread renders the first image, forward hooks record a
checksum of every module's output (the sum of its bits as integers), so a
round whose two renders differ names the first module, in call order,
whose output moved, and whether its input had moved before it.  On the
first mismatch of a process it also renders the first image three more
times (does the change stay?), maps the differing pixels to the render's
tiles, and reads the card's UUID, clocks, throttle reasons and ECC
counters.

Prints one JSON line per process ("serving_drift child: {...}") and a
summary line; exits 1 if any round disagreed.

Usage: python -m nunif_tpu_torch.tools.serving_drift [--rounds 8]
    [--procs 2] [--sets kernels,twins] [--renders-first]
(run from a checkout that holds ``chip_smoke.py``; ``--device cpu --hw
64,96 --rounds 2`` rehearses one process on the CPU)
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np

SMI_FIELDS = ("name", "power.limit", "uuid", "pci.bus_id", "clocks.sm",
              "clocks.max.sm", "temperature.gpu", "clocks_throttle_reasons.active",
              "ecc.errors.corrected.volatile.total",
              "ecc.errors.uncorrected.volatile.total")


def card_state() -> dict:
    """nvidia-smi's reading of each field, one query a field (a field the
    driver does not know reads "?")."""
    out = {}
    for f in SMI_FIELDS:
        p = subprocess.run(["nvidia-smi", f"--query-gpu={f}",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
        out[f] = p.stdout.strip() if p.returncode == 0 else "?"
    return out


class Checksums:
    """Forward hooks on every module of ``model`` that record, on the thread
    that armed them, (module name, int64 sum of the output's bits, the same
    of its first input); read with ``take``."""

    def __init__(self, torch, model):
        self.torch = torch
        self.rows = []
        self.armed = None
        self.handles = [m.register_forward_hook(self._hook(n))
                        for n, m in model.named_modules()]

    @staticmethod
    def _bits(torch, t):
        if not torch.is_tensor(t):
            return None
        t = t.detach().contiguous()
        view = {2: torch.int16, 4: torch.int32}.get(t.element_size())
        return (t.view(view) if view else t).to(torch.int64).sum()

    def _hook(self, name):
        def hook(_mod, args, out):
            if self.armed is not threading.current_thread():
                return
            x = args[0] if args else None
            self.rows.append((name, self._bits(self.torch, out),
                              self._bits(self.torch, x)))
        return hook

    def arm(self):
        self.rows = []
        self.armed = threading.current_thread()

    def take(self):
        self.armed = None
        rows = [(n, None if o is None else int(o), None if i is None else int(i))
                for n, o, i in self.rows]
        self.rows = []
        return rows

    def remove(self):
        for h in self.handles:
            h.remove()


def first_moved(before, after):
    """The first module call whose output checksum differs between two
    renders: {"call", "module", "input_moved"}, or None."""
    if [n for n, _, _ in before] != [n for n, _, _ in after]:
        return {"call": None, "module": "the call order differs"}
    for k, ((name, o1, i1), (_n, o2, i2)) in enumerate(zip(before, after)):
        if o1 != o2:
            return {"call": k, "module": name, "input_moved": i1 != i2,
                    "calls": len(before)}
    return None


def child(kernel_set: str, rounds: int, device: str = "cuda",
          hw=(1080, 1920), renders_first: bool = False) -> dict:
    import io
    import torch
    from http.server import ThreadingHTTPServer
    from PIL import Image
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from nunif_tpu_torch.models import from_flax, save_model
    from nunif_tpu_torch.ops import conv3x3 as k2
    from nunif_tpu_torch.ops import swin_attention as k1
    from nunif_tpu_torch.utils import pil_io
    from nunif_tpu_torch.utils.tiling import make_tile_config
    from nunif_tpu_torch.waifu2x.models.swin_unet import SwinUNet2x, tamed_flax_params
    from nunif_tpu_torch.waifu2x.web import Waifu2xWebService, make_handler

    kernels = {"fused_swin_block_image": k1.fused_swin_block_image,
               "stem_conv3x3": k2.stem_conv3x3}
    ctx = (cs.twins((k1, "fused_swin_block_image"), (k2, "stem_conv3x3"))
           if kernel_set == "twins" else cs.twins())
    h, w = hw
    out = {"set": kernel_set, "rounds": [],
           "card": card_state() if device == "cuda" else {}}
    work = tempfile.mkdtemp()
    if renders_first:
        cs.serving_renders(torch, torch.device(device), work)
    swin = SwinUNet2x()
    from_flax(swin, tamed_flax_params(swin, seed=0))
    save_model(swin, os.path.join(work, "scale2x.nztm"))
    args = argparse.Namespace(
        model_file=os.path.join(work, "scale2x.nztm"), arch=None,
        tile_size=None, batch_size=None, noise_level=None,
        cache_dir=os.path.join(work, "cache"), cache_size_mb=256,
        public_dir=None, device=device)
    service = Waifu2xWebService(args)
    model = service.renderer.model
    sums = Checksums(torch, model)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def render(x, record=False):
        if record:
            sums.arm()
        y = pil_io.quantize(service.render(x), 8)
        return (y, sums.take()) if record else y

    try:
        with ctx:
            for r in range(rounds):
                pngs = [cs.png_bytes(cs.structured_frame(h, w, 100 + 3 * r + i))
                        for i in range(3)]
                srcs = [np.asarray(Image.open(io.BytesIO(p)).convert("RGB"),
                                   np.float32) / 255.0 for p in pngs]
                before, sums_before = render(srcs[0], record=True)
                refs = [before] + [render(x) for x in srcs[1:]]

                def requests():
                    replies = [cs.post_image(url, pngs[0]), None, None]

                    def hit(i):
                        replies[i] = cs.post_image(url, pngs[i])
                    ths = [threading.Thread(target=hit, args=(i,)) for i in (1, 2)]
                    for th in ths:
                        th.start()
                    for th in ths:
                        th.join(timeout=600)
                    return replies
                replies, launches = cs.counted(kernels, requests)
                after, sums_after = render(srcs[0], record=True)
                row = {"round": r, "launches": launches,
                       "render_vs_render": int((after != before).sum()),
                       "replies_vs_renders": []}
                for (status, _ctype, body, _ms), ref in zip(replies, refs):
                    got = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
                    row["replies_vs_renders"].append(
                        int((got != ref).sum()) if status == 200
                        and got.shape == ref.shape else -1)
                bad = row["render_vs_render"] or any(row["replies_vs_renders"])
                if bad:
                    row["first_moved"] = first_moved(sums_before, sums_after)
                if bad and "first_mismatch" not in out:
                    more = [render(srcs[0]) for _ in range(3)]
                    t = model.find_valid_tile_size(None)
                    cfg = make_tile_config(h, w, model.i2i_scale,
                                           model.i2i_offset, (t, t),
                                           model.i2i_blend_size)
                    ys, xs = np.nonzero((after != before).any(-1))
                    step = cfg.output_tile_step_h, cfg.output_tile_step_w
                    out["first_mismatch"] = {
                        "round": r,
                        "more_vs_before": [int((m != before).sum()) for m in more],
                        "more_vs_after": [int((m != after).sum()) for m in more],
                        "tiles": sorted({(int(y) // step[0], int(x) // step[1])
                                         for y, x in zip(ys, xs)})[:40],
                        "max_diff": int(np.abs(after.astype(np.int16) - before).max()),
                        "card": card_state() if device == "cuda" else {}}
                out["rounds"].append(row)
                print(f"serving_drift {kernel_set} round {r}: {row}", flush=True)
    finally:
        sums.remove()
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    out["bad_rounds"] = sum(
        1 for row in out["rounds"]
        if row["render_vs_render"] or any(row["replies_vs_renders"]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--sets", default="kernels,twins")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda",
                   help="cpu: a rehearsal of one process at --hw")
    p.add_argument("--hw", default="1080,1920", help="input height,width")
    p.add_argument("--renders-first", action="store_true",
                   help="run the smoke's five model renders before the server")
    args = p.parse_args(argv)
    hw = tuple(int(v) for v in args.hw.split(","))
    if args.child or args.device == "cpu":
        import torch
        if args.device == "cuda" and not torch.cuda.is_available():
            print("serving_drift: no CUDA device", file=sys.stderr)
            return 2
        res = child(args.child or "kernels", args.rounds, args.device, hw,
                    args.renders_first)
        print("serving_drift child: " + json.dumps(res), flush=True)
        return 1 if res["bad_rounds"] else 0
    from nunif_tpu_torch.ops import _build
    _build.build()
    results = []
    for kernel_set in args.sets.split(","):
        for _ in range(args.procs):
            proc = subprocess.run(
                [sys.executable, "-m", "nunif_tpu_torch.tools.serving_drift",
                 "--child", kernel_set, "--rounds", str(args.rounds),
                 "--hw", args.hw]
                + (["--renders-first"] if args.renders_first else []),
                capture_output=True, text=True, timeout=1800)
            sys.stdout.write(proc.stdout)
            sys.stderr.write(proc.stderr[-4000:])
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("serving_drift child: ")]
            res = json.loads(line[-1].split(": ", 1)[1]) if line else None
            results.append({"set": kernel_set, "rc": proc.returncode,
                            "bad_rounds": None if res is None else res["bad_rounds"],
                            "rounds": args.rounds,
                            "uuid": None if res is None else res["card"]["uuid"]})
    print("serving_drift: " + json.dumps(results), flush=True)
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
