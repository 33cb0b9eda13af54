"""waifu2x web server: the HTTP upscaling API (counterpart of
``nunif_tpu/waifu2x/web.py``).

POST /api takes a multipart upload (or a url to fetch) and returns the
converted image; results are cached on disk by sha1 with a size-bound GC;
GET / serves the static i18n page for the request's Accept-Language;
GET /unlimited, POST /api/tile and GET /api/tile/info serve the unlimited
tile app (``unlimited.py``).  Built on the stdlib ThreadingHTTPServer;
device work is serialised behind one lock, so requests queue for the card.
One model per process: ``--model-file`` (a ``.nztm`` or a reference
``.pth``), else the bundled ``scale2x.nztm``, else ``--arch`` with seeded
random weights.  Where ``--noise-level`` is not given it comes from the
model file's name (``noise{n}``, ``noise{n}_scale2x``, ...; the runtime's
naming), else -1; the JAX server takes it from the flag only.  Cached
results are keyed on the model too (the file's path, size and time), so a
server restarted on another model does not answer from the last one's
cache; the JAX server keys on the request alone.  A ``POST /api`` whose
``noise`` or ``scale`` names a conversion the loaded model does not render
is answered 400, as ``/api/tile`` answers it (the JAX server renders its
one model whatever the request names).  The cache writes each entry
through a temporary file of its own, so two requests that put one key at
once both succeed (the JAX cache shares one ``<key>.tmp`` between them).

Usage: python -m nunif_tpu_torch.waifu2x.web --port 8812 \\
    [--model-file X.nztm|X.pth] [--device cuda]
"""
from __future__ import annotations

import argparse
import hashlib
import io
import json
import logging
import os
import re
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils import pil_io

logger = logging.getLogger("nunif_tpu_torch.waifu2x")

MAX_BODY_BYTES = 20 * 1024 * 1024
MAX_SCALE_PIXELS = 1920 * 1080
MAX_NOISE_PIXELS = 4096 * 4096

INDEX_HTML = """<!doctype html>
<html><head><title>waifu2x (nunif_tpu_torch)</title></head><body>
<h1>waifu2x — GPU</h1>
<form action="/api" method="post" enctype="multipart/form-data">
  <p>file: <input type="file" name="file"></p>
  <p>or URL: <input type="text" name="url" size="60"></p>
  <p>style: <select name="style">
    <option value="art">art</option><option value="photo">photo</option>
  </select>
  noise: <select name="noise">
    <option value="-1">none</option><option value="0">0</option>
    <option value="1">1</option><option value="2">2</option>
    <option value="3">3</option>
  </select>
  scale: <select name="scale">
    <option value="2">2x</option><option value="1">1x</option>
  </select>
  format: <select name="format">
    <option value="png">png</option><option value="webp">webp</option>
  </select></p>
  <p><input type="submit" value="convert"></p>
</form></body></html>"""


def noise_level_of(model_file) -> int:
    """The noise level a model file's name says it removes (the runtime's
    ``noise{n}`` stems), -1 for any other name."""
    stem = os.path.basename(str(model_file)).split(".", 1)[0]
    m = re.fullmatch(r"noise([0-3])(_scale[24]x)?", stem)
    return int(m.group(1)) if m else -1


def model_identity(model_file, arch) -> str:
    """What a cached result depends on besides the request: the model file
    (path, size, modification time), else the seeded architecture."""
    if not model_file:
        return f"arch:{arch}"
    st = os.stat(model_file)
    return hashlib.sha1(f"{os.path.abspath(model_file)}|{st.st_size}|"
                        f"{st.st_mtime_ns}".encode()).hexdigest()


class DiskCache:
    """sha1-keyed result cache with a size-bound GC (oldest access first)."""

    def __init__(self, root: str, max_bytes: int = 256 * 1024 * 1024):
        self.root = root
        self.max_bytes = max_bytes
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, hashlib.sha1(key.encode()).hexdigest())

    def get(self, key: str):
        p = self._path(key)
        try:
            with open(p, "rb") as f:
                data = f.read()
            os.utime(p)
            return data
        except OSError:
            return None

    def put(self, key: str, data: bytes):
        """Write the entry through a temporary file of this call's own, so
        that writers of one key never share a name; the last replace wins."""
        p = self._path(key)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, p)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def gc(self):
        with self._lock:
            entries = []
            total = 0
            for name in os.listdir(self.root):
                p = os.path.join(self.root, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, p))
                total += st.st_size
            if total <= self.max_bytes:
                return
            entries.sort()
            for _, size, p in entries:
                try:
                    os.unlink(p)
                except OSError:
                    continue
                total -= size
                if total <= self.max_bytes:
                    break


class Waifu2xWebService:
    """The model, its renderer, the page table and the result cache of one
    server process.  ``args``: the parser's namespace (``model_file``,
    ``arch``, ``tile_size``, ``batch_size``, ``cache_dir``,
    ``cache_size_mb``; optional ``noise_level``, ``public_dir``,
    ``device``, by default "cuda")."""

    def __init__(self, args):
        self.args = args
        self.cache = DiskCache(args.cache_dir, args.cache_size_mb * 1024 * 1024)
        self.lock = threading.Lock()  # one device program at a time
        self.public_dir = getattr(args, "public_dir", None)
        self.pages = {}  # lang -> static page bytes (webgen)
        self._load_pages()
        self._build_runtime()

    def _load_pages(self):
        """Render the i18n front pages once (and write them to
        ``--public-dir`` when given); on a failure the server falls back to
        ``INDEX_HTML``."""
        try:
            from .webgen import generate_pages, render_pages
            self.pages = {lang: page.encode("utf-8")
                          for lang, page in render_pages().items()}
            if self.public_dir:
                generate_pages(self.public_dir)
        except Exception:  # noqa: BLE001  (the fallback page still serves)
            logger.exception("web: webgen page generation failed")

    def _build_runtime(self):
        import torch
        from ..models import create_model, init_flax_default, load_model
        from ..utils.tiling import TiledRenderer
        from . import models  # noqa: F401  (registers the architectures)
        from .runtime import default_model_dir
        device = getattr(self.args, "device", None) or "cuda"
        model_file = self.args.model_file
        if not model_file and not self.args.arch:
            d = default_model_dir()
            cand = os.path.join(d, "scale2x.nztm") if d else None
            if cand and os.path.exists(cand):
                model_file = cand
                logger.info("web: using bundled model %s", cand)
        if model_file:
            model, _meta = load_model(model_file, device=device)
        else:
            model = create_model(self.args.arch or "waifu2x.swin_unet_2x")
            init_flax_default(model, torch.Generator().manual_seed(0))
            model = model.eval().requires_grad_(False).to(device)
            logger.warning("web: random init model (no --model-file); "
                           "structure / load-test use only")
        self.renderer = TiledRenderer(model)
        self.model_id = model_identity(model_file, self.args.arch)
        self.scale = model.i2i_scale
        noise = getattr(self.args, "noise_level", None)
        if noise is None:
            noise = noise_level_of(model_file) if model_file else -1
        self.noise_level = noise

    def render(self, x: np.ndarray) -> np.ndarray:
        """x (H, W, 3) float32 -> the renderer's fp32 output on the host,
        under the device lock."""
        with self.lock:
            return self.renderer.render(
                x, tile_size=self.args.tile_size,
                batch_size=self.args.batch_size).cpu().numpy()

    def check_conversion(self, noise=None, scale=None):
        """Raise ``ValueError`` if ``noise`` or ``scale`` (None: not asked)
        names a conversion the loaded model does not render."""
        if scale is not None and scale != self.scale:
            raise ValueError(f"server model is {self.scale}x (requested "
                             f"{scale}x); see /api/tile/info")
        if noise is not None and noise != self.noise_level:
            raise ValueError(f"server model noise level is {self.noise_level} "
                             f"(requested {noise}); see /api/tile/info")

    def convert(self, image_bytes: bytes, style: str, noise: int, scale: int,
                image_format: str) -> bytes:
        """The model's render of the image, encoded; ``noise`` and
        ``scale`` must be the model's (``check_conversion``)."""
        from PIL import Image
        self.check_conversion(noise, scale)
        key = hashlib.sha1(image_bytes).hexdigest() + \
            f"_{style}_{noise}_{scale}_{image_format}_{self.model_id}"
        cached = self.cache.get(key)
        if cached is not None:
            return cached
        im = Image.open(io.BytesIO(image_bytes))
        im.load()
        if im.mode != "RGB":
            im = im.convert("RGB")
        n_px = im.size[0] * im.size[1]
        if n_px > (MAX_NOISE_PIXELS if scale == 1 else MAX_SCALE_PIXELS):
            raise ValueError("image too large")
        x = np.asarray(im, np.float32) / 255.0
        t0 = time.perf_counter()
        y = self.render(x)
        logger.info("web: converted %dx%d in %.2fs", im.size[0], im.size[1],
                    time.perf_counter() - t0)
        out = Image.fromarray(pil_io.quantize(y, 8))
        buf = io.BytesIO()
        out.save(buf, format=image_format.upper())
        data = buf.getvalue()
        self.cache.put(key, data)
        self.cache.gc()
        return data


def _parse_multipart(handler) -> dict:
    import email
    import email.policy
    ctype = handler.headers.get("Content-Type", "")
    length = int(handler.headers.get("Content-Length", 0))
    if length > MAX_BODY_BYTES:
        raise ValueError("body too large")
    body = handler.rfile.read(length)
    fields = {}
    if ctype.startswith("multipart/form-data"):
        msg = email.message_from_bytes(
            b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body,
            policy=email.policy.HTTP)
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            payload = part.get_payload(decode=True)
            if part.get_filename():
                fields[name] = payload
            else:
                fields[name] = payload.decode("utf-8", "replace").strip()
    elif ctype.startswith("application/x-www-form-urlencoded"):
        for k, v in urllib.parse.parse_qsl(body.decode("utf-8", "replace")):
            fields[k] = v
    return fields


def make_handler(service: Waifu2xWebService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug("web: " + fmt, *args)

        def _send(self, code, body, ctype="text/html; charset=utf-8",
                  extra_headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra_headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" and service.pages:
                from .webgen import pick_language
                lang = pick_language(self.headers.get("Accept-Language", ""),
                                     list(service.pages))
                # content-negotiated: caches must key on the request language
                self._send(200, service.pages.get(
                    lang, service.pages.get("en", INDEX_HTML.encode())),
                    extra_headers=(("Vary", "Accept-Language"),))
            elif self.path in ("/", "/index.html"):
                self._send(200, service.pages.get("en", INDEX_HTML.encode()))
            elif (self.path.startswith("/index.")
                  and self.path.endswith(".html")
                  and self.path[len("/index."):-len(".html")] in service.pages):
                self._send(200, service.pages[
                    self.path[len("/index."):-len(".html")]])
            elif self.path == "/health":
                self._send(200, b'{"status":"ok"}', "application/json")
            elif self.path in ("/unlimited", "/unlimited.html"):
                from .unlimited import UNLIMITED_HTML
                self._send(200, UNLIMITED_HTML.encode())
            elif self.path == "/api/tile/info":
                model = service.renderer.model
                self._send(200, json.dumps({
                    "name": model.model_name,
                    "scale": service.scale,
                    "offset": model.i2i_offset,
                    "noise": service.noise_level,
                }).encode(), "application/json")
            else:
                self._send(404, b"not found")

        def _tile_api(self):
            """POST /api/tile: one raw float32 tile through the model (the
            unlimited app); scale and noise must match the loaded model."""
            from .unlimited import tile_forward
            q = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
            w = int(q.get("w", ["0"])[0])
            h = int(q.get("h", ["0"])[0])
            tta = int(q.get("tta", ["0"])[0])
            service.check_conversion(
                int(q["noise"][0]) if "noise" in q else None,
                int(q["scale"][0]) if "scale" in q else None)
            if not (0 < h <= 1024 and 0 < w <= 1024):
                raise ValueError("bad tile size")
            length = int(self.headers.get("Content-Length", 0))
            if length != h * w * 3 * 4 or length > MAX_BODY_BYTES:
                raise ValueError("bad tile body")
            tile = np.frombuffer(self.rfile.read(length),
                                 np.float32).reshape(h, w, 3)
            if tta and h != w:
                raise ValueError("tta needs square tiles")
            with service.lock:
                y = tile_forward(service, tile, tta=tta)
            model = service.renderer.model
            self._send(200, np.ascontiguousarray(y).tobytes(),
                       "application/octet-stream",
                       extra_headers=(
                           ("X-Tile-Scale", str(model.i2i_scale)),
                           ("X-Tile-Offset", str(model.i2i_offset))))

        def do_POST(self):
            if self.path.startswith("/api/tile"):
                try:
                    self._tile_api()
                except ValueError as e:
                    self._send(400, str(e).encode())
                except Exception:  # noqa: BLE001  (the server keeps serving)
                    logger.exception("web: tile api error")
                    self._send(500, b"internal error")
                return
            if self.path != "/api":
                self._send(404, b"not found")
                return
            try:
                fields = _parse_multipart(self)
                data = fields.get("file") or b""
                if not data and fields.get("url"):
                    url = fields["url"]
                    if not url.startswith(("http://", "https://")):
                        raise ValueError("bad url")
                    with urllib.request.urlopen(url, timeout=15) as r:
                        data = r.read(MAX_BODY_BYTES)
                if not data:
                    self._send(400, b"no image")
                    return
                style = fields.get("style", "art")
                # a field the request leaves out names the model's own value
                noise = int(fields.get("noise", service.noise_level))
                scale = int(fields.get("scale", service.scale))
                fmt = fields.get("format", "png")
                if fmt not in ("png", "webp"):
                    fmt = "png"
                out = service.convert(data, style, noise, scale, fmt)
                self._send(200, out, f"image/{fmt}")
            except ValueError as e:
                self._send(413 if "large" in str(e) else 400, str(e).encode())
            except Exception:  # noqa: BLE001  (the server keeps serving)
                logger.exception("web: api error")
                self._send(500, b"internal error")

    return Handler


def create_parser():
    p = argparse.ArgumentParser(prog="waifu2x.web", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--bind", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8812)
    p.add_argument("--model-file", default=None,
                   help="a .nztm checkpoint or a reference .pth")
    p.add_argument("--arch", default=None,
                   help="seeded random-init arch (load-test mode); default: "
                        "the bundled scale2x.nztm, else a random swin_unet_2x")
    p.add_argument("--tile-size", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--noise-level", type=int, default=None,
                   help="noise level the model removes (echoed by "
                        "/api/tile/info; tile requests for another level are "
                        "rejected); default: from --model-file's name "
                        "(noise{n}...), else -1")
    p.add_argument("--cache-dir",
                   default=os.path.join(tempfile.gettempdir(), "waifu2x_web_cache"),
                   help="result cache (default: waifu2x_web_cache under the "
                        "temporary directory, which follows TMPDIR)")
    p.add_argument("--cache-size-mb", type=int, default=256)
    p.add_argument("--public-dir", default=None,
                   help="also write the static i18n pages here")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default cuda; fails "
                        "without CUDA)")
    return p


def main(argv=None):
    args = create_parser().parse_args(argv)
    service = Waifu2xWebService(args)
    server = ThreadingHTTPServer((args.bind, args.port), make_handler(service))
    print(f"waifu2x web: http://{args.bind}:{server.server_address[1]}/",
          file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
