"""iw3 player, a local media server for converted 3D videos (counterpart
of ``nunif_tpu/iw3/player.py``): media library listing with zip image
galleries, HTTP range requests (seekable playback), the stereo format from
filename tags, WebVTT subtitles extracted through the port's video backend,
and the browser viewer.  GET / serves the WebXR stereo viewer
(``player_app.py``); GET /flat the plain HTML5 page.  Paths that leave the
media root answer 404.  No network, no device work.

Usage: python -m nunif_tpu_torch.iw3.player --root /videos --port 1304
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger("nunif_tpu_torch.iw3")

VIDEO_EXTS = {".mp4", ".mkv", ".webm", ".mov"}

# the filename tags of each stereo format
_SBS_TAGS = re.compile(r"(_LRF?|[._-]sbs|full[._-]?sbs)", re.IGNORECASE)
_HALF_SBS_TAGS = re.compile(r"(_LRH|half[._-]?sbs)", re.IGNORECASE)
_TB_TAGS = re.compile(r"(_TBF?|[._-]tb|top[._-]?bottom)", re.IGNORECASE)
_RGBD_TAGS = re.compile(r"(_RGBD|[._-]rgbd)", re.IGNORECASE)


def detect_stereo_format(filename: str) -> str:
    """The stereo format a filename's tag names ("mono" without one)."""
    if _HALF_SBS_TAGS.search(filename):
        return "half-sbs"
    if _SBS_TAGS.search(filename):
        return "sbs"
    if _TB_TAGS.search(filename):
        return "tb"
    if _RGBD_TAGS.search(filename):
        return "rgbd"
    return "mono"


IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}
_IMAGE_CTYPES = {".png": "image/png", ".jpg": "image/jpeg",
                 ".jpeg": "image/jpeg", ".webp": "image/webp",
                 ".bmp": "image/bmp"}


def split_zip_path(rel_path: str):
    """"archive.zip/inner/entry.png" -> ("archive.zip", "inner/entry.png");
    (path, None) outside an archive."""
    low = rel_path.lower()
    idx = low.find(".zip/")
    if idx < 0:
        return rel_path, None
    return rel_path[:idx + 4], rel_path[idx + 5:]


def list_media(root: str):
    """Videos, images and zip archives of images under ``root``, each with
    its stereo format (and an archive with its image entries)."""
    import zipfile
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            ext = os.path.splitext(f)[1].lower()
            full = os.path.join(dirpath, f)
            rel = os.path.relpath(full, root)
            if ext in VIDEO_EXTS:
                out.append({"path": rel, "type": "video",
                            "stereo_format": detect_stereo_format(f)})
            elif ext in IMAGE_EXTS:
                out.append({"path": rel, "type": "image",
                            "stereo_format": detect_stereo_format(f)})
            elif ext == ".zip":
                try:
                    with zipfile.ZipFile(full) as zf:
                        entries = [n for n in sorted(zf.namelist())
                                   if os.path.splitext(n)[1].lower()
                                   in IMAGE_EXTS]
                except (zipfile.BadZipFile, OSError):
                    continue
                if entries:
                    out.append({"path": rel, "type": "zip",
                                "stereo_format": detect_stereo_format(f),
                                "entries": entries})
    return out


PLAYER_HTML = """<!doctype html>
<html><head><title>iw3 player</title></head>
<body style="background:#111;color:#eee;font-family:sans-serif">
<h2>iw3 player (flat fallback — the WebXR viewer is at /)</h2>
<div id="list"></div>
<video id="v" controls style="width:100%%;max-height:80vh"></video>
<script>
fetch('/api/library').then(r=>r.json()).then(items=>{
  const d=document.getElementById('list');
  items.forEach(it=>{
    const a=document.createElement('a');
    a.textContent=it.path+' ['+it.stereo_format+']';
    a.href='#'; a.style.display='block'; a.style.color='#9cf';
    a.onclick=()=>{document.getElementById('v').src=
      '/media/'+encodeURIComponent(it.path); return false;};
    d.appendChild(a);
  });
});
</script></body></html>"""


def make_handler(root: str):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            logger.debug("player: " + fmt, *args)

        def _send(self, code, body, ctype="text/html; charset=utf-8",
                  headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urllib.parse.unquote(self.path)
            if path in ("/", "/index.html"):
                from .player_app import PLAYER_APP_HTML
                self._send(200, PLAYER_APP_HTML.encode())
            elif path == "/flat":
                self._send(200, PLAYER_HTML.encode())
            elif path == "/api/library":
                self._send(200, json.dumps(list_media(root)).encode(),
                           "application/json")
            elif path.startswith("/media/"):
                self._serve_media(path[len("/media/"):])
            elif path.startswith("/subtitles/"):
                self._serve_subtitles(path[len("/subtitles/"):])
            else:
                self._send(404, b"not found")

        def _safe_path(self, rel):
            full = os.path.realpath(os.path.join(root, rel))
            if not full.startswith(os.path.realpath(root) + os.sep) or \
                    not os.path.isfile(full):
                return None
            return full

        def _serve_subtitles(self, rel):
            """WebVTT extracted from the video's text subtitle stream,
            cached beside the video while it is not older."""
            full = self._safe_path(rel)
            if full is None:
                self._send(404, b"not found")
                return
            from ..video.backend import extract_subtitles
            vtt = full + ".vtt"
            try:
                if not (os.path.exists(vtt) and
                        os.path.getmtime(vtt) >= os.path.getmtime(full)):
                    n = extract_subtitles(full, vtt)
                    if n == 0:
                        os.unlink(vtt) if os.path.exists(vtt) else None
                        self._send(404, b"no subtitles")
                        return
                with open(vtt, "rb") as f:
                    self._send(200, f.read(), "text/vtt; charset=utf-8")
            except (IOError, OSError) as e:
                logger.debug("subtitles: %s", e)
                self._send(404, b"no subtitles")

        def _serve_media(self, rel):
            zip_part, inner = split_zip_path(rel)
            if inner is not None:
                import zipfile
                zfull = self._safe_path(zip_part)
                if zfull is None:
                    self._send(404, b"not found")
                    return
                try:
                    with zipfile.ZipFile(zfull) as zf:
                        data = zf.read(inner)
                except (KeyError, zipfile.BadZipFile, OSError):
                    self._send(404, b"not found")
                    return
                ctype = _IMAGE_CTYPES.get(
                    os.path.splitext(inner)[1].lower(),
                    "application/octet-stream")
                self._send(200, data, ctype)
                return
            full = self._safe_path(rel)
            if full is None:
                self._send(404, b"not found")
                return
            ext = os.path.splitext(full)[1].lower()
            if ext in _IMAGE_CTYPES:
                with open(full, "rb") as f:
                    self._send(200, f.read(), _IMAGE_CTYPES[ext])
                return
            size = os.path.getsize(full)
            rng = self.headers.get("Range")
            start, end = 0, size - 1
            code = 200
            if rng:
                m = re.match(r"bytes=(\d*)-(\d*)", rng)
                if m:
                    if m.group(1):
                        start = int(m.group(1))
                    if m.group(2):
                        end = int(m.group(2))
                    end = min(end, size - 1)
                    code = 206
            length = end - start + 1
            self.send_response(code)
            self.send_header("Content-Type", "video/mp4")
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("Content-Length", str(length))
            if code == 206:
                self.send_header("Content-Range",
                                 f"bytes {start}-{end}/{size}")
            self.end_headers()
            with open(full, "rb") as f:
                f.seek(start)
                remaining = length
                while remaining > 0:
                    chunk = f.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    try:
                        self.wfile.write(chunk)
                    except (BrokenPipeError, ConnectionResetError):
                        return
                    remaining -= len(chunk)

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(prog="iw3.player", description=__doc__)
    p.add_argument("--root", required=True, help="media directory")
    p.add_argument("--bind", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1304)
    args = p.parse_args(argv)
    server = ThreadingHTTPServer((args.bind, args.port),
                                 make_handler(args.root))
    print(f"iw3 player: http://{args.bind}:{args.port}/", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
