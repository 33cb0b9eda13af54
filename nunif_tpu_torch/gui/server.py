"""Browser GUI for the port's apps: ``python -m nunif_tpu_torch.gui``
(counterpart of ``nunif_tpu/gui/server.py``: the same routes, settings
store and page).

One page with per-app option forms (values persisted server-side via
:class:`..gui.SettingsStore`), jobs on worker threads, live progress over
server-sent events (``/api/progress``) and yml-locale i18n.  Routes: ``/``,
``/api/settings``, ``POST /api/{waifu2x,iw3,stlizer,iw3_video}``,
``/api/result/<id>``.  The models run on the card (``--device cpu`` on the
CPU): the waifu2x job through ``waifu2x/hub.py`` (a swin_unet model runs
kernels K1 / K2), the iw3 job through ``iw3/pipeline.py:process_image``
(the DINOv2 depth nets run K7, row_flow_v3 runs K3).

Runtime slots, as in the JAX GUI: ``_w2x`` (a hub model), ``_iw3``
(depth model name, depth model), and ``_side`` ({method: stereo model}).
The JAX GUI's image job passes no stereo model, so there its own default
method, row_flow_v3, fails ("needs a stereo model"); the port builds the
method's stereo model (``iw3/cli.py:create_stereo_model``) as both GUIs'
video jobs do.  Each job records its decode / render / encode seconds in
``Job.times``.
"""
from __future__ import annotations

import argparse
import io
import json
import logging
import os
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..core.device import resolve_device
from .locale import load_locale
from .persistence import SettingsStore
from .progress import ProgressBridge

logger = logging.getLogger("nunif_tpu_torch.gui")

MAX_BODY_BYTES = 64 * 1024 * 1024


class Job:
    def __init__(self, job_id: str, kind: str):
        self.job_id = job_id
        self.kind = kind
        self.result: bytes | None = None
        self.content_type = "image/png"
        self.filename = "output.png"
        self.error: str | None = None
        self.times: dict = {}  # stage -> seconds
        self.done = threading.Event()


class GuiService:
    """Owns runtimes, jobs, settings, and the progress bridge."""

    def __init__(self, lang: str | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.bridge = ProgressBridge()
        self.settings = {
            "waifu2x": SettingsStore("waifu2x", defaults={
                "method": "noise_scale", "noise_level": 1}),
            "iw3": SettingsStore("iw3", defaults={
                "method": "row_flow_v3", "divergence": 2.0,
                "convergence": 0.5, "stereo_format": "half_sbs",
                "depth_model": "Any_V2_S"}),
            "stlizer": SettingsStore("stlizer", defaults={
                "smoothing": 2.0, "border": "black",
                "filter_name": "gaussian"}),
        }
        self.tr = load_locale(lang)
        self.jobs: dict[str, Job] = {}
        self._jobs_lock = threading.Lock()
        self._runtime_lock = threading.Lock()
        self._w2x = None
        self._iw3 = None
        self._side = {}

    # ---------------------------------------------------------- runtimes
    def waifu2x_runtime(self):
        with self._runtime_lock:
            if self._w2x is None:
                from ..waifu2x.hub import Waifu2xImageModel
                self._w2x = Waifu2xImageModel(device=self.device)
            return self._w2x

    def iw3_runtime(self, depth_model_name: str):
        with self._runtime_lock:
            if self._iw3 is None or self._iw3[0] != depth_model_name:
                from ..iw3.depth import create_depth_model
                dm = create_depth_model(depth_model_name,
                                        device=self.device).load()
                self._iw3 = (depth_model_name, dm)
            return self._iw3[1]

    def stereo_runtime(self, method: str):
        """The stereo model of ``method`` (None for the plain warps)."""
        with self._runtime_lock:
            if method not in self._side:
                from ..iw3.cli import create_stereo_model
                self._side[method] = create_stereo_model(method,
                                                         device=self.device)
            return self._side[method]

    # ---------------------------------------------------------- jobs
    def submit(self, kind: str, fields: dict) -> Job:
        job = Job(uuid.uuid4().hex[:12], kind)
        with self._jobs_lock:
            self.jobs[job.job_id] = job

        def run():
            try:
                if kind == "waifu2x":
                    job.result = self._run_waifu2x(job, fields)
                elif kind == "iw3":
                    job.result = self._run_iw3(job, fields)
                elif kind == "stlizer":
                    job.result = self._run_stlizer(job, fields)
                elif kind == "iw3_video":
                    job.result = self._run_iw3_video(job, fields)
                else:
                    raise ValueError(f"unknown job kind {kind}")
                self.bridge.finish(job.job_id)
            except Exception as e:  # pragma: no cover - error path tested via API
                logger.exception("gui job failed")
                job.error = str(e)
                self.bridge.finish(job.job_id, error=str(e))
            finally:
                job.done.set()

        threading.Thread(target=run, daemon=True).start()
        return job

    def get_job(self, job_id: str) -> Job | None:
        with self._jobs_lock:
            return self.jobs.get(job_id)

    def _decode_image(self, job: Job, data: bytes):
        """PNG / JPEG bytes -> (H, W, 3) fp32 in [0, 1] on the device."""
        import torch
        from PIL import Image
        t0 = time.perf_counter()
        im = Image.open(io.BytesIO(data))
        im.load()
        if im.mode != "RGB":
            im = im.convert("RGB")
        x = torch.from_numpy(np.asarray(im, np.float32) / 255.0).to(self.device)
        job.times["decode"] = time.perf_counter() - t0
        return x

    def _encode_image(self, job: Job, arr) -> bytes:
        """(H, W, 3) in [0, 1] on the host -> PNG bytes, quantised as the
        JAX GUI does."""
        from PIL import Image
        t0 = time.perf_counter()
        buf = io.BytesIO()
        Image.fromarray(quantize_u8(arr)).save(buf, format="PNG")
        job.times["encode"] = time.perf_counter() - t0
        return buf.getvalue()

    def _render(self, job: Job, fn):
        """Run ``fn`` and copy its (H, W, 3) result to the host, timed."""
        t0 = time.perf_counter()
        arr = fn().float().cpu().numpy()
        job.times["render"] = time.perf_counter() - t0
        return arr

    def _run_waifu2x(self, job: Job, fields: dict) -> bytes:
        method = fields.get("method", "noise_scale")
        noise = int(fields.get("noise_level", 1))
        self.settings["waifu2x"].update(
            {"method": method, "noise_level": noise})
        self.bridge.update(job.job_id, 0, 3, "load")
        w2x = self.waifu2x_runtime()
        x = self._decode_image(job, fields["file"])
        self.bridge.update(job.job_id, 1, 3, "convert")
        rgb = self._render(job, lambda: w2x.w2x.convert(
            x, None, method=method, noise_level=noise)[0])
        self.bridge.update(job.job_id, 2, 3, "encode")
        return self._encode_image(job, rgb)

    def _run_iw3(self, job: Job, fields: dict) -> bytes:
        from ..iw3.pipeline import StereoConfig, process_image
        from ..iw3.composition import StereoFormat
        depth_name = fields.get("depth_model", "Any_V2_S")
        fmt_name = fields.get("stereo_format", "half_sbs")
        cfg = StereoConfig(
            method=fields.get("method", "row_flow_v3"),
            divergence=float(fields.get("divergence", 2.0)),
            convergence=float(fields.get("convergence", 0.5)),
            format=StereoFormat.from_name(fmt_name))
        self.settings["iw3"].update({
            "method": cfg.method, "divergence": cfg.divergence,
            "convergence": cfg.convergence,
            "stereo_format": fmt_name, "depth_model": depth_name})
        self.bridge.update(job.job_id, 0, 3, "load depth model")
        dm = self.iw3_runtime(depth_name)
        side = self.stereo_runtime(cfg.method)
        x = self._decode_image(job, fields["file"])
        self.bridge.update(job.job_id, 1, 3, "depth + warp")
        out = self._render(job, lambda: process_image(x, cfg, dm,
                                                      side_model=side))
        self.bridge.update(job.job_id, 2, 3, "encode")
        return self._encode_image(job, out)


    # ------------------------------------------------- server-side video jobs
    # The reference GUIs operate on local paths; uploads are impractical for
    # video, so these jobs take input/output paths on the server.
    def _check_paths(self, fields):
        src = fields.get("input_path", "")
        dst = fields.get("output_path", "")
        if not src or not os.path.isfile(src):
            raise ValueError(f"input_path not found: {src!r}")
        if not dst:
            raise ValueError("output_path required")
        return src, dst

    def _progress(self, job):
        def cb(done, total):
            self.bridge.update(job.job_id, int(done), int(total or 0),
                               "frames")
        return cb

    def _run_stlizer(self, job: Job, fields: dict) -> bytes:
        from ..stlizer.pipeline import stabilize_video
        src, dst = self._check_paths(fields)
        smoothing = float(fields.get("smoothing", 2.0))
        border = fields.get("border", "black")
        self.settings["stlizer"].update({"smoothing": smoothing,
                                         "border": border})
        self.bridge.update(job.job_id, 0, 0, "analyzing")
        r = stabilize_video(src, dst, smoothing=smoothing, border=border,
                            progress_callback=self._progress(job),
                            device=self.device)
        job.content_type = "application/json"
        job.filename = "result.json"
        return json.dumps({"output_path": dst, "frames": r["frames"],
                           "fps": r["fps"]}).encode()

    def _run_iw3_video(self, job: Job, fields: dict) -> bytes:
        from ..iw3.pipeline import StereoConfig
        from ..iw3.composition import StereoFormat
        from ..iw3.video import process_video_full
        src, dst = self._check_paths(fields)
        fmt_name = fields.get("stereo_format", "half_sbs")
        cfg = StereoConfig(
            method=fields.get("method", "row_flow_v3"),
            divergence=float(fields.get("divergence", 2.0)),
            convergence=float(fields.get("convergence", 0.5)),
            format=StereoFormat.from_name(fmt_name))
        self.bridge.update(job.job_id, 0, 0, "loading depth model")
        dm = self.iw3_runtime(fields.get("depth_model", "Any_V2_S"))
        side_model = self.stereo_runtime(cfg.method)
        from ..video import VideoOutputConfig

        def truthy(name):
            return str(fields.get(name, "")).lower() in ("1", "true", "on",
                                                         "yes")
        process_video_full(
            src, dst, cfg, dm, side_model=side_model,
            video_config=VideoOutputConfig(
                max_fps=float(fields.get("max_fps", 30.0))),
            ema_normalize=truthy("ema_normalize"),
            scene_detect=truthy("scene_detect"),
            autocrop=truthy("autocrop"),
            convergence_mode=fields.get("convergence_mode", "constant"))
        job.content_type = "application/json"
        job.filename = "result.json"
        return json.dumps({"output_path": dst}).encode()


def quantize_u8(arr) -> np.ndarray:
    """[0, 1] floats -> uint8 as the GUIs write their PNGs."""
    return (np.clip(np.asarray(arr), 0, 1) * 255 + 0.5).astype(np.uint8)


def _parse_body(handler) -> dict:
    from ..waifu2x.web import _parse_multipart
    return _parse_multipart(handler)


def render_page(service: GuiService) -> str:
    tr = service.tr
    w2x = service.settings["waifu2x"].as_dict()
    iw3 = service.settings["iw3"].as_dict()

    def sel(cur, val):
        return " selected" if str(cur) == str(val) else ""

    return f"""<!doctype html>
<html dir="{'rtl' if tr.rtl else 'ltr'}"><head><meta charset="utf-8">
<title>nunif_tpu</title>
<style>
body{{font-family:sans-serif;max-width:720px;margin:2em auto;padding:0 1em}}
fieldset{{margin-bottom:1.5em}} label{{display:inline-block;min-width:10em}}
progress{{width:100%}} .row{{margin:.4em 0}}
</style></head><body>
<h1>nunif_tpu</h1>
<fieldset><legend>waifu2x</legend>
<form id="w2x">
<div class="row"><label>{tr('Input')}</label><input type="file" name="file" required></div>
<div class="row"><label>{tr('Method')}</label><select name="method">
<option{sel(w2x['method'], 'scale')}>scale</option>
<option{sel(w2x['method'], 'noise')}>noise</option>
<option{sel(w2x['method'], 'noise_scale')}>noise_scale</option></select></div>
<div class="row"><label>{tr('Noise Level')}</label><select name="noise_level">
<option{sel(w2x['noise_level'], 0)}>0</option><option{sel(w2x['noise_level'], 1)}>1</option>
<option{sel(w2x['noise_level'], 2)}>2</option><option{sel(w2x['noise_level'], 3)}>3</option>
</select></div>
<button>{tr('Start')}</button></form></fieldset>
<fieldset><legend>iw3 (2D&rarr;3D)</legend>
<form id="iw3">
<div class="row"><label>{tr('Input')}</label><input type="file" name="file" required></div>
<div class="row"><label>{tr('Depth Model')}</label><select name="depth_model">
<option{sel(iw3['depth_model'], 'Any_V2_S')}>Any_V2_S</option>
<option{sel(iw3['depth_model'], 'Any_S')}>Any_S</option>
<option{sel(iw3['depth_model'], 'Any_V2_B')}>Any_V2_B</option></select></div>
<div class="row"><label>{tr('Method')}</label><select name="method">
<option{sel(iw3['method'], 'row_flow_v3')}>row_flow_v3</option>
<option{sel(iw3['method'], 'mlbw_l2')}>mlbw_l2</option>
<option{sel(iw3['method'], 'forward_fill')}>forward_fill</option>
<option{sel(iw3['method'], 'grid_sample')}>grid_sample</option></select></div>
<div class="row"><label>{tr('Divergence')}</label>
<input name="divergence" value="{iw3['divergence']}" size="5"></div>
<div class="row"><label>{tr('Convergence')}</label>
<input name="convergence" value="{iw3['convergence']}" size="5"></div>
<div class="row"><label>{tr('Stereo Format')}</label><select name="stereo_format">
<option{sel(iw3['stereo_format'], 'half_sbs')}>half_sbs</option>
<option{sel(iw3['stereo_format'], 'sbs')}>sbs</option>
<option{sel(iw3['stereo_format'], 'tb')}>tb</option>
<option{sel(iw3['stereo_format'], 'anaglyph')}>anaglyph</option></select></div>
<button>{tr('Start')}</button></form></fieldset>
<fieldset><legend>iw3 video ({tr('Input')}/{tr('Output')} = server paths)</legend>
<form id="iw3_video">
<div class="row"><label>{tr('Input')}</label><input name="input_path" size="40" required></div>
<div class="row"><label>{tr('Output')}</label><input name="output_path" size="40" required></div>
<div class="row"><label>{tr('Method')}</label><select name="method">
<option>row_flow_v3</option><option>mlbw_l2</option><option>forward_fill</option>
<option>grid_sample</option></select></div>
<div class="row"><label>{tr('Stereo Format')}</label><select name="stereo_format">
<option>half_sbs</option><option>sbs</option><option>tb</option></select></div>
<div class="row"><label>{tr('Max FPS')}</label><input name="max_fps" value="30" size="5"></div>
<div class="row"><label>{tr('Flicker Reduction')}</label><input type="checkbox" name="ema_normalize" value="1"></div>
<div class="row"><label>{tr('Scene Detection')}</label><input type="checkbox" name="scene_detect" value="1"></div>
<div class="row"><label>{tr('Auto Crop')}</label><input type="checkbox" name="autocrop" value="1"></div>
<div class="row"><label>{tr('Convergence Mode')}</label>
<select name="convergence_mode"><option value="constant">constant</option>
<option value="sod_v1">sod_v1</option></select></div>
<button>{tr('Start')}</button></form></fieldset>
<fieldset><legend>stlizer ({tr('Input')}/{tr('Output')} = server paths)</legend>
<form id="stlizer">
<div class="row"><label>{tr('Input')}</label><input name="input_path" size="40" required></div>
<div class="row"><label>{tr('Output')}</label><input name="output_path" size="40" required></div>
<div class="row"><label>Smoothing</label>
<input name="smoothing" value="{service.settings['stlizer'].get('smoothing')}" size="5"></div>
<div class="row"><label>Border</label><select name="border">
<option>black</option><option>crop</option><option>expand</option>
<option>outpaint</option></select></div>
<button>{tr('Start')}</button></form></fieldset>
<div id="status"></div><progress id="bar" value="0" max="1" hidden></progress>
<div id="out"></div>
<script>
async function submit(formId) {{
  const f = document.getElementById(formId);
  f.addEventListener('submit', async (ev) => {{
    ev.preventDefault();
    const resp = await fetch('/api/' + formId, {{method: 'POST',
        body: new FormData(f)}});
    const {{job_id}} = await resp.json();
    const bar = document.getElementById('bar');
    const status = document.getElementById('status');
    bar.hidden = false;
    const es = new EventSource('/api/progress?job=' + job_id);
    es.onmessage = async (m) => {{
      const e = JSON.parse(m.data);
      bar.value = e.total ? e.step / e.total : 0;
      status.textContent = e.desc || '{tr("Processing...")}';
      if (e.done) {{
        es.close();
        if (e.error) {{ status.textContent = '{tr("Error")}: ' + e.error; return; }}
        status.textContent = '{tr("Done")}';
        const r = await fetch('/api/result/' + job_id);
        const ctype = r.headers.get('Content-Type') || '';
        if (ctype.startsWith('image/')) {{
          const url = URL.createObjectURL(await r.blob());
          document.getElementById('out').innerHTML =
            `<a href="${{url}}" download="output.png"><img src="${{url}}" style="max-width:100%"></a>`;
        }} else {{
          document.getElementById('out').textContent = await r.text();
        }}
      }}
    }};
  }});
}}
submit('w2x'); submit('iw3'); submit('iw3_video'); submit('stlizer');
document.getElementById('w2x').action = '/api/waifu2x';
</script></body></html>"""


def make_handler(service: GuiService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug("gui: " + fmt, *args)

        def _send(self, code, body, ctype="text/html; charset=utf-8"):
            if isinstance(body, str):
                body = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(200, render_page(service))
            elif path == "/api/settings":
                app = self.path.split("app=")[-1].split("&")[0] or "waifu2x"
                store = service.settings.get(app)
                if store is None:
                    self._send(404, json.dumps({"error": "unknown app"}),
                               "application/json")
                else:
                    self._send(200, json.dumps(store.as_dict()),
                               "application/json")
            elif path.startswith("/api/result/"):
                job = service.get_job(path.rsplit("/", 1)[-1])
                if job is None:
                    self._send(404, "no such job")
                elif not job.done.is_set():
                    self._send(202, "pending")
                elif job.error:
                    self._send(500, job.error, "text/plain")
                else:
                    self._send(200, job.result, job.content_type)
            elif path == "/api/progress":
                job_id = self.path.split("job=")[-1].split("&")[0]
                self._sse_progress(job_id)
            else:
                self._send(404, "not found")

        def _sse_progress(self, job_id: str):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            q = service.bridge.subscribe()
            try:
                last = service.bridge.latest(job_id)
                if last is not None:
                    self._sse_emit(last)
                    if last.done:
                        return
                deadline = time.time() + 600
                while time.time() < deadline:
                    try:
                        ev = q.get(timeout=10)
                    except Exception:
                        self.wfile.write(b": keepalive\n\n")
                        self.wfile.flush()
                        continue
                    if ev.job_id != job_id:
                        continue
                    self._sse_emit(ev)
                    if ev.done:
                        return
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                service.bridge.unsubscribe(q)

        def _sse_emit(self, ev):
            self.wfile.write(
                b"data: " + json.dumps(ev.to_dict()).encode() + b"\n\n")
            self.wfile.flush()

        def do_POST(self):
            path = self.path.split("?")[0]
            try:
                if path in ("/api/waifu2x", "/api/w2x", "/api/iw3"):
                    fields = _parse_body(self)
                    if "file" not in fields:
                        raise ValueError("no file uploaded")
                    kind = "iw3" if path.endswith("iw3") else "waifu2x"
                    job = service.submit(kind, fields)
                    self._send(200, json.dumps({"job_id": job.job_id}),
                               "application/json")
                elif path in ("/api/stlizer", "/api/iw3_video"):
                    fields = _parse_body(self)
                    kind = path.rsplit("/", 1)[-1]
                    job = service.submit(kind, fields)
                    self._send(200, json.dumps({"job_id": job.job_id}),
                               "application/json")
                elif path == "/api/settings":
                    fields = _parse_body(self)
                    app = fields.pop("app", "waifu2x")
                    store = service.settings.get(app)
                    if store is None:
                        raise ValueError("unknown app")
                    store.update(fields)
                    self._send(200, json.dumps({"ok": True}),
                               "application/json")
                else:
                    self._send(404, "not found")
            except Exception as e:
                self._send(400, json.dumps({"error": str(e)}),
                           "application/json")

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description="nunif_tpu_torch browser GUI")
    p.add_argument("--port", type=int, default=8813)
    p.add_argument("--bind", default="127.0.0.1")
    p.add_argument("--lang", default=None,
                   help="locale override (en/ja/zh_CN)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the models (cpu: the plain twins)")
    args = p.parse_args(argv)
    service = GuiService(lang=args.lang, device=args.device)
    server = ThreadingHTTPServer((args.bind, args.port),
                                 make_handler(service))
    print(f"nunif_tpu_torch gui: http://{args.bind}:{args.port}/", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
