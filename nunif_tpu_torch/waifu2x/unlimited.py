"""unlimited_waifu2x: the browser app that tiles an image client-side and
sends each tile to the server (counterpart of
``nunif_tpu/waifu2x/unlimited.py``).

The page (``UNLIMITED_HTML``, served at ``GET /unlimited``) does the tile
grid, replicate padding, the cumulative float32 seam blending, alpha,
progressive painting, cancel and its settings in the browser; only each
tile's forward pass runs on the server, behind ``POST /api/tile``:

  GET  /api/tile/info
    reply: JSON {name, scale, offset, noise} of the one model the server
    process loaded; the page locks its scale / noise controls to them.
  POST /api/tile?scale=2&noise=-1&tta=0&w=<tile_w>&h=<tile_h>
    body:  float32 LE, (h, w, 3) RGB in [0, 1]
    reply: float32 LE, (h*s - 2*offset, w*s - 2*offset, 3)
    headers: X-Tile-Scale, X-Tile-Offset (the model's I2I contract)
    scale and noise are checked against the loaded model: a mismatch is a
    400, never a silently different conversion.
"""
from __future__ import annotations

import numpy as np
import torch


@torch.inference_mode()
def tile_forward(service, tile: np.ndarray, tta: int = 0) -> np.ndarray:
    """One tile through the server's model, no tiling and no blending, in
    the renderer's compute dtype; ``tta`` averages the 8 dihedral
    transforms (each output clipped to [0, 1], as the JAX program does).

    tile: (h, w, 3) float32 in [0, 1].  Returns (h*s - 2*offset,
    w*s - 2*offset, 3) float32."""
    renderer = service.renderer
    model = renderer.model
    dt = renderer.policy.compute_dtype
    x = torch.from_numpy(np.array(tile, np.float32)).to(renderer.device)

    def fwd(t):
        return model(t.to(dt)[None])[0].float()

    if not tta:
        return fwd(x).cpu().numpy()
    acc = None
    for k in range(4):
        for flip in (False, True):
            t = torch.rot90(x, k, dims=(0, 1))
            if flip:
                t = t.flip(1)
            y = fwd(t)
            if flip:
                y = y.flip(1)
            y = torch.rot90(y, -k, dims=(0, 1))
            acc = y if acc is None else acc + y
    return (acc / 8.0).cpu().numpy()


UNLIMITED_HTML = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>unlimited waifu2x (nunif_tpu_torch)</title>
<style>
body { font-family: sans-serif; max-width: 980px; margin: 16px auto;
       background: #fafafa; color: #222; }
h1 { font-size: 1.3em; }
fieldset { border: 1px solid #ccc; margin-bottom: 8px; }
#drop { border: 2px dashed #999; padding: 24px; text-align: center;
        background: #fff; cursor: pointer; }
#drop.hover { border-color: #39f; background: #eef6ff; }
canvas { max-width: 100%; border: 1px solid #ddd; background: #fff; }
progress { width: 100%; }
button { padding: 4px 16px; }
.row { margin: 6px 0; }
#status { color: #555; font-size: 0.9em; }
</style>
</head>
<body>
<h1>unlimited waifu2x — GPU</h1>
<p>Client-side tiling + seam blending; tiles are upscaled by the server's
GPU per request, so there is no image size limit beyond your patience.</p>
<div id="drop">drop an image here, click to choose, or paste from
clipboard<input type="file" id="file" accept="image/*" hidden></div>
<fieldset><legend>settings</legend>
<div class="row">
 noise: <select id="noise">
  <option value="-1">none</option><option value="0">0</option>
  <option value="1">1</option><option value="2">2</option>
  <option value="3">3</option></select>
 scale: <select id="scale">
  <option value="2">2x</option><option value="1">1x</option></select>
 tile size: <select id="tile_size">
  <option value="64">64</option><option value="112">112</option>
  <option value="160" selected>160</option>
  <option value="256">256</option><option value="400">400</option></select>
 TTA: <input type="checkbox" id="tta">
 alpha: <input type="checkbox" id="alpha" checked>
</div>
<div class="row">
 <button id="start" disabled>start</button>
 <button id="stop" disabled>cancel</button>
 <a id="download" style="display:none" download="waifu2x.png">download</a>
</div>
</fieldset>
<progress id="prog" value="0" max="1" style="display:none"></progress>
<div id="status"></div>
<canvas id="src" style="display:none"></canvas>
<canvas id="dst"></canvas>
<script>
"use strict";
// ---- settings persistence (reference uses cookies; localStorage here) --
const SETTING_IDS = ["noise", "scale", "tile_size", "tta", "alpha"];
function load_settings() {
  for (const id of SETTING_IDS) {
    const v = localStorage.getItem("unlimited_" + id);
    if (v === null) continue;
    const el = document.getElementById(id);
    if (el.type === "checkbox") el.checked = (v === "1");
    else el.value = v;
  }
}
function save_settings() {
  for (const id of SETTING_IDS) {
    const el = document.getElementById(id);
    localStorage.setItem("unlimited_" + id,
                         el.type === "checkbox" ? (el.checked ? "1" : "0")
                                                : el.value);
  }
}

// ---- tile grid math: exact port of nunif/utils/seam_blending.py ------
const BLEND_SIZE = 16;
function calc_parameters(x_h, x_w, scale, offset, tile_size, blend_size) {
  const p = {};
  p.y_h = x_h * scale;
  p.y_w = x_w * scale;
  p.input_offset = Math.ceil(offset / scale);
  p.input_blend_size = Math.ceil(blend_size / scale);
  p.input_tile_step = tile_size - (p.input_offset * 2 + p.input_blend_size);
  p.output_tile_step = p.input_tile_step * scale;
  let h_blocks = 0, w_blocks = 0, input_h = 0, input_w = 0;
  while (input_h < x_h + p.input_offset * 2) {
    input_h = h_blocks * p.input_tile_step + tile_size; ++h_blocks;
  }
  while (input_w < x_w + p.input_offset * 2) {
    input_w = w_blocks * p.input_tile_step + tile_size; ++w_blocks;
  }
  p.h_blocks = h_blocks; p.w_blocks = w_blocks;
  p.input_h = input_h; p.input_w = input_w;
  p.y_buffer_h = input_h * scale;
  p.y_buffer_w = input_w * scale;
  p.pad = [p.input_offset, input_w - (x_w + p.input_offset),
           p.input_offset, input_h - (x_h + p.input_offset)];
  return p;
}
function make_blend_filter(scale, offset, tile_size, blend_size) {
  const out_h = tile_size * scale - offset * 2;
  const out_w = tile_size * scale - offset * 2;
  const ramp = (n) => {
    const r = new Float32Array(n).fill(1.0);
    for (let i = 0; i < blend_size; ++i) {
      const value = 1.0 - (1.0 / (blend_size + 1)) * (i + 1);
      const d = blend_size - 1 - i;
      r[d] = value; r[n - 1 - d] = value;
    }
    return r;
  };
  const rh = ramp(out_h), rw = ramp(out_w);
  const f = new Float32Array(out_h * out_w);
  for (let i = 0; i < out_h; ++i)
    for (let j = 0; j < out_w; ++j)
      f[i * out_w + j] = Math.min(rh[i], rw[j]);
  return {data: f, h: out_h, w: out_w};
}

// cumulative seam blending accumulator (seam_blending.py:155-174 update)
class SeamBlending {
  constructor(x_h, x_w, scale, offset, tile_size) {
    this.p = calc_parameters(x_h, x_w, scale, offset, tile_size, BLEND_SIZE);
    this.scale = scale;
    this.filter = make_blend_filter(scale, offset, tile_size, BLEND_SIZE);
    const n = this.p.y_buffer_h * this.p.y_buffer_w * 3;
    this.pixels = new Float32Array(n);
    this.weights = new Float32Array(n);
  }
  update(tile, tile_i, tile_j) {
    // tile: Float32Array (H, W, 3) HWC
    const {h: H, w: W, data: F} = this.filter;
    const bw = this.p.y_buffer_w;
    const h0 = this.p.output_tile_step * tile_i;
    const w0 = this.p.output_tile_step * tile_j;
    for (let i = 0; i < H; ++i) {
      for (let j = 0; j < W; ++j) {
        const f = F[i * W + j];
        const bi = ((h0 + i) * bw + (w0 + j)) * 3;
        const ti = (i * W + j) * 3;
        for (let c = 0; c < 3; ++c) {
          const old_w = this.weights[bi + c];
          const next_w = old_w + f;
          const keep = old_w / next_w;
          this.pixels[bi + c] = this.pixels[bi + c] * keep +
                                tile[ti + c] * (1.0 - keep);
          this.weights[bi + c] = next_w;
        }
      }
    }
  }
  // crop the valid output region: buffer row/col 0 corresponds to
  // -pad_top*scale of the original image
  output(x_h, x_w) {
    const s = this.scale, bw = this.p.y_buffer_w;
    const oy = (this.p.pad[2] - this.p.input_offset) * s;
    const ox = (this.p.pad[0] - this.p.input_offset) * s;
    const out = new Float32Array(x_h * s * x_w * s * 3);
    for (let i = 0; i < x_h * s; ++i) {
      const src = ((i + oy) * bw + ox) * 3;
      out.set(this.pixels.subarray(src, src + x_w * s * 3), i * x_w * s * 3);
    }
    return out;
  }
}

// ---- image helpers ----------------------------------------------------
// replication padding into the padded input canvas (the reference pads
// with reflection/replication per style; replication here, matching the
// art default)
function pad_replicate(rgb, h, w, pad) {
  const [pl, pr, pt, pb] = pad;
  const H = h + pt + pb, W = w + pl + pr;
  const out = new Float32Array(H * W * 3);
  for (let i = 0; i < H; ++i) {
    const si = Math.min(Math.max(i - pt, 0), h - 1);
    for (let j = 0; j < W; ++j) {
      const sj = Math.min(Math.max(j - pl, 0), w - 1);
      const a = (i * W + j) * 3, b = (si * w + sj) * 3;
      out[a] = rgb[b]; out[a + 1] = rgb[b + 1]; out[a + 2] = rgb[b + 2];
    }
  }
  return out;
}

async function fetch_tile(tile, tile_size, params) {
  const q = new URLSearchParams({...params, w: tile_size, h: tile_size});
  const res = await fetch("/api/tile?" + q.toString(), {
    method: "POST",
    headers: {"Content-Type": "application/octet-stream"},
    body: tile.buffer.slice(tile.byteOffset,
                            tile.byteOffset + tile.byteLength),
  });
  if (!res.ok) throw new Error("tile failed: " + res.status);
  const scale = parseInt(res.headers.get("X-Tile-Scale"));
  const offset = parseInt(res.headers.get("X-Tile-Offset"));
  const buf = await res.arrayBuffer();
  return {data: new Float32Array(buf), scale: scale, offset: offset};
}

// ---- main conversion loop ---------------------------------------------
let g_stop = false;
async function convert_plane(rgb, h, w, params, tile_size, on_tile) {
  // probe one tile to learn scale/offset (echoed by the server)
  const probe = await fetch_tile(new Float32Array(tile_size * tile_size * 3),
                                 tile_size, params);
  const sb = new SeamBlending(h, w, probe.scale, probe.offset, tile_size);
  const p = sb.p;
  const padded = pad_replicate(rgb, h, w, p.pad);
  const W = p.input_w;
  const total = p.h_blocks * p.w_blocks;
  let done = 0;
  for (let ti = 0; ti < p.h_blocks && !g_stop; ++ti) {
    for (let tj = 0; tj < p.w_blocks && !g_stop; ++tj) {
      const i0 = ti * p.input_tile_step, j0 = tj * p.input_tile_step;
      const tile = new Float32Array(tile_size * tile_size * 3);
      for (let i = 0; i < tile_size; ++i) {
        const src = ((i0 + i) * W + j0) * 3;
        tile.set(padded.subarray(src, src + tile_size * 3),
                 i * tile_size * 3);
      }
      const out = await fetch_tile(tile, tile_size, params);
      sb.update(out.data, ti, tj);
      ++done;
      on_tile(done / total, sb, probe.scale, ti, tj);
    }
  }
  if (g_stop) return null;
  return {data: sb.output(h, w), scale: probe.scale};
}

function paint(canvas, data, h, w, alpha) {
  canvas.width = w; canvas.height = h;
  const ctx = canvas.getContext("2d");
  const img = ctx.createImageData(w, h);
  for (let i = 0; i < h * w; ++i) {
    img.data[i * 4] = Math.round(
        Math.min(Math.max(data[i * 3], 0), 1) * 255);
    img.data[i * 4 + 1] = Math.round(
        Math.min(Math.max(data[i * 3 + 1], 0), 1) * 255);
    img.data[i * 4 + 2] = Math.round(
        Math.min(Math.max(data[i * 3 + 2], 0), 1) * 255);
    img.data[i * 4 + 3] = alpha ? Math.round(
        Math.min(Math.max(alpha[i * 3], 0), 1) * 255) : 255;
  }
  ctx.putImageData(img, 0, 0);
}

async function run() {
  const src = document.getElementById("src");
  const dst = document.getElementById("dst");
  const status = document.getElementById("status");
  const prog = document.getElementById("prog");
  const h = src.height, w = src.width;
  if (!h || !w) return;
  save_settings();
  g_stop = false;
  document.getElementById("start").disabled = true;
  document.getElementById("stop").disabled = false;
  document.getElementById("download").style.display = "none";
  prog.style.display = "";
  const ctx = src.getContext("2d");
  const im = ctx.getImageData(0, 0, w, h);
  const rgb = new Float32Array(h * w * 3);
  const a3 = new Float32Array(h * w * 3);
  let has_alpha = false;
  for (let i = 0; i < h * w; ++i) {
    rgb[i * 3] = im.data[i * 4] / 255;
    rgb[i * 3 + 1] = im.data[i * 4 + 1] / 255;
    rgb[i * 3 + 2] = im.data[i * 4 + 2] / 255;
    const a = im.data[i * 4 + 3] / 255;
    a3[i * 3] = a3[i * 3 + 1] = a3[i * 3 + 2] = a;
    if (a < 1) has_alpha = true;
  }
  const params = {
    scale: document.getElementById("scale").value,
    noise: document.getElementById("noise").value,
    tta: document.getElementById("tta").checked ? 1 : 0,
  };
  const tile_size = parseInt(document.getElementById("tile_size").value);
  const t0 = performance.now();
  try {
    const result = await convert_plane(rgb, h, w, params, tile_size,
      (frac, sb, scale) => {
        prog.value = frac;
        status.textContent = "tiles: " + Math.round(frac * 100) + "%";
        // progressive paint of the blended buffer so far
        paint(dst, sb.output(h, w), h * scale, w * scale, null);
      });
    if (result === null) { status.textContent = "cancelled"; return; }
    let alpha_out = null;
    if (has_alpha && document.getElementById("alpha").checked && !g_stop) {
      status.textContent = "alpha channel...";
      // alpha rides the same model as an (a,a,a) image — the reference's
      // keep_alpha path (script.js to_input keep_alpha)
      const ares = await convert_plane(a3, h, w, params, tile_size,
                                       (frac) => { prog.value = frac; });
      if (ares !== null) alpha_out = ares.data;
    }
    paint(dst, result.data, h * result.scale, w * result.scale, alpha_out);
    const dt = ((performance.now() - t0) / 1000).toFixed(1);
    status.textContent = "done in " + dt + "s (" +
        (w * result.scale) + "x" + (h * result.scale) + ")";
    const dl = document.getElementById("download");
    dl.href = dst.toDataURL("image/png");
    dl.style.display = "";
  } catch (e) {
    status.textContent = "error: " + e.message;
  } finally {
    document.getElementById("start").disabled = false;
    document.getElementById("stop").disabled = true;
    prog.style.display = "none";
  }
}

// ---- input wiring ------------------------------------------------------
function set_image(blob) {
  const src = document.getElementById("src");
  const img = new Image();
  img.onload = () => {
    src.width = img.width; src.height = img.height;
    src.getContext("2d").drawImage(img, 0, 0);
    src.style.display = "";
    document.getElementById("start").disabled = false;
    document.getElementById("status").textContent =
        img.width + "x" + img.height + " loaded";
    URL.revokeObjectURL(img.src);
  };
  img.src = URL.createObjectURL(blob);
}
window.addEventListener("load", () => {
  load_settings();
  // one fixed model per server process: lock scale/noise to what the
  // server actually loaded (the server 400s on mismatch)
  fetch("/api/tile/info").then((r) => r.json()).then((info) => {
    for (const [id, v] of [["scale", info.scale], ["noise", info.noise]]) {
      const el = document.getElementById(id);
      el.value = String(v);
      el.disabled = true;
      el.title = "fixed by the server's loaded model (" + info.name + ")";
    }
  }).catch(() => {});
  const drop = document.getElementById("drop");
  const file = document.getElementById("file");
  drop.addEventListener("click", () => file.click());
  file.addEventListener("change", () => {
    if (file.files.length) set_image(file.files[0]);
  });
  drop.addEventListener("dragover", (e) => {
    e.preventDefault(); drop.classList.add("hover");
  });
  drop.addEventListener("dragleave", () => drop.classList.remove("hover"));
  drop.addEventListener("drop", (e) => {
    e.preventDefault(); drop.classList.remove("hover");
    if (e.dataTransfer.files.length) set_image(e.dataTransfer.files[0]);
  });
  window.addEventListener("paste", (e) => {
    for (const item of e.clipboardData.items) {
      if (item.type.startsWith("image/")) set_image(item.getAsFile());
    }
  });
  document.getElementById("start").addEventListener("click", run);
  document.getElementById("stop").addEventListener("click", () => {
    g_stop = true;
  });
});
</script>
</body>
</html>
"""
