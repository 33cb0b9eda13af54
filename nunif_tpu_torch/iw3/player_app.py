"""iw3 player frontend: the WebXR stereo viewer, a static page (counterpart
of ``nunif_tpu/iw3/player_app.py``, the same page).

Raw WebGL2 + WebXR with no external library.  One curved-screen mesh is
drawn once per eye with a per-eye UV window that selects the eye's half of
the video texture (SBS / TB); RGBD draws the colour half on a displacement
grid whose vertices the depth half pushes along -z.  Without a headset the
page draws both eyes side by side with drag-to-look; entering VR uses
``navigator.xr`` immersive-vr with an XRWebGLLayer viewport per view.

Served by ``nunif_tpu_torch/iw3/player.py`` at GET /; the media, library
and subtitle API is the player's.
"""

PLAYER_APP_HTML = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>iw3 player</title>
<style>
body { margin: 0; background: #101014; color: #dde; font-family: sans-serif; }
#panel { padding: 10px 14px; }
h2 { margin: 4px 0 10px; font-size: 1.1em; }
#library a { display: block; color: #9cf; text-decoration: none;
             padding: 2px 0; }
#library a:hover { color: #cef; }
#controls { margin: 8px 0; }
#controls label { margin-right: 12px; font-size: 0.9em; }
select, input[type=range] { vertical-align: middle; }
#glcanvas { width: 100%; height: 62vh; display: block; background: #000; }
video { display: none; }
button { padding: 4px 14px; margin-right: 8px; }
#status { font-size: 0.85em; color: #889; margin-top: 4px; }
#vbar { margin-top: 6px; }
#seek { width: 60%; }
</style>
</head>
<body>
<canvas id="glcanvas"></canvas>
<div id="panel">
<div id="vbar">
 <button id="play">play</button>
 <button id="entervr" disabled>enter VR</button>
 <input type="range" id="seek" min="0" max="1000" value="0">
 <span id="time"></span>
</div>
<div id="controls">
 <label>format <select id="format">
  <option value="auto" selected>auto</option>
  <option value="sbs">full SBS</option>
  <option value="half-sbs">half SBS</option>
  <option value="tb">top-bottom</option>
  <option value="rgbd">RGBD</option>
  <option value="mono">mono</option></select></label>
 <label>screen size <input type="range" id="size" min="0.5" max="4"
   step="0.1" value="2"></label>
 <label>distance <input type="range" id="dist" min="0.8" max="6"
   step="0.1" value="1.8"></label>
 <label>curvature <input type="range" id="curve" min="0" max="1"
   step="0.05" value="0.25"></label>
 <label>swap eyes <input type="checkbox" id="swap"></label>
 <label>subtitles <input type="checkbox" id="subs" checked></label>
</div>
<div id="status"></div>
<h2>library</h2>
<div id="library">loading...</div>
</div>
<video id="video" crossorigin="anonymous" playsinline></video>
<div id="subtitle" style="position:fixed;left:0;right:0;bottom:12vh;
 text-align:center;font-size:1.4em;text-shadow:0 0 4px #000;
 pointer-events:none"></div>
<script>
"use strict";
// ---------- tiny mat4 (column major, the WebGL/WebXR convention) --------
const M4 = {
  identity: () => new Float32Array([1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,0,1]),
  multiply: (a, b) => {
    const o = new Float32Array(16);
    for (let c = 0; c < 4; ++c)
      for (let r = 0; r < 4; ++r) {
        let s = 0;
        for (let k = 0; k < 4; ++k) s += a[k * 4 + r] * b[c * 4 + k];
        o[c * 4 + r] = s;
      }
    return o;
  },
  perspective: (fovy, aspect, near, far) => {
    const f = 1 / Math.tan(fovy / 2), o = new Float32Array(16);
    o[0] = f / aspect; o[5] = f;
    o[10] = (far + near) / (near - far); o[11] = -1;
    o[14] = 2 * far * near / (near - far);
    return o;
  },
  translate: (x, y, z) => {
    const o = M4.identity(); o[12] = x; o[13] = y; o[14] = z; return o;
  },
  rotXY: (rx, ry) => {
    const cx = Math.cos(rx), sx = Math.sin(rx);
    const cy = Math.cos(ry), sy = Math.sin(ry);
    // Ry * Rx
    return new Float32Array([
      cy, 0, -sy, 0,
      sy * sx, cx, cy * sx, 0,
      sy * cx, -sx, cy * cx, 0,
      0, 0, 0, 1]);
  },
};

// ---------- settings (reference storage.js; localStorage here) ----------
const SETTINGS = ["format", "size", "dist", "curve", "swap", "subs"];
function load_settings() {
  for (const id of SETTINGS) {
    const v = localStorage.getItem("iw3_player_" + id);
    if (v === null) continue;
    const el = document.getElementById(id);
    if (el.type === "checkbox") el.checked = v === "1"; else el.value = v;
  }
}
function save_settings() {
  for (const id of SETTINGS) {
    const el = document.getElementById(id);
    localStorage.setItem("iw3_player_" + id,
                         el.type === "checkbox" ? (el.checked ? "1" : "0")
                                                : el.value);
  }
}

// ---------- GL setup -----------------------------------------------------
const canvas = document.getElementById("glcanvas");
const gl = canvas.getContext("webgl2", {xrCompatible: true, antialias: true});
const video = document.getElementById("video");
let xr_session = null;
let cur_format = "mono";

const VS = `#version 300 es
in vec3 pos; in vec2 uv;
uniform mat4 mvp;
uniform vec4 uvwin;       // (u0, v0, uscale, vscale) per-eye window
uniform sampler2D tex;    // also sampled in VS for RGBD displacement
uniform vec4 rgbd;        // (enabled, depth_u0, depth_scale, displacement)
out vec2 vuv;
void main() {
  vec3 p = pos;
  if (rgbd.x > 0.5) {
    vec2 duv = vec2(rgbd.y + uv.x * rgbd.z, uv.y);
    float d = texture(tex, duv).r;
    p.z += (d - 0.5) * rgbd.w;   // push by depth around the screen plane
  }
  vuv = vec2(uvwin.x + uv.x * uvwin.z, uvwin.y + uv.y * uvwin.w);
  gl_Position = mvp * vec4(p, 1.0);
}`;
const FS = `#version 300 es
precision highp float;
in vec2 vuv; out vec4 color;
uniform sampler2D tex;
void main() { color = vec4(texture(tex, vuv).rgb, 1.0); }`;

function compile(type, src) {
  const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw new Error(gl.getShaderInfoLog(s));
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, compile(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, compile(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog);
if (!gl.getProgramParameter(prog, gl.LINK_STATUS))
  throw new Error(gl.getProgramInfoLog(prog));
const U = {
  mvp: gl.getUniformLocation(prog, "mvp"),
  uvwin: gl.getUniformLocation(prog, "uvwin"),
  rgbd: gl.getUniformLocation(prog, "rgbd"),
  tex: gl.getUniformLocation(prog, "tex"),
};

// curved screen mesh: GRID x GRID segments over a cylinder section.
// curvature 0 = flat plane; 1 = 90-degree arc (reference
// menu_screen_settings.js curvature range)
const GRID = 48;
let vao = null, n_index = 0;
function build_screen(aspect, size, curve) {
  const w = size, h = size / aspect;
  const verts = [], uvs = [], idx = [];
  const arc = curve * Math.PI / 2;
  const R = arc > 1e-4 ? w / arc : 0;
  for (let i = 0; i <= GRID; ++i) {
    for (let j = 0; j <= GRID; ++j) {
      const u = j / GRID, v = i / GRID;
      let x, z;
      if (arc > 1e-4) {
        const a = (u - 0.5) * arc;
        x = R * Math.sin(a);
        z = R * (1 - Math.cos(a));   // bows toward the viewer
      } else { x = (u - 0.5) * w; z = 0; }
      const y = (0.5 - v) * h;
      verts.push(x, y, z);
      uvs.push(u, v);
    }
  }
  for (let i = 0; i < GRID; ++i)
    for (let j = 0; j < GRID; ++j) {
      const a = i * (GRID + 1) + j;
      idx.push(a, a + 1, a + GRID + 1, a + 1, a + GRID + 2, a + GRID + 1);
    }
  if (vao) gl.deleteVertexArray(vao);
  vao = gl.createVertexArray();
  gl.bindVertexArray(vao);
  const vb = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, vb);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(verts), gl.STATIC_DRAW);
  const locp = gl.getAttribLocation(prog, "pos");
  gl.enableVertexAttribArray(locp);
  gl.vertexAttribPointer(locp, 3, gl.FLOAT, false, 0, 0);
  const ub = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, ub);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(uvs), gl.STATIC_DRAW);
  const locu = gl.getAttribLocation(prog, "uv");
  gl.enableVertexAttribArray(locu);
  gl.vertexAttribPointer(locu, 2, gl.FLOAT, false, 0, 0);
  const ib = gl.createBuffer();
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ib);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, new Uint32Array(idx),
                gl.STATIC_DRAW);
  n_index = idx.length;
  gl.bindVertexArray(null);
}

// video texture
const tex = gl.createTexture();
gl.bindTexture(gl.TEXTURE_2D, tex);
gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.LINEAR);
gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MAG_FILTER, gl.LINEAR);
gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_S, gl.CLAMP_TO_EDGE);
gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_T, gl.CLAMP_TO_EDGE);
gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGBA, 1, 1, 0, gl.RGBA,
              gl.UNSIGNED_BYTE, new Uint8Array([16, 16, 20, 255]));
let tex_ready = false;
let still_image = null;              // gallery mode: an <img> replaces video
function upload_frame() {
  if (still_image) {
    if (!tex_ready) {
      gl.bindTexture(gl.TEXTURE_2D, tex);
      gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGBA, gl.RGBA, gl.UNSIGNED_BYTE,
                    still_image);
      tex_ready = true;
    }
    return;
  }
  if (video.readyState >= 2) {
    gl.bindTexture(gl.TEXTURE_2D, tex);
    gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGBA, gl.RGBA, gl.UNSIGNED_BYTE,
                  video);
    tex_ready = true;
  }
}
function media_dims() {
  if (still_image) return [still_image.width, still_image.height];
  return [video.videoWidth || 16, video.videoHeight || 9];
}

// per-eye UV window for each stereo layout (reference stereo_screen.js
// texture repeat/offset table)
function uv_window(fmt, eye, swap) {
  if (swap && (eye === "left" || eye === "right"))
    eye = eye === "left" ? "right" : "left";
  switch (fmt) {
    case "sbs": case "half-sbs":
      return eye === "right" ? [0.5, 0, 0.5, 1] : [0, 0, 0.5, 1];
    case "tb":
      return eye === "right" ? [0, 0.5, 1, 0.5] : [0, 0, 1, 0.5];
    case "rgbd":
      return [0, 0, 0.5, 1];           // color = left half; depth = right
    default:
      return [0, 0, 1, 1];
  }
}
// source aspect of ONE eye's image
function eye_aspect(fmt) {
  const [vw, vh] = media_dims();
  switch (fmt) {
    case "sbs": case "rgbd": return (vw / 2) / vh;
    case "half-sbs": return vw / vh;   // half-width storage, 2x stretch
    case "tb": return vw / (vh / 2);
    default: return vw / vh;
  }
}

function draw_eye(eye, proj, viewm) {
  const fmt = cur_format;
  const size = parseFloat(document.getElementById("size").value);
  const dist = parseFloat(document.getElementById("dist").value);
  const swap = document.getElementById("swap").checked;
  const model = M4.translate(0, 0, -dist);
  const mvp = M4.multiply(proj, M4.multiply(viewm, model));
  gl.useProgram(prog);
  gl.bindVertexArray(vao);
  gl.activeTexture(gl.TEXTURE0);
  gl.bindTexture(gl.TEXTURE_2D, tex);
  gl.uniform1i(U.tex, 0);
  gl.uniformMatrix4fv(U.mvp, false, mvp);
  gl.uniform4fv(U.uvwin, uv_window(fmt, eye, swap));
  if (fmt === "rgbd") {
    // depth half starts at u=0.5; displacement scaled by screen size
    gl.uniform4fv(U.rgbd, [1, 0.5, 0.5, 0.35 * size]);
  } else {
    gl.uniform4fv(U.rgbd, [0, 0, 0, 0]);
  }
  gl.drawElements(gl.TRIANGLES, n_index, gl.UNSIGNED_INT, 0);
  gl.bindVertexArray(null);
}

// ---------- desktop preview loop (drag to look) -------------------------
let look = {rx: 0, ry: 0, drag: null};
canvas.addEventListener("pointerdown", (e) => {
  look.drag = [e.clientX, e.clientY, look.rx, look.ry];
});
window.addEventListener("pointerup", () => look.drag = null);
window.addEventListener("pointermove", (e) => {
  if (!look.drag) return;
  look.ry = look.drag[3] + (e.clientX - look.drag[0]) * 0.004;
  look.rx = look.drag[2] + (e.clientY - look.drag[1]) * 0.004;
  look.rx = Math.max(-1.2, Math.min(1.2, look.rx));
});

function rebuild() {
  const size = parseFloat(document.getElementById("size").value);
  const curve = parseFloat(document.getElementById("curve").value);
  build_screen(eye_aspect(cur_format), size, curve);
}

function desktop_frame() {
  if (xr_session) return;         // XR loop owns rendering
  upload_frame();
  const dpr = window.devicePixelRatio || 1;
  const w = canvas.clientWidth * dpr, h = canvas.clientHeight * dpr;
  if (canvas.width !== w || canvas.height !== h) {
    canvas.width = w; canvas.height = h;
  }
  gl.bindFramebuffer(gl.FRAMEBUFFER, null);
  gl.clearColor(0.04, 0.04, 0.06, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.enable(gl.DEPTH_TEST);
  const viewm = M4.rotXY(look.rx, look.ry);
  const stereo = cur_format !== "mono";
  if (stereo) {
    const proj = M4.perspective(1.0, (w / 2) / h, 0.05, 100);
    gl.viewport(0, 0, w / 2, h);
    draw_eye("left", proj, viewm);
    gl.viewport(w / 2, 0, w / 2, h);
    draw_eye("right", proj, viewm);
  } else {
    const proj = M4.perspective(1.0, w / h, 0.05, 100);
    gl.viewport(0, 0, w, h);
    draw_eye("left", proj, viewm);
  }
  requestAnimationFrame(desktop_frame);
}

// ---------- WebXR --------------------------------------------------------
async function enter_vr() {
  if (!navigator.xr) return;
  xr_session = await navigator.xr.requestSession("immersive-vr", {
    optionalFeatures: ["local-floor"]});
  await gl.makeXRCompatible();
  const layer = new XRWebGLLayer(xr_session, gl);
  xr_session.updateRenderState({baseLayer: layer});
  const space = await xr_session.requestReferenceSpace("local");
  xr_session.addEventListener("select", () => toggle_play());
  xr_session.addEventListener("end", () => {
    xr_session = null;
    requestAnimationFrame(desktop_frame);
  });
  const on_frame = (t, frame) => {
    if (!xr_session) return;
    xr_session.requestAnimationFrame(on_frame);
    upload_frame();
    const pose = frame.getViewerPose(space);
    if (!pose) return;
    gl.bindFramebuffer(gl.FRAMEBUFFER, layer.framebuffer);
    gl.clearColor(0.02, 0.02, 0.03, 1);
    gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
    gl.enable(gl.DEPTH_TEST);
    for (const view of pose.views) {
      const vp = layer.getViewport(view);
      gl.viewport(vp.x, vp.y, vp.width, vp.height);
      draw_eye(view.eye === "right" ? "right" : "left",
               view.projectionMatrix, view.transform.inverse.matrix);
    }
  };
  xr_session.requestAnimationFrame(on_frame);
}

// ---------- playback / library -------------------------------------------
function toggle_play() {
  if (video.paused) video.play(); else video.pause();
  document.getElementById("play").textContent =
      video.paused ? "play" : "pause";
}
function fmt_time(s) {
  if (!isFinite(s)) return "";
  const m = Math.floor(s / 60), r = Math.floor(s % 60);
  return m + ":" + String(r).padStart(2, "0");
}
function set_media(item) {
  cur_format = document.getElementById("format").value;
  if (cur_format === "auto") cur_format = item.stereo_format;
  const url = "/media/" + encodeURIComponent(item.path)
      .replace(/%2F/g, "/");
  if (item.type === "image") {
    video.pause();
    const img = new Image();
    img.onload = () => {
      still_image = img; tex_ready = false; rebuild();
      document.getElementById("status").textContent =
          item.path + "  [" + cur_format + "]";
    };
    img.src = url;
    save_settings();
    return;
  }
  still_image = null; tex_ready = false;
  video.src = url;
  video.load();
  video.play().catch(() => {});
  document.getElementById("play").textContent = "pause";
  document.getElementById("status").textContent =
      item.path + "  [" + cur_format + "]";
  // subtitles (WebVTT extracted server-side)
  const st = document.getElementById("subtitle");
  st.textContent = "";
  for (const tr of video.querySelectorAll("track")) tr.remove();
  if (document.getElementById("subs").checked && item.type === "video") {
    const track = document.createElement("track");
    track.kind = "subtitles"; track.default = true;
    track.src = "/subtitles/" + encodeURIComponent(item.path)
        .replace(/%2F/g, "/");
    video.appendChild(track);
    track.addEventListener("load", () => {
      track.track.mode = "hidden";     // rendered by us, not the video el
      track.track.addEventListener("cuechange", () => {
        const cues = track.track.activeCues;
        st.textContent = cues && cues.length ? cues[0].text : "";
      });
    });
  }
  video.addEventListener("loadedmetadata", rebuild, {once: true});
  save_settings();
}

async function load_library() {
  const res = await fetch("/api/library");
  const items = await res.json();
  const el = document.getElementById("library");
  el.textContent = items.length ? "" : "no media found";
  for (const item of items) {
    if (item.type === "zip") {
      // image gallery (reference gallery_manager.js): one link per entry
      for (const entry of item.entries) {
        const a = document.createElement("a");
        a.textContent = item.path + " :: " + entry + " [" +
            item.stereo_format + "]";
        a.href = "#";
        a.onclick = () => {
          set_media({path: item.path + "/" + entry, type: "image",
                     stereo_format: item.stereo_format});
          return false;
        };
        el.appendChild(a);
      }
      continue;
    }
    const a = document.createElement("a");
    a.textContent = item.path + " [" + item.stereo_format + "]" +
        (item.type === "image" ? " (image)" : "");
    a.href = "#";
    a.onclick = () => { set_media(item); return false; };
    el.appendChild(a);
  }
}

window.addEventListener("load", () => {
  load_settings();
  rebuild();
  load_library();
  document.getElementById("play").addEventListener("click", toggle_play);
  document.getElementById("entervr").addEventListener("click", enter_vr);
  for (const id of ["size", "curve"])
    document.getElementById(id).addEventListener("input", () => {
      rebuild(); save_settings();
    });
  for (const id of ["dist", "swap", "format", "subs"])
    document.getElementById(id).addEventListener("change", save_settings);
  const seek = document.getElementById("seek");
  seek.addEventListener("input", () => {
    if (isFinite(video.duration))
      video.currentTime = seek.value / 1000 * video.duration;
  });
  video.addEventListener("timeupdate", () => {
    if (isFinite(video.duration)) {
      seek.value = Math.round(video.currentTime / video.duration * 1000);
      document.getElementById("time").textContent =
          fmt_time(video.currentTime) + " / " + fmt_time(video.duration);
    }
  });
  window.addEventListener("keydown", (e) => {
    if (e.key === " ") { e.preventDefault(); toggle_play(); }
  });
  if (navigator.xr) {
    navigator.xr.isSessionSupported("immersive-vr").then((ok) => {
      document.getElementById("entervr").disabled = !ok;
    });
  }
  requestAnimationFrame(desktop_frame);
});
</script>
</body>
</html>
"""
