"""The port's browser GUI (``nunif_tpu_torch/gui/``) against the JAX
package's (``nunif_tpu/gui/``) on the CPU, mirroring tests/test_gui.py.

Both servers run side by side in threads (127.0.0.1, port 0) with seeded
slots: a waifu2x upconv_7 from one ``.nztm`` (both packages read it), the
NULL depth model for iw3.  Each request goes to both.  Held: the progress
hub, the settings store and the locale tables as JAX's; the page
byte-equal; the waifu2x and iw3 image jobs' PNGs at uint8 PSNR >= 50 dB
(both render in bf16, summing in other orders) and their progress streams
of the same steps; the iw3 video job's frames at >= 50 dB; status codes
and bodies of the error paths equal.  One divergence is guarded: the JAX image job
passes no stereo model, so its default method row_flow_v3 fails; the
port's runs it on the method's stereo model (K3's twin here).
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)

import io
import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

from nunif_tpu.gui import server as jax_server
from nunif_tpu.gui.locale import available_languages as jax_languages
from nunif_tpu.gui.locale import load_locale as jax_load_locale

from nunif_tpu_torch.gui import (ProgressBridge, SettingsStore, load_locale,
                                 server)
from nunif_tpu_torch.gui.locale import available_languages, parse_table
from nunif_tpu_torch.models import create_model, from_flax, save_model, to_flax

PSNR_MIN = 50.0


def psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    mse = (d * d).mean()
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


class TestProgressBridge:
    def test_publish_subscribe(self):
        b = ProgressBridge()
        q = b.subscribe()
        b.update("j1", 1, 4, "work")
        ev = q.get(timeout=2)
        assert ev.job_id == "j1" and ev.step == 1 and ev.total == 4
        assert abs(ev.fraction - 0.25) < 1e-9
        b.finish("j1")
        ev2 = q.get(timeout=2)
        assert ev2.done and ev2.error is None
        assert b.latest("j1").done
        b.unsubscribe(q)

    def test_tqdm_shim(self):
        b = ProgressBridge()
        events = []
        b.subscribe_callback(events.append)
        assert list(b.tqdm_class("job")(range(5), desc="iter")) == list(range(5))
        assert events[-1].done
        assert [e.step for e in events if not e.done] == [0, 1, 2, 3, 4, 5]


class TestSettingsStore:
    def test_roundtrip_defaults(self, tmp_path):
        s = SettingsStore("app", config_dir=str(tmp_path),
                          defaults={"a": 1, "b": "x"})
        s.set("a", 5)
        s.update({"c": [1, 2]})
        s2 = SettingsStore("app", config_dir=str(tmp_path),
                           defaults={"a": 1, "b": "x"})
        assert s2.get("a") == 5 and s2.get("b") == "x" and s2.get("c") == [1, 2]
        s2.reset()
        assert SettingsStore("app", config_dir=str(tmp_path)).get("a") is None

    def test_reads_the_jax_gui_file(self, tmp_path):
        from nunif_tpu.gui import SettingsStore as JaxSettingsStore
        JaxSettingsStore("iw3", config_dir=str(tmp_path)).update(
            {"divergence": 2.5})
        assert SettingsStore("iw3", config_dir=str(tmp_path)).get(
            "divergence") == 2.5

    def test_corrupt_file_ignored(self, tmp_path):
        (tmp_path / "bad.json").write_text("{not json")
        s = SettingsStore("bad", config_dir=str(tmp_path), defaults={"k": 7})
        assert s.get("k") == 7


class TestLocale:
    @pytest.mark.parametrize("lang", ["en", "ja_JP.UTF-8", "zh_CN", "fr_FR"])
    def test_tables_equal_jax(self, lang):
        tr, jtr = load_locale(lang), jax_load_locale(lang)
        assert (tr.lang, tr.rtl, tr.table) == (jtr.lang, jtr.rtl, jtr.table)

    def test_lookup_and_fallback(self):
        tr = load_locale("ja_JP.UTF-8")
        assert tr("Start") == "開始" and tr("UNKNOWN KEY") == "UNKNOWN KEY"

    def test_app_overlay(self, tmp_path):
        (tmp_path / "ja.yml").write_text("Start: カスタム開始\n_RTL: true\n",
                                         encoding="utf-8")
        tr = load_locale("ja", locale_dir=str(tmp_path))
        assert tr("Start") == "カスタム開始" and tr("Cancel") == "キャンセル"
        assert tr.rtl
        assert available_languages() == jax_languages() == ["en", "ja", "zh_CN"]

    def test_parse_table(self):
        assert parse_table("# c\nA: 'x: y'\nB: b\n\nC: false\n") == {
            "A": "x: y", "B": "b", "C": False}


def seeded_upconv7(path):
    import nunif_tpu_torch.waifu2x  # noqa: F401
    model = create_model("waifu2x.upconv_7")
    rng = np.random.default_rng(0)
    flat = {}
    for key, a in to_flax(model).items():
        if key.endswith("kernel"):
            std = 1.0 / np.sqrt(np.prod(a.shape[:-1]))
            flat[key] = (rng.standard_normal(a.shape) * std).astype(np.float32)
        else:
            flat[key] = (rng.normal(0, 0.02, a.shape)
                         + 0.5 * key.startswith("ConvTranspose")).astype(np.float32)
    from_flax(model, flat)
    save_model(model, str(path))
    return str(path)


class _W2xSlot:
    """The hub model's stand-in: a ``Waifu2x`` runtime with seeded slots."""

    def __init__(self, w2x):
        self.w2x = w2x


def serve(service, make_handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def guis(tmp_path_factory):
    root = tmp_path_factory.mktemp("gui")
    model_file = seeded_upconv7(root / "scale2x.nztm")
    saved = os.environ.get("NUNIF_TPU_GUI_DIR")

    os.environ["NUNIF_TPU_GUI_DIR"] = str(root / "settings_port")
    from nunif_tpu_torch.iw3.depth.factory import create_depth_model
    from nunif_tpu_torch.models import load_model
    from nunif_tpu_torch.waifu2x.runtime import Waifu2x
    port = server.GuiService(lang="en", device="cpu")
    w2x = Waifu2x("/nonexistent", device="cpu")
    model, _ = load_model(model_file, device="cpu")
    for method, n in (("scale", None), ("noise_scale", 0), ("noise_scale", 1)):
        w2x.set_slot(method, n, model)
    port._w2x = _W2xSlot(w2x)
    port._iw3 = ("NULL", create_depth_model("NULL", device="cpu").load())

    os.environ["NUNIF_TPU_GUI_DIR"] = str(root / "settings_jax")
    from nunif_tpu.iw3.depth import create_depth_model as jax_create_depth_model
    from nunif_tpu.models.io import load_model as jax_load_model
    from nunif_tpu.waifu2x.runtime import Waifu2x as JaxWaifu2x
    jax_ = jax_server.GuiService(lang="en")
    jw2x = JaxWaifu2x("/nonexistent")
    jm, jparams, _ = jax_load_model(model_file)
    for method, n in (("scale", None), ("noise_scale", 0), ("noise_scale", 1)):
        jw2x.set_slot(method, n, jm, jparams)
    jax_._w2x = _W2xSlot(jw2x)
    jax_._iw3 = ("NULL", jax_create_depth_model("NULL").load())
    if saved is None:
        os.environ.pop("NUNIF_TPU_GUI_DIR")
    else:
        os.environ["NUNIF_TPU_GUI_DIR"] = saved

    srv, url = serve(port, server.make_handler)
    jsrv, jurl = serve(jax_, jax_server.make_handler)
    yield {"port": (url, port), "jax": (jurl, jax_), "dir": root}
    srv.shutdown()
    jsrv.shutdown()


def fetch(req, timeout=300):
    """(status, body), for errors too."""
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def multipart(fields: dict, file_bytes: bytes):
    boundary = "XBOUNDARYX"
    parts = [f"--{boundary}\r\nContent-Disposition: form-data; "
             f"name=\"{k}\"\r\n\r\n{v}\r\n".encode() for k, v in fields.items()]
    parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                 f"name=\"file\"; filename=\"in.png\"\r\n"
                 f"Content-Type: image/png\r\n\r\n".encode()
                 + file_bytes + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def png(w=40, h=32, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    img = np.stack([yy, xx, (yy + xx) / 2], -1) + rng.normal(0, 0.05, (h, w, 3))
    buf = io.BytesIO()
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def post(url, path, body, ctype):
    return urllib.request.Request(url + path, data=body,
                                  headers={"Content-Type": ctype})


def progress_events(url, job_id):
    """Every event of the job's /api/progress stream, until done."""
    events = []
    with urllib.request.urlopen(f"{url}/api/progress?job={job_id}",
                                timeout=600) as r:
        for line in r:
            if line.startswith(b"data: "):
                events.append(json.loads(line[6:]))
                if events[-1]["done"]:
                    break
    return events


def wait_result(url, job_id, tries=3000):
    for _ in range(tries):
        status, body = fetch(f"{url}/api/result/{job_id}")
        if status != 202:
            return status, body
        time.sleep(0.1)
    raise AssertionError("job did not finish")


def submit(guis, path, body, ctype):
    """The same job on both servers: {name: (status, body, events)}."""
    out = {}
    for name in ("port", "jax"):
        url = guis[name][0]
        status, reply = fetch(post(url, path, body, ctype))
        assert status == 200, reply
        job_id = json.loads(reply)["job_id"]
        events = progress_events(url, job_id)
        out[name] = (*wait_result(url, job_id), events)
    return out


def test_index_page_equals_jax(guis):
    pages = [fetch(guis[n][0] + "/") for n in ("port", "jax")]
    assert pages[0] == pages[1]
    assert pages[0][0] == 200 and b"waifu2x" in pages[0][1]


def test_settings_api(guis):
    for name in ("port", "jax"):
        url = guis[name][0]
        assert "divergence" in json.loads(fetch(url + "/api/settings?app=iw3")[1])
        status, body = fetch(post(url, "/api/settings", b"app=iw3&divergence=2.5",
                                  "application/x-www-form-urlencoded"))
        assert status == 200 and json.loads(body)["ok"]
        assert json.loads(fetch(url + "/api/settings?app=iw3")[1])[
            "divergence"] == "2.5"
    assert os.path.exists(guis["dir"] / "settings_port" / "iw3.json")


@pytest.mark.parametrize("method,noise", [("noise_scale", "1"), ("scale", "0")])
def test_waifu2x_job_matches_jax(guis, method, noise):
    body, ctype = multipart({"method": method, "noise_level": noise}, png())
    res = submit(guis, "/api/waifu2x", body, ctype)
    (status, got, events), (jstatus, want, jevents) = res["port"], res["jax"]
    assert status == jstatus == 200
    got, want = np.asarray(Image.open(io.BytesIO(got))), \
        np.asarray(Image.open(io.BytesIO(want)))
    assert got.shape == want.shape == (64, 80, 3)
    assert psnr(got, want) >= PSNR_MIN
    # the stream starts at the latest event when it connects, so each
    # server's events are an ordered tail of the job's four
    every = [(0, 3, "load", False), (1, 3, "convert", False),
             (2, 3, "encode", False), (3, 3, "", True)]
    for evs in (events, jevents):
        strip = [(e["step"], e["total"], e["desc"], e["done"]) for e in evs]
        assert strip == every[every.index(strip[0]):]


def test_waifu2x_job_records_stage_times(guis):
    body, ctype = multipart({"method": "scale", "noise_level": "0"}, png())
    url, service = guis["port"]
    job_id = json.loads(fetch(post(url, "/api/waifu2x", body, ctype))[1])["job_id"]
    assert wait_result(url, job_id)[0] == 200
    times = service.get_job(job_id).times
    assert sorted(times) == ["decode", "encode", "render"]
    assert all(t > 0 for t in times.values())


def test_iw3_job_matches_jax(guis):
    body, ctype = multipart(
        {"method": "grid_sample", "divergence": "2.0", "convergence": "0.5",
         "stereo_format": "half_sbs", "depth_model": "NULL"}, png(64, 48, 1))
    res = submit(guis, "/api/iw3", body, ctype)
    (status, got, _e), (jstatus, want, _je) = res["port"], res["jax"]
    assert status == jstatus == 200
    got, want = np.asarray(Image.open(io.BytesIO(got))), \
        np.asarray(Image.open(io.BytesIO(want)))
    assert got.shape == want.shape == (48, 64, 3)
    assert psnr(got, want) >= PSNR_MIN


def test_iw3_row_flow_v3_job_diverges_from_jax(guis):
    """The JAX image job has no stereo model for its default method; the
    port's builds it (seeded) and answers with the image."""
    body, ctype = multipart(
        {"method": "row_flow_v3", "divergence": "2.0", "convergence": "0.5",
         "stereo_format": "half_sbs", "depth_model": "NULL"}, png(64, 48, 2))
    res = submit(guis, "/api/iw3", body, ctype)
    status, got, _e = res["port"]
    jstatus, jbody, jevents = res["jax"]
    assert jstatus == 500 and b"needs a stereo model" in jbody
    assert jevents[-1]["error"]
    assert status == 200
    assert np.asarray(Image.open(io.BytesIO(got))).shape == (48, 64, 3)
    assert "row_flow_v3" in guis["port"][1]._side


def test_iw3_video_job_matches_jax(guis, tmp_path):
    from nunif_tpu_torch.video import VideoReader, available, generate_video
    from nunif_tpu_torch.video import VideoOutputConfig
    if not available():
        pytest.skip("the native video library is not available")
    rng = np.random.default_rng(0)
    base = (rng.uniform(size=(48, 64, 3)) * 255).astype(np.uint8)
    src = str(tmp_path / "in.mkv")
    lossless = VideoOutputConfig(codec="utvideo", pix_fmt="gbrp",
                                 audio_copy=False)
    generate_video(src, (np.roll(base, i, axis=1) for i in range(6)), 64, 48,
                   fps=8, config=lossless)
    outs = {}
    for name in ("port", "jax"):
        dst = str(tmp_path / f"{name}.mp4")
        fields = {"input_path": src, "output_path": dst, "method": "grid_sample",
                  "stereo_format": "half_sbs", "depth_model": "NULL",
                  "max_fps": "8"}
        url = guis[name][0]
        status, reply = fetch(post(url, "/api/iw3_video",
                                   urllib.parse.urlencode(fields).encode(),
                                   "application/x-www-form-urlencoded"))
        assert status == 200, reply
        status, body = wait_result(url, json.loads(reply)["job_id"])
        assert status == 200 and json.loads(body) == {"output_path": dst}
        with VideoReader(dst) as r:
            outs[name] = [f for f, _pts in r]
    assert len(outs["port"]) == len(outs["jax"]) == 6
    for a, b in zip(outs["port"], outs["jax"]):
        assert psnr(a, b) >= PSNR_MIN


def test_stlizer_job(guis, tmp_path, monkeypatch):
    """A shaky 10-frame 96x160 clip through both GUIs' stlizer jobs
    (smoothing 1.0, border "expand", each package's seeded SuperPoint).
    Each job analyses the clip into its own cache (``NUNIF_TPU_HOME``):
    the result JSONs are equal but for the output path.  The seeded
    analyses agree only to hundredths of a pixel (``test_torch_stlizer.py``),
    so the frames are held on a second port job that reads the JAX job's
    cached analysis, as ``test_warp_pass_from_shared_cache_matches_jax``
    does: >= 50 dB of the JAX job's frames, padded by the same border to
    112x176.  Both sizes are multiples of 16: at other widths the native
    video library's H.264 path is at fault in either package (ROADMAP
    queue 3)."""
    from nunif_tpu_torch.video import VideoReader, available, generate_video
    from nunif_tpu_torch.video import VideoOutputConfig
    if not available():
        pytest.skip("the native video library is not available")
    rng = np.random.default_rng(0)
    base = (rng.uniform(size=(96, 160, 3)) * 255).astype(np.uint8)
    src = str(tmp_path / "shaky.mp4")
    generate_video(src, (np.roll(base, i % 3, axis=1) for i in range(10)),
                   160, 96, fps=8, config=VideoOutputConfig(audio_copy=False))

    def job(name, home, dst):
        monkeypatch.setenv("NUNIF_TPU_HOME", str(tmp_path / home))
        url = guis[name][0]
        status, reply = fetch(post(url, "/api/stlizer", urllib.parse.urlencode(
            {"input_path": src, "output_path": dst, "smoothing": "1.0",
             "border": "expand"}).encode(), "application/x-www-form-urlencoded"))
        assert status == 200, reply
        status, body = wait_result(url, json.loads(reply)["job_id"])
        assert status == 200, body
        result = json.loads(body)
        assert result.pop("output_path") == dst
        with VideoReader(dst) as r:
            return result, np.stack([f for f, _pts in r])

    want, want_frames = job("jax", "home_jax", str(tmp_path / "jax.mp4"))
    got, _frames = job("port", "home_port", str(tmp_path / "port.mp4"))
    assert got == want and want["frames"] == 10
    shared, got_frames = job("port", "home_jax", str(tmp_path / "shared.mp4"))
    assert shared == want
    assert got_frames.shape == want_frames.shape and len(got_frames) == 10
    assert got_frames.shape[1:3] == (112, 176)
    assert psnr(got_frames, want_frames) >= PSNR_MIN


@pytest.mark.parametrize("case", ["bad_upload", "unknown_result", "unknown_route",
                                  "unknown_settings_app", "bad_settings_app",
                                  "video_bad_path", "stlizer_no_output"])
def test_error_paths_answer_as_jax(guis, case):
    form = "application/x-www-form-urlencoded"

    def request(url):
        if case == "bad_upload":
            return fetch(post(url, "/api/waifu2x", b"nope", form))
        if case == "unknown_result":
            return fetch(url + "/api/result/zzz")
        if case == "unknown_route":
            return fetch(url + "/nothing")
        if case == "unknown_settings_app":
            return fetch(url + "/api/settings?app=nope")
        if case == "bad_settings_app":
            return fetch(post(url, "/api/settings", b"app=nope&x=1", form))
        data = (b"input_path=/nonexistent.mp4&output_path=/tmp/x.mp4"
                if case == "video_bad_path" else
                b"input_path=" + __file__.encode())
        kind = "iw3_video" if case == "video_bad_path" else "stlizer"
        status, reply = fetch(post(url, f"/api/{kind}", data, form))
        assert status == 200
        return wait_result(url, json.loads(reply)["job_id"])
    got, want = request(guis["port"][0]), request(guis["jax"][0])
    assert got == want
    assert got[0] in (400, 404, 500)
