"""waifu2x's serving surface in nunif_tpu_torch against the JAX package on
the CPU: the web server (a twin of each test of tests/test_web.py), the
unlimited tile API, the static i18n pages and the hub.

Both servers load the same checkpoint, a seeded upconv_7 ``.nztm``, and run
side by side in threads (127.0.0.1, port 0); each request goes to both.
Held: status codes and headers byte-equal (but ``Date``, and the length of
bodies that differ on purpose: the PNGs, and the pages, whose words say
GPU where JAX's say TPU); images and tiles at uint8 PSNR >= 50 dB (both
render in bf16, summing in other orders).  Two reference faults are not
copied, each with a ``*_diverges_from_jax`` guard: the hub's silent
fallback to the bundled models, and the web server's noise level taken
from the flag only; a third guard holds the port's result cache keyed on
the model, which the JAX server's is not.  Two faults of the JAX server
are repaired: its cache writers of one key share a temporary file, so
concurrent puts raise, and ``POST /api`` renders its one model whatever
noise level or scale the request names.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import argparse
import io
import json
import logging
import os
import threading
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

import nunif_tpu.waifu2x.hub as jhub
from nunif_tpu.waifu2x import unlimited as junlimited
from nunif_tpu.waifu2x import web as jweb
from nunif_tpu.waifu2x.webgen import load_locales as jax_locales
from nunif_tpu.waifu2x.webgen import pick_language as jax_pick_language

from nunif_tpu_torch.models import from_flax, save_model
from nunif_tpu_torch.waifu2x import hub, unlimited, web
from nunif_tpu_torch.waifu2x.models.upconv_7 import UpConv7
from nunif_tpu_torch.waifu2x.runtime import default_model_dir
from nunif_tpu_torch.waifu2x.webgen import (generate_pages, load_locales,
                                            pick_language)

PSNR_MIN = 50.0


def psnr(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    mse = (d * d).mean()
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def seeded_upconv7(path):
    """A seeded upconv_7 .nztm whose output is an image, not a clip."""
    model = UpConv7()
    rng = np.random.default_rng(0)
    from nunif_tpu_torch.models import to_flax
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


def serve(service, make_handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("web")
    model_file = seeded_upconv7(root / "scale2x.nztm")

    def args(name, **kw):
        return argparse.Namespace(
            model_file=model_file, arch=None, tile_size=64, batch_size=4,
            cache_dir=str(root / f"cache_{name}"), cache_size_mb=8,
            public_dir=str(root / f"public_{name}"), **kw)
    port = web.Waifu2xWebService(args("port", device="cpu", noise_level=None))
    jax_ = jweb.Waifu2xWebService(args("jax", noise_level=-1))
    srv, url = serve(port, web.make_handler)
    jsrv, jurl = serve(jax_, jweb.make_handler)
    yield {"port": (url, port), "jax": (jurl, jax_), "dir": root,
           "model_file": model_file}
    srv.shutdown()
    jsrv.shutdown()


def fetch(req, timeout=120):
    """(status, headers without Date, body), for errors too."""
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, headers, body = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, headers, body = e.code, e.headers, e.read()
    return status, {k: v for k, v in headers.items() if k != "Date"}, body


def both(servers, make_request):
    """The same request to both servers: (port's reply, JAX's reply)."""
    return (fetch(make_request(servers["port"][0])),
            fetch(make_request(servers["jax"][0])))


def post_image(im_bytes, **fields):
    boundary = "x123"
    parts = [f"--{boundary}\r\nContent-Disposition: form-data; "
             f"name=\"{k}\"\r\n\r\n{v}\r\n".encode() for k, v in fields.items()]
    parts += [f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
              f"filename=\"a.png\"\r\nContent-Type: image/png\r\n\r\n".encode(),
              im_bytes, f"\r\n--{boundary}--\r\n".encode()]
    body = b"".join(parts)
    return lambda url: urllib.request.Request(
        url + "/api", data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})


def png_bytes(w=32, h=24, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    img = np.stack([yy, xx, (yy + xx) / 2], -1) + rng.normal(0, 0.05, (h, w, 3))
    buf = io.BytesIO()
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def assert_same_headers(port, jax_):
    """Equal status and headers, each Content-Length its own body's (where
    the bodies differ on purpose, the lengths may too)."""
    assert port[0] == jax_[0]
    for _status, headers, body in (port, jax_):
        assert headers["Content-Length"] == str(len(body))
    assert {k: v for k, v in port[1].items() if k != "Content-Length"} == \
        {k: v for k, v in jax_[1].items() if k != "Content-Length"}


def assert_same_image_reply(port, jax_):
    (ps, ph, pb), (js, jh, jb) = port, jax_
    assert ps == js == 200
    assert_same_headers(port, jax_)
    a, b = (np.asarray(Image.open(io.BytesIO(x)).convert("RGB")) for x in (pb, jb))
    assert a.shape == b.shape
    assert psnr(a, b) >= PSNR_MIN
    return a


def as_jax_page(page: bytes) -> bytes:
    """The port's page in the JAX package's words."""
    return (page.decode("utf-8").replace("GPU", "TPU")
            .replace("nunif_tpu_torch.waifu2x.webgen", "nunif_tpu.waifu2x.webgen")
            .encode("utf-8"))


def test_index_and_health(servers):
    for path in ("/", "/health"):
        port, jax_ = both(servers, lambda url: url + path)
        assert port[0] == jax_[0] == 200
        assert_same_headers(port, jax_)
        assert as_jax_page(port[2]) == jax_[2]
    assert b"waifu2x" in port[2] or b"ok" in port[2]


def test_api_upscale(servers):
    data = png_bytes(32, 24)
    a = assert_same_image_reply(*both(servers, post_image(
        data, style="art", noise="-1", scale="2", format="png")))
    assert a.shape == (48, 64, 3)
    # the port's reply is its renderer's output on the decoded input
    _url, service = servers["port"]
    x = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32) / 255
    from nunif_tpu_torch.utils.pil_io import quantize
    np.testing.assert_array_equal(a, quantize(service.render(x), 8))


def test_api_cache_hit(servers):
    data = png_bytes(16, 16, seed=1)
    request = post_image(data, scale="2", format="png")
    first = both(servers, request)
    second = both(servers, request)
    assert first[0][2] == second[0][2] and first[1][2] == second[1][2]
    assert_same_image_reply(*second)


def test_api_no_image(servers):
    port, jax_ = both(servers, lambda url: urllib.request.Request(
        url + "/api", data=b"style=art",
        headers={"Content-Type": "application/x-www-form-urlencoded"}))
    assert port == jax_ and port[0] == 400


def test_concurrent_requests(servers):
    """Three requests at once to each server, images of three sizes."""
    datas = [png_bytes(16 + 8 * i, 16, seed=10 + i) for i in range(3)]
    results = {}

    def hit(key, i):
        results[key, i] = fetch(post_image(datas[i], scale="2")(servers[key][0]))

    threads = [threading.Thread(target=hit, args=(key, i))
               for key in ("port", "jax") for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i in range(3):
        assert_same_image_reply(results["port", i], results["jax", i])


def test_webgen_static_pages(tmp_path):
    """One page per locale, as the JAX package writes them but for its
    words; the flat locale reader reads what PyYAML reads."""
    import yaml
    import os
    from nunif_tpu.waifu2x.webgen import generate_pages as jax_generate
    from nunif_tpu_torch.waifu2x.webgen.gen import LOCALE_DIR
    paths = generate_pages(str(tmp_path / "port"))
    jpaths = jax_generate(str(tmp_path / "jax"))
    assert sorted(os.path.basename(p) for p in paths) == \
        sorted(os.path.basename(p) for p in jpaths)
    for p in paths:
        with open(p, "rb") as f, open(tmp_path / "jax" / os.path.basename(p),
                                      "rb") as g:
            assert as_jax_page(f.read()) == g.read()
    locales = load_locales()
    assert {lang: {k: v.replace("GPU", "TPU") for k, v in t.items()}
            for lang, t in locales.items()} == jax_locales()
    for lang in locales:
        with open(os.path.join(LOCALE_DIR, f"{lang}.yml"), encoding="utf-8") as f:
            assert yaml.safe_load(f) == locales[lang]
    ja = (tmp_path / "port" / "index.ja.html").read_text(encoding="utf-8")
    assert 'lang="ja"' in ja and "変換" in ja and "index.zh_CN.html" in ja


def test_webgen_pick_language():
    avail = ["en", "ja", "zh_CN", "es", "ru"]
    for header in ("ja,en;q=0.8", "zh-CN,zh;q=0.9", "fr-FR,fr;q=0.9,es;q=0.5",
                   "de", "", "es-MX", "ru;q=0.1,ja;q=0.2", "ja;q=x"):
        assert pick_language(header, avail) == jax_pick_language(header, avail)


def test_index_language_negotiation(servers):
    def req(url):
        return urllib.request.Request(url + "/", headers={"Accept-Language": "ja"})
    port, jax_ = both(servers, req)
    assert port[0] == jax_[0] == 200 and port[1]["Vary"] == "Accept-Language"
    assert_same_headers(port, jax_)
    assert as_jax_page(port[2]) == jax_[2] and "変換" in port[2].decode("utf-8")
    assert port[2] != web.INDEX_HTML.encode()
    for path in ("/index.ru.html", "/index.html", "/index.xx.html"):
        port, jax_ = both(servers, lambda url: url + path)
        assert_same_headers(port, jax_)
        assert as_jax_page(port[2]) == jax_[2]


def post_tile(tile, **params):
    q = "&".join(f"{k}={v}" for k, v in params.items())
    return lambda url: urllib.request.Request(
        url + "/api/tile?" + q, data=np.ascontiguousarray(tile).tobytes(),
        headers={"Content-Type": "application/octet-stream"})


def assert_same_tile_reply(port, jax_):
    assert port[0] == jax_[0] == 200 and port[1] == jax_[1]
    a, b = (np.frombuffer(r[2], np.float32) for r in (port, jax_))
    assert a.shape == b.shape
    assert psnr(np.round(a * 255), np.round(b * 255)) >= PSNR_MIN
    return a


def test_unlimited_page(servers):
    port, jax_ = both(servers, lambda url: url + "/unlimited")
    assert port[0] == jax_[0] == 200
    assert_same_headers(port, jax_)
    # the same app but for its words and one reworded script comment
    assert as_jax_page(port[2]).replace(b"nunif_tpu_torch", b"nunif_tpu") \
        .replace(b"main conversion loop ----", b"main conversion driver --") \
        == jax_[2]
    for marker in ("calc_parameters", "SeamBlending", "make_blend_filter",
                   "pad_replicate", "localStorage", "dragover", "paste",
                   "/api/tile", "cancel"):
        assert marker in port[2].decode("utf-8"), marker


def test_unlimited_tile_api(servers):
    tile = np.random.default_rng(5).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    port, jax_ = both(servers, post_tile(tile, w=64, h=64, tta=0))
    out = assert_same_tile_reply(port, jax_)
    assert port[1]["X-Tile-Scale"] == "2" and port[1]["X-Tile-Offset"] == "14"
    assert out.size == (128 - 28) ** 2 * 3
    port, jax_ = both(servers, post_tile(tile[:8], w=64, h=64, tta=0))
    assert port == jax_ and port[0] == 400


def test_unlimited_tile_info_and_validation(servers):
    port, jax_ = both(servers, lambda url: url + "/api/tile/info")
    assert port == jax_ and port[0] == 200
    assert json.loads(port[2]) == {"name": "waifu2x.upconv_7", "scale": 2,
                                   "offset": 14, "noise": -1}
    tile = np.zeros((64, 64, 3), np.float32)
    assert_same_tile_reply(*both(servers, post_tile(
        tile, w=64, h=64, tta=0, scale=2, noise=-1)))
    for bad in ({"scale": 4}, {"noise": 3}, {"w": 2000}, {"tta": 1, "h": 32}):
        params = dict(dict(w=64, h=64, tta=0), **bad)
        t = np.zeros((params["h"], params["w"], 3), np.float32) \
            if params["w"] <= 1024 else tile
        port, jax_ = both(servers, post_tile(t, **params))
        assert port == jax_ and port[0] == 400, bad


def test_unlimited_tile_tta(servers):
    tile = np.random.default_rng(6).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    tta = assert_same_tile_reply(*both(servers, post_tile(tile, w=64, h=64,
                                                          tta=1)))
    plain = assert_same_tile_reply(*both(servers, post_tile(tile, w=64, h=64,
                                                            tta=0)))
    assert np.isfinite(tta).all() and not np.allclose(tta, plain, atol=1e-6)


@pytest.mark.parametrize("tta", [0, 1])
def test_tile_forward_matches_jax(servers, tta):
    """``tile_forward`` directly, on a non-square tile when plain."""
    rng = np.random.default_rng(7 + tta)
    tile = rng.uniform(0, 1, (64, 64 if tta else 48, 3)).astype(np.float32)
    got = unlimited.tile_forward(servers["port"][1], tile, tta=tta)
    want = np.asarray(junlimited.tile_forward(servers["jax"][1], tile, tta=tta))
    assert got.shape == want.shape == (128 - 28, (128 if tta else 96) - 28, 3)
    assert psnr(np.round(got * 255), np.round(want * 255)) >= PSNR_MIN


def test_unlimited_client_blend_parity(servers):
    """The browser app's pipeline simulated in numpy (grid, replicate pad,
    a /api/tile call per tile, cumulative float32 seam blending, crop)
    against the port's one-call render."""
    url, service = servers["port"]
    from nunif_tpu_torch.utils.tiling import make_blend_filter, make_tile_config
    model = service.renderer.model
    scale, offset, blend = model.i2i_scale, model.i2i_offset, model.i2i_blend_size
    tile_size = 64
    h, w = 40, 56
    x = np.random.default_rng(7).uniform(0, 1, (h, w, 3)).astype(np.float32)
    cfg = make_tile_config(h, w, scale, offset, tile_size, blend)
    left, right, top, bottom = cfg.pad
    padded = np.pad(x, ((top, bottom), (left, right), (0, 0)), mode="edge")
    filt = make_blend_filter(scale, offset, tile_size, blend)[..., None]
    pixels = np.zeros((cfg.y_buffer_h, cfg.y_buffer_w, 3), np.float32)
    weights = np.zeros_like(pixels)
    side = tile_size * scale - 2 * offset
    for ti in range(cfg.h_blocks):
        for tj in range(cfg.w_blocks):
            i0, j0 = ti * cfg.input_tile_step_h, tj * cfg.input_tile_step_w
            tile = padded[i0:i0 + tile_size, j0:j0 + tile_size]
            status, _h, body = fetch(post_tile(tile, w=tile_size, h=tile_size,
                                               tta=0)(url))
            assert status == 200
            out = np.frombuffer(body, np.float32).reshape(side, side, 3)
            y0, x0 = ti * cfg.output_tile_step_h, tj * cfg.output_tile_step_w
            old_w = weights[y0:y0 + side, x0:x0 + side]
            next_w = old_w + filt
            keep = np.where(next_w > 0, old_w / np.maximum(next_w, 1e-12), 0)
            pixels[y0:y0 + side, x0:x0 + side] = (
                pixels[y0:y0 + side, x0:x0 + side] * keep + out * (1 - keep))
            weights[y0:y0 + side, x0:x0 + side] = next_w
    want = service.renderer.render(x, tile_size=tile_size, batch_size=4).numpy()
    np.testing.assert_allclose(pixels[:cfg.y_h, :cfg.y_w], want, atol=2e-3)


def test_hub_convert_matches_jax(servers, tmp_path):
    """The hub on a model directory (the seeded scale2x): PIL and array
    inputs, RGBA kept, against the JAX hub; superresolution / denoise
    choose their methods as hubconf's do."""
    model_dir = str(servers["dir"])
    rng = np.random.default_rng(8)
    rgba = np.concatenate([rng.uniform(0, 1, (20, 28, 3)),
                           np.ones((20, 28, 1))], -1)
    im = Image.fromarray((rgba * 255).astype(np.uint8), "RGBA")
    model = hub.waifu2x(model_dir=model_dir, tile_size=64, device="cpu")
    jmodel = jhub.waifu2x(model_dir=model_dir, tile_size=64)
    got, want = model.convert(im), jmodel.convert(im)
    assert got.mode == want.mode == "RGBA" and got.size == want.size == (56, 40)
    assert psnr(np.asarray(got), np.asarray(want)) >= PSNR_MIN
    arr = model.scale(rgba[..., :3].astype(np.float32))
    assert arr.shape == (40, 56, 3) and arr.dtype == np.float32
    assert hub.superresolution(model_dir=model_dir, device="cpu").method == "scale"
    d = hub.denoise(model_dir=model_dir, device="cpu")
    assert (d.method, d.noise_level) == ("noise", 1)


def test_hub_fallback_diverges_from_jax(monkeypatch, tmp_path, caplog):
    """A model_type with no directory under the model root: both hubs serve
    the bundled turbo models; the JAX hub says nothing, the port warns with
    the type asked for and the checkpoints it serves ("turbo" itself, the
    bundled zoo, needs no warning)."""
    monkeypatch.setenv("NUNIF_TPU_MODEL_DIR", str(tmp_path))
    monkeypatch.setattr(jhub, "DEFAULT_MODEL_ROOT", str(tmp_path))
    caplog.set_level(logging.WARNING)
    jmodel = jhub.waifu2x(model_type="photo")
    assert jmodel.model_dir == default_model_dir()
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
    model = hub.waifu2x(model_type="photo", device="cpu")
    assert model.model_dir == default_model_dir()
    warned = [r.getMessage() for r in caplog.records
              if r.levelno >= logging.WARNING and r.name.startswith("nunif_tpu_torch")]
    assert len(warned) == 1 and "'photo'" in warned[0] and "scale2x" in warned[0]
    caplog.clear()
    assert hub.waifu2x(model_type="turbo", device="cpu").model_dir == \
        default_model_dir()
    assert not caplog.records


def test_web_noise_level_diverges_from_jax(servers, tmp_path):
    """A --model-file named noise1_scale2x.nztm and no --noise-level: the
    JAX server reports noise -1 (its flag's default) and rejects tile
    requests for level 1; the port takes 1 from the file's name.  A given
    flag wins; a name without noise{n} gives -1."""
    model_file = str(tmp_path / "noise1_scale2x.nztm")
    with open(servers["model_file"], "rb") as f, open(model_file, "wb") as g:
        g.write(f.read())
    argv = ["--model-file", model_file, "--cache-dir", str(tmp_path / "c"),
            "--device", "cpu"]
    args = web.create_parser().parse_args(argv)
    assert args.noise_level is None
    service = web.Waifu2xWebService(args)
    assert service.noise_level == 1
    jargs = argparse.Namespace(model_file=model_file, arch=None, tile_size=64,
                               batch_size=4, cache_dir=str(tmp_path / "j"),
                               cache_size_mb=8, noise_level=-1,
                               public_dir=str(tmp_path / "p"))
    assert jweb.Waifu2xWebService(jargs).noise_level == -1
    srv, url = serve(service, web.make_handler)
    try:
        status, _h, body = fetch(url + "/api/tile/info")
        assert json.loads(body)["noise"] == 1
        tile = np.zeros((64, 64, 3), np.float32)
        assert fetch(post_tile(tile, w=64, h=64, tta=0, noise=1)(url))[0] == 200
        assert fetch(post_tile(tile, w=64, h=64, tta=0, noise=-1)(url))[0] == 400
    finally:
        srv.shutdown()
    assert web.Waifu2xWebService(web.create_parser().parse_args(
        argv + ["--noise-level", "3"])).noise_level == 3
    assert [web.noise_level_of(p) for p in (
        "a/noise0.nztm", "noise2_scale4x.pth", "noise3_scale2x.pth.nztm",
        "scale2x.nztm", "noise9.nztm", "my_noise1.nztm")] == [0, 2, 3, -1, -1, -1]


def test_web_cache_key_names_model_diverges_from_jax(servers, tmp_path):
    """Two server runs on one cache directory with different models: the
    JAX server answers the second run's request from the first run's cache
    (its key names the request only); the port renders it anew."""
    from nunif_tpu_torch.utils.pil_io import quantize
    other = tmp_path / "other" / "scale2x.nztm"
    other.parent.mkdir()
    model = UpConv7()  # zero weights: a flat output, unlike the seeded model
    save_model(model, str(other))
    data = png_bytes(24, 16, seed=3)

    def reply(service_cls, model_file, cache, **kw):
        args = argparse.Namespace(
            model_file=str(model_file), arch=None, tile_size=64, batch_size=4,
            cache_dir=str(cache), cache_size_mb=8,
            public_dir=str(tmp_path / "pub"), noise_level=-1, **kw)
        service = service_cls(args)
        out = service.convert(data, "art", -1, 2, "png")
        return service, np.asarray(Image.open(io.BytesIO(out)).convert("RGB"))

    first = reply(jweb.Waifu2xWebService, servers["model_file"], tmp_path / "j")[1]
    stale = reply(jweb.Waifu2xWebService, other, tmp_path / "j")[1]
    np.testing.assert_array_equal(stale, first)  # the JAX fault
    reply(web.Waifu2xWebService, servers["model_file"], tmp_path / "p",
          device="cpu")
    service, fresh = reply(web.Waifu2xWebService, other, tmp_path / "p",
                           device="cpu")
    x = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32) / 255
    np.testing.assert_array_equal(fresh, quantize(service.render(x), 8))
    assert not np.array_equal(fresh, first)


def test_web_cache_dir_default_follows_tmpdir(monkeypatch, tmp_path):
    """Without --cache-dir the result cache lies under the temporary
    directory (TMPDIR), not at a fixed path that every checkout shares."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = web.create_parser().parse_args([])
    assert args.cache_dir == str(tmp_path / "waifu2x_web_cache")


def test_api_noise_mismatch_diverges_from_jax(servers):
    """A request for noise 3 (or scale 4) to a server whose model is the
    scale2x one: the JAX server answers 200 with the scale2x render; the
    port answers 400, as its tile API does, and renders nothing.  A request
    that names the model's own conversion, or none, still renders."""
    data = png_bytes(16, 16, seed=11)
    for bad in (dict(noise="3", scale="2"), dict(noise="-1", scale="4"),
                dict(scale="1")):
        port, jax_ = both(servers, post_image(data, **bad))
        assert jax_[0] == 200, bad
        assert port[0] == 400 and b"see /api/tile/info" in port[2], bad
    for ok in (dict(noise="-1", scale="2"), {}):
        assert_same_image_reply(*both(servers, post_image(data, **ok)))


def _barrier_os(barrier):
    """An ``os`` whose ``replace`` first waits for the other writer, so two
    puts of one key reach their replace together."""
    def replace(src, dst):
        barrier.wait(timeout=30)
        return os.replace(src, dst)
    proxy = types.SimpleNamespace(**{k: getattr(os, k) for k in dir(os)
                                     if not k.startswith("__")})
    proxy.replace = replace
    return proxy


def test_disk_cache_concurrent_put_diverges_from_jax(monkeypatch, tmp_path):
    """Two threads put one key and reach the rename together: in the JAX
    cache both wrote the one ``<key>.tmp`` and the second rename raises
    FileNotFoundError; in the port each has its own temporary file and
    both succeed.  Then eight threads put one key 25 times each with
    payloads of other lengths: no call raises, the entry reads back whole
    (one payload, not a mix) and no temporary file is left."""
    errors = {}
    for pkg, mod in (("jax", jweb), ("port", web)):
        cache = mod.DiskCache(str(tmp_path / pkg))
        monkeypatch.setattr(mod, "os", _barrier_os(threading.Barrier(2)))
        errors[pkg] = []

        def put(i, cache=cache, errs=errors[pkg]):
            try:
                cache.put("k", bytes([i]) * 100_000)
            except OSError as e:
                errs.append(type(e).__name__)
        threads = [threading.Thread(target=put, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        monkeypatch.setattr(mod, "os", os)
    assert errors == {"jax": ["FileNotFoundError"], "port": []}

    cache = web.DiskCache(str(tmp_path / "stress"))
    payloads = [bytes([i]) * (50_000 + 997 * i) for i in range(8)]
    failed = []

    def hammer(i):
        for _ in range(25):
            try:
                cache.put("one key", payloads[i])
            except Exception as e:  # noqa: BLE001
                failed.append(repr(e))
    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not failed
    assert cache.get("one key") in payloads
    assert os.listdir(tmp_path / "stress") == [os.path.basename(cache._path("one key"))]
