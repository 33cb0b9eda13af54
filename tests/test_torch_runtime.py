"""nunif_tpu_torch runtime, CLI and renderer repairs, on the CPU.

Each repair is a behaviour the port has and the JAX package does not:
- a tile geometry that does not align with the model's pre-shuffle factor
  falls back to shuffling inside the model (nunif_tpu/utils/tiling.py sets
  the pre-shuffle apply outside its alignment check);
- a missing runtime slot names the file and lists the checkpoints present;
- a checkpoint of an architecture the port lacks fails with "not ported".
The bundled turbo checkpoints load (tests/test_torch_waifu2x_image.py holds
them and the rest of the image path against the JAX package).
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import math

import numpy as np
import pytest
import torch
from torch import nn

from nunif_tpu_torch.core import device as tdevice
from nunif_tpu_torch.core.dtypes import FP32_POLICY
from nunif_tpu_torch.models import (I2IBaseModel, NotPortedError, from_flax,
                                    init_flax_default, save_model)
from nunif_tpu_torch.modules.permute import pixel_shuffle
from nunif_tpu_torch.utils import pil_io, tiling
from nunif_tpu_torch.waifu2x import cli
from nunif_tpu_torch.waifu2x.models.swin_unet import (SwinUNet2x,
                                                      tamed_flax_params)
from nunif_tpu_torch.waifu2x.runtime import Waifu2x, default_model_dir


def pixel_unshuffle(x, r):
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // r, w // r, c * r * r)


class NearestPS4(I2IBaseModel):
    """Toy 2x model (nearest upscale) whose head layout is coarser than its
    scale: pre-shuffle output is (H*2/4, W*2/4, C*16), like turbo_2x."""
    model_name = "test.nearest_ps4"
    i2i_scale = 2
    i2i_offset = 4
    i2i_blend_size = 4
    i2i_ps_factor = 4

    def __init__(self, pre_shuffle_output=False):
        super().__init__()
        self.pre_shuffle_output = pre_shuffle_output
        self.out_channels = 3
        self.gain = nn.Parameter(torch.ones(()))

    def forward(self, x, pre_shuffle=None):
        y = x.repeat_interleave(2, 1).repeat_interleave(2, 2) * self.gain
        o = self.i2i_offset
        y = y[:, o:y.shape[1] - o, o:y.shape[2] - o]
        return pixel_unshuffle(y, 4) if pre_shuffle else y


@pytest.mark.parametrize("tile,ps", [(31, 1), (32, 4)])
def test_misaligned_preshuffle_falls_back(tile, ps):
    model = NearestPS4()
    renderer = tiling.TiledRenderer(model, policy=FP32_POLICY)
    cfg = tiling.make_tile_config(30, 70, 2, 4, tile, 4)
    assert cfg.n_tiles > 1
    assert renderer._ps_factor(cfg, (tile, tile)) == ps
    frame = np.random.default_rng(0).integers(0, 256, (30, 70, 3),
                                              dtype=np.uint8)
    got = renderer.frame_program(30, 70, tile_size=tile, batch_size=3)(frame)
    want = torch.from_numpy(frame).repeat_interleave(2, 0).repeat_interleave(2, 1)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("w2x")
    model = SwinUNet2x(base_dim=32)
    from_flax(model, tamed_flax_params(model, seed=3))
    save_model(model, str(d / "scale2x.nztm"))
    return d


def test_convert_and_render(model_dir):
    w2x = Waifu2x(str(model_dir), policy=FP32_POLICY, device="cpu")
    x = np.random.default_rng(1).random((30, 40, 3), dtype=np.float32)
    rgb, alpha = w2x.convert(x, method="scale", tile_size=64)
    assert rgb.shape == (60, 80, 3) and alpha is None
    assert float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0
    torch.testing.assert_close(rgb, w2x.render(x, "scale", tile_size=64))
    rgb2, alpha2 = w2x.convert(x, np.ones((30, 40, 1), np.float32),
                               method="scale", tile_size=64)
    torch.testing.assert_close(rgb2, rgb)
    assert alpha2.shape == (60, 80, 1) and bool((alpha2 == 1).all())


def test_convert_unported_options_raise(model_dir):
    """Bad options raise; TTA and a non-blank alpha, which raised before
    they were ported, now run (under FP32_POLICY: the test is about the
    options, and bf16 convs are slow on the CPU)."""
    w2x = Waifu2x(str(model_dir), policy=FP32_POLICY, device="cpu")
    x = np.zeros((20, 20, 3), np.float32)
    rgb, alpha = w2x.convert(x, method="scale", tta=True, tile_size=64)
    assert rgb.shape == (40, 40, 3) and alpha is None
    rgb, alpha = w2x.convert(x, np.full((20, 20, 1), 0.5, np.float32),
                             method="scale", tile_size=64)
    assert rgb.shape == (40, 40, 3) and alpha.shape == (40, 40, 1)
    with pytest.raises(ValueError, match="noise_level"):
        w2x.convert(x, method="noise_scale", noise_level=None)
    with pytest.raises(ValueError, match="method"):
        w2x.convert(x, method="resize")


def test_missing_slot_names_file_and_lists_present(model_dir):
    w2x = Waifu2x(str(model_dir), device="cpu")
    with pytest.raises(FileNotFoundError) as e:
        w2x.load_model("noise_scale", 2)
    msg = str(e.value)
    assert "noise2_scale2x.nztm" in msg and "['scale2x']" in msg


def test_bundled_turbo_dir_is_not_ported_yet(tmp_path):
    """The bundled turbo_2x zoo is ported now: its scale2x converts; a
    model dir whose checkpoint names an architecture the port lacks (a
    name no package registers) still raises ``NotPortedError``."""
    assert default_model_dir() is not None
    w2x = Waifu2x(default_model_dir(), device="cpu")
    rgb, _ = w2x.convert(np.zeros((8, 8, 3), np.float32), method="scale",
                         tile_size=64)
    assert rgb.shape == (16, 16, 3)
    import json
    import zipfile
    with zipfile.ZipFile(tmp_path / "scale2x.nztm", "w") as zf:
        zf.writestr("__meta__.json", json.dumps(
            {"nunif_tpu_model": 1, "name": "iw3.no_such_net",
             "kwargs": {}}))
    with pytest.raises(NotPortedError, match="no_such_net.*not ported"):
        Waifu2x(str(tmp_path), device="cpu").convert(
            np.zeros((8, 8, 3), np.float32), method="scale")


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Waifu2x("", device="cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_init_flax_default_distributions():
    layer = nn.Linear(256, 512)
    init_flax_default(layer, torch.Generator().manual_seed(0))
    w = layer.weight.detach()
    assert bool((layer.bias == 0).all())
    assert abs(float(w.std()) - math.sqrt(1 / 256)) < 0.05 * math.sqrt(1 / 256)
    limit = 2 * math.sqrt(1 / 256) / 0.87962566103423978
    assert float(w.abs().max()) <= limit + 1e-6
    again = nn.Linear(256, 512)
    init_flax_default(again, torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, layer.weight)
    model = SwinUNet2x(base_dim=32)
    init_flax_default(model, torch.Generator().manual_seed(1))
    table = model.unet.swin1.block0.attn.relative_position_bias_table.detach()
    assert 0 < float(table.abs().max()) <= 0.04


def _write_png(path, shape):
    from PIL import Image
    arr = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    Image.fromarray(arr).save(path)
    return arr


def test_cli_model_dir(model_dir, tmp_path):
    from PIL import Image
    src = tmp_path / "in.png"
    _write_png(src, (24, 30, 3))
    out = tmp_path / "out" / "x.png"
    rc = cli.main(["-i", str(src), "-o", str(out), "--method", "scale",
                   "--model-dir", str(model_dir), "--tile-size", "64",
                   "--batch-size", "2", "--device", "cpu"])
    assert rc == 0
    with Image.open(out) as im:
        assert im.size == (60, 48) and im.mode == "RGB"


def test_cli_arch_random_weights(tmp_path, caplog):
    from PIL import Image
    src = tmp_path / "in.png"
    _write_png(src, (20, 24, 3))
    out_dir = tmp_path / "out"
    rc = cli.main(["-i", str(src), "-o", str(out_dir), "--method", "scale",
                   "--arch", "waifu2x.swin_unet_2x", "--tile-size", "64x64",
                   "--format", "webp", "--device", "cpu"])
    assert rc == 0
    assert "RANDOM weights" in caplog.text
    with Image.open(out_dir / "in.webp") as im:
        assert im.size == (48, 40)


def test_cli_rejects_video_and_missing_cuda(monkeypatch):
    # a video input reaches the decoder (tests/test_torch_video_cli.py),
    # which rejects a missing file
    with pytest.raises(IOError, match="vio_reader_open"):
        cli.main(["-i", "clip.mp4", "-o", "out.mp4", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-i", "in.png", "-o", "out.png", "--method", "scale",
                  "--arch", "waifu2x.swin_unet_2x"])
    assert cli._tile_size_arg("592x1936") == (592, 1936)
    assert cli._tile_size_arg("256") == 256


def test_pil_io_round_trip(tmp_path):
    x = np.random.default_rng(4).random((9, 11, 3)).astype(np.float32)
    pil_io.save_image(x, str(tmp_path / "a.png"))
    y, meta = pil_io.load_image(str(tmp_path / "a.png"))
    assert y.shape == (9, 11, 3) and meta.mode == "RGB"
    np.testing.assert_allclose(y, np.round(x * 255) / 255, atol=1e-6)
    rgba = np.concatenate([x, np.full((9, 11, 1), 0.5, np.float32)], -1)
    pil_io.save_image(rgba, str(tmp_path / "b.png"))
    z, _ = pil_io.load_image(str(tmp_path / "b.png"))
    assert z.shape == (9, 11, 4)


def test_pixel_unshuffle_helper_inverts_port_shuffle():
    x = torch.arange(2 * 8 * 12 * 3, dtype=torch.float32).reshape(2, 8, 12, 3)
    assert torch.equal(pixel_shuffle(pixel_unshuffle(x, 4), 4), x)


def test_benchmark_matches_jax(model_dir, tmp_path):
    """The quality benchmark: the JAX package's resize, PSNR, noise table
    and image listing, and a run over two images with a checkpoint, the
    baselines and JPEG noise whose baseline scores equal the JAX
    package's."""
    import csv
    from nunif_tpu.waifu2x import benchmark as jbench
    from nunif_tpu.waifu2x.training import dataset as jdataset, degrade
    from nunif_tpu_torch.waifu2x import benchmark as bench
    rng = np.random.default_rng(6)
    a, b = rng.random((2, 23, 31, 3)).astype(np.float32)
    np.testing.assert_array_equal(bench._np_resize(a, 11, 15),
                                  jbench._np_resize(a, 11, 15))
    assert bench.psnr(a, b) == jbench.psnr(a, b)
    assert bench.y_psnr(a, b) == jbench.y_psnr(a, b)
    assert bench.EVAL_QUALITY == degrade.EVAL_QUALITY
    d = tmp_path / "eval"
    (d / "sub").mkdir(parents=True)
    _write_png(d / "a.png", (40, 52, 3))
    _write_png(d / "sub" / "b.png", (36, 30, 3))
    (d / "notes.txt").write_text("not an image")
    assert bench.listdir_images(str(d)) == jdataset.listdir_images(str(d))
    out = tmp_path / "scores.csv"
    rc = bench.main(["-i", str(d), "--model-file", str(model_dir / "scale2x.nztm"),
                     "--baseline", "--noise-level", "1", "--tile-size", "64",
                     "--device", "cpu", "-o", str(out)])
    assert rc == 0
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert [r["file"] for r in rows] == ["a.png", "b.png"]
    for row, path in zip(rows, bench.listdir_images(str(d))):
        assert 10.0 < float(row["psnr"]) < 60.0
        hr = pil_io.load_image(path)[0][..., :3]
        h, w = hr.shape[0] // 2 * 2, hr.shape[1] // 2 * 2
        hr = hr[:h, :w]
        from PIL import Image
        im = Image.fromarray((jbench._np_resize(hr, h // 2, w // 2) * 255
                              + 0.5).astype(np.uint8))
        lr = np.asarray(degrade.add_jpeg_noise(im, 75, "4:2:0"),
                        np.float32) / 255.0
        up = jbench._np_resize(lr, h, w, mode="catrom", antialias=False)
        assert float(row["catrom_psnr"]) == round(jbench.psnr(up, hr), 4)
    assert bench.main(["-i", str(tmp_path / "empty_dir"), "--device", "cpu"]) == 1


def test_cli_scale4x_model_dir_and_arch(tmp_path):
    """--method scale4x loads DIR/scale4x.nztm (here a 4x LayerNorm model);
    --arch waifu2x.swin_unet_4xl builds the 4xl from the registry."""
    from PIL import Image
    from nunif_tpu_torch.waifu2x.models.swin_unet import SwinUNet4x
    model = SwinUNet4x(base_dim=32, layer_norm=True)
    from_flax(model, tamed_flax_params(model, seed=2))
    save_model(model, str(tmp_path / "scale4x.nztm"))
    src = tmp_path / "in.png"
    _write_png(src, (20, 24, 3))
    for extra in (["--model-dir", str(tmp_path)],
                  ["--arch", "waifu2x.swin_unet_4xl"]):
        out = tmp_path / "out.png"
        rc = cli.main(["-i", str(src), "-o", str(out), "--method", "scale4x",
                       "--tile-size", "64", "--device", "cpu", *extra])
        assert rc == 0
        with Image.open(out) as im:
            assert im.size == (96, 80)
