"""The whole iw3 frame path of nunif_tpu_torch for ``row_flow_v2``,
``row_flow_v3_sym``, ``forward`` and ``forward_fill`` against the JAX
package's ``Iw3FrameProcessor`` on the CPU, and the image CLI with the new
methods (the MLBW methods' frame paths: tests/test_torch_iw3_mlbw_frames.py;
the parts: tests/test_torch_iw3_methods.py; the inpaint methods:
tests/test_torch_inpaint*.py).

uint8 frames -> Any_V2_S depth -> the method -> half-SBS, both packages on
the same seeded weights, fp32 (both packages' hard-coded bf16 image casts
resolved to fp32); every comparison first checks that >= 10% of the left
eye's pixels moved.
"""
import numpy as np
import pytest
import torch

from nunif_tpu.iw3.composition import StereoFormat as JFormat
from nunif_tpu.iw3.pipeline import StereoConfig as JConfig
from nunif_tpu.iw3.video import Iw3FrameProcessor as JProcessor
from nunif_tpu.models import create_model as j_create_model
import nunif_tpu.iw3.models  # noqa: F401  (registers the JAX iw3 nets)

from nunif_tpu_torch.iw3.composition import StereoFormat
from nunif_tpu_torch.iw3.depth import create_depth_model
from nunif_tpu_torch.iw3.depth.depth_anything import (
    DepthAnything, shaped_flax_params as depth_params)
from nunif_tpu_torch.iw3.models import row_flow_v3 as trf3
from nunif_tpu_torch.iw3.pipeline import (StereoConfig, apply_divergence,
                                          process_image, resize_depth_for)
from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
from nunif_tpu_torch.models import create_model, from_flax, save_model

import torch_iw3_helpers as h

METHOD_NETS = {"mlbw_l2": "sbs.mlbw_l2", "mlbw_l4": "sbs.mlbw_l4",
               "mlbw_l2s": "sbs.mlbw_l2s", "mlbw_l4s": "sbs.mlbw_l4s",
               "row_flow_v2": "sbs.row_flow_v2",
               "row_flow_v3_sym": "sbs.row_flow_v3",
               "forward": None, "forward_fill": None}
# the MLBW methods' frame paths: tests/test_torch_iw3_mlbw_frames.py
METHODS_HERE = ["row_flow_v2", "row_flow_v3_sym", "forward", "forward_fill"]


@pytest.fixture
def fp32(monkeypatch):
    h.patch_fp32(monkeypatch)


@pytest.fixture(scope="module")
def depth_weights():
    return depth_params(DepthAnything("vits"), 0)


@pytest.fixture(scope="module")
def frames():
    return h.frames()


def _side(name):
    """(port net, flax-layout weights) of a method's stereo net."""
    if name == "sbs.row_flow_v3":
        net = trf3.RowFlowV3()
        params = trf3.shaped_flax_params(net, 1)
        from_flax(net, params)
        return net.eval(), params
    return h.shaped(name)


@pytest.mark.parametrize("method", METHODS_HERE)
def test_frame_path_matches_jax(method, depth_weights, frames, fp32):
    """Iw3FrameProcessor and process_image on the same frames against the
    JAX Iw3FrameProcessor: uint8 PSNR >= 50 dB."""
    check_frame_path(method, depth_weights, frames)


def check_frame_path(method, depth_weights, frames):
    """The check of ``test_frame_path_matches_jax``, under the fp32 patch."""
    dm, jdm = h.depth_models(depth_weights)
    name = METHOD_NETS[method]
    side = jside = jparams = None
    if name:
        side, params = _side(name)
        jside, jparams = j_create_model(name), h.jparams(params)
    cfg = StereoConfig(method=method, format=StereoFormat(half_sbs=True))
    jcfg = JConfig(method=method, format=JFormat(half_sbs=True))
    x = h.t(frames).float() * (1.0 / 255.0)
    depth = torch.stack(dm.minmax_normalize(dm.infer(x, edge_dilation=2)))
    left, _right = apply_divergence(resize_depth_for(depth, x, cfg), x, cfg, side)
    moved = float(((left - x).abs() > 0.5 / 255).float().mean())
    assert moved >= 0.10, moved
    want = np.asarray(JProcessor(jcfg, jdm, jside, jparams,
                                 edge_dilation=2)(frames))
    got = Iw3FrameProcessor(cfg, dm, side, edge_dilation=2)(frames).numpy()
    assert got.shape == want.shape == (2, 64, 90, 3)
    assert h.psnr(h.u8(got), h.u8(want)) >= 50.0, h.psnr(h.u8(got), h.u8(want))
    got_pi = process_image(x, cfg, dm, side, edge_dilation=2).numpy()
    assert h.psnr(h.u8(got_pi), h.u8(want)) >= 50.0


@pytest.mark.parametrize("method", ["mlbw_l2", "forward_fill"])
def test_cli_methods_on_cpu(tmp_path, depth_weights, frames, method):
    """The image CLI from checkpoints written by the port, against the
    library call on the same models (the CLI runs bf16)."""
    from PIL import Image
    from nunif_tpu_torch.iw3 import cli
    depth = DepthAnything("vits")
    from_flax(depth, depth_weights)
    save_model(depth, str(tmp_path / "depth.nztm"))
    argv = ["--method", method, "--half-sbs", "--device", "cpu",
            "--resolution", str(h.RESOLUTION),
            "--depth-checkpoint", str(tmp_path / "depth.nztm")]
    side = None
    if method == "mlbw_l2":
        side, _ = h.shaped("sbs.mlbw_l2")
        save_model(side, str(tmp_path / "mlbw.nztm"))
        argv += ["--stereo-checkpoint", str(tmp_path / "mlbw.nztm")]
    src, dst = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    Image.fromarray(frames[0]).save(src)
    assert cli.main(["-i", src, "-o", dst] + argv) == 0
    with Image.open(dst) as im:
        out = np.asarray(im)
    assert out.shape == (64, 90, 3)
    dm = create_depth_model("Any_V2_S", device="cpu")
    from_flax(dm.load(resolution=h.RESOLUTION).model, depth_weights)
    want = process_image(h.t(frames[0]).float() / 255,
                         StereoConfig(method=method,
                                      format=StereoFormat(half_sbs=True)),
                         dm, side, edge_dilation=2)
    assert np.abs(out.astype(int) - h.u8(want.float().numpy()).astype(int)).max() <= 1


def test_cli_seeded_models_and_unported_method(frames):
    """Without a checkpoint each method builds its nets from flax's init
    (seeded); the new flags reach the config; mlbw_l2_inpaint_video builds
    its clip model (tests/test_torch_inpaint_video.py) and, like every
    inpaint method, needs it."""
    from nunif_tpu_torch.iw3 import cli
    for method in ("row_flow_v2", "row_flow_v3_sym", "mlbw_l4s"):
        model = cli.create_stereo_model(method, device="cpu", seed=3)
        want = create_model(cli.STEREO_MODELS[method])
        assert type(model) is type(want)
        assert getattr(model, "small", False) == getattr(want, "small", False)
        assert not any(p.requires_grad for p in model.parameters())
    for method in ("forward", "forward_fill", "grid_sample", "NULL"):
        assert cli.create_stereo_model(method, device="cpu") is None
    from nunif_tpu_torch.iw3.mlbw_inpaint import MLBWInpaintVideo
    from nunif_tpu_torch.iw3.models.light_video_inpaint_v1 import LightVideoInpaintV1
    video = cli.create_stereo_model("mlbw_l2_inpaint_video", device="cpu")
    assert type(video) is MLBWInpaintVideo
    assert type(video.inpaint_model) is LightVideoInpaintV1
    args = cli.create_parser().parse_args(
        ["-i", "a", "-o", "b", "--preserve-screen-border",
         "--mask-inner-dilation", "2", "--mask-outer-dilation", "3",
         "--inpaint-max-width", "640"])
    cfg = cli.build_config(args)
    assert (cfg.preserve_screen_border, cfg.mask_inner_dilation,
            cfg.mask_outer_dilation, cfg.inpaint_max_width) == (True, 2, 3, 640)
    x = h.t(frames[:1]).float() / 255
    with pytest.raises(ValueError, match="inpaint model"):
        apply_divergence(x[..., :1], x, StereoConfig(method="mlbw_l2_inpaint_video"))
