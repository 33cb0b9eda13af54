"""iw3's inpaint methods (``forward_inpaint``, ``mlbw_l2_inpaint``) in
nunif_tpu_torch through the whole frame path, against the JAX package's
``Iw3FrameProcessor`` on the CPU, and the CLI (the parts:
tests/test_torch_inpaint.py, whose header explains the hole mask's
deliberate divergence and the fixtures shared here).
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import torch

from nunif_tpu.iw3.composition import StereoFormat as JFormat
from nunif_tpu.iw3.forward_inpaint import ForwardInpaint as JForwardInpaint
import nunif_tpu.iw3.mlbw_inpaint as j_mlbw_inpaint
from nunif_tpu.iw3.pipeline import StereoConfig as JConfig
from nunif_tpu.iw3.video import Iw3FrameProcessor as JProcessor

from nunif_tpu_torch.iw3.composition import StereoFormat
from nunif_tpu_torch.iw3.depth.depth_anything import (
    DepthAnything, shaped_flax_params as depth_params)
from nunif_tpu_torch.iw3.forward_inpaint import ForwardInpaint
from nunif_tpu_torch.iw3.mlbw_inpaint import MLBWInpaint
from nunif_tpu_torch.iw3.pipeline import StereoConfig, process_image
from nunif_tpu_torch.iw3.video import Iw3FrameProcessor
from nunif_tpu_torch.models import save_model

import pytest
import torch_iw3_helpers as h
from test_torch_inpaint import inpaint_net, mask_net, port_order  # noqa: F401  (fixtures)


@pytest.mark.parametrize("method", ["forward_inpaint", "mlbw_l2_inpaint"])
def test_inpaint_frame_path_matches_jax(inpaint_net, mask_net, port_order,
                                        monkeypatch, method):
    """Iw3FrameProcessor and process_image with each inpaint method, fp32,
    with the dilations and (forward_inpaint) ``inpaint_max_width``,
    against the JAX Iw3FrameProcessor: uint8 PSNR >= 50 dB."""
    h.patch_fp32(monkeypatch)
    net, jnet, jp = inpaint_net
    dm, jdm = h.depth_models(depth_params(DepthAnything("vits"), 0))
    if method == "forward_inpaint":
        side, jside = ForwardInpaint(net), JForwardInpaint(jnet, jp)
        extra = dict(inpaint_max_width=80)
    else:
        mnet, jmnet, jmp = mask_net
        side = MLBWInpaint(net, mnet)
        jside = j_mlbw_inpaint.MLBWInpaint(inpaint_model=jnet, inpaint_params=jp,
                                           mask_model=jmnet, mask_params=jmp)
        extra = {}
    kw = dict(method=method, mask_inner_dilation=1, mask_outer_dilation=2,
              **extra)
    frames = h.frames()
    cfg = StereoConfig(format=StereoFormat(half_sbs=True), **kw)
    jcfg = JConfig(format=JFormat(half_sbs=True), **kw)
    want = np.asarray(JProcessor(jcfg, jdm, jside, edge_dilation=2)(frames))
    got = Iw3FrameProcessor(cfg, dm, side, edge_dilation=2)(frames).numpy()
    assert got.shape == want.shape
    assert h.psnr(h.u8(got), h.u8(want)) >= 50.0, h.psnr(h.u8(got), h.u8(want))
    x = h.t(frames).float() * (1.0 / 255.0)
    got_pi = process_image(x, cfg, dm, side, edge_dilation=2).numpy()
    assert h.psnr(h.u8(got_pi), h.u8(want)) >= 50.0


def test_cli_mlbw_l2_inpaint_on_cpu(tmp_path, inpaint_net):
    """The CLI with ``--method mlbw_l2_inpaint`` from an inpaint checkpoint
    written by ``save_model`` (the mask-MLBW seeded, as in the JAX CLI)."""
    from PIL import Image
    from nunif_tpu_torch.iw3 import cli
    net = inpaint_net[0]
    save_model(net, str(tmp_path / "inpaint.nztm"))
    side = cli.create_stereo_model("mlbw_l2_inpaint",
                                   str(tmp_path / "inpaint.nztm"), device="cpu")
    assert isinstance(side, MLBWInpaint) and side.mask_model.hole_mask
    assert all(torch.equal(a, b) for a, b in zip(side.inpaint_model.parameters(),
                                                 net.parameters()))
    src, dst = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    Image.fromarray(h.frames()[0]).save(src)
    assert cli.main(["-i", src, "-o", dst, "--method", "mlbw_l2_inpaint",
                     "--half-sbs", "--device", "cpu", "--resolution",
                     str(h.RESOLUTION), "--mask-outer-dilation", "2",
                     "--stereo-checkpoint", str(tmp_path / "inpaint.nztm")]) == 0
    with Image.open(dst) as im:
        assert np.asarray(im).shape == (64, 90, 3)
    fi = cli.create_stereo_model("forward_inpaint", device="cpu", seed=1)
    assert isinstance(fi, ForwardInpaint)
