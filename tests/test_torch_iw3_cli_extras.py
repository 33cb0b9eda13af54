"""The port's iw3 CLI against the JAX package's, on the CPU: every flag of
the JAX parser (and the reference's coverage table), ``--export`` and the
``.yml`` re-import, the new output formats with ``--depth-aa``, and two
places where the port does what the JAX CLI means to: the export's edge
dilation, and ``--debug-depth`` / ``--convergence-mode`` on images.

Both CLIs read the same ``.nztm`` checkpoints written by the port (seeded
Any_V2_S at a 56-pixel depth input, row_flow_v3, DepthAA, SODV1); raw
reference ``.pth`` files of DepthAA / SODV1 convert as JAX's converters
do.  The
comparisons against JAX run both in fp32 (the port's depth model built
fp32, ``patch_fp32``): uint8 >= 50 dB.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import os

import numpy as np
import pytest
import torch

import jax

from nunif_tpu.core import compile_cache as j_compile_cache
from nunif_tpu.iw3 import cli as jcli
from nunif_tpu.iw3 import cli_compat as j_compat
from nunif_tpu.models import torch_convert as jtc

from nunif_tpu_torch.iw3 import cli, cli_compat
from nunif_tpu_torch.iw3 import depth as tdepth
from nunif_tpu_torch.iw3.depth.depth_anything import DepthAnything
from nunif_tpu_torch.iw3.depth.depth_anything import shaped_flax_params as depth_params
from nunif_tpu_torch.iw3.models.depth_aa import DepthAA, shaped_flax_params as aa_params
from nunif_tpu_torch.iw3.models.row_flow_v3 import RowFlowV3
from nunif_tpu_torch.iw3.models.row_flow_v3 import shaped_flax_params as flow_params
from nunif_tpu_torch.iw3.models.sod_v1 import SODV1, shaped_flax_params as sod_params
from nunif_tpu_torch.models import from_flax, save_model, to_flax

import torch_iw3_helpers as h

pytestmark = pytest.mark.usefixtures("two_threads")
two_threads = h.two_threads


def _flags(parser):
    """{flag name without "--": default}."""
    return {s[2:]: a.default for a in parser._actions for s in a.option_strings
            if s.startswith("--")}


def test_flags_match_jax_parser():
    """Every flag of the JAX parser is in the port's with the same default
    (or in ``JAX_FLAGS_NOT_IN_PORT`` with a reason); the port's other
    flags are in ``PORT_ONLY_FLAGS``; every reference flag is covered."""
    ours, theirs = _flags(cli.create_parser()), _flags(jcli.create_parser())
    missing = [f for f in theirs if f not in ours
               and f not in cli_compat.JAX_FLAGS_NOT_IN_PORT]
    assert not missing, missing
    defaults = {f: (ours[f], theirs[f]) for f in theirs
                if f in ours and ours[f] != theirs[f]}
    assert not defaults, defaults
    assert set(ours) - set(theirs) == set(cli_compat.PORT_ONLY_FLAGS)
    assert cli_compat.REFERENCE_IW3_FLAGS == j_compat.REFERENCE_IW3_FLAGS
    unhandled = [f for f in cli_compat.REFERENCE_IW3_FLAGS if f not in ours
                 and f not in cli_compat.NOT_APPLICABLE
                 and cli_compat.RENAMED.get(f) not in ours]
    assert not unhandled, unhandled
    assert all(cli_compat.RENAMED[f] in ours for f in cli_compat.RENAMED)


def test_parser_parses_as_jax():
    """The same argument list (video flags among them) gives the same
    namespace in both parsers, but for the port's own flags."""
    argv = ["-i", "in.mp4", "-o", "out.mp4", "--video-bitrate", "8M",
            "--tune", "film", "grain", "--keyframe-interval", "4", "--metadata",
            "--yes", "--stereo-width", "960", "--ema-normalize", "--ema-buffer",
            "12", "--scene-detect", "--autocrop", "--autocrop-mode", "flat_tb",
            "-vf", "mkv", "--batch-size", "8", "--anaglyph", "wimmer2",
            "--pad", "0.1", "--pad-mode", "16:9", "--convergence-mode", "sod_v1",
            "--depth-aa", "--export-disparity", "--devices", "2"]
    ours = vars(cli.create_parser().parse_args(argv))
    theirs = vars(jcli.create_parser().parse_args(argv))
    for flag in cli_compat.PORT_ONLY_FLAGS:
        del ours[flag]
    assert ours == theirs


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The nets as .nztm files, and a 64 x 96 PNG."""
    from PIL import Image
    d = tmp_path_factory.mktemp("ckpt")
    frame = h.frames()[0]
    nets = {"depth": (DepthAnything("vits"), depth_params(DepthAnything("vits"), 0)),
            "flow": (RowFlowV3(), flow_params(RowFlowV3(), 1)),
            "aa": (DepthAA(), aa_params(DepthAA(), 3))}
    for name, (net, flat) in nets.items():
        from_flax(net, flat)
        save_model(net, str(d / f"{name}.nztm"))
    x = torch.from_numpy(frame).float() / 255
    ramp = torch.linspace(0, 1, 64).reshape(64, 1, 1).expand(64, 90, 1)
    sod = SODV1().eval()
    sod_params(sod, 2, calibration=torch.cat([x, ramp], -1)[None])
    save_model(sod, str(d / "sod.nztm"))
    Image.fromarray(frame).save(str(d / "in.png"))
    return d


def _common(ckpt):
    return ["--resolution", str(h.RESOLUTION), "--depth-checkpoint",
            str(ckpt / "depth.nztm"), "--stereo-checkpoint", str(ckpt / "flow.nztm")]


@pytest.fixture
def fp32(monkeypatch):
    """Both CLIs in fp32: the port's depth model built fp32, the bf16
    image casts of both resolved to fp32; the JAX CLI's persistent compile
    cache off."""
    h.patch_fp32(monkeypatch)
    create = tdepth.create_depth_model
    monkeypatch.setattr(tdepth, "create_depth_model",
                        lambda name, **kw: create(name, dtype=torch.float32, **kw))
    monkeypatch.setattr(j_compile_cache, "enable_persistent_cache",
                        lambda *a, **k: None)


def _read(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im)


def _run(main, argv):
    assert main(argv) == 0


def test_export_import_round_trip_matches_jax(tmp_path, ckpt, fp32):
    """``--export`` (with ``--edge-dilation 2`` given, where both CLIs
    agree) then the ``.yml`` re-import, in each package: the exported depth
    within 2 / 65535, the YAML equal but for its time stamp, the rendered
    frames >= 50 dB."""
    src = str(ckpt / "in.png")
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        exp, imp = tmp_path / f"{name}_export", tmp_path / f"{name}_import"
        _run(main, ["-i", src, "-o", str(exp), "--export", "--edge-dilation", "2"]
             + _common(ckpt) + extra)
        _run(main, ["-i", str(exp / "iw3_export.yml"), "-o", str(imp), "--half-sbs"]
             + _common(ckpt) + extra)
        outs[name] = exp, _read(imp / "in.png")
    (pexp, got), (jexp, want) = outs["port"], outs["jax"]
    dp, dj = (_read(e / "depth" / "in.png").astype(np.int64) for e in (pexp, jexp))
    assert dp.shape == dj.shape and np.abs(dp - dj).max() <= 2
    np.testing.assert_array_equal(_read(pexp / "rgb" / "in.png"),
                                  _read(jexp / "rgb" / "in.png"))
    ymls = [[line for line in (e / "iw3_export.yml").read_text().splitlines()
             if not line.startswith("updated_at")] for e in (pexp, jexp)]
    assert ymls[0] == ymls[1]
    assert got.shape == want.shape == (64, 90, 3)
    assert h.psnr(got, want) >= 50.0


def test_export_edge_dilation_diverges_from_jax(tmp_path, ckpt, fp32):
    """A reference fault the port does not copy: without
    ``--edge-dilation`` the JAX CLI renders with 2 but exports with 0, so
    export then import does not reproduce its direct render (< 50 dB).
    The port exports with the render's 2: >= 50 dB (the 16-bit depth PNG
    is the only rounding)."""
    src = str(ckpt / "in.png")
    psnrs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        direct = tmp_path / f"{name}_direct.png"
        exp, imp = tmp_path / f"{name}_export", tmp_path / f"{name}_import"
        _run(main, ["-i", src, "-o", str(direct), "--half-sbs"] + _common(ckpt) + extra)
        _run(main, ["-i", src, "-o", str(exp), "--export"] + _common(ckpt) + extra)
        _run(main, ["-i", str(exp / "iw3_export.yml"), "-o", str(imp), "--half-sbs"]
             + _common(ckpt) + extra)
        psnrs[name] = h.psnr(_read(imp / "in.png"), _read(direct))
    assert psnrs["port"] >= 50.0, psnrs
    assert psnrs["jax"] < 50.0, psnrs


FORMAT_RUNS = {
    "anaglyph_depth_aa": (["--anaglyph", "dubois", "--depth-aa"], (64, 90, 3)),
    "vr180": (["--vr180"], (134, 268, 3)),
    "half_rgbd": (["--half-rgbd", "--ipd-offset", "4"], (64, 90, 3)),
}


@pytest.mark.parametrize("name", sorted(FORMAT_RUNS))
def test_cli_formats_match_jax(tmp_path, ckpt, fp32, name):
    """Anaglyph (dubois, with ``--depth-aa`` from a checkpoint), VR180 and
    half-RGBD with an IPD offset: the port's CLI against the JAX CLI, the
    output size as expected, >= 50 dB."""
    args, shape = FORMAT_RUNS[name]
    if "--depth-aa" in args:
        args = args + ["--depth-aa-checkpoint", str(ckpt / "aa.nztm")]
    src = str(ckpt / "in.png")
    _run(cli.main, ["-i", src, "-o", str(tmp_path / "p.png"), "--device", "cpu"]
         + args + _common(ckpt))
    _run(jcli.main, ["-i", src, "-o", str(tmp_path / "j.png")] + args + _common(ckpt))
    got, want = _read(tmp_path / "p.png"), _read(tmp_path / "j.png")
    assert got.shape == want.shape == shape
    assert h.psnr(got, want) >= 50.0


def test_image_debug_depth_and_estimator_diverge_from_jax(tmp_path, ckpt, fp32):
    """The JAX CLI passes ``--debug-depth`` and ``--convergence-mode`` to
    video only, so on an image they do nothing there (its output equals
    the plain render).  The port honours both on images: the debug depth
    is the normalised depth in three equal channels, and the estimator
    (EMA off) moves the stereo frame."""
    src = str(ckpt / "in.png")
    plain = ["--half-sbs", "--divergence", "5"]
    sod = ["--convergence-mode", "sod_v1", "--sod-checkpoint", str(ckpt / "sod.nztm")]
    runs = (("port", "plain", plain), ("port", "debug", plain + ["--debug-depth"]),
            ("port", "sod", plain + sod), ("jax", "plain", plain),
            ("jax", "both", plain + sod + ["--debug-depth"]))
    out = {}
    for pkg, name, args in runs:
        main, extra = (cli.main, ["--device", "cpu"]) if pkg == "port" else (jcli.main, [])
        dst = tmp_path / f"{pkg}_{name}.png"
        _run(main, ["-i", src, "-o", str(dst)] + args + _common(ckpt) + extra)
        out[pkg, name] = _read(dst)
    np.testing.assert_array_equal(out["jax", "both"], out["jax", "plain"])
    assert h.psnr(out["port", "plain"], out["jax", "plain"]) >= 50.0
    debug = out["port", "debug"]
    assert debug.shape == (64, 90, 3)
    assert (debug[..., 0] == debug[..., 2]).all() and debug.std() > 10
    assert h.psnr(out["port", "sod"], out["port", "plain"]) < 50.0


def _reference_state_dict(flat, sod):
    """A reference-layout state dict holding the flax-layout weights
    ``flat`` (DepthAA, or SODV1 with ``sod``: each U2NETP conv as conv_s1
    and a BatchNorm bn_s1 with random statistics)."""
    rng = np.random.default_rng(13)
    sd = {}
    for key, a in flat.items():
        path, leaf = key.rsplit("/", 1)
        path = path.replace("/", ".")
        for old, new in (("mha.", "mha.mha."), ("bias.to_bias_", "bias.to_bias."),
                         ("conv_mlp_", "conv_mlp."), ("blocks_", "blocks.")):
            path = path.replace(old, new)
        if sod and "rebnconv" in path:
            if leaf == "kernel":
                c = a.shape[-1]
                bn = f"{path}.bn_s1"
                sd[bn + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                sd[bn + ".bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                sd[bn + ".running_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                sd[bn + ".running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            path += ".conv_s1"
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        sd[f"{path}.{'weight' if leaf == 'kernel' else 'bias'}"] = np.ascontiguousarray(a)
    return sd


@pytest.mark.parametrize("name", ["iw3.depth_aa", "iw3.sod_v1"])
@pytest.mark.parametrize("envelope", [False, True])
def test_raw_helper_checkpoints_convert_as_jax(tmp_path, name, envelope):
    """``--depth-aa-checkpoint`` / ``--sod-checkpoint`` given a raw
    reference ``.pth`` (bare, or in a nunif envelope naming the net): the
    port's net holds exactly the weights JAX's converter makes (U2NETP's
    BatchNorms folded into its convs)."""
    sod = name == "iw3.sod_v1"
    net = SODV1() if sod else DepthAA()
    flat = to_flax(net) if sod else aa_params(net, 3)
    sd = _reference_state_dict(flat, sod)
    path = str(tmp_path / "net.pth")
    torch.save({"name": name, "kwargs": {}, "state_dict": {
        k: torch.from_numpy(v) for k, v in sd.items()}} if envelope else
        {k: torch.from_numpy(v) for k, v in sd.items()}, path)
    got = to_flax(cli._net(name, path, torch.device("cpu"), 0))
    tree = ({"u2netp": jtc.convert_u2netp(sd, prefix="u2netp.")} if sod
            else jtc.convert_depth_aa(sd))
    want = {"/".join(str(p.key) for p in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    if not sod:
        assert all(np.array_equal(got[k], flat[k]) for k in flat)


def test_unported_cli_paths_raise(tmp_path):
    """``--devices`` above 1 raises, naming its ROADMAP item; a video input
    no longer does (tests/test_torch_video_cli.py): it reaches the decoder,
    which fails on a missing file, and writes nothing."""
    with pytest.raises(IOError, match="vio_reader_open"):
        cli.main(["-i", str(tmp_path / "clip.mp4"), "-o", str(tmp_path / "o.mp4"),
                  "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="queue 1, multi-device"):
        cli.main(["-i", "x.png", "-o", "y.png", "--devices", "2", "--device", "cpu"])
    assert not os.path.exists(tmp_path / "o.mp4")
