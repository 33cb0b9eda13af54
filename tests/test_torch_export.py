"""The port's model export (``nunif_tpu_torch/models/export.py``, a
``torch.export`` program in a zip) against the JAX package's ``.nzhlo`` on
the CPU.

Held: the program's graph calls the kernels as custom ops
(``torch.ops.nunif_tpu_torch.*``: K2 once and K1 14 times for
swin_unet_2x, K5 on its window path, K4 four times for a two-stage SwinT,
K6 on the image-form attention); a program loaded in a process that
imports only ``nunif_tpu_torch.models.export`` returns the eager model's
output exactly (both run the same twins on the same bf16 values); the
program at fp32 against JAX's ``ExportedModel`` on the same weights
(upconv_7: 1e-5, the JAX export test's tolerance; swin_unet_2x against
JAX's forward: 1e-4); the seven helper programs against JAX's (1e-5, fp32
products summed in another order); K3 and K7, which are no custom ops,
raise under ``torch.export``.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nunif_tpu.models import create_model as jax_create_model
from nunif_tpu.models.export import ExportedModel as JaxExportedModel
from nunif_tpu.models.export import export_helper_ops as jax_export_helper_ops
from nunif_tpu.models.export import export_model as jax_export_model
from nunif_tpu.models.io import load_model as jax_load_model

from nunif_tpu_torch.cli import export_model as export_cli
from nunif_tpu_torch.models import create_model, from_flax, save_model, to_flax
from nunif_tpu_torch.models.export import (ExportedModel, export_helper_ops,
                                           export_model, kernel_ops)
from nunif_tpu_torch.waifu2x.models.swin_unet import tamed_flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXPORT_ATOL = 1e-5
FP32_ATOL = 1e-4
SWIN_OPS = ["stem_conv3x3"] + ["fused_swin_block_image"] * 14


def unflatten(flat):
    root = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = jnp.asarray(v)
    return root


@pytest.fixture(scope="module")
def swin(tmp_path_factory):
    """A tamed swin_unet_2x on the CPU, its .nztm, an input and the
    program exported unbaked in bf16 (one trace for the file)."""
    d = tmp_path_factory.mktemp("export")
    model = create_model("waifu2x.swin_unet_2x")
    from_flax(model, tamed_flax_params(model, seed=0))
    model.eval().requires_grad_(False)
    save_model(model, str(d / "swin.nztm"))
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    program = export_model(model, str(d / "swin.pt2"), (1, 64, 64, 3))
    return {"dir": d, "model": model, "x": x, "program": program}


def test_export_graph_holds_the_kernel_ops(swin):
    assert kernel_ops(swin["program"]) == SWIN_OPS
    code = swin["program"].graph_module.code
    assert "torch.ops.nunif_tpu_torch.fused_swin_block_image.default" in code
    # the twin's pieces (softmax, the window partition) are not in the graph
    assert "softmax" not in code


def test_export_loads_without_model_classes(swin, tmp_path):
    """A child process that imports only models.export runs the program;
    its output equals the eager model's on the same bf16 input."""
    x = swin["x"]
    np.save(tmp_path / "x.npy", x.numpy())
    child = (
        "import sys, numpy as np\n"
        "from nunif_tpu_torch.models.export import ExportedModel\n"
        f"m = ExportedModel({str(swin['dir'] / 'swin.pt2')!r})\n"
        f"y = m(np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, y.numpy())\n"
        "loaded = [n for n in sys.modules if n.startswith('nunif_tpu_torch.')]\n"
        "assert not any(n.split('.')[1] in ('waifu2x', 'iw3', 'imagenet')\n"
        "               for n in loaded), loaded\n"
        "assert not any(n == 'jax' or n.startswith('nunif_tpu.')\n"
        "               for n in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", child], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with torch.no_grad():
        want = swin["model"](x.to(torch.bfloat16)).float().numpy()
    got = np.load(tmp_path / "y.npy")
    assert got.shape == want.shape == (1, 96, 96, 3)
    assert np.array_equal(got, want)


def test_kernel_layouts_program_matches_the_eager_packs(swin):
    """The program that makes an unbaked export's kernel layouts when it is
    loaded (``layouts.pt2``, written for exports on the card) returns the
    tensors that the eager layers pack and cache: K2's stem, each of the 14
    K1 blocks' nine and each window attention's gathered bias, exactly."""
    from nunif_tpu_torch.models.export import _Layouts, kernel_layouts
    from nunif_tpu_torch.ops.swin_attention import (PackedBlockWeights,
                                                    packed_list)
    model = swin["model"]
    weights = {k: p.detach() for k, p in model.named_parameters()}
    with torch.no_grad():
        got = torch.export.export(_Layouts(model, torch.bfloat16),
                                  (weights,)).module()(weights)
        want = kernel_layouts(model, torch.bfloat16)
        cached = {}
        for name, m in model.named_modules():
            if hasattr(m, "packed_weights"):
                packed = m.packed_weights(torch.bfloat16)
                if isinstance(packed, PackedBlockWeights):
                    packed = packed_list(packed)
            elif hasattr(m, "relative_bias"):
                packed = [m.relative_bias()]
            else:
                continue
            cached.update({f"{name}.kernel_layout{i}": t
                           for i, t in enumerate(packed)})
    assert list(got) == list(want) and sorted(want) == sorted(cached)
    assert len(want) == 2 + 14 * 9 + 14
    for key, t in want.items():
        assert torch.equal(got[key], t) and torch.equal(cached[key], t), key


def test_export_baked_fp32_matches_jax_forward(swin, tmp_path):
    model, x = swin["model"], swin["x"]
    program = export_model(model, str(tmp_path / "b.pt2"), (1, 64, 64, 3),
                           bake_params=True, compute_dtype=torch.float32)
    assert kernel_ops(program) == SWIN_OPS
    em = ExportedModel(str(tmp_path / "b.pt2"))
    assert em.meta["baked"] and em.params is None
    assert em.input_shape == (1, 64, 64, 3)
    got = em(x).numpy()
    with torch.no_grad():
        assert np.array_equal(got, model(x).numpy())
    jm, jparams, _ = jax_load_model(str(swin["dir"] / "swin.nztm"))
    want = np.asarray(jm.apply_fn(jparams, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)


def test_exported_model_checks_the_input_shape(swin):
    """``ExportedModel`` checks the inputs' shapes against the program's
    bucket (the program's own check of every weight is off)."""
    em = ExportedModel(str(swin["dir"] / "swin.pt2"))
    with pytest.raises(ValueError, match="the program takes"):
        em(torch.rand(1, 64, 72, 3))
    with pytest.raises(ValueError, match="the program takes"):
        em(swin["x"], swin["x"])


def test_export_window_path_holds_k5(swin, monkeypatch, tmp_path):
    monkeypatch.setenv("NUNIF_TPU_SWIN_IMG", "0")
    program = export_model(swin["model"], str(tmp_path / "w.pt2"),
                           (1, 64, 64, 3))
    assert kernel_ops(program) == ["stem_conv3x3"] + ["fused_swin_block"] * 14


def test_export_swin_t_holds_k4(tmp_path):
    import nunif_tpu_torch.imagenet  # noqa: F401  (registers the archs)
    model = create_model("imagenet.swin_t", depths=(2, 2), heads=(3, 6))
    from nunif_tpu_torch.models import init_flax_default
    init_flax_default(model, torch.Generator().manual_seed(0))
    model.eval().requires_grad_(False)
    program = export_model(model, str(tmp_path / "t.pt2"), (2, 56, 56, 3),
                           compute_dtype=torch.float32)
    assert kernel_ops(program) == ["fused_window_attention"] * 4
    x = torch.rand(2, 56, 56, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert np.array_equal(ExportedModel(str(tmp_path / "t.pt2"))(x).numpy(),
                              model(x).numpy())


def test_export_image_form_attention_holds_k6():
    from nunif_tpu_torch.modules.attention import ShiftedWindowAttention
    attn = ShiftedWindowAttention(96, 3, window_size=6, shift_size=3).eval()
    x = torch.rand(1, 12, 12, 96)
    with torch.no_grad():
        program = torch.export.export(attn, (x,))
        assert kernel_ops(program) == ["fused_window_attention_image"]
        assert torch.equal(program.module()(x), attn(x))


def seeded_upconv7():
    import nunif_tpu_torch.waifu2x  # noqa: F401
    model = create_model("waifu2x.upconv_7")
    rng = np.random.default_rng(0)
    flat = {k: (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
                if k.endswith("kernel") else rng.normal(0, 0.02, a.shape)
                ).astype(np.float32) for k, a in to_flax(model).items()}
    from_flax(model, flat)
    return model.eval().requires_grad_(False), flat


def test_export_upconv7_matches_jax_exported_model(tmp_path):
    model, flat = seeded_upconv7()
    export_model(model, str(tmp_path / "p.pt2"), (2, 32, 32, 3),
                 compute_dtype=torch.float32)
    jm = jax_create_model("waifu2x.upconv_7")
    jax_export_model(jm, unflatten(flat), str(tmp_path / "j.nzhlo"),
                     (2, 32, 32, 3))
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    got = ExportedModel(str(tmp_path / "p.pt2"))(x).numpy()
    want = np.asarray(JaxExportedModel(str(tmp_path / "j.nzhlo"))(x))
    assert got.shape == want.shape == (2, 36, 36, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_EXPORT_ATOL)


def test_export_cli(swin, tmp_path):
    out = tmp_path / "cli.pt2"
    assert export_cli.main(["-i", str(swin["dir"] / "swin.nztm"), "-o", str(out),
                            "--tile-size", "64", "--batch-size", "2",
                            "--bake-params", "--device", "cpu"]) == 0
    em = ExportedModel(str(out))
    assert em.meta["name"] == "waifu2x.swin_unet_2x" and em.meta["baked"]
    assert em.meta["compute_dtype"] == "bfloat16" and em.meta["device"] == "cpu"
    assert kernel_ops(em.exported) == SWIN_OPS
    assert em.input_shape == (2, 64, 64, 3)


def test_export_helper_ops_match_jax(tmp_path):
    paths = export_helper_ops(str(tmp_path / "p"), tile_size=32, device="cpu")
    jpaths = jax_export_helper_ops(str(tmp_path / "j"), tile_size=32)
    assert sorted(paths) == sorted(jpaths) and len(paths) == 7
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    alpha = (rng.uniform(size=(1, 32, 32, 1)) > 0.4).astype(np.float32)
    split = np.asarray(JaxExportedModel(jpaths["tta_split"])(img))
    inputs = {"pad": (img,), "alpha_border_pad": (img, alpha),
              "tta_split": (img,), "tta_merge": (split,),
              "seam_blend_filter": (np.ones((1, 1, 1, 1), np.float32),),
              "antialias": (img,), "bicubic_2x": (img,)}
    for key, args in inputs.items():
        got = ExportedModel(paths[key])(*args).numpy()
        want = np.asarray(JaxExportedModel(jpaths[key]).exported.call(*args))
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, rtol=0, atol=JAX_EXPORT_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("kernel", ["sdpa", "warp_x_bounded"])
def test_export_refuses_k3_k7(kernel):
    """K3 is no custom op: tracing it raises, it does not record its twin.
    K7 is one (since it got its backward): the graph holds the op itself,
    not its twin's einsums."""
    from nunif_tpu_torch.modules.grid_sample import warp_x_bounded
    from nunif_tpu_torch.ops.sdpa import sdpa

    class M(torch.nn.Module):
        def forward(self, x):
            if kernel == "sdpa":
                return sdpa(x, x, x)
            return warp_x_bounded(x, x[..., 0], 4)
    x = torch.rand(1, 2, 8, 64)
    if kernel == "sdpa":
        ep = torch.export.export(M(), (x,))
        calls = [n.target for n in ep.graph.nodes if n.op == "call_function"]
        assert calls == [torch.ops.nunif_tpu_torch.sdpa.default]
        np.testing.assert_array_equal(ep.module()(x).numpy(), M()(x).numpy())
        return
    with pytest.raises(Exception, match="not a torch.library op"):
        torch.export.export(M(), (x,))
