"""Raw upstream depth checkpoints in nunif_tpu_torch against the JAX
package, on the CPU: the port's own converters (``models/torch_convert.py``)
give JAX's ``torch_convert`` trees key for key and bit for bit; raw
``.pth`` and ``.safetensors`` files load into the DepthAnything, DepthPro
and DA3 wrappers and infer as JAX's wrappers do on the same file; the
port's ``.safetensors`` reader (no ``safetensors`` package on its path)
reads what the package writes; ``.nztm`` files of the new registry names
cross between the packages.

State dicts come from the plain-torch oracles in ``tests/torchref`` at
small configs (ViT 64 wide, 2 blocks; BEiT 64 wide, 4 heads; DepthPro at
tile 128), seeded with ``torch.manual_seed``; inputs are seeded numpy.
Outputs fp32 (JAX's bf16 casts resolved to fp32) to 1e-4.
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nunif_tpu.iw3.depth import da3 as j3
from nunif_tpu.iw3.depth import depth_anything as jda
from nunif_tpu.iw3.depth import depth_pro as jpro
from nunif_tpu.iw3.depth import dinov2 as jdino
from nunif_tpu.iw3.depth import midas as jmidas
from nunif_tpu.models import flatten_params as j_flatten, torch_convert as jtc
from nunif_tpu.models import load_model as j_load_model, save_model as j_save_model

from nunif_tpu_torch.iw3.depth import create_depth_model
from nunif_tpu_torch.iw3.depth import da3 as t3
from nunif_tpu_torch.iw3.depth import depth_anything as tda
from nunif_tpu_torch.iw3.depth import depth_pro as tpro
from nunif_tpu_torch.iw3.depth import dinov2 as tdino
from nunif_tpu_torch.iw3.depth import midas as tmidas
from nunif_tpu_torch.iw3.depth import zoedepth as tz
from nunif_tpu_torch.iw3.depth.base import seeded_weights_
from nunif_tpu_torch.models import from_flax, load_model, save_model, to_flax
from nunif_tpu_torch.models import pth_import, torch_convert as tc

from torchref.beit import MidasBeit
from torchref.depth_pro import DepthProTorch
from torchref.dinovit import DepthAnythingV2, DepthAnythingV3MonoTorch
from torchref.zoe_head import ZoeBinsHead

import torch_iw3_helpers as h

pytestmark = pytest.mark.usefixtures("two_threads")
two_threads = h.two_threads

BEIT_T = dict(embed_dim=64, depth=2, num_heads=4, pretrained_grid=4,
              hooks=(0, 1, 1, 1), neck_channels=(16, 32, 64, 64))
DPT_T = dict(features=16, out_channels=(8, 16, 32, 64))
VIT_T = dict(embed_dim=64, depth=2, num_heads=2, features=16,
             out_channels=(8, 16, 32, 64), idxs=(0, 1, 1, 1))


@pytest.fixture(scope="module", autouse=True)
def tables():
    mp = pytest.MonkeyPatch()
    for mod in (jdino, tdino):
        mp.setitem(mod.INTERMEDIATE_LAYER_IDX, "vitt", [0, 1, 1, 1])
    for mod in (j3, t3, jda, tda):
        mp.setitem(mod._DPT_CONFIGS, "vitt", DPT_T)
    for mod in (jmidas, tmidas):
        mp.setitem(mod.BEIT_CONFIGS, "beit_t", BEIT_T)
    yield
    mp.undo()


class _TorchZoe(torch.nn.Module):
    """ZoeDepth's released key layout: the MiDaS core at core.core.*, the
    bins head at the root."""

    def __init__(self):
        super().__init__()
        self.core = torch.nn.Module()
        self.core.core = MidasBeit(grid=4, **{k: v for k, v in BEIT_T.items() if k not in (
            "pretrained_grid", "neck_channels")}, neck=BEIT_T["neck_channels"])
        for name, mod in ZoeBinsHead().named_children():
            setattr(self, name, mod)


def _da3_sd():
    """DA3 mono's hub layout behind a ``model.`` prefix with the
    ``backbone.`` / ``head.`` names, which the converter normalises."""
    sd = DepthAnythingV3MonoTorch(**VIT_T).state_dict()
    alias = {"pretrained.": "backbone.", "depth_head.": "head."}
    return {"model." + next(new + k[len(old):] for old, new in alias.items()
                            if k.startswith(old)): v for k, v in sd.items()}


# (name, state dict maker, converter call, the port model the tree loads into)
CASES = {
    "depth_anything": (lambda: DepthAnythingV2(**VIT_T).state_dict(),
                       lambda m, sd: m.convert_depth_anything(sd, "vitt"),
                       lambda: tda.DepthAnything("vitt")),
    "midas_core": (lambda: _TorchZoe().core.core.state_dict(),
                   lambda m, sd: m.convert_midas_core(sd, "beit_t"),
                   lambda: tmidas.MidasCore("beit_t")),
    "zoedepth_head": (lambda: ZoeBinsHead().state_dict(),
                      lambda m, sd: m.convert_zoedepth_head(sd),
                      lambda: tz.MetricBinsHead()),
    "zoedepth": (lambda: _TorchZoe().state_dict(),
                 lambda m, sd: m.convert_zoedepth(sd, "beit_t"),
                 lambda: tz.ZoeDepthNet(core="beit_t")),
    "da3mono": (_da3_sd, lambda m, sd: m.convert_da3mono(sd, "vitt"),
                lambda: t3.DepthAnythingV3Mono("vitt")),
    "depth_pro": (lambda: DepthProTorch(64, 2, 2, 128).state_dict(),
                  lambda m, sd: m.convert_depth_pro(sd, "vitt"),
                  lambda: tpro.DepthPro("vitt", tile_size=128, pos_embed_size=8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_converted_tree_equals_jax_bit_for_bit(case):
    """The port's converter and JAX's on the same state dict: the same
    keys, dtypes and bytes; the tree loads into the port's model."""
    make_sd, convert, build = CASES[case]
    torch.manual_seed(40)
    sd = make_sd()
    got = tc.flatten(convert(tc, sd))
    want = {k: np.asarray(v) for k, v in j_flatten(convert(jtc, sd)).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    from_flax(build(), got)


def _write(sd, path):
    if str(path).endswith(".safetensors"):
        from safetensors.torch import save_file
        save_file({k: v.contiguous() for k, v in sd.items()}, str(path))
    else:
        torch.save(sd, str(path))
    return str(path)


def test_safetensors_reader_matches_the_package(tmp_path, monkeypatch):
    """F32, F16 and BF16 tensors (with metadata) read as the package reads
    them (bf16 widened to fp32 exactly), with ``safetensors`` unimportable;
    another dtype raises."""
    from safetensors.torch import load_file, save_file
    g = torch.Generator().manual_seed(41)
    sd = {"a": torch.randn(3, 4, generator=g), "b": torch.randn(5, generator=g).half(),
          "c": torch.randn(2, 3, 2, generator=g).bfloat16(), "d": torch.zeros(0, 4)}
    path = str(tmp_path / "t.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    want = load_file(path)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    got = pth_import.read_safetensors(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        w = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    name, kwargs, sd2 = pth_import.load_torch_checkpoint(path)
    assert name is None and kwargs == {} and sorted(sd2) == sorted(want)
    monkeypatch.delitem(sys.modules, "safetensors")
    save_file({"i": torch.arange(4)}, str(tmp_path / "i.safetensors"))
    monkeypatch.setitem(sys.modules, "safetensors", None)
    with pytest.raises(ValueError, match="I64"):
        pth_import.read_safetensors(str(tmp_path / "i.safetensors"))


def _setup_da(dm):
    dm.encoder = "vitt"
    dm.prep_lower_bound = 70


def _setup_pro(dm):
    dm.encoder, dm.tile_size, dm.img_size = "vitt", 128, 512


# family: (state dict, port / JAX wrapper name, port setup, JAX module, the
# suffix the JAX wrapper reads, load kwargs, input)
FAMILIES = {
    "DepthAnything": (lambda: DepthAnythingV2(**VIT_T).state_dict(), "Any_V2_S",
                      _setup_da, jda, ".pth", dict(resolution=70), (2, 70, 112, 3)),
    "DepthPro": (lambda: DepthProTorch(64, 2, 2, 128).state_dict(), "DepthPro_S",
                 _setup_pro, jpro, ".safetensors", {}, (1, 150, 200, 3)),
    "DA3": (lambda: {k[len("model."):]: v for k, v in _da3_sd().items()}, "Any_V3_Mono",
            _setup_da, j3, ".safetensors", dict(resolution=70), (2, 70, 112, 3)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_raw_checkpoints_load_into_wrappers_as_jax(family, tmp_path, monkeypatch):
    """The same weights as ``.pth`` and ``.safetensors``: the port loads
    both to the same tree (JAX's converter's, bit for bit) and the same
    output; JAX's wrapper, given one of the files, infers the same to
    1e-4."""
    make_sd, name, setup, jmod, jsuffix, load_kw, shape = FAMILIES[family]
    torch.manual_seed(42)
    sd = make_sd()
    with torch.no_grad():
        if family == "DepthPro":  # zero in the oracle's init; a sane FOV
            sd["head.4.bias"].normal_(std=0.1)
            sd["fov.head.4.bias"].fill_(60.0)
        elif family == "DA3":  # sky on part of the frame, not all of it
            sd["head.scratch.output_conv2.2.bias"].copy_(torch.tensor([0.5, -1.0]))
    x = np.random.default_rng(43).uniform(0, 1, shape).astype(np.float32)
    outs, trees = [], []
    for suffix in (".pth", ".safetensors"):
        path = _write(sd, tmp_path / f"w{suffix}")
        dm = create_depth_model(name, device="cpu", dtype=torch.float32)
        setup(dm)
        dm.load(checkpoint=path, **load_kw)
        trees.append(to_flax(dm.model))
        outs.append(dm.infer(torch.from_numpy(x)).numpy())
    assert all(np.array_equal(trees[0][k], trees[1][k]) for k in trees[0])
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].std() > 1e-3
    monkeypatch.setattr(jmod, "jnp", h.jnp_fp32())
    jdm = (jda.DepthAnythingModel if jmod is jda else
           jpro.DepthProModel if jmod is jpro else j3.DepthAnythingV3MonoModel)(name)
    setup(jdm)
    jdm.load(checkpoint=str(tmp_path / f"w{jsuffix}"), **load_kw)
    want = np.asarray(jdm.infer(jnp.asarray(x)))
    np.testing.assert_allclose(outs[0], want, rtol=1e-4, atol=1e-4)


NZTM = [("iw3.zoedepth", lambda: tz.ZoeDepthNet(core="beit_t"), dict(core="beit_t", n_bins=64)),
        ("iw3.zoedepth_nk", lambda: tz.ZoeDepthNKNet(core="beit_t"), dict(core="beit_t", n_bins=64)),
        ("iw3.depth_pro", lambda: tpro.DepthPro("vitt", tile_size=128, pos_embed_size=8),
         dict(encoder="vitt", tile_size=128, use_fov_head=True, pos_embed_size=8)),
        ("iw3.da3_mono", lambda: t3.DepthAnythingV3Mono("vitt"), dict(encoder="vitt"))]


@pytest.mark.parametrize("name,build,kwargs", NZTM, ids=[n for n, _b, _k in NZTM])
def test_nztm_crosses_between_packages(name, build, kwargs, tmp_path):
    """A port-written ``.nztm`` loads in JAX with the same arrays and
    kwargs, and a JAX-written one loads back in the port."""
    model = seeded_weights_(build(), torch.Generator().manual_seed(44))
    flat = to_flax(model)
    path = str(tmp_path / "m.nztm")
    save_model(model, path)
    jmodel, jparams, meta = j_load_model(path)
    assert meta["name"] == name and meta["kwargs"] == kwargs
    jflat = {k: np.asarray(v) for k, v in j_flatten(jparams).items()}
    assert sorted(jflat) == sorted(flat)
    assert all(np.array_equal(jflat[k], flat[k]) for k in flat)
    path2 = str(tmp_path / "j.nztm")
    j_save_model(jmodel, jparams, path2)
    loaded, meta2 = load_model(path2, device="cpu")
    assert type(loaded) is type(model) and meta2["name"] == name
    assert all(np.array_equal(v, flat[k]) for k, v in to_flax(loaded).items())
