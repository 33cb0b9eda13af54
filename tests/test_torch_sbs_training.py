"""iw3's sbs warp-net trainer and its tools in nunif_tpu_torch against the
JAX package, on the CPU: the Jaccard index, the quads that
``synthesize_quads`` writes, ``SBSDataset``'s batches, the loss and its
gradients (row_flow_v3 and mlbw_l2, mask weight 0 and 0.75, the delta
penalty alone), ``create_training_data sbs`` and ``train sbs`` for one
tiny epoch (a ``.nztm`` both packages load), ``count_mask_ratio`` and the
hole-mask threshold sweep.

Tolerances:
- datasets, ``_C`` / ``_D`` quads and the mask counts equal; the Jaccard
  index equal for one image and channel, else within an fp32 rounding of
  the mean (each image's IoU is equal, the mean sums in another order);
- ``_L`` within 1 LSB and ``_M`` flips at most 0.1% of the pixels: the two
  forward warps splat in fp32 in another order, so a value on a rounding
  boundary moves by one step (measured: 0 LSB and 0 flips);
- the loss within 1e-4 relative and each gradient element within rtol
  1e-4, atol 1e-6 x the largest gradient magnitude of all the net's
  parameters, fp32 (the warp's floor and the DCT's sums round in another
  order; a bias whose gradient is ~0 differs by ~1e-9);
- the sweep's IoU table equal to JAX's steps in the port's order (the JAX
  ``postprocess_hole_mask`` closes the logits, ROADMAP's settled
  divergence).

Reference faults the port does not copy: JAX builds row_flow_v3, MLBW
and row_flow_v2 with ``delta_output=False`` and returns a delta all the
same (the flag is never read); the port raises
(``test_delta_output_flag_diverges_from_jax``).  The JAX sweep feeds the
hole-mask net the 8-channel training input, which its first convolution
refuses; the port feeds it the inference input
(``test_sweep_input_diverges_from_jax``).
"""
import argparse
import os

import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import nunif_tpu.iw3.forward_warp as jfw
import nunif_tpu.iw3.models  # noqa: F401  (registers the JAX sbs nets)
from nunif_tpu.iw3.training.sbs import count_mask as jcount
from nunif_tpu.iw3.training.sbs import dataset as jds
from nunif_tpu.iw3.training.sbs import find_mask_threshold as jfmt
from nunif_tpu.iw3.training.sbs import trainer as jtrainer
from nunif_tpu.models import create_model as jax_create_model
from nunif_tpu.models.io import flatten_params, load_model as jax_load_model
from nunif_tpu.modules.jaccard import jaccard_index as jjaccard

from nunif_tpu_torch import create_training_data as t_ctd
from nunif_tpu_torch.iw3.training.sbs import count_mask as tcount
from nunif_tpu_torch.iw3.training.sbs import dataset as tds
from nunif_tpu_torch.iw3.training.sbs import find_mask_threshold as tfmt
from nunif_tpu_torch.iw3.training.sbs import trainer as ttrainer
from nunif_tpu_torch.models import (create_model, from_flax, init_flax_default,
                                    load_model, to_flax)
from nunif_tpu_torch.models.flax_params import _to_flax_layout, flax_keys
from nunif_tpu_torch.modules.jaccard import jaccard_index
from nunif_tpu_torch.train import main as train_main
from nunif_tpu_torch.utils.pil_io import save_image

import torch_iw3_helpers as h
from torch_iw3_helpers import j_hole_mask_port_order

SIZE = 96       # the trainer's default crop; row_flow_v3 / MLBW crop 32 a side
QUAD = 128      # the quads' size


def test_jaccard_index_equals_jax():
    rng = np.random.default_rng(0)
    cases = [rng.random((3, 10, 12, 2), dtype=np.float32) for _ in range(2)]
    cases.append(np.zeros((2, 5, 5, 1), np.float32))          # empty unions
    for a, b in ((cases[0], cases[1]), (cases[2], cases[2]),
                 (cases[0][0], cases[1][0]), (cases[0][0, ..., 0], cases[1][0, ..., 0])):
        for th in (0.3, 0.5):
            got = jaccard_index(torch.from_numpy(a), torch.from_numpy(b), th)
            # each (image, channel) IoU is equal; their fp32 mean is summed
            # in another order, so it may end one rounding away
            assert got == pytest.approx(jjaccard(jnp.asarray(a), jnp.asarray(b), th),
                                        rel=2 ** -22)
    assert jaccard_index(cases[2], cases[2]) == 1.0


@pytest.fixture(scope="module")
def quads(tmp_path_factory):
    """The quads of both packages' ``synthesize_quads`` (train: generated
    sources; eval: a directory of two images), and the JAX tree's path."""
    root = tmp_path_factory.mktemp("sbs_quads")
    src = root / "src"
    src.mkdir()
    rng = np.random.default_rng(3)
    for i, hw in enumerate(((150, 170), (100, 140))):
        Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(src / f"{i}.png")
    kw = dict(n_per_image=1, size=QUAD, divergence=8.0, convergence=0.4)
    with pytest.MonkeyPatch.context() as mp:
        # the JAX warp compiled once: eager, it takes ~1.5 s a quad
        mp.setattr(jfw, "depth_order_bilinear_forward_warp", jax.jit(
            jfw.depth_order_bilinear_forward_warp, static_argnums=(2, 3),
            static_argnames=("fill", "synthetic_view", "return_mask")))
        for pkg, fn in (("jax", jds.synthesize_quads), ("port", tds.synthesize_quads)):
            extra = {"device": "cpu"} if pkg == "port" else {}
            n_train = fn(None, str(root / pkg / "train"), seed=71, **kw, **extra)
            n_eval = fn(str(src), str(root / pkg / "eval"), seed=137, **kw, **extra)
            assert (n_train, n_eval) == (8, 8)
    return root


def test_synthesized_quads_match_jax(quads):
    for split in ("train", "eval"):
        names = sorted(os.listdir(quads / "jax" / split))
        assert len(names) == 32 and sorted(os.listdir(quads / "port" / split)) == names
        flips = total = holes = 0
        for n in names:
            a = np.asarray(Image.open(quads / "port" / split / n))
            b = np.asarray(Image.open(quads / "jax" / split / n))
            if n.endswith(("_C.png", "_D.png")):
                np.testing.assert_array_equal(a, b)
            elif n.endswith("_L.png"):
                assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1, n
            else:
                flips += int(((a > 0) != (b > 0)).sum())
                total += a.size
                holes += int((b > 0).sum())
        # the synthetic depth is smooth, so the warp leaves no hole in
        # either package (a step in depth makes them: test_sweep_*)
        assert flips <= 0.001 * total and holes == 0
        meta = Image.open(quads / "port" / split / "000000_D.png").text
        assert float(meta["divergence"]) == 8.0 and float(meta["convergence"]) == 0.4


@pytest.mark.parametrize("training", [True, False])
def test_sbs_dataset_equals_jax(quads, training):
    d = str(quads / "jax" / ("train" if training else "eval"))
    kw = dict(num_samples=5, training=training, seed=9)
    a = jds.SBSDataset(d, SIZE, 32, **kw)
    b = tds.SBSDataset(d, SIZE, 32, **kw)
    batches = list(zip(a.batches(2), b.batches(2), strict=True))
    assert len(batches) == 2
    for ja, tb in batches:
        assert set(ja) == set(tb)
        assert tb["rgb"].shape == (2, SIZE, SIZE, 3) and tb["y"].shape == (2, 32, 32, 3)
        for k in ja:
            np.testing.assert_array_equal(tb[k], ja[k])
    assert tds.list_quads(d) == jds.list_quads(d)


@pytest.fixture(scope="module")
def sbs_batch(quads):
    d = str(quads / "jax" / "train")
    return next(jds.SBSDataset(d, SIZE, 32, num_samples=2, seed=5).batches(2))


MASK_WEIGHTS = (0.0, 0.75)


@pytest.fixture(scope="module")
def nets(sbs_batch):
    """{arch: (port net, flax params, {mask weight: (JAX loss, JAX
    gradients)})}: flax's initialisation from seed 0 (the port's), the
    head's kernel scaled by 8 so that the deltas move pixels; JAX's loss
    and gradients at both mask weights from one compiled function."""
    out = {}
    jbatch = {k: jnp.asarray(v) for k, v in sbs_batch.items()}
    for arch in ("sbs.row_flow_v3", "sbs.mlbw_l2"):
        model = create_model(arch)
        init_flax_default(model, torch.Generator().manual_seed(0))
        flat = to_flax(model)
        head = "last_layer_1/kernel" if arch == "sbs.row_flow_v3" else "lv1_out_1/kernel"
        flat[head] = flat[head] * 8
        from_flax(model, flat)
        jm = jax_create_model(arch)
        fns = [jtrainer.make_sbs_loss(jm, jm.i2i_offset, mask_weight=w)[0]
               for w in MASK_WEIGHTS]
        both = jax.jit(lambda p: [jax.value_and_grad(
            lambda q, f=f: f(q, jbatch, None), has_aux=True)(p) for f in fns])
        want = {w: (float(v), {k: np.asarray(g) for k, g in flatten_params(grads).items()})
                for w, ((v, _aux), grads) in zip(MASK_WEIGHTS, both(h.jparams(flat)))}
        out[arch] = (model, flat, want)
    return out


def _port_grads(model):
    keys = flax_keys(model)
    return {keys[n]: _to_flax_layout(n, p.grad.numpy()) for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["sbs.row_flow_v3", "sbs.mlbw_l2"])
@pytest.mark.parametrize("mask_weight", MASK_WEIGHTS)
def test_sbs_loss_and_gradients_match_jax(nets, sbs_batch, arch, mask_weight):
    model, _flat, want = nets[arch]
    jloss, jgrads = want[mask_weight]
    loss_fn, eval_fn = ttrainer.make_sbs_loss(model, model.i2i_offset,
                                              mask_weight=mask_weight)
    model.requires_grad_(True).zero_grad(set_to_none=True)
    got, aux = loss_fn(model, sbs_batch, None)
    got.backward()
    assert aux == {} and float(got.detach()) == pytest.approx(jloss, rel=1e-4)
    grads = _port_grads(model)
    assert set(grads) == set(jgrads)
    top = max(float(np.abs(g).max()) for g in jgrads.values())
    assert top > 0
    for k, w in jgrads.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-4, atol=1e-6 * top, err_msg=k)
    assert float(eval_fn(model, sbs_batch)) == pytest.approx(float(got.detach()), rel=1e-6)
    model.requires_grad_(False)


def test_delta_penalty_matches_jax():
    rng = np.random.default_rng(4)
    wp = (np.arange(20, dtype=np.float32)[None, None]
          + rng.normal(0, 1.0, (2, 3, 20)).astype(np.float32))
    want, jg = jax.value_and_grad(jtrainer.delta_penalty)(jnp.asarray(wp))
    t = torch.from_numpy(wp).requires_grad_(True)
    got = ttrainer.delta_penalty(t)
    got.backward()
    assert float(want) > 0 and float(got) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", ["row_flow_v3", "mlbw", "row_flow_v2"])
def test_delta_output_flag_diverges_from_jax(name):
    """``delta_output=False`` names a training head that warps in the net.
    Neither package has one: the JAX constructor takes the flag and
    returns the delta all the same, the port refuses it."""
    model = create_model(f"sbs.{name}")
    init_flax_default(model, torch.Generator().manual_seed(1))
    x = np.random.default_rng(6).random((1, 8, 32, 3), np.float32)
    jm = jax_create_model(f"sbs.{name}", delta_output=False)
    got = jax.jit(jm.apply_fn)(h.jparams(to_flax(model)), jnp.asarray(x))
    with torch.no_grad():
        delta = model(torch.from_numpy(x))     # the port's delta-output net
    for u, v in zip(jax.tree.leaves(got), jax.tree.leaves(delta), strict=True):
        np.testing.assert_allclose(np.asarray(u), v.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(NotImplementedError, match="delta_output=False"):
        create_model(f"sbs.{name}", delta_output=False)


def test_cli_creates_data_and_trains_one_epoch(tmp_path, capsys):
    """``create_training_data sbs`` then ``train sbs`` (row_flow_v3 and
    mlbw_l2) for one epoch on the CPU: finite losses, a ``.nztm`` that
    the port's and the JAX package's loaders read to the same weights."""
    import json
    data = tmp_path / "data"
    assert t_ctd.main(["sbs", "-i", "synthetic", "-o", str(data), "--size",
                       str(QUAD), "--n-per-image", "1", "--device", "cpu"]) == 0
    assert len(os.listdir(data / "train")) == len(os.listdir(data / "eval")) == 32
    for arch, file in (("sbs.row_flow_v3", "sbs_row_flow_v3.nztm"),
                       ("sbs.mlbw_l2", "sbs_mlbw.nztm")):
        out = tmp_path / arch
        assert train_main(["sbs", "--arch", arch, "--model-dir", str(out),
                           "--data-dir", str(data), "--device", "cpu",
                           "--batch-size", "2", "--num-samples", "4",
                           "--max-epoch", "1"]) == 0
        lines = [json.loads(s[len("train: "):]) for s in
                 capsys.readouterr().out.splitlines() if s.startswith("train: ")]
        assert len(lines) == 1 and lines[0]["steps"] == 2
        assert np.isfinite(lines[0]["train_loss"]) and np.isfinite(lines[0]["eval_score"])
        model, meta = load_model(str(out / file), device="cpu")
        assert meta["name"] == model.model_name
        _jm, jparams, _jmeta = jax_load_model(str(out / file))
        keys = flax_keys(model)
        for n, p in model.named_parameters():
            np.testing.assert_array_equal(_to_flax_layout(n, p.numpy()),
                                          np.asarray(flatten_params(jparams)[keys[n]]))


def test_create_training_data_flags_match_jax():
    """The sbs data command has the JAX one's flags and ``--device``."""
    def flags(register, default_parser):
        p = register(argparse.ArgumentParser().add_subparsers(), default_parser)
        return {s for a in p._actions for s in a.option_strings if s.startswith("--")}
    ours = flags(ttrainer.register_create_training_data, t_ctd.create_default_parser())
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_root_ctd", os.path.join(os.path.dirname(__file__), "..",
                                  "create_training_data.py"))
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    theirs = flags(jtrainer.register_create_training_data, root.create_default_parser())
    assert ours - theirs == {"--device"} and theirs <= ours


def test_count_mask_ratio_equals_jax(tmp_path):
    rng = np.random.default_rng(7)
    for i in range(4):
        m = (rng.random((20, 30)) > 0.9).astype(np.uint8) * 255
        Image.fromarray(m if i % 2 else np.stack([m] * 3, -1)).save(tmp_path / f"{i}_ML.png")
    Image.fromarray(np.full((5, 5), 255, np.uint8)).save(tmp_path / "other.png")
    got = tcount.count_mask_ratio(str(tmp_path), log=lambda s: None)
    assert got == jcount.count_mask_ratio(str(tmp_path), log=lambda s: None)
    assert got[0] + got[1] == 4 * 600 and got[1] > 0


DIV = 8.0  # at 128 px wide: a 5-pixel shift, holes beside the depth step


@pytest.fixture(scope="module")
def sweep_case(tmp_path_factory):
    """One seeded 64 x 128 rgb + depth pair and a seeded mask_mlbw_l2
    ``.nztm`` (its hole logit's bias at -1, so the masks differ by
    threshold)."""
    from nunif_tpu_torch.iw3.models.mlbw import shaped_flax_params
    from nunif_tpu_torch.models import save_model
    root = tmp_path_factory.mktemp("sweep")
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rng = np.random.default_rng(8)
    save_image(rng.random((64, 128, 3), dtype=np.float32), str(root / "rgb" / "0.png"))
    depth = h.depth_map(rng, 1, 64, 128)[0] * 0.5
    depth[16:48, 40:80] += 0.5        # a step: the forward warp leaves holes
    save_image(np.repeat(depth, 3, axis=-1), str(root / "depth" / "0.png"))
    model = create_model("sbs.mask_mlbw_l2")
    flat = shaped_flax_params(model, seed=2)
    flat["lv1_out_1/bias"][-1] = -1.0
    from_flax(model, flat)
    save_model(model, str(root / "mask_mlbw.nztm"))
    return root, flat


def test_sweep_matches_jax_steps(sweep_case):
    """The port's IoU table against the JAX steps in the port's order: the
    forward warp's holes, the net on the inference input, the resize,
    threshold and closing."""
    root, flat = sweep_case
    got = tfmt.sweep(str(root / "rgb"), str(root / "depth"),
                     str(root / "mask_mlbw.nztm"), divergence=DIV, device="cpu")
    from nunif_tpu.iw3.backward_warp import make_input_tensor as jinput
    from nunif_tpu.utils.pil_io import load_image as jload
    rgb = jnp.asarray(jload(str(root / "rgb" / "0.png"))[0][None, ..., :3])
    dep = jnp.asarray(jload(str(root / "depth" / "0.png"), color="gray")[0][None, ..., :1])
    gt = jax.jit(jfmt.forward_nonwarp_mask, static_argnums=(2,))(rgb, dep, DIV)
    jm = jax_create_model("sbs.mask_mlbw_l2")
    logits = jax.jit(lambda p, x: jm.apply({"params": p}, x)[2])(
        h.jparams(flat), jinput(None, dep, DIV, 0.5, 128))
    want = {t: float(jjaccard(j_hole_mask_port_order(logits, (64, 128), t), gt))
            for t in tfmt.THRESHOLDS}
    assert got == want
    assert all(0.0 <= v <= 1.0 for v in got.values()) and len(set(got.values())) > 1
    assert 0 < float(gt.mean()) < 0.5


def test_sweep_input_diverges_from_jax(sweep_case):
    """The JAX sweep gives the hole-mask net the 8-channel training input
    (rgb, depth, the two features, the grid) and its first convolution,
    built for 3 channels, raises; the port gives it the inference input."""
    root, _flat = sweep_case
    jm, jp, _meta = jax_load_model(str(root / "mask_mlbw.nztm"))
    rgb = jnp.zeros((1, 64, 128, 3), jnp.float32)
    dep = jnp.full((1, 64, 128, 1), 0.5, jnp.float32)
    with pytest.raises(Exception, match="(?i)shape|channel|dimension"):
        jfmt.model_hole_mask(jm, jp, rgb, dep, DIV)
    model, _meta = load_model(str(root / "mask_mlbw.nztm"), device="cpu")
    with torch.no_grad():
        mask = tfmt.model_hole_mask(model, torch.from_numpy(np.asarray(rgb)),
                                    torch.from_numpy(np.asarray(dep)), DIV)
    assert tuple(mask.shape) == (1, 64, 128, 1)
