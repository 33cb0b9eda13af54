"""imagenet training in nunif_tpu_torch against the JAX package, on the
CPU: ``ImageFolderDataset``'s batches (equal for a seed), the
cross-entropy and its parameter gradients on swin_t (reduced depth at 56
px; K4's twin on the CPU) and on vgg11 at 224 px, ``calibrate_bn``'s
statistics, vgg11's FrozenBatchNorm statistics through a training step,
``SoftmaxConfusionMatrix``, and ``train imagenet --arch imagenet.swin_t``
for one tiny epoch.

Tolerances (fp32): the loss within 1e-4 relative; each gradient element
within rtol 1e-4 and an atol of 1e-6 x the largest gradient plus, for
swin_t, both packages' fp32 errors against the port's float64 gradient
(``torch_grad_check.hold``), for vgg11 twice their change under a
reversed batch (its docstring says why); calibrated means and variances
within 1e-4 relative (float64 sums of the same fp32 conv outputs).
"""
import json
import os

import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
import optax

import nunif_tpu.imagenet  # noqa: F401  (registers the JAX archs)
from nunif_tpu.imagenet import training as jtraining
from nunif_tpu.models import create_model as jax_create_model
from nunif_tpu.models.io import flatten_params
from nunif_tpu.training.confusion_matrix import SoftmaxConfusionMatrix as JaxCM
from nunif_tpu.training.wd_groups import wd_mask as jax_wd_mask

from nunif_tpu_torch.imagenet import training as ttraining
from nunif_tpu_torch.models import create_model, from_flax, init_flax_default, load_model, to_flax
from nunif_tpu_torch.train import main as train_main
from nunif_tpu_torch.training.confusion_matrix import SoftmaxConfusionMatrix
from nunif_tpu_torch.training.env import TrainState, make_train_step
from nunif_tpu_torch.training.optimizers import create_optimizer
from nunif_tpu_torch.training.schedules import constant_lr

import torch_grad_check as gc
import torch_iw3_helpers as h

SMALL = dict(depths=(2, 2), heads=(3, 6))  # 56 px, as test_torch_imagenet.py


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """train/ and eval/ trees of 2 classes x 3 PNGs of assorted sizes."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(0)
    for split in ("train", "eval"):
        for c in ("cat", "dog"):
            (root / split / c).mkdir(parents=True)
            for i, hw in enumerate(((240, 260), (230, 300), (260, 228))):
                Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(
                    root / split / c / f"{i}.png")
        (root / split / "notes.txt").write_text("not a class")
    return root


@pytest.mark.parametrize("training", [True, False])
def test_image_folder_dataset_equals_jax(image_root, training):
    d = str(image_root / ("train" if training else "eval"))
    a = jtraining.ImageFolderDataset(d, size=56, training=training, num_samples=6, seed=3)
    b = ttraining.ImageFolderDataset(d, size=56, training=training, num_samples=6, seed=3)
    assert a.classes == b.classes == ["cat", "dog"] and a.samples == b.samples
    for _epoch in range(2):         # the shuffle advances the same generator
        pairs = list(zip(a.batches(2), b.batches(2), strict=True))
        assert len(pairs) == 3
        for ja, tb in pairs:
            assert tb["y"].dtype == np.int32 and tb["x"].shape == (2, 56, 56, 3)
            for k in ja:
                np.testing.assert_array_equal(tb[k], ja[k])


def _ce_case(arch, kw, hw, seed):
    model = create_model(arch, **kw)
    init_flax_default(model, torch.Generator().manual_seed(seed))
    flat = to_flax(model)
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.rsplit("/", 1)[-1] in ("scale", "bias"):   # off flax's 1 / 0
            flat[k] = (flat[k] + rng.normal(0, 0.1, flat[k].shape)).astype(np.float32)
    from_flax(model, flat)
    x = rng.random((2, hw, hw, 3), dtype=np.float32)
    y = np.asarray([1, 3], np.int32)
    return model, flat, x, y


def _jax_ce(arch, kw, flat, x, y):
    jm = jax_create_model(arch, **kw)

    def jloss(p):     # the JAX trainer's loss_fn
        logits = jm.apply_fn(p, jnp.asarray(x), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()
    return gc.jax_loss_and_grads(flat, jloss)


def _port_ce(x, y):
    def tloss(m, dt):
        logits = m(torch.from_numpy(x).to(dt), train=True)
        return torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long())
    return tloss


def test_swin_t_cross_entropy_and_gradients_match_jax():
    model, flat, x, y = _ce_case("imagenet.swin_t", SMALL, 56, seed=1)
    gc.hold(model, _port_ce(x, y), _jax_ce("imagenet.swin_t", SMALL, flat, x, y))


def test_vgg11_cross_entropy_and_gradients_match_jax():
    """vgg11 in training mode (batch-statistics BatchNorm over 2 images) is
    ill-conditioned in fp32: when only the batch order changes the sums,
    the two packages' gradients move by up to 1.65e-2 of the largest
    together (conv5's kernel), and the float64 run lands as far from both,
    so it is no reference.  The bar of each element: rtol 1e-4 and an atol of 1e-6 x
    the largest gradient plus twice each package's own change under the
    reversed batch (the same loss).  FrozenBatchNorm's statistics take no
    gradient in the port and a zero one in JAX."""
    kw = {"num_classes": 10}
    model, flat, x, y = _ce_case("imagenet.vgg11", kw, 224, seed=1)
    jloss, jg = _jax_ce("imagenet.vgg11", kw, flat, x, y)
    _l, jg_rev = _jax_ce("imagenet.vgg11", kw, flat, x[::-1].copy(), y[::-1].copy())
    with torch.backends.mkldnn.flags(enabled=False):
        loss, g = gc.loss_and_grads(model, _port_ce(x, y))
        _l, g_rev = gc.loss_and_grads(model, _port_ce(x[::-1].copy(), y[::-1].copy()))
    assert loss == pytest.approx(jloss, rel=1e-4)
    stats = {k for k in jg if k.rsplit("/", 1)[-1] in ("mean", "var")}
    assert len(stats) == 16 and set(g) == set(jg) - stats
    assert not any(np.any(jg[k]) for k in stats)
    top = max(float(np.abs(v).max()) for v in jg.values())
    for k in g:
        noise = float(np.abs(jg[k] - jg_rev[k]).max()) + float(np.abs(g[k] - g_rev[k]).max())
        np.testing.assert_allclose(g[k], jg[k], rtol=1e-4, atol=1e-6 * top + 2 * noise,
                                   err_msg=k)
        assert noise <= 0.05 * top, k


@pytest.fixture(scope="module")
def vgg_case():
    model = create_model("imagenet.vgg11", num_classes=10)
    init_flax_default(model, torch.Generator().manual_seed(2))
    return model, to_flax(model)


def test_calibrate_bn_matches_jax(vgg_case):
    """Two batches of 224^2: each bn{k}'s mean and var recomputed from
    conv{k}'s output in a train-mode forward (the earlier layers on the
    batch statistics)."""
    model, flat = vgg_case
    rng = np.random.default_rng(4)
    batches = [{"x": rng.random((2, 224, 224, 3), dtype=np.float32)} for _ in range(3)]
    jm = jax_create_model("imagenet.vgg11", num_classes=10)
    want = flatten_params(jtraining.calibrate_bn(jm, h.jparams(flat), batches,
                                                 max_batches=2))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.backends.mkldnn.flags(enabled=False):
        got = ttraining.calibrate_bn(model, params, iter(batches), max_batches=2)
    names = ttraining.bn_names(model)
    assert len(names) == 8
    for n in names:
        for stat in ("mean", "var"):
            w = np.asarray(want[f"{n}/{stat}"])
            assert not np.array_equal(w, flat[f"{n}/{stat}"])
            np.testing.assert_allclose(got[f"{n}.{stat}"].numpy(), w, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(w).max()), err_msg=n)
    for n, p in model.named_parameters():   # the model keeps its own
        assert torch.equal(p, params[n]) and (n in got)
        if not n.endswith((".mean", ".var")):
            assert got[n] is params[n]


def test_frozen_bn_statistics_stay_through_a_step(vgg_case):
    """A training step (adamw, weight decay 0.1) moves the weights and
    leaves each bn{k}'s mean and var as they were: their gradient is 0 and
    weight decay skips them, as JAX's ``wd_mask`` decides."""
    model, flat = vgg_case
    from_flax(model, flat)
    jmask = flatten_params(jax_wd_mask(h.jparams(flat)))
    assert all(not jmask[k] for k in jmask if k.rsplit("/", 1)[-1] in ("mean", "var"))
    model.requires_grad_(True)
    opt = create_optimizer("adamw", model, constant_lr(1e-3), weight_decay=0.1)
    state = TrainState.create(model, opt)
    x = np.random.default_rng(5).random((2, 224, 224, 3), dtype=np.float32)

    def loss_fn(m, batch, generator):
        return torch.nn.functional.cross_entropy(
            m(torch.from_numpy(batch["x"]), train=True), torch.tensor([0, 7])), {}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = make_train_step(loss_fn)(state, {"x": x})
    model.requires_grad_(False)
    assert metrics["finite"]
    for n, p in model.named_parameters():
        if n.endswith((".mean", ".var")):
            assert torch.equal(p, before[n]), n
        elif n.endswith(".weight"):
            assert not torch.equal(p, before[n]), n
    from_flax(model, flat)


def test_confusion_matrix_equals_jax():
    rng = np.random.default_rng(6)
    a, b = SoftmaxConfusionMatrix(4, ["a", "b", "c", "d"]), JaxCM(4, ["a", "b", "c", "d"])
    for _ in range(3):
        logits = rng.normal(size=(5, 4)).astype(np.float32)
        labels = rng.integers(0, 3, 5)
        a.update(torch.from_numpy(logits), torch.from_numpy(labels))
        b.update(logits, labels)
    np.testing.assert_array_equal(a.matrix, b.matrix)
    assert (a.accuracy, a.average_row_correct(), str(a)) == \
        (b.accuracy, b.average_row_correct(), str(b))
    a.clear()
    assert a.matrix.sum() == 0 and a.accuracy == 0.0


def test_cli_swin_t_one_epoch(image_root, tmp_path, capsys):
    """``train imagenet --arch imagenet.swin_t`` at 224 px on the CPU: one
    epoch of 2 steps, the eval score the negative top-1 accuracy, a
    ``.nztm`` whose eval accuracy equals the trainer's."""
    assert train_main(["imagenet", "--arch", "imagenet.swin_t", "--data-dir",
                       str(image_root), "--model-dir", str(tmp_path), "--device", "cpu",
                       "--batch-size", "2", "--num-samples", "4", "--max-epoch", "1"]) == 0
    lines = [json.loads(s[len("train: "):]) for s in capsys.readouterr().out.splitlines()
             if s.startswith("train: ")]
    assert len(lines) == 1 and lines[0]["steps"] == 2 and np.isfinite(lines[0]["train_loss"])
    model, meta = load_model(str(tmp_path / "imagenet_swin_t.nztm"), device="cpu")
    assert meta["name"] == "imagenet.swin_t" and model.num_classes == 2
    ds = ttraining.ImageFolderDataset(str(image_root / "eval"), size=224, training=False)
    hits = []
    with torch.no_grad():
        for b in ds.batches(2):
            hits.append(float((model(torch.from_numpy(b["x"])).argmax(-1).numpy()
                               == b["y"]).mean()))
    assert -np.mean(hits) == pytest.approx(lines[0]["eval_score"], abs=1e-6)
    assert os.path.exists(tmp_path / "imagenet_swin_t.ckpt")
