"""The port's training framework (``nunif_tpu_torch/training``) against the
JAX package and optax, on the CPU.

Held to JAX / optax: the schedules step by step, the weight-decay mask on
the flax paths of three models, EMA, the hard-example sampler, each of the
five optimizers over 10 steps (with and without the global-norm clip and
with the masked decay), the schedule-free eval parameters, the NaN guard
(a skipped step leaves the parameters, the moments and the step count
as they were, so the next step equals optax's) and gradient
accumulation.  Then the trainer: ``fit`` for two epochs equals one epoch
and one resumed epoch, and the best model is exported.

Tolerances: fp32 on both sides, elementwise ops in the same order:
parameters within 1e-5 relative and 1e-6 absolute after 10 steps;
schedules within 1e-6 relative or 2e-7 of the base rate (JAX evaluates
them in fp32, the port in Python floats).
"""
import os

import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from nunif_tpu import training as jtraining
from nunif_tpu.models import unflatten_params
from nunif_tpu.training import ema as jema, sampler as jsampler

from nunif_tpu_torch import training as ttraining
from nunif_tpu_torch.models import create_model, init_flax_default, to_flax
from nunif_tpu_torch.models.flax_params import (_from_flax_layout,
                                                _to_flax_layout, flax_keys)
from nunif_tpu_torch.modules.attention import SwinTransformerBlock
from nunif_tpu_torch.training import ema as tema, sampler as tsampler
from nunif_tpu_torch.training.optimizers import create_optimizer
import nunif_tpu_torch.imagenet  # noqa: F401  (registers imagenet.*)
import nunif_tpu_torch.waifu2x  # noqa: F401

SCHEDULES = [
    ("none", {}), ("step", dict(step_size=1, gamma=0.5)),
    ("multistep", dict(milestones=[1, 3], gamma=0.1)),
    ("cosine", dict(t_0=2)), ("cosine", dict(t_0=1, t_mult=2)),
    ("cosine", dict(t_0=2, warmup_epochs=1)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_schedules_match_jax(name, kw):
    t = ttraining.build_schedule(name, 0.1, 4, **kw)
    j = jax.jit(jtraining.build_schedule(name, 0.1, 4, **kw))
    for step in range(40):
        # JAX evaluates in fp32: its cosine rounds to ~1e-7 of the base rate
        assert t(step) == pytest.approx(float(j(jnp.int32(step))), rel=1e-6,
                                        abs=2e-7 * 0.1)


@pytest.mark.parametrize("name,kw", [
    ("waifu2x.swin_unet_2x", dict(base_dim=16, layer_norm=True)),
    ("imagenet.vgg11", {}), ("imagenet.swin_t", {})])
def test_wd_mask_matches_jax_on_flax_paths(name, kw):
    model = create_model(name, **kw)
    flat = {k: jnp.zeros(v.shape) for k, v in to_flax(model).items()}
    want = {"/".join(p.key for p in path): bool(v) for path, v in
            jax.tree_util.tree_flatten_with_path(
                jtraining.wd_mask(unflatten_params(flat)))[0]}
    keys = flax_keys(model)
    got = {keys[n]: v for n, v in ttraining.wd_mask(model).items()}
    assert got == want
    assert True in got.values() and False in got.values()


def test_ema_matches_jax():
    rng = np.random.default_rng(0)
    m = torch.nn.Linear(4, 3)
    e = tema.ema_init(m)
    je = {k: jnp.array(v.numpy()) for k, v in e.items()}  # copies
    for _ in range(3):
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)))
        tema.ema_update(e, m, 0.9)
        je = jema.ema_update(je, {n: jnp.asarray(p.detach().numpy())
                                  for n, p in m.named_parameters()}, 0.9)
    for k in e:
        np.testing.assert_allclose(e[k].numpy(), np.asarray(je[k]), rtol=1e-6)


def test_sampler_matches_jax():
    t = tsampler.HardExampleSampler(10, method=tsampler.MiningMethod.TOP10, seed=3)
    j = jsampler.HardExampleSampler(10, method=jsampler.MiningMethod.TOP10, seed=3)
    losses = np.random.default_rng(1).random(10)
    for s in (t, j):
        s.update_losses(np.arange(10), losses)
        s.update_weights()
    np.testing.assert_array_equal(t.weights, j.weights)
    np.testing.assert_array_equal(t.epoch_indexes(), j.epoch_indexes())


def _module():
    """A LayerNorm Swin block: kernels, biases, norm scales and a bias
    table, so the decay mask has both values."""
    torch.manual_seed(0)
    m = SwinTransformerBlock(16, 2, 6, norm="layernorm")
    init_flax_default(m, torch.Generator().manual_seed(1))
    return m


def _grads(m, rng):
    keys = flax_keys(m)
    flat = {keys[n]: rng.normal(0, 1, _to_flax_layout(n, p.detach().numpy()).shape)
            .astype(np.float32) for n, p in m.named_parameters()}
    torch_g = {n: torch.from_numpy(np.ascontiguousarray(
        _from_flax_layout(n, flat[keys[n]]))) for n, _p in m.named_parameters()}
    return torch_g, unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


def _flat_params(m):
    return {k: np.asarray(v) for k, v in to_flax(m).items()}


def _tree_flat(tree):
    return {"/".join(p.key for p in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


OPTIMIZERS = [("adam", 0.0, None), ("adamw", 0.1, None), ("sgd", 0.0, None),
              ("lion", 0.1, None), ("schedulefree", 0.1, None),
              ("adam", 0.0, 1.0), ("lion", 0.0, 5.0)]


@pytest.mark.parametrize("name,wd,clip", OPTIMIZERS)
def test_optimizer_matches_optax_over_10_steps(name, wd, clip):
    m = _module()
    sched_kw = dict(t_0=2, warmup_epochs=1)
    t_opt = create_optimizer(name, m, ttraining.build_schedule(
        "cosine", 1e-2, 3, **sched_kw), weight_decay=wd, grad_clip=clip)
    params = unflatten_params({k: jnp.asarray(v) for k, v in _flat_params(m).items()})
    tx = jtraining.create_optimizer(
        name, jtraining.build_schedule("cosine", 1e-2, 3, **sched_kw),
        weight_decay=wd, params=params, grad_clip=clip)
    state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(2)
    for _ in range(10):
        tg, jg = _grads(m, rng)
        t_opt.step(tg)
        u, state = update(jg, state, params)
        params = optax.apply_updates(params, u)
        got, want = _flat_params(m), _tree_flat(params)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert t_opt.count == 10
    if name == "schedulefree":
        ev = t_opt.eval_params()
        want = _tree_flat(optax.contrib.schedule_free_eval_params(state, params))
        keys = flax_keys(m)
        for n, v in ev.items():
            np.testing.assert_allclose(_to_flax_layout(n, v.numpy()),
                                       want[keys[n]], rtol=1e-5, atol=1e-6)


def test_optimizer_step_moves_every_version():
    """The kernels' weight packs key on ``_version``: every update of every
    optimizer writes each parameter in place."""
    for name, _wd, _clip in OPTIMIZERS[:5]:
        m = _module()
        opt = create_optimizer(name, m, lambda step: 1e-3, weight_decay=0.1)
        before = {n: (p.data_ptr(), p._version) for n, p in m.named_parameters()}
        opt.step({n: torch.ones_like(p) for n, p in m.named_parameters()})
        for n, p in m.named_parameters():
            assert p.data_ptr() == before[n][0] and p._version > before[n][1], (name, n)


def _tiny():
    """y = 2x with one weight, as the JAX package's own framework tests."""
    m = torch.nn.Module()
    m.w = torch.nn.Parameter(torch.zeros(1))

    def loss_fn(model, batch, generator):
        x, y = batch
        return torch.mean((x * model.w - y) ** 2), {}

    def jloss(p, batch, rng):
        x, y = batch
        return jnp.mean((x * p["w"] - y) ** 2), {}
    return m, loss_fn, jloss


def test_nan_guard_and_accumulation_match_jax():
    """finite, NaN, finite batches with Adam: the NaN step changes nothing
    (parameters, moments, step count) and the next step equals optax's;
    accumulation over 4 microbatches equals the whole batch."""
    m, loss_fn, jloss = _tiny()
    opt = create_optimizer("adam", m, lambda s: 0.1)
    st = ttraining.TrainState.create(m, opt)
    step = ttraining.make_train_step(loss_fn, accum_steps=4)
    tx = optax.adam(0.1)
    js = jtraining.TrainState.create({"w": jnp.zeros((1,))}, tx)
    jstep = jtraining.make_train_step(jloss, tx, accum_steps=4)
    x = np.arange(8, dtype=np.float32).reshape(8, 1)
    batches = [(x, 2 * x), (np.full_like(x, np.nan), x), (x + 1, 3 * x)]
    for i, (bx, by) in enumerate(batches):
        mu_before = opt.s_mu["w"].clone()
        met = step(st, (torch.from_numpy(bx), torch.from_numpy(by)))
        js, jm = jstep(js, (jnp.asarray(bx), jnp.asarray(by)), jax.random.PRNGKey(0))
        assert met["finite"] == bool(jm["finite"])
        np.testing.assert_allclose(m.w.detach().numpy(), np.asarray(js.params["w"]),
                                   rtol=1e-6)
        if i == 1:
            assert st.nan_count == 1 and opt.count == 1
            assert torch.equal(opt.s_mu["w"], mu_before)
        else:
            assert met["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert st.nan_count == int(js.nan_count) == 1 and st.step == 3
    # accumulation: the mean of the microbatch gradients is the batch's
    m1, _l, _j = _tiny()
    opt1 = create_optimizer("sgd", m1, lambda s: 0.01)
    ttraining.make_train_step(loss_fn)(ttraining.TrainState.create(m1, opt1),
                                       (torch.from_numpy(x), torch.from_numpy(2 * x)))
    m4, _l, _j = _tiny()
    opt4 = create_optimizer("sgd", m4, lambda s: 0.01)
    ttraining.make_train_step(loss_fn, accum_steps=4)(
        ttraining.TrainState.create(m4, opt4),
        (torch.from_numpy(x), torch.from_numpy(2 * x)))
    torch.testing.assert_close(m1.w, m4.w, rtol=1e-6, atol=0)


def test_ema_step_matches_jax():
    m, loss_fn, jloss = _tiny()
    opt = create_optimizer("sgd", m, lambda s: 0.1)
    st = ttraining.TrainState.create(m, opt, use_ema=True)
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    js = jtraining.TrainState.create({"w": jnp.zeros((1,))}, tx, use_ema=True)
    x = np.ones((4, 1), np.float32)
    for _ in range(3):
        ttraining.make_train_step(loss_fn, ema_decay=0.9)(
            st, (torch.from_numpy(x), torch.from_numpy(2 * x)))
        js, _ = jtraining.make_train_step(jloss, tx, ema_decay=0.9)(
            js, (jnp.asarray(x), jnp.asarray(2 * x)), jax.random.PRNGKey(0))
    np.testing.assert_allclose(st.ema_params["w"].numpy(),
                               np.asarray(js.ema_params["w"]), rtol=1e-6)


def _fit(model_dir, max_epoch, resume, batches, eval_sign=1.0):
    model = create_model("waifu2x.vgg_7")
    init_flax_default(model, torch.Generator().manual_seed(0))

    def loss_fn(model, batch, generator):
        # the loss generator's state is part of the checkpoint
        w = 1.0 + 0.1 * torch.rand((), generator=generator)
        pred = model(torch.from_numpy(batch["x"]), train=True)
        return torch.mean(torch.abs(pred - torch.from_numpy(batch["y"]))) * w, {}

    def eval_fn(model, batch):
        pred = model(torch.from_numpy(batch["x"]))
        return eval_sign * torch.mean(torch.abs(pred - torch.from_numpy(batch["y"])))

    cfg = ttraining.TrainerConfig(model_dir=str(model_dir), max_epoch=max_epoch,
                                  optimizer="adam", learning_rate=1e-3,
                                  ema_decay=0.9, resume=resume,
                                  checkpoint_name="tiny")
    tr = ttraining.Trainer(cfg, model, loss_fn, eval_fn, steps_per_epoch=2)
    tr.fit(lambda: iter(batches), lambda: iter(batches[:1]))
    return tr


@pytest.mark.parametrize("second_epoch", ["better", "worse"])
def test_fit_then_resume_equals_two_epochs(tmp_path, second_epoch):
    """With an eval score that rises as the loss falls ("worse"), the second
    epoch scores worse than the first: the resumed run must keep the first
    epoch's best score and its exported model, as the uninterrupted run
    does (the JAX trainer checkpoints the best score before updating it,
    ROADMAP queue 3)."""
    from nunif_tpu_torch.models import read_checkpoint
    sign = 1.0 if second_epoch == "better" else -1.0
    rng = np.random.default_rng(0)
    batches = [{"x": rng.uniform(size=(2, 18, 18, 3)).astype(np.float32),
                "y": rng.uniform(size=(2, 4, 4, 3)).astype(np.float32)}
               for _ in range(2)]
    whole = _fit(tmp_path / "a", 2, False, batches, sign)
    first = _fit(tmp_path / "b", 1, False, batches, sign)
    assert first.last_epoch == 1 and os.path.exists(first.checkpoint_path)
    first_export = read_checkpoint(str(tmp_path / "b" / "waifu2x_vgg_7.nztm"))[1]
    if second_epoch == "better":
        assert whole.best_score < first.best_score
    else:
        assert whole.best_score == first.best_score
    resumed = _fit(tmp_path / "b", 2, True, batches, sign)
    assert resumed.last_epoch == 2 and resumed.state.step == whole.state.step == 4
    for (n, a), (_n, b) in zip(whole.model.named_parameters(),
                               resumed.model.named_parameters()):
        assert torch.equal(a, b), n
    for n in whole.state.ema_params:
        assert torch.equal(whole.state.ema_params[n], resumed.state.ema_params[n])
    assert resumed.optimizer.count == whole.optimizer.count == 4
    assert resumed.best_score == whole.best_score
    files = os.listdir(tmp_path / "b")
    assert "waifu2x_vgg_7.nztm" in files and any(f.endswith(".csv") for f in files)
    ours = read_checkpoint(str(tmp_path / "b" / "waifu2x_vgg_7.nztm"))[1]
    theirs = read_checkpoint(str(tmp_path / "a" / "waifu2x_vgg_7.nztm"))[1]
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    changed = any(not np.array_equal(ours[k], first_export[k]) for k in ours)
    assert changed == (second_epoch == "better")


def test_schedulefree_export_diverges_from_jax(tmp_path):
    """The JAX trainer evaluates and exports schedule-free's training
    iterate y (``nunif_tpu/training/trainer.py:258``), though its
    ``create_optimizer`` says evaluation must read
    ``schedule_free_eval_params``; the port's trainer exports the average
    x that those eval parameters give (ROADMAP queue 3)."""
    from nunif_tpu.models import create_model as jax_create_model
    import nunif_tpu.waifu2x  # noqa: F401  (registers the JAX models)
    from nunif_tpu.models.io import load_model as jax_load_model
    from nunif_tpu_torch.models import read_checkpoint
    rng = np.random.default_rng(0)
    batch = {"x": rng.uniform(size=(2, 18, 18, 3)).astype(np.float32),
             "y": rng.uniform(size=(2, 4, 4, 3)).astype(np.float32)}
    model = create_model("waifu2x.vgg_7")
    init_flax_default(model, torch.Generator().manual_seed(0))
    flat = _flat_params(model)

    def loss_fn(model, b, generator):
        pred = model(torch.from_numpy(b["x"]), train=True)
        return torch.mean(torch.abs(pred - torch.from_numpy(b["y"]))), {}
    cfg = dict(max_epoch=1, optimizer="schedulefree", learning_rate=1e-2,
               checkpoint_name="sf")
    tr = ttraining.Trainer(ttraining.TrainerConfig(model_dir=str(tmp_path / "t"), **cfg),
                           model, loss_fn, steps_per_epoch=2)
    tr.fit(lambda: iter([batch, batch]))
    _meta, ours = read_checkpoint(str(tmp_path / "t" / "waifu2x_vgg_7.nztm"))
    keys = flax_keys(model)
    ev = {keys[n]: _to_flax_layout(n, v.numpy()) for n, v in tr.optimizer.eval_params().items()}
    trained = _flat_params(model)

    jmodel = jax_create_model("waifu2x.vgg_7")

    def jloss(p, b, key):
        pred = jmodel.apply({"params": p}, b["x"], train=True)
        return jnp.mean(jnp.abs(pred - b["y"])), {}
    jtr = jtraining.Trainer(
        jtraining.TrainerConfig(model_dir=str(tmp_path / "j"), **cfg), jmodel,
        unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}), jloss,
        steps_per_epoch=2)
    jtr.fit(lambda: iter([batch, batch]))
    _m, jparams, _meta = jax_load_model(str(tmp_path / "j" / "waifu2x_vgg_7.nztm"))
    theirs = _tree_flat(jparams)
    j_y = _tree_flat(jtr.state.params)
    j_x = _tree_flat(optax.contrib.schedule_free_eval_params(
        jtr.state.opt_state, jtr.state.params))
    for k in ours:
        np.testing.assert_array_equal(ours[k], ev[k])      # the port: x
        np.testing.assert_array_equal(theirs[k], j_y[k])   # JAX: y
    assert max(float(np.abs(ours[k] - trained[k]).max()) for k in ours) > 1e-5
    assert max(float(np.abs(theirs[k] - j_x[k]).max()) for k in ours) > 1e-5
