"""The GAN step (``training/gan.py``) and the pair augments
(``transforms/diff_augment.py``) of nunif_tpu_torch against the JAX
package, on the CPU.

The step: the small generator and discriminator of ``tests/test_gan.py``
(two 3x3 convs each, the discriminator's first at stride 2), their flax
initial weights carried across, the same numpy batch each step, Adam at lr
1e-3 on both sides, one case per loss kind (hinge with one head and with
two weighted heads, bce, softplus, mask_hinge with the hole grid), with R1
every 2 steps, the generator's EMA and a warmup of one step.  After 3
steps every parameter (and the EMA) within 2 lr of JAX's (Adam's update
is lr g / (|g| + eps): where a gradient element is near 0 a rounding can
turn it); the adaptive weight within 1e-6 of JAX's each step, 0 during the
warmup.  R1 is checked against the same step without it: it moves the
discriminator on its step and not between.

The augments: ``diff_translate`` and the rotation equal to JAX's for
given shifts and angles (the rotation within 1e-5: two bilinear samplers
that round the coordinates apart); the random pairs move both images
alike and keep their shape.
"""
import dataclasses

import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax

from nunif_tpu.models.io import flatten_params
from nunif_tpu.training import gan as jgan
from nunif_tpu.transforms import diff_augment as jda

from nunif_tpu_torch.models import from_flax
from nunif_tpu_torch.modules.conv import conv2d_nhwc
from nunif_tpu_torch.training import gan as tgan
from nunif_tpu_torch.training.optimizers import create_optimizer
from nunif_tpu_torch.training.schedules import constant_lr
from nunif_tpu_torch.transforms import diff_augment as tda

LR = 1e-3
STEPS = 3


class JG(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = fnn.relu(fnn.Conv(8, (3, 3), padding="SAME", name="c1")(x))
        return fnn.Conv(3, (3, 3), padding="SAME", name="last")(h)


class JD(fnn.Module):
    heads: int = 1

    @fnn.compact
    def __call__(self, x):
        h = fnn.relu(fnn.Conv(8, (3, 3), strides=(2, 2), padding="SAME")(x))
        a = fnn.Conv(1, (3, 3), padding="SAME")(h)
        if self.heads == 1:
            return a
        return a, fnn.Conv(1, (1, 1), padding="VALID")(h)


class TG(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv2d(3, 8, 3)
        self.last = nn.Conv2d(8, 3, 3)

    def forward(self, x):
        h = torch.relu(conv2d_nhwc(x, self.c1, padding=1))
        return conv2d_nhwc(h, self.last, padding=1)


class TD(nn.Module):
    def __init__(self, heads=1):
        super().__init__()
        self.heads = heads
        self.Conv_0 = nn.Conv2d(3, 8, 3)
        self.Conv_1 = nn.Conv2d(8, 1, 3)
        if heads == 2:
            self.Conv_2 = nn.Conv2d(8, 1, 1)

    def forward(self, x):
        # 3x3 SAME at stride 2 on an even side pads (0, 1)
        h = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1)).permute(0, 2, 3, 1)
        h = torch.relu(conv2d_nhwc(h, self.Conv_0, stride=2))
        a = conv2d_nhwc(h, self.Conv_1, padding=1)
        if self.heads == 1:
            return a
        return a, conv2d_nhwc(h, self.Conv_2)


def _jax_grid(mask):
    m = jax.lax.reduce_window(mask, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                              (1, 2, 2, 1), "VALID")
    return m > 0


def _torch_grid(mask):
    return F.max_pool2d(mask.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1) > 0


CASES = {  # name: (gan_loss, heads, d_loss_weights, last layer)
    "hinge": ("hinge", 1, (1.0,), ("last", "kernel")),
    "hinge_two_heads": ("hinge", 2, (0.8, 0.2), None),
    "bce": ("bce", 1, (1.0,), ("last", "kernel")),
    "softplus": ("softplus", 1, (1.0,), None),
    "mask_hinge": ("mask_hinge", 1, (1.0,), None),
}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    mask = np.zeros((2, 16, 16, 1), np.float32)
    mask[0, 2:9, 4:6] = 1.0
    mask[1, 10:16, 0:12] = 1.0
    return {"x": x, "y": y, "mask": mask}


def _jax_run(case, cfg, batch):
    kind, heads, weights, last = CASES[case]
    g, d = JG(), JD(heads)
    x = jnp.asarray(batch["x"])
    gp = g.init(jax.random.PRNGKey(0), x)["params"]
    dp = d.init(jax.random.PRNGKey(1), x)["params"]
    mask_mode = kind == "mask_hinge"

    def d_apply(p, img, c, *mask):
        out = d.apply({"params": p}, img)
        return (out, _jax_grid(mask[0])) if mask_mode else out
    init, step = jgan.make_gan_train_step(
        lambda p, b: g.apply({"params": p}, b["x"]), d_apply,
        lambda f, t: jnp.mean(jnp.abs(f - t)), optax.adam(LR), optax.adam(LR),
        cfg, d_loss_weights=weights, last_layer_path=last)
    state = init(gp, dp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    weights_seen = []
    start = (flatten_params(gp), flatten_params(dp))
    for _ in range(STEPS):
        state, m = step(state, jb)
        weights_seen.append(float(m["disc_weight"]))
    return start, state, weights_seen


def _port(case, cfg, start, batch, steps=STEPS, first_step=0):
    kind, heads, weights, last = CASES[case]
    g, d = TG(), TD(heads)
    from_flax(g, {k: np.asarray(v) for k, v in start[0].items()})
    from_flax(d, {k: np.asarray(v) for k, v in start[1].items()})
    mask_mode = kind == "mask_hinge"

    def d_apply(dm, img, c, *mask):
        out = dm(img)
        return (out, _torch_grid(mask[0])) if mask_mode else out
    g_opt = create_optimizer("adam", g, constant_lr(LR))
    d_opt = create_optimizer("adam", d, constant_lr(LR))
    init, step = tgan.make_gan_train_step(
        g, d, lambda gm, b: gm(b["x"]), d_apply,
        lambda f, t: torch.mean(torch.abs(f - t)), g_opt, d_opt, cfg,
        d_loss_weights=weights, last_layer=None if last is None else "last.weight")
    state = init()
    state.step = first_step
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    seen = []
    for _ in range(steps):
        m = step(state, tb)
        seen.append(m)
    return g, d, state, seen


def _params_close(module, jparams, what):
    from nunif_tpu_torch.models import to_flax
    got = to_flax(module) if isinstance(module, nn.Module) else module
    want = {k: np.asarray(v) for k, v in flatten_params(jparams).items()}
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * LR,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_gan_step_matches_jax(case):
    cfg_kw = dict(gan_loss=CASES[case][0], r1_interval=2, ema_decay=0.99,
                  generator_start_step=1)
    batch = _batch()
    start, jstate, jweights = _jax_run(case, jgan.GANConfig(**cfg_kw), batch)
    g, d, state, seen = _port(case, tgan.GANConfig(**cfg_kw), start, batch)
    weights = [float(m["disc_weight"]) for m in seen]
    assert weights[0] == 0.0 and jweights[0] == 0.0        # the warmup
    assert all(w > 0 for w in weights[1:])
    np.testing.assert_allclose(weights, jweights, rtol=0, atol=1e-6)
    assert float(state.disc_weight_ema) == pytest.approx(
        float(jstate.disc_weight_ema), abs=1e-6)
    assert state.step == int(jstate.step) == STEPS
    _params_close(g, jstate.g_params, "G")
    _params_close(d, jstate.d_params, "D")
    from nunif_tpu_torch.models.flax_params import _to_flax_layout, flax_keys
    keys = flax_keys(g)
    ema = {keys[n]: _to_flax_layout(n, t.numpy()) for n, t in state.g_ema_params.items()}
    _params_close(ema, jstate.g_ema_params, "G EMA")
    for m in seen:
        assert all(bool(torch.isfinite(v)) for v in m.values())


def test_gan_step_leaves_the_discriminators_grad_alone():
    """The G step takes its gradients with ``torch.autograd.grad`` over the
    generator's parameters: nothing lands in any ``.grad``."""
    start, _s, _w = _jax_run("hinge", jgan.GANConfig(r1_gamma=0.0), _batch())
    g, d, _state, _seen = _port("hinge", tgan.GANConfig(r1_gamma=0.0), start,
                                _batch(), steps=1)
    assert all(p.grad is None for p in (*g.parameters(), *d.parameters()))


def test_r1_on_its_step_and_off_between():
    """From the same start, R1 (gamma 10, every 2 steps) changes the
    discriminator's step on a step count that 2 divides, and nothing on
    one it does not."""
    start, _s, _w = _jax_run("hinge", jgan.GANConfig(), _batch())
    out = {}
    for first in (0, 1):
        for gamma in (0.0, 10.0):
            cfg = tgan.GANConfig(r1_gamma=gamma, r1_interval=2)
            _g, d, _st, _m = _port("hinge", cfg, start, _batch(), steps=1,
                                   first_step=first)
            out[first, gamma] = {n: p.detach().clone() for n, p in d.named_parameters()}
    diff_on = max(float((out[0, 0.0][n] - out[0, 10.0][n]).abs().max()) for n in out[0, 0.0])
    diff_off = max(float((out[1, 0.0][n] - out[1, 10.0][n]).abs().max()) for n in out[1, 0.0])
    assert diff_on > 1e-6 and diff_off == 0.0


def test_gan_config_fields_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(tgan.GANConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jgan.GANConfig)]


# ------------------------------------------------------------ diff augment
def _img(seed=0, shape=(3, 12, 16, 2)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def test_diff_translate_matches_jax():
    x = _img()
    dx, dy = np.array([3, -5, 0]), np.array([-2, 4, 1])
    want = jda.diff_translate(jnp.asarray(x), jnp.asarray(dx), jnp.asarray(dy))
    got = tda.diff_translate(torch.from_numpy(x), torch.from_numpy(dx),
                             torch.from_numpy(dy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rotate_matches_jax():
    x = _img(1)
    a = np.array([0.3, -1.1, 2.5], np.float32)
    want = jda._rotate(jnp.asarray(x), jnp.asarray(a))
    got = tda.rotate(torch.from_numpy(x), torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fn", ["translate", "rotate", "downsample"])
def test_random_pairs_move_both_alike(fn):
    x = torch.from_numpy(_img(2))
    y = 2.0 * x + 1.0
    gen = torch.Generator().manual_seed(5)
    f = {"translate": tda.diff_pair_random_translate,
         "rotate": tda.diff_pair_random_rotate,
         "downsample": tda.diff_pair_random_downsample}[fn]
    ax, ay = f(gen, x, y)
    assert ax.shape == x.shape and ay.shape == y.shape
    # the same transform on both: linear in the image, so y's is 2 x's + T(1)
    ones = f(torch.Generator().manual_seed(5), x, torch.ones_like(x))[1]
    np.testing.assert_allclose(ay.numpy(), 2.0 * ax.numpy() + ones.numpy(),
                               rtol=0, atol=1e-5)
    if fn != "downsample":
        assert not torch.allclose(ax, x)
