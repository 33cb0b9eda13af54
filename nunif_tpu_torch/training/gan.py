"""GAN training step (counterpart of ``nunif_tpu/training/gan.py``).

The JAX step's semantics, written as one eager PyTorch step:

* one generator forward; the reconstruction loss and the adversarial loss
  (the discriminator's logits of the fake) each get their own
  ``torch.autograd.grad`` over the generator's parameters only, so no
  gradient reaches the discriminator's ``.grad`` from the G step;
* the adaptive weight |grad recon| / |grad gen| (the norm at one
  parameter, or over all of them), clamped to [adaptive_min,
  adaptive_max], smoothed by an EMA that starts at 1.0 and is updated on
  every step, times ``discriminator_weight``, and 0 before
  ``generator_start_step``; the generator steps on recon + weight * gen;
* the discriminator steps on the fake from the generator's parameters
  *before* this step's update (detached), with hinge / bce / softplus /
  mask_hinge losses, a multi-head discriminator's heads weighted by
  ``d_loss_weights``;
* lazy R1 every ``r1_interval`` steps (on the step count before the
  update), its gradient scaled by ``r1_interval``;
* an EMA of the generator's parameters after its update.

The weights and the metrics stay on the device: the step reads nothing
back.  The optimizers are the trainer's (``optimizers.create_optimizer``),
held to optax's update rules, as the JAX step's ``optax`` transforms.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..modules import losses as L
from .ema import ema_init, ema_update


@dataclasses.dataclass
class GANConfig:
    gan_loss: str = "hinge"          # hinge | bce | softplus | mask_hinge
    discriminator_weight: float = 1.0
    adaptive_weight: bool = True
    adaptive_ema_decay: float = 0.98
    adaptive_min: float = 1e-4
    adaptive_max: float = 10.0
    generator_start_step: int = 0    # G warmup: adversarial term off before
    r1_gamma: float = 10.0
    r1_interval: int = 16
    ema_decay: float = 0.0           # > 0 enables the generator's EMA


@dataclasses.dataclass
class GANTrainState:
    """What a step changes besides the two modules and their optimizers:
    the step count, the smoothed adaptive weight (a 0-d fp32 tensor on the
    device) and the generator's EMA {name: tensor} or None."""
    step: int
    disc_weight_ema: torch.Tensor
    g_ema_params: Optional[dict] = None


def _d_loss_fns(kind):
    if kind == "hinge":
        return L.gan_hinge_loss_d, L.gan_hinge_loss_g
    if kind == "mask_hinge":
        # logits come paired with the hole grid; only hole cells count
        def d(real, fake):
            return L.gan_mask_hinge_loss_d(real[0], fake[0], real[1])

        def g(fake):
            return L.gan_mask_hinge_loss_g(fake[0], fake[1])
        return d, g
    if kind == "bce":
        def d(real, fake):
            return L.gan_bce_loss(real, True) + L.gan_bce_loss(fake, False)

        def g(fake):
            return L.gan_bce_loss(fake, True)
        return d, g
    if kind == "softplus":
        return L.gan_softplus_loss_d, L.gan_softplus_loss_g
    raise ValueError(kind)


def _multi(logits):
    return logits if isinstance(logits, (tuple, list)) else (logits,)


def _grads(loss, params, retain=False):
    """d loss / d each of ``params`` (zeros where it does not depend)."""
    got = torch.autograd.grad(loss, params, retain_graph=retain,
                              allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(got, params)]


def _norm(grads):
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


def make_gan_train_step(generator: torch.nn.Module,
                        discriminator: torch.nn.Module,
                        g_apply: Callable, d_apply: Callable,
                        recon_loss_fn: Callable, g_opt, d_opt,
                        cfg: GANConfig, d_loss_weights=(1.0,),
                        last_layer: Optional[str] = None):
    """(init, step) of the GAN step.

    g_apply(generator, batch) -> fake image (NHWC);
    d_apply(discriminator, image, cond[, mask]) -> logits or a tuple of
    them ((logits, hole grid) in mask_hinge mode, which passes
    ``batch["mask"]``); recon_loss_fn(fake, real) -> scalar.  batch: a dict
    of tensors with "y" (the target), optional "cond" and "mask".
    g_opt / d_opt: the optimizers over the modules' parameters.
    last_layer: the generator's parameter whose gradient norms drive the
    adaptive weight (None: the norms over all of them).

    ``init() -> GANTrainState``; ``step(state, batch) ->
    metrics`` {"recon", "gen", "d", "disc_weight"} (0-d tensors on the
    device), updating the modules, the optimizers and ``state`` in place.
    """
    d_loss_fn, g_gan_loss_fn = _d_loss_fns(cfg.gan_loss)
    mask_mode = cfg.gan_loss == "mask_hinge"
    g_names = list(g_opt.params)
    g_params = [g_opt.params[n] for n in g_names]
    d_names = list(d_opt.params)
    d_params = [d_opt.params[n] for n in d_names]
    probe = None if last_layer is None else g_names.index(last_layer)

    def d_call(img, batch):
        if mask_mode:
            return (d_apply(discriminator, img, batch.get("cond"),
                            batch["mask"]),)
        return _multi(d_apply(discriminator, img, batch.get("cond")))

    def norm_at(grads):
        return _norm(grads if probe is None else [grads[probe]])

    def init():
        device = g_params[0].device
        return GANTrainState(
            step=0,
            disc_weight_ema=torch.ones((), dtype=torch.float32, device=device),
            g_ema_params=ema_init(generator) if cfg.ema_decay > 0 else None)

    def step(state: GANTrainState, batch):
        # ---- generator: one forward, two gradients over its parameters
        fake = g_apply(generator, batch)
        recon = recon_loss_fn(fake, batch["y"])
        gen = sum(w * g_gan_loss_fn(lg)
                  for w, lg in zip(d_loss_weights, d_call(fake, batch)))
        g_recon = _grads(recon, g_params, retain=True)
        g_gen = _grads(gen, g_params)
        raw_w = torch.clamp(norm_at(g_recon) / (norm_at(g_gen) + 1e-8),
                            cfg.adaptive_min, cfg.adaptive_max)
        w_ema = (state.disc_weight_ema * cfg.adaptive_ema_decay
                 + raw_w * (1 - cfg.adaptive_ema_decay))
        if state.step >= cfg.generator_start_step:
            weight = (w_ema if cfg.adaptive_weight else 1.0) \
                * cfg.discriminator_weight
        else:
            weight = torch.zeros((), dtype=torch.float32, device=w_ema.device)
        weight = torch.as_tensor(weight, dtype=torch.float32, device=w_ema.device)
        fake = fake.detach()
        g_opt.step({n: a + weight * b
                    for n, a, b in zip(g_names, g_recon, g_gen)})

        # ---- discriminator, on the fake of the parameters before the step
        real_logits = d_call(batch["y"], batch)
        fake_logits = d_call(fake, batch)
        d_loss = sum(w * d_loss_fn(r, f) for w, r, f in
                     zip(d_loss_weights, real_logits, fake_logits))
        d_grads = _grads(d_loss, d_params)
        if cfg.r1_gamma > 0 and state.step % cfg.r1_interval == 0:
            real = batch["y"].detach().requires_grad_(True)
            logits = d_call(real, batch)
            if mask_mode:
                logits = [lg for lg, _m in logits]
            g_img, = torch.autograd.grad(sum(torch.sum(lg) for lg in logits),
                                         real, create_graph=True)
            r1 = (cfg.r1_gamma / 2) * torch.mean(
                torch.sum(g_img.float() ** 2, dim=(1, 2, 3)))
            d_grads = [a + cfg.r1_interval * b
                       for a, b in zip(d_grads, _grads(r1, d_params))]
        d_opt.step(dict(zip(d_names, d_grads)))

        if state.g_ema_params is not None:
            ema_update(state.g_ema_params, generator, cfg.ema_decay)
        state.step += 1
        state.disc_weight_ema = w_ema.detach()
        return {"recon": recon.detach(), "gen": gen.detach(),
                "d": d_loss.detach(), "disc_weight": weight.detach()}

    return init, step
