"""The trainer's optimizers, held to optax's update rules (the JAX
package's ``training/trainer.py:create_optimizer``): ``adam``, ``adamw``
(decay masked by ``wd_groups``), ``sgd`` (momentum 0.9, Nesterov),
``lion`` and ``schedulefree`` (optax's ``contrib.schedule_free`` over an
``adamw`` with b1 = 0), each behind an optional global-norm clip.

optax and ``torch.optim`` differ in small ways (AdamW's order of decay and
update, where the rate is read, what a skipped step counts), so none of
``torch.optim`` is used: each rule is written out as optax chains it.
The learning rate is the schedule at the step count before the update, on
the host.  Every parameter is written in place (``add_`` / ``copy_``),
which moves its ``_version``: the weight packs of the kernels (K1's,
K2's, the gathered attention bias, ``cast_param``) key on it, so a pack
made after a step is a fresh one.  The moments live on the parameters'
device; a step reads nothing back from it.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .wd_groups import wd_mask


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay ** count in fp32, as optax computes it."""
    return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(count),
                                            dtype=np.float32))


class Optimizer:
    """Base: ``params`` {name: parameter}; ``step(grads)`` updates every
    parameter in place from {name: gradient}.  ``count`` is the number of
    updates made (optax's count); ``state_dict`` / ``load_state_dict`` hold
    the moments and counts."""

    def __init__(self, params: dict, schedule: Callable[[int], float],
                 grad_clip: Optional[float] = None):
        self.params = params
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0

    def _zeros(self):
        return {n: torch.zeros_like(p, memory_format=torch.preserve_format)
                for n, p in self.params.items()}

    def clip(self, grads: dict) -> dict:
        """optax.clip_by_global_norm: unchanged where the global norm is
        below ``grad_clip``, else scaled to it (on the device)."""
        if not self.grad_clip:
            return grads
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
        keep = norm < self.grad_clip
        return {n: torch.where(keep, g, g / norm * self.grad_clip)
                for n, g in grads.items()}

    @torch.no_grad()
    def step(self, grads: dict):
        grads = self.clip(grads)
        updates = self.updates(grads)
        for n, u in updates.items():
            self.params[n].add_(u)
        self.count += 1

    def updates(self, grads: dict) -> dict:
        raise NotImplementedError

    def eval_params(self) -> Optional[dict]:
        """Parameters to evaluate and export, where they are not the
        trained ones (schedule-free); None otherwise."""
        return None

    def state_dict(self) -> dict:
        return {"count": self.count, **{k: v for k, v in vars(self).items()
                                        if k.startswith("s_")}}

    def load_state_dict(self, state: dict):
        for k, v in state.items():
            cur = getattr(self, k, None)
            if isinstance(cur, dict):
                for n, t in v.items():
                    cur[n].copy_(t)
            else:
                setattr(self, k, v)


class Adam(Optimizer):
    """optax.adam / adamw: scale_by_adam, [add_decayed_weights(mask)],
    scale_by_learning_rate."""

    def __init__(self, params, schedule, *, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, mask=None, grad_clip=None):
        super().__init__(params, schedule, grad_clip)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mask = mask
        self.s_mu, self.s_nu = self._zeros(), self._zeros()
        self.s_count = 0  # scale_by_adam's own count

    def direction(self, grads: dict) -> dict:
        """scale_by_adam's update and its moment step."""
        self.s_count += 1
        bc1 = _bias_correction(self.b1, self.s_count)
        bc2 = _bias_correction(self.b2, self.s_count)
        out = {}
        for n, g in grads.items():
            mu, nu = self.s_mu[n], self.s_nu[n]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            out[n] = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        return out

    def decayed(self, updates: dict) -> dict:
        """add_decayed_weights: u + weight_decay * p where the mask is set."""
        if not self.weight_decay:
            return updates
        return {n: u + self.weight_decay * self.params[n]
                if self.mask is None or self.mask[n] else u
                for n, u in updates.items()}

    def updates(self, grads):
        lr = self.schedule(self.count)
        return {n: -lr * u for n, u in self.decayed(self.direction(grads)).items()}


class SGD(Optimizer):
    """optax.sgd(momentum, nesterov): trace, scale_by_learning_rate."""

    def __init__(self, params, schedule, *, momentum=0.9, nesterov=True,
                 grad_clip=None):
        super().__init__(params, schedule, grad_clip)
        self.momentum, self.nesterov = momentum, nesterov
        self.s_trace = self._zeros()

    def updates(self, grads):
        lr = self.schedule(self.count)
        out = {}
        for n, g in grads.items():
            t = self.s_trace[n]
            t.copy_(g + self.momentum * t)
            u = g + self.momentum * t if self.nesterov else t
            out[n] = -lr * u
        return out


class Lion(Optimizer):
    """optax.lion: scale_by_lion, add_decayed_weights(mask),
    scale_by_learning_rate."""

    def __init__(self, params, schedule, *, b1=0.9, b2=0.99, weight_decay=0.0,
                 mask=None, grad_clip=None):
        super().__init__(params, schedule, grad_clip)
        self.b1, self.b2 = b1, b2
        self.weight_decay = weight_decay
        self.mask = mask
        self.s_mu = self._zeros()

    def updates(self, grads):
        lr = self.schedule(self.count)
        out = {}
        for n, g in grads.items():
            mu = self.s_mu[n]
            u = torch.sign((1.0 - self.b1) * g + self.b1 * mu)
            mu.copy_((1 - self.b2) * g + self.b2 * mu)
            if self.weight_decay and (self.mask is None or self.mask[n]):
                u = u + self.weight_decay * self.params[n]
            out[n] = -lr * u
        return out


class ScheduleFree(Optimizer):
    """optax.contrib.schedule_free(adamw(b1=0), b1): the parameters are
    y; z is the base optimizer's sequence and x, the average, is what
    evaluation reads (``eval_params``).  The rate of the averaging weight is
    the schedule at ``s_step_count``, which starts at 1; the base adamw
    reads the schedule at its own count, from 0."""

    def __init__(self, params, schedule, *, b1=0.9, b2=0.999,
                 weight_decay=0.0, mask=None, weight_lr_power=2.0,
                 grad_clip=None):
        super().__init__(params, schedule, grad_clip)
        self.b1 = b1
        self.weight_lr_power = weight_lr_power
        self.base = Adam(params, schedule, b1=0.0, b2=b2,
                         weight_decay=weight_decay, mask=mask)
        self.s_z = {n: p.detach().clone() for n, p in params.items()}
        self.s_weight_sum = 0.0
        self.s_step_count = 1
        self.s_max_lr = 0.0

    def updates(self, grads):
        lr = float(np.float32(self.schedule(self.s_step_count)))
        self.s_max_lr = max(self.s_max_lr, lr)
        weight = float(np.float32(self.s_max_lr) ** np.float32(self.weight_lr_power))
        total = float(np.float32(self.s_weight_sum) + np.float32(weight))
        ck = float(np.float32(weight) / np.float32(total)) if total else 0.0
        base = self.base.updates(grads)
        self.base.count += 1
        b1 = self.b1
        out = {}
        for n, u in base.items():
            y, z = self.params[n], self.s_z[n]
            prev_x = (y - (1.0 - b1) * z) / b1
            z.add_(u)
            x = (1.0 - ck) * prev_x + ck * z
            out[n] = (b1 * x + (1.0 - b1) * z) - y
        self.s_weight_sum = total
        self.s_step_count += 1
        return out

    def eval_params(self):
        """optax.contrib.schedule_free_eval_params: (y - (1 - b1) z) / b1."""
        b1 = self.b1
        return {n: (p.detach() - (1.0 - b1) * self.s_z[n]) / b1
                for n, p in self.params.items()}

    def state_dict(self):
        return {**super().state_dict(), "base": self.base.state_dict()}

    def load_state_dict(self, state):
        state = dict(state)
        self.base.load_state_dict(state.pop("base"))
        super().load_state_dict(state)


OPTIMIZERS = ("adam", "adamw", "sgd", "lion", "schedulefree")


def create_optimizer(name: str, module, schedule, *, weight_decay: float = 0.0,
                     grad_clip: Optional[float] = None, **kw) -> Optimizer:
    """The optimizer ``name`` over ``module``'s parameters that need a
    gradient (the JAX package's ``create_optimizer``, same defaults)."""
    name = name.lower()
    params = {n: p for n, p in module.named_parameters() if p.requires_grad}
    mask = None
    if weight_decay:
        full = wd_mask(module)
        mask = {n: full[n] for n in params}
    if name == "adam":
        return Adam(params, schedule, b1=kw.get("b1", 0.9), b2=kw.get("b2", 0.999),
                    grad_clip=grad_clip)
    if name == "adamw":
        return Adam(params, schedule, b1=kw.get("b1", 0.9), b2=kw.get("b2", 0.999),
                    weight_decay=weight_decay, mask=mask, grad_clip=grad_clip)
    if name == "sgd":
        return SGD(params, schedule, momentum=kw.get("momentum", 0.9),
                   nesterov=kw.get("nesterov", True), grad_clip=grad_clip)
    if name == "lion":
        return Lion(params, schedule, b1=kw.get("b1", 0.9), b2=kw.get("b2", 0.99),
                    weight_decay=weight_decay, mask=mask, grad_clip=grad_clip)
    if name in ("schedulefree", "schedulefree_adamw"):
        return ScheduleFree(params, schedule, b1=kw.get("b1", 0.9),
                            b2=kw.get("b2", 0.999), weight_decay=weight_decay,
                            mask=mask, grad_clip=grad_clip)
    raise ValueError(f"unknown optimizer: {name}")
