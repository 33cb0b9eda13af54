"""Learning-rate schedules (counterpart of ``nunif_tpu/training/schedules.py``).

Each schedule is the learning rate as a function of the optimizer step
(``fn(step) -> float``), as optax evaluates it: at the step count before
the update, 0 for the first.  The trainer converts the reference's
epoch-based settings with ``steps_per_epoch``.  Plain Python on the host:
the port's optimizers keep their step count there, so reading the rate
waits on nothing.
"""
from __future__ import annotations

import math
from typing import Sequence


def step_lr(base_lr: float, step_size_epochs: int, gamma: float,
            steps_per_epoch: int):
    def fn(step):
        epoch = step // steps_per_epoch
        return base_lr * (gamma ** (epoch // step_size_epochs))
    return fn


def multistep_lr(base_lr: float, milestones_epochs: Sequence[int],
                 gamma: float, steps_per_epoch: int):
    milestones = sorted(milestones_epochs)

    def fn(step):
        epoch = step // steps_per_epoch
        return base_lr * (gamma ** sum(int(epoch >= m) for m in milestones))
    return fn


def cosine_warm_restarts(base_lr: float, t_0_epochs: int, steps_per_epoch: int,
                         t_mult: int = 1, eta_min: float = 0.0):
    """CosineAnnealingWarmRestarts (torch semantics), by step."""
    t0 = max(1, t_0_epochs * steps_per_epoch)

    def fn(step):
        if t_mult == 1:
            t_cur = step % t0
            t_i = t0
        else:
            n = math.floor(math.log(max(step / t0 * (t_mult - 1) + 1, 1))
                           / math.log(t_mult))
            t_start = t0 * (t_mult ** n - 1) / (t_mult - 1)
            t_i = t0 * t_mult ** n
            t_cur = step - t_start
        return eta_min + (base_lr - eta_min) * (
            1 + math.cos(math.pi * t_cur / t_i)) / 2
    return fn


def with_warmup(schedule_fn, warmup_steps: int, init_scale: float = 1e-8):
    """Linear warmup over ``warmup_steps`` in front of ``schedule_fn``."""
    def fn(step):
        base = schedule_fn(step)
        if warmup_steps <= 0:
            return base
        return base * min(1.0, init_scale + (1 - init_scale) * (step / warmup_steps))
    return fn


def constant_lr(base_lr: float):
    return lambda step: base_lr


def build_schedule(name: str, base_lr: float, steps_per_epoch: int, **kw):
    name = (name or "none").lower()
    if name in ("none", "constant"):
        sched = constant_lr(base_lr)
    elif name == "step":
        sched = step_lr(base_lr, kw.get("step_size", 1),
                        kw.get("gamma", 0.9), steps_per_epoch)
    elif name == "multistep":
        sched = multistep_lr(base_lr, kw.get("milestones", [1]),
                             kw.get("gamma", 0.1), steps_per_epoch)
    elif name in ("cosine", "cosine_warm_restarts", "cosine_wd"):
        sched = cosine_warm_restarts(base_lr, kw.get("t_0", 1),
                                     steps_per_epoch,
                                     t_mult=kw.get("t_mult", 1),
                                     eta_min=kw.get("eta_min", base_lr * 1e-3))
    else:
        raise ValueError(f"unknown scheduler: {name}")
    warmup_epochs = kw.get("warmup_epochs", 0)
    if warmup_epochs:
        sched = with_warmup(sched, warmup_epochs * steps_per_epoch)
    return sched
