"""One eager train step (counterpart of ``nunif_tpu/training/env.py``:
``make_train_step`` / ``make_eval_step``).

``loss_fn(model, batch, generator) -> (loss, aux)`` computes the loss of a
batch; the step follows the JAX step's semantics:

* gradient accumulation: the batch is split into ``accum_steps``
  microbatches along dim 0; the loss and the gradients are their means;
* the NaN guard: a non-finite loss skips the update and leaves the
  parameters, the optimizer's moments and its step count as they were, and
  adds one to ``nan_count``.  The guard reads one flag from the device each
  step (the loss's finiteness, with the loss itself, which the
  hard-example sampler needs anyway);
* EMA after each finite step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .ema import ema_init, ema_update


@dataclasses.dataclass
class TrainState:
    """What a step changes: the model (its parameters), the optimizer, the
    step and NaN counts, the EMA."""
    model: torch.nn.Module
    optimizer: object
    step: int = 0
    nan_count: int = 0
    ema_params: Optional[dict] = None

    @classmethod
    def create(cls, model, optimizer, use_ema=False):
        return cls(model, optimizer,
                   ema_params=ema_init(model) if use_ema else None)


def _split(batch, n):
    """A batch (a tensor, or a tuple / list / dict of tensors) cut into n
    microbatches along dim 0."""
    if isinstance(batch, torch.Tensor):
        return list(batch.chunk(n))
    if isinstance(batch, dict):
        parts = {k: _split(v, n) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    parts = [_split(v, n) for v in batch]
    return [type(batch)(p[i] for p in parts) for i in range(n)]


def make_train_step(loss_fn: Callable, *, accum_steps: int = 1,
                    ema_decay: Optional[float] = None):
    """step(state, batch, generator=None) -> metrics {"loss", "finite",
    aux...} with Python numbers; updates ``state`` in place."""

    def step(state: TrainState, batch, generator=None):
        params = state.optimizer.params
        for p in params.values():
            p.grad = None
        micro = [batch] if accum_steps == 1 else _split(batch, accum_steps)
        loss_sum, aux = 0.0, {}
        for mb in micro:
            loss, aux = loss_fn(state.model, mb, generator)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        loss = loss_sum / accum_steps
        value = float(loss)  # the step's one read from the device
        finite = value == value and abs(value) != float("inf")
        if finite:
            grads = {n: torch.zeros_like(p) if p.grad is None else
                     p.grad / accum_steps if accum_steps > 1 else p.grad
                     for n, p in params.items()}
            state.optimizer.step(grads)
            if state.ema_params is not None and ema_decay is not None:
                ema_update(state.ema_params, state.model, ema_decay)
        else:
            state.nan_count += 1
        for p in params.values():
            p.grad = None
        state.step += 1
        metrics = {"loss": value if finite else 0.0, "finite": finite}
        metrics.update(aux)
        return metrics

    return step


def make_eval_step(metric_fn: Callable):
    """metric_fn(model, batch) -> scalar tensor; run without autograd."""
    def step(model, batch):
        with torch.no_grad():
            return metric_fn(model, batch)
    return step
