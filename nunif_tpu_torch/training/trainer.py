"""Trainer: the host side of training (counterpart of
``nunif_tpu/training/trainer.py``).

Owns seeding, the optimizer (``optimizers.create_optimizer``, held to
optax's update rules) and the schedule, the epoch loop with hard-example
feedback once an epoch, evaluation, the CSV loss log, the best model
exported with ``models.save_model`` (a ``.nztm`` both packages read), and
a checkpoint written atomically: one JSON meta line, then ``torch.save``
of the model, the optimizer (moments and counts), the EMA, the step and
NaN counts and the loss generator's state; ``resume`` reads it back.  The
checkpoint is the port's own format (the JAX trainer writes flax msgpack).

The per-batch math is ``env.make_train_step``'s.  Each epoch also records
where its wall time went: steps, samples, the seconds spent waiting on
the host data pipeline for the next batch, and the device's peak memory.
"""
from __future__ import annotations

import contextlib
import csv
import dataclasses
import io
import json
import logging
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..models import save_model
from .env import TrainState, make_eval_step, make_train_step
from .optimizers import create_optimizer
from .schedules import build_schedule

logger = logging.getLogger("nunif_tpu_torch.training")


@dataclasses.dataclass
class TrainerConfig:
    model_dir: str = "models"
    max_epoch: int = 200
    optimizer: str = "adam"
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None
    scheduler: str = "none"
    scheduler_kw: dict = dataclasses.field(default_factory=dict)
    accum_steps: int = 1          # reference --backward-step
    ema_decay: Optional[float] = None
    seed: int = 71
    nan_limit: int = 100          # reference env.py tolerates <= 100 NaNs
    resume: bool = False
    checkpoint_name: str = "checkpoint"


@contextlib.contextmanager
def params_swapped(model, params: Optional[dict]):
    """``model`` with ``params`` {name: tensor} copied into its parameters
    (in place, so the kernels' weight packs see them), then the trained
    ones copied back; nothing for None."""
    if params is None:
        yield model
        return
    own = dict(model.named_parameters())
    with torch.no_grad():
        kept = {n: p.detach().clone() for n, p in own.items()}
        for n, t in params.items():
            own[n].copy_(t)
    try:
        yield model
    finally:
        with torch.no_grad():
            for n, t in kept.items():
                own[n].copy_(t)


class Trainer:
    """Generic trainer:

      trainer = Trainer(cfg, model, loss_fn, eval_fn)
      trainer.fit(train_loader_fn, eval_loader_fn)

    ``model`` is on its training device with its initial weights.
    ``loss_fn(model, batch, generator) -> (loss, aux)``; ``eval_fn(model,
    batch) -> scalar``.  Loaders are callables that return an epoch's
    iterator of batches.  ``eval_params_fn`` maps {name: tensor} -> {name:
    tensor} before evaluation and export."""

    def __init__(self, cfg: TrainerConfig, model, loss_fn: Callable,
                 eval_fn: Optional[Callable] = None,
                 steps_per_epoch: int = 1000,
                 eval_params_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.model = model
        self.eval_params_fn = eval_params_fn
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        schedule = build_schedule(cfg.scheduler, cfg.learning_rate,
                                  steps_per_epoch, **cfg.scheduler_kw)
        self.optimizer = create_optimizer(
            cfg.optimizer, model, schedule, weight_decay=cfg.weight_decay,
            grad_clip=cfg.grad_clip)
        self.state = TrainState.create(model, self.optimizer,
                                       use_ema=cfg.ema_decay is not None)
        self.train_step = make_train_step(loss_fn, accum_steps=cfg.accum_steps,
                                          ema_decay=cfg.ema_decay)
        self.eval_step = make_eval_step(eval_fn) if eval_fn else None
        self.last_epoch = 0
        self.best_score = float("inf")    # lower is better: eval fns negate
        self.epoch_stats = []
        os.makedirs(cfg.model_dir, exist_ok=True)
        self.loss_csv = os.path.join(cfg.model_dir,
                                     f"loss_{int(time.time())}.csv")
        if cfg.resume:
            self._load_checkpoint()

    # ------------------------------------------------------------ checkpoint
    @property
    def checkpoint_path(self):
        return os.path.join(self.cfg.model_dir,
                            f"{self.cfg.checkpoint_name}.ckpt")

    def save_checkpoint(self):
        st = self.state
        blob = io.BytesIO()
        torch.save({"model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "ema": st.ema_params, "step": st.step,
                    "nan_count": st.nan_count,
                    "generator": self.generator.get_state()}, blob)
        meta = {"last_epoch": self.last_epoch, "best_score": self.best_score}
        tmp = self.checkpoint_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(json.dumps(meta).encode() + b"\n")
            f.write(blob.getvalue())
        os.replace(tmp, self.checkpoint_path)
        logger.debug("checkpoint saved: %s", self.checkpoint_path)

    def _load_checkpoint(self):
        if not os.path.exists(self.checkpoint_path):
            logger.info("no checkpoint to resume from: %s", self.checkpoint_path)
            return
        with open(self.checkpoint_path, "rb") as f:
            meta = json.loads(f.readline().decode())
            blob = torch.load(io.BytesIO(f.read()), map_location=self.device,
                              weights_only=True)
        with torch.no_grad():
            self.model.load_state_dict(blob["model"])
        self.optimizer.load_state_dict(blob["optimizer"])
        st = self.state
        if st.ema_params is not None and blob["ema"] is not None:
            for n, t in blob["ema"].items():
                st.ema_params[n].copy_(t)
        st.step, st.nan_count = blob["step"], blob["nan_count"]
        self.generator.set_state(blob["generator"].cpu())
        self.last_epoch = meta["last_epoch"]
        self.best_score = meta["best_score"]
        logger.info("resumed from epoch %d (best %.5f)",
                    self.last_epoch, self.best_score)

    def eval_params(self) -> Optional[dict]:
        """The parameters evaluation and export read, {name: tensor}, or
        None for the trained ones: the EMA, else the optimizer's
        (schedule-free's average), through ``eval_params_fn``."""
        params = self.state.ema_params
        if params is None:
            params = self.optimizer.eval_params()
        if self.eval_params_fn is not None:
            params = self.eval_params_fn(
                params if params is not None else
                {n: p.detach() for n, p in self.model.named_parameters()})
        return params

    def export_best_model(self, params: Optional[dict]):
        path = os.path.join(self.cfg.model_dir,
                            f"{self.model.model_name.replace('.', '_')}.nztm")
        train_kwargs = dataclasses.asdict(self.cfg)
        with params_swapped(self.model, params):
            save_model(self.model, path, train_kwargs=train_kwargs)
        return path

    def evaluate(self, eval_loader_fn: Optional[Callable[[], Iterable]],
                 params: Optional[dict] = None) -> Optional[float]:
        """The mean eval score over ``eval_loader_fn()``'s batches with
        ``params`` swapped in (None: the model's own), or None without an
        eval function or loader."""
        if self.eval_step is None or eval_loader_fn is None:
            return None
        self.model.eval()
        with params_swapped(self.model, params):
            scores = [float(self.eval_step(self.model, b))
                      for b in eval_loader_fn()]
        return float(np.mean(scores))

    # ----------------------------------------------------------------- loop
    def fit(self, train_loader_fn: Callable[[], Iterable],
            eval_loader_fn: Optional[Callable[[], Iterable]] = None,
            on_epoch_end: Optional[Callable] = None, hard_sampler=None):
        """``hard_sampler``: a HardExampleSampler that gets each batch's
        loss for its samples at the epoch's end."""
        cfg = self.cfg
        cuda = self.device.type == "cuda"
        for epoch in range(self.last_epoch, cfg.max_epoch):
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            t0 = time.perf_counter()
            losses, batch_indexes, samples, wait = [], [], 0, 0.0
            self.model.train()
            batches = iter(train_loader_fn())
            while True:
                tw = time.perf_counter()
                batch = next(batches, None)
                wait += time.perf_counter() - tw
                if batch is None:
                    break
                if isinstance(batch, dict) and "index" in batch:
                    batch = dict(batch)
                    batch_indexes.append(batch.pop("index"))
                samples += len(next(iter(batch.values())) if isinstance(batch, dict)
                               else batch[0])
                metrics = self.train_step(self.state, batch, self.generator)
                losses.append(metrics["loss"])
            if cuda:
                torch.cuda.synchronize(self.device)
            train_wall = time.perf_counter() - t0
            if hard_sampler is not None and batch_indexes:
                for idx, loss in zip(batch_indexes, losses):
                    hard_sampler.update_losses(idx, np.full(len(idx), loss))
                hard_sampler.update_weights()
            if self.state.nan_count > cfg.nan_limit:
                raise RuntimeError(f"too many NaN losses: {self.state.nan_count}")
            train_loss = float(np.mean(losses)) if losses else 0.0
            self.epoch_stats.append({
                "epoch": epoch, "steps": len(losses), "samples": samples,
                "train_seconds": train_wall, "data_wait_seconds": wait,
                "peak_memory_bytes": (torch.cuda.max_memory_allocated(self.device)
                                      if cuda else None)})

            params = self.eval_params()
            eval_score = self.evaluate(eval_loader_fn, params)
            self.last_epoch = epoch + 1
            self._log_epoch(epoch, train_loss, eval_score, time.perf_counter() - t0)
            # The best score is settled before the checkpoint is written, so
            # a resumed run compares against this epoch's score too.
            score = eval_score if eval_score is not None else train_loss
            if score < self.best_score:
                self.best_score = score
                self.export_best_model(params)
                logger.info("epoch %d: new best %.5f", epoch, score)
            self.save_checkpoint()
            if on_epoch_end:
                on_epoch_end(self, epoch, train_loss, eval_score)
        return self.state

    def _log_epoch(self, epoch, train_loss, eval_score, elapsed):
        logger.info("epoch %d: train_loss=%.5f eval=%s (%.1fs)", epoch,
                    train_loss,
                    f"{eval_score:.5f}" if eval_score is not None else "-",
                    elapsed)
        new = not os.path.exists(self.loss_csv)
        with open(self.loss_csv, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["epoch", "train_loss", "eval_score", "elapsed_sec"])
            w.writerow([epoch, train_loss, eval_score, round(elapsed, 2)])


def to_device(batch: dict, device, dtypes: Optional[dict] = None) -> dict:
    """A numpy batch {name: array} as tensors on ``device``; ``dtypes``
    {name: torch dtype} casts the named ones."""
    dtypes = dtypes or {}
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        out[k] = t.to(dtypes[k]) if k in dtypes else t
    return out


def epoch_report(trainer: Trainer, epoch, train_loss, eval_score) -> dict:
    """One epoch's losses and where its time went: steps and samples a
    second over the epoch's training wall time, the share of it spent
    waiting on the host data pipeline, peak device memory."""
    st = trainer.epoch_stats[-1]
    wall = st["train_seconds"]
    return {"epoch": epoch, "train_loss": train_loss, "eval_score": eval_score,
            "steps": st["steps"], "samples": st["samples"],
            "steps_per_second": st["steps"] / wall if wall else None,
            "samples_per_second": st["samples"] / wall if wall else None,
            "data_wait_share": st["data_wait_seconds"] / wall if wall else None,
            "peak_memory_bytes": st["peak_memory_bytes"],
            "nan_count": trainer.state.nan_count,
            "device": str(trainer.device)}


def print_epoch_report(trainer: Trainer, epoch, train_loss, eval_score):
    """``on_epoch_end`` hook: prints ``train: {epoch_report as JSON}``."""
    print("train: " + json.dumps(epoch_report(trainer, epoch, train_loss,
                                              eval_score)), flush=True)
