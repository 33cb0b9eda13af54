"""The training framework (counterpart of ``nunif_tpu/training``): the
eager train step, the trainer, the optimizers held to optax's rules, the
schedules, the hard-example sampler, EMA and the weight-decay mask; the
GAN step (``gan.py``) and the softmax confusion matrix
(``confusion_matrix.py``)."""
from .env import TrainState, make_train_step, make_eval_step
from .trainer import Trainer, TrainerConfig
from .optimizers import create_optimizer
from .schedules import build_schedule
from .sampler import HardExampleSampler, MiningMethod
from .ema import ema_init, ema_update
from .wd_groups import wd_mask

__all__ = [
    "TrainState", "make_train_step", "make_eval_step",
    "Trainer", "TrainerConfig", "create_optimizer", "build_schedule",
    "HardExampleSampler", "MiningMethod", "ema_init", "ema_update", "wd_mask",
]
