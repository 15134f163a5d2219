"""Training (``founddiff_tpu/train``).  The port keeps its state in the
modules and the optimizer, so the JAX pytrees ``EmaState`` and
``TrainState`` have no counterpart."""

from founddiff_tpu_torch.train.ema import ema_decay_schedule, ema_update
from founddiff_tpu_torch.train.state import make_optimizer
from founddiff_tpu_torch.train.trainer import Trainer

__all__ = [
    "Trainer",
    "ema_decay_schedule",
    "ema_update",
    "make_optimizer",
]
