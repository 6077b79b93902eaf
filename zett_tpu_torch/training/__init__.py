"""Hypernet training: losses, schedules, the optimizer, the Trainer and the
CLI (``python -m zett_tpu_torch.training CONFIG.json``)."""

from .config import TrainingConfig
from .engine import Trainer

__all__ = ["Trainer", "TrainingConfig"]
