"""The train state's scalar parts (counterpart of
``zett_tpu/training/state.py``): the micro-step count and the dropout
generator. The parameters live in the Trainer's modules and the optimizer
state in its optimizer (``optimizer.AdamW`` or ``Adafactor``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    step: int
    # draws the hidden-dropout masks and the attention kernels' seeds
    dropout_generator: torch.Generator
