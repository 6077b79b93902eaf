"""Two-phase learning-rate schedules (counterpart of
``zett_tpu/training/schedules.py``) as plain functions of the step.

Randomly initialized params warm up first at ``random_learning_rate``;
pretrained params stay at 0 until the first boundary; both then follow
linear warmup(s) into a cosine decay. The arithmetic is optax's
(``linear_schedule``, ``cosine_decay_schedule``, ``join_schedules``) in
float32, as the JAX package evaluates it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

f32 = np.float32
Schedule = Callable[[int], np.float32]


def _linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: f32(init_value)

    def schedule(count):
        count = min(max(int(count), 0), transition_steps)
        frac = f32(1) - f32(count) / f32(transition_steps)
        return f32(init_value - end_value) * frac + f32(end_value)

    return schedule


def _cosine_decay(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    def schedule(count):
        count = f32(min(float(count), float(decay_steps)))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * count / f32(decay_steps)))
        decayed = f32(1 - alpha) * cosine + f32(alpha)
        return f32(init_value) * decayed

    return schedule


def _join(schedules, boundaries) -> Schedule:
    def schedule(step):
        output = schedules[0](step)
        for boundary, fn in zip(boundaries, schedules[1:]):
            output = output if step < boundary else fn(step - boundary)
        return f32(output)

    return schedule


def create_learning_rate_fn(cfg) -> Tuple[Schedule, Schedule]:
    """(random_fn, pretrained_fn): step -> learning rate."""
    warmup_steps = cfg.warmup_steps if isinstance(cfg.warmup_steps, list) else [cfg.warmup_steps]
    learning_rate = (cfg.learning_rate if isinstance(cfg.learning_rate, list)
                     else [cfg.learning_rate] * len(warmup_steps))
    random_lr = cfg.random_learning_rate or learning_rate[0]

    random_warmup_fn = _linear(0.0, random_lr, cfg.random_warmup_steps)
    warmup_fns = []
    boundaries = [cfg.random_warmup_steps]
    for i, boundary in enumerate(warmup_steps):
        warmup_fns.append(_linear(0.0, learning_rate[i], boundary - boundaries[-1]))
        boundaries.append(boundary)
    decay_fn = _cosine_decay(learning_rate[-1], max(cfg.steps - warmup_steps[-1], 1),
                             cfg.learning_rate_alpha)
    join_boundaries = [cfg.random_warmup_steps, *warmup_steps]
    random_fn = _join([random_warmup_fn, *warmup_fns, decay_fn], join_boundaries)
    pretrained_fn = _join([lambda count: f32(0.0), *warmup_fns, decay_fn], join_boundaries)
    return random_fn, pretrained_fn
