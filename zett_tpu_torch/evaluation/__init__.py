"""Evaluation: the in-training eval loop."""

from .loop import eval_loop

__all__ = ["eval_loop"]
