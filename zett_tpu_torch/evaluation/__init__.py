"""Evaluation: the perplexity / bits-per-char and multiple-choice CLIs and
the in-training eval loop."""

from .choice import evaluate_choice_task, score_loglikelihoods
from .loop import eval_loop
from .perplexity import chunked_tokenize, evaluate_lm

__all__ = ["chunked_tokenize", "eval_loop", "evaluate_choice_task", "evaluate_lm",
           "score_loglikelihoods"]
