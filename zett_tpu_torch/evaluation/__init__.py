"""Evaluation: the perplexity / bits-per-char and multiple-choice CLIs, the
in-training eval loop and the MLM probe."""

from .choice import evaluate_choice_task, score_loglikelihoods
from .loop import eval_loop
from .mlm_probe import mlm_probe
from .perplexity import chunked_tokenize, evaluate_lm

__all__ = ["chunked_tokenize", "eval_loop", "evaluate_choice_task", "evaluate_lm",
           "mlm_probe", "score_loglikelihoods"]
