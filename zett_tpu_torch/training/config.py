"""Training configuration (counterpart of ``zett_tpu/training/config.py``:
the same fields and defaults, so the same JSON configs load, and one field
of the port's own, ``remat_hypernet_glue``). The port runs
``backbone_training`` "no" and "full" and the CLM loss; the Trainer raises
for the other settings. Resume and preemption are keys of the CLI's config
(``resume_from_checkpoint``, ``resume_reset_steps``, ``preempt_signal``),
as in the JAX CLI."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union


@dataclass
class TrainingConfig:
    output_dir: str = "out"
    steps: int = 1000
    learning_rate: Union[float, List[float]] = 3e-4
    random_learning_rate: Optional[float] = None
    warmup_steps: Union[int, List[int]] = 100
    random_warmup_steps: int = 0
    learning_rate_alpha: float = 0.1
    weight_decay: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: Optional[float] = 1.0
    use_adafactor: bool = False
    gradient_accumulation_steps: int = 1
    loss: str = "clm"  # "clm" | "mlm"
    lexical_loss_weight: float = 0.0
    lexical_loss_kind: str = "mse"  # "mse" | "rmse" | "huber"
    apply_lexical_loss_to_init: bool = False
    learnable_bias: bool = False
    add_target_priors_to_bias: bool = False
    identity_steps: int = 0
    backbone_training: str = "no"  # "no" | "full"
    run_backbone_in_training_mode: bool = False
    reinit_projectors: bool = False
    seed: int = 0
    logging_steps: int = 50
    save_steps: int = 500
    save_state: bool = True  # periodic checkpoints include opt state/step/rng
    eval_steps: int = 500
    eval_at_step_zero: bool = False
    dtype: str = "float32"
    n_model_parallel: int = 1
    # memory levers: the hypernet's training forward and each backbone
    # block under torch.utils.checkpoint, and the CLM loss (train and eval)
    # computed in chunks of this many positions (0: the whole logits)
    remat_hypernet: bool = False
    loss_chunk_size: int = 0
    remat_backbone: bool = False
    # the port's own lever (no JAX key: XLA's fusion keeps these tensors
    # out of memory there): the hypernet's f32 LayerNorm and gelu glue on
    # the training route keep only their inputs for the backward and
    # recompute the rest (models.hypernet.remat_glue), inside the
    # remat_hypernet recompute too
    remat_hypernet_glue: bool = False
    # batches collated and copied to the device ahead of the step on a
    # thread (0: each batch is pulled between steps)
    prefetch_batches: int = 2
