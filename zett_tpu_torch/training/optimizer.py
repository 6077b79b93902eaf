"""The optimizer (counterpart of ``zett_tpu/training/optimizer.py``): freeze
labels, the weight-decay mask, global-norm clipping, AdamW and k-step
gradient accumulation, with optax's arithmetic.

The JAX package builds ``MultiSteps(chain(clip_by_global_norm,
multi_transform({"train": adamw, "freeze": set_to_zero})))`` over the whole
parameter tree ``{"hypernet", "inner"}``. Two consequences the port keeps:
the clip's global norm covers every gradient, the frozen backbone's and the
rescalers' included, before the frozen ones are zeroed; and frozen
parameters are never written. Parameters are addressed by their Flax path
tuples, in the order JAX flattens the tree (sorted keys), which is also the
order of the norm's sum.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _is_norm_module(segment: str) -> bool:
    s = segment.lower()
    return (s in ("norm", "ln") or s.startswith("ln_") or "layernorm" in s
            or "layer_norm" in s or "rmsnorm" in s)


def decay_mask_fn(path: Path) -> bool:
    """True where weight decay applies: every param except biases and any
    param inside a normalization module (``optimizer.py:24``)."""
    return path[-1] != "bias" and not any(_is_norm_module(seg) for seg in path)


# the affine rescalers are calibrated once and never updated
ALWAYS_FROZEN_MODULES = frozenset({"scaler", "in_scaler", "out_scaler"})


def get_label(path: Path, backbone_training: str = "no") -> str:
    """"train" or "freeze" for a full path ("hypernet"/"inner", ...)
    (``optimizer.py:44``)."""
    trainable_roots = {"hypernet"}
    if backbone_training == "full":
        trainable_roots.add("inner")
    if ALWAYS_FROZEN_MODULES.intersection(path):
        return "freeze"
    return "train" if path[0] in trainable_roots else "freeze"


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the left-to-right sum of each leaf's
    sum of squares, each leaf's sum in its own dtype."""
    total = None
    for g in grads:
        s = (g * g).sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


class AdamW:
    """Clip, then AdamW on the "train" parameters (decoupled decay on the
    masked ones), with optional k-step accumulation as ``optax.MultiSteps``
    (mean of the k micro-step gradients, one update every k calls).

    params: Flax path -> parameter, in any order. ``step(grads)`` takes
    gradients for every path (None counts as zeros) and updates the
    parameters in place."""

    def __init__(self, params: Dict[Path, torch.nn.Parameter], cfg,
                 learning_rate_fn: Callable[[int], np.float32]):
        self.paths = sorted(params)
        self.params = params
        self.cfg = cfg
        self.lr_fn = learning_rate_fn
        self.train = [p for p in self.paths if get_label(p, cfg.backbone_training) == "train"]
        self.mu = {p: torch.zeros_like(params[p]) for p in self.train}
        self.nu = {p: torch.zeros_like(params[p]) for p in self.train}
        self.count = 0  # adam updates made (also the schedule's count)
        self.k = max(int(cfg.gradient_accumulation_steps), 1)
        self.mini_step = 0
        self.acc: Optional[Dict[Path, torch.Tensor]] = None

    @torch.no_grad()
    def step(self, grads: Dict[Path, Optional[torch.Tensor]]) -> None:
        """One micro step: with k-step accumulation the parameters change
        on every k-th call only."""
        grads = {p: (grads.get(p) if grads.get(p) is not None
                     else torch.zeros_like(self.params[p])) for p in self.paths}
        if self.k > 1:
            n = self.mini_step
            if self.acc is None:
                self.acc = {p: torch.zeros_like(g) for p, g in grads.items()}
            self.acc = {p: self.acc[p] + (grads[p] - self.acc[p]) / (n + 1) for p in self.paths}
            self.mini_step = (n + 1) % self.k
            if n != self.k - 1:
                return
            grads, self.acc = self.acc, None
        self._update(grads)

    def _update(self, grads: Dict[Path, torch.Tensor]) -> None:
        cfg = self.cfg
        max_norm = cfg.max_grad_norm
        if max_norm is not None:
            g_norm = global_norm(grads[p] for p in self.paths)
            if not bool(g_norm < max_norm):
                grads = {p: (g / g_norm.to(g.dtype)) * max_norm for p, g in grads.items()}
        b1, b2, eps, wd = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_epsilon, cfg.weight_decay
        lr = self.lr_fn(self.count)
        self.count += 1
        bc1 = np.float32(1) - np.float32(b1) ** np.float32(self.count)
        bc2 = np.float32(1) - np.float32(b2) ** np.float32(self.count)
        for p in self.train:
            g = grads[p]
            param = self.params[p]
            mu = (1 - b1) * g + b1 * self.mu[p]
            nu = (1 - b2) * (g * g) + b2 * self.nu[p]
            self.mu[p], self.nu[p] = mu, nu
            mu_hat = mu / torch.tensor(bc1, dtype=mu.dtype, device=mu.device)
            nu_hat = nu / torch.tensor(bc2, dtype=nu.dtype, device=nu.device)
            u = mu_hat / (torch.sqrt(nu_hat) + eps)
            if decay_mask_fn(p[1:]):
                u = u + wd * param
            u = torch.tensor(-lr, dtype=u.dtype, device=u.device) * u
            param.copy_((param + u).to(param.dtype))
