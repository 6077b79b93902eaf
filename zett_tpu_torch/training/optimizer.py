"""The optimizer (counterpart of ``zett_tpu/training/optimizer.py``): freeze
labels, the weight-decay mask, global-norm clipping, AdamW or Adafactor,
and k-step gradient accumulation, with optax's arithmetic.

The JAX package builds ``MultiSteps(chain(clip_by_global_norm,
multi_transform({"train": adamw | adafactor, "freeze": set_to_zero})))``
over the whole parameter tree ``{"hypernet", "inner"}``. Two consequences
the port keeps:
the clip's global norm covers every gradient, the frozen backbone's and the
rescalers' included, before the frozen ones are zeroed; and frozen
parameters are never written. Parameters are addressed by their Flax path
tuples, in the order JAX flattens the tree (sorted keys), which is also the
order of the norm's sum. The update rules see each parameter, its gradient
and its state in the Flax layout (Dense kernels (in, out)), since
Adafactor's factored statistics depend on it; the optimizer state is
keyed by "<slot>/<Flax path>" for checkpoints (``state_arrays``).

Under FSDP (``parallel.sharding.shard_backbone``) a backbone parameter is a
DTensor sharded on its first axis: the update rules run on each rank's
local shard (AdamW is elementwise), the clip's global norm adds the
shards' sums of squares over the ranks (one all-reduce a step), and
``state_arrays`` gathers the whole tensors. Adafactor's factored
statistics need whole rows and columns, so a trained sharded parameter
that Adafactor would factor raises ``ValueError`` (ROADMAP A.18).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..parallel.sharding import full_tensor, is_sharded, local_chunk, local_part

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


def global_norm(grads: Iterable[torch.Tensor], sharded: Iterable[bool] = ()) -> torch.Tensor:
    """optax.global_norm: sqrt of the left-to-right sum of each leaf's
    sum of squares, each leaf's sum in its own dtype (its squares in it,
    accumulated in f32 and rounded once, as a bf16 reduction does). A leaf
    flagged in ``sharded`` holds a rank's shard: its f32 sums are added over
    the ranks (one all-reduce for all of them) before that rounding, so a
    sharded leaf rounds as a whole one does."""
    grads = list(grads)
    flags = list(sharded) or [False] * len(grads)
    sums = [(g * g).sum(dtype=torch.float32) for g in grads]
    parts = [i for i, f in enumerate(flags) if f]
    if parts:
        import torch.distributed as dist

        buf = torch.stack([sums[i] for i in parts])
        dist.all_reduce(buf)
        for j, i in enumerate(parts):
            sums[i] = buf[j]
    total = None
    for s, g in zip(sums, grads):
        s = s.to(g.dtype)
        total = s if total is None else total + s
    return torch.sqrt(total)


class _Optimizer:
    """Clip, then the update rule on the "train" parameters (``_apply``),
    with optional k-step accumulation as ``optax.MultiSteps`` (mean of the k
    micro-step gradients, one update every k calls).

    params: Flax path -> parameter, in any order; ``transposed``: the paths
    whose parameter is held transposed against the Flax layout (the
    hypernet's ``nn.Linear`` weights). ``step(grads)`` takes gradients for
    every path (None counts as zeros) and updates the parameters in place;
    a sharded parameter and its gradient are taken as the local shard."""

    name = ""
    slots: Tuple[str, ...] = ()

    def __init__(self, params: Dict[Path, torch.nn.Parameter], cfg,
                 learning_rate_fn: Callable[[int], np.float32],
                 transposed: Iterable[Path] = ()):
        self.paths = sorted(params)
        self.params = params
        self.cfg = cfg
        self.lr_fn = learning_rate_fn
        self.transposed = frozenset(transposed)
        self.train = [p for p in self.paths if get_label(p, cfg.backbone_training) == "train"]
        self.sharded = frozenset(p for p in self.paths if is_sharded(params[p]))
        for p in self.train:
            if p in self.sharded:
                self._check_sharded(p, params[p].shape)
        self.state: Dict[str, Dict[Path, torch.Tensor]] = {slot: {} for slot in self.slots}
        for p in self.train:
            for slot, value in self._init(self.local_view(p, params[p])).items():
                self.state[slot][p] = value
        self.count = 0  # updates made (also the schedule's count)
        self.k = max(int(cfg.gradient_accumulation_steps), 1)
        self.mini_step = 0
        self.acc: Optional[Dict[Path, torch.Tensor]] = None

    def flax_view(self, path: Path, t: torch.Tensor) -> torch.Tensor:
        """``t`` in the Flax layout (a view)."""
        return t.t() if path in self.transposed else t

    def local_view(self, path: Path, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``t`` (all of it unless sharded) in the Flax
        layout (a view)."""
        return self.flax_view(path, local_part(t))

    def _check_sharded(self, path: Path, shape) -> None:
        """Where a rule cannot run on a shard."""

    def _init(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _apply(self, path: Path, g: torch.Tensor, param: torch.Tensor, lr, count: int):
        """The new value of ``param`` (Flax layout) after update ``count``
        (0-based) with learning rate ``lr``."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: Dict[Path, Optional[torch.Tensor]]) -> None:
        """One micro step: with k-step accumulation the parameters change
        on every k-th call only."""
        grads = {p: (local_part(grads[p]) if grads.get(p) is not None
                     else torch.zeros_like(local_part(self.params[p]))) for p in self.paths}
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
        max_norm = self.cfg.max_grad_norm
        if max_norm is not None:
            g_norm = global_norm([grads[p] for p in self.paths],
                                 [p in self.sharded for p in self.paths])
            if not bool(g_norm < max_norm):
                grads = {p: (g / g_norm.to(g.dtype)) * max_norm for p, g in grads.items()}
        count = self.count
        lr = self.lr_fn(count)
        self.count += 1
        for p in self.train:
            param = self.local_view(p, self.params[p])
            new = self._apply(p, self.flax_view(p, grads[p]), param, lr, count)
            param.copy_(new.to(param.dtype))

    # ------------------------------------------------------------ checkpoints
    def state_arrays(self) -> Dict[str, torch.Tensor]:
        """Every state tensor under "<slot>/<Flax path>" in the Flax layout,
        whole: a sharded parameter's state is gathered from the ranks (a
        collective every rank calls)."""
        return {f"{slot}/{'/'.join(p)}": self._whole(p, t) for slot, per in self.state.items()
                for p, t in per.items()}

    def _whole(self, path: Path, t: torch.Tensor) -> torch.Tensor:
        if path not in self.sharded:
            return t
        return self.flax_view(path, full_tensor(self.flax_view(path, t), self.params[path]))

    def scalars(self) -> Dict[str, object]:
        """The update count and the optimizer's name; the state is taken
        at an update boundary, where no gradients are being accumulated."""
        if self.mini_step:
            raise ValueError(f"optimizer state taken after {self.mini_step} of {self.k} "
                             "accumulated micro steps")
        return {"optimizer": self.name, "count": self.count}

    @torch.no_grad()
    def load_state(self, arrays: Dict[str, np.ndarray], scalars: Dict[str, object]) -> None:
        """Inverse of ``state_arrays`` and ``scalars``: each array is copied
        into the live tensor of its key (dtype and device kept)."""
        if scalars["optimizer"] != self.name:
            raise ValueError(f"checkpoint holds {scalars['optimizer']} state; the run "
                             f"uses {self.name}")
        live = {f"{slot}/{'/'.join(p)}" for slot, per in self.state.items() for p in per}
        missing = sorted(live - set(arrays))
        if missing:
            raise KeyError(f"optimizer state missing from the checkpoint: {missing[:5]}")
        for slot, per in self.state.items():
            for p, t in per.items():
                value = torch.from_numpy(np.asarray(arrays[f"{slot}/{'/'.join(p)}"]))
                if p in self.sharded:
                    value = self.flax_view(p, local_chunk(self.flax_view(p, value),
                                                          self.params[p]))
                t.copy_(value)
        self.count = int(scalars["count"])
        self.mini_step, self.acc = 0, None


class AdamW(_Optimizer):
    """``optax.adamw`` (decoupled decay on the masked parameters)."""

    name = "adamw"
    slots = ("mu", "nu")

    def _init(self, param):
        return {"mu": torch.zeros_like(param), "nu": torch.zeros_like(param)}

    def _apply(self, path, g, param, lr, count):
        cfg = self.cfg
        b1, b2, eps, wd = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_epsilon, cfg.weight_decay
        bc1 = np.float32(1) - np.float32(b1) ** np.float32(count + 1)
        bc2 = np.float32(1) - np.float32(b2) ** np.float32(count + 1)
        mu = (1 - b1) * g + b1 * self.state["mu"][path]
        nu = (1 - b2) * (g * g) + b2 * self.state["nu"][path]
        self.state["mu"][path].copy_(mu)
        self.state["nu"][path].copy_(nu)
        mu_hat = mu / torch.tensor(bc1, dtype=mu.dtype, device=mu.device)
        nu_hat = nu / torch.tensor(bc2, dtype=nu.dtype, device=nu.device)
        u = mu_hat / (torch.sqrt(nu_hat) + eps)
        if decay_mask_fn(path[1:]):
            u = u + wd * param
        u = torch.tensor(-lr, dtype=u.dtype, device=u.device) * u
        return param + u


# optax.adafactor's defaults, as the JAX package calls it
# (``optimizer.py:64-69``: learning rate, weight_decay_rate and its mask)
ADAFACTOR_MIN_DIM_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP = 1.0
ADAFACTOR_MIN_SCALE = 1e-3


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """(d1, d0): the second-largest and the largest axis when both hold at
    least ``ADAFACTOR_MIN_DIM_TO_FACTOR`` (``factorized._factored_dims``,
    ties broken by numpy's argsort as there), else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _block_rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


class Adafactor(_Optimizer):
    """``optax.adafactor(learning_rate, weight_decay_rate=weight_decay,
    weight_decay_mask=decay_mask_fn)``: a factored second-moment estimate
    (row and column means of g^2 + eps) for parameters with two axes of at
    least 128, a full one otherwise, with the decay 1 - t^-0.8 at update t;
    the update g / sqrt(v) clipped to a block RMS of 1, scaled by the
    learning rate and by the parameter's block RMS (at least 1e-3); then
    the weight decay rate times the parameter added (after the scaling, not
    multiplied by the learning rate); then subtracted. Second moments are
    held in the parameter's dtype and mixed in f32."""

    name = "adafactor"
    slots = ("v_row", "v_col", "v")

    def _check_sharded(self, path, shape):
        if factored_dims(tuple(self.flax_view(path, torch.empty(shape, device="meta")).shape)):
            raise ValueError(
                f"Adafactor factors {'/'.join(path)} {tuple(shape)}, which FSDP shards over the "
                "ranks: its row and column statistics need the whole tensor (ROADMAP A.18); "
                "use AdamW, or train on one rank")

    def _init(self, param):
        dims = factored_dims(param.shape)
        if dims is None:
            return {"v": torch.zeros_like(param)}
        d1, d0 = dims
        shape = list(param.shape)
        row = shape[:d0] + shape[d0 + 1:]
        col = shape[:d1] + shape[d1 + 1:]
        return {"v_row": param.new_zeros(row), "v_col": param.new_zeros(col)}

    def _apply(self, path, g, param, lr, count):
        t = np.float32(count + 1)
        decay = float(np.float32(1) - t ** np.float32(-ADAFACTOR_DECAY_RATE))
        keep = float(np.float32(1) - np.float32(decay))
        grad_sqr = g * g + ADAFACTOR_EPS
        dims = factored_dims(param.shape)
        if dims is not None:
            d1, d0 = dims
            v_row, v_col = self.state["v_row"][path], self.state["v_col"][path]
            new_row = (decay * v_row.float() + keep * grad_sqr.mean(dim=d0).float()).to(v_row.dtype)
            new_col = (decay * v_col.float() + keep * grad_sqr.mean(dim=d1).float()).to(v_col.dtype)
            v_row.copy_(new_row)
            v_col.copy_(new_col)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (new_row / new_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
            u = g * row_factor.unsqueeze(d0) * (new_col ** -0.5).unsqueeze(d1)
        else:
            v = self.state["v"][path]
            new_v = (decay * v.float() + keep * grad_sqr.float()).to(v.dtype)
            v.copy_(new_v)
            u = g * new_v ** -0.5
        u = u / torch.clamp(_block_rms(u) / ADAFACTOR_CLIP, min=1.0)
        u = torch.tensor(lr, dtype=u.dtype, device=u.device) * u
        rms = _block_rms(param)
        u = u * torch.where(rms <= ADAFACTOR_MIN_SCALE,
                            torch.tensor(ADAFACTOR_MIN_SCALE, dtype=rms.dtype, device=rms.device),
                            rms)
        if decay_mask_fn(path[1:]):
            u = u + self.cfg.weight_decay * param
        return param + (-u)


def build_optimizer(params: Dict[Path, torch.nn.Parameter], cfg,
                    learning_rate_fn: Callable[[int], np.float32],
                    transposed: Iterable[Path] = ()) -> _Optimizer:
    """``optimizer.py:63``: Adafactor with ``use_adafactor``, else AdamW."""
    cls = Adafactor if cfg.use_adafactor else AdamW
    return cls(params, cfg, learning_rate_fn, transposed)
