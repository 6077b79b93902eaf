"""Training losses (counterpart of ``zett_tpu/training/losses.py``): the
causal and masked LM losses (with the CLM eval's bits-per-byte term and the
MLM eval's accuracy), their chunked forms that never hold the (B, L, V)
logits, and the lexical loss that anchors single-source-token predictions
to the source embeddings.

Under ranks (``parallel``) each loss is a global mean: a rank's loss is its
share, its own sum over the global count (the ``count`` arguments, from
``token_count`` summed over the ranks), so the shares add up to the mean
one process computes; the eval metrics come as (sum, count) ``parts`` that
the trainer sums over the ranks before it divides (``finish_parts``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..constants import EPSILON


def _cross_entropy(logits, labels):
    """optax.softmax_cross_entropy_with_integer_labels: logsumexp - logit."""
    label_logits = logits.gather(-1, labels[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - label_logits


def _bpb_parts(per_seq_loss, byte_lengths):
    """(sum, count) of the mean per-sequence loss per byte over the
    sequences that have bytes (``losses.py:167``): padded eval rows (byte
    length 0) count in neither."""
    per_seq_bytes = byte_lengths.sum(-1).float()
    valid = per_seq_bytes > 0
    per_seq = torch.where(valid, per_seq_loss / torch.clamp(per_seq_bytes, min=1.0),
                          torch.zeros((), dtype=per_seq_loss.dtype, device=per_seq_loss.device))
    return per_seq.sum(), valid.sum()


def finish_parts(parts):
    """{name: sum / count} of ``{name: (sum, count, clamp)}``, the count
    clamped at 1 where ``clamp``."""
    return {k: num / (torch.clamp(den, min=1) if clamp else den)
            for k, (num, den, clamp) in parts.items()}


def token_count(labels, attention_mask, loss_mode: str):
    """The positions a loss of ``loss_mode`` counts (f32): the attended
    positions but the last (clm), the labelled attended ones (mlm)."""
    if loss_mode == "clm":
        return attention_mask[..., :-1].float().sum()
    return _mlm_mask(labels, attention_mask).float().sum()


def lm_loss(logits, labels, attention_mask, loss_mode: str, byte_lengths=None,
            with_bpb: bool = False, count=None):
    """``losses.py:183``. clm: the mean next-token cross entropy over
    attended positions; with ``with_bpb``, (loss, mean bits-per-byte term)
    from the per-sequence loss sums and the tokens' byte lengths (B, L).
    mlm: the mean cross entropy over the attended positions whose label is
    not -100. logits (B, L, V) f32. ``count``: the count to divide by in
    place of this batch's own (a rank's share of the global mean)."""
    if with_bpb:
        return tuple(finish_parts(lm_eval_parts(logits, labels, attention_mask, loss_mode,
                                                byte_lengths)).values())
    if loss_mode == "clm":
        shift_logits = logits[..., :-1, :]
        shift_labels = labels[..., 1:].long().clamp(min=0)
        shift_mask = attention_mask[..., :-1].to(logits.dtype)
        loss = _cross_entropy(shift_logits, shift_labels) * shift_mask
        return loss.sum() / (shift_mask.sum() if count is None else count)
    if loss_mode == "mlm":
        label_mask = _mlm_mask(labels, attention_mask).to(logits.dtype)
        loss = _cross_entropy(logits, labels.long().clamp(min=0)) * label_mask
        return loss.sum() / (label_mask.sum() if count is None else count)
    raise ValueError(f"unknown loss mode {loss_mode}")


def lm_eval_parts(logits, labels, attention_mask, loss_mode: str, byte_lengths=None):
    """The eval metrics as ``{name: (sum, count, clamp)}`` (``finish_parts``):
    clm the loss and the bits-per-byte term (``engine.py:589-592``), mlm the
    loss and the accuracy (``engine.py:593-596``)."""
    if loss_mode == "clm":
        shift_mask = attention_mask[..., :-1].to(logits.dtype)
        loss = _cross_entropy(logits[..., :-1, :], labels[..., 1:].long().clamp(min=0)) \
            * shift_mask
        return {"eval_loss": (loss.sum(), shift_mask.sum(), False),
                "eval_bpb": (*_bpb_parts(loss.sum(-1), byte_lengths), True)}
    if loss_mode != "mlm":
        raise ValueError(f"unknown loss mode {loss_mode}")
    label_mask = _mlm_mask(labels, attention_mask)
    maskf = label_mask.to(logits.dtype)
    loss = _cross_entropy(logits, labels.long().clamp(min=0)) * maskf
    hits = (logits.argmax(-1) == labels) & label_mask
    return {"eval_loss": (loss.sum(), maskf.sum(), False),
            "eval_accuracy": (hits.sum(), label_mask.sum(), True)}


def _clm_chunks(hidden, labels, attention_mask, chunk_size: int):
    """The shifted CLM operands padded to whole chunks of positions
    (``losses.py:25-35``): (h, y, m, [(start, end), ...]). h (B, L-1+pad,
    H), y (B, L-1+pad) int64 labels clamped at 0, m (B, L-1+pad) f32."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size {chunk_size} must be positive")
    L1 = hidden.shape[1] - 1
    pad = (-L1) % chunk_size
    h = F.pad(hidden[:, :-1], (0, 0, 0, pad))
    y = F.pad(labels[:, 1:].long().clamp(min=0), (0, pad))
    m = F.pad(attention_mask[:, :-1].float(), (0, pad))
    bounds = [(s, s + chunk_size) for s in range(0, L1 + pad, chunk_size)]
    return h, y, m, bounds


def _chunk_ce(h_c, y_c, m_c, head_w, logit_offset):
    """Masked per-position cross entropy of one chunk (B, C): logits in the
    compute dtype, then f32 with the offset added (``losses.py:37-42``)."""
    logits = (h_c @ head_w.t()).float() + logit_offset[None, None, :]
    return _cross_entropy(logits, y_c) * m_c


def _chunk_ce_sum(h_c, y_c, m_c, head_w, logit_offset):
    return _chunk_ce(h_c, y_c, m_c, head_w, logit_offset).sum()


def chunked_clm_loss(hidden, head_w, logit_offset, labels, attention_mask, chunk_size: int,
                     count=None):
    """The CLM loss from the final hidden states without the (B, L, V)
    logits (``losses.py:12``): each chunk of ``chunk_size`` positions
    computes its logits ``hidden @ head_w.T + logit_offset`` and its masked
    cross-entropy sum under ``checkpoint``, so autograd keeps the chunk's
    inputs and not its logits, and the backward recomputes them. Equal to
    ``lm_loss(logits, ..., "clm")`` on the whole logits up to summation
    order. hidden (B, L, H); head_w (V, H); logit_offset (V,) f32;
    ``count`` as ``lm_loss``'s."""
    h, y, m, bounds = _clm_chunks(hidden, labels, attention_mask, chunk_size)
    w = head_w.to(h.dtype)
    offset = logit_offset.float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s, e in bounds:
        total = total + checkpoint(_chunk_ce_sum, h[:, s:e], y[:, s:e], m[:, s:e], w, offset,
                                   use_reentrant=False)
    return total / torch.clamp(m.sum() if count is None else count, min=1.0)


@torch.no_grad()
def chunked_clm_eval(hidden, head_w, logit_offset, labels, attention_mask, byte_lengths,
                     chunk_size: int, parts: bool = False):
    """Forward-only chunked CLM eval (``losses.py:93``): (loss, mean
    bits-per-byte term), as ``lm_loss(..., with_bpb=True)`` on the whole
    logits, from per-sequence loss sums accumulated chunk by chunk; with
    ``parts``, as ``lm_eval_parts``."""
    h, y, m, bounds = _clm_chunks(hidden, labels, attention_mask, chunk_size)
    w = head_w.to(h.dtype)
    offset = logit_offset.float()
    per_seq = torch.zeros(hidden.shape[0], dtype=torch.float32, device=hidden.device)
    for s, e in bounds:
        per_seq = per_seq + _chunk_ce(h[:, s:e], y[:, s:e], m[:, s:e], w, offset).sum(-1)
    out = {"eval_loss": (per_seq.sum(), m.sum(), False),
           "eval_bpb": (*_bpb_parts(per_seq, byte_lengths), True)}
    return out if parts else tuple(finish_parts(out).values())


def _mlm_mask(labels, attention_mask):
    """The positions an MLM loss counts: labelled and attended."""
    return (labels != -100) & (attention_mask == 1)


def _mlm_chunks(hidden, labels, attention_mask, chunk_size: int):
    """The MLM operands (no shift) padded to whole chunks of positions
    (``losses.py:63-73``): (h, y, m, [(start, end), ...]); y int64 labels
    clamped at 0, m f32 (labelled and attended)."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size {chunk_size} must be positive")
    L = hidden.shape[1]
    pad = (-L) % chunk_size
    h = F.pad(hidden, (0, 0, 0, pad))
    y = F.pad(labels.long().clamp(min=0), (0, pad))
    m = F.pad(_mlm_mask(labels, attention_mask).float(), (0, pad))
    bounds = [(s, s + chunk_size) for s in range(0, L + pad, chunk_size)]
    return h, y, m, bounds


def _mlm_chunk_logits(h_c, head_w, logit_offset, head_fn):
    """One chunk's logits: the head's transform where there is one, the
    product in its output's dtype, then f32 with the offset
    (``losses.py:77-80``)."""
    t = head_fn(h_c) if head_fn is not None else h_c
    return (t @ head_w.to(t.dtype).t()).float() + logit_offset[None, None, :]


def _mlm_chunk_ce_sum(h_c, y_c, m_c, head_w, logit_offset, head_fn):
    logits = _mlm_chunk_logits(h_c, head_w, logit_offset, head_fn)
    return (_cross_entropy(logits, y_c) * m_c).sum()


def chunked_mlm_loss(hidden, head_w, logit_offset, labels, attention_mask, chunk_size: int,
                     head_fn=None, count=None):
    """The MLM loss from the last hidden states without the (B, L, V)
    logits (``losses.py:56``): each chunk of ``chunk_size`` positions runs
    ``head_fn`` (RoBERTa's dense, gelu, LayerNorm), its logits ``t @
    head_w.T + logit_offset`` and its masked cross-entropy sum under
    ``checkpoint``, so autograd keeps the chunk's inputs and the backward
    recomputes the rest. Equal to ``lm_loss(logits, ..., "mlm")`` on the
    whole logits up to summation order (the mean is over at least one
    position); ``count`` as ``lm_loss``'s."""
    h, y, m, bounds = _mlm_chunks(hidden, labels, attention_mask, chunk_size)
    offset = logit_offset.float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s, e in bounds:
        total = total + checkpoint(_mlm_chunk_ce_sum, h[:, s:e], y[:, s:e], m[:, s:e], head_w,
                                   offset, head_fn, use_reentrant=False)
    return total / torch.clamp(m.sum() if count is None else count, min=1.0)


@torch.no_grad()
def chunked_mlm_eval(hidden, head_w, logit_offset, labels, attention_mask, chunk_size: int,
                     head_fn=None, parts: bool = False):
    """Forward-only chunked MLM eval (``losses.py:130``): (loss, accuracy),
    the accuracy from the argmax over the whole vocab inside each position
    chunk (the first of equal maxima, as ``jnp.argmax``); with ``parts``, as
    ``lm_eval_parts``."""
    h, y, m, bounds = _mlm_chunks(hidden, labels, attention_mask, chunk_size)
    offset = logit_offset.float()
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    correct = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s, e in bounds:
        logits = _mlm_chunk_logits(h[:, s:e], head_w, offset, head_fn)
        loss_sum = loss_sum + (_cross_entropy(logits, y[:, s:e]) * m[:, s:e]).sum()
        correct = correct + ((logits.argmax(-1) == y[:, s:e]).float() * m[:, s:e]).sum()
    n = m.sum()
    out = {"eval_loss": (loss_sum, n, False), "eval_accuracy": (correct, n, True)}
    return out if parts else tuple(finish_parts(out).values())


HUBER_DELTA = 1e-3
HUBER_CORRECTION = 30


def _huber(x, y, delta):
    """optax.huber_loss."""
    abs_errors = (x - y).abs()
    quadratic = torch.clamp(abs_errors, max=delta)
    linear = abs_errors - quadratic
    return 0.5 * quadratic * quadratic + delta * linear


def _distance_fn(kind: str):
    if kind == "mse":
        return lambda x, y: torch.square(x - y).sum(dim=-1)
    if kind == "rmse":
        return lambda x, y: torch.linalg.vector_norm(x - y, dim=-1)
    if kind == "huber":
        return lambda x, y: (_huber(x, y, HUBER_DELTA).sum(dim=-1)
                             / HUBER_DELTA / HUBER_CORRECTION)
    raise ValueError(f"unknown lexical loss kind {kind}")


def lexical_loss(predicted_in, predicted_out, target_in, target_out, overlap_mask,
                 kind: str = "mse"):
    """Distance of the predictions of single-source-token targets to their
    source embeddings, normalized by the targets' mean norm
    (``losses.py:231``)."""
    distance = _distance_fn(kind)
    mask = overlap_mask.to(predicted_in.dtype)

    def one(pred, target):
        loss = (distance(pred, target) * mask).sum()
        return loss / (overlap_mask.sum() + EPSILON) / torch.linalg.vector_norm(
            target, dim=1).mean()

    loss_in = one(predicted_in, target_in)
    if target_out is not None and predicted_out is not None:
        return (loss_in + one(predicted_out, target_out)) / 2.0
    return loss_in
