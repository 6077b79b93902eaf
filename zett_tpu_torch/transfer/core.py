"""Zero-shot tokenizer transfer: run the hypernet over a target tokenizer's
whole vocabulary and produce embedding matrices for the base LM.

Counterpart of ``zett_tpu/transfer/core.py``: byte-level conversion of the
target tokenizer matched to the source's special tokens, the surface-form
matrix, priors from Unigram scores, batched inference (length-bucketed, or
overlapping sampled batches averaged per token), and the special-token
splice-back from the source embeddings. One device, no mesh.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import NEGATIVE_INF_FILL_VALUE
from ..models.hypernet import Hypernet
from ..tokenization.convert import convert_to_byte_level
from ..tokenization.core import Tokenizer
from ..tokenization.models import Unigram
from ..tokenization.surface_forms import get_surface_form_matrix


def get_sample_indices(n, p, batch_size, min_k, n_samples, rng=None):
    """Overlapping random vocab batches such that every token receives at
    least ``min_k`` hypernet predictions: ``min_k`` permutations of the vocab,
    each split over ``n_samples // min_k`` rows, topped up by prior-weighted
    sampling (p = log priors; entries at NEGATIVE_INF_FILL_VALUE excluded)
    without replacement, skipping the tokens a row already holds."""
    rng = rng or np.random.default_rng()
    rows_per_round = n_samples // min_k
    if rows_per_round * min_k != n_samples:
        raise ValueError(f"n_samples={n_samples} must be a multiple of min_k={min_k}")
    if batch_size * rows_per_round < n:
        raise ValueError("batch capacity too small to cover the vocab each round")

    weights = np.exp(np.where(p > NEGATIVE_INF_FILL_VALUE, p, -np.inf))
    rows = np.empty((n_samples, batch_size), dtype=np.int32)
    for r in range(min_k):
        chunks = np.array_split(rng.permutation(n), rows_per_round)
        for j, chunk in enumerate(chunks):
            row = rows[r * rows_per_round + j]
            row[: len(chunk)] = chunk
            n_fill = batch_size - len(chunk)
            if n_fill:
                w = weights.copy()
                w[chunk] = 0.0
                row[len(chunk):] = rng.choice(n, size=n_fill, p=w / w.sum(), replace=False)
    return rows


def batched_inference(
    predict_fn,
    surface_forms: np.ndarray,
    priors: np.ndarray,
    batch_size: int = 16384,
    do_batch_sampling: bool = False,
    min_k: int = 4,
    rng=None,
    bucket_multiple: int = 0,
    pad_id: int = 0,
):
    """Run ``predict_fn(surface_forms_batch, priors_batch)`` over the full
    vocab in fixed-size batches; returns (emb_in, emb_out|None, bias) as f32
    numpy arrays stacked over the vocab.

    bucket_multiple > 0 sorts tokens by effective surface length and trims
    trailing pad columns of each batch to the next multiple (exact: trailing
    pads are masked and CLS-pooled away). All-pad rows keep the full width.
    """
    rng = rng or np.random.default_rng(1234)
    n = len(surface_forms)
    maxlen = surface_forms.shape[1]

    if not do_batch_sampling:
        if bucket_multiple:
            nz = surface_forms != pad_id
            any_nz = nz.any(axis=1)
            trailing = np.argmax(nz[:, ::-1], axis=1)
            eff_len = np.where(any_nz, maxlen - trailing, maxlen)
            order = np.argsort(eff_len, kind="stable")
            order = np.resize(order, len(order) + (-len(order)) % batch_size)
            batches = []
            for chunk in order.reshape(-1, batch_size):
                w = int(eff_len[chunk].max())
                w = min(-(-w // bucket_multiple) * bucket_multiple, maxlen)
                batches.append((chunk, w))
        else:
            permutation = rng.permutation(n)
            n_pad = (-n) % batch_size
            padded = np.concatenate([permutation, permutation[:n_pad]])
            batches = [(chunk, maxlen) for chunk in padded.reshape(-1, batch_size)]
    else:
        n_samples = int(np.ceil(n / batch_size)) * min_k
        sample_indices = get_sample_indices(n, priors, batch_size, min_k, n_samples, rng)
        batches = [(chunk, maxlen) for chunk in sample_indices]
    weights = np.zeros(n)

    emb_in_acc = emb_out_acc = bias_acc = None

    def drain(entry):
        nonlocal emb_in_acc, emb_out_acc, bias_acc
        batch_idx, e_in, e_out, b = entry
        e_in = e_in.float().cpu().numpy()
        e_out = e_out.float().cpu().numpy() if e_out is not None else None
        b = b.float().cpu().numpy()
        if emb_in_acc is None:
            emb_in_acc = np.zeros((n, e_in.shape[1]), dtype=np.float32)
            if e_out is not None:
                emb_out_acc = np.zeros((n, e_out.shape[1]), dtype=np.float32)
            bias_acc = np.zeros(n, dtype=np.float32)
        np.add.at(emb_in_acc, batch_idx, e_in)
        if e_out is not None:
            np.add.at(emb_out_acc, batch_idx, e_out)
        np.add.at(bias_acc, batch_idx, b)
        np.add.at(weights, batch_idx, 1.0)

    # pipelined: batch k+1 is enqueued on the device before the host waits
    # for batch k's results, so the host-side accumulation overlaps compute
    inflight: deque = deque()
    for batch_idx, width in batches:
        e_in, e_out, b = predict_fn(surface_forms[batch_idx][:, :width], priors[batch_idx])
        inflight.append((batch_idx, e_in, e_out, b))
        if len(inflight) >= 2:
            drain(inflight.popleft())
    while inflight:
        drain(inflight.popleft())

    weights = np.maximum(weights, 1.0)
    emb_in_acc /= weights[:, None]
    if emb_out_acc is not None:
        emb_out_acc /= weights[:, None]
    bias_acc /= weights
    return emb_in_acc, emb_out_acc, bias_acc


def transfer(
    *,
    hypernet: Hypernet,
    hn_tokenizer: Tokenizer,
    source_tokenizer: Tokenizer,
    source_embeddings_in: np.ndarray,
    target_tokenizer: Tokenizer,
    source_embeddings_out: Optional[np.ndarray] = None,
    lang_index: int = 0,
    batch_size: int = 16384,
    do_batch_sampling: bool = False,
    min_k: int = 4,
    seed: int = 1234,
    fetch_bf16: Optional[bool] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray, Tokenizer]:
    """Full transfer pipeline on the hypernet's device. Returns (emb_in,
    emb_out|None, bias, converted_target_tokenizer).

    fetch_bf16 (default: when the hypernet computes in bf16) rounds the
    predictions to bf16 on the device before they are fetched, as the JAX
    package does; accumulation and the splice run in f32 on the host."""
    cfg = hypernet.config
    rng = np.random.default_rng(seed)
    device = next(hypernet.parameters()).device

    target, _ = convert_to_byte_level(
        target_tokenizer,
        match_special_tokens_to=source_tokenizer,
        make_whitespace_consistent=True,
    )
    surface_forms, _ = get_surface_form_matrix(target, cfg.hn_surface_maxlen, hn_tokenizer)

    if isinstance(target.model, Unigram):
        scores = np.asarray(target.model.get_scores(), dtype=np.float32)
        priors = np.full(len(target), NEGATIVE_INF_FILL_VALUE, dtype=np.float32)
        priors[: len(scores)] = scores
    else:
        priors = np.zeros(len(target), dtype=np.float32)

    source = source_embeddings_in
    if source_embeddings_out is not None:
        source = np.concatenate([source_embeddings_in, source_embeddings_out], axis=1)
    n_pad = (-len(source)) % 128
    if n_pad:
        source = np.concatenate([source, np.zeros((n_pad, source.shape[1]), dtype=source.dtype)])
    source_dev = torch.from_numpy(np.ascontiguousarray(source)).to(device)

    if fetch_bf16 is None:
        fetch_bf16 = hypernet.dtype == torch.bfloat16

    def predict_fn(sf, pr):
        sf = torch.from_numpy(sf.astype(np.int64)).to(device)
        pr = torch.from_numpy(pr).to(device)
        with torch.inference_mode():
            out = hypernet(sf, pr, source_dev, lang_index)
        if fetch_bf16:
            out = tuple(o.to(torch.bfloat16) if o is not None else None for o in out)
        return out

    emb_in, emb_out, bias = batched_inference(
        predict_fn,
        surface_forms,
        priors,
        batch_size=batch_size,
        do_batch_sampling=do_batch_sampling,
        min_k=min_k,
        rng=rng,
        # trailing-pad trimming is exact with CLS pooling; concat pooling
        # reads every position, so it keeps the full width
        bucket_multiple=0 if cfg.concat_last_hidden_state else 4,
        pad_id=cfg.pad_token_id,
    )

    # special tokens: copy source embeddings directly
    for token in target.all_special_tokens:
        tgt_id = target.token_to_id(token)
        src_id = source_tokenizer.token_to_id(token)
        if tgt_id is None or src_id is None:
            continue
        emb_in[tgt_id] = source_embeddings_in[src_id]
        if emb_out is not None and source_embeddings_out is not None:
            emb_out[tgt_id] = source_embeddings_out[src_id]
        bias[tgt_id] = 0.0
    return emb_in, emb_out, bias, target
