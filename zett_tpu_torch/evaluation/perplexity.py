"""Standalone perplexity / bits-per-char evaluation of a (transferred) causal
LM (counterpart of ``zett_tpu/evaluation/perplexity.py``; reference:
eval.py:42-209): chunked tokenization with each token's char length, the
loss over every block with special tokens masked out and an optional
external lm-head bias added to the logits, reported as loss, perplexity,
bits-per-char and chars-per-token.

``evaluate_lm`` keeps its loss and token sums on the model's device and
reads them once at the end (the char count comes from the host arrays);
the JAX package reads them after every batch, which would leave the card
idle between batches. Both add the per-batch f32 sums in f64.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..tokenization.core import Tokenizer
from ..tokenization.fast_encode import fast_encoder_or_none


def chunked_tokenize(tokenizer: Tokenizer, texts: List[str],
                     block_size: int) -> Dict[str, np.ndarray]:
    """Tokenize, concatenate and chunk to block_size (reference
    zett/utils.py:318-347 tokenize_function): input_ids and the char length
    of every token, each (n_blocks, block_size) int32. A canonical
    byte-level tokenizer runs on the native fast encoder and a token's
    length is that of its byte-char string; any other goes through
    ``Tokenizer.encode`` and a token's length comes from its offsets, as in
    JAX (the offsets of the JAX package's encode span the token's whole
    pretoken: ROADMAP C.10)."""
    texts = [t.replace("\x00", "").strip() for t in texts]
    fast = fast_encoder_or_none(tokenizer)
    if fast is not None:
        ids_arr, mask = fast.encode_batch(texts, add_special_tokens=False)
        byte_len = np.zeros(len(tokenizer), dtype=np.int32)
        for token, idx in tokenizer.get_vocab().items():
            if idx < len(byte_len):
                byte_len[idx] = len(token)
        ids = ids_arr[mask == 1].astype(np.int32)  # row-major: the texts, concatenated
        charlens = byte_len[ids]
    else:
        all_ids: List[int] = []
        all_charlens: List[int] = []
        for enc in tokenizer.encode_batch(texts, add_special_tokens=False):
            all_ids.extend(enc.ids)
            all_charlens.extend(e - s for s, e in enc.offsets)
        ids = np.asarray(all_ids, dtype=np.int32)
        charlens = np.asarray(all_charlens, dtype=np.int32)
    total = (len(ids) // block_size) * block_size
    return {"input_ids": ids[:total].reshape(-1, block_size),
            "char_lengths": charlens[:total].reshape(-1, block_size)}


def evaluate_lm(apply_fn: Callable[[torch.Tensor], torch.Tensor], data: Dict[str, np.ndarray],
                special_ids: Optional[List[int]] = None,
                external_bias: Optional[np.ndarray] = None, batch_size: int = 8,
                device="cpu") -> Dict[str, float]:
    """``apply_fn(input_ids)`` -> logits (B, L, V) on ``device``. Returns
    loss / perplexity / bits_per_char / chars_per_token / n_tokens: the
    log-softmax in f32 (plus the external bias, if any), the labels'
    log-probs summed over positions whose label is not a special id."""
    device = torch.device(device)
    ids_all = torch.as_tensor(np.asarray(data["input_ids"]), dtype=torch.long).to(device)
    special = torch.as_tensor(list(special_ids or []), dtype=torch.long, device=device)
    bias = (torch.as_tensor(np.asarray(external_bias), dtype=torch.float32, device=device)
            if external_bias is not None else None)
    loss_sum = torch.zeros((), dtype=torch.float64, device=device)
    token_sum = torch.zeros((), dtype=torch.float64, device=device)
    with torch.inference_mode():
        for start in range(0, len(ids_all), batch_size):
            ids = ids_all[start:start + batch_size]
            logits = apply_fn(ids).float()
            if bias is not None:
                logits = logits + bias[None, None, :]
            logp = torch.log_softmax(logits, dim=-1)
            del logits
            labels = ids[:, 1:]
            tok_logp = logp[:, :-1].gather(-1, labels[..., None])[..., 0]
            del logp
            mask = torch.ones_like(tok_logp)
            if len(special):
                mask = mask * (~torch.isin(labels, special)).float()
            # each batch's f32 sums, added in f64 as JAX's Python floats are
            loss_sum += (-(tok_logp * mask).sum()).double()
            token_sum += mask.sum().double()
    total_loss, total_tokens = float(loss_sum), float(token_sum)  # the one read
    total_chars = int(np.asarray(data["char_lengths"])[:, 1:].sum())
    loss = total_loss / max(total_tokens, 1)
    return {
        "loss": loss,
        "perplexity": float(np.exp(loss)),
        "bits_per_char": total_loss / np.log(2) / max(total_chars, 1),
        "chars_per_token": total_chars / max(total_tokens, 1),
        "n_tokens": total_tokens,
    }


def resolve_device(name: str) -> torch.device:
    """``cuda`` unless the caller asks for ``cpu``; raises when there is no
    card."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    return torch.device(name)


def tf32_note(device) -> str:
    on = device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32
    return f"f32 weights and logits on {device}, TF32 matmul {'on' if on else 'off'}"


def load_causal_lm(model_dir: str, device) -> Callable[[torch.Tensor], torch.Tensor]:
    """A HF causal-LM directory (gpt2 or the Llama family) as
    ``apply_fn(input_ids) -> logits`` on ``device``, weights in f32 as the
    JAX CLIs build it."""
    from ..models.backbones.hf_io import load_hf_state_dict
    from ..models.backbones.registry import (
        IN_EMBEDDING_KEYS,
        build_model,
        config_from_hf,
        resolve_out_path,
    )

    with open(os.path.join(model_dir, "config.json")) as f:
        config_json = json.load(f)
    model_type = config_json["model_type"]
    config = config_from_hf(model_type, config_json)
    if model_type == "gpt2":
        from ..models.backbones.gpt2 import weight_keys
    else:
        from ..models.backbones.llama import weight_keys
    state = load_hf_state_dict(model_dir)
    out_key = resolve_out_path(model_type, state, config_json)
    state = {k: state[k].to(device).to(torch.float32) for k in weight_keys(config)}
    model = build_model(model_type, config, state, torch.float32)
    del state
    in_table = model.weights[IN_EMBEDDING_KEYS[model_type].replace(".", "__")]
    out_table = model.weights[out_key.replace(".", "__")] if out_key else None

    def apply_fn(input_ids):
        if out_table is None:
            return model(input_ids, None, in_table)
        return model(input_ids, None, in_table, out_table)

    return apply_fn
