"""Transfer CLI: apply a trained hypernetwork to a new target tokenizer.

Usage:
  python -m zett_tpu_torch.transfer \\
      --checkpoint CKPT_DIR         # hn_config.json + params.npz + tokenizer.json
      --model MODEL_DIR             # HF gpt2, Llama-family or (XLM-)RoBERTa dir
                                    # (config.json + weights + tokenizer.json)
      --target-tokenizer TOK        # tokenizer.json (or dir containing it)
      --output OUT_DIR
      [--hn-tokenizer TOK] [--batch-size N] [--do-batch-sampling] [--min-k K]
      [--lang-index I] [--seed S] [--device {cuda,cpu}]

The checkpoint directory holds ``hn_config.json`` (the HypernetConfig fields,
plus an optional ``"dtype"``: ``"float32"`` (default) or ``"bfloat16"``, the
hypernet's compute dtype), ``params.npz`` (the Flax parameter tree, one array
per "/"-joined path) and the hn tokenizer's ``tokenizer.json``. A source
tokenizer that is not byte-level (a Llama-family sentencepiece/metaspace
one) is converted to byte level first. Writes ``model.safetensors`` (an
untied head gets the predicted output table; RoBERTa's tied decoder the
predicted input table and its lm-head bias zeros, as the JAX CLI writes
them), ``config.json`` (with the new ``vocab_size``), ``tokenizer.json``
and ``bias.npy``, the predicted bias. Runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--target-tokenizer", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--hn-tokenizer", default=None)
    p.add_argument("--batch-size", type=int, default=16384)
    p.add_argument("--do-batch-sampling", action="store_true")
    p.add_argument("--min-k", type=int, default=4)
    p.add_argument("--lang-index", type=int, default=0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def _tokenizer_path(path: str) -> str:
    if os.path.isdir(path):
        return os.path.join(path, "tokenizer.json")
    return path


def resolve_device(name: str) -> torch.device:
    """The requested device; a missing card raises instead of falling back."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    return torch.device(name)


def load_hypernet(checkpoint: str, device: torch.device):
    """The checkpoint's hypernet on ``device``. It is built on the meta
    device and takes the checkpoint's tensors, cast to each parameter's
    dtype, in place of a default init it would overwrite (0.7 G parameters
    at Mistral-7B's hypernet)."""
    from ..models.convert import flax_to_torch
    from ..models.hypernet import Hypernet, HypernetConfig

    with open(os.path.join(checkpoint, "hn_config.json")) as f:
        raw = json.load(f)
    dtype = _DTYPES[raw.get("dtype", "float32")]
    with torch.device("meta"):
        hypernet = Hypernet(HypernetConfig.from_dict(raw), dtype=dtype)
    with np.load(os.path.join(checkpoint, "params.npz")) as params:
        state = flax_to_torch({k: params[k] for k in params.files})
    dtypes = {k: v.dtype for k, v in hypernet.state_dict().items()}
    hypernet.load_state_dict({k: v.to(dtypes.get(k, v.dtype)) for k, v in state.items()},
                             strict=True, assign=True)
    return hypernet.to(device).eval()


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)

    from ..models.backbones.hf_io import load_hf_state_dict, save_hf_model
    from ..models.backbones.registry import (IN_EMBEDDING_KEYS, ROBERTA_FAMILY, check_supported,
                                             resolve_out_path)
    from ..models.splice import splice_embeddings
    from ..tokenization.convert import convert_to_byte_level, is_byte_level
    from ..tokenization.core import Tokenizer
    from .core import transfer

    hypernet = load_hypernet(args.checkpoint, device)

    hn_tokenizer = Tokenizer.from_file(_tokenizer_path(args.hn_tokenizer or args.checkpoint))
    if not is_byte_level(hn_tokenizer):
        hn_tokenizer, _ = convert_to_byte_level(hn_tokenizer)

    with open(os.path.join(args.model, "config.json")) as f:
        bb_config_json = json.load(f)
    model_type = bb_config_json["model_type"]
    check_supported(model_type)
    state_dict = load_hf_state_dict(args.model)

    source_tokenizer = Tokenizer.from_file(_tokenizer_path(args.model))
    if not is_byte_level(source_tokenizer):
        source_tokenizer, _ = convert_to_byte_level(source_tokenizer)

    emb_in = state_dict[IN_EMBEDDING_KEYS[model_type]].float().numpy()
    out_key = resolve_out_path(model_type, state_dict, bb_config_json)
    emb_out = state_dict[out_key].float().numpy() if out_key is not None else None
    target_tokenizer = Tokenizer.from_file(_tokenizer_path(args.target_tokenizer))

    new_in, new_out, bias, converted_target = transfer(
        hypernet=hypernet,
        hn_tokenizer=hn_tokenizer,
        source_tokenizer=source_tokenizer,
        source_embeddings_in=emb_in,
        source_embeddings_out=emb_out,
        target_tokenizer=target_tokenizer,
        lang_index=args.lang_index,
        batch_size=args.batch_size,
        do_batch_sampling=args.do_batch_sampling,
        min_k=args.min_k,
        seed=args.seed,
    )

    spliced = splice_embeddings(
        state_dict, model_type, torch.from_numpy(new_in),
        torch.from_numpy(new_out) if (new_out is not None and out_key is not None) else None,
        tie_word_embeddings=(model_type in ROBERTA_FAMILY
                             or bb_config_json.get("tie_word_embeddings", model_type == "gpt2")),
    )
    bb_config_json["vocab_size"] = int(new_in.shape[0])
    save_hf_model(args.output, spliced, bb_config_json)
    converted_target.save(os.path.join(args.output, "tokenizer.json"))
    # the predicted bias is a side artifact; RoBERTa's lm-head bias is
    # written as zeros (transfer/__main__.py:125-138)
    np.save(os.path.join(args.output, "bias.npy"), bias)
    print(f"transferred {model_type} -> {len(converted_target)} tokens at {args.output}")


if __name__ == "__main__":
    main()
