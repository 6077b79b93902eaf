"""Baseline-transfer CLI: embedding initializations that need no hypernet
(counterpart of ``zett_tpu/transfer/baselines_cli.py``).

Usage:
  python -m zett_tpu_torch.transfer.baselines_cli \\
      --method {lexical,fvt,bfvt,focus,ofa,passthrough} \\
      --model MODEL_DIR --target-tokenizer TOK --output OUT \\
      [--word-embeddings VECS.txt] [--factorize-dim D] [--top-k K] \\
      [--temperature T] [--fallback {unk,random}] [--seed S] \\
      [--checkpoint CKPT] [--device {cuda,cpu}]

Reads the HF model directory (GPT-2 or the Llama family), converts its
tokenizer to byte level where it is not, converts the target tokenizer
(special tokens matched to the source, whitespace made consistent),
initializes the target's input table (and an untied head's output table)
with the method, and writes a HF directory: ``model.safetensors`` (the new
tables in the model's own dtype), ``config.json`` (the new
``vocab_size``) and the converted target's ``tokenizer.json``.
Prints, and returns from ``main``, a summary: the overlap count, the rows
each table's method filled by each route, and whether the new tables are
finite. ``--method passthrough --checkpoint CKPT`` slices the tables a passthrough
training run wrote to ``CKPT/params.npz`` (the port trainer's format; the
JAX CLI reads its orbax ``state`` instead). FOCUS and OFA search their
similarities on ``--device`` (the card unless ``--device cpu`` is given;
raises without one); without ``--word-embeddings`` they use hashed
char-n-grams, which depend on ``PYTHONHASHSEED`` (ROADMAP C.13).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--method", required=True,
                   choices=["lexical", "fvt", "bfvt", "focus", "ofa", "passthrough"])
    p.add_argument("--model", required=True)
    p.add_argument("--target-tokenizer", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="passthrough: a trainer checkpoint directory (params.npz)")
    p.add_argument("--word-embeddings", default=None,
                   help="ofa/focus auxiliary vectors: text file 'word v1 v2 ...' per line "
                        "(word2vec format, header line optional); hashed char-n-grams when "
                        "absent")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--factorize-dim", type=int, default=None)
    p.add_argument("--fallback", default="unk", choices=["unk", "random"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def load_word_vectors(path: str) -> dict:
    """word2vec text format, with or without its header line."""
    vectors = {}
    with open(path) as f:
        first = f.readline().split()
        if len(first) != 2:  # no word2vec header
            f.seek(0)
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < 3:
                continue
            vectors[parts[0]] = np.asarray(parts[1:], dtype=np.float32)
    return vectors


def main(argv=None):
    args = parse_args(argv)
    from .__main__ import _tokenizer_path, resolve_device

    device = resolve_device(args.device)

    from ..models.backbones.hf_io import load_hf_state_dict, save_hf_model
    from ..models.backbones.registry import IN_EMBEDDING_KEYS, check_supported, resolve_out_path
    from ..models.splice import splice_embeddings
    from ..tokenization.convert import convert_to_byte_level, is_byte_level
    from ..tokenization.core import Tokenizer
    from .baselines import (focus_anchors, focus_transfer, lexical_transfer, ofa_anchors,
                            ofa_transfer, passthrough_transfer)

    if args.method == "passthrough" and args.checkpoint is None:
        raise SystemExit("--checkpoint required for --method passthrough")
    with open(os.path.join(args.model, "config.json")) as f:
        bb_config_json = json.load(f)
    model_type = bb_config_json["model_type"]
    check_supported(model_type)
    state_dict = load_hf_state_dict(args.model)

    source_tokenizer = Tokenizer.from_file(_tokenizer_path(args.model))
    if not is_byte_level(source_tokenizer):
        source_tokenizer, _ = convert_to_byte_level(source_tokenizer)
    target_tokenizer, _ = convert_to_byte_level(
        Tokenizer.from_file(_tokenizer_path(args.target_tokenizer)),
        match_special_tokens_to=source_tokenizer, make_whitespace_consistent=True)

    in_key = IN_EMBEDDING_KEYS[model_type]
    out_key = resolve_out_path(model_type, state_dict, bb_config_json)
    emb_in = state_dict[in_key].float().numpy()
    emb_out = state_dict[out_key].float().numpy() if out_key is not None else None
    word_embeddings = load_word_vectors(args.word_embeddings) if args.word_embeddings else None

    routes = {}
    # FOCUS's and OFA's anchors depend on the vocabularies only (a model's
    # tables have the same rows): built once for both tables
    anchors = None
    if args.method == "focus":
        aux = None if word_embeddings is None else {
            w: v / max(np.linalg.norm(v), 1e-8) for w, v in word_embeddings.items()}
        anchors = focus_anchors(source_tokenizer, target_tokenizer, len(emb_in), aux)
    elif args.method == "ofa":
        anchors = ofa_anchors(source_tokenizer, target_tokenizer, len(emb_in), word_embeddings)

    def run_method(src, table_name):
        kw = dict(routes=routes.setdefault(table_name, {}))
        if args.method in ("lexical", "fvt", "bfvt"):
            fvt = {"lexical": "no", "fvt": "fvt", "bfvt": "bfvt"}[args.method]
            return lexical_transfer(src, source_tokenizer, target_tokenizer, fvt_mode=fvt,
                                    fallback_mode=args.fallback, seed=args.seed, **kw)
        if args.method == "focus":
            return focus_transfer(src, source_tokenizer, target_tokenizer, top_k=args.top_k,
                                  temperature=args.temperature, device=device,
                                  anchors=anchors, **kw)
        return ofa_transfer(src, source_tokenizer, target_tokenizer, top_k=args.top_k,
                            temperature=args.temperature, factorize_dim=args.factorize_dim,
                            seed=args.seed, device=device, anchors=anchors, **kw)

    overlap = None
    if args.method == "passthrough":
        with np.load(os.path.join(args.checkpoint, "params.npz")) as z:
            hn_params = {k: z[k] for k in z.files}
        new_in, new_out = passthrough_transfer(hn_params, len(target_tokenizer))
        if len(new_in) < len(target_tokenizer):
            # the JAX CLI writes the model regardless, its vocab_size under
            # its tokenizer's length
            raise ValueError(
                f"ROADMAP C.16: the checkpoint's tables hold {len(new_in)} rows, fewer than "
                f"the {len(target_tokenizer)} tokens of the converted target tokenizer: they "
                "were trained on another tokenizer (a run without target_tokenizer trains on "
                "the source's byte-level conversion, without the tokens the whitespace-"
                "consistent conversion here adds)")
    else:
        new_in, overlap = run_method(emb_in, "in")
        new_out = run_method(emb_out, "out")[0] if emb_out is not None else None

    def table(rows, key):
        return torch.from_numpy(np.ascontiguousarray(rows)).to(state_dict[key].dtype)

    spliced = splice_embeddings(
        state_dict, model_type, table(new_in, in_key),
        table(new_out, out_key) if (new_out is not None and out_key is not None) else None,
        tie_word_embeddings=bb_config_json.get("tie_word_embeddings", model_type == "gpt2"),
    )
    bb_config_json["vocab_size"] = int(new_in.shape[0])
    save_hf_model(args.output, spliced, bb_config_json)
    target_tokenizer.save(os.path.join(args.output, "tokenizer.json"))
    summary = {"method": args.method, "n_target": len(target_tokenizer),
               "overlap": None if overlap is None else len(overlap), "routes": routes,
               "finite": bool(np.isfinite(new_in).all()
                              and (new_out is None or np.isfinite(new_out).all()))}
    print(f"{args.method}-transferred {model_type} -> {len(target_tokenizer)} tokens "
          f"at {args.output}")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
