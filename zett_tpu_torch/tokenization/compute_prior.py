"""Prior computation CLI (counterpart of
``zett_tpu/tokenization/compute_prior.py``; reference:
zett/compute_prior.py:139-166).

Usage:
  python -m zett_tpu_torch.tokenization.compute_prior \\
      --tokenizer TOK --data TEXTFILE [--mode reestimate] \\
      [--block-size 128] [--output priors.npy] [--max-texts N] \\
      [--device [{cuda,cpu}] | --host-encode]
      [--distributed-coordinator HOST:PORT --distributed-num-processes N
       --distributed-process-id I]
  torchrun --nproc-per-node N -m zett_tpu_torch.tokenization.compute_prior ...

Writes {"substring": ..., "token": ...} to <tokenizer dir>/priors.npy (or
--output). In the default mode (reestimate) a Unigram tokenizer's token
usage is counted by the batched Viterbi on the card
(``ops/device_viterbi.count_tokens_device``; only the (V,) histogram comes
back); ``--device cpu`` runs the same Viterbi on the CPU through the
kernels' plain versions, and without a card the default raises before any
work. ``--host-encode`` takes the host encode path instead
(``chunked_tokenize`` + ``get_prior``, what the JAX CLI runs without its
``--device``); a tokenizer that the device path cannot take (not Unigram,
or a vocab piece outside its byte domain) raises a message that names it.
``--mode use_tokenizer`` tokenizes on the host in both packages: no kernel
computes it, so it reads neither --device nor --host-encode. Under torchrun
or the ``--distributed-*`` flags (one process a GPU; gloo with ``--device
cpu``) the device count splits its pretoken rows over the ranks and sums
the histogram over them (exact: integer counts); rank 0 writes the file.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--data", required=True, help="text file, one document per line")
    p.add_argument("--mode", default="reestimate", choices=["reestimate", "use_tokenizer"])
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument("--output", default=None)
    p.add_argument("--max-texts", type=int, default=None)
    where = p.add_mutually_exclusive_group()
    where.add_argument(
        "--device", nargs="?", const="cuda", default="cuda", choices=("cuda", "cpu"),
        help="count token usage with the batched Viterbi on this device (default and bare: "
        "the card); Unigram tokenizers only. --mode use_tokenizer has no device path: it "
        "tokenizes on the host",
    )
    where.add_argument(
        "--host-encode", action="store_true",
        help="count token usage with the host encode (the JAX CLI without --device) instead "
        "of the device Viterbi",
    )
    from ..parallel import multihost

    multihost.add_flags(p)
    return p.parse_args(argv)


HOST_FLAG = "--host-encode"  # what a message tells the caller to pass for the host path


def device_token_prior(tokenizer, pretoken_counts, device, group=None) -> np.ndarray:
    """Reestimated token prior from counts on ``device`` (split over the
    ranks of ``group`` where one is given): every vocab piece in the byte
    domain (specials and empty pieces never match), Laplace smoothing,
    special ids 0."""
    from ..ops.device_viterbi import count_tokens_device
    from .bytemaps import CHARS_TO_BYTES

    special_tokens = set(tokenizer.all_special_tokens)
    pieces = []
    scores = tokenizer.model.get_scores()
    for i in range(len(scores)):
        tok = tokenizer.id_to_token(i) or ""
        if tok in special_tokens or not tok:
            pieces.append(b"")
            continue
        try:
            pieces.append(bytes(CHARS_TO_BYTES[c] for c in tok))
        except KeyError:
            raise SystemExit(
                f"vocab piece {tok!r} (id {i}) is not representable in the tokenizer's "
                f"byte domain; pass {HOST_FLAG} for the host path")
    if any(isinstance(p, str) for p in pretoken_counts):
        # a tokenizer outside the canonical structure counts its pretoken
        # strings, byte chars where its vocab is byte level
        try:
            pretoken_counts = {bytes(CHARS_TO_BYTES[c] for c in p): n
                               for p, n in pretoken_counts.items()}
        except KeyError:
            raise SystemExit("a pretoken is not representable in the tokenizer's byte domain; "
                             f"pass {HOST_FLAG} for the host path")
    # 48-byte rows: pretokens are GPT-2-split words; the longer tail is
    # segmented exactly on the host
    counts = count_tokens_device(pieces, scores, pretoken_counts, max_pretoken_len=48,
                                 device=device, group=group)
    priors = counts.astype(np.float64) + 1.0  # laplace, as get_prior does
    priors /= priors.sum()
    token_prior = np.log(priors)
    # the counts are model-vocab-sized; added specials can sit beyond them
    special = [i for i in tokenizer.all_special_ids if i < len(token_prior)]
    if special:
        token_prior[np.asarray(special)] = 0.0
    return token_prior


def main(argv=None):
    args = parse_args(argv)
    device = None  # the host encode: --host-encode, or --mode use_tokenizer
    if not args.host_encode and args.mode == "reestimate":
        if args.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to count on "
                               f"the CPU, or {HOST_FLAG} for the host path")
        device = torch.device(args.device)
    from ..parallel import multihost

    rank, _, rank_device = multihost.join_group(multihost.flags_section(args),
                                                device.type if device is not None else "cpu")
    group = None
    if rank_device is not None:
        import torch.distributed as dist

        group = dist.group.WORLD
        device = rank_device if device is not None else None

    from ..evaluation.perplexity import chunked_tokenize
    from .core import Tokenizer
    from .models import Unigram
    from .priors import compute_substring_prior, get_prior

    tok_path = (os.path.join(args.tokenizer, "tokenizer.json")
                if os.path.isdir(args.tokenizer) else args.tokenizer)
    tokenizer = Tokenizer.from_file(tok_path)
    if device is not None and not isinstance(tokenizer.model, Unigram):
        raise SystemExit(
            f"the device path counts Unigram tokenizers only, not "
            f"{type(tokenizer.model).__name__}; pass {HOST_FLAG} for the host path")
    with open(args.data) as f:
        texts = [line.rstrip("\n") for line in f if line.strip()]
    if args.max_texts:
        texts = texts[:args.max_texts]

    substring_prior, pretoken_counts = compute_substring_prior(
        tokenizer, texts=texts, return_pretoken_counts=True)
    if device is not None:
        token_prior = device_token_prior(tokenizer, pretoken_counts, device, group)
    else:
        data = chunked_tokenize(tokenizer, texts, args.block_size)
        token_prior = get_prior(args.mode, data["input_ids"], tokenizer)

    out = args.output or os.path.join(os.path.dirname(tok_path), "priors.npy")
    if rank != 0:  # every rank holds the same priors; rank 0 writes them
        return out
    np.save(out, {"substring": substring_prior, "token": token_prior})
    print(f"wrote priors for {len(tokenizer)} tokens to {out}")
    return out


if __name__ == "__main__":
    main()
