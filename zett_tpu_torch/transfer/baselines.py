"""Baseline embedding-transfer methods that need no hypernet (counterpart of
``zett_tpu/transfer/baselines.py``): lexical overlap copy with FVT/BFVT and
the unk/random fallbacks, FOCUS, OFA, slicing a passthrough run's tables,
and ``apply_to_ft``'s task-vector arithmetic.

Everything but the similarity search is the JAX module's numpy, in the same
order, so on the CPU the results equal JAX's bit for bit. The search, each
new token's top-k most similar anchors in an auxiliary space (FOCUS: the
overlapping tokens; OFA: every source subword), runs on ``device``
(``top_k_similar``), a block of ``SIM_CHUNK_ROWS`` query rows at a time, so
the (new x anchors) similarity matrix never exists whole (at TinyLlama to
starcoder0001 it would be 32.7k x 32k f32, 4.2 GB). On the CPU a block is
numpy's product and ``np.argpartition``, as in JAX; on a card it is
``torch.matmul`` and ``torch.topk``, which rounds the products its own way
and may break a tie at the k-th similarity for another anchor. The
per-token loops stay host Python, as in JAX.

``char_ngram_embeddings`` buckets n-grams with Python's ``hash``, as JAX
does, so its vectors (and FOCUS's and OFA's results without word vectors)
depend on ``PYTHONHASHSEED`` (ROADMAP C.13): fix it to repeat a run.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tokenization.core import Tokenizer

SIM_CHUNK_ROWS = 4096  # query rows of one similarity block
MIN_BLOCK_ROWS = 64  # a shorter last block joins the one before it


def lexical_transfer(
    source_embeddings: np.ndarray,
    source_tokenizer: Tokenizer,
    target_tokenizer: Tokenizer,
    fvt_mode: str = "no",  # "no" | "fvt" | "bfvt"
    fallback_mode: str = "unk",  # "unk" | "random"
    unk_token: str = "<unk>",
    seed: int = 0,
    routes: Optional[Dict[str, int]] = None,
) -> Tuple[np.ndarray, List[int]]:
    """Copy embeddings for overlapping tokens; FVT averages source-subtoken
    embeddings for the rest; fallback fills the remainder
    (``baselines.py:22``). ``routes``, when given, receives the rows each
    way took ("copied", "fvt", "fallback")."""
    rng = np.random.default_rng(seed)
    source_vocab = source_tokenizer.get_vocab()
    n_target = len(target_tokenizer)
    n_source = len(source_embeddings)

    if fallback_mode == "random":
        target = rng.normal(
            loc=source_embeddings.mean(0),
            scale=source_embeddings.std(0),
            size=(n_target, source_embeddings.shape[1]),
        ).astype(source_embeddings.dtype)
    else:
        unk_id = source_tokenizer.token_to_id(unk_token)
        if unk_id is None:
            unk_id = 0
        target = np.repeat(source_embeddings[[unk_id]], n_target, axis=0)

    overlap: List[int] = []
    copied = 0
    model = source_tokenizer.model
    for i in range(n_target):
        token = target_tokenizer.id_to_token(i)
        if token is None:
            continue
        idx = source_vocab.get(token)
        if idx is not None and idx < n_source:
            overlap.append(i)
            copied += 1
            target[i] = source_embeddings[idx]
        elif fvt_mode != "no":
            decomposed = [tid for tid, _t in model.tokenize(token)]
            if fvt_mode == "fvt" and any(t >= n_source or t < 0 for t in decomposed):
                continue
            constituents = [t for t in decomposed if 0 <= t < n_source]
            if constituents:
                overlap.append(i)
                target[i] = source_embeddings[np.asarray(constituents)].mean(0)
    if routes is not None:
        routes.update(copied=copied, fvt=len(overlap) - copied, fallback=n_target - len(overlap))
    return target, overlap


def char_ngram_embeddings(
    tokens: List[str], dim: int = 256, n_min: int = 2, n_max: int = 4, seed: int = 0
) -> np.ndarray:
    """Hash-based char-n-gram embeddings, the offline auxiliary space of FOCUS
    and OFA (``baselines.py:71``): each n-gram of ``<token>`` adds one to the
    bucket ``hash((ngram, seed)) % dim``; rows are scaled by 1/sqrt(#n-grams)
    and then normalised. Python's string hash is salted per process unless
    ``PYTHONHASHSEED`` is set (ROADMAP C.13)."""
    out = np.zeros((len(tokens), dim), dtype=np.float32)
    for i, token in enumerate(tokens):
        padded = f"<{token}>"
        n_grams = 0
        for n in range(n_min, n_max + 1):
            for j in range(len(padded) - n + 1):
                h = hash((padded[j: j + n], seed)) % dim
                out[i, h] += 1.0
                n_grams += 1
        if n_grams:
            out[i] /= np.sqrt(n_grams)
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-8)


def row_blocks(n: int, chunk_rows: int) -> List[Tuple[int, int]]:
    """[start, end) blocks of ``chunk_rows`` rows covering ``n``; a last
    block under ``MIN_BLOCK_ROWS`` rows joins the one before it. numpy's
    BLAS takes other routes for a few rows (matrix-vector for one), which
    sum in another order than the matrix-matrix route that gives a row the
    same value in any larger block, JAX's one block included."""
    chunk_rows = max(chunk_rows, MIN_BLOCK_ROWS)
    bounds = [(s, min(s + chunk_rows, n)) for s in range(0, n, chunk_rows)]
    if len(bounds) > 1 and bounds[-1][1] - bounds[-1][0] < MIN_BLOCK_ROWS:
        bounds[-2:] = [(bounds[-2][0], n)]
    return bounds


def topk_torch(q: torch.Tensor, keys: torch.Tensor, k: int):
    """A block's search on a card: ``torch.matmul`` then ``torch.topk``,
    (products, indices), largest first."""
    return torch.topk(q @ keys.T, k, dim=1)


def top_k_similar(queries: np.ndarray, keys: np.ndarray, k: int, device="cpu",
                  chunk_rows: int = SIM_CHUNK_ROWS) -> Tuple[np.ndarray, np.ndarray]:
    """For each query row, the k key rows of the largest product ``q @ key``
    (cosines for unit rows): (indices (n, k) int64, products (n, k) f32),
    ``chunk_rows`` queries at a time. On the CPU numpy's product and
    ``np.argpartition(-sims, k - 1)``, the JAX module's selection and order
    within a row; on a card ``torch.matmul`` and ``torch.topk`` (largest
    first; a tie at the k-th product may pick another key)."""
    n = len(queries)
    idx = np.empty((n, k), dtype=np.int64)
    vals = np.empty((n, k), dtype=np.float32)
    dev = torch.device(device)
    keys_t = None if dev.type == "cpu" else torch.from_numpy(np.ascontiguousarray(keys)).to(dev)
    for s, e in row_blocks(n, chunk_rows):
        q = queries[s:e]
        if keys_t is None:
            sims = q @ keys.T
            top = np.argpartition(-sims, k - 1, axis=1)[:, :k]
            idx[s:e] = top
            vals[s:e] = np.take_along_axis(sims, top, axis=1)
        else:
            top_v, top_i = topk_torch(torch.from_numpy(np.ascontiguousarray(q)).to(dev),
                                      keys_t, k)
            idx[s:e] = top_i.cpu().numpy()
            vals[s:e] = top_v.float().cpu().numpy()
    return idx, vals


def focus_rows(aux_new: np.ndarray, aux_overlap: np.ndarray, overlap_emb: np.ndarray,
               top_k: int = 10, temperature: float = 0.1,
               device="cpu") -> Tuple[np.ndarray, np.ndarray]:
    """FOCUS's combination (``baselines.py:128-142``): for each new token
    (row of ``aux_new``), the softmax(sim / temperature)-weighted sum of the
    ``overlap_emb`` rows of its top-k most similar overlapping tokens.
    Returns (rows (n, d) in ``overlap_emb``'s dtype, covered (n,) bool); a
    row without a positive similarity among its top k is not covered and
    left zero. Each row depends on its own similarities only."""
    k = min(top_k, len(aux_overlap))
    top_idx, top_sims = top_k_similar(aux_new, aux_overlap, k, device)
    out = np.zeros((len(aux_new), overlap_emb.shape[1]), dtype=overlap_emb.dtype)
    covered = np.zeros(len(aux_new), dtype=bool)
    for row in range(len(aux_new)):
        idx = top_idx[row]
        s = top_sims[row]
        if (s <= 0).all():
            continue  # no similar anchor -> falls back to unk
        w = np.exp((s - s.max()) / temperature)
        w /= w.sum()
        out[row] = (w[:, None] * overlap_emb[idx]).sum(0)
        covered[row] = True
    return out, covered


def focus_anchors(source_tokenizer: Tokenizer, target_tokenizer: Tokenizer, n_source: int,
                  auxiliary_embeddings: Optional[Dict[str, np.ndarray]] = None):
    """FOCUS's inputs (``baselines.py:100-126``), the same for a model's
    input and output tables: (overlap ids, their rows in a source table of
    ``n_source`` rows, new ids, auxiliary rows of the overlapping tokens, of
    the new ones). The auxiliary rows are None when either set is empty."""
    source_vocab = source_tokenizer.get_vocab()
    n_target = len(target_tokenizer)
    target_tokens = [target_tokenizer.id_to_token(i) or "" for i in range(n_target)]

    overlap_ids: List[int] = []
    source_ids: List[int] = []
    overlap_tokens: List[str] = []
    new_ids: List[int] = []
    for i, token in enumerate(target_tokens):
        idx = source_vocab.get(token)
        if idx is not None and idx < n_source:
            overlap_ids.append(i)
            source_ids.append(idx)
            overlap_tokens.append(token)
        else:
            new_ids.append(i)

    aux_overlap = aux_new = None
    if new_ids and overlap_ids:
        if auxiliary_embeddings is None:
            all_tokens = overlap_tokens + [target_tokens[i] for i in new_ids]
            aux = char_ngram_embeddings(all_tokens)
            aux_overlap = aux[: len(overlap_tokens)]
            aux_new = aux[len(overlap_tokens):]
        else:
            aux_overlap = np.stack([auxiliary_embeddings[t] for t in overlap_tokens])
            aux_new = np.stack([auxiliary_embeddings[target_tokens[i]] for i in new_ids])
    return overlap_ids, source_ids, new_ids, aux_overlap, aux_new


def focus_transfer(
    source_embeddings: np.ndarray,
    source_tokenizer: Tokenizer,
    target_tokenizer: Tokenizer,
    auxiliary_embeddings: Optional[Dict[str, np.ndarray]] = None,
    top_k: int = 10,
    temperature: float = 0.1,
    unk_token: str = "<unk>",
    device="cpu",
    routes: Optional[Dict[str, int]] = None,
    anchors=None,
) -> Tuple[np.ndarray, List[int]]:
    """FOCUS (``baselines.py:91``): overlapping tokens copy their source
    embedding; each new token becomes a softmax-weighted combination of the
    embeddings of overlapping tokens, weighted by auxiliary-space
    similarity (``focus_rows``, the search on ``device``); the rest take
    the source's unk row. ``routes``, when given, receives the rows each
    way took ("copied", "combined", "unk"); ``anchors``, when given, is
    ``focus_anchors``' result for these tokenizers and table rows."""
    if anchors is None:
        anchors = focus_anchors(source_tokenizer, target_tokenizer, len(source_embeddings),
                                auxiliary_embeddings)
    overlap_ids, source_ids, new_ids, aux_overlap, aux_new = anchors
    target = np.zeros((len(target_tokenizer), source_embeddings.shape[1]),
                      dtype=source_embeddings.dtype)
    target[overlap_ids] = source_embeddings[source_ids]
    if aux_new is not None:
        rows, covered = focus_rows(aux_new, aux_overlap, target[np.asarray(overlap_ids)],
                                   top_k, temperature, device)
        new = np.asarray(new_ids)
        target[new[covered]] = rows[covered]
        uncovered = sorted(new[~covered].tolist())
    else:
        uncovered = new_ids

    if uncovered:
        unk_id = source_tokenizer.token_to_id(unk_token)
        if unk_id is None:
            unk_id = 0
        target[np.asarray(uncovered)] = source_embeddings[unk_id][None]
    if routes is not None:
        routes.update(copied=len(overlap_ids), combined=len(new_ids) - len(uncovered),
                      unk=len(uncovered))
    return target, overlap_ids


def ofa_subword_embeddings(
    tokenizer: Tokenizer,
    word_embeddings: Dict[str, np.ndarray],
    add_prefix_space: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Subword representations in an external word-vector space
    (``baselines.py:157``): each word's vector is added to every subword of
    its encoding, then averaged and normalised. Returns (reps [vocab, dim],
    has_rep [vocab] bool)."""
    n = len(tokenizer)
    dim = len(next(iter(word_embeddings.values())))
    reps = np.zeros((n, dim), dtype=np.float32)
    counts = np.zeros(n, dtype=np.int64)
    for word, vec in word_embeddings.items():
        text = " " + word if add_prefix_space else word
        ids = tokenizer.encode(text).ids
        for tid in set(ids):
            if 0 <= tid < n:
                reps[tid] += vec
                counts[tid] += 1
    has_rep = counts > 0
    reps[has_rep] /= counts[has_rep, None]
    norms = np.linalg.norm(reps, axis=1, keepdims=True)
    reps = reps / np.maximum(norms, 1e-8)
    return reps, has_rep


def ofa_rows(tgt_reps: np.ndarray, src_reps: np.ndarray, coords: np.ndarray,
             primitive: Optional[np.ndarray], top_k: int = 10, temperature: float = 0.1,
             device="cpu", chunk_rows: int = SIM_CHUNK_ROWS) -> np.ndarray:
    """OFA's combination (``baselines.py:255-266``): for each target row,
    the softmax(sim / temperature)-weighted sum of the ``coords`` rows of
    its top-k most similar source subwords, times ``primitive`` when the
    source was factorized. Rows (n, d) in f32 (the caller casts); each row
    depends on its own similarities only. The weighted sums run
    ``chunk_rows`` rows at a time: numpy's einsum on the CPU, torch's on a
    card."""
    k = min(top_k, len(src_reps))
    top_idx, rows = top_k_similar(tgt_reps, src_reps, k, device, chunk_rows)
    w = np.exp((rows - rows.max(axis=1, keepdims=True)) / temperature)
    w /= w.sum(axis=1, keepdims=True)
    dev = torch.device(device)
    out = []
    for s, e in row_blocks(len(tgt_reps), chunk_rows):
        sel = coords[top_idx[s:e]]
        if dev.type == "cpu":
            combined = np.einsum("nk,nkd->nd", w[s:e], sel)
            if primitive is not None:
                combined = combined @ primitive
        else:
            t = torch.einsum("nk,nkd->nd", torch.from_numpy(w[s:e]).to(dev),
                             torch.from_numpy(sel).to(dev))
            if primitive is not None:
                t = t @ torch.from_numpy(primitive).to(dev)
            combined = t.cpu().numpy()
        out.append(combined)
    return np.concatenate(out) if out else np.zeros((0, coords.shape[1]), np.float32)


def ofa_anchors(source_tokenizer: Tokenizer, target_tokenizer: Tokenizer, n_source: int,
                word_embeddings: Optional[Dict[str, np.ndarray]] = None):
    """OFA's representations (``baselines.py:219-232``), the same for a
    model's input and output tables: (source reps, whether each of the
    ``n_source`` source subwords has one, target reps, whether each target
    token has one), from the word vectors or, without them, from hashed
    char-n-grams of both vocabularies."""
    target_tokens = [target_tokenizer.id_to_token(i) or ""
                     for i in range(len(target_tokenizer))]
    if word_embeddings is not None:
        src_reps, src_has = ofa_subword_embeddings(source_tokenizer, word_embeddings)
        tgt_reps, tgt_has = ofa_subword_embeddings(target_tokenizer, word_embeddings)
    else:
        source_tokens = [source_tokenizer.id_to_token(i) or "" for i in range(n_source)]
        all_reps = char_ngram_embeddings(source_tokens + target_tokens)
        src_reps, tgt_reps = all_reps[:n_source], all_reps[n_source:]
        src_has = np.linalg.norm(src_reps, axis=1) > 0
        tgt_has = np.linalg.norm(tgt_reps, axis=1) > 0
    src_has = src_has[:n_source] if len(src_has) > n_source else src_has
    return src_reps, src_has, tgt_reps, tgt_has


def ofa_transfer(
    source_embeddings: np.ndarray,
    source_tokenizer: Tokenizer,
    target_tokenizer: Tokenizer,
    word_embeddings: Optional[Dict[str, np.ndarray]] = None,
    top_k: int = 10,
    temperature: float = 0.1,
    factorize_dim: Optional[int] = None,
    seed: int = 0,
    device="cpu",
    routes: Optional[Dict[str, int]] = None,
    anchors=None,
) -> Tuple[np.ndarray, List[int]]:
    """OFA-style initialization (``baselines.py:185``): optionally factorize
    the source table by SVD (f64, numpy); represent every subword of both
    vocabularies in a word-vector space (``ofa_anchors``); overlapping
    tokens copy their source row; each new token with a representation
    becomes ``ofa_rows``' combination over its top-k source subwords (the
    search and the sums on ``device``); the rest keep a random row drawn
    from the source's mean and std. ``routes``, when given, receives the
    rows each way took ("copied", "combined", "random"); ``anchors``, when
    given, is ``ofa_anchors``' result for these tokenizers and table rows."""
    rng = np.random.default_rng(seed)
    n_target = len(target_tokenizer)
    n_source = len(source_embeddings)
    source_vocab = source_tokenizer.get_vocab()
    target_tokens = [target_tokenizer.id_to_token(i) or "" for i in range(n_target)]

    if factorize_dim is not None and factorize_dim < source_embeddings.shape[1]:
        u, s, vt = np.linalg.svd(source_embeddings.astype(np.float64), full_matrices=False)
        coords = (u[:, :factorize_dim] * s[:factorize_dim]).astype(source_embeddings.dtype)
        primitive = vt[:factorize_dim].astype(source_embeddings.dtype)
    else:
        coords = source_embeddings
        primitive = None

    if anchors is None:
        anchors = ofa_anchors(source_tokenizer, target_tokenizer, n_source, word_embeddings)
    src_reps, src_has, tgt_reps, tgt_has = anchors

    target = rng.normal(
        loc=source_embeddings.mean(0),
        scale=source_embeddings.std(0),
        size=(n_target, source_embeddings.shape[1]),
    ).astype(source_embeddings.dtype)

    overlap_ids: List[int] = []
    new_with_rep: List[int] = []
    for i, token in enumerate(target_tokens):
        idx = source_vocab.get(token)
        if idx is not None and idx < n_source:
            target[i] = source_embeddings[idx]
            overlap_ids.append(i)
        elif tgt_has[i]:
            new_with_rep.append(i)

    src_ids = np.nonzero(src_has)[0]
    combined_rows = 0
    if new_with_rep and len(src_ids):
        combined = ofa_rows(tgt_reps[np.asarray(new_with_rep)], src_reps[src_ids],
                            coords[src_ids], primitive, top_k, temperature, device)
        target[np.asarray(new_with_rep)] = combined.astype(source_embeddings.dtype)
        combined_rows = len(new_with_rep)
    if routes is not None:
        routes.update(copied=len(overlap_ids), combined=combined_rows,
                      random=n_target - len(overlap_ids) - combined_rows)
    return target, overlap_ids


def passthrough_transfer(hn_params: Dict[str, np.ndarray], n_tokens: int):
    """Slice a passthrough run's tables to the tokenizer size
    (``baselines.py:271``). ``hn_params``: the trainer's ``params.npz``,
    keyed by "/"-joined Flax paths. Returns (input rows, output rows or
    None)."""
    emb_in = np.asarray(hn_params["input_embeddings/embedding"])[:n_tokens]
    emb_out = None
    if "output_embeddings/embedding" in hn_params:
        emb_out = np.asarray(hn_params["output_embeddings/embedding"])[:n_tokens]
    return emb_in, emb_out


def apply_to_ft(base: Dict[str, torch.Tensor], ft: Dict[str, torch.Tensor],
                swapped: Dict[str, torch.Tensor], model_type: str,
                lam: float) -> Dict[str, torch.Tensor]:
    """Task-vector arithmetic over HF state dicts (``baselines.py:281``):
    ``ft + lam * (swapped - base)`` on every weight but the vocab tables,
    which come from ``swapped`` (the input table, the untied head, and a
    tied head's copy of the input table, ``lm_head.weight``; no supported
    family has an lm-head bias). Keys are ``ft``'s."""
    from ..models.backbones.registry import IN_EMBEDDING_KEYS, OUT_EMBEDDING_KEYS, check_supported

    check_supported(model_type)
    tables = {IN_EMBEDDING_KEYS[model_type], OUT_EMBEDDING_KEYS.get(model_type, "lm_head.weight"),
              "lm_head.weight"}
    out = {}
    for key, ft_val in ft.items():
        if key in tables:
            out[key] = swapped[key]
        else:
            out[key] = ft_val + lam * (swapped[key] - base[key])
    return out
