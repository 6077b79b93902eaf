"""Batch construction (counterpart of ``zett_tpu/data/collator.py``; the
batches are bit-identical to the JAX Collator's for the same seed, texts
and tokenizers).

Per batch: optionally sample a random Unigram tokenizer from the batch's
texts, tokenize the texts with it, subsample the vocabulary (positives +
random negatives, preserving special-token indices), and emit the
hypernet's inputs: target_surface_forms, target_priors, mask, ids_to_embed,
special indices, byte_lengths plus the LM's input_ids/attention_mask/labels.
An MLM run's masker (``inner_collator``) rewrites the ids and makes the
labels before the vocab is subsampled. Texts are encoded by the native fast
path (``fast_encode.py``) where the tokenizer is canonical byte-level, else
by ``Tokenizer.encode_batch``, as in the JAX Collator.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..constants import MAX_CHARS_PER_TOKEN, NEGATIVE_INF_FILL_VALUE
from ..tokenization.convert import BYTE_LEVEL_PRETOKENIZER, convert_to_byte_level
from ..tokenization.core import AddedToken, Tokenizer
from ..tokenization.fast_encode import fast_encoder_or_none
from ..tokenization.models import Unigram
from ..tokenization.sampler import TokenizerSampler
from ..tokenization.surface_forms import get_surface_form_matrix
from .config import DataConfig


def build_sampled_tokenizer(
    pieces: List[str],
    scores: List[float],
    reference: Tokenizer,
    add_prefix_space: bool = True,
) -> (Tokenizer, Dict[int, int]):
    """Assemble a Unigram tokenizer from sampled pieces, completing the byte
    alphabet and splicing the reference's special tokens at their reference
    ids (``zett_tpu/data/collator.py:28``)."""
    from ..tokenization.bytemaps import CHARS_TO_BYTES

    pieces = list(pieces)
    scores = list(scores)
    piece_set = set(pieces)

    unknown_chars = sorted(set(CHARS_TO_BYTES.keys()) - piece_set)
    min_score = min(scores) if scores else 0.0
    pieces = unknown_chars + pieces
    scores = [min_score] * len(unknown_chars) + scores

    ref_special_tokens = reference.all_special_tokens
    ref_special_ids = reference.all_special_ids

    for token in set(ref_special_tokens) & set(pieces):
        idx = pieces.index(token)
        pieces.pop(idx)
        scores.pop(idx)

    special_ids_map: Dict[int, int] = {}
    order = np.argsort(ref_special_ids)
    for i in order:
        rid, rtok = ref_special_ids[i], ref_special_tokens[i]
        pieces.insert(rid, rtok)
        scores.insert(rid, 0.0)
        actual = pieces.index(rtok)
        if actual != rid:
            special_ids_map[rid] = actual

    data = {
        "version": "1.0",
        "added_tokens": [],
        "normalizer": {"type": "Prepend", "prepend": " "} if add_prefix_space else None,
        "pre_tokenizer": BYTE_LEVEL_PRETOKENIZER,
        "post_processor": (reference.post_processor.to_json()
                           if reference.post_processor is not None else None),
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {
            "type": "Unigram",
            "unk_id": None,
            "vocab": [[p, s] for p, s in zip(pieces, scores)],
            "byte_fallback": False,
        },
    }
    tok = Tokenizer.from_json(data)
    for rtok in ref_special_tokens:
        tok.register_added_token(
            AddedToken(rtok, normalized=False, special=True), pieces.index(rtok)
        )
    return tok, special_ids_map


class Collator:
    """Callable batch collator.

    reference: our byte-level reference tokenizer (source model's tokenizer,
    already converted) providing special tokens/post-processor.
    hn_tokenizer: the hypernet's byte-level tokenizer for surface forms.
    """

    def __init__(
        self,
        reference: Tokenizer,
        hn_tokenizer: Optional[Tokenizer],
        data_config: DataConfig,
        batch_size: Optional[int] = None,
        fixed_tokenizer: Optional[Tokenizer] = None,
        initial_texts: Optional[Dict[str, List[str]]] = None,
        lang_code: Optional[str] = None,
        inner_collator=None,
        is_validation: bool = False,
        seed: Optional[int] = None,
    ):
        self.reference = reference
        self.hn_tokenizer = hn_tokenizer
        self.cfg = data_config
        self.batch_size = batch_size
        self.lang_code = lang_code
        # the masker of an MLM run (``data/mlm.py``; collator.py:115): it
        # rewrites the ids and makes the labels
        self.inner_collator = inner_collator
        # a validation collator samples tokenizers without feeding the
        # sampler's pool (collator.py:214)
        self.is_validation = is_validation
        # per-batch rng: each __call__ reseeds from (seed, batch counter) so
        # the randomness of batch k is a pure function of the collator seed
        self._seed = (
            int(seed)
            if seed is not None
            else int(np.random.SeedSequence().generate_state(1)[0])
        )
        self._batch_counter = 0
        self.rng = np.random.default_rng(self._seed)
        # piece -> hn surface ids, persisted across batches (sampled vocabs
        # repeat pieces heavily, so each distinct piece tokenizes once)
        self._surface_cache: Dict[str, tuple] = {}
        self._fixed_fast = None  # (the fixed tokenizer's fast encoder or None,)

        if (fixed_tokenizer is None) != data_config.do_tokenizer_sampling:
            raise ValueError("a fixed tokenizer is given exactly when sampling is off")

        if not data_config.do_tokenizer_sampling:
            tokenizer = fixed_tokenizer
            self.original_length = len(tokenizer)
            # the passthrough hypernet's tables are keyed by the fixed
            # tokenizer's own ids: it is used as given (collator.py:140)
            if not data_config.use_passthrough_hypernet:
                tokenizer, _ = convert_to_byte_level(
                    tokenizer,
                    match_special_tokens_to=reference,
                    make_whitespace_consistent=True,
                )
            if hn_tokenizer is None or hn_tokenizer.get_vocab() == tokenizer.get_vocab():
                self.surface_forms = np.arange(len(tokenizer))[:, None].astype(np.int32)
            else:
                self.surface_forms, _ = get_surface_form_matrix(
                    tokenizer, data_config.hn_surface_maxlen, hn_tokenizer
                )
            self.tokenizer = tokenizer
            if isinstance(tokenizer.model, Unigram):
                scores = list(tokenizer.model.get_scores())
                while len(scores) < len(tokenizer):
                    scores.append(0.0)
                self.scores = np.array(scores)
            else:
                self.scores = np.zeros(len(tokenizer))
            all_tokens = [tokenizer.id_to_token(i) or "" for i in range(len(tokenizer))]
            self.byte_lengths = np.array([len(t) for t in all_tokens])
            self.inv_ids_to_embed = (
                np.zeros(len(tokenizer), dtype=np.int32)
                if data_config.n_token_subsample is not None
                else None
            )
        else:
            self.inv_ids_to_embed = (
                np.zeros(data_config.tokenizer_sample_max + 256, dtype=np.int32)
                if data_config.n_token_subsample is not None
                else None
            )

        self.samplers: Dict[str, List[TokenizerSampler]] = {}
        if initial_texts is not None:
            bs = self.batch_size or 512
            for lang, lang_texts in initial_texts.items():
                texts = [self._sample_span(t) for t in lang_texts]
                pools = []
                for _ in range(data_config.n_pools):
                    sampler = TokenizerSampler()
                    for start in range(0, len(texts), bs):
                        sampler.sample_tokenizer(
                            {t: 1 for t in texts[start : start + bs]},
                            30_000, 16, 4, 0.0, pop_prev=False,
                        )
                    pools.append(sampler)
                self.samplers[lang] = pools

    # ------------------------------------------------------------------ utils
    def _fast_encoder(self, tokenizer: Tokenizer):
        """The native fast encoder of ``tokenizer`` (or None): built once for
        the fixed tokenizer, which encodes every batch (a BPE's merge table
        takes a fifth of a second to build), and anew for each sampled one."""
        if tokenizer is not getattr(self, "tokenizer", None):
            return fast_encoder_or_none(tokenizer)
        if self._fixed_fast is None:
            self._fixed_fast = (fast_encoder_or_none(tokenizer),)
        return self._fixed_fast[0]

    def _sample_span(self, text: str) -> str:
        max_length = MAX_CHARS_PER_TOKEN * self.cfg.block_size
        if self.cfg.sample_text_span:
            start = int(self.rng.integers(0, max(len(text) - max_length, 0) + 1))
        else:
            start = 0
        return text[start : start + max_length]

    # ------------------------------------------------------- tokenizer sample
    def sample_tokenizer(self, texts: List[str], sampler: TokenizerSampler):
        cfg = self.cfg
        n_total = int(self.rng.normal(cfg.tokenizer_sample_mean, cfg.tokenizer_sample_std))
        n_total = min(max(n_total, cfg.tokenizer_sample_min), cfg.tokenizer_sample_max)

        if cfg.tokenizer_noise_mean > 0:
            noise_std = float(
                self.rng.lognormal(np.log(cfg.tokenizer_noise_mean), cfg.tokenizer_noise_std)
            )
        else:
            noise_std = 0.0

        sampled = sampler.sample_tokenizer(
            {t: 1 for t in texts}, n_total, 16, 4, noise_std,
            pop_prev=True, push_current=not self.is_validation, rng=self.rng,
        )
        pieces = [p for p, _ in sampled]
        scores = [s for _, s in sampled]

        tokenizer, special_ids_map = build_sampled_tokenizer(
            pieces, scores, self.reference, cfg.add_prefix_space
        )
        vocab_len = len(tokenizer)
        priors = np.zeros(vocab_len)
        model_scores = tokenizer.model.get_scores()
        priors[: len(model_scores)] = model_scores

        tokens = [tokenizer.id_to_token(i) or "" for i in range(vocab_len)]
        byte_lengths = np.array([len(t) for t in tokens])

        if self.hn_tokenizer is not None:
            surface_forms, _ = get_surface_form_matrix(
                tokens, cfg.hn_surface_maxlen, self.hn_tokenizer,
                cache=self._surface_cache,
            )
        else:
            surface_forms = None
        return tokenizer, special_ids_map, surface_forms, priors, byte_lengths

    # ----------------------------------------------------------------- encode
    def encode(
        self,
        tokenizer: Tokenizer,
        texts: List[str],
        surface_forms: np.ndarray,
        priors: np.ndarray,
        special_ids_map: Optional[Dict[int, int]] = None,
        byte_lengths: Optional[np.ndarray] = None,
    ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if len(priors) != len(surface_forms):
            raise ValueError("one prior per surface form")

        pad_token = None
        for cand in ("<pad>", "<|endoftext|>", "</s>", "[PAD]"):
            if tokenizer.token_to_id(cand) is not None:
                pad_token = cand
                break
        if pad_token is None and tokenizer.all_special_tokens:
            pad_token = tokenizer.all_special_tokens[0]
        pad_id = tokenizer.token_to_id(pad_token) if pad_token else 0

        fast = self._fast_encoder(tokenizer)
        if fast is not None:
            input_ids, attention_mask = fast.encode_batch(
                texts, add_special_tokens=True, max_length=cfg.block_size, pad_id=pad_id
            )
        else:
            tokenizer.enable_truncation(cfg.block_size)
            tokenizer.enable_padding(
                length=cfg.block_size, pad_id=pad_id, pad_token=pad_token or ""
            )
            encs = tokenizer.encode_batch(texts, add_special_tokens=True)
            tokenizer.no_truncation()
            tokenizer.no_padding()
            input_ids = np.array([e.ids for e in encs], dtype=np.int32)
            attention_mask = np.array([e.attention_mask for e in encs], dtype=np.int32)

        for key, value in (special_ids_map or {}).items():
            input_ids[input_ids == key] = value

        encodings: Dict[str, np.ndarray] = {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
        }
        # after the special-id remap, before the vocab: the positives below
        # come from the masked ids (collator.py:284-287)
        if self.inner_collator is not None:
            encodings.update(self.inner_collator(tokenizer, input_ids))
        else:
            encodings["labels"] = input_ids.copy()

        input_ids = encodings["input_ids"]
        special_ids = np.array(tokenizer.all_special_ids, dtype=np.int64)
        positive_indices = np.unique(input_ids)

        if byte_lengths is not None:
            non_special = ~np.isin(input_ids, special_ids)
            blen = byte_lengths[input_ids]
            unk_id = tokenizer.token_to_id("<unk>")
            encodings["metrics"] = {
                "avg_byte_length": float(blen[non_special].mean()) if non_special.any() else 0.0,
                "unk_ratio": float((input_ids == unk_id).mean()) if unk_id is not None else 0.0,
            }
            encodings["byte_lengths"] = blen

        if cfg.n_token_subsample is not None:
            if cfg.n_token_subsample % cfg.pad_to_multiple_of:
                raise ValueError("n_token_subsample must be a multiple of pad_to_multiple_of")
            tokens_in_batch = np.concatenate([
                special_ids,
                np.setdiff1d(
                    np.unique(np.concatenate([input_ids.ravel(), encodings["labels"].ravel()])),
                    special_ids,
                ),
            ])
            tokens_in_batch = tokens_in_batch[tokens_in_batch >= 0]  # drop -100 labels
            if len(tokens_in_batch) > cfg.n_token_subsample:
                raise ValueError(f"{len(tokens_in_batch)} tokens in the batch exceed "
                                 f"n_token_subsample {cfg.n_token_subsample}")

            if cfg.subsample_mode == "positives_only":
                negatives = np.zeros(cfg.n_token_subsample - len(tokens_in_batch), dtype=np.int64)
            elif cfg.subsample_mode == "random":
                negatives = np.setdiff1d(np.arange(len(tokenizer)), positive_indices)
                if len(negatives) < cfg.n_token_subsample - len(tokens_in_batch):
                    raise ValueError("the vocab has too few negatives for n_token_subsample")
                self.rng.shuffle(negatives)
                negatives = negatives[: cfg.n_token_subsample - len(tokens_in_batch)]
            else:
                raise NotImplementedError(cfg.subsample_mode)

            ids_to_embed = list(np.concatenate([tokens_in_batch, negatives]))
            # keep special tokens at their original indices where possible (the
            # LM may hard-code e.g. the pad id)
            for special in sorted(special_ids):
                ids_to_embed.remove(special)
                ids_to_embed.insert(int(special), int(special))
            ids_to_embed = np.array(ids_to_embed, dtype=np.int64)

            if len(self.inv_ids_to_embed) < len(tokenizer):
                # sampled vocabs can exceed sample_max + 256: the sampler
                # force-includes the byte alphabet, whitespace runs and
                # specials on top of the requested size
                self.inv_ids_to_embed = np.zeros(len(tokenizer), dtype=np.int32)
            self.inv_ids_to_embed[ids_to_embed] = np.arange(len(ids_to_embed))
            encodings["input_ids"] = self.inv_ids_to_embed[encodings["input_ids"]]
            active = encodings["labels"] != -100
            encodings["labels"] = np.where(
                active, self.inv_ids_to_embed[np.where(active, encodings["labels"], 0)], -100
            )
            encodings["target_priors"] = priors[ids_to_embed]
            encodings["target_surface_forms"] = surface_forms[ids_to_embed]
            encodings["mask"] = np.ones(len(ids_to_embed), dtype=bool)
            encodings["ids_to_embed"] = ids_to_embed
            ids_list = list(ids_to_embed)
            encodings["special_indices"] = np.array(
                [ids_list.index(x) for x in special_ids]
            )
        else:
            length = len(priors)
            if cfg.do_tokenizer_sampling:
                if cfg.tokenizer_sample_max % cfg.pad_to_multiple_of:
                    raise ValueError("tokenizer_sample_max must be a multiple of "
                                     "pad_to_multiple_of")
                n_pad = cfg.tokenizer_sample_max + cfg.pad_to_multiple_of - length
                if n_pad < 0:
                    raise ValueError(
                        f"sampled vocab ({length}) exceeds tokenizer_sample_max + "
                        f"pad_to_multiple_of ({cfg.tokenizer_sample_max} + "
                        f"{cfg.pad_to_multiple_of}): sample_max must cover the "
                        "256-char byte alphabet plus special tokens")
            elif length % cfg.pad_to_multiple_of != 0:
                n_pad = cfg.pad_to_multiple_of - (length % cfg.pad_to_multiple_of)
            else:
                n_pad = 0
            encodings["target_priors"] = np.pad(
                priors, (0, n_pad), constant_values=NEGATIVE_INF_FILL_VALUE
            )
            encodings["target_surface_forms"] = np.pad(
                surface_forms, ((0, n_pad), (0, 0)), constant_values=0
            )
            encodings["mask"] = np.concatenate(
                [np.ones(length, dtype=bool), np.zeros(n_pad, dtype=bool)]
            )
            encodings["ids_to_embed"] = np.concatenate(
                [np.arange(length), np.zeros(n_pad, dtype=np.int64)]
            )
            encodings["special_indices"] = special_ids

        if tokenizer.all_special_tokens != self.reference.all_special_tokens:
            raise ValueError("the batch tokenizer's special tokens are not the reference's")
        encodings["special_indices_in_reference"] = np.array(
            [self.reference.token_to_id(t) for t in tokenizer.all_special_tokens]
        )
        return encodings

    def inner_seed(self, batch: int) -> List[int]:
        """The masker's seed for batch ``batch``: (the Collator's seed, the
        batch counter, 1, and the DataLoader worker's id + 1 inside a
        worker, else 0), so that workers forked from one Collator draw
        different masks (ROADMAP C.18; the JAX CLI's masker is unseeded)."""
        from torch.utils.data import get_worker_info

        info = get_worker_info()
        return [self._seed, batch, 1, 0 if info is None else info.id + 1]

    # --------------------------------------------------------------- __call__
    def __call__(self, data, for_identity_step: bool = False) -> Dict[str, np.ndarray]:
        self.rng = np.random.default_rng([self._seed, self._batch_counter])
        reseed = getattr(self.inner_collator, "reseed", None)
        if reseed is not None:
            reseed(self.inner_seed(self._batch_counter))
        self._batch_counter += 1
        if for_identity_step:
            indices = self.rng.choice(
                self.original_length, size=self.cfg.n_token_subsample, replace=False
            )
            return {
                "target_surface_forms": self.surface_forms[indices],
                "target_priors": np.zeros(len(indices), dtype=np.float32),
                "ids_to_embed": indices,
                "lang_code": self.lang_code,
                "lang_index": np.array(
                    self.cfg.langs.index(self.lang_code) if self.lang_code else 0
                ),
            }

        if isinstance(data, dict):
            texts_in = data["texts"]
            lang_code = data.get("lang_code")
        elif "texts" in data[0]:
            texts_in = data[0]["texts"]
            lang_code = data[0].get("lang_code")
        else:
            texts_in = [e["text"] for e in data]
            lang_code = None
        if self.lang_code is not None:
            lang_code = self.lang_code

        texts = [self._sample_span(t) for t in texts_in]

        if self.cfg.do_tokenizer_sampling:
            pools = self.samplers[lang_code]
            sampler = pools[int(self.rng.integers(0, len(pools)))]
            tokenizer, special_ids_map, surface_forms, priors, byte_lengths = (
                self.sample_tokenizer(texts, sampler)
            )
        else:
            tokenizer = self.tokenizer
            special_ids_map = {}
            surface_forms = self.surface_forms
            priors = self.scores
            byte_lengths = self.byte_lengths

        encodings = self.encode(
            tokenizer, texts, surface_forms, priors,
            special_ids_map=special_ids_map, byte_lengths=byte_lengths,
        )
        encodings["lang_code"] = lang_code
        encodings["lang_index"] = np.array(
            self.cfg.langs.index(lang_code) if lang_code in self.cfg.langs else 0
        )
        return encodings
