"""Text streams (counterpart of ``zett_tpu/data/datasets.py``): per-language
infinite packed streams, single-language (or mixed) training batches, and
the deterministic validation batches, and the language list with its
sampling probabilities (explicit weights, or corpus sizes from a metadata
CSV raised to ``language_sampling_alpha``).

Sources are ``<lang>.txt`` files (one text per line) under a training
directory, or in-memory ``texts_by_lang``. The JAX package also reads HF
dataset directories and parquet files through ``datasets``, which the port
does not use: such sources raise.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from torch.utils.data import Dataset, IterableDataset, get_worker_info

from ..constants import MAX_CHARS_PER_TOKEN


def open_text_source(directory: str, lang: str) -> List[str]:
    """The texts of ``<directory>/<lang>.txt``, one per non-blank line."""
    path_txt = os.path.join(directory, f"{lang}.txt")
    if os.path.exists(path_txt):
        with open(path_txt) as f:
            return [line.rstrip("\n") for line in f if line.strip()]
    for other in (os.path.join(directory, lang), os.path.join(directory, f"{lang}.parquet")):
        if os.path.exists(other):
            raise NotImplementedError(
                f"{other}: HF dataset and parquet sources are not ported; give {lang}.txt")
    raise ValueError(f"No training data for language {lang} in {directory}")


def _resolve_sources(langs: Sequence[str], train_directory: Optional[str],
                     texts_by_lang: Optional[Dict[str, List[str]]]) -> Dict[str, object]:
    sources: Dict[str, object] = {}
    for lang in langs:
        if texts_by_lang is not None and lang in texts_by_lang:
            sources[lang] = texts_by_lang[lang]
        else:
            if train_directory is None:
                raise ValueError(f"no data source for {lang}")
            sources[lang] = open_text_source(train_directory, lang)
    return sources


class LanguageStream:
    """Infinite packed-text stream over one language's corpus.

    Epoch e of a language with seed s is the permutation rng([s, e]); a
    worker consumes its strided slice [worker_idx::num_workers] of each
    epoch. Texts are greedily packed with the eos separator until the packed
    string reaches ``min_chars``."""

    def __init__(self, source, *, min_chars: int, eos_token: Optional[str] = None,
                 do_packing: bool = True, seed: int = 0, worker_idx: int = 0,
                 num_workers: int = 1):
        if len(source) == 0:
            raise ValueError("empty corpus")
        self.source = source
        self.min_chars = min_chars
        self.eos = eos_token or ""
        self.do_packing = do_packing
        self.seed = seed
        self.worker_idx = worker_idx
        self.num_workers = num_workers
        self._epoch = -1
        self._order = np.empty(0, dtype=np.int64)
        self._cursor = 0

    def _advance_epoch(self):
        self._epoch += 1
        rng = np.random.default_rng([self.seed, self._epoch])
        self._order = rng.permutation(len(self.source))[self.worker_idx::self.num_workers]
        self._cursor = 0

    def _next_raw(self) -> str:
        while True:
            if self._cursor >= len(self._order):
                self._advance_epoch()
            text = self.source[int(self._order[self._cursor])]
            self._cursor += 1
            text = text.strip()
            if text:
                return text

    def __iter__(self) -> Iterator[str]:
        return self

    def __next__(self) -> str:
        parts = [self._next_raw()]
        if self.do_packing:
            total = len(parts[0])
            while total < self.min_chars:
                nxt = self._next_raw()
                total += len(self.eos) + len(nxt)
                parts.append(nxt)
        return self.eos.join(parts)


class TrainDataset(IterableDataset):
    """Infinite stream of text batches: one language drawn per batch (or,
    with ``mix_languages``, per text under the tag "all")."""

    def __init__(self, langs: Sequence[str], language_probs: Optional[np.ndarray] = None,
                 batch_size: int = 128, block_size: int = 128,
                 train_directory: Optional[str] = None,
                 texts_by_lang: Optional[Dict[str, List[str]]] = None,
                 do_sequence_packing: bool = True, eos_token: Optional[str] = None,
                 mix_languages: bool = False, seed: int = 0):
        self.langs = [l for l in langs if l != "all"]
        if language_probs is None:
            probs = np.ones(len(self.langs), dtype=np.float64)
        else:
            probs = np.asarray(language_probs, dtype=np.float64)
            if len(probs) != len(self.langs):
                raise ValueError("one probability per language")
        self.language_probs = probs / probs.sum()
        self.batch_size = batch_size
        self.min_chars = block_size * MAX_CHARS_PER_TOKEN
        self.do_sequence_packing = do_sequence_packing
        self.eos_token = eos_token
        self.mix_languages = mix_languages
        self.seed = seed
        self.dataset = _resolve_sources(self.langs, train_directory, texts_by_lang)

    def get_texts_in_each_language(self, n: int) -> Dict[str, List[str]]:
        return {lang: list(self.dataset[lang][:n]) for lang in self.langs}

    def get_texts(self, n: int) -> List[str]:
        texts: List[str] = []
        for batch in self:
            texts.extend(batch["texts"])
            if len(texts) >= n:
                break
        return texts[:n]

    def _make_streams(self, worker_idx: int, num_workers: int):
        return {
            lang: LanguageStream(
                self.dataset[lang], min_chars=self.min_chars, eos_token=self.eos_token,
                do_packing=self.do_sequence_packing, seed=self.seed + i,
                worker_idx=worker_idx, num_workers=num_workers,
            )
            for i, lang in enumerate(self.langs)
        }

    def __iter__(self):
        info = get_worker_info()
        num_workers = info.num_workers if info is not None else 1
        worker_idx = info.id if info is not None else 0
        streams = self._make_streams(worker_idx, num_workers)
        rng = np.random.default_rng([self.seed, 977, worker_idx])
        while True:
            if self.mix_languages:
                choice = rng.choice(len(self.langs), size=self.batch_size, p=self.language_probs)
                yield {"texts": [next(streams[self.langs[c]]) for c in choice],
                       "lang_code": "all"}
            else:
                lang = self.langs[int(rng.choice(len(self.langs), p=self.language_probs))]
                yield {"texts": [next(streams[lang]) for _ in range(self.batch_size)],
                       "lang_code": lang}


class ValidDataset(Dataset):
    """Deterministic map-style dataset of per-language text batches
    (``datasets.py:254``): the index is a (language, offset) table over
    each language's full batches in order; a language with fewer texts than
    one batch keeps one partial batch, padded with empty texts (all-padding
    rows that count in no loss or bits-per-byte denominator)."""

    def __init__(self, langs: Sequence[str], batch_size: int, n_subsample: Optional[int] = None,
                 valid_directory: Optional[str] = None,
                 texts_by_lang: Optional[Dict[str, List[str]]] = None):
        self.langs = [l for l in langs if l != "all"]
        self.batch_size = batch_size
        self.dataset: Dict[str, List[str]] = {}
        self._index: List[Tuple[str, int]] = []
        for lang in self.langs:
            if texts_by_lang is not None and lang in texts_by_lang:
                texts = list(texts_by_lang[lang])
            else:
                if valid_directory is None:
                    raise ValueError(f"no validation data for {lang}")
                texts = open_text_source(valid_directory, lang)
            if n_subsample is not None:
                texts = texts[:n_subsample]
            self.dataset[lang] = texts
            n_batches = len(texts) // batch_size
            self._index.extend((lang, b * batch_size) for b in range(n_batches))
            if n_batches == 0 and texts:
                self._index.append((lang, 0))

    def __len__(self):
        return len(self._index)

    def __getitem__(self, idx):
        lang, start = self._index[idx]
        texts = self.dataset[lang][start:start + self.batch_size]
        texts = texts + [""] * (self.batch_size - len(texts))
        return {"texts": texts, "lang_code": lang}


# ------------------------------------------------------- language weighting
def language_probs_from_sizes(sizes: Sequence[float], alpha: float = 0.3) -> np.ndarray:
    """Sampling probabilities proportional to corpus_size ** alpha
    (``datasets.py:312``)."""
    p = np.asarray(sizes, dtype=np.float64) ** alpha
    return p / p.sum()


def load_language_list(path: str) -> Tuple[List[str], Optional[np.ndarray]]:
    """One code per line, or "code,weight" lines whose weights become the
    (normalized) sampling probabilities (``datasets.py:319``)."""
    with open(path) as f:
        rows = [line.strip() for line in f if line.strip()]
    if rows and "," in rows[0]:
        langs = [r.split(",")[0].strip() for r in rows]
        weights = np.asarray([float(r.split(",")[1]) for r in rows])
        return langs, weights / weights.sum()
    return rows, None


def language_sizes_from_metadata(langs: Sequence[str], csv_path: str,
                                 size_column: str = "n_pages") -> np.ndarray:
    """Per-language corpus sizes from a metadata CSV with a header row that
    names ``lang_code`` and ``size_column`` (MADLAD-400's table,
    ``datasets.py:333``); a language missing from it raises ``KeyError``."""
    with open(csv_path) as f:
        header = f.readline().strip().split(",")
        key_i, size_i = header.index("lang_code"), header.index(size_column)
        table = {}
        for line in f:
            cells = line.strip().split(",")
            if len(cells) > max(key_i, size_i):
                table[cells[key_i]] = float(cells[size_i])
    missing = [lang for lang in langs if lang not in table]
    if missing:
        raise KeyError(f"languages missing from {csv_path}: {missing}")
    return np.asarray([table[lang] for lang in langs])
