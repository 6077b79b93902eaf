"""The port's training data path (zett_tpu_torch/data, tokenization/sampler,
fast_encode and the native host library built from zett_tpu_torch/csrc)
held against the JAX package: the same seed, texts and tokenizer JSON give
bit-identical text streams and Collator batches."""

import os

import numpy as np
import pytest

from zett_tpu.data import Collator as JaxCollator
from zett_tpu.data import DataConfig as JaxDataConfig
from zett_tpu.data import TrainDataset as JaxTrainDataset
from zett_tpu.tokenization import Tokenizer as JaxTokenizer
from zett_tpu.tokenization.convert import convert_to_byte_level as jax_convert
from zett_tpu_torch.csrc import host_lib
from zett_tpu_torch.data import Collator, DataConfig, TrainDataset
from zett_tpu_torch.tokenization.convert import convert_to_byte_level
from zett_tpu_torch.tokenization.core import Tokenizer

CFG = dict(block_size=32, hn_surface_maxlen=7, n_token_subsample=256, pad_to_multiple_of=64,
           tokenizer_sample_mean=2000, tokenizer_sample_std=0, tokenizer_sample_min=512,
           tokenizer_sample_max=2048, tokenizer_noise_mean=1e-5, tokenizer_noise_std=2.0,
           langs=["en"])


@pytest.fixture(scope="module")
def tokenizers():
    """(JAX reference, port reference) from the same byte-level JSON."""
    from fixtures import _build_gpt2_like, _cached

    data, _ = jax_convert(JaxTokenizer.from_json(_cached("gpt2_like", _build_gpt2_like)))
    data = data.to_json()
    return JaxTokenizer.from_json(data), Tokenizer.from_json(data)


@pytest.fixture(scope="module")
def texts(corpus):
    return [t for t in corpus if t.strip()]


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        va, vb = a[key], b[key]
        if isinstance(va, dict):
            assert va == vb, key
        elif isinstance(va, np.ndarray):
            vb = np.asarray(vb)
            assert va.dtype == vb.dtype and va.shape == vb.shape, key
            assert np.array_equal(va, vb), key
        else:
            assert va == vb, key


def test_host_library_is_built_from_the_port(tmp_path, monkeypatch):
    """The port compiles its own copy of zett_host.cpp with g++ into its
    build directory, never into a source tree."""
    assert os.path.dirname(host_lib._SRC).endswith(os.path.join("zett_tpu_torch", "csrc"))
    path = host_lib.lib_path()
    assert os.sep.join(("build", "zett_tpu_torch")) in path
    host_lib.lib()
    assert os.path.exists(path)
    monkeypatch.setattr(host_lib, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        host_lib.build()


@pytest.mark.parametrize("mix", [False, True])
def test_train_dataset_streams_equal(texts, tmp_path, mix):
    by_lang = {"en": texts[:60], "de": texts[60:100]}
    kw = dict(langs=["en", "de"], batch_size=5, block_size=8, mix_languages=mix, seed=3,
              eos_token="<|endoftext|>")
    for lang, lines in by_lang.items():
        (tmp_path / f"{lang}.txt").write_text("\n".join(lines) + "\n")
    for source in (dict(texts_by_lang=by_lang), dict(train_directory=str(tmp_path))):
        a = iter(JaxTrainDataset(**source, **kw))
        b = iter(TrainDataset(**source, **kw))
        for _ in range(12):
            assert next(a) == next(b)


@pytest.mark.parametrize("subsample", [256, None])
def test_sampled_batches_equal(tokenizers, texts, subsample):
    jref, tref = tokenizers
    kw = dict(batch_size=8, initial_texts={"en": texts[:32]}, seed=5)
    a = JaxCollator(reference=jref, hn_tokenizer=jref.copy(),
                    data_config=JaxDataConfig(**{**CFG, "n_token_subsample": subsample}), **kw)
    b = Collator(reference=tref, hn_tokenizer=tref.copy(),
                 data_config=DataConfig(**{**CFG, "n_token_subsample": subsample}), **kw)
    for i in range(3):
        item = {"texts": texts[8 * i + 3: 8 * i + 11], "lang_code": "en"}
        _assert_batches_equal(a(item), b(item))


@pytest.mark.parametrize("fixed", ["bpe", "unigram"])
def test_fixed_tokenizer_batches_equal(tokenizers, texts, fixed):
    """Fixed-tokenizer batches: the reference's own BPE (native BPE encode)
    and a sampled Unigram tokenizer written out as JSON."""
    jref, tref = tokenizers
    if fixed == "bpe":
        jfixed, tfixed = jref.copy(), tref.copy()
    else:
        sampler = JaxCollator(reference=jref, hn_tokenizer=jref.copy(),
                              data_config=JaxDataConfig(**CFG), batch_size=8,
                              initial_texts={"en": texts[:32]}, seed=1)
        tok = sampler.sample_tokenizer(texts[:8], sampler.samplers["en"][0])[0].to_json()
        jfixed, tfixed = JaxTokenizer.from_json(tok), Tokenizer.from_json(tok)
    cfg = {**CFG, "do_tokenizer_sampling": False, "n_token_subsample": None}
    a = JaxCollator(reference=jref, hn_tokenizer=jref.copy(), data_config=JaxDataConfig(**cfg),
                    batch_size=4, fixed_tokenizer=jfixed, seed=0)
    b = Collator(reference=tref, hn_tokenizer=tref.copy(), data_config=DataConfig(**cfg),
                 batch_size=4, fixed_tokenizer=tfixed, seed=0)
    for i in range(2):
        item = {"texts": texts[4 * i: 4 * i + 4], "lang_code": "en"}
        _assert_batches_equal(a(item), b(item))


def test_identity_batches_equal(tokenizers):
    jref, tref = tokenizers
    cfg = {**CFG, "do_tokenizer_sampling": False, "n_token_subsample": 64}
    a = JaxCollator(reference=jref, hn_tokenizer=jref.copy(), data_config=JaxDataConfig(**cfg),
                    batch_size=4, fixed_tokenizer=jref.copy(), lang_code="en", seed=2)
    b = Collator(reference=tref, hn_tokenizer=tref.copy(), data_config=DataConfig(**cfg),
                 batch_size=4, fixed_tokenizer=tref.copy(), lang_code="en", seed=2)
    for _ in range(3):
        _assert_batches_equal(a(None, for_identity_step=True), b(None, for_identity_step=True))


def test_converted_tokenizer_matches(tokenizers):
    """The identity collator's byte-level conversion (specials matched,
    whitespace made consistent) gives the JAX package's vocab."""
    jref, tref = tokenizers
    a, _ = jax_convert(jref.copy(), match_special_tokens_to=jref, make_whitespace_consistent=True)
    b, _ = convert_to_byte_level(tref.copy(), match_special_tokens_to=tref,
                                 make_whitespace_consistent=True)
    assert a.get_vocab() == b.get_vocab()
