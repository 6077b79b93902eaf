"""Llama-3 in the port, held against the JAX package (and HF) on the CPU.

- A small byte-level BPE trained with ``tokenizers`` under Llama-3's
  structure (Meta-Llama-3-8B's tokenizer.json: Split(its pattern,
  Isolated) then ByteLevel without prefix space or regex, ignore_merges,
  the post-processor Sequence[ByteLevel, TemplateProcessing] with
  <|begin_of_text|>, a ByteLevel decoder, 256 specials after the pieces),
  with one vocab entry that no merge reaches: the port's encode equals the
  JAX package's field for field and HF's ids; chunked_tokenize, the
  pretoken counts and the substring prior under it equal JAX's (under
  Qwen2's structure chunked_tokenize equals JAX's general pipeline, where
  JAX's fast path runs the GPT-2 split: ROADMAP C.24).
- A tiny Llama at Llama-3's ratios (rope_theta 500000, 4 query heads over
  1 KV head, untied head): its logits against JAX's and HF's, and
  ``transfer()``'s tables from it under that tokenizer against JAX's,
  within the Llama tolerances of ``test_torch_port_llama.py``.
- ``rope_scaling`` (Llama-3.1's) is read by neither package (ROADMAP C.23).
- ``chip_smoke.llama3_tokenizer_json`` (phase 20's generator) at a small
  size: the port's encode equals JAX's and HF's on its output.
"""

import json
import os

import numpy as np
import pytest
import torch
from flax import traverse_util

import jax.numpy as jnp
from fixtures import CORPUS
from zett_tpu.evaluation.perplexity import chunked_tokenize as jax_chunked_tokenize
from zett_tpu.models import HypernetConfig as JaxHnConfig
from zett_tpu.models.backbones.loader import convert_llama
from zett_tpu.models.backbones.registry import build_model as jax_build_model
from zett_tpu.tokenization import Tokenizer as JaxTokenizer
from zett_tpu.tokenization import priors as jax_priors
from zett_tpu.tokenization.convert import convert_to_byte_level as jax_convert
from zett_tpu.transfer import transfer as jax_transfer
from zett_tpu_torch.evaluation.perplexity import chunked_tokenize
from zett_tpu_torch.models import Hypernet, HypernetConfig
from zett_tpu_torch.models.backbones.llama import LlamaConfig, LlamaForCausalLM
from zett_tpu_torch.models.convert import flax_to_torch
from zett_tpu_torch.tokenization import Tokenizer
from zett_tpu_torch.tokenization import priors
from zett_tpu_torch.tokenization.convert import convert_to_byte_level
from zett_tpu_torch.transfer import transfer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK = os.path.join(REPO, "artifacts", "tokenizers", "{}", "tokenizer.json")
FIELDS = ("ids", "tokens", "offsets", "type_ids", "attention_mask", "special_tokens_mask")
# Meta-Llama-3-8B's tokenizer.json, pre_tokenizer.pretokenizers[0].pattern.Regex
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
UNREACHED = "Ġzzqx"  # " zzqx": in the vocab, reached by no merge
TEXTS = CORPUS + [
    "zzqx and zzqx zzqx, zzqxx", "It'S ſ's K'd İ'll ı've\r\n\r\n  \u0085x y\xa0z",
    "digits 1234567 ١٢٣٤ 𝟙𝟚 é̈ x\x1c\x1d\x1e\x1fy   ", "trailing spaces   ",
    "<|begin_of_text|> inside <|eot_id|>text"]


def _specials():
    names = {0: "<|begin_of_text|>", 1: "<|end_of_text|>", 6: "<|start_header_id|>",
             7: "<|end_header_id|>", 9: "<|eot_id|>"}
    reserved = iter(range(256))
    return [names.get(i) or f"<|reserved_special_token_{next(reserved)}|>" for i in range(256)]


@pytest.fixture(scope="module")
def llama3_json():
    """The small Llama-3-structured tokenizer.json, built by tokenizers."""
    from tokenizers import Regex, Tokenizer as HfTokenizer, decoders, models, pre_tokenizers
    from tokenizers import processors, trainers

    tok = HfTokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    trainer = trainers.BpeTrainer(vocab_size=1500, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS * 5, trainer)
    data = json.loads(tok.to_str())
    vocab = data["model"]["vocab"]
    assert UNREACHED not in vocab
    vocab[UNREACHED] = len(vocab)
    tok = HfTokenizer.from_str(json.dumps(data))
    n = tok.get_vocab_size()
    tok.add_special_tokens(_specials())
    assert tok.token_to_id("<|begin_of_text|>") == n
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(
            single="<|begin_of_text|> $A", pair="<|begin_of_text|> $A <|begin_of_text|>:1 $B:1",
            special_tokens=[("<|begin_of_text|>", n)])])
    tok.decoder = decoders.ByteLevel()
    return json.loads(tok.to_str())


def _assert_same(a, b, what):
    for f in FIELDS:
        got, want = getattr(b, f), getattr(a, f)
        assert [tuple(x) if isinstance(x, (list, tuple)) else x for x in got] == \
            [tuple(x) if isinstance(x, (list, tuple)) else x for x in want], (what, f)


def _three(data):
    from tokenizers import Tokenizer as HfTokenizer

    raw = json.dumps(data)
    return JaxTokenizer.from_str(raw), Tokenizer.from_str(raw), HfTokenizer.from_str(raw)


def test_llama3_tokenizer_encodes_as_jax_and_hf(llama3_json):
    """Every text with and without special tokens: the port's encode field
    for field as JAX's, ids as HF's; decode as JAX's; the unreached entry
    comes out whole (ignore_merges)."""
    jtok, tok, hf = _three(llama3_json)
    assert tok.to_str() == jtok.to_str()
    for text in TEXTS:
        for special in (True, False):
            a, b = jtok.encode(text, add_special_tokens=special), \
                tok.encode(text, add_special_tokens=special)
            _assert_same(a, b, (text, special))
            assert b.ids == hf.encode(text, add_special_tokens=special).ids, (text, special)
            for skip in (True, False):
                assert tok.decode(b.ids, skip_special_tokens=skip) == \
                    jtok.decode(a.ids, skip_special_tokens=skip)
    unreached = tok.token_to_id(UNREACHED)
    assert tok.encode("zzqx and zzqx", add_special_tokens=False).ids.count(unreached) == 1


# Qwen2-7B's tokenizer.json, pre_tokenizer.pretokenizers[0].pattern.Regex
QWEN2_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
               r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def test_chunked_tokenize_and_priors_match_jax(llama3_json, monkeypatch):
    """Under the Llama-3-structured tokenizer (the general pipeline and the
    matcher): chunked_tokenize, the pretoken counts and the substring prior
    equal JAX's. Under the same pieces with Qwen2's structure (its split, a
    plain ByteLevel post-processor), JAX's chunked_tokenize takes its fast
    path, which runs the GPT-2 split in place of Qwen2's and gives other ids
    than its own encode (ROADMAP C.24); the port's equals JAX's general
    pipeline there, and its own encode."""
    import zett_tpu.evaluation.perplexity as jax_perplexity

    texts = [t for t in TEXTS if t.strip()]
    qwen2 = json.loads(json.dumps(llama3_json))
    qwen2["pre_tokenizer"]["pretokenizers"][0]["pattern"]["Regex"] = QWEN2_SPLIT
    qwen2["post_processor"] = {"type": "ByteLevel", "add_prefix_space": False,
                               "trim_offsets": False, "use_regex": False}
    for data in (llama3_json, qwen2):
        jtok, tok, _ = _three(data)
        counts = priors.get_pretoken_counts(tok, texts)
        assert counts == jax_priors.get_pretoken_counts(jtok, texts)
        np.testing.assert_array_equal(priors.compute_substring_prior(tok, texts=texts),
                                      jax_priors.compute_substring_prior(jtok, texts=texts))
        got = chunked_tokenize(tok, texts, 32)
        with monkeypatch.context() as m:
            if data is qwen2:
                fast = jax_chunked_tokenize(jtok, texts, 32)
                assert not np.array_equal(fast["input_ids"][:1], got["input_ids"][:1])
                m.setattr(jax_perplexity, "fast_encoder_or_none", lambda t: None)
            want = jax_chunked_tokenize(jtok, texts, 32)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        encoded = [i for t in texts for i in tok.encode(t.strip(), add_special_tokens=False).ids]
        assert got["input_ids"].ravel().tolist() == encoded[:got["input_ids"].size]


def _hf_llama3(vocab):
    """A tiny HF Llama at Llama-3's ratios, weights from torch's seed 0 and
    non-trivial RMSNorm weights."""
    import transformers as tf

    cfg = tf.LlamaConfig(vocab_size=vocab, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
                         rope_theta=500000.0, rms_norm_eps=1e-5, max_position_embeddings=64,
                         tie_word_embeddings=False)
    torch.manual_seed(0)
    model = tf.LlamaForCausalLM(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.add_(0.1 * torch.randn(p.shape))
    return model, cfg


def _logits(cfg_dict, hf_cfg, sd, ids, mask, dtype):
    tdt, jdt = dtype
    cfg = LlamaConfig.from_hf(cfg_dict)
    port = LlamaForCausalLM(cfg, sd, tdt)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask), sd["model.embed_tokens.weight"],
                   sd["lm_head.weight"]).float().numpy()
    module, jcfg = jax_build_model("llama", hf_config=hf_cfg, dtype=jdt)
    params = convert_llama({k: v.numpy() for k, v in sd.items()}, jcfg)
    ref = np.asarray(jnp.asarray(module.apply({"params": params}, jnp.asarray(ids),
                                              attention_mask=jnp.asarray(mask)), jnp.float32))
    return cfg, got, ref


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_llama3_backbone_matches_jax_and_hf(dtype_name):
    """Logits on the unpadded positions of (2, 12) ids with a padded row:
    f32 within 1e-5 of JAX's and within 2e-4 absolute plus 1e-3 relative of
    HF torch's; bf16 within 2 bf16 ulps of JAX's largest logit."""
    hf, hf_cfg = _hf_llama3(128)
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, size=(2, 12)).astype(np.int64)
    mask = np.ones((2, 12), np.int64)
    mask[1, 8:] = 0
    valid = mask.astype(bool)
    dtype = {"float32": (torch.float32, jnp.float32),
             "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype_name]
    cfg, got, ref = _logits(hf_cfg.to_dict(), hf_cfg, sd, ids, mask, dtype)
    assert cfg.rope_theta == 500000.0 and cfg.kv_heads == 1 and not cfg.tie_word_embeddings
    err = np.abs(got - ref)[valid].max()
    if dtype_name == "float32":
        assert err <= 1e-5, err
        with torch.no_grad():
            theirs = hf(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).logits
        np.testing.assert_allclose(got[valid], theirs.numpy()[valid], atol=2e-4, rtol=1e-3)
    else:
        top = float(np.abs(ref).max())
        assert err <= 2 * 2.0 ** (np.floor(np.log2(top)) - 7), err


def test_rope_scaling_is_ignored_as_in_jax():
    """Llama-3.1's rope_scaling: neither package reads it (ROADMAP C.23), so
    the logits equal those of the same weights without it, in both, f32."""
    import transformers as tf

    hf, hf_cfg = _hf_llama3(128)
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    scaling = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 16}
    scaled_cfg = tf.LlamaConfig(**dict(hf_cfg.to_dict(), rope_scaling=scaling))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 128, size=(2, 40)).astype(np.int64)
    mask = np.ones((2, 40), np.int64)
    f32 = (torch.float32, jnp.float32)
    _, got, ref = _logits(hf_cfg.to_dict(), hf_cfg, sd, ids, mask, f32)
    cfg, got_s, ref_s = _logits(scaled_cfg.to_dict(), scaled_cfg, sd, ids, mask, f32)
    assert not hasattr(cfg, "rope_scaling")
    np.testing.assert_array_equal(got_s, got)
    np.testing.assert_array_equal(ref_s, ref)
    with torch.no_grad():  # HF reads it: the reference and the port differ from HF here
        theirs = tf.LlamaForCausalLM(scaled_cfg)
        theirs.load_state_dict(hf.state_dict())
        scaled = theirs.eval()(torch.from_numpy(ids)).logits.numpy()
    assert np.abs(scaled - ref).max() > 1e-3


HN = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
          max_position_embeddings=8, n_embd=64, hn_surface_maxlen=7,
          embed_using_source_embeddings=True, n_extra_tokens=16, rescale_embeddings=True,
          predict_bias=True, separate_out_embeddings=True,
          hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def test_transfer_from_llama3_matches_jax(llama3_json):
    """transfer() to de_raw from the tiny Llama-3 under the Llama-3
    tokenizer (source and, converted to byte level, hn tokenizer), dual
    heads: both tables and the bias within 1e-5 of JAX's (f32 hypernet, sums
    in another order), special rows and the converted target identical."""
    import jax

    from zett_tpu.models import Hypernet as JaxHypernet

    jsource, source, _ = _three(llama3_json)
    vocab = len(source)
    hf, _ = _hf_llama3(vocab)
    emb_in = hf.state_dict()["model.embed_tokens.weight"].numpy()
    emb_out = hf.state_dict()["lm_head.weight"].numpy()
    cfg = dict(HN, original_vocab_size=vocab)
    src = np.concatenate([emb_in, emb_out], axis=1)
    src = np.concatenate([src, np.zeros(((-len(src)) % 128, src.shape[1]), np.float32)])
    jax_model = JaxHypernet(JaxHnConfig(**cfg))
    p = jax_model.init(jax.random.PRNGKey(0), jnp.ones((4, 7), jnp.int32), jnp.zeros(4),
                       jnp.asarray(src), 0)
    flat = traverse_util.flatten_dict(p["params"], sep="/")
    rng = np.random.default_rng(1)
    for k, v in flat.items():
        x = rng.normal(size=v.shape) / np.sqrt(v.shape[0]) if k.endswith("kernel") else \
            1.0 + 0.1 * rng.normal(size=v.shape) if k.endswith(("scale", "/w")) else \
            0.05 * rng.normal(size=v.shape)
        flat[k] = np.asarray(x, np.float32)
    model = Hypernet(HypernetConfig(**cfg))
    model.load_state_dict(flax_to_torch(flat))
    common = dict(source_embeddings_in=emb_in, source_embeddings_out=emb_out, lang_index=0,
                  batch_size=2048, seed=3)
    ref_in, ref_out, ref_bias, ref_tok = jax_transfer(
        hypernet=jax_model, hn_params=traverse_util.unflatten_dict(flat, sep="/"),
        hn_tokenizer=jax_convert(jsource)[0], source_tokenizer=jsource,
        target_tokenizer=JaxTokenizer.from_file(TOK.format("de_raw")), **common)
    got_in, got_out, got_bias, got_tok = transfer(
        hypernet=model, hn_tokenizer=convert_to_byte_level(source)[0], source_tokenizer=source,
        target_tokenizer=Tokenizer.from_file(TOK.format("de_raw")), **common)
    assert got_tok.to_str() == ref_tok.to_str()
    for got, ref in ((got_in, ref_in), (got_out, ref_out), (got_bias, ref_bias)):
        assert got.shape == ref.shape and np.abs(got - ref).max() <= 1e-5
    special = [got_tok.token_to_id(t) for t in got_tok.all_special_tokens]
    np.testing.assert_array_equal(got_in[special], ref_in[special])
    assert np.abs(got_in - got_out).max() > 0.01


def test_phase20_tokenizer_generator_encodes_as_jax_and_hf():
    """chip_smoke.py's Llama-3 tokenizer at 3000 pieces: every merge's parts
    and result in the vocab, the specials at 3000-3255 under Llama-3's
    names, and the port's encode of CORPUS and the README's paragraphs
    field for field as JAX's, ids as HF's, decode(encode(text)) == text."""
    import chip_smoke

    data = chip_smoke.llama3_tokenizer_json(3000)
    vocab = data["model"]["vocab"]
    assert len(vocab) == 3000 and all(a in vocab and b in vocab and a + b in vocab
                                      for a, b in data["model"]["merges"])
    jtok, tok, hf = _three(data)
    assert len(tok) == 3256 and tok.token_to_id("<|eot_id|>") == 3009
    assert tok.token_to_id("<|reserved_special_token_250|>") == 3255
    with open(os.path.join(REPO, "README.md")) as f:
        paragraphs = [p for p in f.read().split("\n\n") if p.strip()][:40]
    for text in TEXTS + paragraphs:
        a, b = jtok.encode(text), tok.encode(text)
        _assert_same(a, b, text)
        assert b.ids == hf.encode(text).ids, text
        assert tok.decode(tok.encode(text, add_special_tokens=False).ids) == text or \
            "<|" in text
