"""The port's eval entry points (zett_tpu_torch/evaluation: perplexity.py,
choice.py, the perplexity CLI ``__main__.py`` and the choice CLI) held
against the JAX package on the CPU, on tiny GPT-2 and Llama directories
with seeded weights: chunked tokenization (the native fast path and the
general encode pipeline), evaluate_lm with special ids and an external
bias (loss, perplexity, bits-per-char and chars-per-token within 1e-5
relative, n_tokens equal), score_loglikelihoods (each request's ll within
1e-4 absolute, n_tokens, n_bytes and greedy equal), evaluate_choice_task,
both CLIs on the same HF directory; then the Collator's general encode
branch and the general get_pretoken_counts."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import fixtures
from zett_tpu.evaluation.choice import evaluate_choice_task as jax_choice_task
from zett_tpu.evaluation.choice import main as jax_choice_main
from zett_tpu.evaluation.choice import score_loglikelihoods as jax_score
from zett_tpu.evaluation.__main__ import main as jax_ppl_main
from zett_tpu.evaluation.perplexity import chunked_tokenize as jax_chunked
from zett_tpu.evaluation.perplexity import evaluate_lm as jax_evaluate_lm
from zett_tpu.models.backbones.loader import load_backbone_params
from zett_tpu.models.backbones.registry import build_model as jax_build_model
from zett_tpu.tokenization import Tokenizer as JaxTokenizer
from zett_tpu.tokenization import priors as jax_priors
from zett_tpu_torch.evaluation import choice
from zett_tpu_torch.evaluation.__main__ import main as ppl_main
from zett_tpu_torch.evaluation.perplexity import chunked_tokenize, evaluate_lm, load_causal_lm
from zett_tpu_torch.models.backbones.hf_io import save_hf_model
from zett_tpu_torch.tokenization import Tokenizer
from zett_tpu_torch.tokenization import priors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPA = os.path.join(REPO, "out", "multilingual_eval", "copa_{}.jsonl")
TOKENIZERS = ("xlmr_like", "llama_like", "gpt2_like")  # general, general, fast path
RTOL = 1e-5


def _tokenizer_json(name):
    return json.dumps(fixtures._cached(name, getattr(fixtures, f"_build_{name}")))


def _gpt2_state(vocab, rng, E=32, n_layer=2, n_pos=256):
    def normal(*shape, s=0.02):
        return torch.from_numpy(s * rng.standard_normal(shape, dtype=np.float32))

    sd = {"transformer.wte.weight": normal(vocab, E, s=0.5),
          "transformer.wpe.weight": normal(n_pos, E, s=0.1),
          "transformer.ln_f.weight": 1 + normal(E), "transformer.ln_f.bias": normal(E)}
    for i in range(n_layer):
        for name, shape in (("ln_1.weight", (E,)), ("ln_1.bias", (E,)), ("ln_2.weight", (E,)),
                            ("ln_2.bias", (E,)), ("attn.c_attn.weight", (E, 3 * E)),
                            ("attn.c_attn.bias", (3 * E,)), ("attn.c_proj.weight", (E, E)),
                            ("attn.c_proj.bias", (E,)), ("mlp.c_fc.weight", (E, 4 * E)),
                            ("mlp.c_fc.bias", (4 * E,)), ("mlp.c_proj.weight", (4 * E, E)),
                            ("mlp.c_proj.bias", (E,))):
            sd[f"transformer.h.{i}.{name}"] = normal(*shape, s=0.2)
    config = {"model_type": "gpt2", "vocab_size": vocab, "n_positions": n_pos, "n_embd": E,
              "n_layer": n_layer, "n_head": 2, "layer_norm_epsilon": 1e-5,
              "tie_word_embeddings": True}
    return sd, config


def _llama_state(vocab, rng, H=32, I=64, n_layer=2, heads=4, kv=2):
    def normal(*shape, s=0.2):
        return torch.from_numpy(s * rng.standard_normal(shape, dtype=np.float32))

    hd = H // heads
    sd = {"model.embed_tokens.weight": normal(vocab, H, s=0.5), "model.norm.weight": 1 + normal(H),
          "lm_head.weight": normal(vocab, H, s=0.5)}
    for i in range(n_layer):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": 1 + normal(H),
                   p + "post_attention_layernorm.weight": 1 + normal(H),
                   p + "self_attn.q_proj.weight": normal(heads * hd, H),
                   p + "self_attn.k_proj.weight": normal(kv * hd, H),
                   p + "self_attn.v_proj.weight": normal(kv * hd, H),
                   p + "self_attn.o_proj.weight": normal(H, heads * hd),
                   p + "mlp.gate_proj.weight": normal(I, H), p + "mlp.up_proj.weight": normal(I, H),
                   p + "mlp.down_proj.weight": normal(H, I)})
    config = {"model_type": "llama", "vocab_size": vocab, "hidden_size": H,
              "intermediate_size": I, "num_hidden_layers": n_layer,
              "num_attention_heads": heads, "num_key_value_heads": kv,
              "max_position_embeddings": 256, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
              "tie_word_embeddings": False, "hidden_act": "silu"}
    return sd, config


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """{(family, tokenizer name): an HF directory with seeded weights}."""
    out = {}
    for k, (family, name) in enumerate((f, n) for f in ("gpt2", "llama") for n in TOKENIZERS):
        text = _tokenizer_json(name)
        vocab = len(Tokenizer.from_str(text))
        make = _gpt2_state if family == "gpt2" else _llama_state
        sd, config = make(vocab, np.random.default_rng(k))
        path = tmp_path_factory.mktemp(f"{family}_{name}")
        save_hf_model(str(path), sd, config)
        (path / "tokenizer.json").write_text(text)
        np.save(path / "bias.npy", np.random.default_rng(100 + k).standard_normal(vocab)
                .astype(np.float32))
        out[family, name] = str(path)
    return out


def _jax_apply(path):
    with open(os.path.join(path, "config.json")) as f:
        config_json = json.load(f)

    class _Cfg:
        def __init__(self, d):
            self.__dict__.update(d)

    module, config = jax_build_model(config_json["model_type"], hf_config=_Cfg(config_json))
    params = load_backbone_params(path, config_json["model_type"], config)
    return (lambda p, ids: module.apply({"params": p}, ids)), params


def _texts():
    return [t for t in fixtures.CORPUS if t.strip()]


def _close(got, want, rtol=RTOL):
    assert abs(got - want) <= rtol * abs(want), (got, want)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("name", TOKENIZERS)
def test_evaluate_lm_matches_jax(model_dirs, family, name):
    """chunked_tokenize bit for bit (ids and char lengths), then evaluate_lm
    with the tokenizer's special ids and an external bias."""
    path = model_dirs[family, name]
    jtok, tok = (T.from_file(os.path.join(path, "tokenizer.json"))
                 for T in (JaxTokenizer, Tokenizer))
    want_data = jax_chunked(jtok, _texts(), 32)
    data = chunked_tokenize(tok, _texts(), 32)
    for key in ("input_ids", "char_lengths"):
        assert data[key].dtype == want_data[key].dtype
        np.testing.assert_array_equal(data[key], want_data[key])
    # a special id at position 5 of every third block, so the mask bites
    special = tok.all_special_ids
    if special:
        data["input_ids"][::3, 5] = special[0]
        want_data["input_ids"][::3, 5] = special[0]
    bias = np.load(os.path.join(path, "bias.npy"))
    apply, params = _jax_apply(path)
    want = jax_evaluate_lm(apply, params, want_data, special_ids=special, external_bias=bias,
                           batch_size=4)
    fn = load_causal_lm(path, "cpu")
    got = evaluate_lm(fn, data, special_ids=special, external_bias=bias, batch_size=4)
    assert got["n_tokens"] == want["n_tokens"]
    for key in ("loss", "perplexity", "bits_per_char", "chars_per_token"):
        _close(got[key], want[key])


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("name", ["xlmr_like", "gpt2_like"])
def test_score_loglikelihoods_and_choice_task_match_jax(model_dirs, family, name):
    """Each request's ll within 1e-4, its n_tokens, n_bytes and greedy
    equal; the choice task's acc and acc_norm equal. Requests reach 40
    tokens (two width buckets) and the last batch is partial."""
    path = model_dirs[family, name]
    jtok, tok = (T.from_file(os.path.join(path, "tokenizer.json"))
                 for T in (JaxTokenizer, Tokenizer))
    texts = _texts()
    items = [{"query": texts[i], "choices": [" " + texts[i + 1][:20], texts[i + 2][:9], "."],
              "gold": i % 3} for i in range(0, 33, 3)]
    requests = [(it["query"], c) for it in items for c in it["choices"]]
    apply, params = _jax_apply(path)
    fn = load_causal_lm(path, "cpu")
    want = jax_score(apply, params, jtok, requests, batch_size=4, max_length=40)
    got = choice.score_loglikelihoods(fn, tok, requests, batch_size=4, max_length=40)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g["ll"] - w["ll"]) <= 1e-4, (g, w)
        assert (g["n_tokens"], g["n_bytes"], g["greedy"]) == \
            (w["n_tokens"], w["n_bytes"], w["greedy"])
    assert choice.evaluate_choice_task(fn, tok, items, batch_size=4, max_length=40) == \
        jax_choice_task(apply, params, jtok, items, batch_size=4, max_length=40)


def _stdout_json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("name", ["llama_like", "gpt2_like"])
def test_perplexity_cli_matches_jax(model_dirs, family, name, tmp_path):
    path = model_dirs[family, name]
    data = tmp_path / "text.txt"
    data.write_text("\n".join(_texts()) + "\n")
    argv = ["--model", path, "--data", str(data), "--block-size", "48", "--batch-size", "3",
            "--bias", os.path.join(path, "bias.npy"), "--max-texts", "150"]
    want = _stdout_json(jax_ppl_main, argv)
    got = _stdout_json(ppl_main, argv + ["--device", "cpu"])
    assert sorted(got) == sorted(want)
    assert got["n_tokens"] == want["n_tokens"]
    for key in ("loss", "perplexity", "bits_per_char", "chars_per_token"):
        _close(got[key], want[key])


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("task", ["en", "code"])
def test_choice_cli_matches_jax(model_dirs, family, task):
    """The choice CLI on the repo's COPA-style tasks (the first 12 items)."""
    path = model_dirs[family, "xlmr_like"]
    argv = ["--model", path, "--data", COPA.format(task), "--max-items", "12",
            "--batch-size", "5", "--max-length", "64"]
    assert _stdout_json(choice.main, argv + ["--device", "cpu"]) == \
        _stdout_json(jax_choice_main, argv)


@pytest.mark.parametrize("main", [ppl_main, choice.main], ids=["perplexity", "choice"])
def test_clis_need_the_card_without_device_flag(model_dirs, main, tmp_path, monkeypatch):
    """Without --device cpu the CLIs run on the card; with none they raise
    before loading anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA.*--device cpu"):
        main(["--model", str(tmp_path / "missing"), "--data", str(tmp_path / "missing")])


# ------------------------------------------------ the Collator and the priors

@pytest.fixture(scope="module")
def references():
    from zett_tpu.tokenization.convert import convert_to_byte_level as jax_convert

    data, _ = jax_convert(JaxTokenizer.from_json(
        fixtures._cached("gpt2_like", fixtures._build_gpt2_like)))
    data = data.to_json()
    return JaxTokenizer.from_json(data), Tokenizer.from_json(data)


@pytest.mark.parametrize("subsample", [None, 128])
def test_collator_general_branch_matches_jax(references, subsample):
    """A fixed WordPiece tokenizer (bert_like) stays WordPiece through the
    byte-level conversion, so the Collator encodes with encode_batch
    (truncated and padded to the block): batches equal JAX's."""
    from zett_tpu.data import Collator as JaxCollator
    from zett_tpu.data import DataConfig as JaxDataConfig
    from zett_tpu_torch.data import Collator, DataConfig
    from zett_tpu_torch.tokenization.fast_encode import fast_encoder_or_none

    jref, tref = references
    cfg = dict(block_size=24, hn_surface_maxlen=7, n_token_subsample=subsample,
               pad_to_multiple_of=64, langs=["en"], do_tokenizer_sampling=False)
    text = _tokenizer_json("bert_like")
    a = JaxCollator(reference=jref, hn_tokenizer=jref.copy(), data_config=JaxDataConfig(**cfg),
                    batch_size=4, fixed_tokenizer=JaxTokenizer.from_str(text), seed=0)
    b = Collator(reference=tref, hn_tokenizer=tref.copy(), data_config=DataConfig(**cfg),
                 batch_size=4, fixed_tokenizer=Tokenizer.from_str(text), seed=0)
    assert fast_encoder_or_none(b.tokenizer) is None
    texts = _texts()
    for i in range(3):
        item = {"texts": texts[4 * i: 4 * i + 4], "lang_code": "en"}
        want, got = a(item), b(item)
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(np.asarray(got[key]), value, err_msg=key)
            else:
                assert got[key] == value, key


@pytest.mark.parametrize("name", ["xlmr_like", "llama_like", "bert_like", "nfkc_en_raw"])
def test_general_pretoken_counts_and_substring_prior_match_jax(name):
    """Tokenizers outside the canonical byte-level structure count their own
    normalized pretokens (string keys), as JAX does; the substring prior
    then equals JAX's."""
    if name == "nfkc_en_raw":
        with open(os.path.join(REPO, "artifacts", "tokenizers", "en_raw", "tokenizer.json")) as f:
            data = json.load(f)
        data["normalizer"] = {"type": "NFKC"}
        text = json.dumps(data)
    else:
        text = _tokenizer_json(name)
    jtok, tok = JaxTokenizer.from_str(text), Tokenizer.from_str(text)
    texts = _texts()
    want = jax_priors.get_pretoken_counts(jtok, texts)
    got = priors.get_pretoken_counts(tok, texts)
    assert got == want and all(isinstance(k, str) for k in got)
    np.testing.assert_array_equal(priors.compute_substring_prior(tok, texts=texts),
                                  jax_priors.compute_substring_prior(jtok, texts=texts))


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_prior_cli_on_a_non_canonical_tokenizer_matches_jax(device, tmp_path):
    """compute_prior on en_raw with an NFKC normalizer (byte-level vocab,
    not the canonical structure): the general pretoken counts, and
    chunked_tokenize's general branch on the host path, give JAX's
    priors.npy."""
    from zett_tpu.tokenization import compute_prior as jax_cli
    from zett_tpu_torch.tokenization import compute_prior as cli

    with open(os.path.join(REPO, "artifacts", "tokenizers", "en_raw", "tokenizer.json")) as f:
        data = json.load(f)
    data["normalizer"] = {"type": "NFKC"}
    (tmp_path / "tok").mkdir()
    (tmp_path / "tok" / "tokenizer.json").write_text(json.dumps(data))
    (tmp_path / "text.txt").write_text("\n".join(_texts()) + "\n")
    base = ["--tokenizer", str(tmp_path / "tok"), "--data", str(tmp_path / "text.txt")]
    jax_cli.main(base + ["--output", str(tmp_path / "jax.npy")] + (["--device"] if device else []))
    cli.main(base + ["--output", str(tmp_path / "port.npy")]
             + (["--device", "cpu"] if device else ["--host-encode"]))
    got, want = (np.load(tmp_path / f"{n}.npy", allow_pickle=True).item() for n in ("port", "jax"))
    for key in ("substring", "token"):
        np.testing.assert_array_equal(got[key], want[key])
