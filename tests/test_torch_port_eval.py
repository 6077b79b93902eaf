"""The port's eval path held against the JAX package on the CPU: ValidDataset
and the validation / fixed-tokenizer Collator batches (bit-identical), the
CLM loss with bits-per-byte, the Trainer's compute_embeddings, eval_step,
eval_step_cached and eval_loop from the same parameters and batches (the
plain and the prior + inter-token-attention hypernet), the training CLI's
eval rows in metrics.jsonl, and a transfer at the prior +
inter-token-attention configuration through both transfer CLIs."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from test_torch_port_data import _assert_batches_equal
from test_torch_port_training import HN, V_BATCH, VOCAB, _batch, _close, model_dir  # noqa: F401
from test_torch_port_transfer import TOK, _config, _flax_params, _write_gpt2_dir
from zett_tpu.data import Collator as JaxCollator
from zett_tpu.data import DataConfig as JaxDataConfig
from zett_tpu.data import ValidDataset as JaxValidDataset
from zett_tpu.evaluation import eval_loop as jax_eval_loop
from zett_tpu.models import HypernetConfig as JaxHnConfig
from zett_tpu.models.backbones.gpt2 import GPT2Config as JaxGPT2Config
from zett_tpu.models.backbones.gpt2 import GPT2LMHeadModel as JaxGPT2
from zett_tpu.models.backbones.loader import invert_gpt2
from zett_tpu.tokenization import Tokenizer as JaxTokenizer
from zett_tpu.training import Trainer as JaxTrainer
from zett_tpu.training import TrainingConfig as JaxTrainingConfig
from zett_tpu.training.losses import lm_loss as jax_lm_loss
from zett_tpu_torch.data import Collator, DataConfig, ValidDataset
from zett_tpu_torch.evaluation import eval_loop
from zett_tpu_torch.models import HypernetConfig
from zett_tpu_torch.models.backbones.gpt2 import GPT2Config
from zett_tpu_torch.tokenization.core import Tokenizer
from zett_tpu_torch.training import Trainer, TrainingConfig
from zett_tpu_torch.training.losses import lm_loss

PITA_HN = dict(HN, embed_target_priors=True, add_inter_token_attention=True,
               inter_token_attention_bias_by_priors=True, n_inter_token_blocks=4)
CFG = dict(block_size=32, hn_surface_maxlen=7, n_token_subsample=None, pad_to_multiple_of=64,
           tokenizer_sample_mean=2000, tokenizer_sample_std=0, tokenizer_sample_min=512,
           tokenizer_sample_max=2048, tokenizer_noise_mean=1e-5, tokenizer_noise_std=2.0,
           langs=["en"])


@pytest.fixture(scope="module")
def texts(corpus):
    return [t for t in corpus if t.strip()]


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("n_subsample", [None, 7, 40])
def test_valid_dataset_matches_jax(texts, tmp_path, n_subsample):
    """Every index gives the same batch, from in-memory texts and from
    <lang>.txt files; a language shorter than one batch keeps one padded
    partial batch."""
    by_lang = {"en": texts[:50], "de": texts[50:53]}
    for lang, lines in by_lang.items():
        (tmp_path / f"{lang}.txt").write_text("\n".join(lines) + "\n")
    kw = dict(langs=["all", "en", "de"], batch_size=8, n_subsample=n_subsample)
    for source in (dict(texts_by_lang=by_lang), dict(valid_directory=str(tmp_path))):
        a, b = JaxValidDataset(**source, **kw), ValidDataset(**source, **kw)
        assert len(a) == len(b) > 0
        for i in range(len(a)):
            assert a[i] == b[i]


@pytest.fixture(scope="module")
def gpt2_raw():
    return (JaxTokenizer.from_file(TOK.format("gpt2_raw")),
            Tokenizer.from_file(TOK.format("gpt2_raw")))


def test_validation_collator_batches_equal(gpt2_raw, texts):
    """The sampled-tokenizer validation collator (is_validation: the sampler
    pool is not fed) at seed + 1 over three batches."""
    jref, tref = gpt2_raw
    kw = dict(batch_size=8, initial_texts={"en": texts[:64]}, is_validation=True, seed=4)
    a = JaxCollator(reference=jref, hn_tokenizer=jref.copy(), data_config=JaxDataConfig(**CFG),
                    **kw)
    b = Collator(reference=tref, hn_tokenizer=tref.copy(), data_config=DataConfig(**CFG), **kw)
    for i in range(3):
        item = {"texts": texts[8 * i: 8 * i + 8], "lang_code": "en"}
        _assert_batches_equal(a(item), b(item))


@pytest.mark.parametrize("name", ["de_raw", "en_raw"])
def test_extra_valid_collator_batches_equal(gpt2_raw, texts, name):
    """An extra-valid collator: a fixed Unigram tokenizer from the repo's
    artifacts, no vocab subsampling, no span sampling."""
    jref, tref = gpt2_raw
    cfg = dict(CFG, do_tokenizer_sampling=False, sample_text_span=False)
    kw = dict(batch_size=4, is_validation=True, seed=0)
    a = JaxCollator(reference=jref, hn_tokenizer=jref.copy(), data_config=JaxDataConfig(**cfg),
                    fixed_tokenizer=JaxTokenizer.from_file(TOK.format(name)), **kw)
    b = Collator(reference=tref, hn_tokenizer=tref.copy(), data_config=DataConfig(**cfg),
                 fixed_tokenizer=Tokenizer.from_file(TOK.format(name)), **kw)
    for i in range(2):
        item = {"texts": texts[4 * i: 4 * i + 3] + [""], "lang_code": "en"}
        _assert_batches_equal(a(item), b(item))


# ------------------------------------------------------------------ losses
def test_lm_loss_with_bpb_matches_jax():
    """Loss and bits-per-byte term within 1e-6 relative; a row without bytes
    (an empty padding text) counts in neither."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 9, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, size=(4, 9)).astype(np.int32)
    mask = (rng.random((4, 9)) > 0.2).astype(np.int32)
    blen = rng.integers(1, 6, size=(4, 9)).astype(np.int64)
    mask[3], blen[3] = 0, 0
    want = jax_lm_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), "clm",
                       byte_lengths=jnp.asarray(blen), with_bpb=True)
    got = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                  torch.from_numpy(mask), "clm", byte_lengths=torch.from_numpy(blen),
                  with_bpb=True)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


# ----------------------------------------------------------------- trainer
def _trainers(hn):
    """A JAX Trainer and a port Trainer from the same parameters (f32)."""
    bb_cfg = JaxGPT2Config(vocab_size=VOCAB, n_positions=32, n_embd=64, n_layer=2, n_head=2)
    bb_params = JaxGPT2(bb_cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    kw = dict(steps=6, learning_rate=1e-3, warmup_steps=1, lexical_loss_weight=0.5,
              logging_steps=10, save_steps=0, eval_steps=0, dtype="float32")
    jtr = JaxTrainer(hn_config=JaxHnConfig(**hn), backbone_config=bb_cfg,
                     backbone_params=bb_params, model_type="gpt2",
                     train_config=JaxTrainingConfig(**kw), vocab_batch_size=V_BATCH)
    hn_params = {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in
                 traverse_util.flatten_dict(jtr.state.params["hypernet"], sep="/").items()}
    sd = invert_gpt2(jax.tree_util.tree_map(np.asarray, bb_params), bb_cfg)
    ttr = Trainer(hn_config=HypernetConfig(**hn),
                  backbone_config=GPT2Config(vocab_size=VOCAB, n_positions=32, n_embd=64,
                                             n_layer=2, n_head=2),
                  backbone_state={k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                  model_type="gpt2", train_config=TrainingConfig(**kw), device="cpu",
                  hn_params=hn_params)
    return jtr, ttr


def _eval_batch(seed):
    b = _batch(seed)
    rng = np.random.default_rng(seed + 100)
    b["byte_lengths"] = rng.integers(1, 8, size=b["input_ids"].shape).astype(np.int64)
    b["target_priors"] = (rng.normal(size=V_BATCH) * 2 - 9).astype(np.float32)
    b["target_priors"][~b["mask"]] = -100000.0
    b["lang_code"] = "en"
    b["metrics"] = {"avg_byte_length": 3.5, "unk_ratio": 0.0}
    return b


@pytest.mark.parametrize("hn", ["plain", "pita"])
def test_eval_steps_match_jax(hn):
    """compute_embeddings (inference route, special rows spliced),
    eval_step and eval_step_cached from the same parameters and batch: the
    embeddings and bias within 1e-5 of their scale, the metrics within 1e-5
    relative (f32)."""
    jtr, ttr = _trainers(PITA_HN if hn == "pita" else HN)
    batch = _eval_batch(3)
    jb, tb = jtr._device_batch(batch), ttr._device_batch(batch)
    j_emb = jtr.compute_embeddings(jtr.state, jb)
    t_emb = ttr.compute_embeddings(tb)
    assert j_emb[1] is None and t_emb[1] is None
    _close(t_emb[0], j_emb[0], 1e-5, "emb_in")
    _close(t_emb[2], j_emb[2], 1e-5, "bias")
    for got, want in ((ttr.eval_step(tb), jtr.eval_step(jtr.state, jb)),
                      (ttr.eval_step_cached(tb, *t_emb),
                       jtr.eval_step_cached(jtr.state, jb, *j_emb))):
        assert sorted(got) == sorted(want) == ["eval_bpb", "eval_loss"]
        for k in want:
            _close(got[k], want[k], 1e-5, k)


def test_eval_loop_matches_jax():
    """eval_loop over two batches, fixed tokenizer (the embeddings of the
    first batch reused) and not: the same keys, values within 1e-5
    relative."""
    jtr, ttr = _trainers(PITA_HN)
    batches = [_eval_batch(5), _eval_batch(6)]
    batches[1]["target_surface_forms"] = batches[0]["target_surface_forms"]
    batches[1]["target_priors"] = batches[0]["target_priors"]
    for fixed in (True, False):
        want = jax_eval_loop(jtr, iter(batches), name="eval_x", fixed_tokenizer=fixed)
        got = eval_loop(ttr, iter(batches), name="eval_x", fixed_tokenizer=fixed)
        assert sorted(got) == sorted(want)
        assert "eval_x/eval_bpb" in got and "eval_x/en_eval_loss" in got
        for k in want:
            _close(got[k], want[k], 1e-5, k)


# --------------------------------------------------------------------- CLI
def _cli_config(model_dir, out_dir, texts, hn_extra):
    return {
        "model_dir": model_dir, "output_dir": out_dir,
        "texts_by_lang": {"en": texts[:64]},
        "valid_texts_by_lang": {"en": texts[64:88]},
        "extra_valid_tokenizers": [os.path.dirname(TOK.format("de_raw"))],
        "n_valid_subsample": 16, "eval_steps": 2, "eval_at_step_zero": True,
        "langs": ["en"], "steps": 2, "warmup_steps": 1, "identity_steps": 0,
        "logging_steps": 1, "save_steps": 0, "batch_size": 8, "block_size": 16,
        "n_token_subsample": None, "pad_to_multiple_of": 64, "tokenizer_sample_mean": 256,
        "tokenizer_sample_std": 0, "tokenizer_sample_min": 256, "tokenizer_sample_max": 512,
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 1, "max_position_embeddings": 8, "hn_surface_maxlen": 4,
        "embed_using_source_embeddings": True, "n_extra_tokens": 8,
        "rescale_embeddings": True, "lexical_loss_weight": 0.5,
        "hidden_dropout_prob": 0.0, "attention_dropout_prob": 0.0, "n_initial_texts": 16,
        **hn_extra,
    }


def test_training_cli_eval_rows_match_jax(model_dir, texts, tmp_path):  # noqa: F811
    """Both training CLIs on the same config with eval at step 0 and at
    step 2 (an extra-valid tokenizer and sampled validation tokenizers): the
    port writes the JAX CLI's eval rows, key for key, with finite values;
    the port's step-0 eval (before any update) runs its cached-embedding
    path once per fixed tokenizer per eval."""
    from zett_tpu.training.__main__ import main as jax_main
    from zett_tpu_torch.training import engine
    from zett_tpu_torch.training.__main__ import main as port_main

    extra = dict(embed_target_priors=True, add_inter_token_attention=True,
                 inter_token_attention_bias_by_priors=True, n_inter_token_blocks=4)
    rows = {}
    calls = []
    orig = engine.Trainer.compute_embeddings

    def counting(self, b):
        calls.append(1)
        return orig(self, b)

    for name, main, args in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        out = tmp_path / name
        cfg_path = tmp_path / f"{name}.json"
        cfg_path.write_text(json.dumps(_cli_config(model_dir, str(out), texts, extra)))
        if name == "port":
            engine.Trainer.compute_embeddings = counting
        try:
            main([str(cfg_path)] + args)
        finally:
            engine.Trainer.compute_embeddings = orig
        lines = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
        rows[name] = [r for r in lines if any(k.startswith("eval") for k in r)]
    assert len(rows["jax"]) == len(rows["port"]) == 2
    for j, t in zip(rows["jax"], rows["port"]):
        assert sorted(j) == sorted(t)
        assert "eval_de_raw/eval_loss" in t and "eval/eval_bpb" in t
        assert all(np.isfinite(v) for k, v in t.items() if k != "run")
    # two evals x (one cached forward for de_raw) + one forward per sampled batch
    n_valid = 2  # 24 texts, n_valid_subsample 16, batch 8
    assert len(calls) == 2 * (1 + n_valid)


def test_pita_transfer_cli_matches_jax(tmp_path):
    """Both transfer CLIs at the prior + inter-token-attention features on
    one checkpoint and HF model dir, with de_raw (Unigram: real priors reach
    the prior token and the inter-token bias): the spliced table and
    bias.npy within 2e-5 (f32; the inter-token exchange mixes every row of
    a batch, so both keep the JAX package's length bucketing), the other
    files identical."""
    import orbax.checkpoint as ocp
    from safetensors.numpy import load_file

    from zett_tpu.transfer.__main__ import main as jax_main
    from zett_tpu_torch.transfer.__main__ import main as port_main

    vocab = len(Tokenizer.from_file(TOK.format("gpt2_raw")))
    model_dir = str(tmp_path / "gpt2")
    sd = _write_gpt2_dir(model_dir, vocab)
    cfg = dict(_config(vocab), embed_target_priors=True, add_inter_token_attention=True,
               inter_token_attention_bias_by_priors=True, n_inter_token_blocks=4,
               inter_token_residual_ln=True)
    _, flat = _flax_params(cfg, sd["transformer.wte.weight"].numpy())
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    with open(ckpt / "hn_config.json", "w") as f:
        json.dump(JaxHnConfig(**cfg).to_dict(), f)
    np.savez(ckpt / "params.npz", **flat)
    Tokenizer.from_file(TOK.format("gpt2_raw")).save(str(ckpt / "tokenizer.json"))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(ckpt / "state"), traverse_util.unflatten_dict(flat, sep="/"))
    ckptr.wait_until_finished()

    common = ["--checkpoint", str(ckpt), "--model", model_dir,
              "--target-tokenizer", TOK.format("de_raw"), "--batch-size", "2048"]
    jax_out, port_out = str(tmp_path / "jax_out"), str(tmp_path / "port_out")
    jax_main(common + ["--output", jax_out])
    port_main(common + ["--output", port_out, "--device", "cpu"])
    ref = load_file(os.path.join(jax_out, "model.safetensors"))
    got = load_file(os.path.join(port_out, "model.safetensors"))
    assert set(got) == set(ref)
    for k in ref:
        if k in ("transformer.wte.weight", "lm_head.weight"):
            assert np.abs(got[k] - ref[k]).max() <= 2e-5, (k, np.abs(got[k] - ref[k]).max())
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    bias_ref = np.load(os.path.join(jax_out, "bias.npy"))
    bias_got = np.load(os.path.join(port_out, "bias.npy"))
    assert np.abs(bias_got - bias_ref).max() <= 2e-5
    for name in ("tokenizer.json", "config.json"):
        with open(os.path.join(jax_out, name)) as a, open(os.path.join(port_out, name)) as b:
            assert a.read() == b.read(), name
