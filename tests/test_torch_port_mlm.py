"""The port's masked-LM path (zett_tpu_torch/data/mlm.py, the Collator's
masker hook, the MLM losses, the trainer under loss "mlm", the training and
transfer CLIs on an xlm-roberta directory, evaluation/mlm_probe.py) held
against the JAX package on the CPU, on numpy-seeded inputs: the masker bit
for bit (xlmr_like with <mask> appended as its last id, as XLM-R places
it, and roberta0001), the Collator with the masker, the losses and their
gradients, one MLM train step's loss and hypernet gradients (learnable
bias, 26 language ids) chunked and unchunked, the eval metrics, the CLIs
and the probe. Also ROADMAP C.18 (the port seeds its masker per batch, so
a replay resume is bit-equal) and C.19 (JAX's MLM eval masks nothing, and
the port follows it)."""

import copy
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as fnn
from flax import traverse_util

from zett_tpu.data import Collator as JaxCollator
from zett_tpu.data import DataConfig as JaxDataConfig
from zett_tpu.data.mlm import MLMCollator as JaxMLMCollator
from zett_tpu.models import HypernetConfig as JaxHnConfig
from zett_tpu.tokenization import Tokenizer as JaxTokenizer
from zett_tpu.tokenization.convert import convert_to_byte_level as jax_convert
from zett_tpu.training import Trainer as JaxTrainer
from zett_tpu.training import TrainingConfig as JaxTrainingConfig
from zett_tpu.training.losses import chunked_mlm_eval as jax_chunked_mlm_eval
from zett_tpu.training.losses import chunked_mlm_loss as jax_chunked_mlm_loss
from zett_tpu.training.losses import lm_loss as jax_lm_loss
from zett_tpu.training.state import TrainState as JaxTrainState
from zett_tpu_torch.data import Collator, DataConfig
from zett_tpu_torch.data.datasets import language_probs_from_sizes, language_sizes_from_metadata
from zett_tpu_torch.data.mlm import MLMCollator
from zett_tpu_torch.models import HypernetConfig
from zett_tpu_torch.models.backbones.registry import config_from_hf
from zett_tpu_torch.models.convert import flax_paths
from zett_tpu_torch.tokenization.convert import convert_to_byte_level
from zett_tpu_torch.tokenization.core import Tokenizer
from zett_tpu_torch.training import Trainer, TrainingConfig
from zett_tpu_torch.training.losses import chunked_mlm_eval, chunked_mlm_loss, lm_loss

from test_torch_port_roberta import (HF_CONFIG, jax_roberta, padded_batch,
                                     roberta_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROBERTA0001 = os.path.join(REPO, "artifacts", "tokenizers", "roberta0001", "tokenizer.json")
DE_RAW = os.path.join(REPO, "artifacts", "tokenizers", "de_raw", "tokenizer.json")
CSV = os.path.join(REPO, "artifacts", "madlad400_metadata.csv")
MASK_SEED = 7


def xlmr_mask_json(base):
    """A copy of a tokenizer JSON with <mask> appended as its last id, a
    special added token (XLM-R's layout: <mask> is id 250001)."""
    data = copy.deepcopy(base)
    n = len(data["model"]["vocab"])
    data["model"]["vocab"].append(["<mask>", 0.0])
    data["added_tokens"].append({"id": n, "content": "<mask>", "single_word": False,
                                 "lstrip": False, "rstrip": False, "normalized": False,
                                 "special": True})
    return data


@pytest.fixture(scope="module")
def mask_tokenizers(xlmr_like_json):
    """(JAX, port) byte-level conversions of xlmr_like with <mask>."""
    data = xlmr_mask_json(xlmr_like_json)
    jtok, _ = jax_convert(JaxTokenizer.from_json(data))
    ttok, _ = convert_to_byte_level(Tokenizer.from_json(data))
    assert ttok.to_json() == jtok.to_json() and ttok.token_to_id("<mask>") is not None
    return jtok, ttok


@pytest.fixture(scope="module")
def texts(corpus):
    return [t for t in corpus if t.strip()]


def _encode(tok, texts, length=24):
    tok.enable_truncation(length)
    tok.enable_padding(length=length, pad_id=1, pad_token="<pad>")
    ids = np.array([e.ids for e in tok.encode_batch(texts)], dtype=np.int32)
    tok.no_truncation()
    tok.no_padding()
    return ids


# ------------------------------------------------------------------ masker
@pytest.mark.parametrize("which", ["xlmr_like_mask", "roberta0001"])
def test_masker_bit_equal(which, mask_tokenizers, texts):
    """The same seed gives the same ids and labels as JAX's masker; special
    positions are never picked, about 15% of the others are."""
    if which == "roberta0001":
        jtok, ttok = JaxTokenizer.from_file(ROBERTA0001), Tokenizer.from_file(ROBERTA0001)
    else:
        jtok, ttok = mask_tokenizers
    ids = _encode(ttok, texts[:40])
    np.testing.assert_array_equal(ids, _encode(jtok, texts[:40]))
    want = JaxMLMCollator(seed=MASK_SEED)(jtok, ids)
    got = MLMCollator(seed=MASK_SEED)(ttok, ids)
    for key in ("input_ids", "labels"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    special = np.isin(ids, ttok.all_special_ids)
    picked = got["labels"] != -100
    assert not (picked & special).any()
    assert 0.1 < picked.sum() / (~special).sum() < 0.2
    assert (got["input_ids"][picked] == ttok.token_to_id("<mask>")).mean() > 0.6


def test_masker_without_mask_token_raises(xlmr_like_json, texts):
    tok = Tokenizer.from_json(xlmr_like_json)
    ids = _encode(tok, texts[:4])
    for masker, t in ((MLMCollator(seed=0), tok),
                      (JaxMLMCollator(seed=0), JaxTokenizer.from_json(xlmr_like_json))):
        with pytest.raises(ValueError, match="mask token"):
            masker(t, ids)


class _PerBatchJaxMasker(JaxMLMCollator):
    """JAX's masker restarted before each batch from the key the port's
    Collator uses outside a DataLoader worker: (seed, batch, 1, 0)."""

    def __init__(self, seed):
        super().__init__()
        self.seed, self.batch = seed, 0

    def __call__(self, tokenizer, input_ids):
        self.rng = np.random.default_rng([self.seed, self.batch, 1, 0])
        self.batch += 1
        return super().__call__(tokenizer, input_ids)


@pytest.mark.parametrize("subsample", [None, 512])
def test_collator_with_masker_matches_jax(mask_tokenizers, texts, subsample):
    """Sampled-tokenizer batches through the masker hook equal JAX's
    Collator(inner_collator=...) with its masker seeded per batch as the
    port seeds it (ROADMAP C.18): three batches, vocab subsampled (the
    positives from the masked ids, the labels remapped with -100 kept) and
    not (xlmr_26l's setting)."""
    jref, tref = mask_tokenizers
    cfg = dict(block_size=32, hn_surface_maxlen=7, n_token_subsample=subsample,
               pad_to_multiple_of=64, tokenizer_sample_mean=1000, tokenizer_sample_std=0,
               tokenizer_sample_min=512, tokenizer_sample_max=1024, tokenizer_noise_mean=1e-5,
               tokenizer_noise_std=2.0, langs=["en"])
    kw = dict(batch_size=8, initial_texts={"en": texts[:32]}, seed=5)
    a = JaxCollator(reference=jref, hn_tokenizer=jref.copy(), data_config=JaxDataConfig(**cfg),
                    inner_collator=_PerBatchJaxMasker(5), **kw)
    b = Collator(reference=tref, hn_tokenizer=tref.copy(), data_config=DataConfig(**cfg),
                 inner_collator=MLMCollator(), **kw)
    for i in range(3):
        item = {"texts": texts[8 * i + 3: 8 * i + 11], "lang_code": "en"}
        want, got = a(item), b(item)
        assert sorted(got) == sorted(want)
        for key, va in want.items():
            if isinstance(va, np.ndarray):
                assert va.dtype == np.asarray(got[key]).dtype, key
                np.testing.assert_array_equal(got[key], va, err_msg=key)
            else:
                assert got[key] == va, key
        assert (got["labels"] == -100).mean() > 0.5 and (got["labels"] >= 0).any()


# ------------------------------------------------------------------ losses
def _loss_inputs(seed=0, B=3, L=11, H=16, V=40):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, L, H)).astype(np.float32)
    head_w = rng.normal(size=(V, H)).astype(np.float32) * 0.5
    offset = np.where(rng.random(V) > 0.1, 0.0, -1e5).astype(np.float32)
    offset[:30] += rng.normal(size=30).astype(np.float32) * 0.1
    labels = rng.integers(0, 30, size=(B, L)).astype(np.int32)
    labels[rng.random((B, L)) > 0.4] = -100
    mask = np.ones((B, L), np.int32)
    mask[1, 7:] = 0
    # a handful of positions the head gets right, so accuracy is not 0
    labels[0, 1] = int(np.argmax(hidden[0, 1] @ head_w.T + offset))
    return hidden, head_w, offset, labels, mask


def _head_params(H=16, seed=1):
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": (rng.normal(size=(H, H)) / np.sqrt(H)).astype(np.float32),
                      "bias": (0.1 * rng.normal(size=H)).astype(np.float32)},
            "ln": {"scale": (1 + 0.1 * rng.normal(size=H)).astype(np.float32),
                   "bias": (0.1 * rng.normal(size=H)).astype(np.float32)}}


def _jax_head_fn(p, H=16):
    dense, ln = fnn.Dense(H), fnn.LayerNorm(epsilon=1e-5)

    def head_fn(h):
        h = fnn.gelu(dense.apply({"params": p["dense"]}, h), approximate=False)
        return ln.apply({"params": p["ln"]}, h)

    return head_fn


def _torch_head_fn(p):
    from zett_tpu_torch.models.hypernet import gelu_exact
    from zett_tpu_torch.ops.encoder_layer import layer_norm_flax_exact

    w = {k: {n: torch.from_numpy(v).requires_grad_(True) for n, v in d.items()}
         for k, d in p.items()}

    def head_fn(h):
        x = gelu_exact(h @ w["dense"]["kernel"] + w["dense"]["bias"])
        return layer_norm_flax_exact(x, w["ln"]["scale"], w["ln"]["bias"], 1e-5, torch.float32)

    return head_fn, w


def test_lm_loss_mlm_matches_jax():
    _, _, _, labels, mask = _loss_inputs()
    logits = np.random.default_rng(2).normal(size=labels.shape + (40,)).astype(np.float32) * 3
    want = jax_lm_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), "mlm")
    got = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                  torch.from_numpy(mask), "mlm")
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize("with_head", [False, True])
def test_chunked_mlm_loss_and_eval_match_jax(with_head):
    """chunked_mlm_loss (chunk 4 over L 11: a padded last chunk) with and
    without the head transform: the loss within 1e-5 relative, the
    gradients of the hidden states, the head table and the head's weights
    within 1e-4 of their largest; chunked_mlm_eval's loss within 1e-5
    relative and its accuracy equal (and nonzero)."""
    hidden, head_w, offset, labels, mask = _loss_inputs()
    p = _head_params()
    jhead = _jax_head_fn(p) if with_head else None

    def jax_loss(h, w, params):
        fn = _jax_head_fn(params) if with_head else None
        return jax_chunked_mlm_loss(h, w, jnp.asarray(offset), jnp.asarray(labels),
                                    jnp.asarray(mask), 4, head_fn=fn)

    want, jgrads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2)))(
        jnp.asarray(hidden), jnp.asarray(head_w), jax.tree_util.tree_map(jnp.asarray, p))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(head_w).requires_grad_(True)
    thead, tp = _torch_head_fn(p) if with_head else (None, None)
    got = chunked_mlm_loss(th, tw, torch.from_numpy(offset), torch.from_numpy(labels).long(),
                           torch.from_numpy(mask), 4, head_fn=thead)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    pairs = [(th.grad, jgrads[0]), (tw.grad, jgrads[1])]
    if with_head:
        pairs += [(tp[k][n].grad, jgrads[2][k][n]) for k in p for n in p[k]]
    for g, w in pairs:
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()

    want_l, want_a = jax.jit(lambda h, w: jax_chunked_mlm_eval(
        h, w, jnp.asarray(offset), jnp.asarray(labels), jnp.asarray(mask), 4,
        head_fn=jhead))(jnp.asarray(hidden), jnp.asarray(head_w))
    got_l, got_a = chunked_mlm_eval(torch.from_numpy(hidden), torch.from_numpy(head_w),
                                    torch.from_numpy(offset), torch.from_numpy(labels).long(),
                                    torch.from_numpy(mask), 4, head_fn=thead)
    assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(float(want_l))
    assert float(got_a) == float(want_a)
    if not with_head:
        assert float(got_a) > 0


# ------------------------------------------------------------------ engine
HN = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=1, num_attention_heads=2,
          max_position_embeddings=10, hn_surface_maxlen=4, embed_using_source_embeddings=True,
          n_extra_tokens=16, rescale_embeddings=True, predict_bias=True, embed_lang_id=True,
          n_langs=26, hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
          n_embd=HF_CONFIG["hidden_size"])
V_BATCH = 64
BACKBONE = dict(HF_CONFIG, num_hidden_layers=1)  # the train steps' backbone


def _mlm_batch(seed):
    rng = np.random.default_rng(seed)
    M = HN["hn_surface_maxlen"]
    sf = rng.integers(1, HF_CONFIG["vocab_size"] + 16, size=(V_BATCH, M)).astype(np.int32)
    sf[np.arange(M)[None] >= rng.integers(1, M + 1, size=V_BATCH)[:, None]] = 0
    ids, mask = padded_batch(V_BATCH, seed=seed)
    labels = np.where(rng.random(ids.shape) < 0.3, ids, -100).astype(np.int32)
    labels[:, 0] = -100
    vocab_mask = np.ones(V_BATCH, bool)
    vocab_mask[-4:] = False
    return {"input_ids": ids.astype(np.int32), "attention_mask": mask.astype(np.int32),
            "labels": labels, "target_surface_forms": sf,
            "target_priors": np.zeros(V_BATCH, np.float32), "mask": vocab_mask,
            "ids_to_embed": rng.permutation(HF_CONFIG["vocab_size"])[:V_BATCH].astype(np.int32),
            "special_indices": np.array([0, 1, 2]),
            "special_indices_in_reference": np.array([0, 1, 2]), "lang_index": np.array(5),
            "byte_lengths": np.ones(ids.shape, np.int32)}


@pytest.fixture(scope="module")
def engine_pair():
    """A JAX Trainer (loss mlm, learnable bias, 26 language ids) over the
    seeded xlm-roberta, its gradients captured, the eval metrics and one
    train step run; the hypernet's initial parameters as JAX made them."""
    sd = roberta_state_dict(BACKBONE)
    _, jcfg, params = jax_roberta(BACKBONE, sd)
    kw = dict(steps=4, learning_rate=1e-3, warmup_steps=1, loss="mlm", learnable_bias=True,
              lexical_loss_weight=0.0, logging_steps=10, save_steps=0, eval_steps=0)
    captured = []
    orig = JaxTrainState.apply_gradients

    def capture(self, *, grads, **k):
        jax.debug.callback(captured.append, grads)
        return orig(self, grads=grads, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTrainState, "apply_gradients", capture)
    try:
        jtr = JaxTrainer(hn_config=JaxHnConfig(**HN), backbone_config=jcfg,
                         backbone_params=params, model_type="xlm-roberta",
                         train_config=JaxTrainingConfig(**kw), vocab_batch_size=V_BATCH)
        hn_params = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
            jtr.state.params["hypernet"], sep="/").items()}
        eb = _mlm_batch(20)
        evals = {k: float(v) for k, v in jtr.eval_step(jtr.state, jtr._device_batch(eb)).items()}
        tb = _mlm_batch(21)
        jtr.state, metrics = jtr.train_step(jtr.state, jtr._device_batch(tb))
        jax.effects_barrier()
    finally:
        mp.undo()
    grads = {k[1:]: np.asarray(v) for k, v in traverse_util.flatten_dict(captured[0]).items()
             if k[0] == "hypernet"}
    return dict(sd=sd, hn_params=hn_params, kw=kw, eval_batch=eb, evals=evals, train_batch=tb,
                loss=float(metrics["loss"]), grads=grads)


def _port_trainer(pair, **kw):
    state = {k: torch.from_numpy(np.array(v)) for k, v in pair["sd"].items()}
    cfg = TrainingConfig(**{**pair["kw"], **kw})
    return Trainer(hn_config=HypernetConfig(**HN),
                   backbone_config=config_from_hf("xlm-roberta", BACKBONE),
                   backbone_state=state, model_type="xlm-roberta", train_config=cfg,
                   device="cpu", hn_params=pair["hn_params"])


@pytest.mark.parametrize("chunk", [0, 5])
def test_mlm_train_step_and_eval_match_jax(engine_pair, chunk):
    """One train step under loss "mlm" (learnable bias, language id 5 of
    26; a 1-layer backbone, no lexical loss) from the JAX hypernet's
    parameters carried in by flax_to_torch (xlmr_26l's settings: 26
    language ids, the bias head), unchunked and with loss_chunk_size 5 (L
    12: a padded last chunk) against JAX's unchunked step: the loss within 1e-5
    relative, every hypernet gradient within 1e-4 of its largest (or of 1%
    of the model's largest); the eval metrics (eval_loss, eval_accuracy)
    before it within 1e-5 relative and equal."""
    pair = engine_pair
    ttr = _port_trainer(pair, loss_chunk_size=chunk)
    b = ttr._device_batch(pair["eval_batch"])
    got = {k: float(v) for k, v in ttr.eval_step(b).items()}
    assert sorted(got) == sorted(pair["evals"]) == ["eval_accuracy", "eval_loss"]
    assert abs(got["eval_loss"] - pair["evals"]["eval_loss"]) <= 1e-5 * pair["evals"]["eval_loss"]
    assert got["eval_accuracy"] == pair["evals"]["eval_accuracy"]

    m = ttr.train_step(pair["train_batch"])
    assert abs(m["loss"] - pair["loss"]) <= 1e-5 * abs(pair["loss"])
    transposed = {p for p, t in flax_paths(ttr.hypernet).values() if t}
    floor = 1e-2 * max(np.abs(g).max() for g in pair["grads"].values())
    bias_grad = None
    for path, want in pair["grads"].items():
        g = ttr.last_grads[("hypernet",) + path]
        g = torch.zeros_like(ttr.params[("hypernet",) + path]) if g is None else g
        g = (g.t() if path in transposed else g).numpy()
        assert g.shape == want.shape, path
        assert np.abs(g - want).max() <= 1e-4 * max(np.abs(want).max(), floor), path
        if path[0] == "bias_projection" and path[-1] == "kernel":
            bias_grad = g
    assert bias_grad is not None and np.abs(bias_grad).max() > 0  # the learnable bias trains
    lang = ttr.last_grads[("hypernet", "encoder", "lang_embedding", "embedding")]
    assert torch.nonzero(lang.abs().sum(-1)).flatten().tolist() == [5]


def test_trainer_splices_no_source_bias(engine_pair):
    """The source's lm-head bias never reaches the logits: a trainer whose
    backbone holds a huge lm_head.bias gives the same loss."""
    pair = engine_pair
    a = _port_trainer(pair)
    sd = dict(pair["sd"], **{"lm_head.bias": np.full(HF_CONFIG["vocab_size"], 1e4, np.float32)})
    b = _port_trainer(dict(pair, sd=sd))
    batch = pair["eval_batch"]
    la = float(a.eval_step(a._device_batch(batch))["eval_loss"])
    lb = float(b.eval_step(b._device_batch(batch))["eval_loss"])
    assert la == lb


# --------------------------------------------------------------------- CLIs
def _write_model_dir(path, data):
    """A tiny xlm-roberta HF directory (safetensors, config.json, the
    tokenizer with <mask>) with the seeded weights."""
    from zett_tpu_torch.models.backbones.hf_io import save_hf_model

    n = len(data["model"]["vocab"])
    cfg = dict(HF_CONFIG, vocab_size=n)
    sd = roberta_state_dict(cfg, seed=3)
    save_hf_model(path, {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, cfg)
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(data, f, ensure_ascii=False)
    return cfg


LANGS = ["en", "de", "fr"]


def _cli_config(model_dir, out, texts, **kw):
    by_lang = {lang: texts[i * 30:(i + 1) * 30] for i, lang in enumerate(LANGS)}
    return {
        "model_dir": model_dir, "output_dir": out, "loss": "mlm", "learnable_bias": True,
        "embed_lang_id": True, "langs": LANGS, "language_metadata_csv": CSV,
        "language_sampling_alpha": 0.1, "texts_by_lang": by_lang, "steps": 3, "warmup_steps": 1,
        "identity_steps": 1, "identity_n_subsample": 128, "logging_steps": 1, "save_steps": 0,
        "eval_steps": 0, "batch_size": 4, "block_size": 16, "n_token_subsample": None,
        "pad_to_multiple_of": 64, "tokenizer_sample_mean": 256, "tokenizer_sample_std": 0,
        "tokenizer_sample_min": 256, "tokenizer_sample_max": 512, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 1,
        "max_position_embeddings": 8, "hn_surface_maxlen": 4,
        "embed_using_source_embeddings": True, "n_extra_tokens": 8, "rescale_embeddings": True,
        "lexical_loss_weight": 0.5, "lexical_loss_kind": "huber", "hidden_dropout_prob": 0.0,
        "attention_dropout_prob": 0.0, "n_initial_texts": 16, "seed": 3, **kw,
    }


def _captured_eval_loop(module, store):
    """Wrap ``module.eval_loop`` to keep the batches it is given."""
    orig = module.eval_loop

    def wrapped(trainer, batches, **kw):
        batches = list(batches)
        store.extend(batches)
        return orig(trainer, iter(batches), **kw)

    return wrapped


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory, xlmr_like_json, texts):
    """The port's training CLI on --device cpu at a tiny xlm-roberta (loss
    mlm, language_metadata_csv): a 3-step run with eval at step 0, a 2-step
    run, and that run resumed to step 3 from its final/ (replay resume)."""
    import zett_tpu_torch.evaluation as port_eval
    from zett_tpu_torch.training.__main__ import main

    root = tmp_path_factory.mktemp("xlmr_cli")
    model_dir = str(root / "xlmr")
    data = xlmr_mask_json(xlmr_like_json)
    _write_model_dir(model_dir, data)
    valid = {lang: texts[90 + 4 * i: 94 + 4 * i] for i, lang in enumerate(LANGS)}

    def run(name, **kw):
        path = root / f"{name}.json"
        path.write_text(json.dumps(_cli_config(model_dir, str(root / name), texts, **kw)))
        return main([str(path), "--device", "cpu"])

    eval_batches = []
    mp = pytest.MonkeyPatch()
    mp.setattr(port_eval, "eval_loop", _captured_eval_loop(port_eval, eval_batches))
    try:
        full = run("full", eval_at_step_zero=True, valid_texts_by_lang=valid,
                   n_valid_subsample=4, extra_valid_tokenizers=[os.path.dirname(DE_RAW)])
    finally:
        mp.undo()
    short = run("short", steps=2)
    resumed = run("resumed", resume_from_checkpoint=str(root / "short" / "final"))
    return dict(root=root, model_dir=model_dir, data=data, full=full, short=short,
                resumed=resumed, eval_batches=eval_batches)


def test_training_cli_runs_mlm_and_resumes_bit_equal(cli_run):
    """xlm-roberta with loss mlm and language_metadata_csv through the CLI
    on --device cpu: finite losses, eval rows with eval_loss and
    eval_accuracy, final/ written; the languages drawn with probability
    size ** 0.1; a run resumed from a 2-step run's final/ replays the data
    stream and its step 3 equals the uninterrupted run's bit for bit (the
    masks included: ROADMAP C.18)."""
    from zett_tpu.data.datasets import language_probs_from_sizes as jax_probs
    from zett_tpu.data.datasets import language_sizes_from_metadata as jax_sizes

    trainer, history = cli_run["full"]
    rows = [h for h in history if "loss" in h or "identity_loss" in h]
    assert [h["step"] for h in rows] == [1, 2, 3]
    assert all(np.isfinite(v) for h in history for v in h.values() if isinstance(v, float))
    out = cli_run["root"] / "full"
    metrics = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    first = metrics[0]
    assert first.get("step", 0) == 0 and "eval/eval_loss" in first
    for name in ("eval", "eval_de_raw"):
        for key in ("eval_loss", "eval_accuracy"):
            assert np.isfinite(first[f"{name}/{key}"]), (name, key)
    for f in ("hn_config.json", "params.npz", "tokenizer.json"):
        assert (out / "final" / f).exists()
    assert trainer.hn_config.n_langs == 3
    want = jax_probs(jax_sizes(LANGS, CSV), 0.1)
    np.testing.assert_array_equal(
        language_probs_from_sizes(language_sizes_from_metadata(LANGS, CSV), 0.1), want)

    _, hist_r = cli_run["resumed"]
    full3 = [h for h in history if h.get("step") == 3][0]
    res3 = [h for h in hist_r if h.get("step") == 3][0]
    assert res3["loss"] == full3["loss"]


@pytest.fixture(scope="module")
def transferred(cli_run, tmp_path_factory):
    """Both transfer CLIs from the CLI run's final/ (orbax state beside its
    params.npz for JAX) to its own hn tokenizer (final/tokenizer.json)."""
    import orbax.checkpoint as ocp

    from zett_tpu.transfer.__main__ import main as jax_main
    from zett_tpu_torch.transfer.__main__ import main as port_main

    final = cli_run["root"] / "full" / "final"
    with np.load(final / "params.npz") as z:
        flat = {k: z[k] for k in z.files}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(final / "state"), traverse_util.unflatten_dict(flat, sep="/"))
    ckptr.wait_until_finished()
    root = tmp_path_factory.mktemp("xlmr_transfer")
    common = ["--checkpoint", str(final), "--model", cli_run["model_dir"],
              "--target-tokenizer", str(final), "--batch-size", "1024", "--lang-index", "1"]
    jax_out, port_out = str(root / "jax"), str(root / "port")
    jax_main(common + ["--output", jax_out])
    port_main(common + ["--output", port_out, "--device", "cpu"])
    return jax_out, port_out


def test_transfer_cli_matches_jax(transferred):
    """The same safetensors keys and dtypes; the spliced table (the tied
    decoder equal to it) within 1e-5; both lm-head biases zero;
    bias.npy within 1e-5; every other weight, config.json and
    tokenizer.json identical."""
    from safetensors.numpy import load_file

    jax_out, port_out = transferred
    ref = load_file(os.path.join(jax_out, "model.safetensors"))
    got = load_file(os.path.join(port_out, "model.safetensors"))
    assert set(got) == set(ref) and "roberta.embeddings.position_ids" not in got
    table = "roberta.embeddings.word_embeddings.weight"
    assert got[table].shape[0] == len(Tokenizer.from_file(os.path.join(port_out,
                                                                      "tokenizer.json")))
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        if k in (table, "lm_head.decoder.weight"):
            assert np.abs(got[k] - ref[k]).max() <= 1e-5, k
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got["lm_head.decoder.weight"], got[table])
    for k in ("lm_head.bias", "lm_head.decoder.bias"):
        assert not got[k].any()
    b_ref, b_got = (np.load(os.path.join(d, "bias.npy")) for d in (jax_out, port_out))
    assert b_got.dtype == b_ref.dtype and np.abs(b_got - b_ref).max() <= 1e-5
    for name in ("tokenizer.json", "config.json"):
        with open(os.path.join(jax_out, name)) as a, open(os.path.join(port_out, name)) as b:
            assert a.read() == b.read(), name


def test_mlm_probe_matches_jax(transferred, texts):
    """mlm_probe on the port's transferred model under its tokenizer against
    JAX's on the same weights, texts and seed: n_masked equal, the loss
    within 1e-5 relative, the accuracy equal."""
    from zett_tpu.evaluation.mlm_probe import mlm_probe as jax_probe
    from zett_tpu.models.backbones.loader import load_backbone_params
    from zett_tpu_torch.evaluation import mlm_probe
    from zett_tpu_torch.models.backbones.hf_io import load_hf_state_dict
    from zett_tpu_torch.models.backbones.registry import build_model

    _, port_out = transferred
    with open(os.path.join(port_out, "config.json")) as f:
        cfg_json = json.load(f)
    jmodel, jcfg, _ = jax_roberta(cfg_json, {})
    params = load_backbone_params(port_out, "xlm-roberta", jcfg)
    tok_path = os.path.join(port_out, "tokenizer.json")
    probe_texts = texts[:20]
    want = jax_probe(lambda p, ids, mask: jmodel.apply({"params": p}, ids, mask), params,
                     JaxTokenizer.from_file(tok_path), probe_texts, block_size=32, batch_size=8,
                     seed=4)
    model = build_model("xlm-roberta", config_from_hf("xlm-roberta", cfg_json),
                        load_hf_state_dict(port_out), torch.float32)
    got = mlm_probe(model, Tokenizer.from_file(tok_path), probe_texts, block_size=32,
                    batch_size=8, seed=4)
    assert got["n_masked"] == want["n_masked"] > 0
    assert abs(got["mlm_loss"] - want["mlm_loss"]) <= 1e-5 * want["mlm_loss"]
    assert got["mlm_accuracy"] == want["mlm_accuracy"]


def test_c19_mlm_eval_batches_are_not_masked(cli_run, tmp_path, monkeypatch):
    """ROADMAP C.19: under loss "mlm" the JAX CLI's eval batches (the
    sampled-tokenizer validation and the extra-valid de_raw ones) are
    not masked, their labels are their ids, while its train batches are;
    the port's CLI, on the same config, gives eval batches of the same
    kind. The JAX CLI runs with its Trainer stubbed out (no step)."""
    import zett_tpu.evaluation as jax_eval
    from zett_tpu.training import engine as jax_engine
    from zett_tpu.training.__main__ import main as jax_main

    train_batches, eval_batches = [], []

    class StubTrainer:
        def __init__(self, **kw):
            self.state = type("State", (), {"step": 0})()

        def fit(self, batch_iter, identity_iter=None, **kw):
            train_batches.append(next(batch_iter))
            return []

        def save_checkpoint(self, path, **kw):
            os.makedirs(path, exist_ok=True)

    def capture(trainer, batches, name="eval", **kw):
        eval_batches.extend((name, b) for b in batches)
        return {}

    monkeypatch.setattr(jax_engine, "Trainer", StubTrainer)
    monkeypatch.setattr(jax_eval, "eval_loop", capture)
    config = json.loads((cli_run["root"] / "full.json").read_text())
    config["output_dir"] = str(tmp_path / "jax")
    path = tmp_path / "jax.json"
    path.write_text(json.dumps(config))
    jax_main([str(path)])

    assert sorted({name for name, _ in eval_batches}) == ["eval", "eval_de_raw"]
    port = [("port", b) for b in cli_run["eval_batches"]]
    assert len(port) == len(eval_batches)
    for name, b in eval_batches + port:
        labels, ids = np.asarray(b["labels"]), np.asarray(b["input_ids"])
        assert not (labels == -100).any(), name
        np.testing.assert_array_equal(labels, ids, err_msg=name)
    assert (np.asarray(train_batches[0]["labels"]) == -100).mean() > 0.5


def test_c20_special_past_the_target_vocab(xlmr_like_json):
    """ROADMAP C.20: a target converted to match a source whose special id
    lies past the target's vocab (XLM-R's <mask>, the last of 250002 ids;
    here the 8000th id against de_raw's 7715 converted tokens). JAX
    registers the source's id, which no row of the target holds, and its
    transfer() raises IndexError at the special-token splice; the port
    registers the special at its row (the end of the vocab), and its
    transfer puts the source's <mask> row there. Both transfers run a stub
    hypernet (ones; the splice is the point)."""
    from types import SimpleNamespace

    from zett_tpu.transfer import transfer as jax_transfer
    from zett_tpu_torch.transfer import transfer

    data = copy.deepcopy(xlmr_like_json)
    n = 7999 - len(data["model"]["vocab"])
    data["model"]["vocab"] += [[f"▁pad{i}", -30.0] for i in range(n)]
    data = xlmr_mask_json(data)
    de_raw = DE_RAW
    jsrc, _ = jax_convert(JaxTokenizer.from_json(data))
    tsrc, _ = convert_to_byte_level(Tokenizer.from_json(data))
    assert jsrc.token_to_id("<mask>") == tsrc.token_to_id("<mask>") == 7999
    src = np.random.default_rng(0).normal(size=(len(tsrc), 8)).astype(np.float32)

    class JaxStub:
        config = SimpleNamespace(hn_surface_maxlen=4, pad_token_id=0,
                                 concat_last_hidden_state=False)
        dtype = jnp.float32

        def apply(self, variables, sf, pr, source, lang):
            return jnp.ones((sf.shape[0], 8)), None, jnp.zeros(sf.shape[0])

    class Stub(torch.nn.Module):
        config = SimpleNamespace(hn_surface_maxlen=4, pad_token_id=0)
        dtype = torch.float32

        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))

        def forward(self, sf, pr, source, lang):
            return torch.ones(sf.shape[0], 8), None, torch.zeros(sf.shape[0])

    with pytest.raises(IndexError):
        jax_transfer(hypernet=JaxStub(), hn_params={}, hn_tokenizer=jsrc, source_tokenizer=jsrc,
                     source_embeddings_in=src, target_tokenizer=JaxTokenizer.from_file(de_raw),
                     batch_size=4096)
    emb, _, bias, target = transfer(hypernet=Stub(), hn_tokenizer=tsrc, source_tokenizer=tsrc,
                                    source_embeddings_in=src,
                                    target_tokenizer=Tokenizer.from_file(de_raw),
                                    batch_size=4096)
    mask_id = target.token_to_id("<mask>")
    assert emb.shape == (len(target), 8) and mask_id == len(target) - 1
    np.testing.assert_array_equal(emb[mask_id], src[7999])
    jtarget, _ = jax_convert(JaxTokenizer.from_file(de_raw), match_special_tokens_to=jsrc,
                             make_whitespace_consistent=True)
    assert jtarget.to_json()["model"] == target.to_json()["model"]
    assert jtarget.token_to_id("<mask>") == 7999 >= len(jtarget) == len(target)
    assert bias[mask_id] == 0.0
