"""The port's n-shot and baseline training path held against the JAX
package on the CPU: PassthroughHypernet (f32 and bf16, tied and untied,
with and without the bias table), the Collator's passthrough branch, train
steps with passthrough tables and ``backbone_training: "full"`` on a GPT-2
and a Llama backbone under AdamW and Adafactor (losses, gradients, every
updated table and backbone parameter), the full-state resume with the
backbone, the baseline configs' constant schedule, the training CLI into
the baselines CLI's ``--method passthrough``, and the reference's faults
on this path: C.11 (the lexical loss under passthrough), C.12 (tables keyed
by each target token's first hypernet piece), C.14 (a fixed tokenizer with
more ids than the source table) and C.15 (validation text under a fixed
tokenizer)."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax import traverse_util

from zett_tpu.data import Collator as JaxCollator
from zett_tpu.data import DataConfig as JaxDataConfig
from zett_tpu.models import HypernetConfig as JaxHnConfig
from zett_tpu.models import PassthroughHypernet as JaxPassthrough
from zett_tpu.models.backbones.gpt2 import GPT2Config as JaxGPT2Config
from zett_tpu.models.backbones.gpt2 import GPT2LMHeadModel as JaxGPT2
from zett_tpu.models.backbones.llama import LlamaConfig as JaxLlamaConfig
from zett_tpu.models.backbones.llama import LlamaForCausalLM as JaxLlama
from zett_tpu.models.backbones.loader import invert_gpt2, invert_llama
from zett_tpu.tokenization import Tokenizer as JaxTokenizer
from zett_tpu.tokenization.convert import convert_to_byte_level as jax_convert
from zett_tpu.training import Trainer as JaxTrainer
from zett_tpu.training import TrainingConfig as JaxTrainingConfig
from zett_tpu.training.schedules import create_learning_rate_fn as jax_lr_fn
from zett_tpu.training.state import TrainState as JaxTrainState
from zett_tpu_torch.data import Collator, DataConfig
from zett_tpu_torch.models import HypernetConfig, PassthroughHypernet
from zett_tpu_torch.models.backbones.gpt2 import GPT2Config, GPT2LMHeadModel
from zett_tpu_torch.models.backbones.llama import LlamaConfig
from zett_tpu_torch.models.convert import flax_paths, flax_to_torch, torch_to_flax
from zett_tpu_torch.tokenization.convert import convert_to_byte_level
from zett_tpu_torch.tokenization.core import Tokenizer
from zett_tpu_torch.training import Trainer, TrainingConfig
from zett_tpu_torch.training.optimizer import factored_dims
from zett_tpu_torch.training.schedules import create_learning_rate_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V_BATCH, VOCAB, WIDTH = 64, 300, 128  # the tables: VOCAB padded to 384 rows
HN = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=1, num_attention_heads=1,
          max_position_embeddings=8, n_embd=WIDTH, hn_surface_maxlen=4,
          embed_using_source_embeddings=True, predict_bias=True,
          hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
GPT2 = dict(vocab_size=VOCAB, n_positions=32, n_embd=WIDTH, n_layer=2, n_head=4)
LLAMA = dict(hidden_size=WIDTH, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64, rms_norm_eps=1e-5,
             tie_word_embeddings=False)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel, what="", floor=1e-12):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


# ---------------------------------------------------------------- the module
@pytest.mark.parametrize("predict_bias", [True, False])
@pytest.mark.parametrize("untied", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_passthrough_hypernet_matches_jax(dtype, untied, predict_bias):
    """Rows of f32 tables looked up in the compute dtype, by the first
    surface-form id, equal JAX's exactly (an id past the table a NaN row
    on both sides); the parameters carry across under their Flax names."""
    cfg = dict(HN, n_embd=16, separate_out_embeddings=untied, predict_bias=predict_bias)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(0)
    sf = rng.integers(0, 40, size=(24, 4)).astype(np.int32)
    sf[5, 0] = 40  # past the table
    jmodel = JaxPassthrough(JaxHnConfig(**cfg), vocab_size=40, dtype=jdt)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(sf))["params"]
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    names = {"input_embeddings/embedding"} | ({"output_embeddings/embedding"} if untied else set()) \
        | ({"bias/embedding"} if predict_bias else set())
    assert set(flat) == names
    want = jmodel.apply({"params": params}, jnp.asarray(sf), None, None, 0)
    model = PassthroughHypernet(HypernetConfig(**cfg), vocab_size=40, dtype=tdt)
    model.load_state_dict(flax_to_torch(flat), strict=True)
    assert {"/".join(p) for p, _ in flax_paths(model).values()} == names
    assert all(np.array_equal(v, flat[k]) for k, v in torch_to_flax(model).items())
    got = model(torch.from_numpy(sf), None, None, 0)
    assert (got[1] is None) == (want[1] is None)
    for g, w in zip(got, want):
        if w is None:
            continue
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_f32(g), _f32(w))
    assert bool(torch.isnan(got[0][5]).all()) and bool(jnp.isnan(want[0][5]).all())


# ------------------------------------------------------------- the collator
@pytest.fixture(scope="module")
def gpt2_reference(gpt2_like_json):
    """(JAX, port) byte-level gpt2-like reference tokenizers."""
    data = jax_convert(JaxTokenizer.from_json(gpt2_like_json))[0].to_json()
    return JaxTokenizer.from_json(data), Tokenizer.from_json(data)


def _collators(refs, fixed_json, passthrough, convert):
    jref, tref = refs
    cfg = dict(block_size=32, hn_surface_maxlen=7, pad_to_multiple_of=64, langs=["en"],
               do_tokenizer_sampling=False, n_token_subsample=None,
               use_passthrough_hypernet=passthrough)
    jfixed, tfixed = JaxTokenizer.from_json(fixed_json), Tokenizer.from_str(json.dumps(fixed_json))
    if convert:
        jfixed = jax_convert(jfixed, match_special_tokens_to=jref,
                             make_whitespace_consistent=True)[0]
        tfixed = convert_to_byte_level(tfixed, match_special_tokens_to=tref,
                                       make_whitespace_consistent=True)[0]
    a = JaxCollator(reference=jref, hn_tokenizer=jref.copy(), data_config=JaxDataConfig(**cfg),
                    batch_size=4, fixed_tokenizer=jfixed, seed=0)
    b = Collator(reference=tref, hn_tokenizer=tref.copy(), data_config=DataConfig(**cfg),
                 batch_size=4, fixed_tokenizer=tfixed, seed=0)
    return a, b


def test_passthrough_collator_keeps_the_fixed_tokenizer(gpt2_reference, gpt2_like_json, corpus):
    """With passthrough the Collator takes the fixed tokenizer as given
    (``collator.py:140``): the gpt2-like source's own tokenizer (1035
    tokens, the baseline configs' case) gives JAX's batches id for id, and
    other batches than the conversion the Collator makes without
    passthrough (1164 tokens with whitespace made consistent; what the port
    made before this branch)."""
    from test_torch_port_data import _assert_batches_equal

    texts = [t for t in corpus if t.strip()]
    a, b = _collators(gpt2_reference, gpt2_like_json, passthrough=True, convert=False)
    _, converted = _collators(gpt2_reference, gpt2_like_json, passthrough=False, convert=False)
    assert len(b.tokenizer) == 1035 and len(converted.tokenizer) == 1164
    for i in range(2):
        item = {"texts": texts[4 * i: 4 * i + 4], "lang_code": "en"}
        got = b(item)
        _assert_batches_equal(a(item), got)
        other = converted(item)
        assert not np.array_equal(got["input_ids"], other["input_ids"]) or \
            not np.array_equal(got["target_surface_forms"], other["target_surface_forms"])


def test_tables_are_keyed_by_the_first_hypernet_piece(gpt2_reference, xlmr_like_json, corpus):
    """ROADMAP C.12: with a fixed target unlike the hypernet's tokenizer the
    Collator builds hypernet surface forms, and the tables are read at each
    form's first piece: the xlmr-like target's tokens share source-id rows.
    The port's surface forms and looked-up rows equal JAX's."""
    texts = [t for t in corpus if t.strip()]
    a, b = _collators(gpt2_reference, xlmr_like_json, passthrough=True, convert=True)
    item = {"texts": texts[:4], "lang_code": "en"}
    ja, tb_ = a(item), b(item)
    np.testing.assert_array_equal(tb_["target_surface_forms"], ja["target_surface_forms"])
    n_target = len(b.tokenizer)
    first = tb_["target_surface_forms"][:n_target, 0]
    assert len(np.unique(first)) < n_target  # many target tokens, one row
    rows = 1152  # the gpt2-like source's 1035 rows padded to a multiple of 128
    cfg = dict(HN, n_embd=16)
    jmodel = JaxPassthrough(JaxHnConfig(**cfg), vocab_size=rows)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(ja["target_surface_forms"]))
    want = jmodel.apply(params, jnp.asarray(ja["target_surface_forms"]))[0]
    model = PassthroughHypernet(HypernetConfig(**cfg), vocab_size=rows)
    model.load_state_dict(flax_to_torch(
        {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params["params"],
                                                                 sep="/").items()}))
    got = model(torch.from_numpy(tb_["target_surface_forms"]))[0]
    np.testing.assert_array_equal(_f32(got), _f32(want))


# --------------------------------------------------------------- train steps
def _batch(seed):
    rng = np.random.default_rng(seed)
    B, L, M = 3, 12, HN["hn_surface_maxlen"]
    sf = rng.integers(1, 384, size=(V_BATCH, M)).astype(np.int32)
    lens = rng.integers(1, M + 1, size=V_BATCH)
    sf[np.arange(M)[None] >= lens[:, None]] = 0
    attention_mask = np.ones((B, L), np.int32)
    attention_mask[1, 9:] = 0
    mask = np.ones(V_BATCH, bool)
    mask[-5:] = False
    return {
        "input_ids": rng.integers(0, V_BATCH, size=(B, L)).astype(np.int32),
        "attention_mask": attention_mask,
        "labels": rng.integers(0, V_BATCH, size=(B, L)).astype(np.int32),
        "target_surface_forms": sf,
        "target_priors": np.zeros(V_BATCH, np.float32),
        "mask": mask,
        "special_indices": np.array([0, 5]),
        "special_indices_in_reference": np.array([0, 3]),
        "lang_index": np.array(0),
    }


def _backbone(model_type, seed=0):
    """(JAX config, Flax params with every leaf refilled from a numpy seed,
    port config, HF state dict)."""
    if model_type == "gpt2":
        jcfg = JaxGPT2Config(**GPT2)
        params = JaxGPT2(jcfg).init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    else:
        jcfg = JaxLlamaConfig(vocab_size=VOCAB, **LLAMA)
        params = JaxLlama(jcfg).init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    flat = traverse_util.flatten_dict(params, sep="/")
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        x = 1.0 + 0.1 * rng.normal(size=v.shape) if k.endswith(("norm/weight", "scale")) else \
            rng.normal(size=v.shape) * (0.05 if "embed" in k or "lm_head" in k or "wte" in k
                                        else 0.1)
        flat[k] = np.asarray(x, np.float32)
    tree = traverse_util.unflatten_dict(flat, sep="/")
    if model_type == "gpt2":
        sd = invert_gpt2(tree, jcfg)
        tcfg = GPT2Config(**GPT2)
    else:
        sd = invert_llama(tree, jcfg)
        tcfg = LlamaConfig.from_hf({"model_type": "llama", "vocab_size": VOCAB, **LLAMA})
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    return jcfg, tree, tcfg, sd


def _trainers(model_type, adafactor, dtype="float32", learning_rate=1e-3):
    jcfg, tree, tcfg, sd = _backbone(model_type)
    hn = dict(HN, separate_out_embeddings=model_type != "gpt2")
    kw = dict(steps=4, learning_rate=learning_rate, warmup_steps=0, learning_rate_alpha=1.0,
              lexical_loss_weight=0.0, max_grad_norm=0.1, weight_decay=0.01, adam_beta2=0.95,
              identity_steps=0, logging_steps=10, save_steps=0, eval_steps=0, dtype=dtype,
              backbone_training="full", learnable_bias=True, use_adafactor=adafactor)
    jtr = JaxTrainer(hn_config=JaxHnConfig(**hn), backbone_config=jcfg, backbone_params=tree,
                     model_type=model_type, train_config=JaxTrainingConfig(**kw),
                     vocab_batch_size=V_BATCH, use_passthrough_hypernet=True)
    ttr = Trainer(hn_config=HypernetConfig(**hn), backbone_config=tcfg, backbone_state=sd,
                  model_type=model_type, train_config=TrainingConfig(**kw), device="cpu",
                  use_passthrough_hypernet=True)
    return jtr, ttr


def _port_flax(ttr, path, t):
    return t.t() if path in ttr.transposed else t


def _inv_sqrt_second_moment(opt, path, shape):
    """1 / sqrt of the port Adafactor's second-moment estimate of a
    parameter after its last update, in the Flax layout."""
    if path in opt.state["v"]:
        return _f32(opt.state["v"][path]) ** -0.5
    d1, d0 = factored_dims(shape)
    row, col = _f32(opt.state["v_row"][path]), _f32(opt.state["v_col"][path])
    reduced_d1 = d1 - 1 if d1 > d0 else d1
    row_factor = (row / row.mean(axis=reduced_d1, keepdims=True)) ** -0.5
    return np.expand_dims(row_factor, d0) * np.expand_dims(col ** -0.5, d1)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("model_type", ["gpt2", "llama"])
def test_passthrough_full_finetuning_steps_match_jax(model_type, optimizer, monkeypatch):
    """Two train steps with the passthrough tables and the whole backbone
    trained, f32, from the same source rows and backbone: losses within
    1e-5 relative; each step's gradient of every table and backbone leaf
    within 1e-4 of its largest or of 1% of the model's largest; every
    parameter after the steps within 1e-5 of its leaf's scale plus 1e-4 x
    the summed learning rates plus, element by element, what the update
    rule carries of the measured gradient differences (AdamW:
    ``test_torch_port_training._adam_carried_differences``; Adafactor: 3
    lr x the parameter's block RMS x the difference / sqrt of the
    second-moment estimate a step). The Llama family's (out, in) weights
    reach the update rule in the Flax layout: Adafactor's row and column
    statistics of a factored kernel are JAX's."""
    from test_torch_port_training import _adam_carried_differences

    captured = []
    orig = JaxTrainState.apply_gradients

    def capture(self, *, grads, **kw):
        jax.debug.callback(captured.append, grads)
        return orig(self, grads=grads, **kw)

    monkeypatch.setattr(JaxTrainState, "apply_gradients", capture)
    jtr, ttr = _trainers(model_type, optimizer == "adafactor")
    assert isinstance(ttr.hypernet, PassthroughHypernet)
    assert all(p.dtype == torch.float32 for p in ttr.backbone.parameters())
    if model_type == "llama":
        assert ("inner", "model", "layers_0", "mlp", "up_proj", "kernel") in ttr.transposed
    start = {p: _f32(_port_flax(ttr, p, t)).copy() for p, t in ttr.params.items()}
    lrs, port_grads, bounds = [], [], {}
    for seed in (11, 12):
        batch = _batch(seed)
        before = {p: _f32(_port_flax(ttr, p, t)).copy() for p, t in ttr.params.items()}
        jtr.state, jm = jtr.train_step(jtr.state, jtr._device_batch(batch))
        tm = ttr.train_step(batch)
        _close(tm["loss"], jm["loss"], 1e-5, "loss")
        assert tm["lexical_loss"] == 0.0 and float(jm["lexical_loss"]) == 0.0
        lrs.append(tm["learning_rate"])
        grads = {p: _f32(_port_flax(ttr, p, g if g is not None else torch.zeros_like(ttr.params[p])))
                 for p, g in ttr.last_grads.items()}
        port_grads.append(grads)
        if optimizer == "adafactor":
            jg = traverse_util.flatten_dict(captured[-1])
            norms = [np.sqrt(sum(float(np.sum(np.square(_f32(g), dtype=np.float64)))
                                 for g in gs.values())) for gs in (jg, grads)]
            scales = [min(1.0, ttr.cfg.max_grad_norm / n) for n in norms]
            for p in grads:
                diff = np.abs(scales[1] * grads[p] - scales[0] * _f32(jg[p]))
                rms = max(float(np.sqrt(np.mean(np.square(before[p])))), 1e-3)
                inv = _inv_sqrt_second_moment(ttr.optimizer, p, before[p].shape)
                bounds[p] = bounds.get(p, 0.0) + 3 * lrs[-1] * rms * diff * inv
    jax_grads = [traverse_util.flatten_dict(g) for g in captured]
    assert len(jax_grads) == 2
    for jgrads, tgrads in zip(jax_grads, port_grads):
        assert set(jgrads) == set(tgrads)
        floor = 1e-2 * max(float(np.abs(_f32(g)).max()) for g in jgrads.values())
        for path, g in jgrads.items():
            _close(tgrads[path], g, 1e-4, path, floor)
    if optimizer == "adamw":
        bounds = _adam_carried_differences(jax_grads, port_grads, lrs, ttr.cfg)
    jparams = traverse_util.flatten_dict(jtr.state.params)
    assert set(jparams) == set(ttr.params)
    lr_sum = sum(lrs)
    for path, want in jparams.items():
        got = _f32(_port_flax(ttr, path, ttr.params[path]))
        want = _f32(want)
        assert got.shape == want.shape, path
        err = np.abs(got - want)
        assert (err <= 1e-5 * np.abs(want).max() + 1e-4 * lr_sum + bounds[path]).all(), \
            (path, float(err.max()))
    for path in (("hypernet", "input_embeddings", "embedding"),
                 ("inner",) + (("transformer", "h_1", "c_fc", "kernel")
                               if model_type == "gpt2" else
                               ("model", "layers_1", "mlp", "up_proj", "kernel"))):
        assert not np.array_equal(_f32(_port_flax(ttr, path, ttr.params[path])), start[path])


def test_gpt2_full_finetuning_forward_promotes_like_flax():
    """f32 parameters under bf16 compute (full fine-tuning): the LayerNorms
    take their f32 parameters and return f32, as flax promotes them, so the
    final hidden states and the logits are f32; the logits within 2 bf16
    ulps of the largest of the JAX module's at dtype bf16."""
    jcfg, tree, tcfg, sd = _backbone("gpt2", seed=4)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, VOCAB, size=(2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int32)
    mask[1, 7:] = 0
    want = JaxGPT2(jcfg, dtype=jnp.bfloat16).apply({"params": tree}, jnp.asarray(ids),
                                                   jnp.asarray(mask))
    model = GPT2LMHeadModel(tcfg, sd, torch.bfloat16)
    got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                sd["transformer.wte.weight"])
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    scale = float(np.abs(_f32(want)).max())
    assert np.abs(_f32(got) - _f32(want))[mask.astype(bool)].max() <= 2 * 2.0 ** -8 * scale


def test_full_state_resume_carries_the_backbone(tmp_path):
    """A full-state checkpoint after step 1 (Llama, AdamW: its kernels
    transposed into the Flax layout) holds "inner/<Flax path>" for every
    backbone parameter, and a new trainer restored from it takes step 2
    exactly as the uninterrupted run: the loss, the tables and every
    backbone parameter bit for bit."""
    _, a = _trainers("llama", False)
    a.train_step(_batch(11))
    a.save_checkpoint(str(tmp_path / "ckpt"), full_state=True)
    want = a.train_step(_batch(12))
    with np.load(tmp_path / "ckpt" / "resume" / "state.npz") as z:
        inner = {k for k in z.files if k.startswith("inner/")}
        up = z["inner/model/layers_0/mlp/up_proj/kernel"]
    assert inner == {"/".join(p) for p in a.params if p[0] == "inner"}
    assert up.shape == (WIDTH, 256)  # (in, out), the Flax layout
    with np.load(tmp_path / "ckpt" / "params.npz") as z:
        assert set(z.files) == {"input_embeddings/embedding", "output_embeddings/embedding",
                                "bias/embedding"}
    _, b = _trainers("llama", False)
    assert b.restore_checkpoint(str(tmp_path / "ckpt")) == 1
    got = b.train_step(_batch(12))
    assert got["loss"] == want["loss"]
    for path, p in a.params.items():
        assert torch.equal(b.params[path], p), path


def test_baseline_schedule_is_constant():
    """The baseline configs' scalar learning rate with warmup_steps 0 and
    learning_rate_alpha 1.0: the port's schedule equals optax's at every
    step, the rate itself throughout."""
    kw = dict(steps=50, learning_rate=1e-6, warmup_steps=0, learning_rate_alpha=1.0)
    jr, _ = jax_lr_fn(JaxTrainingConfig(**kw))
    tr, _ = create_learning_rate_fn(TrainingConfig(**kw))
    for s in range(55):
        want = float(jr(jnp.int32(s)))
        assert abs(float(tr(s)) - want) <= 2.4e-7 * abs(want), s
        assert abs(want - 1e-6) <= 1e-6 * 2.4e-7


# ------------------------------------------------------------- through CLIs
@pytest.fixture(scope="module")
def gpt2_dir(tmp_path_factory, gpt2_like_json):
    from safetensors.numpy import save_file

    path = tmp_path_factory.mktemp("gpt2_passthrough")
    tok = JaxTokenizer.from_json(gpt2_like_json)
    cfg = JaxGPT2Config(vocab_size=len(tok), n_positions=64, n_embd=32, n_layer=1, n_head=2)
    params = JaxGPT2(cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    sd = invert_gpt2(jax.tree_util.tree_map(np.asarray, params), cfg)
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              str(path / "model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": len(tok), "n_positions": 64,
                   "n_embd": 32, "n_layer": 1, "n_head": 2, "layer_norm_epsilon": 1e-5,
                   "tie_word_embeddings": True}, f)
    tok.save(str(path / "tokenizer.json"))
    return str(path)


def _nshot_config(model_dir, out_dir, corpus, **over):
    """configs/nshot/gpt2_passthrough_ft.json's keys on gpt2_en's, at a tiny
    size."""
    cfg = {
        "model_dir": model_dir, "output_dir": out_dir,
        "texts_by_lang": {"en": [t for t in corpus if t.strip()][:96]}, "langs": ["en"],
        "steps": 2, "warmup_steps": 0, "learning_rate": 1e-4, "learning_rate_alpha": 1.0,
        "identity_steps": 0, "logging_steps": 1, "save_steps": 0, "eval_steps": 0,
        "batch_size": 8, "block_size": 16, "n_token_subsample": None,
        "pad_to_multiple_of": 128, "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 1, "num_attention_heads": 2, "max_position_embeddings": 16,
        "hn_surface_maxlen": 8, "n_initial_texts": 16, "hidden_dropout_prob": 0.0,
        "attention_dropout_prob": 0.0, "use_passthrough_hypernet": True,
        "do_tokenizer_sampling": False, "backbone_training": "full",
        "embed_using_source_embeddings": True, "lexical_loss_weight": 0.5,
        "predict_bias": True,
    }
    cfg.update(over)
    return cfg


def test_lexical_loss_under_passthrough_fails_in_jax_and_is_refused(gpt2_dir, corpus, tmp_path):
    """ROADMAP C.11: passthrough with embed_using_source_embeddings and a
    lexical weight (every configs/nshot/*.json): JAX's run_training fails
    with TypeError at its first step (the state keeps no source table); the
    port refuses with a ValueError naming C.11 before it trains."""
    from zett_tpu.training.__main__ import run_training as jax_run
    from zett_tpu_torch.training.__main__ import run_training

    with pytest.raises(TypeError, match="NoneType"):
        jax_run(_nshot_config(gpt2_dir, str(tmp_path / "jax"), corpus), "c11")
    with pytest.raises(ValueError, match="C.11"):
        run_training(_nshot_config(gpt2_dir, str(tmp_path / "port"), corpus), "c11",
                     device="cpu")
    assert not os.path.exists(tmp_path / "port")


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(REPO, "configs", "nshot"))))
def test_nshot_configs_raise_the_named_error(name):
    """Each configs/nshot/*.json raises C.11's ValueError from the training
    CLI before it reads its model."""
    from zett_tpu_torch.training.__main__ import main

    with pytest.raises(ValueError, match="C.11"):
        main([os.path.join(REPO, "configs", "nshot", name), "--device", "cpu"])


def test_training_cli_into_the_passthrough_baseline(gpt2_dir, xlmr_like_json, corpus, tmp_path):
    """An n-shot run through the training CLI against a fixed target
    (passthrough tables, full fine-tuning, lexical weight 0): finite losses,
    final/params.npz holds the tables only, and the baselines CLI's
    --method passthrough writes the tables' first rows as the model's table
    under the target it trained on, as JAX's passthrough_transfer slices
    them."""
    from zett_tpu.transfer.baselines import passthrough_transfer
    from zett_tpu_torch.models.backbones.hf_io import load_safetensors
    from zett_tpu_torch.training.__main__ import run_training
    from zett_tpu_torch.transfer.baselines_cli import main as baselines_main

    target = tmp_path / "target.json"
    JaxTokenizer.from_json(xlmr_like_json).save(str(target))
    cfg = _nshot_config(gpt2_dir, str(tmp_path / "run"), corpus, lexical_loss_weight=0.0,
                        target_tokenizer=str(target))
    trainer, history = run_training(cfg, "nshot", device="cpu")
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    final = tmp_path / "run" / "final"
    with np.load(final / "params.npz") as z:
        tables = {k: z[k] for k in z.files}
    assert set(tables) == {"input_embeddings/embedding", "bias/embedding"}
    assert os.path.exists(final / "resume" / "state.npz")
    out = tmp_path / "model"
    summary = baselines_main(["--method", "passthrough", "--checkpoint", str(final),
                              "--model", gpt2_dir, "--target-tokenizer", str(target),
                              "--output", str(out), "--device", "cpu"])
    written = load_safetensors(str(out / "model.safetensors"))
    n = json.load(open(out / "config.json"))["vocab_size"]
    assert n == summary["n_target"] == len(trainer.last_train_batch["target_surface_forms"]
                                           [trainer.last_train_batch["mask"]])
    want, _ = passthrough_transfer({"input_embeddings": {"embedding": tables[
        "input_embeddings/embedding"]}}, n)
    np.testing.assert_array_equal(written["transformer.wte.weight"].numpy(), want)


def test_cli_resume_from_a_periodic_save_replays_step_2(gpt2_dir, corpus, tmp_path):
    """Full fine-tuning through the training CLI: 2 steps with the full
    state saved after each (step_1/ holds inner/), and step 2 resumed from
    step_1/ through the CLI takes the continuous run's batch (the data
    replay) and gives its loss, tables and backbone bit for bit."""
    from zett_tpu_torch.training.__main__ import run_training

    cfg = _nshot_config(gpt2_dir, str(tmp_path / "run"), corpus, lexical_loss_weight=0.0,
                        save_steps=1, save_state=True)
    cont, want = run_training(cfg, "continuous", device="cpu")
    step_1 = tmp_path / "run" / "step_1"
    with np.load(step_1 / "resume" / "state.npz") as z:
        assert any(k.startswith("inner/") for k in z.files)
    res, got = run_training(dict(cfg, output_dir=str(tmp_path / "resumed"), save_steps=0,
                                 resume_from_checkpoint=str(step_1)), "resumed", device="cpu")
    assert [h["step"] for h in got] == [2] and got[0]["loss"] == want[1]["loss"]
    ref, new = cont.last_train_batch, res.last_train_batch
    keys = sorted(k for k, v in ref.items() if hasattr(v, "shape"))
    assert keys and keys == sorted(k for k, v in new.items() if hasattr(v, "shape"))
    for k in keys:
        np.testing.assert_array_equal(np.asarray(new[k]), np.asarray(ref[k]), err_msg=k)
    assert any(p[0] == "inner" for p in cont.params)
    for path, p in cont.params.items():
        assert torch.equal(res.params[path], p), path


def test_passthrough_cli_on_an_original_run_is_refused(gpt2_dir, corpus, tmp_path):
    """ROADMAP C.16: a baseline run without target_tokenizer trains its
    tables on the source's byte-level conversion (1035 tokens, 1152 rows),
    while --method passthrough converts the target with whitespace made
    consistent (1164 tokens): JAX's CLI would slice 1152 rows for a
    1164-token tokenizer and write that model; the port's refuses by name
    and writes nothing."""
    from zett_tpu.transfer.baselines import passthrough_transfer
    from zett_tpu_torch.training.__main__ import run_training
    from zett_tpu_torch.transfer.baselines_cli import main as baselines_main

    cfg = _nshot_config(gpt2_dir, str(tmp_path / "run"), corpus, lexical_loss_weight=0.0,
                        steps=1)
    run_training(cfg, "original", device="cpu")
    final = tmp_path / "run" / "final"
    with np.load(final / "params.npz") as z:
        table = z["input_embeddings/embedding"]
    src = JaxTokenizer.from_file(os.path.join(gpt2_dir, "tokenizer.json"))
    jax_target, _ = jax_convert(src, match_special_tokens_to=jax_convert(src.copy())[0],
                                make_whitespace_consistent=True)
    rows, _ = passthrough_transfer({"input_embeddings": {"embedding": table}}, len(jax_target))
    assert (len(rows), len(jax_target), len(src)) == (1152, 1164, 1035)
    with pytest.raises(ValueError, match="C.16"):
        baselines_main(["--method", "passthrough", "--checkpoint", str(final), "--model",
                        gpt2_dir, "--target-tokenizer", gpt2_dir, "--output",
                        str(tmp_path / "model"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "model")


def test_bf16_tables_hold_the_compute_dtype():
    """ROADMAP C.17: in bf16 the passthrough tables are held in bf16, as
    JAX's state holds the source rows cast to the compute dtype, while the
    fine-tuned backbone is f32: at the baseline configs' learning rate 1e-6
    an update of a table element rounds away unless the element is tiny,
    on both sides, and nearly every backbone element moves. Losses within
    2% (bf16)."""
    jtr, ttr = _trainers("gpt2", False, dtype="bfloat16", learning_rate=1e-6)
    path = ("hypernet", "input_embeddings", "embedding")
    kernel = ("inner", "transformer", "h_0", "c_fc", "kernel")
    j0 = _f32(traverse_util.flatten_dict(jtr.state.params)[path]).copy()
    jk0 = _f32(traverse_util.flatten_dict(jtr.state.params)[kernel]).copy()
    t0 = _f32(ttr.params[path]).copy()
    tk0 = _f32(ttr.params[kernel]).copy()
    assert ttr.params[path].dtype == torch.bfloat16
    assert traverse_util.flatten_dict(jtr.state.params)[path].dtype == jnp.bfloat16
    assert ttr.params[kernel].dtype == torch.float32
    batch = _batch(13)
    jtr.state, jm = jtr.train_step(jtr.state, jtr._device_batch(batch))
    tm = ttr.train_step(batch)
    _close(tm["loss"], jm["loss"], 2e-2, "loss")
    jp = traverse_util.flatten_dict(jtr.state.params)
    for table_moved, kernel_moved in (
            ((_f32(jp[path]) != j0).mean(), (_f32(jp[kernel]) != jk0).mean()),
            ((_f32(ttr.params[path]) != t0).mean(), (_f32(ttr.params[kernel]) != tk0).mean())):
        assert table_moved < 0.05 and kernel_moved > 0.9, (table_moved, kernel_moved)


def test_fixed_tokenizer_past_the_source_table(llama_like_json, corpus, tmp_path, capsys):
    """ROADMAP C.14: a fixed tokenizer with more ids than the passthrough
    table's rows (the converted metaspace source: 2046 tokens over a model
    of 1920 rows) reads NaN rows in JAX, whose loss is NaN; the port pads
    the tables to the batch's ids with zero rows, says so naming C.14, and
    trains finite."""
    from safetensors.numpy import save_file

    from zett_tpu.training.__main__ import run_training as jax_run
    from zett_tpu_torch.training.__main__ import run_training

    vocab = 1920
    bb = dict(LLAMA, hidden_size=32, intermediate_size=64, num_hidden_layers=1)
    cfg = JaxLlamaConfig(vocab_size=vocab, **bb)
    params = JaxLlama(cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    sd = invert_llama(jax.tree_util.tree_map(np.asarray, params), cfg)
    model_dir = tmp_path / "llama"
    model_dir.mkdir()
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              str(model_dir / "model.safetensors"))
    with open(model_dir / "config.json", "w") as f:
        json.dump({"model_type": "llama", "vocab_size": vocab, **bb}, f)
    JaxTokenizer.from_json(llama_like_json).save(str(model_dir / "tokenizer.json"))
    run = _nshot_config(str(model_dir), "", corpus, lexical_loss_weight=0.0)
    _, jhist = jax_run(dict(run, output_dir=str(tmp_path / "jax")), "c14")
    assert all(np.isnan(h["loss"]) for h in jhist)
    capsys.readouterr()
    trainer, hist = run_training(dict(run, output_dir=str(tmp_path / "port")), "c14",
                                 device="cpu")
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "2048 rows" in capsys.readouterr().out.split("ROADMAP C.14")[0].splitlines()[-1]
    rows = trainer.hypernet.input_embeddings.weight.shape[0]
    assert rows == 2048 >= len(trainer.last_train_batch["target_surface_forms"])


def test_validation_text_under_a_fixed_tokenizer_fails_in_both(gpt2_dir, corpus, tmp_path):
    """ROADMAP C.15: a passthrough or baseline config (do_tokenizer_sampling
    false) with validation text builds its sampled-tokenizer validation
    Collator without a fixed tokenizer: JAX fails its assertion, the port
    raises its ValueError, both before any step."""
    from zett_tpu.training.__main__ import run_training as jax_run
    from zett_tpu_torch.training.__main__ import run_training

    run = _nshot_config(gpt2_dir, "", corpus, lexical_loss_weight=0.0,
                        valid_texts_by_lang={"en": [t for t in corpus if t.strip()][96:128]})
    with pytest.raises(AssertionError):
        jax_run(dict(run, output_dir=str(tmp_path / "jax")), "c15")
    with pytest.raises(ValueError, match="fixed tokenizer"):
        run_training(dict(run, output_dir=str(tmp_path / "port")), "c15", device="cpu")
