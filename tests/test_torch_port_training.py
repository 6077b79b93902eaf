"""The port's training path (zett_tpu_torch/training, the GPT-2 backbone and
the hypernet's training route) held against the JAX package on the CPU:
losses, the LR schedule, one optimizer update, the hypernet's training-route
gradients, and whole train/identity steps from JAX-initialised parameters
moved by flax_to_torch (hypernet) and invert_gpt2 (backbone). Also the
training CLI end to end with --device cpu, its final/ read by the port's
transfer CLI."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax import traverse_util

from zett_tpu.models import Hypernet as JaxHypernet
from zett_tpu.models import HypernetConfig as JaxHnConfig
from zett_tpu.models.backbones.gpt2 import GPT2Config as JaxGPT2Config
from zett_tpu.models.backbones.gpt2 import GPT2LMHeadModel as JaxGPT2
from zett_tpu.models.backbones.loader import invert_gpt2
from zett_tpu.training import Trainer as JaxTrainer
from zett_tpu.training import TrainingConfig as JaxTrainingConfig
from zett_tpu.training.losses import lexical_loss as jax_lexical_loss
from zett_tpu.training.losses import lm_loss as jax_lm_loss
from zett_tpu.training.optimizer import build_optimizer, get_labels
from zett_tpu.training.schedules import create_learning_rate_fn as jax_lr_fn
from zett_tpu.training.state import TrainState as JaxTrainState
from zett_tpu_torch.models import Hypernet, HypernetConfig
from zett_tpu_torch.models.backbones.gpt2 import GPT2Config
from zett_tpu_torch.models.convert import flax_paths, flax_to_torch
from zett_tpu_torch.training import Trainer, TrainingConfig
from zett_tpu_torch.training.losses import lexical_loss, lm_loss
from zett_tpu_torch.training.optimizer import AdamW
from zett_tpu_torch.training.schedules import create_learning_rate_fn

HN = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
          max_position_embeddings=8, n_embd=64, hn_surface_maxlen=4,
          embed_using_source_embeddings=True, n_extra_tokens=16, rescale_embeddings=True,
          predict_bias=True, hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
V_BATCH, VOCAB = 64, 300


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel, what="", floor=1e-12):
    """max |got - want| <= rel x max(largest |want|, floor)."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


# ---------------------------------------------------------------------- losses
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mse", "rmse", "huber"])
def test_lexical_loss_matches_jax(kind, dtype):
    """f32 within 1e-6 relative; bf16 (every op rounded in bf16 on both
    sides, sums in another order) within 2%."""
    rng = np.random.default_rng(0)
    pred, target = (rng.normal(size=(50, 32)).astype(np.float32) * 0.02 for _ in range(2))
    pred[:10] = target[:10] + 1e-4 * rng.normal(size=(10, 32))  # inside huber's delta
    overlap = rng.random(50) > 0.4
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = jax_lexical_loss(jnp.asarray(pred, jdt), None, jnp.asarray(target, jdt), None,
                            jnp.asarray(overlap), kind)
    got = lexical_loss(torch.from_numpy(pred).to(tdt), None, torch.from_numpy(target).to(tdt),
                       None, torch.from_numpy(overlap), kind)
    _close(got, want, 1e-6 if dtype == "float32" else 2e-2, kind)


def test_lm_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 9, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, size=(3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) > 0.2).astype(np.int32)
    want = jax_lm_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), "clm")
    got = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                  torch.from_numpy(mask), "clm")
    _close(got, want, 1e-6)
    # the MLM loss: labelled (not -100) and attended positions, no shift
    labels[rng.random((3, 9)) > 0.3] = -100
    want = jax_lm_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), "mlm")
    got = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                  torch.from_numpy(mask), "mlm")
    _close(got, want, 1e-6)


@pytest.mark.parametrize("kw", [
    dict(steps=100, warmup_steps=[10, 20], random_warmup_steps=0, learning_rate=[3e-4, 6e-5]),
    dict(steps=50, warmup_steps=7, random_warmup_steps=3, learning_rate=1e-3,
         random_learning_rate=2e-3),
])
def test_schedule_matches_optax(kw):
    """Both schedules of every step, within 2 f32 ulps (cos is computed by
    numpy here and by XLA there)."""
    jr, jp = jax_lr_fn(JaxTrainingConfig(**kw))
    tr, tp = create_learning_rate_fn(TrainingConfig(**kw))
    for s in range(kw["steps"] + 5):
        for j, t in ((jr, tr), (jp, tp)):
            want = float(j(jnp.int32(s)))
            assert abs(float(t(s)) - want) <= 2.4e-7 * abs(want), (s, float(t(s)), want)


# ------------------------------------------------------------------- optimizer
def _opt_tree(rng):
    """A params tree with every kind of leaf the labels and the decay mask
    tell apart; the frozen backbone in bf16."""
    def a(*shape, dtype=np.float32):
        return rng.normal(size=shape).astype(dtype)

    return {
        "hypernet": {
            "encoder": {"embeddings_ln": {"scale": a(8), "bias": a(8)},
                        "layer_0": {"attention": {"query": {"kernel": a(8, 8), "bias": a(8)}}},
                        "position_embeddings": a(4, 8)},
            "output_projection": {"layers_0": {"ln": {"scale": a(8), "bias": a(8)}}},
            "in_scaler": {"w": a(1, 8), "b": a(1, 8)},
            "scaler": {"w": a(1, 8), "b": a(1, 8)},
        },
        "inner": {"transformer": {"h_0": {"ln_1": {"scale": a(8)},
                                          "attn": {"c_attn": {"kernel": a(8, 24)}}},
                                  "wpe": {"embedding": a(4, 8)}}},
    }


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw_matches_optax(accum):
    """Four micro steps of gradients (clip binding, frozen rescalers and
    backbone, decay mask, k-step accumulation) give the same params as
    build_optimizer + optax.apply_updates: f32 within 1e-6 relative, frozen
    leaves bitwise unchanged."""
    rng = np.random.default_rng(2)
    tree = _opt_tree(rng)
    tree["inner"] = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), tree["inner"])
    kw = dict(steps=10, learning_rate=1e-2, warmup_steps=2, weight_decay=0.1,
              max_grad_norm=0.5, adam_beta2=0.95, gradient_accumulation_steps=accum)
    jcfg, tcfg = JaxTrainingConfig(**kw), TrainingConfig(**kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = build_optimizer(jcfg, jax_lr_fn(jcfg)[0], get_labels(jparams))
    opt_state = tx.init(jparams)
    flat = traverse_util.flatten_dict(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)) for k, v in flat.items()}
    opt = AdamW(tparams, tcfg, create_learning_rate_fn(tcfg)[0])
    for step in range(4):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in flat.items()}
        jgrads = traverse_util.unflatten_dict(
            {k: jnp.asarray(g, flat[k].dtype) for k, g in grads.items()})
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step({k: torch.from_numpy(g).to(tparams[k].dtype) for k, g in grads.items()})
    for k, v in traverse_util.flatten_dict(jparams).items():
        if k[0] == "inner" or k[1] in ("scaler", "in_scaler"):
            assert np.array_equal(_f32(tparams[k]), _f32(flat[k])), k
            assert np.array_equal(_f32(v), _f32(flat[k])), k
        else:
            _close(tparams[k], v, 1e-6, k)
            assert not np.array_equal(_f32(v), _f32(flat[k])), k


# ------------------------------------------------------------- hypernet grads
def test_hypernet_training_route_gradients_match_jax():
    """The training route (inference=False: torch projections around
    merged_attention_train's plain forward and hand-written backward) gives
    JAX's loss and every parameter gradient, f32, within 1e-5 of each
    leaf's largest gradient (or of 1% of the model's largest, for leaves
    whose exact gradient is 0, such as the key biases)."""
    from test_torch_port_hypernet import _inputs, _params

    cfg = dict(HN, hn_surface_maxlen=7, original_vocab_size=300)
    sf, src = _inputs()
    jmodel = JaxHypernet(JaxHnConfig(**cfg))
    flat = _params(jmodel, sf, src)
    rng = np.random.default_rng(3)
    w_in = rng.normal(size=(len(sf), 64)).astype(np.float32)
    w_b = rng.normal(size=len(sf)).astype(np.float32)

    def jloss(params):
        e, _, b = jmodel.apply({"params": params}, jnp.asarray(sf), None, jnp.asarray(src), 0,
                               deterministic=True, inference=False)
        return (e * w_in).sum() + (b * w_b).sum()

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(traverse_util.unflatten_dict(flat, sep="/"))
    jgrads = traverse_util.flatten_dict(jgrads, sep="/")
    model = Hypernet(HypernetConfig(**cfg))
    model.load_state_dict(flax_to_torch({k: np.asarray(v) for k, v in flat.items()}))
    e, _, b = model(torch.from_numpy(sf).long(), None, torch.from_numpy(src), 0,
                    deterministic=True, inference=False)
    got = (e * torch.from_numpy(w_in)).sum() + (b * torch.from_numpy(w_b)).sum()
    got.backward()
    _close(got, want, 1e-5)
    floor = 1e-2 * max(float(np.abs(_f32(g)).max()) for g in jgrads.values())
    for name, (path, transpose) in flax_paths(model).items():
        g = dict(model.named_parameters())[name].grad
        _close(g.t() if transpose else g, jgrads["/".join(path)], 1e-5, name, floor)


def test_hypernet_training_route_dropout_is_seeded():
    """With dropout on (deterministic=False), the training route draws every
    mask and kernel seed from the generator it is given: the same generator
    state gives the same output, another state another, gradients flow."""
    from test_torch_port_hypernet import _inputs

    cfg = dict(HN, hn_surface_maxlen=7, original_vocab_size=300,
               hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    sf, src = _inputs()
    model = Hypernet(HypernetConfig(**cfg))
    model.init_weights(torch.Generator().manual_seed(0))
    args = (torch.from_numpy(sf).long(), None, torch.from_numpy(src), 0)

    def run(seed):
        return model(*args, deterministic=False, inference=False,
                     generator=torch.Generator().manual_seed(seed))[0]

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        plain = model(*args, deterministic=True, inference=False)[0]
    assert not torch.equal(a, plain)
    a.sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    with pytest.raises(ValueError, match="generator"):
        model(*args, deterministic=False, inference=False)


# ---------------------------------------------------------------- train steps
def _batch(seed):
    rng = np.random.default_rng(seed)
    B, L, M = 3, 12, HN["hn_surface_maxlen"]
    sf = rng.integers(1, VOCAB + 16, size=(V_BATCH, M)).astype(np.int32)
    lens = rng.integers(1, M + 1, size=V_BATCH)
    sf[np.arange(M)[None] >= lens[:, None]] = 0
    sf[7] = 0  # all-padding surface form
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
        "ids_to_embed": rng.permutation(VOCAB)[:V_BATCH].astype(np.int32),
        "special_indices": np.array([0, 5]),
        "special_indices_in_reference": np.array([0, 3]),
        "lang_index": np.array(0),
    }


def _trainers(dtype):
    """A JAX Trainer and a port Trainer from the same parameters."""
    bb_cfg = JaxGPT2Config(vocab_size=VOCAB, n_positions=32, n_embd=64, n_layer=2, n_head=2)
    bb_params = JaxGPT2(bb_cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    kw = dict(steps=6, learning_rate=1e-3, warmup_steps=1, lexical_loss_weight=0.5,
              lexical_loss_kind="huber", max_grad_norm=0.05, weight_decay=0.01,
              adam_beta2=0.95, identity_steps=1, logging_steps=10, save_steps=0,
              eval_steps=0, dtype=dtype)
    jtr = JaxTrainer(hn_config=JaxHnConfig(**HN), backbone_config=bb_cfg,
                     backbone_params=bb_params, model_type="gpt2",
                     train_config=JaxTrainingConfig(**kw), vocab_batch_size=V_BATCH)
    hn_params = {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in
                 traverse_util.flatten_dict(jtr.state.params["hypernet"], sep="/").items()}
    sd = invert_gpt2(jax.tree_util.tree_map(np.asarray, bb_params), bb_cfg)
    ttr = Trainer(hn_config=HypernetConfig(**HN),
                  backbone_config=GPT2Config(vocab_size=VOCAB, n_positions=32, n_embd=64,
                                             n_layer=2, n_head=2),
                  backbone_state={k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                  model_type="gpt2", train_config=TrainingConfig(**kw), device="cpu",
                  hn_params=hn_params)
    return jtr, ttr


def _torch_grads_by_path(ttr):
    """The port's last gradients in the Flax layout (kernels transposed)."""
    transposed = {("hypernet",) + path for path, t in flax_paths(ttr.hypernet).values() if t}
    out = {}
    for path, g in ttr.last_grads.items():
        if g is None:
            g = torch.zeros_like(ttr.params[path])
        out[path] = g.t() if path in transposed else g
    return out


def _adam_carried_differences(jax_grads, port_grads, lrs, cfg):
    """Per element, how far AdamW can carry the measured gradient
    differences into the parameters (f64, from each step's raw gradients
    on both sides). Step t moves an element by lr_t * m_hat / (sqrt(v_hat)
    + eps) of the clipped gradients; to first order a difference d_s in the
    clipped gradient of a step s <= t changes that move by at most
    3 lr_t d_s / (sqrt(v_hat_t) + eps) (the derivative's two terms are
    bounded by the moments' weights, 1 and about 1.1 at these betas), and
    stays in the moments of every later step."""
    def clip_scale(grads):
        norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64))) for g in grads))
        return min(1.0, cfg.max_grad_norm / norm)

    out = {}
    scales = [(clip_scale(j.values()), clip_scale(p.values()))
              for j, p in zip(jax_grads, port_grads)]
    for path in jax_grads[0]:
        nu = diff = total = 0.0
        for t, (j, p) in enumerate(zip(jax_grads, port_grads)):
            cj, cp = scales[t]
            gj = cj * np.asarray(j[path], np.float64)
            diff = diff + np.abs(cp * p[path].astype(np.float64) - gj)
            nu = cfg.adam_beta2 * nu + (1 - cfg.adam_beta2) * gj * gj
            nu_hat = nu / (1 - cfg.adam_beta2 ** (t + 1))
            total = total + 3 * lrs[t] * diff / (np.sqrt(nu_hat) + cfg.adam_epsilon)
        out[path] = total
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_and_identity_steps_match_jax(dtype, monkeypatch):
    """An identity step then two train steps (lexical huber loss, source
    special-token splice, clip binding) from the same parameters and
    batches. f32: losses within 1e-5 relative; every step's gradients
    within 1e-4 of each leaf's largest or of 1% of the model's largest (the
    frozen bf16 backbone's within 2 bf16 ulps); parameters after the steps
    within 1e-5 of each leaf's scale plus 1e-4 x the summed learning rates
    plus, element by element, what AdamW carries of the measured gradient
    differences (``_adam_carried_differences``). bf16 (XLA rounds
    every bf16 op, the port rounds fused gelu/LayerNorm once): losses within
    2%, parameters within 2 x the summed learning rates (an update whose
    gradient sits at bf16 rounding noise can flip sign). Frozen leaves are
    bitwise unchanged on both sides."""
    captured = []
    orig = JaxTrainState.apply_gradients

    def capture(self, *, grads, **kw):
        jax.debug.callback(captured.append, grads)
        return orig(self, grads=grads, **kw)

    monkeypatch.setattr(JaxTrainState, "apply_gradients", capture)
    jtr, ttr = _trainers(dtype)
    f32 = dtype == "float32"
    rel_loss = 1e-5 if f32 else 2e-2
    start = {k: _f32(p).copy() for k, p in ttr.params.items()}
    steps = [("identity", _batch(10)), ("train", _batch(11)), ("train", _batch(12))]
    lr_sum = 0.0
    lrs, port_grads = [], []
    for kind, batch in steps:
        if kind == "identity":
            jtr.state, jm = jtr.identity_train_step(jtr.state, jtr._device_batch(batch))
            tm = ttr.identity_train_step(batch)
            _close(tm["identity_loss"], jm["identity_loss"], rel_loss, kind)
        else:
            jtr.state, jm = jtr.train_step(jtr.state, jtr._device_batch(batch))
            tm = ttr.train_step(batch)
            for key in ("loss", "lexical_loss", "mean_lexical_overlap"):
                _close(tm[key], jm[key], rel_loss, key)
        _close(tm["learning_rate"], jm["learning_rate"], 1e-7)
        lr_sum += tm["learning_rate"]
        lrs.append(tm["learning_rate"])
        port_grads.append({p: _f32(g).copy() for p, g in _torch_grads_by_path(ttr).items()})
    jparams = traverse_util.flatten_dict(jtr.state.params)
    assert all(float(optax.global_norm(g)) > 0.05 for g in captured)  # the clip binds
    if f32:
        jax_grads = [traverse_util.flatten_dict(g) for g in captured]
        assert len(jax_grads) == len(port_grads) == len(steps)
        for (kind, _), jgrads, tgrads in zip(steps, jax_grads, port_grads):
            assert set(jgrads) == set(tgrads)
            floor = 1e-2 * max(float(np.abs(_f32(g)).max()) for g in jgrads.values())
            for path, g in jgrads.items():
                _close(tgrads[path], g, 1e-4 if path[0] == "hypernet" else 2 ** -7,
                       (kind, path), floor)
        carried = _adam_carried_differences(jax_grads, port_grads, lrs, ttr.cfg)
    transposed = {("hypernet",) + p for p, t in flax_paths(ttr.hypernet).values() if t}
    for path, want in jparams.items():
        got = ttr.params[path]
        got = got.t() if path in transposed else got
        frozen = path[0] == "inner" or path[1] in ("scaler", "in_scaler")
        if frozen:
            assert np.array_equal(_f32(ttr.params[path]), start[path]), path
        if path[-2:] == ("key", "bias"):
            # its exact gradient is 0 (the softmax ignores a per-query
            # constant), so both sides update it from rounding noise
            continue
        # Adam moves each element by about the learning rate whatever its
        # gradient's size: an element whose gradient is rounding noise
        # differs by a share of the summed learning rates, and in f32 by what
        # Adam makes of the measured gradient differences
        floor = (1e-4 if f32 else 2.0) * lr_sum
        if f32:
            floor = floor + carried[path]
        err = np.abs(_f32(got) - _f32(want))
        assert (err <= 1e-5 * np.abs(_f32(want)).max() + floor).all(), (path, err.max())


# ------------------------------------------------------------------------ CLI
@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, gpt2_like_json):
    """A tiny HF GPT-2 directory written by the JAX package's tools."""
    from safetensors.numpy import save_file

    from zett_tpu.tokenization import Tokenizer as JaxTokenizer

    path = tmp_path_factory.mktemp("gpt2_port_cli")
    tok = JaxTokenizer.from_json(gpt2_like_json)
    cfg = JaxGPT2Config(vocab_size=len(tok), n_positions=64, n_embd=64, n_layer=1, n_head=1)
    params = JaxGPT2(cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    sd = invert_gpt2(jax.tree_util.tree_map(np.asarray, params), cfg)
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              str(path / "model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": len(tok), "n_positions": 64,
                   "n_embd": 64, "n_layer": 1, "n_head": 1, "layer_norm_epsilon": 1e-5,
                   "tie_word_embeddings": True}, f)
    tok.save(str(path / "tokenizer.json"))
    return str(path)


def _cli_config(model_dir, out_dir, corpus):
    return {
        "model_dir": model_dir, "output_dir": out_dir,
        "texts_by_lang": {"en": [t for t in corpus if t.strip()][:96]},
        "langs": ["en"], "steps": 3, "warmup_steps": 1, "identity_steps": 1,
        "identity_n_subsample": 128, "logging_steps": 1, "save_steps": 0, "eval_steps": 0,
        "batch_size": 4, "block_size": 16, "n_token_subsample": None, "pad_to_multiple_of": 64,
        "tokenizer_sample_mean": 256, "tokenizer_sample_std": 0, "tokenizer_sample_min": 256,
        "tokenizer_sample_max": 512, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 1, "max_position_embeddings": 8,
        "hn_surface_maxlen": 4, "embed_using_source_embeddings": True, "n_extra_tokens": 8,
        "rescale_embeddings": True, "lexical_loss_weight": 0.5, "lexical_loss_kind": "huber",
        "hidden_dropout_prob": 0.0, "attention_dropout_prob": 0.0, "n_initial_texts": 16,
    }


def test_training_cli_on_cpu_writes_a_transferable_checkpoint(model_dir, corpus, tmp_path):
    from zett_tpu_torch.training.__main__ import main
    from zett_tpu_torch.transfer.__main__ import main as transfer_main

    out = tmp_path / "run"
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_cli_config(model_dir, str(out), corpus)))
    trainer, history = main([str(cfg_path), "--device", "cpu"])
    assert [h["step"] for h in history] == [1, 2, 3]
    assert "identity_loss" in history[0] and "loss" in history[1]
    assert all(np.isfinite(v) for h in history for v in h.values())
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3 and json.loads(lines[-1])["step"] == 3
    for name in ("hn_config.json", "params.npz", "tokenizer.json"):
        assert (out / "final" / name).exists()
    transfer_main(["--checkpoint", str(out / "final"), "--model", model_dir,
                   "--target-tokenizer", str(out / "final"), "--output", str(tmp_path / "t"),
                   "--device", "cpu", "--batch-size", "256"])
    assert (tmp_path / "t" / "model.safetensors").exists()


def test_training_cli_without_device_flag_needs_the_card(model_dir, corpus, tmp_path):
    from zett_tpu_torch.training.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_cli_config(model_dir, str(tmp_path / "run"), corpus)))
    with pytest.raises(RuntimeError, match="CUDA"):
        main([str(cfg_path)])
    assert not os.path.exists(tmp_path / "run")
