"""The trainer's memory and resume levers of the port (zett_tpu_torch/training)
held against the JAX package and against the port's own plain trainer on the
CPU: the chunked CLM loss and eval, remat of the hypernet and of the backbone
blocks (with dropout on), Adafactor against optax, full-state checkpoints
with replay resume, preemption by a real signal, the batch prefetcher, and
the training CLI's resume_from_checkpoint."""

import importlib
import json
import os
import signal
import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax import traverse_util

from zett_tpu.models import HypernetConfig as JaxHnConfig
from zett_tpu.models.backbones.gpt2 import GPT2Config as JaxGPT2Config
from zett_tpu.models.backbones.gpt2 import GPT2LMHeadModel as JaxGPT2
from zett_tpu.models.backbones.loader import invert_gpt2
from zett_tpu.training import Trainer as JaxTrainer
from zett_tpu.training import TrainingConfig as JaxTrainingConfig
from zett_tpu.training.losses import chunked_clm_eval as jax_chunked_clm_eval
from zett_tpu.training.losses import chunked_clm_loss as jax_chunked_clm_loss
from zett_tpu.training.optimizer import build_optimizer as jax_build_optimizer
from zett_tpu.training.optimizer import get_labels
from zett_tpu.training.schedules import create_learning_rate_fn as jax_lr_fn
from zett_tpu_torch.models import HypernetConfig
from zett_tpu_torch.models.backbones.gpt2 import GPT2Config
from zett_tpu_torch.training import Trainer, TrainingConfig
from zett_tpu_torch.training.losses import chunked_clm_eval, chunked_clm_loss, lm_loss
from zett_tpu_torch.training.optimizer import Adafactor
from zett_tpu_torch.training.prefetch import BatchPrefetcher
from zett_tpu_torch.training.schedules import create_learning_rate_fn
from test_torch_port_training import (HN, V_BATCH, VOCAB, _batch, _cli_config, _close, _f32,
                                     model_dir)  # noqa: F401 (a fixture)

# the module (the ops package exports its function of the same name)
core_mod = importlib.import_module("zett_tpu_torch.ops.attention_core")
HN_DROPOUT = dict(HN, hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
TRAIN_KW = dict(learning_rate=1e-3, warmup_steps=1, lexical_loss_weight=0.5,
                lexical_loss_kind="huber", max_grad_norm=0.05, weight_decay=0.01,
                adam_beta2=0.95, logging_steps=1, save_steps=0, eval_steps=0)


# ---------------------------------------------------------------- the losses
def _loss_inputs(seed, B=3, L=12, H=16, V=40):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, L, H)).astype(np.float32)
    head_w = rng.normal(size=(V, H)).astype(np.float32) * 0.5
    offset = np.where(rng.random(V) > 0.1, 0.0, -100_000.0).astype(np.float32)
    offset += rng.normal(size=V).astype(np.float32) * 0.1
    labels = rng.integers(0, V, size=(B, L)).astype(np.int32)
    labels[0, 3] = -100
    mask = np.ones((B, L), np.int32)
    mask[1, 8:] = 0
    byte_lengths = rng.integers(1, 6, size=(B, L)).astype(np.int32)
    byte_lengths[2] = 0  # a padded eval row: no bytes
    mask[2] = 0
    return hidden, head_w, offset, labels, mask, byte_lengths


# L - 1 = 11: chunks of 1 and 11 divide it, 4 and 5 pad
@pytest.mark.parametrize("chunk", [1, 4, 5, 11])
def test_chunked_clm_loss_matches_jax_and_lm_loss(chunk):
    """The loss within 1e-6 relative of JAX's chunked_clm_loss and of the
    port's lm_loss on the whole logits (f32, as the JAX test holds it); the
    gradients into hidden and head_w within 1e-5 of the largest of each."""
    hidden, head_w, offset, labels, mask, _ = _loss_inputs(chunk)

    def jfn(h, w):
        return jax_chunked_clm_loss(h, w, jnp.asarray(offset), jnp.asarray(labels),
                                    jnp.asarray(mask), chunk)

    want, (jg_h, jg_w) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(hidden),
                                                                 jnp.asarray(head_w))
    t_h = torch.from_numpy(hidden).requires_grad_()
    t_w = torch.from_numpy(head_w).requires_grad_()
    got = chunked_clm_loss(t_h, t_w, torch.from_numpy(offset), torch.from_numpy(labels),
                           torch.from_numpy(mask), chunk)
    got.backward()
    _close(got, want, 1e-6, "loss vs JAX")
    _close(t_h.grad, jg_h, 1e-5, "d hidden vs JAX")
    _close(t_w.grad, jg_w, 1e-5, "d head_w vs JAX")

    p_h = torch.from_numpy(hidden).requires_grad_()
    p_w = torch.from_numpy(head_w).requires_grad_()
    logits = p_h @ p_w.t() + torch.from_numpy(offset)[None, None]
    plain = lm_loss(logits, torch.from_numpy(labels), torch.from_numpy(mask), "clm")
    plain.backward()
    _close(got, plain, 1e-6, "loss vs lm_loss")
    _close(t_h.grad, p_h.grad, 1e-5, "d hidden vs lm_loss")
    _close(t_w.grad, p_w.grad, 1e-5, "d head_w vs lm_loss")


@pytest.mark.parametrize("chunk", [1, 4, 5, 11])
def test_chunked_clm_eval_matches_jax_and_lm_loss(chunk):
    """(loss, bits-per-byte term) within 1e-6 relative of JAX's
    chunked_clm_eval and of lm_loss(..., with_bpb=True) on the whole
    logits, with a padded row of no bytes."""
    hidden, head_w, offset, labels, mask, byte_lengths = _loss_inputs(10 + chunk)
    want = jax_chunked_clm_eval(jnp.asarray(hidden), jnp.asarray(head_w), jnp.asarray(offset),
                                jnp.asarray(labels), jnp.asarray(mask),
                                jnp.asarray(byte_lengths), chunk)
    args = [torch.from_numpy(x) for x in (hidden, head_w, offset, labels, mask, byte_lengths)]
    got = chunked_clm_eval(*args, chunk)
    logits = args[0] @ args[1].t() + args[2][None, None]
    plain = lm_loss(logits, args[3], args[4], "clm", byte_lengths=args[5], with_bpb=True)
    for i, what in enumerate(("loss", "bpb")):
        _close(got[i], want[i], 1e-6, what + " vs JAX")
        _close(got[i], plain[i], 1e-6, what + " vs lm_loss")


# ------------------------------------------------------------- tiny trainers
BB = dict(vocab_size=VOCAB, n_positions=32, n_embd=64, n_layer=2, n_head=2)


@pytest.fixture(scope="module")
def backbone():
    """A tiny GPT-2 from JAX's init: (JAX params, HF state dict)."""
    params = JaxGPT2(JaxGPT2Config(**BB)).init(jax.random.PRNGKey(0),
                                              jnp.ones((1, 4), jnp.int32))["params"]
    sd = invert_gpt2(jax.tree_util.tree_map(np.asarray, params), JaxGPT2Config(**BB))
    return params, sd


def _port_trainer(backbone, hn=HN_DROPOUT, **kw):
    cfg = dict(TRAIN_KW, steps=5, run_backbone_in_training_mode=True)
    cfg.update(kw)
    return Trainer(hn_config=HypernetConfig(**hn), backbone_config=GPT2Config(**BB),
                   backbone_state={k: torch.from_numpy(np.array(v))
                                   for k, v in backbone[1].items()},
                   model_type="gpt2", train_config=TrainingConfig(**cfg), device="cpu")


def _hn_grads(trainer):
    return {p: g.clone() for p, g in trainer.last_grads.items()
            if p[0] == "hypernet" and g is not None}


@pytest.mark.parametrize("lever", [dict(remat_hypernet=True), dict(remat_backbone=True),
                                   dict(loss_chunk_size=4),
                                   dict(remat_hypernet=True, remat_backbone=True,
                                        loss_chunk_size=5),
                                   dict(remat_hypernet_glue=True),
                                   dict(remat_hypernet=True, remat_hypernet_glue=True)],
                         ids=["remat_hypernet", "remat_backbone", "chunked", "all", "glue",
                              "remat_hypernet_glue"])
def test_levers_match_the_plain_trainer_with_dropout_on(backbone, lever, monkeypatch):
    """Three train steps with hidden and attention dropout at 0.1
    (run_backbone_in_training_mode): remat alone, and the glue's op-by-op
    remat with or without it, gives the plain trainer's losses, gradients
    and parameters bit for bit (the recomputed forward draws the same
    dropout seeds); with the chunked loss, losses within
    1e-6 relative and gradients within 1e-5 of each leaf's largest (or of
    1% of the model's largest, for leaves whose exact gradient is 0). Under
    remat_hypernet the attention core's forward (kernel 2 on the card) runs
    twice a train step for each layer, its backward once."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = core_mod.attention_core, core_mod.attention_core_bwd

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    plain, levered = _port_trainer(backbone), _port_trainer(backbone, **lever)
    exact = "loss_chunk_size" not in lever
    n_layers = HN["num_hidden_layers"]
    for i in range(3):
        batch = _batch(20 + i)
        mp = plain.train_step(batch)
        monkeypatch.setattr(core_mod, "attention_core", count_fwd)
        monkeypatch.setattr(core_mod, "attention_core_bwd", count_bwd)
        calls.update(fwd=0, bwd=0)
        ml = levered.train_step(batch)
        monkeypatch.setattr(core_mod, "attention_core", fwd)
        monkeypatch.setattr(core_mod, "attention_core_bwd", bwd)
        assert calls == {"fwd": n_layers * (2 if lever.get("remat_hypernet") else 1),
                         "bwd": n_layers}, calls
        g_plain, g_lever = _hn_grads(plain), _hn_grads(levered)
        assert set(g_plain) == set(g_lever)
        if exact:
            assert ml == mp, (i, ml, mp)
            for p in g_plain:
                assert torch.equal(g_plain[p], g_lever[p]), p
        else:
            for key in ("loss", "lexical_loss"):
                _close(ml[key], mp[key], 1e-6, key)
            # leaves whose exact gradient is 0 (the key biases) against 1%
            # of the model's largest
            floor = 1e-2 * max(float(g.abs().max()) for g in g_plain.values())
            for p in g_plain:
                _close(g_lever[p], g_plain[p], 1e-5, p, floor)
    assert torch.equal(plain.state.dropout_generator.get_state(),
                       levered.state.dropout_generator.get_state())
    if exact:
        for p in plain.params:
            assert torch.equal(plain.params[p], levered.params[p]), p


def _jax_trainer(backbone, **kw):
    cfg = dict(TRAIN_KW, steps=5)
    cfg.update(kw)
    return JaxTrainer(hn_config=JaxHnConfig(**HN), backbone_config=JaxGPT2Config(**BB),
                      backbone_params=backbone[0], model_type="gpt2",
                      train_config=JaxTrainingConfig(**cfg), vocab_batch_size=V_BATCH)


@pytest.mark.parametrize("use_adafactor", [False, True], ids=["adamw", "adafactor"])
def test_levered_train_and_eval_steps_match_jax(backbone, use_adafactor):
    """The port and the JAX trainer from the same parameters with every
    lever on (remat of both, chunks of 5 positions that pad L - 1 = 11):
    three train steps' losses within 1e-5 relative (f32), then the chunked
    eval step and the cached-embedding eval within 1e-5."""
    kw = dict(remat_hypernet=True, remat_backbone=True, loss_chunk_size=5,
              use_adafactor=use_adafactor, learning_rate=1e-2)
    jtr = _jax_trainer(backbone, **kw)
    hn_params = {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in
                 traverse_util.flatten_dict(jtr.state.params["hypernet"], sep="/").items()}
    ttr = Trainer(hn_config=HypernetConfig(**HN), backbone_config=GPT2Config(**BB),
                  backbone_state={k: torch.from_numpy(np.array(v))
                                  for k, v in backbone[1].items()},
                  model_type="gpt2", train_config=TrainingConfig(**dict(TRAIN_KW, steps=5, **kw)),
                  device="cpu", hn_params=hn_params)
    for i in range(3):
        batch = _batch(30 + i)
        jtr.state, jm = jtr.train_step(jtr.state, jtr._device_batch(batch))
        tm = ttr.train_step(batch)
        for key in ("loss", "lexical_loss"):
            _close(tm[key], jm[key], 1e-5, (i, key))
    batch = dict(_batch(40), byte_lengths=np.random.default_rng(40).integers(
        1, 6, size=(3, 12)).astype(np.int32))
    jm = jtr.eval_step(jtr.state, jtr._device_batch(batch))
    b = ttr._device_batch(batch)
    tm = ttr.eval_step(b)
    cached = ttr.eval_step_cached(b, *ttr.compute_embeddings(b))
    for key in ("eval_loss", "eval_bpb"):
        _close(tm[key], jm[key], 1e-5, key)
        assert float(cached[key]) == float(tm[key]), key


# ------------------------------------------------------------------ Adafactor
def _adafactor_tree(rng):
    """Leaves Adafactor tells apart: factored kernels (square, wide, tall,
    three axes), unfactored ones (an axis under 128, rank 1), norm and bias
    leaves out of the decay mask, frozen rescalers, a frozen bf16 backbone."""
    def a(*shape, scale=0.05):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {
        "hypernet": {
            "encoder": {"embeddings_ln": {"scale": a(128) + 1, "bias": a(128)},
                        "layer_0": {"attention": {"query": {"kernel": a(128, 128),
                                                            "bias": a(128)}},
                                    "intermediate": {"kernel": a(128, 256)},
                                    "output": {"kernel": a(256, 130)}},
                        "position_embeddings": a(8, 128),
                        "tiny": {"kernel": a(3, 4) * 1e-3}},
            "output_projection": {"layers_1": {"kernel": a(2, 129, 128)}},
            "in_scaler": {"w": a(1, 128), "b": a(1, 128)},
        },
        # small: a bf16 sum of squares over many elements rounds by a bf16
        # ulp in another order on the two sides, which moves the global
        # clip's scale and, through the second moments, every update
        "inner": {"transformer": {"h_0": {"attn": {"c_attn": {"kernel": a(8, 24)}}}}},
    }


@pytest.mark.parametrize("accum", [1, 2])
def test_adafactor_matches_optax(accum):
    """Six micro steps of gradients through build_optimizer(use_adafactor)
    + optax.apply_updates against the port's Adafactor: the global clip
    binding over every leaf (frozen ones included), the decay mask, frozen
    labels and k-step accumulation; one Dense kernel held transposed as
    the hypernet's nn.Linear weights are. Trained leaves within 1e-5 of
    their scale plus 1e-6 (f32: optax and torch reduce the row and column
    means in another order), frozen leaves bitwise unchanged, and the
    factored state in the Flax layout."""
    rng = np.random.default_rng(7)
    tree = _adafactor_tree(rng)
    tree["inner"] = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), tree["inner"])
    kw = dict(steps=10, learning_rate=5e-2, warmup_steps=2, weight_decay=0.1,
              max_grad_norm=0.5, use_adafactor=True, gradient_accumulation_steps=accum)
    jcfg, tcfg = JaxTrainingConfig(**kw), TrainingConfig(**kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = jax_build_optimizer(jcfg, jax_lr_fn(jcfg)[0], get_labels(jparams))
    opt_state = tx.init(jparams)
    flat = traverse_util.flatten_dict(jparams)
    flipped = ("hypernet", "encoder", "layer_0", "attention", "query", "kernel")

    def to_torch(k, v):
        t = torch.from_numpy(np.array(v, np.float32)).to(
            torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        return t.t().contiguous() if k == flipped else t

    tparams = {k: torch.nn.Parameter(to_torch(k, v)) for k, v in flat.items()}
    opt = Adafactor(tparams, tcfg, create_learning_rate_fn(tcfg)[0], transposed=[flipped])
    for step in range(6):
        grads = {k: (rng.normal(size=v.shape) * 0.1).astype(np.float32) for k, v in flat.items()}
        jgrads = traverse_util.unflatten_dict(
            {k: jnp.asarray(g, flat[k].dtype) for k, g in grads.items()})
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step({k: to_torch(k, jnp.asarray(g, flat[k].dtype)) for k, g in grads.items()})
    assert opt.count == 6 // accum
    for k, v in traverse_util.flatten_dict(jparams).items():
        got = tparams[k].t() if k == flipped else tparams[k]
        if k[0] == "inner" or k[1] == "in_scaler":
            assert np.array_equal(_f32(got), _f32(flat[k])), k
            assert np.array_equal(_f32(v), _f32(flat[k])), k
        else:
            want = _f32(v)
            err = np.abs(_f32(got) - want).max()
            assert err <= 1e-5 * np.abs(want).max() + 1e-6, (k, err)
            assert not np.array_equal(want, _f32(flat[k])), k
    # the factored second moments of the square kernel, in the Flax layout
    inner = opt_state.inner_opt_state if accum > 1 else opt_state
    factored = inner[1].inner_states["train"].inner_state[0]
    for slot in ("v_row", "v_col"):
        want = traverse_util.flatten_dict(getattr(factored, slot))[flipped]
        _close(opt.state[slot][flipped], want, 1e-5, slot)
    assert flipped not in opt.state["v"]
    assert ("hypernet", "encoder", "tiny", "kernel") in opt.state["v"]


# ---------------------------------------------------------- resume, preempt
def _stream(seed0=50):
    i = 0
    while True:
        yield _batch(seed0 + i % 7)
        i += 1


def _losses(history):
    return {h["step"]: h["loss"] for h in history if "loss" in h}


@pytest.mark.parametrize("use_adafactor,accum", [(False, 1), (True, 2)],
                         ids=["adamw", "adafactor-accum2"])
def test_full_state_resume_is_bit_identical(backbone, tmp_path, use_adafactor, accum):
    """A run saving full state every 2 steps, restored at step 2 into a
    fresh trainer that replays the data stream, gives the uninterrupted
    run's losses, parameters, optimizer state and dropout generator bit for
    bit (dropout on); reset_steps restores the parameters only; a full
    state mid-accumulation is refused."""
    kw = dict(use_adafactor=use_adafactor, gradient_accumulation_steps=accum, steps=5,
              identity_steps=0)
    ref = _port_trainer(backbone, output_dir=str(tmp_path / "ref"), **kw)
    ref_losses = _losses(ref.fit(_stream()))
    saver = _port_trainer(backbone, output_dir=str(tmp_path / "save"), save_steps=2, **kw)
    assert _losses(saver.fit(_stream())) == ref_losses
    ckpt = str(tmp_path / "save" / "step_2")
    for name in ("params.npz", "hn_config.json", "resume/state.npz", "resume/state.json"):
        assert os.path.exists(os.path.join(ckpt, name)), name
    with open(os.path.join(ckpt, "resume", "state.json")) as f:
        scalars = json.load(f)
    assert scalars["step"] == 2 * accum and scalars["count"] == 2
    with np.load(os.path.join(ckpt, "resume", "state.npz")) as z:
        slots = {k.split("/")[0] for k in z.files}
    assert slots == ({"v_row", "v_col", "v"} if use_adafactor else {"mu", "nu"}) | {
        "dropout_generator"}

    resumed = _port_trainer(backbone, output_dir=str(tmp_path / "resumed"), **kw)
    micro = resumed.restore_checkpoint(ckpt)
    assert micro == 2 * accum
    got = _losses(resumed.fit(_stream(), resume_step=micro // accum))
    assert sorted(got) == [3, 4, 5]
    assert got == {s: ref_losses[s] for s in (3, 4, 5)}
    for p in ref.params:
        assert torch.equal(ref.params[p], resumed.params[p]), p
    for key, t in ref.optimizer.state_arrays().items():
        assert torch.equal(t, resumed.optimizer.state_arrays()[key]), key
    assert torch.equal(ref.state.dropout_generator.get_state(),
                       resumed.state.dropout_generator.get_state())

    if accum > 1:  # full state is taken at a step boundary only
        resumed.train_step(_batch(1))
        with pytest.raises(ValueError, match="accumulated"):
            resumed.save_checkpoint(str(tmp_path / "mid"), full_state=True)
        assert not os.path.exists(tmp_path / "mid")

    reset = _port_trainer(backbone, output_dir=str(tmp_path / "reset"), **kw)
    assert reset.restore_checkpoint(ckpt, reset_steps=True) == 0
    assert reset.optimizer.count == 0 and reset.state.step == 0
    with np.load(os.path.join(ckpt, "params.npz")) as z:
        from zett_tpu_torch.models.convert import torch_to_flax

        now = torch_to_flax(reset.hypernet)
        assert all(np.array_equal(now[k], z[k]) for k in z.files)


def test_preemption_by_signal_then_resume(backbone, tmp_path):
    """SIGUSR1 sent from the log callback at step 2 (prefetch on): the loop
    finishes the step, writes preempt_step_2 with full state, returns and
    restores the previous handler; a trainer restored from it and replaying
    the stream gives the uninterrupted run's losses of steps 3-5 bit for
    bit."""
    ref = _port_trainer(backbone, output_dir=str(tmp_path / "ref"), identity_steps=1)
    ref_losses = _losses(ref.fit(_stream(), _stream(70)))

    run = _port_trainer(backbone, output_dir=str(tmp_path / "run"), identity_steps=1)

    def on_log(step, metrics):
        if step == 2:
            os.kill(os.getpid(), signal.SIGUSR1)

    before = signal.getsignal(signal.SIGUSR1)
    hist = run.fit(_stream(), _stream(70), on_log=on_log, preempt_signal=signal.SIGUSR1)
    assert signal.getsignal(signal.SIGUSR1) == before
    assert hist[-1] == {"step": 2, "preempted": 1.0}
    assert max(_losses(hist)) == 2 and run.state.step == 2
    ckpt = str(tmp_path / "run" / "preempt_step_2")
    assert os.path.isdir(os.path.join(ckpt, "resume"))

    resumed = _port_trainer(backbone, output_dir=str(tmp_path / "resumed"), identity_steps=1)
    got = _losses(resumed.fit(_stream(), _stream(70),
                              resume_step=resumed.restore_checkpoint(ckpt)))
    assert got == {s: ref_losses[s] for s in (3, 4, 5)}


# ----------------------------------------------------------------- prefetch
def test_prefetch_gives_the_inline_loop_its_batches(backbone):
    """fit with prefetch_batches 2 and 0 (identity steps from a second
    stream, accumulation 2): the same losses bit for bit, and records that
    time the pull (collate_ms), the wait for it (wait_ms) and the loop."""
    kw = dict(identity_steps=1, gradient_accumulation_steps=2, steps=3)
    runs = {}
    for depth in (2, 0):
        t = _port_trainer(backbone, prefetch_batches=depth, **kw)
        runs[depth] = (t.fit(_stream(), _stream(70)), t.records)
    assert [_losses(h) for h, _ in runs.values()][0] == _losses(runs[0][0])
    assert runs[2][0][0]["identity_loss"] == runs[0][0][0]["identity_loss"]
    for _, records in runs.values():
        assert [r["kind"] for r in records] == ["identity"] * 2 + ["train"] * 4
        for r in records:
            assert {"collate_ms", "wait_ms", "host_ms", "loop_ms"} <= set(r)
            assert r["loop_ms"] >= r["host_ms"]


def test_prefetcher_order_errors_and_close():
    """The prefetcher yields its source's items in order with their device
    batches; an exception in the thread is raised again by the consumer
    after the items before it; 3000 items pass a one-deep queue in order
    while the interpreter switches threads as often as it can; close()
    leaves no live thread, also while the thread is blocked on a full
    queue of an endless source."""
    def to_device(batch, pin):
        assert pin is False
        return {"x": torch.from_numpy(batch["x"])}

    items = [(i, {"x": np.full(3, i)}) for i in range(5)]
    pf = BatchPrefetcher(iter(items), to_device, "cpu", depth=2)
    got = list(pf)
    pf.close()
    assert [g[0] for g in got] == list(range(5))
    assert all(torch.equal(g[2]["x"], torch.full((3,), i)) for i, g in enumerate(got))
    assert not pf._thread.is_alive()

    def failing():
        for i in range(3):
            yield i, {"x": np.zeros(1)}
        raise ValueError("collate failed")

    pf = BatchPrefetcher(failing(), to_device, "cpu", depth=1)
    assert [next(pf)[0] for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="collate failed"):
        next(pf)
    pf.close()
    assert not pf._thread.is_alive()

    def endless():
        i = 0
        while True:
            yield i, {"x": np.zeros(1)}
            i += 1

    # many items through a one-deep queue with the interpreter switching
    # threads as often as it can: none lost, none reordered
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        many = [(i, {"x": np.full(1, i)}) for i in range(3000)]
        pf = BatchPrefetcher(iter(many), to_device, "cpu", depth=1)
        assert [int(g[2]["x"][0]) for g in pf] == list(range(3000))
        pf.close()
    finally:
        sys.setswitchinterval(interval)

    before = threading.active_count()
    pf = BatchPrefetcher(endless(), to_device, "cpu", depth=1)
    assert next(pf)[0] == 0
    pf.close()
    assert not pf._thread.is_alive()
    assert threading.active_count() == before


def test_fit_raises_the_prefetch_threads_error(backbone):
    """A batch iterator that fails inside the prefetch thread fails fit
    with its own exception, after the steps before it, and leaves no
    prefetch thread behind."""
    def failing():
        yield _batch(1)
        raise RuntimeError("bad batch")

    t = _port_trainer(backbone, prefetch_batches=2, steps=3)
    with pytest.raises(RuntimeError, match="bad batch"):
        t.fit(failing())
    assert t.state.step == 1
    assert not any(th.name == "zett-batch-prefetch" for th in threading.enumerate())


def test_trainer_refuses_only_unported_settings(backbone):
    """Backbone training regimes other than "no" and "full" are refused;
    full fine-tuning and the MLM loss are ported (the trainer builds)."""
    with pytest.raises(NotImplementedError):
        _port_trainer(backbone, backbone_training="lora")
    assert _port_trainer(backbone, loss="mlm").cfg.loss == "mlm"
    _port_trainer(backbone, remat_hypernet=True, remat_backbone=True, loss_chunk_size=8,
                  use_adafactor=True, prefetch_batches=3, save_state=True)
    _port_trainer(backbone, backbone_training="full")


# ---------------------------------------------------------------------- CLI
def test_training_cli_preempts_and_resumes_on_cpu(model_dir, corpus, tmp_path, monkeypatch):
    """The CLI on --device cpu with dropout on: an uninterrupted 4-step run;
    a run with preempt_signal SIGUSR1 sent from its log callback at step 2,
    which writes preempt_step_2 and no final/; a run from it through
    resume_from_checkpoint, whose steps 3-4 losses equal the uninterrupted
    run's bit for bit; and resume_reset_steps, which starts at step 0."""
    from zett_tpu_torch.training import engine
    from zett_tpu_torch.training.__main__ import main

    def run(name, **extra):
        cfg = dict(_cli_config(model_dir, str(tmp_path / name), corpus), steps=4,
                   hidden_dropout_prob=0.1, attention_dropout_prob=0.1,
                   run_backbone_in_training_mode=True, **extra)
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        return main([str(path), "--device", "cpu"])

    _, hist_a = run("a")
    assert os.path.isdir(tmp_path / "a" / "final" / "resume")

    orig_fit = engine.Trainer.fit

    def fit_with_kill(self, *args, on_log=None, **kw):
        def kill_at_2(step, metrics):
            on_log(step, metrics)
            if step == 2:
                os.kill(os.getpid(), signal.SIGUSR1)
        return orig_fit(self, *args, on_log=kill_at_2, **kw)

    monkeypatch.setattr(engine.Trainer, "fit", fit_with_kill)
    _, hist_b = run("b", preempt_signal="SIGUSR1")
    monkeypatch.setattr(engine.Trainer, "fit", orig_fit)
    assert hist_b[-1] == {"step": 2, "preempted": 1.0}
    assert os.path.isdir(tmp_path / "b" / "preempt_step_2" / "resume")
    assert not os.path.exists(tmp_path / "b" / "final")

    trainer_c, hist_c = run("c", resume_from_checkpoint=str(tmp_path / "b" / "preempt_step_2"))
    assert trainer_c.state.step == 4
    want = {h["step"]: h["loss"] for h in hist_a if h["step"] > 2}
    assert {h["step"]: h["loss"] for h in hist_c} == want

    trainer_d, hist_d = run("d", resume_from_checkpoint=str(tmp_path / "a" / "final"),
                            resume_reset_steps=True)
    assert trainer_d.state.step == 4 and [h["step"] for h in hist_d] == [1, 2, 3, 4]
