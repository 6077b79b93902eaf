"""One rank of the process group that ``test_torch_port_parallel.py``
spawns, and the runs it shares with that test's one-process references.

Usage (one process a rank, gloo on the CPU):
  python tests/torch_parallel_worker.py RANK WORLD PORT WORKDIR

Each rank joins the group at ``127.0.0.1:PORT`` (WORLD 1: one process
without a group, the reference), reads the inputs the test
wrote to ``WORKDIR/inputs.npz`` (the JAX-initialised GPT-2 and hypernet
parameters) and ``WORKDIR/cli.json``, runs every run of ``run_all`` in turn,
and writes its results to ``WORKDIR/rank<R>.npz``. It imports neither JAX
nor the JAX package, and checks so before it writes.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from zett_tpu_torch.models import HypernetConfig  # noqa: E402
from zett_tpu_torch.models.backbones.gpt2 import GPT2Config  # noqa: E402
from zett_tpu_torch.models.backbones.llama import LlamaConfig, weight_keys  # noqa: E402
from zett_tpu_torch.models.backbones.roberta import RobertaConfig  # noqa: E402
from zett_tpu_torch.training import Trainer, TrainingConfig  # noqa: E402

V_BATCH, VOCAB, B_LM = 64, 300, 4
# a gpt2_en-shaped hypernet at small widths (tests/test_torch_port_training.py)
HN = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
          max_position_embeddings=8, n_embd=64, hn_surface_maxlen=4,
          embed_using_source_embeddings=True, n_extra_tokens=16, rescale_embeddings=True,
          predict_bias=True, hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
TRAIN = dict(steps=6, learning_rate=1e-3, warmup_steps=1, lexical_loss_weight=0.5,
             lexical_loss_kind="huber", max_grad_norm=0.05, weight_decay=0.01,
             adam_beta2=0.95, identity_steps=1, logging_steps=10, save_steps=0,
             eval_steps=0, dtype="float32")
GPT2 = dict(vocab_size=VOCAB, n_positions=32, n_embd=64, n_layer=2, n_head=2)
LLAMA = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)


def make_batch(seed, v=V_BATCH, b=B_LM, L=12, m=4):
    """A train batch of ``v`` vocab rows and ``b`` LM rows (one padded, one
    all-padding surface form, five masked vocab rows)."""
    rng = np.random.default_rng(seed)
    sf = rng.integers(1, VOCAB + 16, size=(v, m)).astype(np.int32)
    lens = rng.integers(1, m + 1, size=v)
    sf[np.arange(m)[None] >= lens[:, None]] = 0
    sf[7] = 0
    attention_mask = np.ones((b, L), np.int32)
    attention_mask[1, 9:] = 0
    mask = np.ones(v, bool)
    mask[-5:] = False
    return {
        "input_ids": rng.integers(0, v, size=(b, L)).astype(np.int32),
        "attention_mask": attention_mask,
        "labels": rng.integers(0, v, size=(b, L)).astype(np.int32),
        "target_surface_forms": sf,
        "target_priors": np.zeros(v, np.float32),
        "mask": mask,
        "ids_to_embed": rng.permutation(VOCAB)[:v].astype(np.int32),
        "special_indices": np.array([0, 5]),
        "special_indices_in_reference": np.array([0, 3]),
        "lang_index": np.array(0),
    }


def _inputs(work):
    with np.load(os.path.join(work, "inputs.npz")) as z:
        return {k: z[k] for k in z.files}


def _prefixed(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def gpt2_trainer(work, dropout=0.0, **train):
    """The GPT-2 trainer of the JAX parity test's parameters."""
    inputs = _inputs(work)
    hn = dict(HN, hidden_dropout_prob=dropout, attention_dropout_prob=dropout)
    return Trainer(hn_config=HypernetConfig(**hn), backbone_config=GPT2Config(**GPT2),
                   backbone_state={k: torch.from_numpy(v)
                                   for k, v in _prefixed(inputs, "bb/").items()},
                   model_type="gpt2", train_config=TrainingConfig(**dict(TRAIN, **train)),
                   device="cpu", hn_params=_prefixed(inputs, "hn/"))


def llama_state(seed=5):
    """A tiny untied Llama's HF state dict (mistral-like: GQA, 2 KV heads)."""
    rng = np.random.default_rng(seed)
    cfg = LlamaConfig(**LLAMA)
    out = {}
    for k in weight_keys(cfg):
        if k.endswith("norm.weight") or "layernorm" in k:
            shape = (cfg.hidden_size,)
            out[k] = torch.from_numpy(1.0 + 0.1 * rng.normal(size=shape).astype(np.float32))
            continue
        if "embed_tokens" in k or k == "lm_head.weight":
            shape = (VOCAB, cfg.hidden_size)
        elif k.endswith(("q_proj.weight", "o_proj.weight")):
            shape = (cfg.hidden_size, cfg.hidden_size)
        elif k.endswith(("k_proj.weight", "v_proj.weight")):
            shape = (cfg.kv_heads * cfg.dims_per_head, cfg.hidden_size)
        elif k.endswith(("gate_proj.weight", "up_proj.weight")):
            shape = (cfg.intermediate_size, cfg.hidden_size)
        else:
            shape = (cfg.hidden_size, cfg.intermediate_size)
        out[k] = torch.from_numpy((0.05 * rng.normal(size=shape)).astype(np.float32))
    return out


def llama_trainer(passthrough=False, **train):
    """A trainer over ``llama_state``: the hypernet (its own init) with the
    frozen backbone, or the passthrough tables with ``backbone_training``
    "full"."""
    hn = dict(HN, separate_out_embeddings=True, hidden_dropout_prob=0.1,
              attention_dropout_prob=0.1)
    kw = dict(TRAIN, **train)
    if passthrough:
        kw.update(lexical_loss_weight=0.0, identity_steps=0, backbone_training="full")
    return Trainer(hn_config=HypernetConfig(**hn), backbone_config=LlamaConfig(**LLAMA),
                   backbone_state=llama_state(), model_type="mistral",
                   train_config=TrainingConfig(**kw), device="cpu",
                   use_passthrough_hypernet=passthrough, passthrough_rows=VOCAB + 16)


ROBERTA = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=128, max_position_embeddings=40, pad_token_id=1)


def roberta_state(seed=6):
    """A tiny XLM-R's HF state dict (the tied decoder left out, as the
    backbone holds it)."""
    from zett_tpu_torch.models.backbones.roberta import weight_keys as roberta_keys

    rng = np.random.default_rng(seed)
    cfg = RobertaConfig(**ROBERTA)
    H, I = cfg.hidden_size, cfg.intermediate_size
    out = {}
    for k in roberta_keys(cfg):
        if "LayerNorm.weight" in k or "layer_norm.weight" in k:
            a = 1.0 + 0.1 * rng.normal(size=H)
        elif k.endswith("bias"):
            a = 0.05 * rng.normal(size=VOCAB if k == "lm_head.bias" else
                                  I if "intermediate" in k else H)
        elif "embeddings" in k:
            rows = {"word": VOCAB, "posi": cfg.max_position_embeddings, "toke": 1}
            a = 0.5 * rng.normal(size=(rows[k.split(".")[2][:4]], H))
        elif "intermediate" in k:
            a = rng.normal(size=(I, H)) / np.sqrt(H)
        elif "output.dense" in k and "attention" not in k:
            a = rng.normal(size=(H, I)) / np.sqrt(I)
        else:
            a = rng.normal(size=(H, H)) / np.sqrt(H)
        out[k] = torch.from_numpy(np.asarray(a, np.float32))
    return out


def whole(t):
    """A tensor as numpy f32, gathered from the ranks where sharded."""
    from zett_tpu_torch.parallel.sharding import full_tensor, is_sharded

    t = t.detach()
    if is_sharded(t):
        t = full_tensor(t.to_local(), t)
    return t.float().numpy()


def _flax(trainer, path, t):
    """``whole(t)`` in the Flax layout (Dense kernels (in, out))."""
    a = whole(t)
    return a.T if path in trainer.transposed else a


def params_of(trainer, roots=("hypernet", "inner")):
    return {"/".join(p): _flax(trainer, p, t) for p, t in trainer.params.items()
            if p[0] in roots}


def grads_of(trainer):
    """The last step's gradients (zeros where a parameter had none, as JAX
    reports them)."""
    return {"/".join(p): _flax(trainer, p, g) if g is not None
            else np.zeros(tuple(_flax(trainer, p, trainer.params[p]).shape), np.float32)
            for p, g in trainer.last_grads.items()}


@contextlib.contextmanager
def capturing_grads(store):
    """Appends every step's ``grads_of`` to ``store`` (on every rank: the
    sharded ones are gathered)."""
    orig = Trainer._apply_gradients

    def apply(self, loss):
        orig(self, loss)
        store.append(grads_of(self))

    Trainer._apply_gradients = apply
    try:
        yield store
    finally:
        Trainer._apply_gradients = orig


def _grads_out(store):
    return {f"grad{i}/{k}": v for i, g in enumerate(store) for k, v in g.items()}


def steps(trainer, kinds, seeds):
    """``kinds`` ("identity"/"train") on ``make_batch(seeds[i])``: the
    losses, the learning rates and each step's gradients."""
    out = {}
    for i, (kind, seed) in enumerate(zip(kinds, seeds)):
        batch = make_batch(seed)
        if kind == "identity":
            m = trainer.identity_train_step(batch)
            out[f"loss/{i}"] = np.float64(m["identity_loss"])
            out[f"learning_rate/{i}"] = np.float64(m["learning_rate"])
        else:
            m = trainer.train_step(batch)
            for key in ("loss", "lexical_loss", "mean_lexical_overlap", "learning_rate"):
                out[f"{key}/{i}"] = np.float64(m[key])
        out.update({f"grad{i}/{k}": v for k, v in grads_of(trainer).items()})
    return out


# -------------------------------------------------------------------- the runs
def job_gpt2(work, dropout):
    """An identity step and two train steps of the GPT-2 trainer."""
    trainer = gpt2_trainer(work, dropout)
    out = steps(trainer, ("identity", "train", "train"), (10, 11, 12))
    out.update({f"param/{k}": v for k, v in params_of(trainer).items()})
    return out


def job_llama(work):
    """Two train steps over the tiny Llama, frozen and fully sharded, with
    dropout 0.1 and the chunked loss (its headless call under FSDP)."""
    trainer = llama_trainer(loss_chunk_size=4, identity_steps=0)
    out = steps(trainer, ("train", "train"), (20, 21))
    out.update({f"param/{k}": v for k, v in params_of(trainer, ("hypernet",)).items()})
    return out


def job_mlm(work):
    """Two MLM train steps over the tiny XLM-R, fully sharded, the chunked
    loss (its head run chunk by chunk on the model's own weights), then an
    eval step."""
    hn = dict(HN, hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    trainer = Trainer(hn_config=HypernetConfig(**hn), backbone_config=RobertaConfig(**ROBERTA),
                      backbone_state=roberta_state(), model_type="xlm-roberta",
                      train_config=TrainingConfig(**dict(TRAIN, loss="mlm", loss_chunk_size=4,
                                                         identity_steps=0)), device="cpu")
    out = {}
    for i, seed in enumerate((50, 51)):
        batch = make_batch(seed)
        batch["labels"][:, ::3] = -100
        m = trainer.train_step(batch)
        out[f"loss/{i}"], out[f"learning_rate/{i}"] = np.float64(m["loss"]), \
            np.float64(m["learning_rate"])
        out.update({f"grad{i}/{k}": v for k, v in grads_of(trainer).items()})
    metrics = trainer.eval_step(trainer._device_batch(make_batch(52)))
    out.update({f"loss_eval/{k}": np.float64(v) for k, v in metrics.items()})
    out.update({f"param/{k}": v for k, v in params_of(trainer, ("hypernet",)).items()})
    return out


def job_full(work):
    """Passthrough tables with the backbone trained ("full", AdamW, its
    state sharded), two steps, then a full-state checkpoint."""
    trainer = llama_trainer(passthrough=True)
    out = steps(trainer, ("train", "train"), (30, 31))
    out.update({f"param/{k}": v for k, v in params_of(trainer).items()})
    trainer.save_checkpoint(os.path.join(work, "full_ckpt"), full_state=True)
    out.update({f"state/{k}": whole(t) for k, t in trainer.optimizer.state_arrays().items()})
    return out


def job_preempt(work, rank):
    """``fit`` over 7 steps with the preemption signal enabled; rank 1 (or
    the one process) sets its flag at step 2's boundary, directly."""
    trainer = gpt2_trainer(work, 0.1, steps=7, logging_steps=1,
                           output_dir=os.path.join(work, "preempt_run"))

    def on_log(step, metrics):
        if step == 2 and rank == 1:
            trainer._preempted = True

    with capturing_grads([]) as grads:
        history = trainer.fit((make_batch(40 + i) for i in range(100)),
                              (make_batch(60 + i) for i in range(100)), on_log=on_log,
                              preempt_signal=signal.SIGUSR2)
    return {**{f"param/{k}": v for k, v in params_of(trainer, ("hypernet",)).items()},
            **_grads_out(grads),
            "steps": np.array([h["step"] for h in history]),
            **{f"learning_rate/{i}": np.float64(h["learning_rate"])
               for i, h in enumerate(history) if "learning_rate" in h},
            "preempted": np.array([h.get("preempted", 0.0) for h in history]),
            "losses": np.array([h.get("loss", h.get("identity_loss", np.nan))
                                for h in history])}


def job_transfer(work):
    """``transfer()`` of a small seeded hypernet from gpt2_raw to de_raw."""
    from zett_tpu_torch.models import Hypernet
    from zett_tpu_torch.tokenization import Tokenizer
    from zett_tpu_torch.transfer import transfer

    tok = os.path.join(REPO, "artifacts", "tokenizers", "{}", "tokenizer.json")
    source = Tokenizer.from_file(tok.format("gpt2_raw"))
    target = Tokenizer.from_file(tok.format("de_raw"))
    cfg = HypernetConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                         num_attention_heads=1, max_position_embeddings=8, n_embd=32,
                         hn_surface_maxlen=7, embed_using_source_embeddings=True,
                         original_vocab_size=len(source), n_extra_tokens=16,
                         rescale_embeddings=True, predict_bias=True)
    hypernet = Hypernet(cfg)
    hypernet.init_weights(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    src = (0.02 * rng.normal(size=(len(source), 32))).astype(np.float32)
    emb_in, _, bias, converted = transfer(hypernet=hypernet, hn_tokenizer=source,
                                          source_tokenizer=source, source_embeddings_in=src,
                                          target_tokenizer=target, batch_size=4096)
    return {"emb_in": emb_in, "bias": bias, "n": np.array(len(converted))}


def count_inputs(seed=7, n=3000):
    """A random byte vocab (every byte but four, which take the unk path)
    and weighted random pretokens, some past the 16-byte rows."""
    rng = np.random.default_rng(seed)
    pieces = sorted({rng.bytes(int(rng.integers(2, 7))) for _ in range(n)})
    pieces += [bytes([b]) for b in range(256) if b not in (0xF5, 0xF6, 0xFE, 0xFF)] + [b""]
    scores = (rng.normal(size=len(pieces)) * 2 - 8).tolist()
    pretokens = {rng.bytes(int(rng.integers(1, 24))): int(rng.integers(1, 50))
                 for _ in range(5000)}
    return pieces, scores, pretokens


def job_counts(group):
    from zett_tpu_torch.ops.device_viterbi import count_tokens_device

    pieces, scores, pretokens = count_inputs()
    return {"counts": count_tokens_device(pieces, scores, pretokens, max_pretoken_len=16,
                                          device="cpu", group=group)}


def job_cli(work, flags, rank):
    """The training CLI on ``cli.json`` (with ``flags``: the distributed
    ones), then the transfer CLI on its final/."""
    from zett_tpu_torch.training.__main__ import main
    from zett_tpu_torch.transfer.__main__ import main as transfer_main

    with open(os.path.join(work, "cli.json")) as f:
        cfg = json.load(f)
    out = os.path.join(work, "cli_run" if flags else "cli_run_1")
    cfg["output_dir"] = out
    path = os.path.join(work, "cli_cfg.json" if flags else "cli_cfg_1.json")
    if rank == 0:
        with open(path, "w") as f:
            json.dump(cfg, f)
    if flags:
        torch.distributed.barrier()
    with capturing_grads([]) as grads:
        trainer, history = main([path, "--device", "cpu", *flags])
    transfer_main(["--checkpoint", os.path.join(out, "final"), "--model", cfg["model_dir"],
                   "--target-tokenizer", os.path.join(out, "final"),
                   "--output", os.path.join(out, "transferred"), "--device", "cpu",
                   "--batch-size", "256", *flags])
    return {"losses": np.array([h.get("loss", h.get("identity_loss")) for h in history]),
            **{f"learning_rate/{i}": np.float64(h["learning_rate"])
               for i, h in enumerate(history)},
            **_grads_out(grads),
            **{f"param/{k}": v for k, v in params_of(trainer, ("hypernet",)).items()}}


def job_refusals(work):
    """What a process group refuses, by name: the inter-token exchange over
    split rows; Adafactor on a parameter FSDP shards and Adafactor factors."""
    from zett_tpu_torch.training.optimizer import Adafactor

    refused = {}
    try:
        inputs = _inputs(work)
        Trainer(hn_config=HypernetConfig(**dict(HN, add_inter_token_attention=True)),
                backbone_config=GPT2Config(**GPT2),
                backbone_state={k: torch.from_numpy(v)
                                for k, v in _prefixed(inputs, "bb/").items()},
                model_type="gpt2", train_config=TrainingConfig(**TRAIN), device="cpu")
    except ValueError as exc:
        refused["inter_token"] = int("ROADMAP A.17" in str(exc))
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Shard, distribute_tensor

        mesh = init_device_mesh("cpu", (torch.distributed.get_world_size(),))
        big = torch.nn.Parameter(distribute_tensor(torch.zeros(256, 128), mesh, [Shard(0)]))
        Adafactor({("inner", "dense", "kernel"): big},
                  TrainingConfig(**dict(TRAIN, backbone_training="full", use_adafactor=True)),
                  lambda step: np.float32(1e-3))
    except ValueError as exc:
        refused["adafactor"] = int("ROADMAP A.18" in str(exc))
    return {k: np.array(v) for k, v in refused.items()}


def run_all(work, rank=0, flags=(), group=None):
    """Every run, its results under "<run>/"."""
    out = {}
    runs = (("gpt2_drop", lambda: job_gpt2(work, 0.1)), ("gpt2", lambda: job_gpt2(work, 0.0)),
            ("llama", lambda: job_llama(work)), ("mlm", lambda: job_mlm(work)),
            ("full", lambda: job_full(work)),
            ("preempt", lambda: job_preempt(work, rank)), ("transfer", lambda: job_transfer(work)),
            ("counts", lambda: job_counts(group)),
            ("cli", lambda: job_cli(work, list(flags), rank)))
    for name, run in runs:
        out.update({f"{name}/{k}": v for k, v in run().items()})
    return out


def main():
    rank, world, port, work = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch.distributed as dist

    torch.manual_seed(0)
    if world == 1:
        out = run_all(work)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        flags = ["--distributed-coordinator", f"127.0.0.1:{port}",
                 "--distributed-num-processes", str(world), "--distributed-process-id",
                 str(rank)]
        out = run_all(work, rank, flags, dist.group.WORLD)
        out.update({f"refusals/{k}": v for k, v in job_refusals(work).items()})
    loaded = sorted(m for m in sys.modules
                    if m in ("jax", "zett_tpu") or m.startswith(("jax.", "zett_tpu.")))
    if loaded:
        raise SystemExit(f"rank {rank} imported {loaded}")
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
