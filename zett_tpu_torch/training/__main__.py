"""Training CLI: hypernetwork training end to end.

Usage:
  python -m zett_tpu_torch.training CONFIG.json [--device {cuda,cpu}]
  python -m zett_tpu_torch.training --model MODEL_DIR --train-data DIR --output-dir OUT [...]

The same JSON configs as ``python -m zett_tpu.training`` (``_base``
inheritance included) map onto ``TrainingConfig``, ``DataConfig`` and
``HypernetConfig``; the backbone is GPT-2, a Llama-family model or
(XLM-)RoBERTa (its ``config.json``'s ``model_type``), and a source
tokenizer that is not byte-level is converted first. ``loss: "mlm"``
(configs/zeroshot/xlmr_26l.json) masks each training batch with
``data.mlm.MLMCollator``, drawn from a generator seeded with (the run's
``seed``, the batch counter), where the JAX CLI's masker is unseeded
(ROADMAP C.18); as in the JAX CLI, the eval batches are not masked (C.19).
``langs`` is a list, or a file of one code per line (or "code,weight"
lines); without weights, ``language_metadata_csv`` gives corpus sizes and
languages are drawn with probability size ** ``language_sampling_alpha``.
Runs on the card unless ``--device cpu`` is given, and raises when there is
none. One process on one device: a
config's ``n_model_parallel`` runs without a mesh, as the JAX CLI does on
one device. Metrics stream to ``<output_dir>/metrics.jsonl``;
the trained hypernet is written to ``<output_dir>/final/`` in the transfer
CLI's checkpoint format (``hn_config.json``, ``params.npz``,
``tokenizer.json``), so ``python -m zett_tpu_torch.transfer --checkpoint
OUT/final`` reads it. Training text comes from ``<train_directory>/<lang>.txt``
or an in-memory ``texts_by_lang``. With ``valid_directory`` (``<lang>.txt``)
or ``valid_texts_by_lang``, eval runs every ``eval_steps`` steps (and at
step 0 with ``eval_at_step_zero``): each of ``extra_valid_tokenizers`` with
its embeddings computed once per eval, then sampled tokenizers; the rows
(``eval_<tokenizer>/...`` and ``eval/...``) go to ``metrics.jsonl``.

Resume and preemption (config keys, as in the JAX CLI):
``"resume_from_checkpoint": DIR`` restores a checkpoint the trainer wrote
(``DIR/params.npz``, and with ``DIR/resume/`` the optimizer state, step and
dropout generator) and replays the data stream up to its step;
``"resume_reset_steps": true`` restores the parameters only and starts at
step 0. ``"preempt_signal": "SIGTERM"`` (any signal name) makes that
signal end the run at the next step boundary with a full-state checkpoint
in ``<output_dir>/preempt_step_<N>/`` and no ``final/``; resume from it.
With ``save_state`` (the default) ``final/`` and the periodic
``step_<N>/`` checkpoints hold the full state too.

The n-shot and baseline configs (``configs/nshot/``, ``configs/baseline/``:
``use_passthrough_hypernet``, ``backbone_training: "full"``,
``do_tokenizer_sampling: false``) train the passthrough tables and the
whole backbone against one fixed tokenizer, ``target_tokenizer`` (converted
to byte level) or the source's own; ``final/params.npz`` holds the tables,
which ``python -m zett_tpu_torch.transfer.baselines_cli --method
passthrough --checkpoint OUT/final`` slices into a model. A passthrough
config with the lexical loss on (every ``configs/nshot/*.json``, through
gpt2_en's ``lexical_loss_weight`` 0.5) raises ``ValueError`` naming
ROADMAP C.11 before loading anything: the JAX trainer fails on it with a
``TypeError`` at its first step.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import signal
import sys

import numpy as np

from ..data.datasets import (language_probs_from_sizes, language_sizes_from_metadata,
                             load_language_list)


def load_config_file(path: str) -> dict:
    """A JSON config with its ``_base`` chain resolved."""
    with open(path) as f:
        config = json.load(f)
    base_name = config.pop("_base", None)
    config.pop("_diff_note", None)
    if base_name:
        base = load_config_file(os.path.join(os.path.dirname(path), base_name))
        base.update(config)
        config = base
    return config


def load_configs(config: dict):
    from ..data import DataConfig
    from ..models.hypernet import HypernetConfig
    from .config import TrainingConfig

    def pick(cls):
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in config.items() if k in known})

    return pick(TrainingConfig), pick(DataConfig), pick(HypernetConfig)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    device_p = argparse.ArgumentParser(add_help=False)
    device_p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    if argv and argv[0].endswith(".json"):
        args, rest = device_p.parse_known_args(argv[1:])
        if rest:
            raise SystemExit(f"unknown arguments after config file: {rest}")
        config = load_config_file(argv[0])
        run_name = os.path.splitext(os.path.basename(argv[0]))[0]
    else:
        p = argparse.ArgumentParser(description=__doc__, parents=[device_p],
                                    formatter_class=argparse.RawDescriptionHelpFormatter)
        p.add_argument("--config", default=None)
        p.add_argument("--model", dest="model_dir")
        p.add_argument("--train-data", dest="train_directory")
        p.add_argument("--valid-data", dest="valid_directory", default=None)
        p.add_argument("--output-dir", dest="output_dir", default="out")
        p.add_argument("--steps", type=int, default=None)
        p.add_argument("--batch-size", dest="batch_size", type=int, default=128)
        p.add_argument("--num-workers", type=int, default=0)
        p.add_argument("--langs", nargs="*", default=["en"])
        args = p.parse_args(argv)
        config = {}
        if args.config:
            with open(args.config) as f:
                config = json.load(f)
        for k, v in vars(args).items():
            if v is not None and k not in ("config", "device"):
                config[k] = v
        run_name = os.path.basename(config.get("output_dir", "run"))
    return run_training(config, run_name, device=args.device)


def build_eval_fn(config: dict, data_cfg, reference, hn_tokenizer, batch_size: int, seed: int):
    """The in-training eval (``zett_tpu/training/__main__.py:323-377``), or
    None without validation text: one fixed-tokenizer collator per
    ``extra_valid_tokenizers`` entry (no vocab subsampling, no span
    sampling), evaluated with cached embeddings, then the sampled-tokenizer
    validation collator at ``seed + 1``. Under ``loss: "mlm"`` no eval
    collator masks, as in the JAX CLI (ROADMAP C.19): the labels are the
    ids."""
    valid_dir = config.get("valid_directory")
    if not (valid_dir or config.get("valid_texts_by_lang")):
        return None
    from ..data import Collator, ValidDataset
    from ..evaluation import eval_loop
    from ..tokenization.core import Tokenizer

    valid_ds = ValidDataset(langs=data_cfg.langs, batch_size=batch_size,
                            n_subsample=config.get("n_valid_subsample", 64),
                            valid_directory=valid_dir,
                            texts_by_lang=config.get("valid_texts_by_lang"))
    fixed_cfg = dataclasses.replace(data_cfg, do_tokenizer_sampling=False,
                                    n_token_subsample=None, sample_text_span=False)
    extra = []
    for tok_path in config.get("extra_valid_tokenizers", []):
        tok = Tokenizer.from_file(os.path.join(tok_path, "tokenizer.json")
                                  if os.path.isdir(tok_path) else tok_path)
        extra.append((os.path.basename(tok_path.rstrip("/")),
                      Collator(reference=reference, hn_tokenizer=hn_tokenizer,
                               data_config=fixed_cfg, batch_size=batch_size,
                               fixed_tokenizer=tok, is_validation=True, seed=seed)))
    valid_collator = Collator(
        reference=reference, hn_tokenizer=hn_tokenizer, data_config=data_cfg,
        batch_size=batch_size,
        initial_texts={lang: texts[:64] for lang, texts in valid_ds.dataset.items()},
        is_validation=True, seed=seed + 1)

    def eval_fn(trainer):
        out = {}
        for name, collator in extra:
            out.update(eval_loop(trainer, (collator([valid_ds[i]]) for i in range(len(valid_ds))),
                                 name=f"eval_{name}", fixed_tokenizer=True))
        out.update(eval_loop(trainer,
                             (valid_collator([valid_ds[i]]) for i in range(len(valid_ds))),
                             name="eval"))
        return out

    return eval_fn


def run_training(config: dict, run_name: str = "run", device: str = "cuda"):
    """``zett_tpu/training/__main__.py:102`` without distributed init,
    trackers, cost analysis and profiling. Returns (trainer, history)."""
    from ..data import Collator, TrainDataset
    from ..data.mlm import MLMCollator
    from ..models.backbones.hf_io import load_hf_state_dict
    from ..models.backbones.registry import (IN_EMBEDDING_KEYS, check_supported,
                                             config_from_hf, is_output_tied)
    from ..tokenization.convert import convert_to_byte_level, is_byte_level
    from ..tokenization.core import Tokenizer
    from ..transfer.__main__ import resolve_device
    from .engine import Trainer, check_passthrough

    dev = resolve_device(device)
    train_cfg, data_cfg, hn_cfg = load_configs(config)
    check_passthrough(hn_cfg, train_cfg, data_cfg.use_passthrough_hypernet)
    os.makedirs(train_cfg.output_dir, exist_ok=True)

    model_dir = config["model_dir"]
    with open(os.path.join(model_dir, "config.json")) as f:
        bb_config_json = json.load(f)
    model_type = bb_config_json["model_type"]
    check_supported(model_type)
    bb_config = config_from_hf(model_type, bb_config_json)
    bb_state = load_hf_state_dict(model_dir)

    reference = Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
    if not is_byte_level(reference):
        reference, _ = convert_to_byte_level(reference)
    hn_tokenizer = reference.copy()

    emb = bb_state[IN_EMBEDDING_KEYS[model_type]]
    hn_cfg = dataclasses.replace(hn_cfg, n_embd=int(emb.shape[1]),
                                 n_langs=max(len(data_cfg.langs), 1),
                                 vocab_size=len(hn_tokenizer) + 256)
    if "separate_out_embeddings" not in config:
        hn_cfg = dataclasses.replace(
            hn_cfg, separate_out_embeddings=not is_output_tied(model_type, bb_config_json))

    langs_cfg = config.get("langs", data_cfg.langs)
    if isinstance(langs_cfg, str):
        langs, lang_probs = load_language_list(langs_cfg)
    else:
        langs, lang_probs = [lang for lang in langs_cfg if lang != "all"], None
    if len(langs) == 1:
        lang_probs = np.array([1.0])
    elif lang_probs is None and config.get("language_metadata_csv"):
        sizes = language_sizes_from_metadata(langs, config["language_metadata_csv"])
        lang_probs = language_probs_from_sizes(sizes, data_cfg.language_sampling_alpha)
    mix_languages = bool(config.get("mix_languages", data_cfg.mix_languages))
    data_cfg = dataclasses.replace(data_cfg, langs=(["all"] + langs) if mix_languages else langs,
                                   mix_languages=mix_languages)
    hn_cfg = dataclasses.replace(hn_cfg, n_langs=len(data_cfg.langs))

    batch_size = config.get("batch_size", 128)
    dataset = TrainDataset(
        langs=langs, language_probs=lang_probs, batch_size=batch_size,
        block_size=data_cfg.block_size, train_directory=config.get("train_directory"),
        texts_by_lang=config.get("texts_by_lang"),
        eos_token=reference.all_special_tokens[0] if reference.all_special_tokens else None,
        mix_languages=mix_languages, seed=train_cfg.seed,
    )
    fixed_tokenizer = None
    if not data_cfg.do_tokenizer_sampling:
        target_tok_path = config.get("target_tokenizer")
        if target_tok_path:
            tok_file = (os.path.join(target_tok_path, "tokenizer.json")
                        if os.path.isdir(target_tok_path) else target_tok_path)
            fixed_tokenizer, _ = convert_to_byte_level(
                Tokenizer.from_file(tok_file), match_special_tokens_to=reference,
                make_whitespace_consistent=True)
        else:
            fixed_tokenizer = reference.copy()
    n_initial = config.get("n_initial_texts", 256)
    initial_texts = ({"all": dataset.get_texts(n_initial)} if mix_languages
                     else dataset.get_texts_in_each_language(n_initial))
    # the masker of an MLM run, reseeded by the Collator before each batch
    # (ROADMAP C.18)
    inner_collator = MLMCollator() if train_cfg.loss == "mlm" else None
    collator = Collator(reference=reference, hn_tokenizer=hn_tokenizer, data_config=data_cfg,
                        batch_size=batch_size, initial_texts=initial_texts,
                        fixed_tokenizer=fixed_tokenizer, inner_collator=inner_collator,
                        seed=train_cfg.seed)
    identity_collator = None
    if train_cfg.identity_steps > 0:
        id_data_cfg = dataclasses.replace(
            data_cfg, do_tokenizer_sampling=False,
            n_token_subsample=(data_cfg.identity_n_subsample
                               if data_cfg.identity_n_subsample is not None
                               else data_cfg.n_token_subsample))
        identity_collator = Collator(reference=reference, hn_tokenizer=hn_tokenizer,
                                     data_config=id_data_cfg, batch_size=batch_size,
                                     fixed_tokenizer=reference.copy(),
                                     lang_code=data_cfg.langs[0], seed=train_cfg.seed)

    # one device: n_model_parallel shards nothing (zett_tpu/training/__main__.py:
    # 274-278 builds a mesh only across devices)
    print(f"{model_type} backbone on one device ({dev}); n_model_parallel "
          f"{train_cfg.n_model_parallel} runs without a mesh", flush=True)
    # the vocab rows of a batch (zett_tpu/training/__main__.py:281-287);
    # the passthrough tables cover them and the hn tokenizer's ids
    if data_cfg.n_token_subsample is not None:
        vocab_batch = data_cfg.n_token_subsample
    elif fixed_tokenizer is not None:
        pad = data_cfg.pad_to_multiple_of
        vocab_batch = -(-len(fixed_tokenizer) // pad) * pad
    else:
        vocab_batch = data_cfg.tokenizer_sample_max + data_cfg.pad_to_multiple_of
    trainer = Trainer(hn_config=hn_cfg, backbone_config=bb_config, backbone_state=bb_state,
                      model_type=model_type, train_config=train_cfg, device=dev,
                      hn_pad_token_id=hn_cfg.pad_token_id,
                      use_passthrough_hypernet=data_cfg.use_passthrough_hypernet,
                      passthrough_rows=max(vocab_batch, len(hn_tokenizer)))

    num_workers = config.get("num_workers", 0)
    if num_workers > 0:
        from torch.utils.data import DataLoader

        batch_iter = iter(DataLoader(dataset, batch_size=1, num_workers=num_workers,
                                     collate_fn=collator, persistent_workers=True))
    else:
        batch_iter = (collator([item]) for item in dataset)
    identity_iter = None
    if identity_collator is not None:
        identity_iter = (identity_collator(None, for_identity_step=True)
                         for _ in itertools.count())

    eval_fn = build_eval_fn(config, data_cfg, reference, hn_tokenizer, batch_size,
                            train_cfg.seed)
    metrics_path = os.path.join(train_cfg.output_dir, "metrics.jsonl")

    def on_log(step, metrics):
        with open(metrics_path, "a") as f:
            f.write(json.dumps({"run": run_name, **metrics}) + "\n")
        print(f"step {step}: " + " ".join(f"{k}={v:.4g}" for k, v in metrics.items()
                                          if isinstance(v, (int, float))), flush=True)

    resume_step = 0
    resume_path = config.get("resume_from_checkpoint")
    if resume_path:
        trainer.restore_checkpoint(resume_path,
                                   reset_steps=bool(config.get("resume_reset_steps", False)))
        resume_step = trainer.state.step // max(1, train_cfg.gradient_accumulation_steps)
        print(f"resumed from {resume_path} at step {resume_step}", flush=True)

    if train_cfg.eval_at_step_zero and eval_fn is not None:
        on_log(0, eval_fn(trainer))
    preempt_signal = None
    if config.get("preempt_signal"):
        preempt_signal = getattr(signal, config["preempt_signal"])
    history = trainer.fit(batch_iter, identity_iter, eval_fn=eval_fn, on_log=on_log,
                          resume_step=resume_step, preempt_signal=preempt_signal)
    if history and history[-1].get("preempted"):
        # preempt_step_<N> holds the resumable state; final/ is for
        # finished runs
        print("preempted: the state is in the preempt_step checkpoint; no final/", flush=True)
    else:
        trainer.save_checkpoint(os.path.join(train_cfg.output_dir, "final"),
                                tokenizer=hn_tokenizer, full_state=train_cfg.save_state)
    return trainer, history


if __name__ == "__main__":
    main()
