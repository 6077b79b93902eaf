"""The training engine (counterpart of ``zett_tpu/training/engine.py``):
state init, the train, identity and eval steps, and the loop with logging
and in-training eval.

One train step (``engine.py:500-543``): the hypernet predicts the
embeddings of the batch's vocab rows on its training route (kernels 2 and
3 for every attention core); the source model's special-token rows are
spliced in; the frozen backbone (GPT-2, the Llama family or RoBERTa) runs
with the predicted input table, and with the predicted output table as its
head when the head is untied (RoBERTa's lm-head bias is zeroed, as the JAX
splice zeroes it; the learnable bias is added to the logits); the loss is
the CLM or MLM loss plus the weighted lexical loss; the gradients of every
parameter, the frozen backbone's included, go through the optimizer
(``optimizer.py``), which updates the hypernet only. The identity step
(``engine.py:545-573``) regresses the predicted embeddings of sampled
source tokens onto their source embeddings. Eval
(``engine.py:575-620``) predicts the batch's embeddings on the hypernet's
inference route without gradients (``compute_embeddings``: kernel 1, 4 or 2
per layer as the configuration routes it) and reports the CLM loss and the
bits-per-byte term, or the MLM loss and accuracy (``eval_step``); a fixed
tokenizer's embeddings are computed once and reused across batches
(``eval_step_cached``, ``evaluation/loop.py``).

The memory levers (``engine.py:341-346``, ``:397-498``): ``remat_hypernet``
runs the hypernet's training forward under ``torch.utils.checkpoint``;
``remat_hypernet_glue`` (the port's own) rematerializes its f32 LayerNorm
and gelu glue op by op (``models.hypernet.remat_glue``: what XLA's fusion
keeps out of memory);
``remat_backbone`` each backbone block; ``loss_chunk_size`` computes the
loss, in training and in eval, from the backbone's final hidden states
chunk by chunk (``losses.chunked_clm_loss``/``chunked_clm_eval``, and
``chunked_mlm_loss``/``chunked_mlm_eval`` with RoBERTa's MLM head run per
chunk), so the (B, L, V) logits never exist. The loop (``fit``) prefetches
batches on a thread (``prefetch.BatchPrefetcher``), writes full-state checkpoints
(parameters, optimizer state, step, dropout generator) and resumes from
them by replaying the data stream, and on a preemption signal checkpoints
and returns.

The n-shot and baseline runs (``use_passthrough_hypernet``,
``backbone_training: "full"``): ``PassthroughHypernet``'s tables, set from
the source rows, take the hypernet's place, and the state keeps no source
table, so there is no special-token splice, no lexical loss (refused by
name, ROADMAP C.11) and no identity step; under ``"full"`` the backbone's
parameters are f32, computed in the compute dtype, and train with the
tables (the optimizer sees the Llama family's ``(out, in)`` weights in the
Flax layout), and a full-state checkpoint carries them. Not ported: xglm,
multi-GPU (and with it the multihost preemption agreement).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..constants import NEGATIVE_INF_FILL_VALUE
from ..models.backbones.registry import build_model, headless_model, mlm_head, resolve_out_path
from ..models.convert import (backbone_flax_path, backbone_transposed, flax_paths,
                              flax_to_torch, torch_to_flax)
from ..models.hypernet import Hypernet, HypernetConfig, PassthroughHypernet, remat_glue
from ..models.splice import extract_embeddings
from .losses import (chunked_clm_eval, chunked_clm_loss, chunked_mlm_eval, chunked_mlm_loss,
                     lexical_loss, lm_loss, mlm_accuracy)
from .optimizer import build_optimizer
from .prefetch import BatchPrefetcher
from .schedules import create_learning_rate_fn
from .state import TrainState

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_passthrough(hn_config, train_config, use_passthrough_hypernet: bool) -> None:
    """Refuse the lexical loss under the passthrough hypernet (ROADMAP
    C.11). Its state keeps no source table (``engine.py:207``), and the
    lexical loss reads one (``engine.py:520``): the JAX trainer raises
    ``TypeError`` at its first step. Every ``configs/nshot/*.json`` asks
    for it through gpt2_en's ``embed_using_source_embeddings`` and
    ``lexical_loss_weight`` 0.5; the ``configs/baseline/`` ones set the
    weight to 0."""
    if (use_passthrough_hypernet and hn_config.embed_using_source_embeddings
            and train_config.lexical_loss_weight > 0):
        raise ValueError(
            "ROADMAP C.11: the passthrough hypernet keeps no source embeddings, so the "
            "lexical loss (embed_using_source_embeddings with lexical_loss_weight "
            f"{train_config.lexical_loss_weight}) cannot run; set lexical_loss_weight to 0 "
            "(the JAX trainer fails with TypeError at its first step)")


class Trainer:
    def __init__(
        self,
        *,
        hn_config: HypernetConfig,
        backbone_config,
        backbone_state: Dict[str, torch.Tensor],
        model_type: str,
        train_config,
        device,
        hn_pad_token_id: int = 0,
        hn_params: Optional[Dict[str, np.ndarray]] = None,
        use_passthrough_hypernet: bool = False,
        passthrough_rows: int = 0,
    ):
        cfg = train_config
        if cfg.loss not in ("clm", "mlm"):
            raise ValueError(f"unknown loss mode {cfg.loss}")
        if cfg.backbone_training not in ("no", "full"):
            raise NotImplementedError(f"backbone_training={cfg.backbone_training!r} is not "
                                      "ported ('no' and 'full' are)")
        check_passthrough(hn_config, cfg, use_passthrough_hypernet)
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.hn_pad_token_id = hn_pad_token_id
        self.model_type = model_type

        source, original_vocab = extract_embeddings(backbone_state, model_type,
                                                    config=backbone_config)
        self.source_embeddings = source.to(self.dtype).to(self.device)
        self.out_tied = resolve_out_path(model_type, backbone_state, backbone_config) is None
        if hn_config.embed_using_source_embeddings and hn_config.original_vocab_size == 0:
            hn_config = dataclasses.replace(hn_config, original_vocab_size=original_vocab)
        self.hn_config = hn_config

        if cfg.backbone_training == "no":
            # the frozen backbone is held in bf16 (engine.py:234-238)
            held = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32 else v)
                    for k, v in backbone_state.items()}
        else:
            # full fine-tuning: f32 parameters, as the JAX package loads
            # them (its loader reads f32; a bf16 checkpoint widens exactly),
            # cast to the compute dtype inside each op
            held = {k: (v.float() if v.is_floating_point() else v)
                    for k, v in backbone_state.items()}
        # per-block remat (engine.py:178-186)
        backbone_config = dataclasses.replace(backbone_config, remat_blocks=cfg.remat_backbone)
        self.backbone = build_model(model_type, backbone_config, held,
                                    self.dtype).to(self.device)
        self.headless = headless_model(model_type, self.backbone)
        self.mlm_head = mlm_head(model_type, self.backbone)
        if use_passthrough_hypernet:
            self.hypernet = self._passthrough_tables(passthrough_rows)
            # the state keeps no source table (engine.py:207): no
            # special-token splice, no lexical loss, no identity step
            self.source_embeddings = None
        else:
            # built on the meta device: init_weights or the given parameters
            # write every value that a default init would draw first
            with torch.device("meta"):
                self.hypernet = Hypernet(hn_config, dtype=self.dtype)
            self.hypernet.to_empty(device="cpu")
        if hn_params is not None:
            self.hypernet.load_state_dict(flax_to_torch(hn_params), strict=True)
        elif not use_passthrough_hypernet:
            self.hypernet.init_weights(torch.Generator().manual_seed(cfg.seed))
        self.hypernet.to(self.device)

        # every parameter under its Flax path, as jax.value_and_grad sees
        # the state's params {"hypernet", "inner"}; the optimizer sees the
        # Flax layout through ``transposed``
        self.params: Dict[tuple, torch.nn.Parameter] = {}
        transposed = []
        hn_paths = flax_paths(self.hypernet)
        for name, p in self.hypernet.named_parameters():
            path, transpose = hn_paths[name]
            self.params[("hypernet",) + path] = p
            if transpose:
                transposed.append(("hypernet",) + path)
        for key, p in self.backbone.named_hf_parameters():
            path = ("inner",) + backbone_flax_path(model_type, key)
            self.params[path] = p
            if backbone_transposed(model_type, key):
                transposed.append(path)
        self.transposed = frozenset(transposed)

        self.random_lr_fn, _ = create_learning_rate_fn(cfg)
        self.optimizer = build_optimizer(self.params, cfg, self.random_lr_fn, transposed)
        self.state = TrainState(step=0,
                                dropout_generator=torch.Generator().manual_seed(cfg.seed + 1))
        self.last_grads: Dict[tuple, torch.Tensor] = {}
        self.records: List[Dict[str, Any]] = []
        self.last_train_batch: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ steps
    def _device_batch(self, batch: Dict[str, Any], pin: bool = False) -> Dict[str, torch.Tensor]:
        """The numeric arrays of a host batch as device tensors; with
        ``pin``, copied from pinned host memory without blocking (the
        prefetcher's side stream)."""
        out = {}
        for k, v in batch.items():
            if k == "metrics" or not (hasattr(v, "shape") or isinstance(v, (int, float))):
                continue
            a = np.asarray(v)
            if a.dtype.kind not in "biuf":
                continue
            if a.dtype == np.float64:
                a = a.astype(np.float32)  # as jnp.asarray without x64
            t = torch.from_numpy(np.ascontiguousarray(a))
            out[k] = (t.pin_memory().to(self.device, non_blocking=True) if pin
                      else t.to(self.device))
        return out

    @staticmethod
    def _source_rows(table, ids):
        """Rows ``ids`` of a source table, ids past its end clamped to its
        last row, as a JAX gather ``table[ids]`` clamps them
        (``engine.py:520``). A converted source tokenizer can hold more
        tokens than the source model has rows (TinyLlama's 32000-row table
        has no padding rows to spare; ROADMAP C.7)."""
        return table[ids.clamp(max=table.shape[0] - 1)]

    def _passthrough_tables(self, min_rows: int) -> PassthroughHypernet:
        """The passthrough tables from the source rows (``engine.py:198-209``):
        the input table, the output table where the head is untied, the
        bias zeros. As in JAX they hold the source rows as cast to the
        compute dtype. The tables have the padded source's rows, or
        ``min_rows`` where that is more (the ids a batch can hold): JAX
        sizes them by the source alone, so a fixed tokenizer with more ids
        than that (a converted metaspace source) reads NaN rows past their
        end and its loss is NaN (ROADMAP C.14); the port pads on with zero
        rows, as ``extract_embeddings`` pads the source to a multiple of
        128."""
        hn_cfg = self.hn_config
        if hn_cfg.separate_out_embeddings == self.out_tied:
            raise ValueError(f"separate_out_embeddings={hn_cfg.separate_out_embeddings} "
                             f"but the {self.model_type} head is "
                             f"{'tied' if self.out_tied else 'untied'}")
        source = self.source_embeddings
        rows = max(source.shape[0], int(min_rows))
        if rows > source.shape[0]:
            print(f"passthrough tables: {rows} rows for the fixed tokenizer's ids, past the "
                  f"source's {source.shape[0]}: the rows past the source start at zero, where "
                  f"the reference reads NaN and its loss is NaN (ROADMAP C.14)", flush=True)
        with torch.device("meta"):  # every value is written below
            tables = PassthroughHypernet(hn_cfg, vocab_size=rows, dtype=self.dtype)
        tables = tables.to_empty(device="cpu").to(self.dtype)
        n, n_embd = source.shape[0], hn_cfg.n_embd
        with torch.no_grad():
            for p in tables.parameters():
                p.zero_()
            tables.input_embeddings.weight[:n] = source[:, :n_embd].cpu()
            if hn_cfg.separate_out_embeddings:
                tables.output_embeddings.weight[:n] = source[:, n_embd:].cpu()
        return tables

    def _split_source(self):
        if self.source_embeddings is None:
            return None, None
        n_embd = self.hn_config.n_embd
        src_in = self.source_embeddings[:, :n_embd]
        src_out = None if self.out_tied else self.source_embeddings[:, n_embd:]
        return src_in, src_out

    def _hypernet(self, b, deterministic: bool, inference: bool = False, generator=None,
                  remat: bool = False):
        """The hypernet on a device batch. With ``remat`` and gradients on,
        under ``checkpoint`` (``engine.py:341-346``): the forward keeps only
        its inputs and the backward runs it again. ``checkpoint`` restores
        the default generators for that second run but not the explicit
        dropout generator, so each run draws from its own generator set to
        the state the first run started from; afterwards the step's
        generator takes the state the first run ended at, as without remat."""
        if generator is None and not deterministic:
            generator = self.state.dropout_generator
        args = (b["target_surface_forms"], b.get("target_priors"), self.source_embeddings,
                b.get("lang_index"))

        def glue():
            return remat_glue() if self.cfg.remat_hypernet_glue else contextlib.nullcontext()

        if not (remat and torch.is_grad_enabled()):
            with glue():
                return self.hypernet(*args, deterministic=deterministic, inference=inference,
                                     generator=generator)
        start = generator.get_state() if generator is not None else None
        end = []

        def run(*inputs):
            g = None
            if start is not None:
                g = torch.Generator()
                g.set_state(start)
            # the backward's recompute runs here too
            with glue():
                out = self.hypernet(*inputs, deterministic=deterministic, inference=inference,
                                    generator=g)
            if g is not None and not end:
                end.append(g.get_state())
            return out

        out = checkpoint(run, *args, use_reentrant=False)
        if generator is not None:
            generator.set_state(end[0])
        return out

    def _embeddings(self, b, deterministic: bool, inference: bool = False, generator=None):
        """The hypernet's predictions with the source model's special-token
        rows spliced in (``engine.py:348-368``), the hypernet under remat
        with ``remat_hypernet``."""
        src_in, src_out = self._split_source()
        emb_in, emb_out, biases = self._hypernet(b, deterministic, inference, generator,
                                                 remat=self.cfg.remat_hypernet)
        if src_in is None:  # the passthrough state keeps no source table
            return emb_in, emb_out, biases
        special, special_ref = b["special_indices"].long(), b["special_indices_in_reference"].long()
        emb_in = emb_in.index_put((special,), src_in[special_ref].to(emb_in.dtype))
        if emb_out is not None and src_out is not None:
            emb_out = emb_out.index_put((special,), src_out[special_ref].to(emb_out.dtype))
        return emb_in, emb_out, biases

    def _logits(self, b, emb_in, emb_out, biases):
        """The frozen backbone with the predicted tables (the output table as
        the head when it is untied), plus the vocab mask and the configured
        bias terms (``engine.py:370-385``)."""
        cfg = self.cfg
        head = () if self.out_tied else (emb_out,)
        logits = self.backbone(b["input_ids"].long(), b["attention_mask"], emb_in, *head)
        vocab_mask = torch.where(b["mask"], 0.0, float(NEGATIVE_INF_FILL_VALUE))
        logits = logits + vocab_mask.to(logits.dtype)[None, None, :]
        if cfg.learnable_bias:
            logits = logits + biases[None, None, :]
        if cfg.add_target_priors_to_bias:
            logits = logits + b["target_priors"][None, None, :]
        return logits

    def _logit_offset(self, b, biases):
        """The chunked route's additive logit terms in f32, in the order
        ``engine.py:427-435`` adds them: the vocab mask, the learnable bias,
        the priors."""
        cfg = self.cfg
        offset = torch.where(b["mask"], 0.0, float(NEGATIVE_INF_FILL_VALUE)).float()
        if cfg.learnable_bias:
            offset = offset + biases.float()
        if cfg.add_target_priors_to_bias:
            offset = offset + b["target_priors"].float()
        return offset

    def _headless(self, b, emb_in, emb_out):
        """(final hidden states, head weights) of the spliced backbone
        (``engine.py:408-425``): the predicted output table when the head is
        untied, else the input table."""
        hidden = self.headless(b["input_ids"].long(), b["attention_mask"], emb_in)
        head_w = emb_out if (not self.out_tied and emb_out is not None) else emb_in
        return hidden, head_w

    def _train_loss(self, b):
        cfg = self.cfg
        hn_cfg = self.hn_config
        src_in, src_out = self._split_source()
        emb_in, emb_out, biases = self._embeddings(b, not cfg.run_backbone_in_training_mode)
        if self.cfg.loss_chunk_size > 0:
            hidden, head_w = self._headless(b, emb_in, emb_out)
            args = (hidden, head_w, self._logit_offset(b, biases), b["labels"],
                    b["attention_mask"], cfg.loss_chunk_size)
            loss = (chunked_clm_loss(*args) if cfg.loss == "clm"
                    else chunked_mlm_loss(*args, head_fn=self.mlm_head))
        else:
            logits = self._logits(b, emb_in, emb_out, biases)
            loss = lm_loss(logits.float(), b["labels"], b["attention_mask"], cfg.loss)
        if hn_cfg.embed_using_source_embeddings and cfg.lexical_loss_weight > 0:
            sf = b["target_surface_forms"].long()
            target_in = self._source_rows(src_in, sf[:, 0])
            target_out = self._source_rows(src_out, sf[:, 0]) if src_out is not None else None
            overlap = (sf[:, 1:] == self.hn_pad_token_id).all(dim=1)
            lex = lexical_loss(emb_in, emb_out, target_in, target_out, overlap,
                               cfg.lexical_loss_kind)
            return loss + lex * cfg.lexical_loss_weight, lex, overlap.float().mean()
        return loss, None, None

    def _identity_loss(self, b):
        src_in, src_out = self._split_source()
        if src_in is None:
            raise ValueError("the identity step regresses onto the source table, which the "
                             "passthrough hypernet's state does not keep (JAX fails at "
                             "jnp.take of None); set identity_steps to 0")
        emb_in, emb_out, _ = self._hypernet(b, deterministic=True)
        # JAX takes the rows with jnp.take, which fills ids past the table
        # with NaN (ROADMAP C.7): the port clamps them as the lexical
        # loss's gather does
        ids = b["ids_to_embed"].long()
        in_loss = torch.square(emb_in - self._source_rows(src_in, ids)).sum(-1).mean()
        if src_out is not None and emb_out is not None:
            out_loss = torch.square(emb_out - self._source_rows(src_out, ids)).sum(-1).mean()
            return (in_loss + out_loss) / 2.0
        return in_loss

    def _apply_gradients(self, loss) -> None:
        for p in self.params.values():
            p.grad = None
        loss.backward()
        self.last_grads = {path: p.grad for path, p in self.params.items()}
        self.optimizer.step(self.last_grads)
        self.state.step += 1

    def _lr_metric(self) -> float:
        return float(self.random_lr_fn(self.state.step // self.cfg.gradient_accumulation_steps))

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        return self._train_step(self._device_batch(batch))

    def identity_train_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        return self._identity_train_step(self._device_batch(batch))

    def _train_step(self, b: Dict[str, torch.Tensor]) -> Dict[str, float]:
        lr = self._lr_metric()
        loss, lex, overlap = self._train_loss(b)
        self._apply_gradients(loss)
        return {
            "loss": float(loss.detach()),
            "lexical_loss": float(lex.detach()) if lex is not None else 0.0,
            "mean_lexical_overlap": float(overlap.detach()) if overlap is not None else 0.0,
            "learning_rate": lr,
        }

    def _identity_train_step(self, b: Dict[str, torch.Tensor]) -> Dict[str, float]:
        lr = self._lr_metric()
        loss = self._identity_loss(b)
        self._apply_gradients(loss)
        return {"identity_loss": float(loss.detach()), "learning_rate": lr}

    # ------------------------------------------------------------------- eval
    @torch.no_grad()
    def compute_embeddings(self, b):
        """The eval's embeddings of a device batch (``engine.py:615-620``):
        the hypernet's inference route, or, with
        ``run_backbone_in_training_mode``, its dropout route from a copy of
        the step generator's state (the state does not advance)."""
        deterministic = not self.cfg.run_backbone_in_training_mode
        generator = None
        if not deterministic:
            generator = torch.Generator()
            generator.set_state(self.state.dropout_generator.get_state())
        return self._embeddings(b, deterministic, inference=deterministic, generator=generator)

    def eval_metrics_from_logits(self, logits, b) -> Dict[str, torch.Tensor]:
        """``engine.py:589-597``: the CLM loss and bits-per-byte term, or the
        MLM loss and accuracy."""
        logits = logits.float()
        if self.cfg.loss == "clm":
            loss, bpb = lm_loss(logits, b["labels"], b["attention_mask"], "clm",
                                byte_lengths=b["byte_lengths"], with_bpb=True)
            return {"eval_loss": loss, "eval_bpb": bpb}
        loss = lm_loss(logits, b["labels"], b["attention_mask"], "mlm")
        return {"eval_loss": loss,
                "eval_accuracy": mlm_accuracy(logits, b["labels"], b["attention_mask"])}

    @torch.no_grad()
    def eval_step(self, b) -> Dict[str, torch.Tensor]:
        """Eval metrics of a device batch (``engine.py:575-587``)."""
        return self.eval_step_cached(b, *self.compute_embeddings(b))

    @torch.no_grad()
    def eval_step_cached(self, b, emb_in, emb_out, biases) -> Dict[str, torch.Tensor]:
        """Eval metrics with precomputed embeddings (``engine.py:604-613``);
        with ``loss_chunk_size``, chunk by chunk from the final hidden states
        (``chunked_eval_metrics``, ``engine.py:476-493``)."""
        cfg = self.cfg
        if cfg.loss_chunk_size > 0:
            hidden, head_w = self._headless(b, emb_in, emb_out)
            offset = self._logit_offset(b, biases)
            if cfg.loss == "clm":
                loss, bpb = chunked_clm_eval(hidden, head_w, offset, b["labels"],
                                             b["attention_mask"], b["byte_lengths"],
                                             cfg.loss_chunk_size)
                return {"eval_loss": loss, "eval_bpb": bpb}
            loss, acc = chunked_mlm_eval(hidden, head_w, offset, b["labels"],
                                         b["attention_mask"], cfg.loss_chunk_size,
                                         head_fn=self.mlm_head)
            return {"eval_loss": loss, "eval_accuracy": acc}
        return self.eval_metrics_from_logits(self._logits(b, emb_in, emb_out, biases), b)

    # ------------------------------------------------------------------- loop
    def fit(self, batch_iterator: Iterator[Dict[str, Any]],
            identity_iterator: Optional[Iterator[Dict[str, Any]]] = None,
            eval_fn: Optional[Callable[["Trainer"], Dict[str, float]]] = None,
            on_log: Optional[Callable[[int, Dict[str, float]], None]] = None,
            resume_step: int = 0, preempt_signal: Optional[int] = None):
        """``engine.py:653-804`` on one process. Steps before
        ``resume_step`` pull and drop their batches, so a run restored from
        a checkpoint of step ``resume_step`` sees the data stream where the
        checkpoint left it. With ``prefetch_batches``
        > 0 a thread pulls the next batches and copies them to the device
        while a step runs. Every ``eval_steps`` steps, ``eval_fn(self)``'s
        metrics join the history and go to ``on_log`` as a row of their
        own. With ``preempt_signal`` (a signal number) the signal sets a
        flag; at the next step boundary the loop writes a full-state
        checkpoint to ``<output_dir>/preempt_step_<N>``, appends
        ``{"step": N, "preempted": 1.0}`` to the history and returns; the
        previous handler is restored on the way out.

        Records, per micro step, in ``self.records``: ``collate_ms`` (the
        host pull of its batch, on the prefetch thread when there is one),
        ``wait_ms`` (the time the loop waited for the batch: the inline pull
        and copy, or the block on the prefetch queue), ``host_ms`` (the
        step's call), ``loop_ms`` (the loop's wall time since the previous
        step ended: logging, saves and evals included) and, on the card,
        ``device_ms`` (the step on the device's clock, CUDA events)."""
        cfg = self.cfg
        k = cfg.gradient_accumulation_steps
        history = []
        running: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        t0 = time.time()
        cuda = self.device.type == "cuda"

        def track(key: str, value: float):
            running[key] = running.get(key, 0.0) + value
            counts[key] = counts.get(key, 0) + 1

        def host_stream():
            for micro_step in range(cfg.steps * k):
                step = micro_step // k
                use_identity = step < cfg.identity_steps and identity_iterator is not None
                source = identity_iterator if use_identity else batch_iterator
                if step < resume_step:
                    next(source)
                    continue
                t_collate = time.perf_counter()
                batch = next(source)
                yield micro_step, use_identity, (time.perf_counter() - t_collate) * 1e3, batch

        self._preempted = False
        prev_handler = None
        if preempt_signal is not None:
            def on_preempt(signum, frame):
                self._preempted = True

            prev_handler = signal.signal(preempt_signal, on_preempt)
        stream = None
        try:
            if cfg.prefetch_batches > 0:
                stream = BatchPrefetcher(host_stream(), self._device_batch, self.device,
                                         depth=cfg.prefetch_batches)
            else:
                stream = ((*head, batch, self._device_batch(batch))
                          for *head, batch in host_stream())
            t_prev = time.perf_counter()
            while True:
                t_wait = time.perf_counter()
                item = next(stream, None)
                if item is None:
                    break
                micro_step, use_identity, collate_ms, batch, b = item
                wait_ms = (time.perf_counter() - t_wait) * 1e3
                step = micro_step // k
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                t_step = time.perf_counter()
                if use_identity:
                    metrics = self._identity_train_step(b)
                else:
                    metrics = self._train_step(b)
                    self.last_train_batch = batch
                record = {"kind": "identity" if use_identity else "train",
                          "collate_ms": collate_ms, "wait_ms": wait_ms,
                          "host_ms": (time.perf_counter() - t_step) * 1e3}
                if cuda:
                    end.record()
                    end.synchronize()
                    record["device_ms"] = start.elapsed_time(end)
                t_now = time.perf_counter()
                record["loop_ms"] = (t_now - t_prev) * 1e3
                t_prev = t_now
                self.records.append(record)
                for key, v in metrics.items():
                    track(key, v)
                lang = batch.get("lang_code") if isinstance(batch, dict) else None
                if lang is not None:
                    if "loss" in metrics:
                        track(f"{lang}_loss", metrics["loss"])
                    if "attention_mask" in batch:
                        track(f"{lang}_pad_ratio",
                              float((np.asarray(batch["attention_mask"]) == 0).mean()))
                    for name, value in (batch.get("metrics") or {}).items():
                        track(f"{lang}_{name}", float(value))

                is_boundary = (micro_step + 1) % k == 0
                if is_boundary and (step + 1) % cfg.logging_steps == 0:
                    logged = {key: v / counts[key] for key, v in running.items()}
                    logged["time"] = time.time() - t0
                    logged["step"] = step + 1
                    history.append(logged)
                    if on_log is not None:
                        on_log(step + 1, logged)
                    running, counts = {}, {}
                if is_boundary and cfg.save_steps and (step + 1) % cfg.save_steps == 0:
                    self.save_checkpoint(os.path.join(cfg.output_dir, f"step_{step + 1}"),
                                         full_state=cfg.save_state)
                if is_boundary and eval_fn is not None and cfg.eval_steps \
                        and (step + 1) % cfg.eval_steps == 0:
                    evald = {"step": step + 1, **eval_fn(self)}
                    history.append(evald)
                    if on_log is not None:
                        on_log(step + 1, evald)
                if is_boundary and self._preempted:
                    # one process: act on the local flag at every boundary
                    # (engine.py:813-826); the multihost agreement waits for
                    # multi-GPU
                    self.save_checkpoint(
                        os.path.join(cfg.output_dir, f"preempt_step_{step + 1}"),
                        full_state=True)
                    history.append({"step": step + 1, "preempted": 1.0})
                    break
        finally:
            if isinstance(stream, BatchPrefetcher):
                stream.close()
            if preempt_signal is not None:
                signal.signal(preempt_signal, prev_handler)
        return history

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, path: str, tokenizer=None, full_state: bool = False) -> None:
        """The hypernet's parameters in the transfer CLI's checkpoint format:
        ``hn_config.json`` (HypernetConfig fields + "dtype"), ``params.npz``
        (Flax paths joined by "/") and, when given, ``tokenizer.json``. With
        ``full_state`` (``engine.py:842-875``) also ``resume/``:
        ``state.npz`` (the optimizer state under "<slot>/<Flax path>", and
        the dropout generator's state under "dropout_generator") and
        ``state.json`` (the micro step, the optimizer's name and update
        count), and under full fine-tuning the backbone's parameters under
        "inner/<Flax path>"; full state is taken at a step boundary. The
        parameters written are the hypernet's (the passthrough tables),
        never the backbone's, as in JAX."""
        scalars = {"step": self.state.step, **self.optimizer.scalars()} if full_state else None
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "params.npz"), **torch_to_flax(self.hypernet))
        with open(os.path.join(path, "hn_config.json"), "w") as f:
            json.dump({**self.hn_config.to_dict(), "dtype": self.cfg.dtype}, f, indent=2)
        if tokenizer is not None:
            # compact: a pretty dump of a 250k-piece vocab runs the json
            # module's pure-Python encoder for seconds
            tokenizer.save(os.path.join(path, "tokenizer.json"), pretty=False)
        if full_state:
            resume = os.path.join(path, "resume")
            os.makedirs(resume, exist_ok=True)
            # bf16 state goes to f32, which holds it exactly
            arrays = {k: t.detach().float().cpu().numpy()
                      for k, t in self.optimizer.state_arrays().items()}
            arrays.update(self._inner_arrays())
            arrays["dropout_generator"] = self.state.dropout_generator.get_state().numpy()
            np.savez(os.path.join(resume, "state.npz"), **arrays)
            with open(os.path.join(resume, "state.json"), "w") as f:
                json.dump(scalars, f, indent=2)

    def _inner_arrays(self) -> Dict[str, np.ndarray]:
        """Under full fine-tuning, the backbone's parameters under
        "inner/<Flax path>" in the Flax layout (``engine.py:867-868``);
        nothing when the backbone is frozen."""
        if self.cfg.backbone_training != "full":
            return {}
        out = {}
        for path, p in self.params.items():
            if path[0] == "inner":
                t = p.detach().float().cpu()
                out["/".join(path)] = (t.t() if path in self.transposed else t).contiguous().numpy()
        return out

    @torch.no_grad()
    def _load_inner(self, arrays: Dict[str, np.ndarray]) -> None:
        """Inverse of ``_inner_arrays`` (``engine.py:909-917``): pops the
        "inner/..." arrays and copies each into its parameter."""
        inner = {k: arrays.pop(k) for k in [k for k in arrays if k.startswith("inner/")]}
        if self.cfg.backbone_training != "full":
            return
        for path, p in self.params.items():
            if path[0] != "inner":
                continue
            key = "/".join(path)
            if key not in inner:
                raise KeyError(f"full fine-tuning state: {key} missing from the checkpoint")
            t = torch.from_numpy(np.asarray(inner[key]))
            p.copy_(t.t() if path in self.transposed else t)

    def restore_checkpoint(self, path: str, reset_steps: bool = False) -> int:
        """The hypernet's parameters from ``path`` always; the optimizer
        state, micro step and dropout generator (and a fine-tuned backbone)
        too where ``path/resume`` exists and not ``reset_steps``
        (``engine.py:877-923``). Returns the
        micro step the run goes on from."""
        with np.load(os.path.join(path, "params.npz")) as z:
            params = {k: z[k] for k in z.files}
        self.hypernet.load_state_dict(flax_to_torch(params), strict=True)
        resume = os.path.join(path, "resume")
        if os.path.isdir(resume) and not reset_steps:
            with open(os.path.join(resume, "state.json")) as f:
                scalars = json.load(f)
            with np.load(os.path.join(resume, "state.npz")) as z:
                arrays = {k: z[k] for k in z.files}
            self.state.dropout_generator.set_state(
                torch.from_numpy(arrays.pop("dropout_generator")))
            self._load_inner(arrays)
            self.optimizer.load_state(arrays, scalars)
            self.state.step = int(scalars["step"])
        return self.state.step
