"""The training engine (counterpart of ``zett_tpu/training/engine.py``):
state init, the train, identity and eval steps, and the loop with logging
and in-training eval.

One train step (``engine.py:500-543``): the hypernet predicts the
embeddings of the batch's vocab rows on its training route (kernels 2 and
3 for every attention core); the source model's special-token rows are
spliced in; the frozen GPT-2 runs with the predicted table as its tied
embeddings; the loss is the CLM loss plus the weighted lexical loss; the
gradients of every parameter, the frozen backbone's included, go through
the optimizer (``optimizer.py``), which updates the hypernet only. The
identity step (``engine.py:545-573``) regresses the predicted embeddings of
sampled source tokens onto their source embeddings. Eval
(``engine.py:575-620``) predicts the batch's embeddings on the hypernet's
inference route without gradients (``compute_embeddings``: kernel 1, 4 or 2
per layer as the configuration routes it) and reports the CLM loss and the
bits-per-byte term (``eval_step``); a fixed tokenizer's embeddings are
computed once and reused across batches (``eval_step_cached``,
``evaluation/loop.py``).

Not ported: full-state checkpoints and resume, the prefetch thread,
the preemption hook, remat and chunked losses, MLM, backbones other than
GPT-2, full backbone fine-tuning, multi-GPU. Saving writes the hypernet's
parameters in the transfer CLI's checkpoint format (``save_checkpoint``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..constants import NEGATIVE_INF_FILL_VALUE
from ..models.backbones.gpt2 import GPT2Config, GPT2LMHeadModel
from ..models.backbones.registry import resolve_out_path
from ..models.convert import flax_paths, flax_to_torch, torch_to_flax
from ..models.hypernet import Hypernet, HypernetConfig
from ..models.splice import extract_embeddings
from .losses import lexical_loss, lm_loss
from .optimizer import AdamW
from .schedules import create_learning_rate_fn
from .state import TrainState

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def gpt2_flax_path(key: str) -> tuple:
    """HF GPT-2 key -> the JAX package's Flax path (``loader.convert_gpt2``):
    the optimizer's labels, decay mask and leaf order read these."""
    parts = key.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}
    if parts[1] in ("wte", "wpe"):
        return ("transformer", parts[1], "embedding")
    if parts[1] == "ln_f":
        return ("transformer", "ln_f", "scale" if parts[2] == "weight" else "bias")
    base = ("transformer", f"h_{parts[2]}")
    rest = parts[3:]
    if rest[0] in ("ln_1", "ln_2"):
        return base + (rest[0], "scale" if rest[1] == "weight" else "bias")
    if rest[0] == "attn":
        return base + ("attn", rest[1], leaf[rest[2]])
    return base + (rest[1], leaf[rest[2]])  # mlp.c_fc / mlp.c_proj


class Trainer:
    def __init__(
        self,
        *,
        hn_config: HypernetConfig,
        backbone_config: GPT2Config,
        backbone_state: Dict[str, torch.Tensor],
        model_type: str,
        train_config,
        device,
        hn_pad_token_id: int = 0,
        hn_params: Optional[Dict[str, np.ndarray]] = None,
    ):
        cfg = train_config
        unported = {
            "backbone_training != 'no'": cfg.backbone_training != "no",
            "loss=mlm": cfg.loss != "clm",
            "loss_chunk_size": cfg.loss_chunk_size > 0,
            "remat_hypernet": cfg.remat_hypernet,
            "remat_backbone": cfg.remat_backbone,
            "use_adafactor": cfg.use_adafactor,
        }
        missing = [k for k, on in unported.items() if on]
        if missing:
            raise NotImplementedError(f"training options not ported: {', '.join(missing)}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.hn_pad_token_id = hn_pad_token_id

        source, original_vocab = extract_embeddings(backbone_state, model_type)
        self.source_embeddings = source.to(self.dtype).to(self.device)
        self.out_tied = resolve_out_path(model_type, backbone_state) is None
        if hn_config.embed_using_source_embeddings and hn_config.original_vocab_size == 0:
            hn_config = dataclasses.replace(hn_config, original_vocab_size=original_vocab)
        self.hn_config = hn_config

        # the frozen backbone is held in bf16 (engine.py:234-238)
        frozen = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32 else v)
                  for k, v in backbone_state.items()}
        self.backbone = GPT2LMHeadModel(backbone_config, frozen, self.dtype).to(self.device)
        self.hypernet = Hypernet(hn_config, dtype=self.dtype)
        if hn_params is not None:
            self.hypernet.load_state_dict(flax_to_torch(hn_params), strict=True)
        else:
            self.hypernet.init_weights(torch.Generator().manual_seed(cfg.seed))
        self.hypernet.to(self.device)

        # every parameter under its Flax path, as jax.value_and_grad sees
        # the state's params {"hypernet", "inner"}
        self.params: Dict[tuple, torch.nn.Parameter] = {}
        hn_paths = flax_paths(self.hypernet)
        for name, p in self.hypernet.named_parameters():
            self.params[("hypernet",) + hn_paths[name][0]] = p
        for key, p in self.backbone.named_hf_parameters():
            self.params[("inner",) + gpt2_flax_path(key)] = p

        self.random_lr_fn, _ = create_learning_rate_fn(cfg)
        self.optimizer = AdamW(self.params, cfg, self.random_lr_fn)
        self.state = TrainState(step=0,
                                dropout_generator=torch.Generator().manual_seed(cfg.seed + 1))
        self.last_grads: Dict[tuple, torch.Tensor] = {}
        self.records: List[Dict[str, Any]] = []
        self.last_train_batch: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ steps
    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            if k == "metrics" or not (hasattr(v, "shape") or isinstance(v, (int, float))):
                continue
            a = np.asarray(v)
            if a.dtype.kind not in "biuf":
                continue
            if a.dtype == np.float64:
                a = a.astype(np.float32)  # as jnp.asarray without x64
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return out

    def _split_source(self):
        n_embd = self.hn_config.n_embd
        src_in = self.source_embeddings[:, :n_embd]
        src_out = None if self.out_tied else self.source_embeddings[:, n_embd:]
        return src_in, src_out

    def _hypernet(self, b, deterministic: bool, inference: bool = False, generator=None):
        if generator is None and not deterministic:
            generator = self.state.dropout_generator
        return self.hypernet(
            b["target_surface_forms"], b.get("target_priors"), self.source_embeddings,
            b.get("lang_index"), deterministic=deterministic, inference=inference,
            generator=generator,
        )

    def _embeddings(self, b, deterministic: bool, inference: bool = False, generator=None):
        """The hypernet's predictions with the source model's special-token
        rows spliced in (``engine.py:348-368``)."""
        src_in, src_out = self._split_source()
        emb_in, emb_out, biases = self._hypernet(b, deterministic, inference, generator)
        special, special_ref = b["special_indices"].long(), b["special_indices_in_reference"].long()
        emb_in = emb_in.index_put((special,), src_in[special_ref].to(emb_in.dtype))
        if emb_out is not None and src_out is not None:
            emb_out = emb_out.index_put((special,), src_out[special_ref].to(emb_out.dtype))
        return emb_in, emb_out, biases

    def _logits(self, b, emb_in, emb_out, biases):
        """The frozen backbone with the predicted table, plus the vocab mask
        and the configured bias terms (``engine.py:370-385``)."""
        cfg = self.cfg
        logits = self.backbone(b["input_ids"].long(), b["attention_mask"], emb_in)
        vocab_mask = torch.where(b["mask"], 0.0, float(NEGATIVE_INF_FILL_VALUE))
        logits = logits + vocab_mask.to(logits.dtype)[None, None, :]
        if cfg.learnable_bias:
            logits = logits + biases[None, None, :]
        if cfg.add_target_priors_to_bias:
            logits = logits + b["target_priors"][None, None, :]
        return logits

    def _train_loss(self, b):
        cfg = self.cfg
        hn_cfg = self.hn_config
        src_in, src_out = self._split_source()
        emb_in, emb_out, biases = self._embeddings(b, not cfg.run_backbone_in_training_mode)
        logits = self._logits(b, emb_in, emb_out, biases)
        loss = lm_loss(logits.float(), b["labels"], b["attention_mask"], cfg.loss)
        if hn_cfg.embed_using_source_embeddings and cfg.lexical_loss_weight > 0:
            sf = b["target_surface_forms"].long()
            target_in = src_in[sf[:, 0]]
            target_out = src_out[sf[:, 0]] if src_out is not None else None
            overlap = (sf[:, 1:] == self.hn_pad_token_id).all(dim=1)
            lex = lexical_loss(emb_in, emb_out, target_in, target_out, overlap,
                               cfg.lexical_loss_kind)
            return loss + lex * cfg.lexical_loss_weight, lex, overlap.float().mean()
        return loss, None, None

    def _identity_loss(self, b):
        src_in, src_out = self._split_source()
        emb_in, emb_out, _ = self._hypernet(b, deterministic=True)
        ids = b["ids_to_embed"].long()
        in_loss = torch.square(emb_in - src_in[ids]).sum(-1).mean()
        if src_out is not None and emb_out is not None:
            out_loss = torch.square(emb_out - src_out[ids]).sum(-1).mean()
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
        b = self._device_batch(batch)
        lr = self._lr_metric()
        loss, lex, overlap = self._train_loss(b)
        self._apply_gradients(loss)
        return {
            "loss": float(loss.detach()),
            "lexical_loss": float(lex.detach()) if lex is not None else 0.0,
            "mean_lexical_overlap": float(overlap.detach()) if overlap is not None else 0.0,
            "learning_rate": lr,
        }

    def identity_train_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        b = self._device_batch(batch)
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
        """``engine.py:589-596``, CLM only."""
        loss, bpb = lm_loss(logits.float(), b["labels"], b["attention_mask"], "clm",
                            byte_lengths=b["byte_lengths"], with_bpb=True)
        return {"eval_loss": loss, "eval_bpb": bpb}

    @torch.no_grad()
    def eval_step(self, b) -> Dict[str, torch.Tensor]:
        """Eval metrics of a device batch (``engine.py:575-587``)."""
        return self.eval_metrics_from_logits(self._logits(b, *self.compute_embeddings(b)), b)

    @torch.no_grad()
    def eval_step_cached(self, b, emb_in, emb_out, biases) -> Dict[str, torch.Tensor]:
        """Eval metrics with precomputed embeddings (``engine.py:604-613``)."""
        return self.eval_metrics_from_logits(self._logits(b, emb_in, emb_out, biases), b)

    # ------------------------------------------------------------------- loop
    def fit(self, batch_iterator: Iterator[Dict[str, Any]],
            identity_iterator: Optional[Iterator[Dict[str, Any]]] = None,
            eval_fn: Optional[Callable[["Trainer"], Dict[str, float]]] = None,
            on_log: Optional[Callable[[int, Dict[str, float]], None]] = None):
        """``engine.py:653-804`` without replay resume, prefetch and
        preemption. Records, per micro step, the host time to collate its
        batch and the step's time on the device's clock (CUDA events) in
        ``self.records``. Every ``eval_steps`` steps, ``eval_fn(self)``'s
        metrics join the history and go to ``on_log`` as a row of their
        own."""
        cfg = self.cfg
        history = []
        running: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        t0 = time.time()
        cuda = self.device.type == "cuda"

        def track(key: str, value: float):
            running[key] = running.get(key, 0.0) + value
            counts[key] = counts.get(key, 0) + 1

        for micro_step in range(cfg.steps * cfg.gradient_accumulation_steps):
            step = micro_step // cfg.gradient_accumulation_steps
            use_identity = step < cfg.identity_steps and identity_iterator is not None
            t_collate = time.perf_counter()
            batch = next(identity_iterator if use_identity else batch_iterator)
            collate_ms = (time.perf_counter() - t_collate) * 1e3
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            t_step = time.perf_counter()
            if use_identity:
                metrics = self.identity_train_step(batch)
            else:
                metrics = self.train_step(batch)
                self.last_train_batch = batch
            record = {"kind": "identity" if use_identity else "train",
                      "collate_ms": collate_ms,
                      "host_ms": (time.perf_counter() - t_step) * 1e3}
            if cuda:
                end.record()
                end.synchronize()
                record["device_ms"] = start.elapsed_time(end)
            self.records.append(record)
            for k, v in metrics.items():
                track(k, v)
            lang = batch.get("lang_code") if isinstance(batch, dict) else None
            if lang is not None:
                if "loss" in metrics:
                    track(f"{lang}_loss", metrics["loss"])
                if "attention_mask" in batch:
                    track(f"{lang}_pad_ratio",
                          float((np.asarray(batch["attention_mask"]) == 0).mean()))
                for name, value in (batch.get("metrics") or {}).items():
                    track(f"{lang}_{name}", float(value))

            is_boundary = (micro_step + 1) % cfg.gradient_accumulation_steps == 0
            if is_boundary and (step + 1) % cfg.logging_steps == 0:
                logged = {k: v / counts[k] for k, v in running.items()}
                logged["time"] = time.time() - t0
                logged["step"] = step + 1
                history.append(logged)
                if on_log is not None:
                    on_log(step + 1, logged)
                running, counts = {}, {}
            if is_boundary and cfg.save_steps and (step + 1) % cfg.save_steps == 0:
                self.save_checkpoint(os.path.join(cfg.output_dir, f"step_{step + 1}"))
            if is_boundary and eval_fn is not None and cfg.eval_steps \
                    and (step + 1) % cfg.eval_steps == 0:
                evald = {"step": step + 1, **eval_fn(self)}
                history.append(evald)
                if on_log is not None:
                    on_log(step + 1, evald)
        return history

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, path: str, tokenizer=None) -> None:
        """The hypernet's parameters in the transfer CLI's checkpoint format:
        ``hn_config.json`` (HypernetConfig fields + "dtype"), ``params.npz``
        (Flax paths joined by "/") and, when given, ``tokenizer.json``."""
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "params.npz"), **torch_to_flax(self.hypernet))
        with open(os.path.join(path, "hn_config.json"), "w") as f:
            json.dump({**self.hn_config.to_dict(), "dtype": self.cfg.dtype}, f, indent=2)
        if tokenizer is not None:
            tokenizer.save(os.path.join(path, "tokenizer.json"))
