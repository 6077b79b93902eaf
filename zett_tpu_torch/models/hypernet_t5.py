"""The T5-compat hypernet encoder (``encoder_type="t5"``), in PyTorch.

Counterpart of ``zett_tpu/models/hypernet_t5.py``: it holds the reference's
``hn_model_type="t5"`` checkpoints numerically, in place of the roberta
encoder (``hypernet.HypernetEncoder``), with the same call:

- pre-LN blocks with ``T5LayerNorm`` (RMS: no mean subtraction, no bias,
  variance in f32);
- bias-free q/k/v/o projections and UNSCALED attention scores;
- the relative attention bias computed in block 0 (HF T5's bucketing, no
  epsilon: ``relative_position_bucket(..., eps=0.0)``) with the additive key
  mask folded in, and reused by the later blocks;
- the feed-forward: relu, or gated tanh-gelu (``hidden_act="gated-gelu"``);
- the prior token divided by log(1e-12) before its projection;
- the T5-style inter-token exchange: pre-norm on the token states, a
  residual ``inter_token_ln2`` on the blocks, and the UP attention reads
  each row's first position only, one update broadcast over the row;
- a final RMS LayerNorm.

No kernel is involved on either route, as in the JAX package: forward and
backward are PyTorch ops. Dropout (attention weights, the feed-forward's
activation, each block's feed-forward output and the final states) follows
flax's ``nn.Dropout`` with masks from the caller's generator. Language ids
and adapters are not implemented for this type upstream and are ignored,
as in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.encoder_layer import gelu
from .hypernet import Dense, HypernetConfig, dropout, relative_position_bucket

PRIOR_NORMALIZATION = math.log(1e-12)  # the reference stack's prior normalization constant


class T5LayerNorm(nn.Module):
    """RMS norm: x / sqrt(mean(x^2) + eps) in f32, times the weight, cast."""

    def __init__(self, dim: int, eps: float, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        return (self.weight.float() * (xf / torch.sqrt(var + self.eps))).to(self.dtype)


class T5Attention(nn.Module):
    """Bias-free multi-head attention with unscaled scores and an optional
    additive position bias (HF FlaxT5Attention; hypernet_t5.py:70-134)."""

    def __init__(self, cfg: HypernetConfig, dtype, has_relative_attention_bias: bool = False):
        super().__init__()
        H = cfg.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.q = Dense(H, H, dtype, bias=False)
        self.k = Dense(H, H, dtype, bias=False)
        self.v = Dense(H, H, dtype, bias=False)
        self.o = Dense(H, H, dtype, bias=False)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_attention_heads)

    def forward(self, hidden, attention_mask_bias=None, position_bias=None,
                key_value_states=None, deterministic: bool = True, generator=None):
        """Returns (output, the position bias the next blocks reuse):
        block 0 makes it from its table and the (B, 1, 1, Lk) mask bias."""
        cfg = self.cfg
        dt = self.dtype
        nh = cfg.num_attention_heads
        kv = key_value_states if key_value_states is not None else hidden
        q, k, v = self.q(hidden), self.k(kv), self.v(kv)
        B, Lq, H = q.shape
        Lk = k.shape[1]
        d = H // nh
        q, k, v = (t.reshape(B, -1, nh, d) for t in (q, k, v))
        if position_bias is None and hasattr(self, "relative_attention_bias"):
            offsets = torch.arange(Lk)[None, :] - torch.arange(Lq)[:, None]
            buckets = relative_position_bucket(offsets, cfg.relative_attention_num_buckets,
                                               cfg.relative_attention_max_distance, eps=0.0)
            table = self.relative_attention_bias.weight.to(dt)
            position_bias = table[buckets.to(table.device)].permute(2, 0, 1)[None]
            if attention_mask_bias is not None:
                position_bias = position_bias + attention_mask_bias
        elif position_bias is None:
            position_bias = attention_mask_bias
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).to(dt)
        if position_bias is not None:
            scores = scores + position_bias.to(dt)
        weights = torch.softmax(scores.float(), dim=-1).to(dt)
        if not deterministic and cfg.attention_dropout_prob > 0.0:
            weights = dropout(weights, cfg.attention_dropout_prob, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float()).to(dt)
        return self.o(out.reshape(B, Lq, H)), position_bias


class T5FF(nn.Module):
    """DenseReluDense: relu, or gated tanh-gelu for ``hidden_act="gated-gelu"``."""

    def __init__(self, cfg: HypernetConfig, dtype):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.cfg = cfg
        self.gated = cfg.hidden_act == "gated-gelu"
        if self.gated:
            self.wi_0 = Dense(H, I, dtype, bias=False)
            self.wi_1 = Dense(H, I, dtype, bias=False)
        else:
            self.wi = Dense(H, I, dtype, bias=False)
        self.wo = Dense(I, H, dtype, bias=False)

    def forward(self, x, deterministic: bool = True, generator=None):
        if self.gated:
            h = gelu(self.wi_0(x)) * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        if not deterministic and self.cfg.hidden_dropout_prob > 0.0:
            h = dropout(h, self.cfg.hidden_dropout_prob, generator)
        return self.wo(h)


class T5Block(nn.Module):
    def __init__(self, cfg: HypernetConfig, dtype, has_relative_attention_bias: bool = False):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.cfg = cfg
        self.attn_ln = T5LayerNorm(H, eps, dtype)
        self.attention = T5Attention(cfg, dtype, has_relative_attention_bias)
        if cfg.add_inter_token_attention:
            self.inter_token_ln1 = T5LayerNorm(H, eps, dtype)
            self.inter_token_down = T5Attention(cfg, dtype)
            self.inter_token_ln2 = T5LayerNorm(H, eps, dtype)
            self.inter_token_up = T5Attention(cfg, dtype)
        self.ff_ln = T5LayerNorm(H, eps, dtype)
        self.ff = T5FF(cfg, dtype)

    def forward(self, hidden, attention_mask_bias, position_bias, target_priors=None,
                inter_token_blocks=None, deterministic: bool = True, generator=None):
        """hypernet_t5.py:160-212: (output, the position bias)."""
        cfg = self.cfg
        attn, position_bias = self.attention(
            self.attn_ln(hidden), attention_mask_bias=attention_mask_bias,
            position_bias=position_bias, deterministic=deterministic, generator=generator)
        hidden = hidden + attn
        if cfg.add_inter_token_attention:
            bias = None
            if cfg.inter_token_attention_bias_by_priors:
                bias = target_priors[None] * cfg.inter_token_attention_bias_scaler
            normed = self.inter_token_ln1(hidden)
            blocks_attn, _ = self.inter_token_down(
                inter_token_blocks[None], position_bias=bias,
                key_value_states=normed[None, :, 0], deterministic=deterministic,
                generator=generator)
            blocks = self.inter_token_ln2(inter_token_blocks + blocks_attn[0])
            up, _ = self.inter_token_up(normed[None, :, 0], key_value_states=blocks[None],
                                        deterministic=deterministic, generator=generator)
            # one update per token row, broadcast over its positions
            hidden = hidden + up[0][:, None, :]
        ff = self.ff(self.ff_ln(hidden), deterministic=deterministic, generator=generator)
        if not deterministic and cfg.hidden_dropout_prob > 0.0:
            ff = dropout(ff, cfg.hidden_dropout_prob, generator)
        return hidden + ff, position_bias


class T5CompatEncoder(nn.Module):
    """Drop-in for ``HypernetEncoder`` holding hn_model_type="t5" weights
    (hypernet_t5.py:215-286)."""

    def __init__(self, cfg: HypernetConfig, dtype):
        super().__init__()
        H = cfg.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        if not cfg.embed_using_source_embeddings:
            self.word_embeddings = nn.Embedding(cfg.vocab_size, H)
        if cfg.embed_target_priors:
            self.prior_projection = Dense(1, H, dtype)
        if cfg.add_inter_token_attention:
            self.inter_token_blocks = nn.Parameter(
                torch.zeros(cfg.n_inter_token_blocks, H, dtype=dtype))
        self.layers = nn.ModuleList(T5Block(cfg, dtype, has_relative_attention_bias=i == 0)
                                    for i in range(cfg.num_hidden_layers))
        self.final_ln = T5LayerNorm(H, cfg.layer_norm_eps, dtype)

    def forward(self, input_ids, attention_mask, inputs_embeds=None, target_priors=None,
                lang_index=None, inference: bool = True, deterministic: bool = True,
                generator=None):
        """``inference`` picks nothing here: the encoder has no kernel route."""
        cfg = self.cfg
        dt = self.dtype
        if inputs_embeds is None:
            inputs_embeds = F.embedding(input_ids, self.word_embeddings.weight.to(dt))
        hidden = inputs_embeds
        if cfg.embed_target_priors:
            prior_tok = self.prior_projection(target_priors[..., None].float()
                                              / PRIOR_NORMALIZATION)
            hidden = torch.cat([hidden, prior_tok[:, None, :].to(hidden.dtype)], dim=1)
            attention_mask = torch.cat(
                [attention_mask, attention_mask.new_ones(hidden.shape[0], 1)], dim=1)
        mask_bias = torch.where(attention_mask[:, None, None, :].bool(),
                                torch.zeros((), dtype=dt, device=hidden.device),
                                torch.tensor(torch.finfo(dt).min, dtype=dt, device=hidden.device))
        blocks = self.inter_token_blocks if cfg.add_inter_token_attention else None
        position_bias = None
        for layer in self.layers:
            hidden, position_bias = layer(hidden, mask_bias, position_bias,
                                          target_priors=target_priors,
                                          inter_token_blocks=blocks,
                                          deterministic=deterministic, generator=generator)
        hidden = self.final_ln(hidden)
        if not deterministic and cfg.hidden_dropout_prob > 0.0:
            hidden = dropout(hidden, cfg.hidden_dropout_prob, generator)
        return hidden
