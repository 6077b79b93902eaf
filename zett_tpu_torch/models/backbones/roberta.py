"""The (XLM-)RoBERTa masked-LM encoder with its word embeddings passed in
(counterpart of ``zett_tpu/models/backbones/roberta.py``).

``RobertaForMaskedLM.forward(input_ids, attention_mask, word_embeddings,
lm_head_bias=None)`` embeds with ``word_embeddings``, runs the post-LN
layers and the MLM head, and returns ``head(hidden) @ word_embeddings.T``
(the decoder is tied to the input table), plus ``lm_head_bias`` where one
is given: the training step splices the hypernet's predicted table in and
no bias (the JAX splice zeroes it, ``engine.py:370-375``);
``mlm_logits`` uses the model's own table and bias. ``hidden_states`` is
the headless model, ``lm_head_transform`` the head before its decoder
(dense, erf gelu, LayerNorm): the chunked MLM loss runs it chunk by chunk.
Weights are the HF state dict's, held as parameters in their stored dtype
and cast to the compute dtype at use, as flax promotes them (the
LayerNorms take theirs as held, as ``gpt2.py`` does).

The arithmetic follows the JAX module (``roberta.py:50-130``): position
ids from the ids, not the mask (``cumsum(not_pad) * not_pad +
pad_token_id``), one token type, the embeddings' LayerNorm; scores
accumulated and scaled in f32 with an additive ``finfo(f32).min`` padding
bias, an f32 softmax whose weights are cast to the compute dtype; post-LN
residuals; erf gelu. These are library ops (cuBLAS on the card), as they are
XLA in the JAX package. With ``remat_blocks`` each layer runs under
``torch.utils.checkpoint`` when gradients are on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.encoder_layer import layer_norm_flax_exact
from ..hypernet import gelu_exact
from .units import BlockModel

FAMILY = ("roberta", "xlm-roberta")
WORD_EMBEDDINGS = "roberta.embeddings.word_embeddings.weight"
# HF writes the lm-head bias twice, tied: the head's and its decoder's
BIAS_KEYS = ("lm_head.bias", "lm_head.decoder.bias")


@dataclass
class RobertaConfig:
    vocab_size: int = 250002
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    remat_blocks: bool = False
    pad_token_id: int = 1
    tie_word_embeddings: bool = True

    @classmethod
    def from_hf(cls, hf: dict) -> "RobertaConfig":
        """From a ``config.json`` dict (``RobertaConfig.from_hf``)."""
        return cls(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            max_position_embeddings=hf["max_position_embeddings"],
            type_vocab_size=hf.get("type_vocab_size", 1),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
            pad_token_id=hf.get("pad_token_id", 1),
        )


_LAYER = ("attention.self.query", "attention.self.key", "attention.self.value",
          "attention.output.dense", "attention.output.LayerNorm", "intermediate.dense",
          "output.dense", "output.LayerNorm")


def _layer_keys(i: int):
    return [f"roberta.encoder.layer.{i}.{m}.{leaf}" for m in _LAYER for leaf in ("weight", "bias")]


def weight_keys(config: RobertaConfig):
    """The HF keys the model holds: those ``loader.convert_roberta`` keeps,
    with the tied decoder's weight and bias left out (the word table and
    ``lm_head.bias`` stand for them)."""
    keys = [WORD_EMBEDDINGS, "roberta.embeddings.position_embeddings.weight",
            "roberta.embeddings.token_type_embeddings.weight",
            "roberta.embeddings.LayerNorm.weight", "roberta.embeddings.LayerNorm.bias"]
    for i in range(config.num_hidden_layers):
        keys += _layer_keys(i)
    keys += ["lm_head.dense.weight", "lm_head.dense.bias", "lm_head.layer_norm.weight",
             "lm_head.layer_norm.bias", "lm_head.bias"]
    return keys


class RobertaForMaskedLM(BlockModel):
    def __init__(self, config: RobertaConfig, state_dict: Dict[str, torch.Tensor], dtype):
        super().__init__()
        self.config = config
        self.dtype = dtype
        # the layers ``roberta.encoder.layer.N`` in units of their own
        # (units.py)
        self._hold(weight_keys(config), [_layer_keys(i) for i in range(config.num_hidden_layers)],
                   state_dict, self._layer)

    def _ln(self, x, prefix):
        # flax LayerNorm without a dtype: f32 statistics, the parameters as
        # held, output in the promoted dtype of x and the parameters
        scale, bias = self.raw(prefix + ".weight"), self.raw(prefix + ".bias")
        return layer_norm_flax_exact(x, scale, bias, self.config.layer_norm_eps,
                                     torch.promote_types(x.dtype, scale.dtype))

    def _dense(self, x, prefix):
        # flax Dense: the (out, in) weight in the compute dtype, the bias
        # added in it
        return F.linear(x.to(self.dtype), self.w(prefix + ".weight")) + self.w(prefix + ".bias")

    def _layer(self, hidden, attention_bias, p):
        cfg = self.config
        B, L, E = hidden.shape
        h = cfg.num_attention_heads
        hd = E // h
        q = self._dense(hidden, p + "attention.self.query").reshape(B, L, h, hd)
        k = self._dense(hidden, p + "attention.self.key").reshape(B, L, h, hd)
        v = self._dense(hidden, p + "attention.self.value").reshape(B, L, h, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores / math.sqrt(hd) + attention_bias
        weights = torch.softmax(scores, dim=-1).to(self.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, L, E)
        attn = self._dense(attn, p + "attention.output.dense")
        hidden = self._ln(attn + hidden, p + "attention.output.LayerNorm")
        x = gelu_exact(self._dense(hidden, p + "intermediate.dense"))
        x = self._dense(x, p + "output.dense")
        return self._ln(x + hidden, p + "output.LayerNorm")

    def hidden_states(self, input_ids, attention_mask, word_embeddings):
        """The last layer's output (post-LN; no final norm), (B, L, hidden)
        in the compute dtype (f32 where the LayerNorms' parameters are),
        with ``word_embeddings`` (V, hidden) as the input table."""
        return self._hidden_states(input_ids, attention_mask, word_embeddings)

    def _hidden_states(self, input_ids, attention_mask, word_embeddings):
        cfg = self.config
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        embeds = F.embedding(input_ids, word_embeddings.to(self.dtype))
        not_pad = (input_ids != cfg.pad_token_id).long()
        positions = torch.cumsum(not_pad, dim=1) * not_pad + cfg.pad_token_id
        pos = F.embedding(positions, self.w("roberta.embeddings.position_embeddings.weight"))
        types = self.w("roberta.embeddings.token_type_embeddings.weight")[0]
        hidden = self._ln(embeds + pos + types, "roberta.embeddings.LayerNorm")
        attention_bias = torch.where(attention_mask.bool()[:, None, None, :], 0.0,
                                     torch.finfo(torch.float32).min)
        remat = cfg.remat_blocks and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            p = f"roberta.encoder.layer.{i}."
            if remat:
                hidden = checkpoint(block, hidden, attention_bias, p, use_reentrant=False)
            else:
                hidden = block(hidden, attention_bias, p)
        return hidden

    def lm_head_transform(self, hidden):
        """The MLM head before its decoder (``roberta.py:126-128``):
        ``lm_head.dense``, erf gelu, ``lm_head.layer_norm``."""
        return self._ln(gelu_exact(self._dense(hidden, "lm_head.dense")), "lm_head.layer_norm")

    def forward(self, input_ids, attention_mask, word_embeddings,
                lm_head_bias: Optional[torch.Tensor] = None):
        """Logits (B, L, V): the head's output times the tied decoder
        ``word_embeddings`` in the compute dtype, both promoted to a common
        dtype as jnp's matmul does, plus ``lm_head_bias`` when given."""
        t = self.lm_head_transform(self._hidden_states(input_ids, attention_mask,
                                                       word_embeddings))
        table = word_embeddings.to(self.dtype)
        common = torch.promote_types(t.dtype, table.dtype)
        logits = t.to(common) @ table.to(common).t()
        return logits if lm_head_bias is None else logits + lm_head_bias

    def mlm_logits(self, input_ids, attention_mask=None):
        """The model's own logits: its word table and its lm-head bias."""
        return self(input_ids, attention_mask, self.raw(WORD_EMBEDDINGS),
                    self.raw("lm_head.bias"))
