"""GPT-2 decoder with its embedding table passed in (counterpart of
``zett_tpu/models/backbones/gpt2.py``).

``GPT2LMHeadModel.forward(input_ids, attention_mask, wte)`` embeds with
``wte``, runs the blocks and returns ``hidden @ wte.T``: the training step
splices the hypernet's predicted table in as ``wte``. Weights are the HF
state dict's (Conv1D kernels are (in, out), as flax Dense kernels), held as
parameters in their stored dtype and cast to the compute dtype at use, as
flax promotes them (the LayerNorms take theirs as held: with full
fine-tuning's f32 parameters their outputs are f32, as flax's promotion
makes them). The arithmetic follows the JAX module
(``gpt2.py:48-117``): attention scores accumulated and scaled in f32 with
an additive ``finfo(f32).min`` causal/padding bias, an f32 softmax whose
weights are cast to the compute dtype, flax LayerNorm (f32 statistics),
tanh-gelu, and logits in the compute dtype. These are library ops (cuBLAS
on the card), as they are XLA in the JAX package. With ``remat_blocks``
(the trainer's ``remat_backbone``, ``gpt2.py:29-32``) each block runs under
``torch.utils.checkpoint`` when gradients are on: its activations are
recomputed in the backward instead of kept.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.encoder_layer import gelu, layer_norm_flax_exact
from .units import BlockModel


@dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_inner: Optional[int] = None
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    remat_blocks: bool = False

    @classmethod
    def from_hf(cls, hf: dict) -> "GPT2Config":
        return cls(
            vocab_size=hf["vocab_size"], n_positions=hf["n_positions"], n_embd=hf["n_embd"],
            n_layer=hf["n_layer"], n_head=hf["n_head"], n_inner=hf.get("n_inner"),
            layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
        )


def _block_keys(i: int):
    p = f"transformer.h.{i}."
    return [p + k for k in (
        "ln_1.weight", "ln_1.bias", "attn.c_attn.weight", "attn.c_attn.bias",
        "attn.c_proj.weight", "attn.c_proj.bias", "ln_2.weight", "ln_2.bias",
        "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias")]


def weight_keys(config: GPT2Config):
    """The HF keys the model holds (``wte`` included: it is a parameter of
    the backbone even though the forward takes the table as an argument)."""
    keys = ["transformer.wte.weight", "transformer.wpe.weight",
            "transformer.ln_f.weight", "transformer.ln_f.bias"]
    for i in range(config.n_layer):
        keys += _block_keys(i)
    if not config.tie_word_embeddings:
        keys.append("lm_head.weight")
    return keys


class GPT2LMHeadModel(BlockModel):
    def __init__(self, config: GPT2Config, state_dict: Dict[str, torch.Tensor], dtype):
        super().__init__()
        if not config.tie_word_embeddings:
            raise NotImplementedError("untied GPT-2 heads are not ported")
        self.config = config
        self.dtype = dtype
        # the blocks ``transformer.h.N`` in units of their own (units.py)
        self._hold(weight_keys(config), [_block_keys(i) for i in range(config.n_layer)],
                   state_dict, self._block)

    def _ln(self, x, prefix):
        # flax LayerNorm without a dtype: f32 statistics, the parameters as
        # held, output in the promoted dtype of x and the parameters (the
        # compute dtype for a frozen bf16 backbone, f32 for full
        # fine-tuning's f32 parameters)
        scale, bias = self.raw(prefix + ".weight"), self.raw(prefix + ".bias")
        return layer_norm_flax_exact(x, scale, bias, self.config.layer_norm_epsilon,
                                     torch.promote_types(x.dtype, scale.dtype))

    def _dense(self, x, prefix):
        # flax Dense: input and kernel in the compute dtype, the product in
        # it, then the bias added in it
        return x.to(self.dtype) @ self.w(prefix + ".weight") + self.w(prefix + ".bias")

    def _attention(self, x, bias, prefix):
        cfg = self.config
        B, L, E = x.shape
        H = cfg.n_head
        hd = E // H
        q, k, v = self._dense(x, prefix + ".c_attn").split(E, dim=-1)
        q = q.reshape(B, L, H, hd).transpose(1, 2)
        k = k.reshape(B, L, H, hd).transpose(1, 2)
        v = v.reshape(B, L, H, hd).transpose(1, 2)
        scores = q.float() @ k.float().transpose(-1, -2)
        scores = scores / math.sqrt(hd) + bias
        weights = torch.softmax(scores, dim=-1).to(self.dtype)
        out = (weights @ v).transpose(1, 2).reshape(B, L, E)
        return self._dense(out, prefix + ".c_proj")

    def hidden_states(self, input_ids, attention_mask, wte):
        """Final hidden states (after ln_f), (B, L, E): in the compute dtype,
        or f32 where ``ln_f``'s parameters are f32 and the compute dtype is
        not."""
        return self._hidden_states(input_ids, attention_mask, wte)

    def _hidden_states(self, input_ids, attention_mask, wte):
        cfg = self.config
        B, L = input_ids.shape
        dev = input_ids.device
        hidden = (torch.nn.functional.embedding(input_ids, wte.to(self.dtype))
                  + self.w("transformer.wpe.weight")[:L][None])
        causal = torch.tril(torch.ones(L, L, dtype=torch.bool, device=dev))[None, None]
        mask = causal if attention_mask is None else causal & attention_mask.bool()[:, None, None, :]
        bias = torch.where(mask, 0.0, torch.finfo(torch.float32).min)
        remat = cfg.remat_blocks and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            p = f"transformer.h.{i}"
            if remat:
                hidden = checkpoint(block, hidden, bias, p, use_reentrant=False)
            else:
                hidden = block(hidden, bias, p)
        return self._ln(hidden, "transformer.ln_f")

    def _block(self, hidden, bias, p):
        hidden = hidden + self._attention(self._ln(hidden, p + ".ln_1"), bias, p + ".attn")
        h = self._dense(self._ln(hidden, p + ".ln_2"), p + ".mlp.c_fc")
        return hidden + self._dense(gelu(h), p + ".mlp.c_proj")

    def forward(self, input_ids, attention_mask, wte):
        """Logits (B, L, V): ``hidden @ wte.T`` with the table in the
        compute dtype, both promoted to a common dtype as jnp's matmul does
        (f32 after an f32 ``ln_f``)."""
        hidden = self._hidden_states(input_ids, attention_mask, wte)
        table = wte.to(self.dtype)
        common = torch.promote_types(hidden.dtype, table.dtype)
        return hidden.to(common) @ table.to(common).t()
