"""The Llama-family decoder (llama, mistral, gemma, qwen2) with its
embedding tables passed in (counterpart of
``zett_tpu/models/backbones/llama.py``).

``LlamaForCausalLM.forward(input_ids, attention_mask, embed_tokens,
lm_head=None)`` embeds with ``embed_tokens``, runs the layers and returns
the logits: ``hidden @ lm_head.T`` for an untied head, ``hidden @
embed_tokens.T`` for a tied one. The training step and the eval splice the
hypernet's predicted tables in through these arguments; ``hidden_states``
is the headless model (the chunked CLM loss computes its logits chunk by
chunk). Weights are the HF state dict's, held as parameters in their
stored dtype: projections are cast to the compute dtype at use, as flax
promotes a Dense kernel, and the RMSNorm weights are not (the JAX module
multiplies its f32 normalised values by the weight as stored).

The arithmetic follows the JAX module (``llama.py``) and its dtype
promotion, which is kept as it is:
- RMSNorm multiplies the compute-dtype x by an f32 rsqrt of the f32 mean
  square, then by the weight (``1 + weight`` with gemma's unit offset), and
  casts once;
- rotary embeddings in the half-rotation layout, with f32 sin/cos, so q
  and k leave them in f32 and the scores are f32 x f32;
- grouped-query attention: head i reads KV head i // (h / kvh), as
  ``jnp.repeat``;
- the scores are divided by sqrt(head_dim) and take an additive causal and
  padding bias of ``finfo(f32).min``; the softmax runs in f32 and its
  weights are cast to the compute dtype before PV against the
  compute-dtype v;
- SwiGLU (``silu(gate) * up``), gemma's tanh-GeGLU, gemma's sqrt(hidden)
  embedding scale, qwen2's q/k/v biases.
Mistral's sliding window is ignored, as the JAX module ignores it (ZeTT's
blocks are at most 512 positions). These are library ops (cuBLAS on the
card), as they are XLA einsums in the JAX package. With ``remat_blocks``
each layer runs under ``torch.utils.checkpoint`` when gradients are on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .units import BlockModel

FAMILY = ("llama", "mistral", "gemma", "qwen2")


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # q/k/v biases (qwen2)
    hidden_act: str = "silu"  # "silu" (llama, mistral, qwen2) | "gelu" (gemma, tanh)
    scale_embeddings: bool = False  # gemma: embeddings times sqrt(hidden)
    rmsnorm_unit_offset: bool = False  # gemma: (1 + w) * norm(x)
    model_type: str = "llama"
    remat_blocks: bool = False

    @classmethod
    def from_hf(cls, hf: dict) -> "LlamaConfig":
        """From a ``config.json`` dict (``LlamaConfig.from_hf``, llama.py)."""
        model_type = hf.get("model_type", "llama")
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads"),
            head_dim=hf.get("head_dim"),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 10000.0),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            # qwen2's architecture has q/k/v biases whatever its config says
            attention_bias=True if model_type == "qwen2" else hf.get("attention_bias", False),
            hidden_act="gelu" if model_type == "gemma" else "silu",
            scale_embeddings=model_type == "gemma",
            rmsnorm_unit_offset=model_type == "gemma",
            model_type=model_type,
        )

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or (self.hidden_size // self.num_attention_heads)


def _layer_keys(cfg: LlamaConfig, i: int):
    p = f"model.layers.{i}."
    keys = [p + "input_layernorm.weight", p + "post_attention_layernorm.weight"]
    keys += [p + f"self_attn.{n}_proj.weight" for n in ("q", "k", "v", "o")]
    if cfg.attention_bias:
        keys += [p + f"self_attn.{n}_proj.bias" for n in ("q", "k", "v")]
    keys += [p + f"mlp.{n}_proj.weight" for n in ("gate", "up", "down")]
    return keys


def weight_keys(config: LlamaConfig):
    """The HF keys the model holds (``embed_tokens`` and an untied
    ``lm_head`` included: they are parameters of the backbone even though
    the forward takes the tables as arguments)."""
    keys = ["model.embed_tokens.weight", "model.norm.weight"]
    for i in range(config.num_hidden_layers):
        keys += _layer_keys(config, i)
    if not config.tie_word_embeddings:
        keys.append("lm_head.weight")
    return keys


def rotary_embedding(positions, dim: int, theta: float):
    """(sin, cos), each (..., dim // 2), f32 (``rotary_embedding``)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=positions.device) / dim))
    freqs = positions[..., None].float() * inv_freq
    return torch.sin(freqs), torch.cos(freqs)


def apply_rotary(x, sin, cos):
    """x (B, L, heads, head_dim) in the half-rotation layout; a bf16 x times
    the f32 sin/cos leaves in f32 (``apply_rotary``)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gelu_tanh_jax(x):
    """``jax.nn.gelu(x, approximate=True)`` op by op in x's dtype."""
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * (x ** 3))))
    return x * cdf


class LlamaForCausalLM(BlockModel):
    def __init__(self, config: LlamaConfig, state_dict: Dict[str, torch.Tensor], dtype):
        super().__init__()
        self.config = config
        self.dtype = dtype
        # the layers ``model.layers.N`` in units of their own (units.py)
        self._hold(weight_keys(config),
                   [_layer_keys(config, i) for i in range(config.num_hidden_layers)],
                   state_dict, self._layer)

    def _norm(self, x, key):
        cfg = self.config
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + cfg.rms_norm_eps)
        w = self.raw(key)
        if cfg.rmsnorm_unit_offset:
            w = 1.0 + w
        return (y * w).to(self.dtype)

    def _dense(self, x, prefix, bias: bool = False):
        # flax Dense: the (out, in) weight in the compute dtype, the bias
        # added in it
        out = F.linear(x.to(self.dtype), self.w(prefix + ".weight"))
        return out + self.w(prefix + ".bias") if bias else out

    def _attention(self, x, attention_bias, sin, cos, p):
        cfg = self.config
        B, L, _ = x.shape
        h, hd, kvh = cfg.num_attention_heads, cfg.dims_per_head, cfg.kv_heads
        qkv_bias = cfg.attention_bias
        q = self._dense(x, p + "q_proj", qkv_bias).reshape(B, L, h, hd)
        k = self._dense(x, p + "k_proj", qkv_bias).reshape(B, L, kvh, hd)
        v = self._dense(x, p + "v_proj", qkv_bias).reshape(B, L, kvh, hd)
        q = apply_rotary(q, sin, cos)
        k = apply_rotary(k, sin, cos)
        if kvh != h:  # grouped-query: each kv head serves h / kvh query heads
            k = k.repeat_interleave(h // kvh, dim=2)
            v = v.repeat_interleave(h // kvh, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores / math.sqrt(hd) + attention_bias
        weights = torch.softmax(scores, dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, L, h * hd)
        return self._dense(out, p + "o_proj")

    def _mlp(self, x, p):
        gate = self._dense(x, p + "gate_proj")
        up = self._dense(x, p + "up_proj")
        act = gate * torch.sigmoid(gate) if self.config.hidden_act == "silu" \
            else gelu_tanh_jax(gate)
        return self._dense(act * up, p + "down_proj")

    def _layer(self, hidden, attention_bias, sin, cos, p):
        hidden = hidden + self._attention(self._norm(hidden, p + "input_layernorm.weight"),
                                          attention_bias, sin, cos, p + "self_attn.")
        return hidden + self._mlp(self._norm(hidden, p + "post_attention_layernorm.weight"),
                                  p + "mlp.")

    def hidden_states(self, input_ids, attention_mask, embed_tokens):
        """Final hidden states (after the last RMSNorm), (B, L, hidden) in the
        compute dtype, with ``embed_tokens`` (V, hidden) as the input
        table."""
        return self._hidden_states(input_ids, attention_mask, embed_tokens)

    def _hidden_states(self, input_ids, attention_mask, embed_tokens):
        cfg = self.config
        B, L = input_ids.shape
        dev = input_ids.device
        hidden = F.embedding(input_ids, embed_tokens.to(self.dtype))
        if cfg.scale_embeddings:
            scale = torch.tensor(math.sqrt(cfg.hidden_size), dtype=torch.float32)
            hidden = hidden * scale.to(hidden.dtype).to(dev)
        positions = torch.arange(L, device=dev)[None].expand(B, L)
        sin, cos = rotary_embedding(positions, cfg.dims_per_head, cfg.rope_theta)
        causal = torch.tril(torch.ones(L, L, dtype=torch.bool, device=dev))[None, None]
        mask = causal if attention_mask is None else causal & attention_mask.bool()[:, None, None, :]
        attention_bias = torch.where(mask, 0.0, torch.finfo(torch.float32).min)
        remat = cfg.remat_blocks and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            p = f"model.layers.{i}."
            if remat:
                hidden = checkpoint(block, hidden, attention_bias, sin, cos, p,
                                    use_reentrant=False)
            else:
                hidden = block(hidden, attention_bias, sin, cos, p)
        return self._norm(hidden, "model.norm.weight")

    def forward(self, input_ids, attention_mask, embed_tokens, lm_head=None):
        """Logits (B, L, V) in the compute dtype: ``hidden @ lm_head.T`` when
        the head is untied (``lm_head`` (V, hidden), HF's layout), else
        ``hidden @ embed_tokens.T``."""
        hidden = self._hidden_states(input_ids, attention_mask, embed_tokens)
        if self.config.tie_word_embeddings:
            return hidden @ embed_tokens.to(self.dtype).t()
        if lm_head is None:
            raise ValueError("an untied head needs its lm_head table")
        return hidden @ lm_head.to(self.dtype).t()
