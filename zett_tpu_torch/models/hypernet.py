"""The ZeTT hypernetwork, inference and training routes, in PyTorch.

Counterpart of ``zett_tpu/models/hypernet.py``: a small post-LN transformer
encoder runs over each target token's surface form, pools the first
position and projects to the frozen LM's embeddings (+ an lm-head bias).

Kept features: source-embedding input with the fallback table (or the hn
vocab's own embedding table), absolute or relative (T5-bucketed, per-head
bias) positions, the target-prior token, the language-id token
(``embed_lang_id``), inter-token attention (with the prior bias and the
residual LayerNorms), per-language bottleneck adapters after each layer,
tanh- and erf-gelu, affine rescalers, single/dual heads, the bias head,
CLS or concat pooling, and the T5-compat encoder (``encoder_type="t5"``,
``hypernet_t5.py``) that holds reference T5 checkpoints. Two routes,
chosen as the JAX module chooses them (``inference``, defaulting to
``deterministic``):

- inference: a layer runs kernel 1 (``ops.encoder_layer``, the tier-3
  layer) where the JAX module would fuse the whole layer (no inter-token
  attention, tanh-gelu); every other layer that is not CLS-only runs its
  self-attention through kernel 4 (``ops.attention_block``, the tier-2
  block) and its LayerNorms, inter-token exchange and FFN with torch ops;
  the last, CLS-only layer (absent with inter-token attention) computes its
  projections and FFN with torch matmuls and its attention core with
  kernel 2 (``ops.attention_core``, the tier-4 core). Forward only.
- training (``inference=False``, what the Trainer runs): every layer
  computes its projections, LayerNorms and FFN with torch ops (XLA in the
  JAX package) and its self-attention core with ``merged_attention_train``,
  kernel 2 forward and kernel 3 backward with in-kernel dropout; the last
  layer stays CLS-only where the JAX module makes it so. Hidden dropout
  follows flax's ``nn.Dropout`` with masks drawn from an explicit generator.

The inter-token exchange (cross-attention between the batch's rows and a
few learned blocks) takes the JAX module's plain attention (``_attention``)
on both routes, as the JAX package leaves it to XLA; so do the
self-attention of every layer with relative positions (the per-head bias
excludes the fused paths, hypernet.py:398, :485), of rows wider than
``MERGED_ATTENTION_MAX`` merged positions and of head widths that are not a
multiple of 64, and the whole T5-compat encoder. The language adapters run
after kernel 1's layer as after the unfused one (hypernet.py:526, :582).

Head widths 64 and 128 run on the kernels (1 to 4 are instantiated for
both); a multiple of 64 past 128, where the JAX module would fuse the layer
or the block, raises ``NotImplementedError`` naming ROADMAP A.10.
Concat pooling runs where the JAX module's runs: its output heads'
residual block is (rows, H) wide, so a pooled row longer than one position
fails there (ROADMAP C.21) and raises ``ValueError`` here.

``PassthroughHypernet`` is the n-shot baseline's stand-in with the same
call: plain tables read at each row's first surface-form id.

Parameters are stored as torch's ``nn.Linear`` layout; ``models.convert``
maps a Flax parameter tree onto them. Weights are f32 and cast to the
compute dtype at use, as flax's ``param_dtype``/``dtype`` split does; the
rescalers, position embeddings and inter-token blocks carry the compute
dtype themselves.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention_block import attention_block_fused
from ..ops.attention_core import (HEAD_WIDTHS, attention_core, merged_attention_train,
                                  softmax_weights)
from ..ops.encoder_layer import encoder_layer, gelu, layer_norm_flax_exact

MERGED_ATTENTION_MAX = 256  # widest merged (L*h) row on the kernel route


@dataclass
class HypernetConfig:
    # encoder dims
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 3
    num_attention_heads: int = 12
    max_position_embeddings: int = 24
    vocab_size: int = 256  # hn tokenizer vocab (ignored when embedding from source)
    type_vocab_size: int = 1
    pad_token_id: int = 0
    layer_norm_eps: float = 1e-5
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    # target embedding dims
    n_embd: int = 768
    separate_out_embeddings: bool = False
    # ZeTT extensions
    hn_surface_maxlen: int = 16
    embed_target_priors: bool = False
    add_inter_token_attention: bool = False
    inter_token_attention_bias_by_priors: bool = False
    inter_token_attention_bias_scaler: float = 1.0
    n_inter_token_blocks: int = 16
    inter_token_residual_ln: bool = False
    language_adapter_bottleneck_dim: int = 0
    embed_lang_id: bool = False
    n_langs: int = 1
    embed_using_source_embeddings: bool = False
    original_vocab_size: int = 0  # source vocab size (source-embedding mode)
    n_extra_tokens: int = 1  # fallback table size (byte tokens new to source)
    rescale_embeddings: bool = False
    single_head: bool = False
    predict_bias: bool = True
    concat_last_hidden_state: bool = False
    position_embedding_type: str = "absolute"
    encoder_type: str = "roberta"
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    hidden_act: str = "gelu_new"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HypernetConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def n_in_embd(self) -> int:
        return self.n_embd * 2 if self.separate_out_embeddings else self.n_embd


def _check_supported(cfg: HypernetConfig) -> None:
    """Refuse what the port cannot run: a head width that is a multiple of
    64 past 128 on the roberta encoder with layers the JAX module would fuse
    (kernels 1 and 4 exist at 64 and 128 only). Other widths run the plain
    route, as in JAX (hypernet.py:403, :489)."""
    h = cfg.num_attention_heads
    width = cfg.hidden_size // h if cfg.hidden_size % h == 0 else None
    if (cfg.encoder_type != "t5" and cfg.position_embedding_type != "relative"
            and width is not None and width % 64 == 0 and width not in HEAD_WIDTHS):
        raise NotImplementedError(f"hypernet head width {width}: kernels 1 and 4 run head "
                                  f"widths {HEAD_WIDTHS} (other widths: ROADMAP A.10)")


# Inside ``remat_glue()`` the f32 glue of the training route (each LayerNorm
# and FFN activation) keeps only its compute-dtype input for the backward
# and recomputes its f32 intermediates there.
_REMAT_GLUE = contextvars.ContextVar("remat_glue", default=False)


@contextlib.contextmanager
def remat_glue():
    """Rematerialize the hypernet's elementwise f32 glue (LayerNorms, gelu)
    op by op while gradients are on: eager PyTorch keeps every f32
    intermediate of these ops for the backward (several (rows, L, H) f32
    tensors a LayerNorm, (rows, L, I) ones a gelu), which XLA fuses away in
    the reference. Same arithmetic, forward and backward; the trainer's
    ``remat_hypernet_glue`` runs the hypernet inside it."""
    token = _REMAT_GLUE.set(True)
    try:
        yield
    finally:
        _REMAT_GLUE.reset(token)


def _glue(fn, *args):
    if _REMAT_GLUE.get() and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def embed_take(table, ids):
    """Rows ``ids`` of ``table`` by flax ``nn.Embed``'s rules: a one-row
    table is broadcast to the ids' shape plus its width; otherwise
    ``jnp.take``'s, negative ids counted from the end and an id past either
    end a row of NaN."""
    if table.shape[0] == 1:
        return table.expand(*ids.shape, table.shape[1])
    return take_rows(table, ids)


def take_rows(table, index):
    """``jnp.take(table, index, axis=0)`` for a float table: negative
    indices counted from the end, an index past either end a row of NaN."""
    n = table.shape[0]
    idx = torch.as_tensor(index, device=table.device).long()
    inside = (idx >= -n) & (idx < n)
    rows = table[torch.where(inside, idx % n, 0)]
    return torch.where(inside.reshape(inside.shape + (1,) * (table.dim() - 1)), rows,
                       float("nan"))


def relative_position_bucket(relative_position, num_buckets=32, max_distance=128, eps=1e-6):
    """T5 bidirectional relative-position bucketing: int64 buckets of int64
    offsets. ``eps`` inside the log is the JAX roberta encoder's
    (hypernet.py:616-631); HF T5's has none (``eps=0``,
    hypernet_t5.py:54-67)."""
    num_buckets //= 2
    ret = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float() / max_exact + eps)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).nan_to_num(neginf=0.0).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


def gelu_exact(x):
    """erf gelu (flax ``nn.gelu(approximate=False)``, 0.5 x erfc(-x /
    sqrt 2)), computed in f32 on the compute-dtype value and cast once."""
    xf = x.float()
    return (0.5 * xf * torch.erfc(-xf * math.sqrt(0.5))).to(x.dtype)


def activation(cfg: HypernetConfig):
    """The encoder FFN's activation (hypernet.py:128-129)."""
    return gelu_exact if cfg.hidden_act == "gelu" else gelu


def draw_seed(generator: torch.Generator) -> int:
    """A dropout seed in [0, 2^31 - 1) from a CPU generator (the JAX module
    draws ``randint(rng, (), 0, 2**31 - 1)``, hypernet.py:205-208)."""
    return int(torch.randint(0, 2**31 - 1, (), generator=generator))


def dropout(x, rate: float, generator: torch.Generator):
    """flax ``nn.Dropout``: keep with probability 1 - rate, kept values
    divided by 1 - rate. The mask comes from a device generator seeded from
    ``generator``, so the draw is a pure function of that generator's state."""
    dev_gen = torch.Generator(device=x.device)
    dev_gen.manual_seed(draw_seed(generator))
    keep = torch.rand(x.shape, generator=dev_gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Linear):
    """flax nn.Dense: f32 parameters promoted to the compute dtype, the
    product in that dtype, then the bias (if any) added in it."""

    def __init__(self, in_features: int, out_features: int, dtype, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def kernel(self):
        """The (in, out) kernel in the compute dtype."""
        return self.weight.to(self.dtype).t()

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel()
        return y + self.bias.to(self.dtype) if self.bias is not None else y


class LayerNorm(nn.Module):
    """flax nn.LayerNorm (f32 statistics, output in the module dtype)."""

    def __init__(self, dim: int, eps: float, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        return _glue(layer_norm_flax_exact, x, self.weight, self.bias, self.eps, self.dtype)


class Rescaler(nn.Module):
    """Per-feature affine calibration w * x + b, parameters in the module
    dtype (promoted with x as jnp would)."""

    def __init__(self, dim: int, dtype):
        super().__init__()
        self.w = nn.Parameter(torch.ones(1, dim, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(1, dim, dtype=dtype))

    def forward(self, x):
        return self.w * x + self.b


class ProjectorBlock(nn.Module):
    """Residual MLP block of the in/out projection heads. Its LayerNorm uses
    flax's default epsilon 1e-6 and its activation is always tanh-gelu
    (``zett_tpu/models/hypernet.py:140-144``)."""

    def __init__(self, dim: int, intermediate_dim: int, dtype):
        super().__init__()
        self.dense1 = Dense(dim, intermediate_dim, dtype)
        self.dense2 = Dense(intermediate_dim, dim, dtype)
        self.ln = LayerNorm(dim, 1e-6, dtype)

    def forward(self, x):
        h = self.dense1(x)
        h = self.dense2(_glue(gelu, h))
        return self.ln(_glue(gelu, h) + x)


def _attention(q, k, v, key_bias, key_mask, num_heads: int, rate: float = 0.0,
               generator=None, head_bias=None):
    """The JAX module's plain attention core (hypernet.py:158-287 without
    the Pallas branches), on (B, L, H) projections: the merged-head form
    when both merged widths fit ``MERGED_ATTENTION_MAX``, else per head.
    key_bias (B', Lk) additive, key_mask (B, Lk) bool, head_bias (B', h, Lq,
    Lk) additive per head (relative positions; in the merged form scattered
    onto the block diagonal), each None or not. Scores accumulate wide and
    are cast, divided by sqrt(d) in the compute dtype, biased, masked with
    one select to finfo.min; softmax wide, weights cast, dropped at
    ``rate`` with masks from ``generator``."""
    B, Lq, H = q.shape
    Lk = k.shape[1]
    h = num_heads
    d = H // h
    dtype = q.dtype
    if Lq * h <= MERGED_ATTENTION_MAX and Lk * h <= MERGED_ATTENTION_MAX:
        kmask = key_mask.repeat_interleave(h, dim=-1) if key_mask is not None else None
        kb = key_bias.repeat_interleave(h, dim=-1) if key_bias is not None else None
        plane = None
        if head_bias is not None:
            # [q*h + i, k*h + j] = head_bias[i, q, k] where i == j, else 0
            hb = head_bias.to(dtype).expand(head_bias.shape[0], h, Lq, Lk).permute(0, 2, 1, 3)
            eye = torch.eye(h, dtype=dtype, device=q.device)
            plane = (hb[..., None] * eye[None, None, :, None, :]).reshape(
                head_bias.shape[0], Lq * h, Lk * h)
        weights, _ = softmax_weights(q.reshape(B, Lq * h, d), k.reshape(B, Lk * h, d), kmask,
                                     h, kb, plane)
        vs, pv = v.reshape(B, Lk * h, d), "bqk,bkd->bqd"
    else:
        vs, pv = v.reshape(B, Lk, h, d), "bhqk,bkhd->bqhd"
        scores = torch.einsum("bqhd,bkhd->bhqk", q.reshape(B, Lq, h, d).float(),
                              k.reshape(B, Lk, h, d).float()).to(dtype)
        scores = scores / torch.tensor(math.sqrt(d), dtype=dtype, device=q.device)
        if key_bias is not None:
            scores = scores + key_bias.to(dtype)[:, None, None, :]
        if head_bias is not None:
            scores = scores + head_bias.to(dtype)
        if key_mask is not None:
            scores = torch.where(key_mask[:, None, None, :], scores, torch.finfo(dtype).min)
        weights = torch.softmax(scores.float(), dim=-1).to(dtype)
    if rate > 0.0:
        weights = dropout(weights, rate, generator)
    return torch.einsum(pv, weights.float(), vs.float()).to(dtype).reshape(B, Lq, H)


class Attention(nn.Module):
    """Self/cross attention with an optional additive key bias: the
    query/key/value/out projections of a layer and the routes through them
    (hypernet.py:343-447)."""

    def __init__(self, cfg: HypernetConfig, dtype):
        super().__init__()
        H = cfg.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.num_heads = cfg.num_attention_heads
        self.query = Dense(H, H, dtype)
        self.key = Dense(H, H, dtype)
        self.value = Dense(H, H, dtype)
        self.out = Dense(H, H, dtype)

    def weights(self):
        """(wq, bq, wk, bk, wv, bv, wo, bo) in the compute dtype, kernels
        (in, out)."""
        dt = self.dtype
        return tuple(t for m in (self.query, self.key, self.value, self.out)
                     for t in (m.kernel(), m.bias.to(dt)))

    def forward(self, hidden, mask=None, key_value_states=None, attention_bias=None,
                deterministic: bool = True, generator=None, head_bias=None):
        """The plain route (``_attention``): cross-attention over
        ``key_value_states``, wide rows, relative positions (``head_bias``)
        and head widths without a kernel. A mask (B, Lk) wins over
        ``attention_bias`` (B', Lk), as in the JAX module. Attention and
        hidden dropout apply when not ``deterministic``."""
        cfg = self.cfg
        kv = key_value_states if key_value_states is not None else hidden
        key_mask = mask.bool() if mask is not None else None
        key_bias = attention_bias if mask is None else None
        rate = 0.0 if deterministic else float(cfg.attention_dropout_prob)
        ctx = _attention(self.query(hidden), self.key(kv), self.value(kv), key_bias, key_mask,
                         self.num_heads, rate, generator, head_bias)
        out = self.out(ctx)
        if not deterministic and cfg.hidden_dropout_prob > 0.0:
            out = dropout(out, cfg.hidden_dropout_prob, generator)
        return out

    def forward_block(self, hidden, mask):
        """Self-attention on the inference route: kernel 4 through
        ``attention_block_fused`` (hypernet.py:394-428)."""
        return attention_block_fused(hidden, mask.float(), None, *self.weights(),
                                     self.num_heads, True, False)

    def forward_cls(self, hidden, mask):
        """Output for position 0 only: q projects the CLS position, keys and
        values span all positions; the core is kernel 2."""
        B, Lk, H = hidden.shape
        h = self.num_heads
        d = H // h
        qm = self.query(hidden[:, :1]).reshape(B, h, d)
        km = self.key(hidden).reshape(B, Lk * h, d)
        vm = self.value(hidden).reshape(B, Lk * h, d)
        kmaskf = mask.repeat_interleave(h, dim=-1).float()
        ctx = attention_core(qm, km, vm, kmaskf, h).reshape(B, 1, H)
        return self.out(ctx)

    def forward_train(self, hidden, mask, cls_only: bool, rate: float, generator):
        """The differentiated route (hypernet.py:430-447 with the tier-4
        core): torch projections, ``merged_attention_train`` on the merged
        layout (queries at position 0 only when ``cls_only``), the out
        projection."""
        B, Lk, H = hidden.shape
        h = self.num_heads
        d = H // h
        q_in = hidden[:, :1] if cls_only else hidden
        Lq = q_in.shape[1]
        qm = self.query(q_in).reshape(B, Lq * h, d)
        km = self.key(hidden).reshape(B, Lk * h, d)
        vm = self.value(hidden).reshape(B, Lk * h, d)
        kmaskf = mask.repeat_interleave(h, dim=-1).float()
        seed = draw_seed(generator) if rate > 0.0 else 0
        ctx = merged_attention_train(qm, km, vm, kmaskf, seed, h, rate)
        return self.out(ctx.reshape(B, Lq, H))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: HypernetConfig, dtype):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        H = cfg.hidden_size
        eps = cfg.layer_norm_eps
        self.attention = Attention(cfg, dtype)
        self.attention_ln = LayerNorm(H, eps, dtype)
        if cfg.add_inter_token_attention:
            self.inter_token_down = Attention(cfg, dtype)
            self.inter_token_up = Attention(cfg, dtype)
            if cfg.inter_token_residual_ln:
                self.inter_token_down_ln = LayerNorm(H, eps, dtype)
                self.inter_token_up_ln = LayerNorm(H, eps, dtype)
        self.intermediate = Dense(H, cfg.intermediate_size, dtype)
        self.output = Dense(cfg.intermediate_size, H, dtype)
        self.output_ln = LayerNorm(H, eps, dtype)
        self.act = activation(cfg)
        n, d = cfg.n_langs, cfg.language_adapter_bottleneck_dim
        if d > 0:
            # per-language bottleneck adapters: the weights in the compute
            # dtype, the biases f32, as the JAX module declares them
            self.lang_adapter_down_weights = nn.Parameter(torch.zeros(n, H, d, dtype=dtype))
            self.lang_adapter_down_bias = nn.Parameter(torch.zeros(n, d))
            self.lang_adapter_up_weights = nn.Parameter(torch.zeros(n, d, H, dtype=dtype))
            self.lang_adapter_up_bias = nn.Parameter(torch.zeros(n, H))
            self.adapter_ln = LayerNorm(H, eps, dtype)

    def forward(self, hidden, mask, target_priors=None, inter_token_blocks=None,
                cls_only: bool = False, inference: bool = True, deterministic: bool = True,
                generator=None, lang_index=None, position_bias=None):
        """hypernet.py:454-582. On the inference route a layer takes kernel 1
        exactly where the JAX module fuses the whole layer (``fused_layer``,
        :480-492); else its self-attention takes kernel 4 where the JAX
        module fuses the block (``fused_ok``, :394-405), kernel 2 when
        CLS-only, and the plain route otherwise. Rows whose merged width
        L*h is over ``MERGED_ATTENTION_MAX`` take the plain per-head route
        on every path, as ``_attention`` does in the JAX module (there an
        all-padding row averages its own head's values, not every head's);
        so do relative positions (``position_bias`` (1, h, L, L)) and head
        widths without a kernel. The language adapters follow either route."""
        cfg = self.cfg
        wide = hidden.shape[1] * cfg.num_attention_heads > MERGED_ATTENTION_MAX
        plain = (wide or position_bias is not None
                 or cfg.hidden_size // cfg.num_attention_heads not in HEAD_WIDTHS)
        if inference and not cls_only and not plain and not cfg.add_inter_token_attention \
                and cfg.hidden_act != "gelu":
            return self._adapter_tail(self._fused_layer(hidden, mask), lang_index)
        hidden_drop = not deterministic and cfg.hidden_dropout_prob > 0.0
        if plain:
            # the attention module's own route, queries at position 0 only
            # when CLS-only; hidden dropout inside it
            if cls_only and position_bias is not None:
                position_bias = position_bias[:, :, :1, :]
            attn = self.attention(hidden[:, :1] if cls_only else hidden, mask,
                                  key_value_states=hidden, deterministic=deterministic,
                                  generator=generator, head_bias=position_bias)
        elif not inference:
            rate = 0.0 if deterministic else float(cfg.attention_dropout_prob)
            attn = self.attention.forward_train(hidden, mask, cls_only, rate, generator)
            if hidden_drop:
                attn = dropout(attn, cfg.hidden_dropout_prob, generator)
        elif cls_only:
            attn = self.attention.forward_cls(hidden, mask)
        else:
            attn = self.attention.forward_block(hidden, mask)
        residual = hidden[:, :1] if cls_only else hidden
        attn = self.attention_ln(attn + residual)
        if cfg.add_inter_token_attention:
            attn = self._inter_token(attn, target_priors, inter_token_blocks, deterministic,
                                     generator)
        h = self.output(_glue(self.act, self.intermediate(attn)))
        if hidden_drop:
            h = dropout(h, cfg.hidden_dropout_prob, generator)
        return self._adapter_tail(self.output_ln(h + attn), lang_index)

    def _adapter_tail(self, h, lang_index):
        """Per-language bottleneck adapters (hypernet.py:584-613): the
        language's down and up weights (``jnp.take`` at ``lang_index``), the
        activation between them, the residual and ``adapter_ln``. As in
        JAX, the down product rounds to the compute dtype and adding the f32
        bias promotes the rest to f32 until the LayerNorm; no dropout."""
        if self.cfg.language_adapter_bottleneck_dim <= 0:
            return h
        dw = take_rows(self.lang_adapter_down_weights, lang_index)
        db = take_rows(self.lang_adapter_down_bias, lang_index)
        uw = take_rows(self.lang_adapter_up_weights, lang_index)
        ub = take_rows(self.lang_adapter_up_bias, lang_index)
        mid = _glue(self.act, (h.float() @ dw.float()).to(h.dtype) + db)
        adapted = mid @ uw.to(mid.dtype) + ub
        return self.adapter_ln(adapted + h)

    def _fused_layer(self, hidden, mask):
        cfg = self.cfg
        dt = self.dtype
        return encoder_layer(
            hidden, mask, *self.attention.weights(),
            self.attention_ln.weight, self.attention_ln.bias,
            self.intermediate.kernel(), self.intermediate.bias.to(dt),
            self.output.kernel(), self.output.bias.to(dt),
            self.output_ln.weight, self.output_ln.bias,
            num_heads=cfg.num_attention_heads, eps=cfg.layer_norm_eps,
        )

    def _inter_token(self, attn_out, target_priors, blocks, deterministic, generator):
        """Rows exchange information through the learned blocks
        (hypernet.py:541-574): the blocks attend over every row's position 0
        (biased by the priors when so configured), then every position of
        every row attends over the blocks. The batch axis is the sequence
        axis of a one-element batch."""
        cfg = self.cfg
        bias = None
        if cfg.inter_token_attention_bias_by_priors:
            bias = target_priors[None] * cfg.inter_token_attention_bias_scaler
        blocks_in = blocks[None]
        down = self.inter_token_down(blocks_in, key_value_states=attn_out[None, :, 0],
                                     attention_bias=bias, deterministic=deterministic,
                                     generator=generator)
        if cfg.inter_token_residual_ln:
            down = self.inter_token_down_ln(down + blocks_in)
        V, L, H = attn_out.shape
        flat = attn_out.reshape(1, V * L, H)
        up = self.inter_token_up(flat, key_value_states=down, deterministic=deterministic,
                                 generator=generator)
        if cfg.inter_token_residual_ln:
            up = self.inter_token_up_ln(up + flat)
        return up.reshape(V, L, H)


class HypernetEncoder(nn.Module):
    """Embeddings (+ the prior token) and the layer stack."""

    def __init__(self, cfg: HypernetConfig, dtype):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        H = cfg.hidden_size
        if not cfg.embed_using_source_embeddings:
            self.word_embeddings = nn.Embedding(cfg.vocab_size, H)
        if cfg.position_embedding_type == "absolute":
            self.position_embeddings = nn.Parameter(
                torch.zeros(cfg.max_position_embeddings, H, dtype=dtype)
            )
        if cfg.embed_target_priors:
            self.prior_projection = Dense(1, H, dtype)
        if cfg.embed_lang_id:
            self.lang_embedding = nn.Embedding(cfg.n_langs, H)
        self.embeddings_ln = LayerNorm(H, cfg.layer_norm_eps, dtype)
        if cfg.add_inter_token_attention:
            self.inter_token_blocks = nn.Parameter(
                torch.zeros(cfg.n_inter_token_blocks, H, dtype=dtype)
            )
        if cfg.position_embedding_type == "relative":
            # t5-style bucketed relative attention bias, shared by all layers
            self.relative_attention_bias = nn.Parameter(
                torch.zeros(cfg.relative_attention_num_buckets, cfg.num_attention_heads,
                            dtype=dtype))
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers)
        )

    def position_bias(self, L: int):
        """(1, h, L, L) per-head bias of relative positions (key minus query
        offset, bucketed on the CPU), hypernet.py:707-722."""
        cfg = self.cfg
        offsets = torch.arange(L)[None, :] - torch.arange(L)[:, None]
        buckets = relative_position_bucket(offsets, cfg.relative_attention_num_buckets,
                                           cfg.relative_attention_max_distance)
        table = self.relative_attention_bias
        return table[buckets.to(table.device)].permute(2, 0, 1)[None]

    def lang_token(self, lang_index):
        """The language id's row of ``lang_embedding`` in the compute
        dtype, squeezed as ``jnp.squeeze`` does (hypernet.py:678-684). As
        flax ``nn.Embed`` takes it: a one-row table is broadcast to the
        index's shape plus H (any index, but not a scalar one: as in JAX,
        (1, H) does not broadcast to (H,)); otherwise ``jnp.take``'s rules,
        negative indices counted from the end and an index past either end
        a row of NaN."""
        table = self.lang_embedding.weight.to(self.dtype)
        return embed_take(table, torch.as_tensor(lang_index, device=table.device)).squeeze()

    def forward(self, input_ids, attention_mask, inputs_embeds=None, target_priors=None,
                lang_index=None, inference: bool = True, deterministic: bool = True,
                generator=None):
        cfg = self.cfg
        if inputs_embeds is None:
            inputs_embeds = F.embedding(input_ids, self.word_embeddings.weight.to(self.dtype))
        L = inputs_embeds.shape[1]
        if cfg.position_embedding_type == "absolute":
            hidden = inputs_embeds + self.position_embeddings[:L]
        else:
            hidden = inputs_embeds
        if cfg.embed_target_priors:
            # one more position, always attended (hypernet.py:669-677)
            prior_tok = self.prior_projection(target_priors[..., None])
            hidden = torch.cat([hidden, prior_tok[:, None, :].to(hidden.dtype)], dim=1)
            attention_mask = torch.cat(
                [attention_mask, attention_mask.new_ones(hidden.shape[0], 1)], dim=1)
        if cfg.embed_lang_id:
            # one more position, after the prior token, always attended
            # (hypernet.py:678-691): the same row for every surface form
            lang_tok = self.lang_token(lang_index)
            hidden = torch.cat([hidden, lang_tok[None, None, :].expand(hidden.shape[0], 1, -1)],
                               dim=1)
            attention_mask = torch.cat(
                [attention_mask, attention_mask.new_ones(hidden.shape[0], 1)], dim=1)
        hidden = self.embeddings_ln(hidden)
        if not deterministic and cfg.hidden_dropout_prob > 0.0:
            hidden = dropout(hidden, cfg.hidden_dropout_prob, generator)
        blocks = self.inter_token_blocks if cfg.add_inter_token_attention else None
        position_bias = None
        if cfg.position_embedding_type == "relative":
            position_bias = self.position_bias(hidden.shape[1])
        # the last layer's non-CLS outputs are dead when the caller pools
        # hidden[:, 0]: it computes position 0 only (exact), unless concat
        # pooling or the inter-token exchange reads every position
        # (hypernet.py:726-728)
        cls_only_last = not (cfg.concat_last_hidden_state or cfg.add_inter_token_attention)
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            hidden = layer(hidden, attention_mask, target_priors=target_priors,
                           inter_token_blocks=blocks, cls_only=cls_only_last and i == n - 1,
                           inference=inference, deterministic=deterministic,
                           generator=generator, lang_index=lang_index,
                           position_bias=position_bias)
        return hidden


class Hypernet(nn.Module):
    """target surface forms (+ source embeddings) -> (emb_in, emb_out | None,
    bias)."""

    def __init__(self, config: HypernetConfig, dtype=torch.float32):
        super().__init__()
        cfg = config
        _check_supported(cfg)
        self.config = cfg
        self.dtype = dtype
        H, I = cfg.hidden_size, cfg.intermediate_size
        if cfg.encoder_type == "t5":
            from .hypernet_t5 import T5CompatEncoder

            self.encoder = T5CompatEncoder(cfg, dtype)
        else:
            self.encoder = HypernetEncoder(cfg, dtype)
        self.fallback_embeddings = nn.Embedding(max(cfg.n_extra_tokens, 1), cfg.n_in_embd)
        if cfg.embed_using_source_embeddings:
            self.input_projection = nn.Sequential(
                Dense(cfg.n_in_embd, H, dtype), ProjectorBlock(H, I, dtype)
            )
        head_in_dim = cfg.n_in_embd if cfg.single_head else cfg.n_embd
        self.output_projection = nn.Sequential(
            ProjectorBlock(H, I, dtype), Dense(H, head_in_dim, dtype)
        )
        if not cfg.single_head and cfg.separate_out_embeddings:
            self.output_projection_out = nn.Sequential(
                ProjectorBlock(H, I, dtype), Dense(H, cfg.n_embd, dtype)
            )
        if cfg.rescale_embeddings:
            self.in_scaler = Rescaler(cfg.n_in_embd, dtype)
            self.scaler = Rescaler(cfg.n_embd if not cfg.single_head else cfg.n_in_embd, dtype)
            if cfg.separate_out_embeddings:
                self.out_scaler = Rescaler(cfg.n_embd, dtype)
        if cfg.predict_bias:
            self.bias_projection = Dense(H, 1, dtype)

    def forward(self, target_surface_forms, target_priors=None, source_embeddings=None,
                lang_index=None, deterministic: bool = True, inference=None, generator=None):
        """The JAX module's call signature. ``target_priors`` (B,) feed the
        prior token and the inter-token prior bias where the config asks for
        them (the bias only with ``add_inter_token_attention``, the one
        place the JAX module reads it); ``lang_index`` (a scalar, or any
        shape that squeezes to one row) feeds the language-id token where
        ``embed_lang_id`` asks for it. ``inference`` picks the route
        (default: ``deterministic``);
        ``generator`` (a CPU ``torch.Generator``) draws the dropout masks and
        seeds when ``deterministic`` is False."""
        cfg = self.config
        if inference is None:
            inference = deterministic
        if not deterministic and generator is None:
            raise ValueError("dropout needs an explicit generator")
        if inference and not deterministic:
            raise ValueError("the inference route is deterministic")
        if target_priors is None and (cfg.embed_target_priors
                                      or (cfg.add_inter_token_attention
                                          and cfg.inter_token_attention_bias_by_priors)):
            raise ValueError("this config reads target_priors")
        if lang_index is None and cfg.embed_lang_id:
            raise ValueError("this config reads lang_index")
        sf = target_surface_forms
        attention_mask = sf != cfg.pad_token_id

        inputs_embeds = None
        if cfg.embed_using_source_embeddings:
            # surface-form ids index the SOURCE vocab; byte tokens beyond it
            # fall back to a learned table (ids clipped into both tables)
            use_fallback = sf >= cfg.original_vocab_size
            main_ids = torch.clamp(sf, 0, cfg.original_vocab_size - 1)
            fallback_ids = torch.clamp(
                sf - cfg.original_vocab_size, 0, max(cfg.n_extra_tokens, 1) - 1
            )
            source_embeds = F.embedding(main_ids, source_embeddings)
            if cfg.rescale_embeddings:
                source_embeds = self.in_scaler(source_embeds)
            # F.embedding's backward reduces duplicate ids by segment: the
            # clipped ids of non-fallback positions all hit row 0
            fallback = F.embedding(fallback_ids, self.fallback_embeddings.weight.to(self.dtype))
            inputs_embeds = torch.where(use_fallback[..., None], fallback, source_embeds)
            inputs_embeds = self.input_projection(inputs_embeds)

        hidden = self.encoder(sf, attention_mask, inputs_embeds=inputs_embeds,
                              target_priors=target_priors, lang_index=lang_index,
                              inference=inference,
                              deterministic=deterministic, generator=generator)
        if cfg.concat_last_hidden_state:
            pooled = hidden.reshape(sf.shape[0], -1)
            if pooled.shape[1] != cfg.hidden_size:
                # the JAX module's output heads add a (rows, H) residual to
                # this input and fail on any other width (ROADMAP C.21)
                raise ValueError(
                    f"concat_last_hidden_state pools {hidden.shape[1]} positions into a row of "
                    f"{pooled.shape[1]}; the output heads' residual block takes "
                    f"{cfg.hidden_size} (one position), as in the JAX package (ROADMAP C.21)")
        else:
            pooled = hidden[:, 0]

        predicted = self.output_projection(pooled)
        if cfg.single_head:
            predicted_in = predicted[..., : cfg.n_embd]
            predicted_out = predicted[..., cfg.n_embd:] if cfg.separate_out_embeddings else None
        else:
            predicted_in = predicted
            predicted_out = (
                self.output_projection_out(pooled) if cfg.separate_out_embeddings else None
            )
        if cfg.rescale_embeddings:
            predicted_in = self.scaler(predicted_in)
            if predicted_out is not None:
                predicted_out = self.out_scaler(predicted_out)

        if cfg.predict_bias:
            predicted_bias = self.bias_projection(pooled)[..., 0]
        else:
            predicted_bias = torch.zeros(sf.shape[0], dtype=self.dtype, device=sf.device)
        return predicted_in, predicted_out, predicted_bias

    @staticmethod
    def _truncated_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
        """N(0, std) cut at +-2 std: one draw, then only the elements
        outside redrawn until none is (``nn.init.trunc_normal_`` redraws the
        whole tensor each round, six times over at a 64M-element kernel)."""
        w = torch.randn(shape, generator=generator).mul_(std)
        flat = w.view(-1)
        redraw = torch.nonzero(flat.abs() > 2 * std).flatten()  # in index order
        while redraw.numel():
            values = torch.randn(redraw.numel(), generator=generator).mul_(std)
            flat[redraw] = values
            redraw = redraw[values.abs() > 2 * std]
        return w

    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` with flax's initializers
        (hypernet.py): lecun_normal Dense kernels (truncated normal, std
        sqrt(1/fan_in) / 0.8796), zero biases, normal(initializer_range)
        embedding tables, position embeddings, inter-token blocks and the
        relative-position table, LayerNorm ones/zeros, rescalers ones/zeros,
        lecun_normal language adapters with zero biases. The values differ from a JAX init (another
        random stream); the distributions are the same."""
        from .hypernet_t5 import T5LayerNorm

        std = self.config.initializer_range
        lecun = 0.87962566103423978  # the std of N(0, 1) cut at +-2
        with torch.no_grad():
            for name, mod in self.named_modules():
                if isinstance(mod, Dense):
                    s = (1.0 / mod.in_features) ** 0.5 / lecun
                    mod.weight.copy_(self._truncated_normal(mod.weight.shape, s, generator))
                    if mod.bias is not None:
                        mod.bias.zero_()
                elif isinstance(mod, (LayerNorm, T5LayerNorm)):
                    mod.weight.fill_(1.0)
                    if getattr(mod, "bias", None) is not None:
                        mod.bias.zero_()
                elif isinstance(mod, nn.Embedding):
                    mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * std)
                elif isinstance(mod, Rescaler):
                    mod.w.fill_(1.0)
                    mod.b.zero_()
                elif isinstance(mod, EncoderLayer) and hasattr(mod, "lang_adapter_down_weights"):
                    # lecun_normal of an (n_langs, in, out) table: fan_in n_langs * in
                    for w in (mod.lang_adapter_down_weights, mod.lang_adapter_up_weights):
                        s = (1.0 / (w.shape[0] * w.shape[1])) ** 0.5 / lecun
                        w.copy_(self._truncated_normal(w.shape, s, generator))
                    mod.lang_adapter_down_bias.zero_()
                    mod.lang_adapter_up_bias.zero_()
            for name in ("position_embeddings", "inter_token_blocks", "relative_attention_bias"):
                p = getattr(self.encoder, name, None)
                if p is not None:
                    p.copy_(torch.randn(p.shape, generator=generator) * std)


class PassthroughHypernet(nn.Module):
    """The n-shot baseline (``zett_tpu/models/hypernet.py:908-941``): plain
    learned tables indexed by each row's first surface-form id, in place of
    the hypernet. ``input_embeddings`` (vocab_size, n_embd), with
    ``separate_out_embeddings`` ``output_embeddings`` too, and with
    ``predict_bias`` a ``bias`` table (vocab_size, 1); flax ``nn.Embed``s,
    so their parameters are f32 (the trainer casts them to what JAX's state
    holds) and a lookup is in the compute dtype, past the table a row of
    NaN (``embed_take``). Takes ``Hypernet``'s call signature and reads only
    the surface forms."""

    def __init__(self, config: HypernetConfig, vocab_size: int, dtype=torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.vocab_size = vocab_size

        def table(width):
            return nn.Embedding(vocab_size, width)

        self.input_embeddings = table(cfg.n_embd)
        if cfg.separate_out_embeddings:
            self.output_embeddings = table(cfg.n_embd)
        if cfg.predict_bias:
            self.bias = table(1)

    def forward(self, target_surface_forms, target_priors=None, source_embeddings=None,
                lang_index=None, deterministic: bool = True, inference=None, generator=None):
        ids = target_surface_forms[..., 0]

        def lookup(mod):
            return embed_take(mod.weight, ids).to(self.dtype)

        predicted_in = lookup(self.input_embeddings)
        predicted_out = lookup(self.output_embeddings) \
            if self.config.separate_out_embeddings else None
        if self.config.predict_bias:
            predicted_bias = lookup(self.bias)[..., 0]
        else:
            predicted_bias = torch.zeros(ids.shape, dtype=self.dtype, device=ids.device)
        return predicted_in, predicted_out, predicted_bias
