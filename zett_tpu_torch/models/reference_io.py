"""Reference-format (upstream zett) hypernetwork checkpoints, read into the
port's Flax-layout parameter tree.

Counterpart of ``zett_tpu/models/reference_io.py``. The reference saves a
hypernet as an HF ``save_pretrained`` directory: ``config.json`` (the HF
backbone config with the ``hn_*`` arguments copied on) and
``flax_model.msgpack`` (the Flax tree under the HF FlaxRoberta names of
its ``model`` submodule, or HF FlaxT5's for ``hn_model_type="t5"``). The
published ``benjamin/zett-hypernetwork-*`` artifacts use that layout.
``msgpack_io.read_msgpack`` reads the file without ``flax``.

``convert_reference_hypernet`` renames the tree into the JAX package's
names and resolves the three structural differences:

- HF roberta embeddings add a token-type embedding (always index 0) to every
  position: ``token_type_embeddings[0]`` is folded into the position table;
- the reference reuses the layer-output LayerNorm for the language-adapter
  residual; the adapter's own ``adapter_ln`` receives a copy of it;
- the placeholder tables the reference allocates unconditionally (the
  one-row word table in source-embedding mode, the prior projection, the
  language table, the inter-token blocks) are dropped where the config does
  not use them.

``reference_config_to_ours`` maps the config: erf-gelu for roberta (HF's
default ``hidden_act``), the residual inter-token LayerNorms, and for T5 the
T5-compat encoder (``hypernet_t5.py``) with its epsilon and feed-forward.

Leaves are numpy arrays, or ``torch.bfloat16`` tensors for bf16 leaves
(numpy has no bfloat16); ``models.convert.flax_to_torch`` takes either.

    config, params = load_reference_hypernet("zett-hypernetwork-TinyLlama")
    hypernet = Hypernet(config, dtype=torch.bfloat16)
    hypernet.load_state_dict(flax_to_torch(params))
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .convert import flatten as _flatten, unflatten as _unflatten
from .hypernet import HypernetConfig
from .msgpack_io import read_msgpack

# (reference path suffix -> our path), applied after the `model.` prefix
# trim; per-layer renames are handled programmatically below
_EMBED_RENAMES = {
    ("embeddings", "word_embeddings", "embedding"): ("encoder", "word_embeddings", "embedding"),
    ("embeddings", "LayerNorm", "scale"): ("encoder", "embeddings_ln", "scale"),
    ("embeddings", "LayerNorm", "bias"): ("encoder", "embeddings_ln", "bias"),
    ("embeddings", "target_priors_projection", "kernel"): ("encoder", "prior_projection", "kernel"),
    ("embeddings", "target_priors_projection", "bias"): ("encoder", "prior_projection", "bias"),
    ("embeddings", "lang_embedding", "embedding"): ("encoder", "lang_embedding", "embedding"),
}

_LAYER_RENAMES = {
    ("attention", "self", "query"): ("attention", "query"),
    ("attention", "self", "key"): ("attention", "key"),
    ("attention", "self", "value"): ("attention", "value"),
    ("attention", "output", "dense"): ("attention", "out"),
    ("attention", "output", "LayerNorm"): ("attention_ln",),
    ("intermediate", "dense"): ("intermediate",),
    ("output", "dense"): ("output",),
    ("output", "LayerNorm"): ("output_ln",),
    ("output", "lang_adapter_down_weights"): ("lang_adapter_down_weights",),
    ("output", "lang_adapter_down_bias"): ("lang_adapter_down_bias",),
    ("output", "lang_adapter_up_weights"): ("lang_adapter_up_weights",),
    ("output", "lang_adapter_up_bias"): ("lang_adapter_up_bias",),
    # each inter-token exchange is a full residual attention block upstream:
    # Attention + the inter_token_{down,up}_ln LayerNorms
    ("inter_token_attention_down", "self", "query"): ("inter_token_down", "query"),
    ("inter_token_attention_down", "self", "key"): ("inter_token_down", "key"),
    ("inter_token_attention_down", "self", "value"): ("inter_token_down", "value"),
    ("inter_token_attention_down", "output", "dense"): ("inter_token_down", "out"),
    ("inter_token_attention_down", "output", "LayerNorm"): ("inter_token_down_ln",),
    ("inter_token_attention_up", "self", "query"): ("inter_token_up", "query"),
    ("inter_token_attention_up", "self", "key"): ("inter_token_up", "key"),
    ("inter_token_attention_up", "self", "value"): ("inter_token_up", "value"),
    ("inter_token_attention_up", "output", "dense"): ("inter_token_up", "out"),
    ("inter_token_attention_up", "output", "LayerNorm"): ("inter_token_up_ln",),
}

# t5-type layer renames: reference block paths are
# encoder/block/{i}/layer/{0,1}/... with the hyper extensions on the "layer"
# module itself; ours are encoder/layer_{i}/... (hypernet_t5.py T5Block)
_T5_LAYER_RENAMES = {
    ("layer", "0", "SelfAttention", "q"): ("attention", "q"),
    ("layer", "0", "SelfAttention", "k"): ("attention", "k"),
    ("layer", "0", "SelfAttention", "v"): ("attention", "v"),
    ("layer", "0", "SelfAttention", "o"): ("attention", "o"),
    ("layer", "0", "SelfAttention", "relative_attention_bias"): (
        "attention", "relative_attention_bias"),
    ("layer", "0", "layer_norm"): ("attn_ln",),
    ("layer", "1", "DenseReluDense", "wi"): ("ff", "wi"),
    ("layer", "1", "DenseReluDense", "wi_0"): ("ff", "wi_0"),
    ("layer", "1", "DenseReluDense", "wi_1"): ("ff", "wi_1"),
    ("layer", "1", "DenseReluDense", "wo"): ("ff", "wo"),
    ("layer", "1", "layer_norm"): ("ff_ln",),
    ("layer", "inter_token_attention_down", "q"): ("inter_token_down", "q"),
    ("layer", "inter_token_attention_down", "k"): ("inter_token_down", "k"),
    ("layer", "inter_token_attention_down", "v"): ("inter_token_down", "v"),
    ("layer", "inter_token_attention_down", "o"): ("inter_token_down", "o"),
    ("layer", "inter_token_attention_up", "q"): ("inter_token_up", "q"),
    ("layer", "inter_token_attention_up", "k"): ("inter_token_up", "k"),
    ("layer", "inter_token_attention_up", "v"): ("inter_token_up", "v"),
    ("layer", "inter_token_attention_up", "o"): ("inter_token_up", "o"),
    ("layer", "inter_token_layer_norm1"): ("inter_token_ln1",),
    ("layer", "inter_token_layer_norm2"): ("inter_token_ln2",),
}


def _convert_t5_path(sub, config, out, value) -> bool:
    """Map one reference t5-tree path (after the `model.` trim) into ours.
    Returns True if handled."""
    if sub[:2] == ("shared", "embedding"):
        if not config.embed_using_source_embeddings:
            out[("encoder", "word_embeddings", "embedding")] = value
        return True  # 1-row placeholder in source-embedding mode
    if sub[:2] == ("encoder", "target_priors_projection"):
        if config.embed_target_priors:
            out[("encoder", "prior_projection") + sub[2:]] = value
        return True
    if sub[:2] == ("encoder", "final_layer_norm"):
        out[("encoder", "final_ln") + sub[2:]] = value
        return True
    if sub[:3] == ("encoder", "block", "inter_token_blocks"):
        if config.add_inter_token_attention:
            out[("encoder", "inter_token_blocks")] = value
        return True
    if sub[0] == "encoder" and sub[1] == "block":
        i = sub[2]
        for ref_suffix, our_suffix in _T5_LAYER_RENAMES.items():
            if sub[3:3 + len(ref_suffix)] == ref_suffix:
                rest = sub[3 + len(ref_suffix):]
                out[("encoder", f"layer_{i}") + our_suffix + rest] = value
                return True
        raise KeyError(f"unmapped reference t5 layer param: {sub}")
    return False


def _leaf(v):
    """A tree leaf as numpy (``np.asarray`` in the JAX package), a bf16
    tensor kept as it is."""
    return v if isinstance(v, torch.Tensor) else np.asarray(v)


def convert_reference_hypernet(ref_params: dict, config: HypernetConfig) -> dict:
    """Rename a reference Hypernet param tree into ours. ``ref_params`` is
    the tree under "params" (or with the wrapper, which is stripped).
    Returns a nested dict of leaves."""
    if "params" in ref_params and isinstance(ref_params["params"], dict):
        ref_params = ref_params["params"]

    flat = {k: _leaf(v) for k, v in _flatten(ref_params).items()}

    out: Dict[Tuple[str, ...], object] = {}
    token_type: Optional[object] = None
    position: Optional[object] = None

    for path, value in flat.items():
        if path[0] == "model":
            sub = path[1:]
            if config.encoder_type == "t5":
                if _convert_t5_path(sub, config, out, value):
                    continue
                raise KeyError(f"unmapped reference t5 param: {path}")
            if sub[:2] == ("embeddings", "token_type_embeddings"):
                token_type = value
                continue
            if sub[:2] == ("embeddings", "position_embeddings"):
                position = value
                continue
            if sub in _EMBED_RENAMES:
                if sub[1] == "word_embeddings" and config.embed_using_source_embeddings:
                    continue  # 1-row placeholder table, unused
                if sub[1] == "target_priors_projection" and not config.embed_target_priors:
                    continue  # allocated unconditionally upstream, unused
                if sub[1] == "lang_embedding" and not config.embed_lang_id:
                    continue
                out[_EMBED_RENAMES[sub]] = value
                continue
            if sub == ("encoder", "layer", "inter_token_blocks"):
                # allocated unconditionally by the reference layer collection
                if config.add_inter_token_attention:
                    out[("encoder", "inter_token_blocks")] = value
                continue
            if sub[0] == "encoder" and sub[1] == "layer":
                i = sub[2]
                for ref_suffix, our_suffix in _LAYER_RENAMES.items():
                    if sub[3:3 + len(ref_suffix)] == ref_suffix:
                        rest = sub[3 + len(ref_suffix):]
                        out[("encoder", f"layer_{i}") + our_suffix + rest] = value
                        # the reference adapter residual reuses the layer
                        # output LayerNorm: mirror it into our adapter_ln
                        if (config.language_adapter_bottleneck_dim > 0
                                and ref_suffix == ("output", "LayerNorm")):
                            out[("encoder", f"layer_{i}", "adapter_ln") + rest] = value
                        break
                else:
                    raise KeyError(f"unmapped reference layer param: {sub}")
                continue
            raise KeyError(f"unmapped reference param: {path}")
        # top-level heads, scalers and the fallback table keep their names
        out[path] = value

    if position is not None:
        if token_type is not None:
            # token type 0 is added to every position upstream: fold it in
            position = position + token_type[0]
        out[("encoder", "position_embeddings")] = position

    return _unflatten(out)


# reference HypernetArgs / HF-config key -> HypernetConfig field
_CONFIG_KEYMAP = {
    "hn_hidden_size": "hidden_size",
    "hn_intermediate_size": "intermediate_size",
    "hn_n_layers": "num_hidden_layers",
    "hn_num_attention_heads": "num_attention_heads",
    "n_embd": "n_embd",
    "separate_out_embeddings": "separate_out_embeddings",
    "hn_surface_maxlen": "hn_surface_maxlen",
    "hn_embed_target_priors": "embed_target_priors",
    "hn_add_inter_token_attention": "add_inter_token_attention",
    "hn_inter_token_attention_bias_by_priors": "inter_token_attention_bias_by_priors",
    "hn_inter_token_attention_bias_scaler": "inter_token_attention_bias_scaler",
    "hn_n_inter_token_blocks": "n_inter_token_blocks",
    "hn_embed_lang_id": "embed_lang_id",
    "n_langs": "n_langs",
    "hn_embed_using_source_embeddings": "embed_using_source_embeddings",
    "original_vocab_size": "original_vocab_size",
    "hn_n_extra_tokens": "n_extra_tokens",
    "hn_rescale_embeddings": "rescale_embeddings",
    "hn_single_head": "single_head",
    "hn_predict_bias": "predict_bias",
    "hn_concat_last_hidden_state": "concat_last_hidden_state",
    "hn_language_adapter_bottleneck_dim": "language_adapter_bottleneck_dim",
    "max_position_embeddings": "max_position_embeddings",
    "vocab_size": "vocab_size",
    "pad_token_id": "pad_token_id",
    "layer_norm_eps": "layer_norm_eps",
    "hidden_dropout_prob": "hidden_dropout_prob",
    "attention_probs_dropout_prob": "attention_dropout_prob",
    "initializer_range": "initializer_range",
}

# HF config.json copies of the args may use the config-native names
_CONFIG_ALIASES = (
    "embed_target_priors", "add_inter_token_attention", "inter_token_attention_bias_by_priors",
    "inter_token_attention_bias_scaler", "n_inter_token_blocks", "embed_lang_id",
    "embed_using_source_embeddings", "language_adapter_bottleneck_dim", "num_attention_heads",
    "num_hidden_layers", "hidden_size", "intermediate_size",
)

_T5_KEYS = (("d_model", "hidden_size"), ("d_ff", "intermediate_size"),
            ("num_layers", "num_hidden_layers"), ("num_heads", "num_attention_heads"))


def reference_config_to_ours(ref: dict) -> HypernetConfig:
    """Map a reference checkpoint config (HF config.json with the hn_* args
    copied on, or a bare HypernetArgs dict) to HypernetConfig."""
    model_type = ref.get("hn_model_type", "roberta")
    if model_type not in ("roberta", "t5"):
        raise NotImplementedError(f"unknown reference hn_model_type {model_type!r}")
    kwargs = {}
    for src, dst in _CONFIG_KEYMAP.items():
        if ref.get(src) is not None:
            kwargs[dst] = ref[src]
    for alias in _CONFIG_ALIASES:
        if alias not in kwargs and ref.get(alias) is not None:
            kwargs[alias] = ref[alias]
    if model_type == "t5":
        # the T5-compat encoder (hypernet_t5.py); T5-native config keys
        kwargs["encoder_type"] = "t5"
        for t5_key, dst in _T5_KEYS:
            if dst not in kwargs and ref.get(t5_key) is not None:
                kwargs[dst] = ref[t5_key]
        kwargs["layer_norm_eps"] = ref.get("layer_norm_epsilon", 1e-6)
        ff = ref.get("feed_forward_proj", "relu")
        kwargs["hidden_act"] = "gated-gelu" if "gated" in ff else "relu"
        if ref.get("dropout_rate") is not None:
            kwargs.setdefault("hidden_dropout_prob", ref["dropout_rate"])
            kwargs.setdefault("attention_dropout_prob", ref["dropout_rate"])
        d_kv = ref.get("d_kv")
        if d_kv is not None and d_kv * kwargs["num_attention_heads"] != kwargs["hidden_size"]:
            raise NotImplementedError(
                "t5 checkpoints with num_heads*d_kv != d_model are not supported")
        if kwargs.get("num_attention_heads") is None:
            kwargs["num_attention_heads"] = kwargs["hidden_size"] // 64
        return HypernetConfig(**kwargs)
    if kwargs.get("num_attention_heads") is None:
        kwargs["num_attention_heads"] = kwargs["hidden_size"] // 64
    kwargs["hidden_act"] = ref.get("hidden_act", "gelu")  # HF roberta default
    if kwargs.get("add_inter_token_attention"):
        # reference exchanges are full residual attention blocks
        kwargs["inter_token_residual_ln"] = True
    return HypernetConfig(**kwargs)


def sync_config_to_params(config: HypernetConfig, params: dict) -> HypernetConfig:
    """Table-sized config fields must match the checkpoint (the reference's
    saved config.json carries the BACKBONE's vocab/position sizes, not the
    hypernet encoder's): read them off the converted params."""
    flat = _flatten(params)
    updates = {}
    for path, field in (
        (("encoder", "word_embeddings", "embedding"), "vocab_size"),
        (("encoder", "position_embeddings"), "max_position_embeddings"),
        (("fallback_embeddings", "embedding"), "n_extra_tokens"),
        (("encoder", "lang_embedding", "embedding"), "n_langs"),
        (("encoder", "inter_token_blocks"), "n_inter_token_blocks"),
    ):
        if path in flat:
            updates[field] = int(flat[path].shape[0])
    return dataclasses.replace(config, **updates)


def load_reference_hypernet(path: str) -> Tuple[HypernetConfig, dict]:
    """Read a reference checkpoint directory (HF save_pretrained layout:
    config.json + flax_model.msgpack) and return (our config, our params)
    in the Flax layout; ``models.convert.flax_to_torch`` makes the port
    ``Hypernet``'s state dict of them."""
    with open(os.path.join(path, "config.json")) as f:
        ref_config = json.load(f)
    config = reference_config_to_ours(ref_config)
    ref_params = read_msgpack(os.path.join(path, "flax_model.msgpack"))
    params = convert_reference_hypernet(ref_params, config)
    return sync_config_to_params(config, params), params
