"""Where each supported backbone keeps its vocab-dependent weights in the HF
state dict, and the family dispatch (counterpart of
``zett_tpu/models/backbones/registry.py`` for gpt2, the Llama family and
RoBERTa).

GPT-2 ties its output embeddings to the input table: logits use
``transformer.wte.weight``, and HF writes the same table as
``lm_head.weight``. The Llama family (llama, mistral, gemma, qwen2) keeps
its input table in ``model.embed_tokens.weight`` and, when untied, its
output table in ``lm_head.weight``; a tied checkpoint carries no
``lm_head.weight``. RoBERTa and XLM-R keep the input table in
``roberta.embeddings.word_embeddings.weight`` and tie their MLM decoder
(``lm_head.decoder.weight``) to it; they alone have an lm-head bias, which
HF writes twice (``lm_head.bias``, ``lm_head.decoder.bias``).
"""

from __future__ import annotations

import re

from .llama import FAMILY as LLAMA_FAMILY
from .roberta import BIAS_KEYS as _ROBERTA_BIAS
from .roberta import FAMILY as ROBERTA_FAMILY
from .roberta import WORD_EMBEDDINGS as _ROBERTA_WORDS

IN_EMBEDDING_KEYS = {"gpt2": "transformer.wte.weight",
                     **{t: "model.embed_tokens.weight" for t in LLAMA_FAMILY},
                     **{t: _ROBERTA_WORDS for t in ROBERTA_FAMILY}}
# the key a tied head's table is written under (the input table's copy)
TIED_HEAD_KEYS = {"gpt2": "lm_head.weight", **{t: "lm_head.weight" for t in LLAMA_FAMILY},
                  **{t: "lm_head.decoder.weight" for t in ROBERTA_FAMILY}}
# the lm-head bias, zeroed by a splice (JAX ``BIAS_PATHS``)
BIAS_KEYS = {t: _ROBERTA_BIAS for t in ROBERTA_FAMILY}
# the untied output table's key (JAX ``OUT_EMBEDDING_PATHS``): gpt2's and
# gemma's heads are tied
OUT_EMBEDDING_KEYS = {t: "lm_head.weight" for t in LLAMA_FAMILY if t != "gemma"}

# The HF weights the JAX package's converters keep (loader.py convert_gpt2,
# convert_llama); anything else, such as GPT-2's attention-mask buffers and
# llama's rotary inv_freq buffers, is dropped on the way through a transfer
# (a tied llama's lm_head.weight too: ``splice_embeddings``).
_GPT2_KEEP = re.compile(
    r"transformer\.(wte|wpe)\.weight"
    r"|transformer\.ln_f\.(weight|bias)"
    r"|lm_head\.weight"
    r"|transformer\.h\.\d+\.(ln_1|ln_2|attn\.c_attn|attn\.c_proj|mlp\.c_fc|mlp\.c_proj)"
    r"\.(weight|bias)"
)
_LLAMA_KEEP = re.compile(
    r"model\.embed_tokens\.weight"
    r"|model\.norm\.weight"
    r"|lm_head\.weight"
    r"|model\.layers\.\d+\.(input_layernorm|post_attention_layernorm)\.weight"
    r"|model\.layers\.\d+\.(self_attn|mlp)\.\w+_proj\.(weight|bias)"
)

# the keys ``loader.invert_roberta`` writes (``position_ids`` buffers and a
# pooler are dropped, as ``convert_roberta`` drops them)
_ROBERTA_KEEP = re.compile(
    r"roberta\.embeddings\.(word|position|token_type)_embeddings\.weight"
    r"|roberta\.embeddings\.LayerNorm\.(weight|bias)"
    r"|lm_head\.(dense|layer_norm)\.(weight|bias)"
    r"|lm_head\.bias|lm_head\.decoder\.(weight|bias)"
    r"|roberta\.encoder\.layer\.\d+\.(attention\.self\.(query|key|value)"
    r"|attention\.output\.dense|attention\.output\.LayerNorm|intermediate\.dense"
    r"|output\.dense|output\.LayerNorm)\.(weight|bias)"
)

KEEP_KEYS = {"gpt2": _GPT2_KEEP, **{t: _LLAMA_KEEP for t in LLAMA_FAMILY},
             **{t: _ROBERTA_KEEP for t in ROBERTA_FAMILY}}


def is_output_tied(model_type: str, config=None) -> bool:
    """Whether the logits use the input table (``registry.py:114``): always
    for gpt2; the config's ``tie_word_embeddings`` (``config.json``'s dict
    or a backbone config) for the Llama family."""
    check_supported(model_type)
    if model_type in LLAMA_FAMILY and config is not None:
        return _tied(config)
    return model_type not in OUT_EMBEDDING_KEYS


def _tied(config) -> bool:
    if config is None:
        return False
    if isinstance(config, dict):
        return bool(config.get("tie_word_embeddings", False))
    return bool(getattr(config, "tie_word_embeddings", False))


def resolve_out_path(model_type: str, state_dict: dict, config=None):
    """The HF key of untied output embeddings where the checkpoint holds
    them, else None (``registry.py:48-61``: presence decides). A config
    (``config.json``'s dict or a backbone config) that ties the embeddings
    drops the key first, as ``loader.convert_llama`` does: a torch state
    dict of a tied model lists ``lm_head.weight`` too."""
    check_supported(model_type)
    key = OUT_EMBEDDING_KEYS.get(model_type)
    if key is None or _tied(config):
        return None
    return key if key in state_dict else None


def config_from_hf(model_type: str, config_json: dict, remat_blocks: bool = False):
    """The backbone config of a family from its ``config.json`` dict."""
    import dataclasses

    check_supported(model_type)
    if model_type == "gpt2":
        from .gpt2 import GPT2Config as Config
    elif model_type in ROBERTA_FAMILY:
        from .roberta import RobertaConfig as Config
    else:
        from .llama import LlamaConfig as Config
    return dataclasses.replace(Config.from_hf(config_json), remat_blocks=remat_blocks)


def build_model(model_type: str, config, state_dict, dtype):
    """The backbone module of a family (``registry.py:86``): its config
    (``config_from_hf``) and HF state dict, weights held as stored and cast
    to ``dtype`` at use."""
    check_supported(model_type)
    if model_type == "gpt2":
        from .gpt2 import GPT2LMHeadModel as Model
    elif model_type in ROBERTA_FAMILY:
        from .roberta import RobertaForMaskedLM as Model
    else:
        from .llama import LlamaForCausalLM as Model
    return Model(config, state_dict, dtype)


def headless_model(model_type: str, model):
    """The callable ``(input_ids, attention_mask, table) -> final hidden
    states`` of a backbone without its lm head (``registry.py:120``): the
    chunked losses compute their logits chunk by chunk from these. For
    gpt2, the hidden states after ``ln_f``; for the Llama family, after the
    last RMSNorm; for RoBERTa, the last layer's output (the MLM head's
    transform runs per chunk: ``mlm_head``)."""
    check_supported(model_type)
    return model.hidden_states


def mlm_head(model_type: str, model):
    """The MLM head's transform before the decoder (``engine.py:437-453``),
    or None for a family without one."""
    check_supported(model_type)
    return model.lm_head_transform if model_type in ROBERTA_FAMILY else None


def check_supported(model_type: str) -> None:
    if model_type not in IN_EMBEDDING_KEYS:
        raise NotImplementedError(f"backbone {model_type!r} is not ported (gpt2, "
                                  f"{', '.join(LLAMA_FAMILY + ROBERTA_FAMILY)} are)")
