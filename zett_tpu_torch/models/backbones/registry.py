"""Where each supported backbone keeps its vocab-dependent weights in the HF
state dict (the gpt2 entries of ``zett_tpu/models/backbones/registry.py``).

GPT-2 ties its output embeddings to the input table: logits use
``transformer.wte.weight``, and HF writes the same table as
``lm_head.weight``. It has no lm-head bias.
"""

from __future__ import annotations

import re

IN_EMBEDDING_KEYS = {"gpt2": "transformer.wte.weight"}

# The HF GPT-2 weights the JAX package's gpt2 converter keeps
# (loader.py convert_gpt2); anything else, such as the attention-mask
# buffers, is dropped on the way through a transfer.
_GPT2_KEEP = re.compile(
    r"transformer\.(wte|wpe)\.weight"
    r"|transformer\.ln_f\.(weight|bias)"
    r"|lm_head\.weight"
    r"|transformer\.h\.\d+\.(ln_1|ln_2|attn\.c_attn|attn\.c_proj|mlp\.c_fc|mlp\.c_proj)"
    r"\.(weight|bias)"
)

KEEP_KEYS = {"gpt2": _GPT2_KEEP}


def is_output_tied(model_type: str, config: dict = None) -> bool:
    """Whether the logits use the input table (``registry.py:114``): always
    for gpt2."""
    check_supported(model_type)
    return True


def resolve_out_path(model_type: str, state_dict: dict):
    """The HF key of untied output embeddings present in the state dict,
    or None when tied (``registry.py:48``); gpt2's head is tied."""
    check_supported(model_type)
    return None


def headless_model(model_type: str, model):
    """The callable ``(input_ids, attention_mask, wte) -> final hidden
    states`` of a backbone without its lm head (``registry.py:120``): the
    chunked CLM loss computes its logits chunk by chunk from these. For
    gpt2, the hidden states after ``ln_f``."""
    check_supported(model_type)
    return model.hidden_states


def check_supported(model_type: str) -> None:
    if model_type not in IN_EMBEDDING_KEYS:
        raise NotImplementedError(f"backbone {model_type!r} is not ported (gpt2 is)")
