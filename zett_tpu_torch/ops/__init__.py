"""Hand-written CUDA kernels of the port and their plain versions."""

from .attention_block import attention_block, attention_block_fused, attention_block_reference
from .attention_core import (
    attention_core,
    attention_core_bwd,
    attention_core_bwd_reference,
    attention_core_reference,
    merged_attention,
    merged_attention_reference,
    merged_attention_train,
)
from .encoder_layer import encoder_layer, encoder_layer_reference, layer_norm_flax_exact
from .viterbi_dp import viterbi_dp, viterbi_dp_plain

__all__ = [
    "attention_block",
    "attention_block_fused",
    "attention_block_reference",
    "attention_core",
    "attention_core_bwd",
    "attention_core_bwd_reference",
    "attention_core_reference",
    "encoder_layer",
    "encoder_layer_reference",
    "layer_norm_flax_exact",
    "merged_attention",
    "merged_attention_reference",
    "merged_attention_train",
    "viterbi_dp",
    "viterbi_dp_plain",
]
