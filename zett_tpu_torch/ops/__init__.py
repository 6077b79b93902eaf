"""Hand-written CUDA kernels of the transfer path and their plain versions."""

from .attention_core import attention_core, attention_core_reference
from .encoder_layer import encoder_layer, encoder_layer_reference, layer_norm_flax_exact

__all__ = [
    "attention_core",
    "attention_core_reference",
    "encoder_layer",
    "encoder_layer_reference",
    "layer_norm_flax_exact",
]
