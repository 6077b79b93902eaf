from .core import batched_inference, get_sample_indices, transfer

__all__ = ["batched_inference", "get_sample_indices", "transfer"]
