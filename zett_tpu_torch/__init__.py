"""PyTorch / CUDA port of zett_tpu's zero-shot transfer path for NVIDIA Hopper."""
