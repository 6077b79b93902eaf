"""Multi-GPU execution on ``torch.distributed`` (counterpart of
``zett_tpu/parallel``): one process a GPU, the batch split over the ranks,
the frozen backbone fully sharded (``sharding.shard_backbone``)."""

from .multihost import (agree_flag, all_reduce_sum, batch_seed_for_step, device_for,
                        gather_rows, initialize_distributed, process_slice, rank_and_world,
                        should_initialize_distributed)
from .sharding import BATCH_SPLIT, check_divisible, local_batch, shard_backbone

__all__ = ["BATCH_SPLIT", "agree_flag", "all_reduce_sum", "batch_seed_for_step",
           "check_divisible", "device_for", "gather_rows", "initialize_distributed",
           "local_batch", "process_slice", "rank_and_world", "shard_backbone",
           "should_initialize_distributed"]
