"""The data-parallel layout (counterpart of ``zett_tpu/parallel/sharding.py``).

- The batch (``BATCH_SPLIT``, ``BATCH_PSPECS``'s "data" axis): the LM rows
  (``input_ids``, ``attention_mask``, ``labels``, ``byte_lengths``) are split
  over the ranks on the host (``local_batch``); the vocab rows
  (``target_surface_forms``, ``target_priors``, ``mask``, ``ids_to_embed``)
  are split at the hypernet's input (``multihost.process_slice``): every rank
  keeps the whole (V,) vectors, since the logits read every vocab row once
  the ranks' predicted tables are gathered. Anything else is replicated.
- The hypernet is replicated and its gradients summed over the ranks.
- The backbone is fully sharded with FSDP2 (``fully_shard``) over every
  rank, the counterpart of ``fsdp_rules``: each block is a unit of its own
  and the model itself holds the tables, the final norm and the heads
  (``shard_backbone``). Gradients are summed, not averaged, over the ranks:
  each rank's loss is its share of the global mean.

Tensor parallelism on a "model" axis (``HYPERNET_RULES``,
``BACKBONE_RULES``) is not ported: ROADMAP A.17.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from .multihost import process_slice

VOCAB_KEYS = ("target_surface_forms", "target_priors", "mask", "ids_to_embed")
LM_KEYS = ("input_ids", "attention_mask", "labels", "byte_lengths")
# the batch keys whose leading axis is split over the ranks, and where
BATCH_SPLIT: Dict[str, str] = {**{k: "vocab" for k in VOCAB_KEYS},
                               **{k: "lm" for k in LM_KEYS}}


def check_divisible(batch: Dict[str, Any], world: int) -> None:
    """ValueError, naming both numbers, where a split key's rows do not
    split evenly over ``world`` ranks."""
    for key, kind in BATCH_SPLIT.items():
        v = batch.get(key)
        if v is None or not hasattr(v, "shape") or not len(v.shape):
            continue
        n = int(v.shape[0])
        if n % world:
            what = "vocab batch" if kind == "vocab" else "LM batch"
            raise ValueError(f"the global {what} of {n} rows ({key}) does not split over "
                             f"{world} ranks")


def local_batch(batch: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """The batch as rank ``rank`` of ``world`` holds it: its share of the LM
    rows, everything else whole (the counterpart of ``globalize_batch``:
    every rank built the same global batch)."""
    check_divisible(batch, world)
    out = {}
    for k, v in batch.items():
        if BATCH_SPLIT.get(k) == "lm" and hasattr(v, "shape") and len(v.shape):
            v = np.asarray(v)[process_slice(v.shape[0], rank, world)]
        out[k] = v
    return out


def fsdp_units(model: nn.Module) -> List[nn.Module]:
    """The modules of a backbone that become ``fully_shard`` units below the
    model itself: its blocks (gpt2's ``transformer.h.N``, the Llama family's
    ``model.layers.N``, (XLM-)RoBERTa's ``roberta.encoder.layer.N``;
    ``models/backbones/units.py``). The tables, the final norm and the heads
    stay on the model, the root unit."""
    return list(model.blocks)


def _fsdp():
    try:
        from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    except ImportError:  # torch before 2.6 kept FSDP2 here
        from torch.distributed._composable.fsdp import (fully_shard,
                                                        register_fsdp_forward_method)
    return fully_shard, register_fsdp_forward_method


def _sum_gradients(unit) -> None:
    """Reduce-scatter the unit's gradients as a sum (FSDP2 averages by
    default)."""
    if hasattr(unit, "set_force_sum_reduction_for_comms"):
        unit.set_force_sum_reduction_for_comms(True)
    if hasattr(unit, "set_gradient_divide_factor"):
        unit.set_gradient_divide_factor(1.0)
    else:
        unit.set_reduce_scatter_divide_factor(1.0)


def shard_backbone(model: nn.Module, device: torch.device) -> nn.Module:
    """``fully_shard`` the backbone (already on ``device``) over every rank
    of the default group: each block, then the model; ``hidden_states`` (the
    headless model the chunked losses call) runs under the model's FSDP
    hooks as ``forward`` does. Its parameters become DTensors sharded on
    their first axis; ``named_hf_parameters`` yields them."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    fully_shard, register = _fsdp()
    mesh = init_device_mesh(device.type, (dist.get_world_size(),))
    units = fsdp_units(model)
    for unit in units:
        fully_shard(unit, mesh=mesh)
    fully_shard(model, mesh=mesh)
    register(model, "hidden_states")
    for unit in (*units, model):
        _sum_gradients(unit)
    return model


def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # torch before 2.5
        from torch.distributed._tensor import DTensor
    return DTensor


def is_sharded(t) -> bool:
    """Whether ``t`` is a DTensor (an FSDP-sharded parameter or gradient)."""
    return isinstance(t, _dtensor_type())


def local_part(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view of its storage), else ``t``."""
    return t.to_local() if is_sharded(t) else t


def full_tensor(local: torch.Tensor, like) -> torch.Tensor:
    """The whole tensor of which ``local`` is this rank's shard, laid out
    as the sharded parameter ``like`` (a collective every rank calls)."""
    DTensor = _dtensor_type()
    return DTensor.from_local(local.contiguous(), like.device_mesh, like.placements,
                              shape=like.shape, stride=like.stride()).full_tensor()


def local_chunk(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's shard of the whole tensor ``full``, as the sharded
    parameter ``like`` holds its own: ``torch.chunk`` over the first axis,
    FSDP's split."""
    import torch.distributed as dist

    chunks = torch.chunk(full, dist.get_world_size(), dim=0)
    rank = dist.get_rank()
    part = chunks[rank] if rank < len(chunks) else full[:0]
    want = local_part(like).shape
    if tuple(part.shape) != tuple(want):
        raise ValueError(f"a shard of {tuple(full.shape)} is {tuple(part.shape)} here, the "
                         f"parameter's is {tuple(want)}")
    return part
