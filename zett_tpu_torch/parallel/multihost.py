"""Process group set-up and the collectives of the data-parallel layout
(counterpart of ``zett_tpu/parallel/multihost.py``).

One process runs on each GPU (``cuda:LOCAL_RANK``). As in the JAX package,
every rank builds the identical global batch from the same seeds and keeps
its own share of its rows (``sharding.local_batch``), so the data path
needs no communication. The backend follows the device: NCCL for
``cuda``, gloo for the CPU (what the CPU tests spawn); it is never probed
for and never swapped, and a collective that fails raises.

Launch with ``torchrun --nproc-per-node N -m zett_tpu_torch.training
CONFIG.json`` (the group comes from torchrun's ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``), or give each process the JAX CLI's
flags, ``--distributed-coordinator HOST:PORT --distributed-num-processes N
--distributed-process-id I``, or the config's ``distributed`` section with
the same three keys.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def should_initialize_distributed(config: dict) -> bool:
    """The CLIs join a process group when the config carries a
    ``distributed`` section or torchrun's environment is present."""
    return bool(config.get("distributed") or os.environ.get("WORLD_SIZE"))


def backend_for(device_type: str) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: str = "cuda") -> Tuple[int, int]:
    """``init_process_group`` with the explicit arguments (the coordinator
    ``HOST:PORT`` of rank 0, the world size, this rank), or from torchrun's
    environment when all three are None. Returns (rank, world size); a
    group already up is returned as it is. On the card, call it after
    ``torch.cuda.set_device(device_for(...))``."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    explicit = (coordinator_address, num_processes, process_id)
    backend = backend_for(device_type)
    if all(v is None for v in explicit):
        dist.init_process_group(backend, init_method="env://")
    elif any(v is None for v in explicit):
        raise ValueError("distributed: give the coordinator address, the number of processes "
                         f"and the process id together (got {explicit})")
    else:
        address = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=address, world_size=int(num_processes),
                                rank=int(process_id))
    return dist.get_rank(), dist.get_world_size()


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the default group, (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def add_flags(parser) -> None:
    """The JAX CLIs' per-process identity flags (``zett_tpu/training/
    __main__.py:53-57``)."""
    parser.add_argument("--distributed-coordinator", default=None,
                        help="HOST:PORT of rank 0's process group store")
    parser.add_argument("--distributed-num-processes", type=int, default=None)
    parser.add_argument("--distributed-process-id", type=int, default=None)


def flags_section(args) -> Optional[dict]:
    """The flags as a config's ``distributed`` section, or None without
    them."""
    section = {"coordinator_address": args.distributed_coordinator,
               "num_processes": args.distributed_num_processes,
               "process_id": args.distributed_process_id}
    return section if any(v is not None for v in section.values()) else None


def join_group(section: Optional[dict], device_type: str):
    """A CLI's process group (``zett_tpu/training/__main__.py:115-130``):
    from a ``distributed`` section (``coordinator_address``,
    ``num_processes``, ``process_id``), else from torchrun's environment.
    Returns (rank, world size, this process's device), or (0, 1, None)
    without either: one process. On the card the process takes
    ``cuda:<local rank>`` before the group starts."""
    if not should_initialize_distributed({"distributed": section}):
        return 0, 1, None
    section = section or {}
    rank = section.get("process_id")
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    dev = device_for(device_type, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank, world = initialize_distributed(section.get("coordinator_address"),
                                         section.get("num_processes"),
                                         section.get("process_id"), device_type=dev.type)
    print(f"distributed: rank {rank} of {world} on {dev} ({backend_for(dev.type)})",
          flush=True)
    return rank, world, dev


def local_rank(rank: int) -> int:
    """torchrun's ``LOCAL_RANK``, else the rank modulo this host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count()
    return rank % n if n else 0


def device_for(device_type: str, rank: int) -> torch.device:
    """``cuda:<local rank>`` on the card, ``cpu`` otherwise."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank(rank))
    return torch.device(device_type)


def batch_seed_for_step(base_seed: int, step: int) -> int:
    """The per-step seed every rank derives alike (``multihost.py:62``), so
    the sampled tokenizer is the same on all ranks without a broadcast."""
    return (base_seed * 1_000_003 + step * 7919) % (2**31 - 1)


def process_slice(n: int, rank: Optional[int] = None, world: Optional[int] = None) -> slice:
    """This rank's contiguous share of a length-``n`` leading axis
    (``multihost.py:107``); ValueError, naming both numbers, when ``n`` does
    not split evenly."""
    if rank is None or world is None:
        rank, world = rank_and_world()
    if n % world:
        raise ValueError(f"a batch of {n} rows does not split over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def _collective(new: str, old: str):
    """A collective under its current name (torch 2.13 renamed the
    ``*_tensor`` ones ``*_single``), the older one before it."""
    return getattr(dist, new, None) or getattr(dist, old)


class _GatherRows(torch.autograd.Function):
    """All-gather of row blocks; the backward reduce-scatters (sums each
    block's gradient over the ranks, hands each rank its own)."""

    @staticmethod
    def forward(ctx, t):
        out = t.new_empty((t.shape[0] * dist.get_world_size(), *t.shape[1:]))
        _collective("all_gather_single", "all_gather_into_tensor")(out, t.contiguous())
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.new_empty((grad.shape[0] // dist.get_world_size(), *grad.shape[1:]))
        _collective("reduce_scatter_single", "reduce_scatter_tensor")(out, grad.contiguous())
        return out


def gather_rows(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The ranks' row blocks of ``t`` concatenated in rank order, with
    autograd: the backward sums each block's gradient over the ranks and
    hands every rank its own block's."""
    return None if t is None else _GatherRows.apply(t)


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> None:
    """Sums each tensor over the ranks in place: one collective a dtype, on
    a flat buffer."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def reduce_scalar(value: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor summed over the ranks (a new tensor; no autograd)."""
    out = value.detach().clone()
    dist.all_reduce(out)
    return out


def agree_flag(flag: bool, device) -> bool:
    """Whether any rank's ``flag`` is set: one all-reduce (max) of an int
    on ``device`` (the preemption agreement, ``engine.py:806-838``)."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
