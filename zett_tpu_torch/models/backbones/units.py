"""The backbones' parameter layout: the weights of each block in a module
of its own (an FSDP unit under ``parallel.sharding.shard_backbone``) and
the rest (tables, final norm, heads) on the model itself, every weight
under its HF key ("." held as "__", which ``nn.ParameterDict`` keys cannot
hold).

A block's forward runs the owning model's block function, which reads its
weights by HF key (``raw``) at call time, so under FSDP it sees the
gathered weights between the unit's hooks. ``named_hf_parameters`` yields
(HF key, parameter) in the checkpoint's key order whatever the sharding.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence

import torch
from torch import nn


def _params(keys: Iterable[str], state_dict: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k.replace(".", "__"): nn.Parameter(state_dict[k].detach().clone())
                             for k in keys})


class Block(nn.Module):
    """One block's weights; ``forward(*args)`` is ``run(*args)``."""

    def __init__(self, keys: Sequence[str], state_dict: Dict[str, torch.Tensor],
                 run: Callable):
        super().__init__()
        self.weights = _params(keys, state_dict)
        self.__dict__["run"] = run  # the owner's method: not a submodule

    def forward(self, *args):
        return self.run(*args)


class BlockModel(nn.Module):
    """Base of the three backbones: ``self.weights`` (the model's own
    weights) and ``self.blocks`` (one ``Block`` a layer)."""

    def _hold(self, keys: List[str], block_keys: List[List[str]],
              state_dict: Dict[str, torch.Tensor], run: Callable) -> None:
        in_blocks = {k for ks in block_keys for k in ks}
        self.weights = _params([k for k in keys if k not in in_blocks], state_dict)
        self.blocks = nn.ModuleList(Block(ks, state_dict, run) for ks in block_keys)
        owner = {k: self.weights for k in keys if k not in in_blocks}
        for block, ks in zip(self.blocks, block_keys):
            owner.update({k: block.weights for k in ks})
        # plain attributes, not submodules
        self.__dict__["_owner"] = owner
        self.__dict__["_keys"] = list(keys)

    def raw(self, key: str) -> torch.Tensor:
        return self._owner[key][key.replace(".", "__")]

    def w(self, key: str) -> torch.Tensor:
        return self.raw(key).to(self.dtype)

    def named_hf_parameters(self):
        for k in self._keys:
            yield k, self.raw(k)
