"""Data parallelism for batched generation: one process per GPU.

The PyTorch idiom for the JAX package's 1-D ``dp`` mesh
(``cfgpp_tpu/parallel/mesh.py``): ``torchrun --nproc_per_node N`` starts one
process per GPU and sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``.
Rank r runs on ``cuda:LOCAL_RANK`` and takes its contiguous
``batch_size / world`` share of every global batch, which is where JAX's
``P("dp")`` places a batch's rows.  No collective is needed: each sample's
random streams are keyed by its global index (``DiffusionEngine.
sample_batch``), so an image does not depend on the rank that draws it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence

import torch


@dataclass(frozen=True)
class DataParallel:
    """This process's place among the ranks."""
    rank: int = 0
    world: int = 1
    local_rank: int = 0

    @property
    def device(self) -> torch.device:
        """The rank's GPU."""
        return torch.device("cuda", self.local_rank)


def data_parallel() -> DataParallel:
    """The rank, world size and local rank as torchrun sets them (a lone
    process is rank 0 of 1)."""
    env = os.environ
    dp = DataParallel(rank=int(env.get("RANK", 0)),
                      world=int(env.get("WORLD_SIZE", 1)),
                      local_rank=int(env.get("LOCAL_RANK", 0)))
    if not 0 <= dp.rank < dp.world or dp.local_rank < 0:
        raise ValueError(f"RANK={dp.rank}, WORLD_SIZE={dp.world},"
                         f" LOCAL_RANK={dp.local_rank}: no such rank")
    return dp


def shard_indices(indices: Sequence[int], rank: int, world: int) -> List[int]:
    """Rank ``rank``'s contiguous share of a global batch of ``indices``."""
    if len(indices) % world:
        raise ValueError(f"a batch of {len(indices)} does not split over"
                         f" {world} ranks")
    n = len(indices) // world
    return list(indices[rank * n:(rank + 1) * n])
