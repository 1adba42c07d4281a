"""Arena geometry: the shared vocabulary of the HotMem and vanilla managers.

An *arena* is the device-memory region holding per-request decode state
(KV caches and/or SSM/LRU state) for one serving replica.  HotMem divides it
into ``n_partitions`` fixed-size partitions of ``partition_tokens`` (the
request-declared token budget — the paper's user-declared function memory
limit).  The vanilla baseline divides the same capacity into blocks of
``block_tokens`` (the analogue of Linux's 128 MiB memory blocks).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ModelConfig


def state_bytes_for_tokens(cfg: ModelConfig, tokens: int) -> int:
    """Device bytes of per-request decode state at a given context length
    (sums the cache spec tree for batch=1; window caches cap at the window,
    SSM/LRU state is constant — exactly what a partition must hold).
    Spec dtypes are torch dtypes here, so the item size comes from the
    dtype itself (the JAX package reads it through ``np.dtype``)."""
    from repro_torch.models.model import cache_specs
    from repro_torch.models.layers import tree_map_specs
    total = 0

    def acc(spec):
        nonlocal total
        total += math.prod(spec.shape) * spec.dtype.itemsize

    tree_map_specs(acc, cache_specs(cfg, 1, max(tokens, 1)))
    return total


@dataclasses.dataclass(frozen=True)
class ArenaSpec:
    """Geometry of one replica's state arena."""
    partition_tokens: int          # request-declared budget (paper: mem limit)
    n_partitions: int              # concurrency factor N (paper: boot param)
    block_tokens: int = 128        # vanilla granularity (paper: 128MiB block)
    bytes_per_partition: int = 0   # device bytes of one partition

    @property
    def blocks_per_partition(self) -> int:
        return math.ceil(self.partition_tokens / self.block_tokens)

    @property
    def n_blocks(self) -> int:     # same total capacity for both managers
        return self.n_partitions * self.blocks_per_partition

    @property
    def bytes_per_block(self) -> int:
        return math.ceil(self.bytes_per_partition
                         / self.blocks_per_partition)

    @property
    def arena_bytes(self) -> int:
        return self.bytes_per_partition * self.n_partitions

    @classmethod
    def from_model(cls, cfg: ModelConfig, partition_tokens: int,
                   n_partitions: int, block_tokens: int = 128) -> "ArenaSpec":
        return cls(partition_tokens=partition_tokens,
                   n_partitions=n_partitions,
                   block_tokens=block_tokens,
                   bytes_per_partition=state_bytes_for_tokens(
                       cfg, partition_tokens))


@dataclasses.dataclass
class ReclaimEvent:
    """Outcome of one shrink/unplug request (the paper's unplug metric)."""
    requested_units: int           # partitions (hotmem) or blocks (vanilla)
    reclaimed_units: int
    reclaimed_bytes: int
    migrated_blocks: int           # 0 for HotMem by construction
    migrated_bytes: int
    wall_seconds: float = 0.0
