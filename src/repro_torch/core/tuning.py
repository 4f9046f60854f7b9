"""Tiling autotuner: chunk sizes of the fused query and the chunked build,
from the device's memory limits and the problem shape.

The counterpart of ``repro.core.tuning``, with the same sizing model.  The
limits come from the device a tensor lives on: on the card,
``torch.cuda.get_device_properties`` gives the L2 size (the working-set
budget of one streamed chunk) and the total memory; on the CPU a fixed
prior stands in.  Nothing is probed or cached on disk, so a result depends
on the device model and the shape only, and is the same from run to run.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "MemoryLimits",
    "TileConfig",
    "CPU_LIMITS",
    "device_limits",
    "autotune_tiles",
    "autotune_build_block_n",
]


@dataclasses.dataclass(frozen=True)
class MemoryLimits:
    """Per-device memory budget the tiler plans against: ``fast_bytes`` for
    one streamed chunk's working set, ``hbm_bytes`` for whole-array
    residency."""

    fast_bytes: int
    hbm_bytes: int


#: Per-core L2 of a server CPU; "hbm" is host RAM.  The JAX package's prior.
CPU_LIMITS = MemoryLimits(fast_bytes=2 * 2**20, hbm_bytes=32 * 2**30)


def device_limits(device: torch.device | str) -> MemoryLimits:
    """Memory limits of ``device``: the card's own L2 size and total memory,
    or :data:`CPU_LIMITS` for the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return CPU_LIMITS
    if device.type != "cuda":
        raise ValueError(f"no memory model for device {device}")
    props = torch.cuda.get_device_properties(device)
    return MemoryLimits(fast_bytes=int(props.L2_cache_size), hbm_bytes=int(props.total_memory))


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Resolved tiling of the fused query.

    * ``block_n`` — data points per streamed chunk (one loop step).
    * ``survivor_cap`` — compaction width: the per-chunk budget of rows
      beating the carried pool minimum that merge at the pruned width; a
      chunk exceeding it takes the exact full-width fallback (same result).
    """

    block_n: int
    survivor_cap: int = 256

    def __post_init__(self):
        if self.block_n < 1:
            raise ValueError(f"block_n must be >= 1, got {self.block_n}")
        if self.survivor_cap < 1:
            raise ValueError(f"survivor_cap must be >= 1, got {self.survivor_cap}")


def _round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def _round_down(v: int, mult: int) -> int:
    return (v // mult) * mult


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(v, hi))


_BLOCK_QUANTUM = 512
_BLOCK_MAX = 1 << 16
_CAP_QUANTUM = 64
_CAP_SAFETY = 8


def autotune_tiles(
    n: int,
    d: int,
    m: int,
    pool: int,
    *,
    limits: MemoryLimits,
    n_subspaces: int = 8,
    itemsize: int = 4,
) -> TileConfig:
    """Pick ``(block_n, survivor_cap)`` for a streamed query.

    The JAX package's model: the largest 512-multiple ``block_n`` (clamped
    to [512, 65536], to about n/8, and to at least the pool) whose chunk
    working set ``block_n * (Ns*4 + d*itemsize + m*4)`` fits
    ``limits.fast_bytes`` beside the carried pool ``2*3*m*pool*4``; and a
    ``survivor_cap`` of ``_CAP_SAFETY`` times the expected pool entrants
    per chunk ``pool * block_n / n``, a 64-multiple.
    """
    if min(n, d, m, pool) < 1:
        raise ValueError(f"n/d/m/pool must all be >= 1, got {n}/{d}/{m}/{pool}")
    per_point = n_subspaces * 4 + d * itemsize + m * 4
    carried = 2 * 3 * m * pool * 4
    budget = max(limits.fast_bytes - carried, _BLOCK_QUANTUM * per_point)
    block_n = _clamp(
        _round_down(budget // per_point, _BLOCK_QUANTUM), _BLOCK_QUANTUM, _BLOCK_MAX
    )
    block_n = min(block_n, max(_round_up(n // 8, _BLOCK_QUANTUM), _BLOCK_QUANTUM))
    block_n = max(
        block_n, _clamp(_round_up(pool, _BLOCK_QUANTUM), _BLOCK_QUANTUM, _BLOCK_MAX)
    )
    expected = pool * block_n / max(n, 1)
    cap = _clamp(
        _round_up(int(_CAP_SAFETY * expected) + 1, _CAP_QUANTUM),
        _CAP_QUANTUM,
        max(_CAP_QUANTUM, _round_down(min(pool, block_n), _CAP_QUANTUM)),
    )
    return TileConfig(block_n=block_n, survivor_cap=cap)


def autotune_build_block_n(
    n: int,
    d: int,
    *,
    sqrt_k: int,
    limits: MemoryLimits,
    n_subspaces: int = 8,
    itemsize: int = 4,
) -> int:
    """Chunk size of the chunked build: the largest 512-multiple whose
    ``(2Ns, block_n, sqrtK)`` distance block plus ``(2Ns, block_n, h_max)``
    half-space view fits ``limits.fast_bytes``."""
    if min(n, d, sqrt_k, n_subspaces) < 1:
        raise ValueError(
            f"n/d/sqrt_k/n_subspaces must be >= 1, got {n}/{d}/{sqrt_k}/{n_subspaces}"
        )
    h_max = -(-(-(-d // n_subspaces)) // 2)  # ceil(ceil(d/Ns) / 2)
    per_point = 2 * n_subspaces * (sqrt_k + h_max) * itemsize
    block_n = _clamp(
        _round_down(limits.fast_bytes // per_point, _BLOCK_QUANTUM),
        _BLOCK_QUANTUM,
        _BLOCK_MAX,
    )
    return min(block_n, max(_round_up(n, _BLOCK_QUANTUM), _BLOCK_QUANTUM))
