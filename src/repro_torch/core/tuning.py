"""Tiling autotuner: chunk sizes of the fused query and the chunked build,
from the device's memory limits and the problem shape.

The counterpart of ``repro.core.tuning``, with the same sizing model.  The
limits come from the device a tensor lives on: on the card,
``torch.cuda.get_device_properties`` gives the L2 size (the working-set
budget of one streamed chunk) and the total memory; on the CPU a fixed
prior stands in.  Nothing is probed or cached on disk, so a result depends
on the device model and the shape only, and is the same from run to run.
:func:`static_device_limits` gives a card's limits as constants, with no
card: the static gate and the dry-run plan against them on any host.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "MemoryLimits",
    "DeviceLimits",
    "TileConfig",
    "CPU_LIMITS",
    "H100_LIMITS",
    "device_limits",
    "static_device_limits",
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


@dataclasses.dataclass(frozen=True)
class DeviceLimits(MemoryLimits):
    """A card's limits as constants: its memory budget (L2 as ``fast_bytes``,
    device memory as ``hbm_bytes``) and what a launch may take."""

    smem_optin_bytes: int = 0  # dynamic + static shared memory a block may opt in to
    n_sm: int = 0
    regs_per_sm: int = 0
    max_threads_per_block: int = 0
    smem_per_sm_bytes: int = 0  # shared memory an SM holds, the blocks' reserve included
    max_threads_per_sm: int = 0


#: NVIDIA H100 80GB HBM3 (SXM), as ``torch.cuda.get_device_properties``
#: reports it: ``L2_cache_size``, ``total_memory``,
#: ``shared_memory_per_block_optin``, ``multi_processor_count``,
#: ``regs_per_multiprocessor``, ``max_threads_per_block``,
#: ``shared_memory_per_multiprocessor``, ``max_threads_per_multi_processor``.
H100_LIMITS = DeviceLimits(
    fast_bytes=52_428_800, hbm_bytes=85_017_493_504, smem_optin_bytes=232_448, n_sm=132,
    regs_per_sm=65_536, max_threads_per_block=1_024, smem_per_sm_bytes=233_472,
    max_threads_per_sm=2_048,
)
_STATIC = {"h100": H100_LIMITS, "cpu": CPU_LIMITS}


def static_device_limits(name: str = "h100") -> MemoryLimits:
    """The limits of a device model by name (``"h100"``, ``"cpu"``), never
    read from a device: the counterpart of the JAX package's
    ``static_backend_limits``.  Lint entries and the dry-run pin their tiles
    to it, so they prove the card's tiling on any host."""
    if name not in _STATIC:
        raise ValueError(f"static_device_limits: unknown device {name!r} (known: {sorted(_STATIC)})")
    return _STATIC[name]


def device_limits(device: torch.device | str) -> MemoryLimits:
    """Memory limits of ``device``: the card's own L2 size and total memory,
    :data:`CPU_LIMITS` for the CPU, or a static model by name
    (:func:`static_device_limits`, e.g. ``"h100"``)."""
    if isinstance(device, str) and device in _STATIC and device != "cpu":
        return _STATIC[device]
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


# --------------------------------------------------------------------------
# Static-gate registry hook (see repro_torch.analysis)
# --------------------------------------------------------------------------


def lint_entries():
    """Registry hook: the autotuner's tiles keep their quanta (a 512-multiple
    ``block_n``, a 64-multiple ``survivor_cap`` no wider than it) under the
    CPU prior and the H100's limits, at serving-scale, huge-pool and
    minimum shapes."""
    from repro_torch.analysis.registry import TileEntry

    sweep = (
        # (n, d, m, pool, n_subspaces): the JAX package's sweep
        (50_000, 128, 8, 1_000, 8),
        (1_000_000, 96, 64, 20_000, 8),
        (32_768, 16, 1, 33, 4),
    )
    configs = tuple(
        autotune_tiles(n, d, m, pool, n_subspaces=ns, limits=static_device_limits(name))
        for name in ("cpu", "h100")
        for (n, d, m, pool, ns) in sweep
    )
    return [
        TileEntry(
            name="tuning.autotune_tiles",
            contract={"block_quantum": _BLOCK_QUANTUM, "cap_quantum": _CAP_QUANTUM},
            tile_configs=configs,
            note="TileConfig quantisation contract under the CPU and H100 limits",
        )
    ]
