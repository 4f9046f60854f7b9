"""Launch of the CUDA kernel ``csrc/linear_attn.cu``, which replaces the TPU
kernel ``linear_attn_kernel`` of ``repro/kernels/linear_attn/kernel.py``:
chunked gated linear attention, one block per (head, slice of value
columns) walking the chunks in order with its slice of the state in shared
memory.  Inside a chunk the intra-chunk scores are cut into 16 x 16
sub-blocks: the off-diagonal ones factor their decay about the log-decay at
the end of the sub-block above (both factors <= 1, so nothing overflows
however small the decay) and run on the tensor cores in 3xTF32 with the
other products; the diagonal ones keep the per-term exponent on the CUDA
cores, over their causal half only.  Bytes bound it on an H100 (see the
source's header).

The op wrappers (:mod:`.ops`) have checked every argument; this module
picks the chunk tile and the value-column slice, allocates the outputs,
launches on the current stream and raises on any CUDA error.  A chunk
``c`` runs on the smallest tile of :data:`TILES` that holds it, with ``c``
live rows a chunk; a chunk above 128 runs as chunks of 128 (the same
recurrence, regrouped: see the source's header).  :func:`smem_bytes` asks
the source for its shared-memory layout, so the card's refusal of a wide
``dk`` follows it.  ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

TILES = (16, 32, 64, 128)  # the chunk tiles the kernel is built for
_SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]


def smem_bytes(tile: int, dk: int, dvs: int) -> int:
    """Shared memory of one block at chunk tile ``tile``, in bytes, as the
    source lays it out (its ``smem_floats``; at most 2^31 - 1); builds the
    library if needed."""
    return _build.entry("linear_attn", "linear_attn_smem_bytes", [_I, _I, _I])(tile, dk, dvs)


def chunk_tile(chunk: int) -> int:
    """The tile a chunk runs on: the smallest of :data:`TILES` holding
    ``min(chunk, 128)`` rows."""
    return next(c for c in TILES if c >= min(chunk, TILES[-1]))


def value_slice(bh: int, dk: int, dv: int, chunk: int, n_sm: int) -> int:
    """Value columns per block, one of 64, 32, 16: the widest that wastes
    no half of itself on ``dv``, still gives every SM a block (the dv
    slices of one head are independent), and fits in shared memory."""
    dvs = 64
    while dvs > 16 and (dv <= dvs // 2 or bh * -(-dv // dvs) < n_sm
                        or smem_bytes(chunk, dk, dvs) > _SMEM_LIMIT):
        dvs //= 2
    return dvs


def linear_attn(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    chunk: int, shift: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    bh, t, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    tile = chunk_tile(chunk)
    dvs = value_slice(bh, dk, dv, tile, torch.cuda.get_device_properties(dev).multi_processor_count)
    o = torch.empty((bh, t, dv), dtype=q.dtype, device=dev)
    state = torch.empty((bh, dk, dv), dtype=torch.float32, device=dev)
    fn = _build.entry("linear_attn", "linear_attn", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            bh, t, dk, dv, tile, min(chunk, tile), shift, dvs, int(q.dtype == torch.bfloat16),
            o.data_ptr(), state.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("linear_attn", rc, "linear_attn")
    launches += 1
    return o, state
