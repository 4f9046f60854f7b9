"""Launch of the CUDA kernel ``pairwise_sqdist`` of ``csrc/pairwise_l2.cu``
(which replaces the TPU kernel ``pairwise_sqdist_kernel``): a block of 128
threads owns a work item: 512 adjacent points (:data:`POINTS`) and a group
of up to 64 queries (:data:`QUERIES`); each thread holds its 4 points in
registers, read once, and the group's queries are broadcast from shared
memory.  Bytes bound
it on an H100 at SC-Linear's subspace width, the arithmetic in the plain
order at about three quarters of them (see the source's header).

The op wrapper (:mod:`.ops`) has checked every argument; this module
allocates the output, launches on the current stream and raises on any
CUDA error.  ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

QUERIES, POINTS = 64, 512  # a block's query group and point tile (kQ, kPoints)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _LL, _P, _LL, _I, _I, _I, _I, _P, _P]


def vec(x: torch.Tensor) -> int:
    """The kernel's copy width for the points, in floats: 4 (16-byte copies)
    where the view starts on a 16-byte boundary and its row stride is a
    multiple of 4 floats, else 1."""
    return 4 if x.data_ptr() % 16 == 0 and x.stride(0) % 4 == 0 else 1


def items(m: int, n: int) -> int:
    """The kernel's work items, one block each: a group of :data:`QUERIES`
    queries and a tile of :data:`POINTS` points."""
    return -(-m // QUERIES) * -(-n // POINTS)


def pairwise_sqdist(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    global launches
    m, d = q.shape
    n = x.shape[0]
    dev = q.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = _build.entry("pairwise_l2", "pairwise_sqdist", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            q.data_ptr(), q.stride(0), x.data_ptr(), x.stride(0), m, n, d, vec(x),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("pairwise_l2", rc, "pairwise_sqdist")
    launches += 1
    return out
