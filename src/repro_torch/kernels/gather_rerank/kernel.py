"""Launch of the CUDA kernel ``csrc/gather_rerank.cu`` (which replaces the
TPU kernel ``gather_rerank_kernel``): a group of :func:`group` lanes per
candidate, loads :func:`vec` floats wide, :data:`PER_THREAD` candidates a
thread with all their row loads in flight at once.  Bytes bound it on an
H100 (see the source's header).

The op wrapper (:mod:`.ops`) has checked every argument; the kernel reads
the ids as they are (int32 or int64, any strides) and clips them itself.
This module picks the instantiation (:func:`plan`), allocates the output,
launches on the current stream and raises on any CUDA error.  ``launches``
counts the launches.  :func:`scattered_read_probe` is a measurement beside
it (``csrc/read_probe.cu``), counted nowhere.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

#: the candidates a thread carries (the source's ``kPerThread``)
PER_THREAD = 2
#: threads a block (the source's ``kThreads``)
THREADS = 256

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _I, _LL, _LL, _P, _LL, _P, _LL, _I, _I, _I, _I, _P, _P]


def vec(d: int, *ptrs: int) -> int:
    """The widest load, in floats, that rows of ``d`` floats at the data
    pointers ``ptrs`` allow: 4 (16-byte aligned), 2 (8-byte) or 1."""
    for v in (4, 2):
        if d % v == 0 and all(p % (4 * v) == 0 for p in ptrs):
            return v
    return 1


def group(d: int, v: int) -> int:
    """Lanes a candidate takes: the power of two at or above ``d / v``, at
    most 32 (past ``32 * v`` floats the group loops over ``d``)."""
    return min(32, 1 << (max(1, -(-d // v)) - 1).bit_length())


def plan(d: int, v: int) -> tuple[int, int, int]:
    """``(G, K, candidates a block)`` of the launch at width ``d`` and load
    width ``v``."""
    g = group(d, v)
    return g, PER_THREAD, THREADS // g * PER_THREAD


def blocks(total: int, d: int, v: int = 4) -> int:
    """The grid of a launch over ``total`` candidates."""
    return -(-total // plan(d, v)[2])


def gather_rerank_l2(ids: torch.Tensor, x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``(m, c)`` squared distances."""
    global launches
    m, c = ids.shape
    n, d = x.shape
    dev = ids.device
    out = torch.empty((m, c), dtype=torch.float32, device=dev)
    v = vec(d, x.data_ptr(), q.data_ptr())
    g = group(d, v)
    fn = _build.entry("gather_rerank", "gather_rerank_l2", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            ids.data_ptr(), int(ids.dtype == torch.int64), ids.stride(0), ids.stride(1),
            x.data_ptr(), n, q.data_ptr(), m * c, c, d, g, v, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("gather_rerank", rc, "gather_rerank_l2")
    launches += 1
    return out


def scattered_read_probe(x: torch.Tensor, reads: int, per_thread: int = 8,
                         seed: int = 0) -> torch.Tensor:
    """A measurement, on no path (``csrc/read_probe.cu``): ``reads`` reads of
    32-byte rows of ``x`` (contiguous fp32, 32-byte aligned) at hashed
    positions, ``per_thread`` (1, 2, 4 or 8) a thread in flight at once,
    each thread's sum written out.  Not counted as a launch of row 2."""
    rows = x.numel() // 8
    if x.dtype != torch.float32 or not x.is_contiguous() or x.data_ptr() % 32 or rows >= 2**32:
        raise ValueError("x must be contiguous fp32, 32-byte aligned, under 2^32 rows of 8")
    out = torch.empty(reads // per_thread, dtype=torch.float32, device=x.device)
    fn = _build.entry("read_probe", "scattered_read_probe",
                      [_P, ctypes.c_uint, _LL, _I, ctypes.c_uint, _P, _P])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), rows, reads, per_thread, seed, out.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("read_probe", rc, "scattered_read_probe")
    return out
