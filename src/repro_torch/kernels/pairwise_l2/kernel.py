"""Launch of the CUDA kernel ``pairwise_sqdist`` of ``csrc/pairwise_l2.cu``
(which replaces the TPU kernel ``pairwise_sqdist_kernel``): a SIMT tile of
32 x 128 outputs per block, 16 dims staged in shared memory per pass.
Bytes bound it on an H100 at SC-Linear's subspace width (see the source's
header).

The op wrapper (:mod:`.ops`) has checked every argument; this module
allocates the output, launches on the current stream and raises on any
CUDA error.  ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _LL, _P, _LL, _I, _I, _I, _P, _P]


def pairwise_sqdist(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    global launches
    m, d = q.shape
    n = x.shape[0]
    dev = q.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = _build.entry("pairwise_l2", "pairwise_sqdist", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            q.data_ptr(), q.stride(0), x.data_ptr(), x.stride(0), m, n, d,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("pairwise_l2", rc, "pairwise_sqdist")
    launches += 1
    return out
