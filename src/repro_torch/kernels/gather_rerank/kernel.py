"""Launch of the CUDA kernel ``csrc/gather_rerank.cu`` (which replaces the
TPU kernel ``gather_rerank_kernel``): one warp per (query, candidate),
16-byte loads where ``d % 4 == 0``.  Bytes bound it on an H100 (see the
source's header).

The op wrapper (:mod:`.ops`) has checked and clipped every argument; this
module allocates the output, launches on the current stream and raises on
any CUDA error.  ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _LL, _I, _I, _I, _P, _P]


def gather_rerank_l2(ids: torch.Tensor, x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    global launches
    m, c = ids.shape
    d = x.shape[1]
    dev = ids.device
    out = torch.empty((m, c), dtype=torch.float32, device=dev)
    vec4 = d % 4 == 0 and x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    fn = _build.entry("gather_rerank", "gather_rerank_l2", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            ids.data_ptr(), x.data_ptr(), q.data_ptr(), m * c, c, d, int(vec4),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("gather_rerank", rc, "gather_rerank_l2")
    launches += 1
    return out
