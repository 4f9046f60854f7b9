"""Launch of the CUDA kernel ``csrc/sc_score.cu`` (which replaces the TPU
kernel ``sc_score_cells_prefilter_compact_kernel``): one block per query,
the activated set as a bitmap in shared memory, a block-wide scan for the
survivor slots.  Bytes bound it on an H100 (see the source's header).

The op wrapper (:mod:`.ops`) has checked every argument; this module
allocates the outputs, launches on the current stream and raises on any
CUDA error.  ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]


def sc_score_compact(
    ranks: torch.Tensor,
    cuts: torch.Tensor,
    cells: torch.Tensor,
    thr: torch.Tensor,
    limit: int,
    keep_cols: torch.Tensor | None,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    global launches
    ns, m, k_cells = ranks.shape
    bc = cells.shape[1]
    dev = ranks.device
    scores = torch.empty((m, bc), dtype=torch.int32, device=dev)
    surv_cols = torch.empty((m, cap), dtype=torch.int32, device=dev)
    surv_scores = torch.empty((m, cap), dtype=torch.int32, device=dev)
    count = torch.empty((m,), dtype=torch.int32, device=dev)
    fn = _build.entry("sc_score", "sc_score_compact", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(
            ranks.data_ptr(), cuts.data_ptr(), cells.data_ptr(), cells.stride(0),
            thr.data_ptr(), None if keep_cols is None else keep_cols.data_ptr(),
            ns, m, k_cells, bc, limit, cap,
            scores.data_ptr(), surv_cols.data_ptr(), surv_scores.data_ptr(),
            count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check("sc_score", rc, "sc_score_compact")
    launches += 1
    return scores, surv_cols, surv_scores, count
