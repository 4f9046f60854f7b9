"""Hand-written CUDA kernels of the port, one package per TPU kernel family
(``kernel.py`` launches, ``ops.py`` checks and dispatches by device,
``ref.py`` is the plain PyTorch version), built from ``../csrc`` by
:mod:`._build`.

:data:`KERNELS` names every ported kernel with the module and attribute of
its launch counter; :func:`launch_counts` reads them and
:func:`reset_launch_counts` sets them to 0.  The public ops are exported
here as the JAX package exports its own.
"""

from __future__ import annotations

from repro_torch.kernels.gather_rerank import kernel as _gather
from repro_torch.kernels.kmeans_assign import kernel as _kmeans
from repro_torch.kernels.linear_attn import kernel as _linear_attn
from repro_torch.kernels.linear_attn.ops import linear_attention, linear_attention_with_state
from repro_torch.kernels.pairwise_l2 import kernel as _pairwise
from repro_torch.kernels.pairwise_l2.ops import pairwise_sqdist
from repro_torch.kernels.sc_score import kernel as _score
from repro_torch.kernels.sc_score.ops import sc_scores_cells, sc_scores_fused

__all__ = [
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "pairwise_sqdist",
    "sc_scores_fused",
    "sc_scores_cells",
    "linear_attention",
    "linear_attention_with_state",
]

#: kernel name -> (kernel module, launch-counter attribute)
KERNELS = {
    "sc_score_cells_prefilter_compact": (_score, "launches"),
    "gather_rerank": (_gather, "launches"),
    "kmeans_stats": (_kmeans, "stats_launches"),
    "kmeans_pair_assign_hist": (_kmeans, "pair_hist_launches"),
    "sc_score_cells": (_score, "cells_launches"),
    "sc_score_cells_prefilter": (_score, "prefilter_launches"),
    "sc_score": (_score, "fused_launches"),
    "pairwise_sqdist": (_pairwise, "launches"),
    "kmeans_assign_batched": (_kmeans, "assign_batched_launches"),
    "kmeans_assign": (_kmeans, "assign_launches"),
    "linear_attn": (_linear_attn, "launches"),
}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
