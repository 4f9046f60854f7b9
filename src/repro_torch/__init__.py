"""SuCo (Subspace Collision ANN search) ported to PyTorch and CUDA.

The counterpart of the JAX package ``repro``, module for module
(``core/``, ``kernels/<name>/{kernel,ops,ref}.py``, ``data/``), for these
paths on one NVIDIA H100: build an index in any of the four build modes,
insert into it, delete from it and persist it (``build_index``,
``SuCoIndex``, ``SuCoEngine(capacity=...)``), serve queries in the fused,
dense and streaming modes (``SuCoEngine``, ``suco_query``), the
index-free SC-Linear (``sc_linear_query``), the K-means library
(``repro_torch.core.kmeans``: ``kmeans``, ``kmeans_batched``, ``assign``,
``init_centroids_pp``), and the ANN serving layer over the engine
(``repro_torch.serve``: ``AnnServer``, ``AsyncAnnServer``, the
``DegradationLadder`` with its Theorem-2 floors from
``repro_torch.core.theory``).  Every TPU kernel of those
paths is a hand-written CUDA kernel for ``sm_90a`` in ``csrc/``, built at
first use; a tensor on the CPU takes each kernel's plain PyTorch version
instead.  The package imports neither JAX nor anything of ``repro``.
"""

from repro_torch.core.sc_linear import sc_linear_query
from repro_torch.core.subspace import SubspaceSpec, contiguous_spec, sampled_spec
from repro_torch.core.suco import (
    STREAMING_MIN_N,
    INDEX_ARTIFACT_VERSION,
    ArtifactError,
    CapacityError,
    EnginePolicy,
    EngineStats,
    SuCoConfig,
    SuCoEngine,
    SuCoIndex,
    assign_points,
    build_index,
    load_index_artifact,
    suco_query,
    suco_query_fused,
)
from repro_torch.core.tuning import TileConfig
from repro_torch.kernels import sc_scores_cells, sc_scores_fused
