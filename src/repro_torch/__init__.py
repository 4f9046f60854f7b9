"""SuCo (Subspace Collision ANN search) ported to PyTorch and CUDA.

The counterpart of the JAX package ``repro``, module for module
(``core/``, ``kernels/<name>/{kernel,ops,ref}.py``, ``data/``), for the main
path: build an index and serve fused queries on one NVIDIA H100.  Every TPU
kernel of that path is a hand-written CUDA kernel for ``sm_90a`` in
``csrc/``, built at first use; a tensor on the CPU takes each kernel's
plain PyTorch version instead.  The package imports neither JAX nor
anything of ``repro``.
"""

from repro_torch.core.suco import (
    ArtifactError,
    EnginePolicy,
    EngineStats,
    SuCoConfig,
    SuCoEngine,
    SuCoIndex,
    build_index,
    load_index_artifact,
    suco_query_fused,
)
from repro_torch.core.tuning import TileConfig
