"""SuCo on torch: subspaces, distances, collisions, SC-Linear and pools,
tiling, the K-means library (:mod:`repro_torch.core.kmeans`) and the
index, its lifecycle and the queries of :mod:`repro_torch.core.suco`.

Public API, as the JAX package's ``repro.core`` names it:
  sc_scores_from_subspaces, sc_linear_query       (Algorithm 1, SC-Linear)
  suco_query, suco_query_streaming, suco_scores   (Algorithm 4, its modes)
  activate_cells_sorted, dynamic_activation_lax   (Algorithm 3)
  batch_bucket, padding_waste, autoscale_buckets  (the engine's batch buckets)
  theory, da_numpy                                (Theorems 1-2; Alg. 3 in numpy)
"""

from repro_torch.core.sc_linear import (
    merge_topk_pool,
    rerank,
    rerank_candidates,
    sc_linear_query,
    sc_scores_from_subspaces,
)
from repro_torch.core.suco import (
    STREAMING_MIN_N,
    activate_cells_sorted,
    autoscale_buckets,
    batch_bucket,
    dynamic_activation_lax,
    padding_waste,
    suco_query,
    suco_query_fused,
    suco_query_streaming,
    suco_scores,
)
from repro_torch.core import da_numpy, theory
