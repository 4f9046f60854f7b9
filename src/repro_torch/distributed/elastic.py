"""Elastic scaling for the sharded SuCo index (the counterpart of
``repro.distributed.elastic``).

The index layout is a pure function of (dataset order, config): points are
range-sharded over the point axes and subspaces over the model axis.  So a
re-scale is mechanical: gather the logical arrays (``cell_ids`` are per
point, the centroids and counts per subspace, nothing is recomputed) and
slice them again for the new mesh, inside one world.  Checkpoints store the
logical arrays (:func:`index_to_host`), so a lost rank's share is sliced
from them again.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.suco import SuCoIndex
from repro_torch.distributed.engine import DistSuCoConfig, ShardedIndex, shard_index

__all__ = ["reshard_index", "index_to_host", "index_from_host"]


def _logical(index: SuCoIndex | ShardedIndex) -> SuCoIndex:
    return index.gather() if isinstance(index, ShardedIndex) else index


def reshard_index(new_mesh, cfg: DistSuCoConfig, index: SuCoIndex | ShardedIndex) -> ShardedIndex:
    """Move an index (sharded over any earlier mesh of this world, or
    logical) onto ``new_mesh``'s layout."""
    return shard_index(new_mesh, cfg, _logical(index))


def index_to_host(index: SuCoIndex | ShardedIndex) -> dict:
    """The logical index as host arrays (a checkpoint's payload)."""
    logical = _logical(index)
    return {name: getattr(logical, name).cpu().numpy()  # host-sync: ok — a checkpoint's copy
            for name in ("centroids1", "centroids2", "cell_ids", "cell_counts")}


def index_from_host(
    payload: dict, spec, sqrt_k: int, mesh=None, cfg=None, *, device: torch.device | str = "cuda"
) -> SuCoIndex | ShardedIndex:
    """An index from :func:`index_to_host`'s arrays on ``device``; sharded
    onto ``mesh`` when ``mesh`` and ``cfg`` are given."""
    idx = SuCoIndex.from_numpy(
        np.asarray(payload["centroids1"]), np.asarray(payload["centroids2"]),
        np.asarray(payload["cell_ids"]), np.asarray(payload["cell_counts"]),
        spec=spec, sqrt_k=sqrt_k, device=device,
    )
    if mesh is not None and cfg is not None:
        return reshard_index(mesh, cfg, idx)
    return idx
