"""The sharded SuCo engine on ``torch.distributed``: the mesh
(:mod:`.compat`), the sharded build, query and serving engines
(:mod:`.engine`) and elastic re-sharding (:mod:`.elastic`)."""

from repro_torch.distributed.compat import Mesh
from repro_torch.distributed.engine import (
    DistSuCoConfig,
    ShardedEnginePool,
    ShardedIndex,
    ShardedSuCoEngine,
    build_sharded,
    index_shardings,
    make_query_fn,
    query_sharded,
    shard_index,
)
from repro_torch.distributed.elastic import reshard_index, index_to_host, index_from_host

__all__ = [
    "DistSuCoConfig",
    "ShardedEnginePool",
    "ShardedSuCoEngine",
    "build_sharded",
    "index_shardings",
    "make_query_fn",
    "query_sharded",
    "shard_index",
    "reshard_index",
    "index_to_host",
    "index_from_host",
    "Mesh",
    "ShardedIndex",
]
