"""Distributed SuCo engine: the sharded index build and query on
``torch.distributed`` (the counterpart of ``repro.distributed.engine``).

Layout over the mesh axes ``(pod, data, model)`` (:class:`~repro_torch.
distributed.compat.Mesh`), as the reference shards its arrays:

  X            (n, d)         rows by point shard, columns by model rank
  cell_ids     (Ns, n)        subspaces by model rank, points by point shard
  cell_counts  (Ns, K)        subspaces by model rank
  centroids    (Ns, sqrtK, h) subspaces by model rank
  queries      (mq, d)        columns by model rank, whole on every shard

``Ns % model == 0`` and ``d % Ns == 0``: each model rank owns ``Ns/model``
whole subspaces, a contiguous dim slice; ``n`` divides by the point
shards.  Every rank runs the same program on its share and the
collectives of :class:`Mesh` join them, where the reference runs one
``shard_map`` body per device.

Build (:func:`build_sharded`): the first ``sqrt_k`` points of point shard 0
seed every codebook; each Lloyd step runs the Lloyd-statistics kernel over
the rank's points and sums its ``(sums, counts)`` over the point shards;
the final assignment runs the paired-assignment kernel, whose IMI histogram
is summed the same way.

Query (:func:`make_query_fn`), per chunk of ``q_chunk`` queries: the
SC-score kernel scores the shard (in blocks of ``block_n`` points, carried
in a (score desc, id asc) pool, or all at once with ``block_n=0``), the
int8 scores are summed over ``model``; the gather-rerank kernel gives the
candidates' partial distances over the rank's dim slice, summed over
``model``; the rank's top-k go to every point shard and a last top-k over
them gives the answer, the same on every rank.  Every selection is a
stable sort, which keeps ``lax.top_k``'s rule (the lower position first
among ties).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import subspace as sub
from repro_torch.core.distances import sqdist_rowwise
from repro_torch.core.sc_linear import INT32_MAX, candidate_pool_size, merge_topk_pool
from repro_torch.core.spans import loop_span
from repro_torch.core.suco import (
    DEFAULT_BATCH_BUCKETS,
    SuCoIndex,
    _cell_ranks_and_cut,
    batch_bucket,
    load_index_artifact,
)
from repro_torch.core.tuning import autotune_build_block_n, autotune_tiles, device_limits
from repro_torch.distributed.compat import Mesh
from repro_torch.kernels.gather_rerank.ops import gather_rerank_block
from repro_torch.kernels.kmeans_assign.ops import kmeans_pair_assign_hist, kmeans_stats
from repro_torch.kernels.sc_score.ops import sc_scores_cells

__all__ = [
    "DistSuCoConfig",
    "ShardedIndex",
    "resolved_query_block_n",
    "index_shardings",
    "shard_index",
    "build_sharded",
    "make_query_fn",
    "query_sharded",
    "ShardedSuCoEngine",
    "ShardedEnginePool",
]


@dataclasses.dataclass(frozen=True)
class DistSuCoConfig:
    n_subspaces: int = 16
    sqrt_k: int = 64
    kmeans_iters: int = 10
    alpha: float = 0.03
    beta: float = 0.003
    k: int = 50
    q_chunk: int = 32  # queries a chunk (bounds the (q_chunk, n_local) scores)
    block_n: int | None = None  # points a streaming block of the query;
    # None = autotune from the device's memory limits and the per-shard
    # problem shape (repro_torch.core.tuning.autotune_tiles); 0 = dense
    # per-shard scoring (the small-n reference path)
    build_block_n: int | None = 4096  # points a chunk of each Lloyd pass of
    # the build; None = autotune (autotune_build_block_n); 0 = the shard's
    # points in one chunk (the dense reference path)
    point_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    seed: int = 0
    tuning_backend: str | None = None  # device whose memory limits the block
    # autotuners plan against ("cuda", "cpu", or a static model such as "h100":
    # core.tuning.static_device_limits); None = the data's device.
    # Pin it when planning on another device than the one that serves.

    @property
    def n_cells(self) -> int:
        return self.sqrt_k**2


def _n_point_shards(mesh: Mesh, cfg: DistSuCoConfig) -> int:
    return mesh.size(cfg.point_axes)


def _limits(cfg: DistSuCoConfig, device):
    return device_limits(cfg.tuning_backend or device)


def resolved_query_block_n(
    mesh: Mesh, cfg: DistSuCoConfig, n: int, d: int, *, device="cuda"
) -> int:
    """The per-shard streaming block of the sharded query.

    ``cfg.block_n=None`` autotunes from the memory limits of
    ``cfg.tuning_backend`` (``device``'s when unset) and the *local*
    problem shape (shard points, dim slice, ``q_chunk`` queries, per-shard
    candidate pool); explicit values (0 = dense) pass through."""
    if cfg.block_n is not None:
        if cfg.block_n < 0:
            raise ValueError(
                f"block_n must be >= 0 (0 = dense) or None (autotune), got {cfg.block_n}"
            )
        return cfg.block_n
    n_loc = max(n // _n_point_shards(mesh, cfg), 1)
    tp = mesh.shape[cfg.model_axis]
    d_loc = max(d // tp, 1)
    m_cand = candidate_pool_size(n_loc, cfg.k, cfg.beta)
    return autotune_tiles(
        n_loc, d_loc, cfg.q_chunk, m_cand, limits=_limits(cfg, device),
        n_subspaces=max(cfg.n_subspaces // tp, 1),
    ).block_n


def _check(mesh: Mesh, cfg: DistSuCoConfig, d: int) -> tuple[int, int]:
    tp = mesh.shape[cfg.model_axis]
    if cfg.n_subspaces % tp:
        raise ValueError(f"Ns={cfg.n_subspaces} must divide by model={tp}")
    if d % cfg.n_subspaces:
        raise ValueError(f"d={d} must divide by Ns={cfg.n_subspaces}")
    return cfg.n_subspaces // tp, d // cfg.n_subspaces


def _n_local(mesh: Mesh, cfg: DistSuCoConfig, n: int) -> int:
    p = _n_point_shards(mesh, cfg)
    if n % p:
        raise ValueError(f"n={n} must divide by the {p} point shards")
    return n // p


def index_shardings(mesh: Mesh, cfg: DistSuCoConfig, n: int, d: int) -> dict[str, tuple]:
    """This rank's share of each logical array, as an index into it
    (``x[sh["x"]]`` is the rank's block of ``x``): its point range and dim
    slice of ``x``, its subspaces and point range of ``cell_ids``, its
    subspaces of ``cell_counts`` and the centroids, its dim slice of the
    queries."""
    ns_loc, s = _check(mesh, cfg, d)
    n_loc = _n_local(mesh, cfg, n)
    pt = mesh.axis_index(cfg.point_axes)
    mp = mesh.axis_index(cfg.model_axis)
    rows = slice(pt * n_loc, (pt + 1) * n_loc)
    cols = slice(mp * ns_loc * s, (mp + 1) * ns_loc * s)
    subs = slice(mp * ns_loc, (mp + 1) * ns_loc)
    return dict(
        x=(rows, cols),
        cell_ids=(subs, rows),
        cell_counts=(subs, slice(None)),
        centroids=(subs, slice(None), slice(None)),
        queries=(slice(None), cols),
    )


@dataclasses.dataclass
class ShardedIndex:
    """One rank's share of a SuCo index laid out over ``mesh`` by ``cfg``
    (:func:`index_shardings`); :meth:`gather` rebuilds the logical index."""

    centroids1: torch.Tensor  # (ns_loc, sqrtK, h) float32
    centroids2: torch.Tensor  # (ns_loc, sqrtK, h) float32
    cell_ids: torch.Tensor  # (ns_loc, n_loc) int32
    cell_counts: torch.Tensor  # (ns_loc, K) int32, over all n points
    spec: sub.SubspaceSpec  # the logical index's
    sqrt_k: int
    n_points: int  # n, all shards
    mesh: Mesh
    cfg: DistSuCoConfig

    def gather(self) -> SuCoIndex:
        """The logical index, on every rank (on this share's device)."""
        m, pa, ma = self.mesh, self.cfg.point_axes, self.cfg.model_axis

        def over_model(t):  # (tp, ns_loc, ...) -> (Ns, ...)
            return m.all_gather(t, ma).flatten(0, 1)

        cells = m.all_gather(self.cell_ids, pa)  # (P, ns_loc, n_loc)
        cells = cells.permute(1, 0, 2).reshape(self.cell_ids.shape[0], -1)
        return SuCoIndex(
            centroids1=over_model(self.centroids1),
            centroids2=over_model(self.centroids2),
            cell_ids=over_model(cells),
            cell_counts=over_model(self.cell_counts),
            spec=self.spec,
            sqrt_k=self.sqrt_k,
        )


def shard_index(
    mesh: Mesh, cfg: DistSuCoConfig, index: SuCoIndex, *, device=None
) -> ShardedIndex:
    """This rank's share of a logical ``index`` (built on one device, or
    loaded from an artifact) on ``device`` (the index's when ``None``)."""
    if index.tombstone is not None:
        raise ValueError("the sharded engine serves no tombstones")
    d, ns = index.spec.d, cfg.n_subspaces
    if index.spec != sub.contiguous_spec(d, ns) or index.sqrt_k != cfg.sqrt_k:
        raise ValueError(
            f"the sharded layout needs contiguous_spec({d}, {ns}) at sqrt_k={cfg.sqrt_k}, "
            f"got {index.spec} at sqrt_k={index.sqrt_k}"
        )
    sh = index_shardings(mesh, cfg, index.n_points, d)
    dev = index.cell_ids.device if device is None else torch.device(device)
    take = lambda t, key: t[sh[key]].to(dev).contiguous()
    return ShardedIndex(
        centroids1=take(index.centroids1, "centroids"),
        centroids2=take(index.centroids2, "centroids"),
        cell_ids=take(index.cell_ids, "cell_ids"),
        cell_counts=take(index.cell_counts, "cell_counts"),
        spec=index.spec,
        sqrt_k=index.sqrt_k,
        n_points=index.n_points,
        mesh=mesh,
        cfg=cfg,
    )


def _split_local(x_loc: torch.Tensor, ns_loc: int, s: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``(n_loc, ns_loc * s) -> 2 x (ns_loc, n_loc, h1)`` half views (the
    second zero-padded to ``h1`` dims)."""
    n_loc = x_loc.shape[0]
    xs = x_loc.reshape(n_loc, ns_loc, s).transpose(0, 1)  # (ns, n, s)
    h1 = (s + 1) // 2
    a = xs[..., :h1]
    b = xs[..., h1:]
    if b.shape[-1] < h1:
        b = F.pad(b, (0, h1 - b.shape[-1]))
    return a, b, h1


def _local_x(mesh: Mesh, cfg: DistSuCoConfig, x, device) -> tuple[torch.Tensor, int, int]:
    """This rank's block of the global ``x`` on ``device`` -> ``(x_loc, n, d)``."""
    x = torch.as_tensor(x)
    if x.dim() != 2:
        raise ValueError(f"data must be (n, d), got {tuple(x.shape)}")
    n, d = x.shape
    sh = index_shardings(mesh, cfg, n, d)
    return x[sh["x"]].to(device=device, dtype=torch.float32).contiguous(), n, d


# --------------------------------------------------------------------------
# Build
# --------------------------------------------------------------------------


def build_sharded(mesh: Mesh, x, cfg: DistSuCoConfig, *, device=None) -> ShardedIndex:
    """Distributed Algorithm 2: K-means by summed sufficient statistics.

    ``x`` is the global ``(n, d)`` data (each rank reads its share) on
    ``device`` (``x``'s own when ``None``).  Each Lloyd step is one pass of
    the Lloyd-statistics kernel over the rank's ``(2 ns_loc, n_loc, h1)``
    half-subspace points in chunks of ``cfg.build_block_n`` (0: the shard
    in one chunk), and only its ``(2 ns_loc, sqrt_k, h1)`` sums and counts
    are summed over the point shards.  The kernel adds each chunk's points
    in index order, so the chunked and the one-chunk builds give the same
    bits.
    """
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    x_loc, n, d = _local_x(mesh, cfg, x, device)
    ns_loc, s = _check(mesh, cfg, d)
    n_loc = x_loc.shape[0]
    pa = cfg.point_axes
    sqrt_k = cfg.sqrt_k
    if n_loc < sqrt_k:
        raise ValueError(f"each shard needs at least sqrt_k={sqrt_k} points, has {n_loc}")
    build_block_n = cfg.build_block_n
    if build_block_n is None:
        build_block_n = autotune_build_block_n(
            n_loc, d, sqrt_k=sqrt_k, n_subspaces=cfg.n_subspaces,
            limits=_limits(cfg, x_loc.device),
        )
    if build_block_n < 0:
        raise ValueError(f"build_block_n must be >= 0 (0 = dense), got {build_block_n}")
    chunk = build_block_n or n_loc

    a, b, _ = _split_local(x_loc, ns_loc, s)
    cb = torch.cat([a, b], dim=0).contiguous()  # (2ns_loc, n_loc, h1)
    del a, b
    # deterministic init: the first sqrt_k points of point shard 0
    first = 1.0 if mesh.axis_index(pa) == 0 else 0.0
    c = mesh.psum(cb[:, :sqrt_k, :] * first, pa).contiguous()
    for _ in range(cfg.kmeans_iters):
        with loop_span("sharded.lloyd_step"):
            _, sums, cnts, _ = kmeans_stats(cb, c, block_n=chunk)
            sums = mesh.psum(sums, pa)
            cnts = mesh.psum(cnts, pa)
            new = sums / torch.clamp(cnts, min=1.0)[..., None]
            c = torch.where(cnts[..., None] > 0, new, c).contiguous()
    assign, counts = kmeans_pair_assign_hist(cb, c, block_n=chunk)
    cell_ids = (assign[:ns_loc] * sqrt_k + assign[ns_loc:]).contiguous()
    return ShardedIndex(
        centroids1=c[:ns_loc].contiguous(),
        centroids2=c[ns_loc:].contiguous(),
        cell_ids=cell_ids,
        cell_counts=mesh.psum(counts, pa),
        spec=sub.contiguous_spec(d, cfg.n_subspaces),
        sqrt_k=sqrt_k,
        n_points=n,
        mesh=mesh,
        cfg=cfg,
    )


# --------------------------------------------------------------------------
# Query
# --------------------------------------------------------------------------


def make_query_fn(mesh: Mesh, cfg: DistSuCoConfig, n: int, d: int, mq: int, *, device="cuda"):
    """The sharded query step for batches of ``mq`` queries over ``n``
    points of ``d`` dims: ``f(x_loc, c1, c2, cell_ids, counts, q_loc) ->
    (ids (mq, k) int32, dists (mq, k) float32)``, the same on every rank.

    Its arguments are this rank's shares (:func:`index_shardings`): the
    data block, the index arrays of a :class:`ShardedIndex` and the
    queries' dim slice.  ``device`` is the one the block autotuner plans
    for (unless ``cfg.tuning_backend`` names another)."""
    ns_loc, s = _check(mesh, cfg, d)
    pa, ma = cfg.point_axes, cfg.model_axis
    k = cfg.k
    n_loc = _n_local(mesh, cfg, n)
    if not 1 <= k <= n_loc:
        raise ValueError(f"k={k} must be in [1, n_local={n_loc}]")
    target = sub.collision_count(n, cfg.alpha)
    m_cand = candidate_pool_size(n_loc, k, cfg.beta)
    q_chunk = min(cfg.q_chunk, mq)
    if mq % q_chunk:
        raise ValueError(f"mq={mq} must divide by q_chunk={q_chunk}")
    block_n = resolved_query_block_n(mesh, cfg, n, d, device=device)
    bn = min(block_n, n_loc) if block_n else 0
    smax = cfg.n_subspaces
    offset = mesh.axis_index(pa) * n_loc

    def summed_scores(ranks, cuts, cells):
        # this rank's subspaces' collisions, summed over model as int8
        part = sc_scores_cells(ranks, cuts, cells).to(torch.int8)
        return mesh.psum(part, ma).to(torch.int32)

    def dense_candidates(ranks, cuts, cell_ids):
        """The full (q_chunk, n_loc) scores of this shard."""
        scores = summed_scores(ranks, cuts, cell_ids)
        return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :m_cand]

    def streaming_candidates(ranks, cuts, cell_ids):
        """The shard in blocks of bn points, carried in a top-m_cand pool:
        (score desc, id asc), the dense path's order exactly."""
        qc = ranks.shape[1]
        dev = cell_ids.device
        pool_s = torch.full((qc, m_cand), -1, dtype=torch.int32, device=dev)
        pool_i = torch.full((qc, m_cand), INT32_MAX, dtype=torch.int32, device=dev)
        for lo in range(0, n_loc, bn):
            with loop_span("sharded.query_block"):
                hi = min(lo + bn, n_loc)
                scores = summed_scores(ranks, cuts, cell_ids[:, lo:hi])
                ids = torch.arange(lo, hi, dtype=torch.int32, device=dev).expand(qc, hi - lo)
                pool_s, pool_i = merge_topk_pool(pool_s, pool_i, scores, ids, smax=smax)
        return pool_i

    def fn(x_loc, c1, c2, cell_ids, counts, q_loc):
        qa, qb, _ = _split_local(q_loc, ns_loc, s)  # (ns_loc, mq, h1)
        d1 = sqdist_rowwise(qa, c1)  # (ns_loc, mq, sqrt_k)
        d2 = sqdist_rowwise(qb, c2)
        ids_out, dists_out = [], []
        for c0 in range(0, mq, q_chunk):
            ranks, cuts = _cell_ranks_and_cut(
                d1[:, c0:c0 + q_chunk], d2[:, c0:c0 + q_chunk], counts[:, None, :], target
            )
            if bn:
                cand = streaming_candidates(ranks, cuts, cell_ids)
            else:
                cand = dense_candidates(ranks, cuts, cell_ids)
            # partial distances over this rank's dim slice, summed over model
            part = gather_rerank_block(cand, x_loc, q_loc[c0:c0 + q_chunk].contiguous())
            full = mesh.psum(part, ma)
            pos = torch.sort(full, dim=1, stable=True).indices[:, :k]
            ids_out.append(cand.gather(1, pos).to(torch.int32) + offset)
            dists_out.append(full.gather(1, pos))
        ids = torch.cat(ids_out)
        dists = torch.cat(dists_out)
        # global top-k over the point shards, listed shard by shard
        all_ids = mesh.all_gather(ids, pa).transpose(0, 1).reshape(mq, -1)
        all_d = mesh.all_gather(dists, pa).transpose(0, 1).reshape(mq, -1)
        pos = torch.sort(all_d, dim=1, stable=True).indices[:, :k]
        return all_ids.gather(1, pos), all_d.gather(1, pos)

    return torch.inference_mode()(fn)


def _as_sharded(mesh: Mesh, cfg: DistSuCoConfig, index, device) -> ShardedIndex:
    """A :class:`ShardedIndex` laid out for ``(mesh, cfg)`` as it is, or a
    logical ``SuCoIndex`` sharded here."""
    if not isinstance(index, ShardedIndex):
        return shard_index(mesh, cfg, index, device=device)
    layout = lambda c: (c.n_subspaces, c.sqrt_k, c.point_axes, c.model_axis)
    if index.mesh is not mesh or layout(index.cfg) != layout(cfg):
        raise ValueError("the index is sharded for another mesh or layout: "
                         "move it with elastic.reshard_index")
    return index


def query_sharded(
    mesh: Mesh, cfg: DistSuCoConfig, x, index, q
) -> tuple[torch.Tensor, torch.Tensor]:
    """Builds and runs the sharded query step: the global ``x`` and ``q``,
    a :class:`ShardedIndex` (or a logical ``SuCoIndex``, sharded here) ->
    ``(ids (m, k), dists (m, k))`` on every rank, on the index's device."""
    dev = (index.cell_ids.device if isinstance(index, (ShardedIndex, SuCoIndex))
           else torch.device("cuda"))
    index = _as_sharded(mesh, cfg, index, dev)
    x_loc, n, d = _local_x(mesh, cfg, x, dev)
    q = torch.as_tensor(q)
    q_loc = q[index_shardings(mesh, cfg, n, d)["queries"]].to(dev, torch.float32).contiguous()
    fn = make_query_fn(mesh, cfg, n, d, q.shape[0], device=dev)
    return fn(x_loc, index.centroids1, index.centroids2, index.cell_ids, index.cell_counts,
              q_loc)


# --------------------------------------------------------------------------
# ShardedSuCoEngine: the multi-rank serving counterpart of SuCoEngine
# --------------------------------------------------------------------------


def _bucket_mq(m: int, buckets: Sequence[int], q_chunk: int) -> int:
    b = batch_bucket(m, buckets)
    if b > q_chunk:
        b = -(-b // q_chunk) * q_chunk
    return b


class ShardedSuCoEngine:
    """Sharded serving engine: :class:`repro_torch.core.suco.SuCoEngine`
    across a mesh.

    Shares the single-device engine's artifact format (``SuCoIndex.save`` /
    ``load``: an index persisted by a single-device build serves the mesh
    through :func:`shard_index`) and its bucketing policy
    (:func:`batch_bucket`, rounded up to a ``q_chunk`` multiple, the query
    step's chunk).  One query step per bucket (:func:`make_query_fn`);
    after :meth:`warmup` covers the traffic mix, ``compile_count`` stays
    flat.  ``k`` is part of the engine's config (per-shard candidate pools
    are sized from it), so heterogeneous-k traffic runs one engine per k
    (:class:`ShardedEnginePool`).  ``device`` defaults to the card; pass
    ``"cpu"`` to run the plain versions of the kernels.
    """

    def __init__(
        self,
        mesh: Mesh,
        cfg: DistSuCoConfig,
        x,
        index,
        *,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        device: torch.device | str = "cuda",
    ):
        dev = torch.device(device)
        x_loc, n, d = _local_x(mesh, cfg, x, dev)
        self._place(mesh, cfg, x_loc, n, d, _as_sharded(mesh, cfg, index, dev), batch_buckets)

    def _place(self, mesh, cfg, x_loc, n, d, index, batch_buckets) -> None:
        if index.n_points != n or index.spec.d != d:
            raise ValueError(f"data ({n}, {d}) does not match the index's "
                             f"({index.n_points}, {index.spec.d})")
        self.mesh = mesh
        self.cfg = cfg
        self.x_loc = x_loc
        self.n, self.d = n, d
        self.device = x_loc.device
        self.index = index
        self.batch_buckets = tuple(batch_buckets)
        self._fns: dict[int, object] = {}

    @classmethod
    def _placed(cls, mesh, cfg, x_loc, n, d, index, batch_buckets) -> "ShardedSuCoEngine":
        """An engine over shares already placed on this rank (a pool's)."""
        eng = cls.__new__(cls)
        eng._place(mesh, cfg, x_loc, n, d, index, batch_buckets)
        return eng

    # ---- lifecycle -------------------------------------------------------

    @classmethod
    def build(
        cls,
        mesh: Mesh,
        cfg: DistSuCoConfig,
        x,
        *,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        device: torch.device | str = "cuda",
    ) -> "ShardedSuCoEngine":
        """Distributed Algorithm 2 (:func:`build_sharded`) -> engine."""
        index = build_sharded(mesh, x, cfg, device=device)
        return cls(mesh, cfg, x, index, batch_buckets=batch_buckets, device=device)

    @classmethod
    def from_artifact(
        cls,
        path,
        mesh: Mesh,
        cfg: DistSuCoConfig,
        x,
        *,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        device: torch.device | str = "cuda",
    ) -> "ShardedSuCoEngine":
        """Serve a ``SuCoIndex.save`` artifact across the mesh."""
        index, _ = load_index_artifact(path, device=device)
        return cls(mesh, cfg, x, index, batch_buckets=batch_buckets, device=device)

    def save(self, path, config=None) -> None:
        """Persist the index artifact: every rank gathers the logical index,
        rank 0 writes it (:meth:`SuCoIndex.save`), and every rank returns
        once it is written."""
        _save(self.mesh, self.index, path, config)

    # ---- bucketing -------------------------------------------------------

    def bucket_mq(self, m: int) -> int:
        """The padded batch serving ``m`` queries: the shared
        :func:`batch_bucket` policy, rounded up to a ``q_chunk`` multiple
        past one chunk."""
        return _bucket_mq(m, self.batch_buckets, self.cfg.q_chunk)

    @staticmethod
    def aot_query_fn(
        mesh: Mesh,
        cfg: DistSuCoConfig,
        n: int,
        d: int,
        m: int,
        *,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        device="cuda",
    ):
        """The query step a live engine would dispatch ``m`` queries to, and
        its padded batch: ``-> (query fn, mq)``, with no data."""
        mq = _bucket_mq(m, batch_buckets, cfg.q_chunk)
        return make_query_fn(mesh, cfg, n, d, mq, device=device), mq

    # ---- query -----------------------------------------------------------

    def _fn_for(self, mq: int):
        fn = self._fns.get(mq)
        if fn is None:
            fn = make_query_fn(self.mesh, self.cfg, self.n, self.d, mq, device=self.device)
            self._fns[mq] = fn
        return fn

    def _invoke(self, b: int, q_padded: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cols = index_shardings(self.mesh, self.cfg, self.n, self.d)["queries"]
        idx = self.index
        return self._fn_for(b)(
            self.x_loc, idx.centroids1, idx.centroids2, idx.cell_ids, idx.cell_counts,
            q_padded[cols].contiguous(),
        )

    def query(self, q) -> tuple[torch.Tensor, torch.Tensor]:
        """``q: (m, d) -> (ids (m, k), dists (m, k))``, the global top-k."""
        q = torch.as_tensor(q, dtype=torch.float32).to(self.device)
        if q.dim() != 2 or q.shape[1] != self.d:
            raise ValueError(f"queries must be (m, {self.d}), got {tuple(q.shape)}")
        m = q.shape[0]
        b = self.bucket_mq(m)
        if b != m:
            q = F.pad(q, (0, 0, 0, b - m))
        ids, dists = self._invoke(b, q)
        return ids[:m], dists[:m]

    def warmup(self, batch_sizes: Sequence[int] = (1,)) -> int:
        """One query step per bucket of the traffic mix, each run once on a
        zero batch; returns the number of new steps."""
        before = self.compile_count
        for b in sorted({self.bucket_mq(m) for m in batch_sizes}):
            self._invoke(b, torch.zeros((b, self.d), device=self.device))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()  # host-sync: ok — warm-up only
        return self.compile_count - before

    @property
    def compile_count(self) -> int:
        """Query steps made, one per bucket (the reference's executables)."""
        return len(self._fns)


def _save(mesh: Mesh, index: ShardedIndex, path, config) -> None:
    logical = index.gather()
    if mesh.rank == 0:
        logical.save(path, config)
    mesh.barrier()


# --------------------------------------------------------------------------
# ShardedEnginePool: per-k engines for heterogeneous-k sharded traffic
# --------------------------------------------------------------------------


class ShardedEnginePool:
    """Per-``k`` pool of :class:`ShardedSuCoEngine` over one placed dataset.

    A sharded engine bakes ``k`` into its config (per-shard candidate pools
    are ``candidate_pool_size(n_local, k, beta)`` wide), so the pool places
    ``(x, index)`` on this rank exactly once and keeps one engine per ``k``
    over those shares.  After :meth:`warmup` covers the traffic mix, the
    pool-wide ``compile_count`` stays flat across every ``k``.
    """

    def __init__(
        self,
        mesh: Mesh,
        cfg: DistSuCoConfig,
        x,
        index,
        *,
        ks: Sequence[int] = (),
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        device: torch.device | str = "cuda",
    ):
        dev = torch.device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.x_loc, self.n, self.d = _local_x(mesh, cfg, x, dev)
        self.index = _as_sharded(mesh, cfg, index, dev)
        self.device = dev
        self.batch_buckets = tuple(batch_buckets)
        self._engines: dict[int, ShardedSuCoEngine] = {}
        self._dead: set[int] = set()  # k-classes whose engine raised
        self._rebound: dict[int, str] = {}  # dead k -> failure reason
        for k in ks:
            self.engine_for(k)

    # ---- lifecycle -------------------------------------------------------

    @classmethod
    def build(
        cls,
        mesh: Mesh,
        cfg: DistSuCoConfig,
        x,
        *,
        ks: Sequence[int] = (),
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        device: torch.device | str = "cuda",
    ) -> "ShardedEnginePool":
        """Distributed Algorithm 2 (:func:`build_sharded`) -> pool."""
        index = build_sharded(mesh, x, cfg, device=device)
        return cls(mesh, cfg, x, index, ks=ks, batch_buckets=batch_buckets, device=device)

    @classmethod
    def from_artifact(
        cls,
        path,
        mesh: Mesh,
        cfg: DistSuCoConfig,
        x,
        *,
        ks: Sequence[int] = (),
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        device: torch.device | str = "cuda",
    ) -> "ShardedEnginePool":
        """Serve a ``SuCoIndex.save`` artifact across the mesh, per-k pooled."""
        index, _ = load_index_artifact(path, device=device)
        return cls(mesh, cfg, x, index, ks=ks, batch_buckets=batch_buckets, device=device)

    def save(self, path, config=None) -> None:
        """Persist the shared index artifact (as :meth:`ShardedSuCoEngine.save`)."""
        _save(self.mesh, self.index, path, config)

    # ---- binding ---------------------------------------------------------

    @property
    def ks(self) -> tuple[int, ...]:
        """The ``k`` values with live engines."""
        return tuple(sorted(self._engines))

    @property
    def dead_ks(self) -> tuple[int, ...]:
        """k-classes marked dead by :meth:`query_resilient` (their traffic
        is rebound to healthy engines until :meth:`revive`)."""
        return tuple(sorted(self._dead))

    def engine_for(self, k: int) -> ShardedSuCoEngine:
        """The pool member serving ``k``, made on first use over the pool's
        placed shares (warm it, or declare ``ks=``, before serving)."""
        eng = self._engines.get(k)
        if eng is None:
            if not 1 <= k <= self.n:
                raise ValueError(f"k={k} must be in [1, n={self.n}]")
            eng = ShardedSuCoEngine._placed(
                self.mesh, dataclasses.replace(self.cfg, k=k), self.x_loc, self.n, self.d,
                self.index, self.batch_buckets,
            )
            self._engines[k] = eng
        return eng

    # ---- query -----------------------------------------------------------

    def query(self, q, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``q: (m, d), k -> (ids (m, k), dists (m, k))`` through the
        per-``k`` engine's bucketed step."""
        return self.engine_for(k).query(q)

    # ---- fault tolerance -------------------------------------------------

    def _rebind_target(self, k: int) -> int:
        """The healthy k-class serving a dead ``k``: the smallest live
        ``k' >= k`` (its top-k' truncates to the exact top-k), else the
        largest live ``k' < k`` (a shorter answer; ``degraded`` either way)."""
        live = [kk for kk in sorted(self._engines) if kk not in self._dead]
        if not live:
            raise RuntimeError(
                f"ShardedEnginePool: no healthy engines left to rebind k={k} "
                f"(dead: {sorted(self._dead)})"
            )
        for kk in live:
            if kk >= k:
                return kk
        return live[-1]

    def revive(self, k: int) -> None:
        """Return a dead k-class to service with a fresh engine, so a
        poisoned ``query`` binding does not linger."""
        if k in self._dead:
            self._dead.discard(k)
            self._rebound.pop(k, None)
            self._engines.pop(k, None)
            self.engine_for(k)

    def query_resilient(self, q, k: int) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """:meth:`query` that survives a dead or raising per-``k`` engine.

        Any failure but ``ValueError`` (a dying shard binding; a healthy
        engine does not raise on a well-formed query) marks the k-class
        dead and rebinds the request to a healthy engine
        (:meth:`_rebind_target`): truncated to ``k`` when it serves a larger
        k', shorter when only a smaller k' is left.  Returns ``(ids, dists,
        info)``, ``info = {"degraded": bool, "served_by": k', "reason":
        str}``.  ``ValueError`` (malformed input) is raised unchanged and
        kills nothing.
        """
        if k not in self._dead:
            try:
                ids, dists = self.engine_for(k).query(q)
                return ids, dists, {"degraded": False, "served_by": k, "reason": ""}
            except ValueError:
                raise
            except Exception as e:
                self._dead.add(k)
                self._rebound[k] = f"{type(e).__name__}: {e}"
        k2 = self._rebind_target(k)
        ids, dists = self.engine_for(k2).query(q)
        if k2 > k:
            ids, dists = ids[..., :k], dists[..., :k]
        return ids, dists, {
            "degraded": True,
            "served_by": k2,
            "reason": f"k={k} engine dead ({self._rebound.get(k, 'unknown')}), "
                      f"rebound to k={k2}",
        }

    def warmup(self, batch_sizes: Sequence[int] = (1,), ks: Sequence[int] | None = None) -> int:
        """One query step per (bucket, k) of the traffic mix; returns the
        number of new steps.  ``ks=None`` warms the engines in the pool."""
        ks = self.ks if ks is None else ks
        return sum(self.engine_for(k).warmup(batch_sizes) for k in sorted(set(ks)))

    @property
    def compile_count(self) -> int:
        """Query steps over the pool (the sum over its engines): flat after
        a warm-up that covers the traffic."""
        return sum(e.compile_count for e in self._engines.values())

    @staticmethod
    def aot_query_fn(
        mesh: Mesh,
        cfg: DistSuCoConfig,
        n: int,
        d: int,
        m: int,
        k: int,
        *,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        device="cuda",
    ):
        """:meth:`ShardedSuCoEngine.aot_query_fn` with ``k`` bound as
        :meth:`engine_for` binds it."""
        return ShardedSuCoEngine.aot_query_fn(
            mesh, dataclasses.replace(cfg, k=k), n, d, m, batch_buckets=batch_buckets,
            device=device,
        )
