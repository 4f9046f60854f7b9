"""SuCo (paper Algorithms 2-4) on torch: the index and its lifecycle, the
queries and the serving engine over it.

The counterpart of ``repro.core.suco``'s index and engine:

* **Index** (Alg. 2): per subspace, split the dims in two halves and train
  ``sqrt(K)`` centroids per half; the IMI is the ``sqrt(K) x sqrt(K)``
  grid.  Stored densely as ``cell_ids (Ns, n) int32`` and ``cell_counts
  (Ns, K) int32``.  :func:`build_index` builds it in one of the JAX
  package's four modes (``SuCoConfig.build_mode``: dense Lloyd, chunked
  Lloyd, minibatch with kmeans++ seeding, or "auto": dense below
  :data:`STREAMING_MIN_N` points and chunked from it on).
* **Lifecycle**: :meth:`SuCoIndex.insert` assigns new points to the
  existing centroids (:func:`assign_points`, the build's final assignment
  over the new points only) and :meth:`SuCoIndex.delete` tombstones ids,
  both keeping ``cell_counts`` equal to the live occupancy.
  :meth:`SuCoIndex.save` writes the JAX package's version-3 ``.npz``
  artifact (per-array CRC32, the build config, ``extra_<name>`` sidecar
  arrays, an atomic replace); :func:`load_index_artifact` reads versions
  1-3, from either package, with the same checks.
* **Query** (Algs. 3-4) as :func:`suco_query_fused`: Dynamic Activation as
  per-cell ranks and cutoffs, then one pass over the data in chunks.  Per
  chunk one kernel scores, prunes (Pareto: only rows beating the carried
  pool minimum can enter) and compacts the survivors; their exact distances
  are computed in-pass (the gather-rerank kernel) and merged into a carried
  ``(score, dist, id)`` pool in (score desc, id asc) order.  A chunk whose
  survivors overflow the compaction width takes the exact fallback: the
  chunk's own top ``min(pool, chunk)`` rows.  Either way the result equals
  the JAX package's, id for id, up to ties of the fp distances.  The
  overflow decision reads one flag back to the host per chunk; the engine
  counts these synchronisations.
* **The other query modes** of :func:`suco_query`: ``"dense"`` scores all
  ``n`` points at once (:func:`suco_scores`, one ``(m, n)`` matrix) and
  re-ranks the top pool; ``"streaming"`` (:func:`suco_query_streaming`)
  scores ``block_n``-point chunks and merges each into a carried
  ``(score, id)`` pool, reading nothing back to the host.  ``"auto"`` is
  dense below :data:`STREAMING_MIN_N` points and fused from it on.  All
  modes return the same answers.
* **Serving**: :class:`SuCoEngine` holds ``(x, index, EnginePolicy)`` on
  one device, pads each batch to a bucket and answers it in the mode the
  policy resolved to at construction.  Built with ``capacity=``, it takes
  live inserts into pre-allocated slots and deletes, without changing a
  tensor's shape, and hands over to a warmed successor with
  :meth:`SuCoEngine.swap`.  The policy counts served batch sizes, from
  which :func:`autoscale_buckets` proposes the buckets of
  :meth:`SuCoEngine.autoscaled`; :meth:`EnginePolicy.degraded` gives the
  reduced budgets of the serving layer's degradation ladder
  (:mod:`repro_torch.serve.ann`).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
import tempfile
import zipfile
import zlib
from typing import Iterable, Mapping, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import subspace as sub
from repro_torch.core.distances import Metric, pairwise_dist_rowwise
from repro_torch.core.kmeans import kmeans_batched, pair_cell_counts
from repro_torch.kernels.kmeans_assign.ops import kmeans_stats
from repro_torch.core.sc_linear import (
    INT32_MAX,
    _resolve_merge_impl,
    QueryResult,
    candidate_dists,
    candidate_pool_size,
    merge_topk_pool,
    merge_topk_pool_with_dists,
    rerank,
    rerank_candidates,
    top_block_positions,
)
from repro_torch.core.spans import loop_span
from repro_torch.core.tuning import (
    TileConfig,
    autotune_build_block_n,
    autotune_tiles,
    device_limits,
)
from repro_torch.kernels.sc_score.ops import sc_scores_cells, sc_scores_cells_prefilter_compact

__all__ = [
    "SuCoConfig",
    "SuCoIndex",
    "ArtifactError",
    "CapacityError",
    "INDEX_ARTIFACT_VERSION",
    "build_index",
    "assign_points",
    "load_index_artifact",
    "STREAMING_MIN_N",
    "activate_cells_sorted",
    "dynamic_activation_lax",
    "suco_cell_ranks",
    "suco_scores",
    "suco_query",
    "suco_query_streaming",
    "suco_query_fused",
    "batch_bucket",
    "padding_waste",
    "autoscale_buckets",
    "DEFAULT_BATCH_BUCKETS",
    "EnginePolicy",
    "EngineStats",
    "SuCoEngine",
    "DEFAULT_MERGE_IMPL",
]

#: The pool merge of the streaming and fused chunk loops
#: (``sc_linear.merge_topk_pool``'s ``impl``): the stable sort of the
#: (score desc, id asc) key.  ``"counting"`` / ``"auto"`` is the reference's
#: sort-free merge, with equal bits, but ~5 (Ns + 2) more launches a chunk
#: on a host-bound path: the main path's fused batches of 1 / 8 / 64 took
#: 12.0 / 19.3 / 31.5 ms under the sort and 38.2 / 54.2 / 98.3 ms under the
#: counting merge (H100 80GB HBM3, 700 W; ``chip_smoke.py``'s
#: ``static_gate``, ``PERF.md`` §6).
DEFAULT_MERGE_IMPL = "sort"

# mode="auto" answers from the dense (m, n) score matrix below this many
# points and with the single-pass fused query from it on (the JAX package's
# cutover); the build's "auto" switches dense -> chunked Lloyd at the same n.
STREAMING_MIN_N = 32_768

_BUILD_MODES = ("auto", "dense", "chunked", "minibatch")

# The JAX package's artifact contract (repro.core.suco): a plain .npz,
# tagged and version-stamped; v2 adds "tombstone", v3 per-array checksums
# ("crc_<key>", all but the two keys below, which are checked by value) and
# the "extra_<name>" sidecar arrays.
_ARTIFACT_MAGIC = "suco-index"
INDEX_ARTIFACT_VERSION = 3
_ARTIFACT_READABLE_VERSIONS = (1, 2, 3)
_ARTIFACT_UNCHECKSUMMED = ("artifact", "version")
_ARTIFACT_EXTRA_PREFIX = "extra_"
_ARTIFACT_REQUIRED_KEYS = (
    "artifact", "version", "centroids1", "centroids2", "cell_ids", "cell_counts",
    "sqrt_k", "spec_d", "spec_n_subspaces", "spec_perm", "spec_bounds",
)


class ArtifactError(ValueError):
    """An index artifact could not be loaded: a foreign file, an unsupported
    version, missing keys, a checksum mismatch or a corrupt payload."""


class CapacityError(ValueError):
    """A mutable :class:`SuCoEngine` has too few free slots for an insert:
    the signal to re-index onto a larger successor."""


def _array_crc(a: np.ndarray) -> int:
    """CRC32 over an array's dtype, shape and raw bytes — the ``crc_<key>``
    content checksum of a version-3 artifact."""
    a = np.ascontiguousarray(a)
    h = zlib.crc32(str(a.dtype).encode())
    h = zlib.crc32(repr(a.shape).encode(), h)
    h = zlib.crc32(a.tobytes(), h)
    return h & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SuCoConfig:
    """Static SuCo hyper-parameters (paper defaults: K=50^2, Ns=8, t=20).

    ``build_mode``: "auto" | "dense" | "chunked" | "minibatch" (see
    :func:`build_index`).  ``block_n`` is the build's chunk of points (the
    minibatch sample size); 0 autotunes it from the device's memory limits
    (:func:`repro_torch.core.tuning.autotune_build_block_n`).
    """

    n_subspaces: int = 8
    sqrt_k: int = 50
    kmeans_iters: int = 20
    seed: int = 0
    build_mode: str = "auto"
    block_n: int = 4096

    @property
    def n_cells(self) -> int:
        return self.sqrt_k * self.sqrt_k


@dataclasses.dataclass
class SuCoIndex:
    """Centroid codebooks + dense IMI occupancy, all on one device.

    ``tombstone`` (optional ``(n,) bool``, True = deleted) excludes points
    from every candidate pool; ``cell_counts`` counts live points only.
    """

    centroids1: torch.Tensor  # (Ns, sqrtK, h_max) float32
    centroids2: torch.Tensor  # (Ns, sqrtK, h_max) float32
    cell_ids: torch.Tensor  # (Ns, n) int32
    cell_counts: torch.Tensor  # (Ns, K) int32
    spec: sub.SubspaceSpec
    sqrt_k: int
    tombstone: torch.Tensor | None = None

    @property
    def n_cells(self) -> int:
        return self.sqrt_k * self.sqrt_k

    @property
    def n_points(self) -> int:
        return self.cell_ids.shape[1]

    @property
    def n_live(self) -> int:
        """Live (non-tombstoned) point count."""
        if self.tombstone is None:
            return self.n_points
        return self.n_points - int(self.tombstone.sum())

    def to(self, device: torch.device | str) -> "SuCoIndex":
        """This index with every tensor on ``device``."""
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self,
            centroids1=move(self.centroids1),
            centroids2=move(self.centroids2),
            cell_ids=move(self.cell_ids),
            cell_counts=move(self.cell_counts),
            tombstone=move(self.tombstone),
        )

    def memory_bytes(self) -> int:
        """Index footprint (the paper's ``O(sqrt(K) d + n Ns)`` claim)."""
        arrays = (self.centroids1, self.centroids2, self.cell_ids, self.cell_counts, self.tombstone)
        return sum(t.numel() * t.element_size() for t in arrays if t is not None)

    # ---- live mutation ---------------------------------------------------

    def insert(self, x_new, *, block_n: int = 4096) -> "SuCoIndex":
        """Append ``x_new: (b, d)`` points, assigned to the existing
        centroids (Alg. 2's assignment step only, no re-cluster):
        a new index with ``b`` more live columns, ids ``n_points ..
        n_points + b - 1``, and ``cell_counts`` grown by their occupancy.
        Shapes change, so a serving engine inserts into pre-allocated slots
        instead (:meth:`SuCoEngine.insert`)."""
        x_new = _points(x_new, self.spec.d, self.cell_ids.device)
        cells, counts_delta, _ = assign_points(
            x_new, self.centroids1, self.centroids2, spec=self.spec, sqrt_k=self.sqrt_k,
            block_n=block_n,
        )
        tomb = self.tombstone
        if tomb is not None:
            tomb = torch.cat([tomb, tomb.new_zeros(x_new.shape[0])])
        return dataclasses.replace(
            self,
            cell_ids=torch.cat([self.cell_ids, cells], dim=1),
            cell_counts=self.cell_counts + counts_delta,
            tombstone=tomb,
        )

    def delete(self, ids) -> "SuCoIndex":
        """Tombstone the given point ids (idempotent; duplicates fine): a new
        index whose ``cell_counts`` drops the *newly* deleted points only.
        Shapes are kept.  Ids outside ``[0, n_points)`` raise."""
        ids = _checked_ids(ids, self.n_points)
        if ids.size == 0:
            return self
        dev = self.cell_ids.device
        tomb = (torch.zeros(self.n_points, dtype=torch.bool, device=dev)
                if self.tombstone is None else self.tombstone.clone())
        counts = self.cell_counts.clone()
        _tombstone_(tomb, counts, self.cell_ids, torch.as_tensor(ids, device=dev))
        return dataclasses.replace(self, cell_counts=counts, tombstone=tomb)

    # ---- persistence -----------------------------------------------------

    def save(
        self,
        path,
        config: SuCoConfig | None = None,
        *,
        extras: Mapping[str, np.ndarray] | None = None,
    ) -> None:
        """Write the index as a version-3 ``.npz`` artifact, the JAX
        package's format: the four index arrays byte for byte, the subspace
        spec, the tombstone (as uint8) when there is one, the build
        ``config`` when given, and ``extras`` as ``extra_<name>`` arrays;
        each array with its ``crc_<key>`` CRC32.

        The write is atomic: the payload goes to a temp file in the same
        directory, is fsynced and replaces ``path``; a failed write removes
        the temp file and leaves ``path`` as it was."""
        cpu = lambda t: t.detach().cpu().numpy()
        payload: dict[str, np.ndarray] = {
            "artifact": np.asarray(_ARTIFACT_MAGIC),
            "version": np.asarray(INDEX_ARTIFACT_VERSION, np.int32),
            "centroids1": cpu(self.centroids1),
            "centroids2": cpu(self.centroids2),
            "cell_ids": cpu(self.cell_ids),
            "cell_counts": cpu(self.cell_counts),
            "sqrt_k": np.asarray(self.sqrt_k, np.int32),
            "spec_d": np.asarray(self.spec.d, np.int32),
            "spec_n_subspaces": np.asarray(self.spec.n_subspaces, np.int32),
            "spec_perm": np.asarray(self.spec.perm, np.int32),
            "spec_bounds": np.asarray(self.spec.bounds, np.int32),
        }
        if self.tombstone is not None:
            payload["tombstone"] = cpu(self.tombstone).astype(np.uint8)
        if config is not None:
            payload.update(
                config_n_subspaces=np.asarray(config.n_subspaces, np.int32),
                config_sqrt_k=np.asarray(config.sqrt_k, np.int32),
                config_kmeans_iters=np.asarray(config.kmeans_iters, np.int32),
                config_seed=np.asarray(config.seed, np.int32),
                config_build_mode=np.asarray(config.build_mode),
                config_block_n=np.asarray(config.block_n, np.int32),
            )
        for name, value in (extras or {}).items():
            payload[_ARTIFACT_EXTRA_PREFIX + name] = np.asarray(value)
        payload.update({
            f"crc_{k}": np.asarray(_array_crc(v), np.uint32)
            for k, v in list(payload.items()) if k not in _ARTIFACT_UNCHECKSUMMED
        })
        _write_atomic(path, payload)

    @classmethod
    def load(cls, path, *, device: torch.device | str = "cuda") -> "SuCoIndex":
        """Load an artifact written by :meth:`save` (or the JAX package's)
        onto ``device``, bit-identical."""
        return load_index_artifact(path, device=device)[0]

    @classmethod
    def from_numpy(
        cls,
        centroids1: np.ndarray,
        centroids2: np.ndarray,
        cell_ids: np.ndarray,
        cell_counts: np.ndarray,
        *,
        spec: sub.SubspaceSpec,
        sqrt_k: int,
        tombstone: np.ndarray | None = None,
        device: torch.device | str = "cuda",
    ) -> "SuCoIndex":
        """An index from numpy arrays in the JAX package's layouts (the
        weights of an index built there), checked and moved to ``device``."""
        ns, k = spec.n_subspaces, int(sqrt_k)
        h = spec.max_half_size
        for name, a in (("centroids1", centroids1), ("centroids2", centroids2)):
            if np.shape(a) != (ns, k, h):
                raise ValueError(f"{name} must be {(ns, k, h)}, got {np.shape(a)}")
        if np.ndim(cell_ids) != 2 or np.shape(cell_ids)[0] != ns:
            raise ValueError(f"cell_ids must be ({ns}, n), got {np.shape(cell_ids)}")
        if np.shape(cell_counts) != (ns, k * k):
            raise ValueError(f"cell_counts must be {(ns, k * k)}, got {np.shape(cell_counts)}")
        n = np.shape(cell_ids)[1]
        if tombstone is not None and np.shape(tombstone) != (n,):
            raise ValueError(f"tombstone must be ({n},), got {np.shape(tombstone)}")

        def t(a, dtype):
            return torch.tensor(np.asarray(a, dtype=dtype), device=device)

        return cls(
            centroids1=t(centroids1, np.float32),
            centroids2=t(centroids2, np.float32),
            cell_ids=t(cell_ids, np.int32),
            cell_counts=t(cell_counts, np.int32),
            spec=spec,
            sqrt_k=k,
            tombstone=None if tombstone is None else t(tombstone, np.bool_),
        )


def _points(x_new, d: int, device: torch.device) -> torch.Tensor:
    """New points as a ``(b, d)`` float32 tensor on ``device``."""
    x_new = torch.as_tensor(x_new, dtype=torch.float32).to(device)
    if x_new.dim() == 1:
        x_new = x_new[None]
    if x_new.dim() != 2 or x_new.shape[1] != d:
        raise ValueError(f"points must be (b, {d}), got {tuple(x_new.shape)}")
    return x_new


def _checked_ids(ids, n: int) -> np.ndarray:
    """Sorted unique int64 ids, each in ``[0, n)``."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    ids = np.unique(np.asarray(ids, dtype=np.int64))
    if ids.size and (ids[0] < 0 or ids[-1] >= n):
        raise ValueError(f"ids must be in [0, {n}), got range [{ids[0]}, {ids[-1]}]")
    return ids


def _tombstone_(
    tomb: torch.Tensor, counts: torch.Tensor, cell_ids: torch.Tensor, ids: torch.Tensor
) -> torch.Tensor:
    """In place: mark ``ids`` (unique, in range) deleted in ``tomb`` and
    drop the newly dead ones from ``counts``; returns the newly dead mask."""
    newly = ~tomb[ids]
    tomb[ids] = True
    ns, n_cells = counts.shape
    cells = cell_ids[:, ids].long() + (torch.arange(ns, device=ids.device) * n_cells)[:, None]
    dead = newly.to(torch.int32).expand(ns, -1)
    counts.view(-1).index_add_(0, cells.reshape(-1), -dead.reshape(-1))
    return newly


def _write_atomic(path, payload: Mapping[str, np.ndarray]) -> None:
    """``np.savez`` of ``payload`` to ``path`` by a same-directory temp file,
    fsync and ``os.replace``; the temp file is removed on any failure."""
    path = os.fspath(path)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".", prefix=os.path.basename(path) + ".", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        raise


@torch.inference_mode()
def build_index(
    x: torch.Tensor,
    config: SuCoConfig = SuCoConfig(),
    *,
    spec: sub.SubspaceSpec | None = None,
    init_centroids: torch.Tensor | None = None,
    sample_idx: torch.Tensor | None = None,
) -> SuCoIndex:
    """Algorithm 2 on ``x: (n, d)``, on the device ``x`` lies on.

    K-means over the ``2*Ns`` half-subspace codebooks in ``config.
    build_mode``: "dense" (full-batch Lloyd), "chunked" (Lloyd over
    ``block_n``-point chunks), "minibatch" (``kmeans_iters`` sampled steps
    of ``block_n`` points, kmeans++ seeding), or "auto" (dense below
    :data:`STREAMING_MIN_N` points, chunked from it on); then the paired
    final assignment with the IMI histogram.  Dense and chunked run the same
    update rule and differ only in fp summation order.  Deterministic given
    ``config.seed``.  Test hooks: ``init_centroids: (2*Ns, sqrtK, h_max)``
    (first halves, then second halves) replaces the initial centroids, and
    ``sample_idx: (kmeans_iters, block_n)`` the minibatch samples.
    """
    if spec is None:
        spec = sub.contiguous_spec(x.shape[-1], config.n_subspaces)
    mode = config.build_mode
    if mode not in _BUILD_MODES:
        raise ValueError(f"unknown build_mode {mode!r}, expected one of {_BUILD_MODES}")
    x = x.float()
    n, d = x.shape
    if mode == "auto":
        mode = "chunked" if n >= STREAMING_MIN_N else "dense"
    if mode != "dense" and config.block_n < 0:
        raise ValueError(
            f"build_mode={mode!r} requires block_n >= 0 (0 = autotune), got {config.block_n}"
        )
    if mode == "dense":
        block_n = 0
    else:
        block_n = config.block_n or autotune_build_block_n(
            n, d, sqrt_k=config.sqrt_k, n_subspaces=spec.n_subspaces,
            limits=device_limits(x.device),
        )
    h1, h2 = sub.split_halves_padded(spec, sub.permute(spec, x))
    both = torch.cat([h1, h2], dim=0).contiguous()  # (2Ns, n, h_max)
    del h1, h2
    res = kmeans_batched(
        both, config.sqrt_k, config.kmeans_iters,
        algo="minibatch" if mode == "minibatch" else "lloyd", block_n=block_n,
        pair_sqrt_k=config.sqrt_k, generator=torch.Generator().manual_seed(config.seed),
        init_centroids=init_centroids, sample_idx=sample_idx,
    )
    ns = spec.n_subspaces
    a = res.assignments
    cell_ids = (a[:ns] * config.sqrt_k + a[ns:]).to(torch.int32)
    return SuCoIndex(
        res.centroids[:ns].contiguous(), res.centroids[ns:].contiguous(),
        cell_ids, res.cell_counts, spec=spec, sqrt_k=config.sqrt_k,
    )


@torch.inference_mode()
def assign_points(
    x_new: torch.Tensor,
    centroids1: torch.Tensor,
    centroids2: torch.Tensor,
    *,
    spec: sub.SubspaceSpec,
    sqrt_k: int,
    block_n: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assign ``x_new: (b, d)`` to existing centroids, in ``block_n``-point
    chunks: the incremental-insert core.  Returns ``(cell_ids (Ns, b)
    int32, counts_delta (Ns, K) int32, inertia () f32)``: the occupancy to
    add to ``cell_counts`` and the new points' assignment inertia (the
    drift statistic).  One Lloyd-statistics pass with its assignments (the
    kernel on the card), then an integer bincount of the cells."""
    ns = spec.n_subspaces
    h1, h2 = sub.split_halves_padded(spec, sub.permute(spec, x_new.float()))
    both = torch.cat([h1, h2], dim=0).contiguous()
    cents = torch.cat([centroids1, centroids2], dim=0).contiguous()
    a, _, _, inertia = kmeans_stats(both, cents, block_n=block_n, with_assign=True)
    cells = (a[:ns] * sqrt_k + a[ns:]).to(torch.int32)
    return cells, pair_cell_counts(a, sqrt_k), inertia.sum()


def load_index_artifact(
    path, *, device: torch.device | str = "cuda", return_extras: bool = False
) -> (tuple[SuCoIndex, SuCoConfig | None]
      | tuple[SuCoIndex, SuCoConfig | None, dict[str, np.ndarray]]):
    """Load an index artifact written by :meth:`SuCoIndex.save` of either
    package -> ``(index on device, build config | None)``; with
    ``return_extras`` also the ``extra_<name>`` sidecar arrays as
    ``{name: array}``.

    Checks the tag, the key inventory and the version (1-3) before touching
    any payload, and every ``crc_<key>`` content checksum of a version-3
    artifact before building anything; each failure raises
    :class:`ArtifactError` naming the path and what failed.
    """
    try:
        z = np.load(path, allow_pickle=False)
    except (ValueError, OSError, EOFError, zipfile.BadZipFile) as e:
        raise ArtifactError(f"{path!s}: not a readable npz ({type(e).__name__}: {e})") from e
    with z:
        names = set(z.files)
        if "artifact" not in names or str(z["artifact"][()]) != _ARTIFACT_MAGIC:
            raise ArtifactError(f"{path!s} is not a {_ARTIFACT_MAGIC} artifact")
        missing = [k for k in _ARTIFACT_REQUIRED_KEYS if k not in names]
        if missing:
            raise ArtifactError(
                f"{path!s}: {_ARTIFACT_MAGIC} artifact is missing keys {missing} "
                f"(found {sorted(names)})"
            )
        try:
            version = int(z["version"][()])
            if version not in _ARTIFACT_READABLE_VERSIONS:
                raise ArtifactError(
                    f"{path!s}: unsupported {_ARTIFACT_MAGIC} artifact version {version} "
                    f"(readable: {_ARTIFACT_READABLE_VERSIONS})"
                )
            arrays = {k: z[k] for k in names}
        except ArtifactError:
            raise
        except (ValueError, OSError, EOFError, zipfile.BadZipFile, zlib.error) as e:
            # a member listed in the directory but truncated mid-payload
            raise ArtifactError(
                f"{path!s}: {_ARTIFACT_MAGIC} artifact payload is corrupt "
                f"({type(e).__name__}: {e})"
            ) from e
    for key in sorted(names):
        if key.startswith("crc_") or f"crc_{key}" not in names:
            continue
        stored = int(arrays[f"crc_{key}"][()])
        computed = _array_crc(arrays[key])
        if computed != stored:
            raise ArtifactError(
                f"{path!s}: content checksum mismatch on key {key!r} "
                f"(stored 0x{stored:08x}, computed 0x{computed:08x})"
            )
    spec = sub.SubspaceSpec(
        d=int(arrays["spec_d"][()]),
        n_subspaces=int(arrays["spec_n_subspaces"][()]),
        perm=tuple(int(p) for p in arrays["spec_perm"]),
        bounds=tuple(int(b) for b in arrays["spec_bounds"]),
    )
    index = SuCoIndex.from_numpy(
        arrays["centroids1"], arrays["centroids2"], arrays["cell_ids"],
        arrays["cell_counts"], spec=spec, sqrt_k=int(arrays["sqrt_k"][()]),
        tombstone=arrays["tombstone"].astype(bool) if "tombstone" in names else None,
        device=device,
    )
    config = None
    if "config_n_subspaces" in names:
        try:
            config = SuCoConfig(
                n_subspaces=int(arrays["config_n_subspaces"][()]),
                sqrt_k=int(arrays["config_sqrt_k"][()]),
                kmeans_iters=int(arrays["config_kmeans_iters"][()]),
                seed=int(arrays["config_seed"][()]),
                build_mode=str(arrays["config_build_mode"][()]),
                block_n=int(arrays["config_block_n"][()]),
            )
        except KeyError as e:
            raise ArtifactError(f"{path!s}: incomplete build config, no {e}") from e
    if not return_extras:
        return index, config
    extras = {k[len(_ARTIFACT_EXTRA_PREFIX):]: arrays[k]
              for k in names if k.startswith(_ARTIFACT_EXTRA_PREFIX)}
    return index, config, extras


# --------------------------------------------------------------------------
# Dynamic Activation
# --------------------------------------------------------------------------


def _cell_ranks_and_cut(
    dists1: torch.Tensor, dists2: torch.Tensor, cell_counts: torch.Tensor, target: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic Activation as (per-cell rank, cutoff rank), batched.

    ``dists1/dists2: (..., sqrtK)``, ``cell_counts: (..., K)`` (broadcast
    against the leading dims) -> ``(rank (..., K) int32, cut (...) int32)``.
    ``rank[c]`` is cell c's position in ascending ``dists1 + dists2`` order,
    ties by cell id (a stable sort, as ``jnp.argsort``); ``cut`` is the last
    rank of the minimal prefix whose cumulative count reaches ``target``
    (everything when none does).  The activation mask is ``rank <= cut``.
    """
    cell_dist = (dists1[..., :, None] + dists2[..., None, :]).flatten(-2)  # (..., K)
    order = torch.argsort(cell_dist, dim=-1, stable=True)
    counts = cell_counts.expand(order.shape)
    csum = torch.cumsum(torch.gather(counts, -1, order), dim=-1)
    reached = csum >= target
    n_cells = order.shape[-1]
    first = torch.argmax(reached.to(torch.int32), dim=-1)
    cut = torch.where(reached.any(dim=-1), first, n_cells - 1)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n_cells, device=order.device).expand(order.shape)
    )
    return rank.to(torch.int32), cut.to(torch.int32)


def activate_cells_sorted(
    dists1: torch.Tensor, dists2: torch.Tensor, cell_counts: torch.Tensor, target: int
) -> torch.Tensor:
    """Dynamic Activation as a sort prefix (the exact equivalent of Alg. 3).

    ``dists1/dists2: (sqrtK,)``, ``cell_counts: (K,)`` (row-major over
    ``(c1, c2)``) -> ``(K,)`` bool: the minimal ascending-distance prefix of
    cells whose cumulative count reaches ``target``.
    """
    rank, cut = _cell_ranks_and_cut(dists1, dists2, cell_counts, target)
    return rank <= cut


def dynamic_activation_lax(
    dists1: torch.Tensor, dists2: torch.Tensor, cell_counts: torch.Tensor, target: int
) -> torch.Tensor:
    """Paper Algorithm 3 as written: a loop that pops the nearest active
    cell of the ``sqrtK`` sorted rows until ``target`` points are retrieved.

    Kept for fidelity and tests (it runs on the host, one step per cell);
    the query paths use :func:`activate_cells_sorted`.  Returns the same
    ``(K,)`` bool mask.
    """
    d1, d2 = dists1.cpu(), dists2.cpu()
    k1, k2 = d1.shape[0], d2.shape[0]
    idx1 = torch.argsort(d1, stable=True)
    idx2 = torch.argsort(d2, stable=True)
    s1, s2 = d1[idx1], d2[idx2]
    idx1, idx2 = idx1.tolist(), idx2.tolist()
    counts = cell_counts.cpu().reshape(k1, k2).tolist()

    def cell_dist(r: int, c: int) -> float:  # summed in the inputs' dtype
        return float(s1[r] + s2[c])

    inf = float("inf")
    active_col = [0] * k1
    active_dist = [inf] * k1
    active_dist[0] = cell_dist(0, 0)
    mask = torch.zeros(k1 * k2, dtype=torch.bool)
    got = 0
    while got < target and any(v != inf for v in active_dist):
        pos = min(range(k1), key=lambda r: (active_dist[r], r))  # first minimum, as argmin
        col = active_col[pos]
        c1, c2 = idx1[pos], idx2[col]
        mask[c1 * k2 + c2] = True
        got += counts[c1][c2]
        if col == 0 and pos < k1 - 1:  # popped at column 0: activate the next row (l. 12)
            active_dist[pos + 1] = cell_dist(pos + 1, 0)
            active_col[pos + 1] = 0
        if col < k2 - 1:  # advance this row (l. 15-17) or retire it
            active_col[pos] = col + 1
            active_dist[pos] = cell_dist(pos, col + 1)
        else:
            active_dist[pos] = inf
    return mask.to(dists1.device)


def _centroid_dists(
    index: SuCoIndex, q: torch.Tensor, metric: Metric
) -> tuple[torch.Tensor, torch.Tensor]:
    """``q: (m, d)`` -> query-to-centroid distances ``(Ns, m, sqrtK)`` per
    half, rowwise (the same bits whatever the batch padding or device)."""
    qh1, qh2 = sub.split_halves_padded(index.spec, sub.permute(index.spec, q))
    d1 = pairwise_dist_rowwise(qh1, index.centroids1, metric)
    d2 = pairwise_dist_rowwise(qh2, index.centroids2, metric)
    return d1, d2


def suco_cell_ranks(
    index: SuCoIndex, q: torch.Tensor, count: int, metric: Metric = "l2"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(subspace, query) Dynamic-Activation state for chunked scoring:
    ``q: (m, d) -> (ranks (Ns, m, K) int32, cuts (Ns, m) int32)``."""
    d1, d2 = _centroid_dists(index, q, metric)
    return _cell_ranks_and_cut(d1, d2, index.cell_counts[:, None, :], count)


def suco_scores(
    index: SuCoIndex, q: torch.Tensor, count: int, metric: Metric = "l2"
) -> torch.Tensor:
    """``q: (m, d) -> (m, n)`` int32 SC-scores via the IMI (Alg. 4 l.3-12):
    point j collides with query q in subspace i iff its cell lies inside
    the activated prefix.  One chunked-score launch over all ``n`` columns
    (the SC-score kernel on the card)."""
    ranks, cuts = suco_cell_ranks(index, q, count, metric)
    return sc_scores_cells(ranks, cuts, index.cell_ids)


# --------------------------------------------------------------------------
# Query (Algorithm 4): dense, streaming and single-pass fused
# --------------------------------------------------------------------------


def _check_query(n: int, k: int, metric: Metric) -> None:
    if k > n:
        raise ValueError(f"k={k} must be <= n={n}")
    if metric not in ("l2", "l1"):
        raise ValueError(f"unknown metric {metric!r}")


def _dense_query(
    x: torch.Tensor, index: SuCoIndex, q: torch.Tensor, *, k: int, alpha: float, beta: float,
    metric: Metric,
) -> QueryResult:
    """The dense mode: the ``(m, n)`` score matrix, deleted points at -1,
    then the exact re-rank of its top pool."""
    n = x.shape[0]
    _check_query(n, k, metric)
    scores = suco_scores(index, q, sub.collision_count(n, alpha), metric)
    if index.tombstone is not None:
        # a deleted point scores -1: below every live point, and the rerank
        # gives negative-score slots an infinite distance
        scores = torch.where(index.tombstone[None, :], -1, scores)
    return rerank(x, q, scores, k, candidate_pool_size(n, k, beta), metric)


@torch.inference_mode()
def suco_query_streaming(
    x: torch.Tensor,
    index: SuCoIndex,
    q: torch.Tensor,
    *,
    k: int,
    alpha: float,
    beta: float,
    metric: Metric = "l2",
    block_n: int = 4096,
    merge_impl: str = DEFAULT_MERGE_IMPL,
) -> QueryResult:
    """Algorithm 4 as a streaming query over ``block_n``-point chunks, with
    the same answers as the dense mode and peak memory
    ``O(m * (block_n + n_candidates))``.

    A Python loop over the chunks: per chunk the chunked-score kernel gives
    the ``(m, bc)`` scores (the last chunk is a shorter column slice of the
    cell ids, so nothing is padded), deleted points drop to the sentinel
    ``(-1, INT32_MAX)``, and the chunk merges into a carried top pool in
    (score desc, id asc) order (``merge_impl``, any of
    ``sc_linear.MERGE_IMPLS``: the same bits).  After the loop the pool
    equals the dense top pool exactly, and the exact re-rank returns the
    dense answers.  Nothing is read back to the host.
    """
    if block_n < 1:
        raise ValueError(f"block_n must be >= 1, got {block_n}")
    n = x.shape[0]
    _check_query(n, k, metric)
    m = q.shape[0]
    ns = index.spec.n_subspaces
    ranks, cuts = suco_cell_ranks(index, q, sub.collision_count(n, alpha), metric)
    pool = candidate_pool_size(n, k, beta)
    dev = x.device
    pool_s = torch.full((m, pool), -1, dtype=torch.int32, device=dev)
    pool_i = torch.full((m, pool), INT32_MAX, dtype=torch.int32, device=dev)
    for lo in range(0, n, block_n):
        with loop_span("suco.streaming_chunk"):
            hi = min(lo + block_n, n)
            s = sc_scores_cells(ranks, cuts, index.cell_ids[:, lo:hi])
            ids = torch.arange(lo, hi, dtype=torch.int32, device=dev)
            if index.tombstone is not None:
                live = ~index.tombstone[lo:hi]
                s = torch.where(live[None, :], s, -1)
                ids = torch.where(live, ids, INT32_MAX)
            pool_s, pool_i = merge_topk_pool(
                pool_s, pool_i, s, ids.expand(m, hi - lo), impl=merge_impl, smax=ns
            )
    return rerank_candidates(x, q, pool_i, pool_s, k, metric)


def _fused_query(
    x: torch.Tensor,
    index: SuCoIndex,
    q: torch.Tensor,
    *,
    k: int,
    alpha: float,
    beta: float,
    metric: Metric,
    tiles: TileConfig | None,
    merge_impl: str = DEFAULT_MERGE_IMPL,
) -> tuple[QueryResult, int]:
    """:func:`suco_query_fused` plus the number of host synchronisations it
    made (one per chunk: the overflow decision)."""
    n, d = x.shape
    _check_query(n, k, metric)
    m = q.shape[0]
    ns = index.spec.n_subspaces
    pool = candidate_pool_size(n, k, beta)
    if tiles is None:
        tiles = autotune_tiles(
            n, d, m, pool, limits=device_limits(x.device), n_subspaces=ns,
            itemsize=x.element_size(),
        )
    ranks, cuts = suco_cell_ranks(index, q, sub.collision_count(n, alpha), metric)
    bn = min(tiles.block_n, n)
    cap = min(tiles.survivor_cap, bn)
    dev = x.device
    dist_dtype = torch.float32 if metric == "l2" else torch.promote_types(x.dtype, q.dtype)
    pool_s = torch.full((m, pool), -1, dtype=torch.int32, device=dev)
    pool_d = torch.full((m, pool), float("inf"), dtype=dist_dtype, device=dev)
    pool_i = torch.full((m, pool), INT32_MAX, dtype=torch.int32, device=dev)
    keep = None if index.tombstone is None else ~index.tombstone
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    syncs = 0
    for lo in range(0, n, bn):
        with loop_span("suco.fused_chunk"):
            bc = min(bn, n - lo)
            keep_b = None if keep is None else keep[lo : lo + bc]
            thr = pool_s[:, -1].contiguous()  # pool sorted desc: its minimum
            s, surv_c, surv_s, total = sc_scores_cells_prefilter_compact(
                ranks, cuts, index.cell_ids[:, lo : lo + bc], thr, bc, keep_b, cap=cap
            )
            syncs += 1
            if bool((total > cap).any()):
                # Exact overflow fallback: the merged pool can absorb at most
                # `pool` rows of this chunk, so its own top min(pool, bc) rows
                # by (score desc, id asc) merge to the same pool as all of it.
                cols = torch.arange(bc, dtype=torch.int32, device=dev)
                top = top_block_positions(s, cols, min(pool, bc), ns, merge_impl)
                blk_s = s.gather(1, top)
                ids_b = cols + lo if keep_b is None else torch.where(keep_b, cols + lo, INT32_MAX)
                blk_i = ids_b[top]
                blk_d = torch.where(blk_i == INT32_MAX, float("inf"),
                                    candidate_dists(x, q, blk_i, metric))
            else:
                live = slot[None, :] < total[:, None]  # survivors score > thr >= -1
                blk_i = torch.where(live, surv_c + lo, INT32_MAX)
                blk_s = torch.where(live, surv_s, -1)
                blk_d = torch.where(live, candidate_dists(x, q, blk_i, metric), float("inf"))
            pool_s, pool_d, pool_i = merge_topk_pool_with_dists(
                pool_s, pool_d, pool_i, blk_s, blk_d, blk_i, impl=merge_impl, smax=ns
            )
    # ascending distance, ties to the earlier (score desc, id asc) slot
    pos = torch.sort(pool_d, dim=1, stable=True).indices[:, :k]
    res = QueryResult(pool_i.gather(1, pos), pool_d.gather(1, pos), pool_s.gather(1, pos))
    return res, syncs


@torch.inference_mode()
def suco_query_fused(
    x: torch.Tensor,
    index: SuCoIndex,
    q: torch.Tensor,
    *,
    k: int,
    alpha: float,
    beta: float,
    metric: Metric = "l2",
    tiles: TileConfig | None = None,
    merge_impl: str = DEFAULT_MERGE_IMPL,
) -> QueryResult:
    """Algorithm 4 as the single-pass fused query: score -> prune -> rerank
    -> merge per chunk, on the device ``x`` lies on.

    ``x: (n, d)`` float32, ``q: (m, d)``; returns ``QueryResult`` of
    ``(m, k)`` ids (int32), distances and SC-scores (int32).  ``tiles=None``
    autotunes ``(block_n, survivor_cap)`` from the device's memory limits
    (:func:`repro_torch.core.tuning.autotune_tiles`).  ``merge_impl`` picks
    the pool merge and the overflow fallback's selection
    (``sc_linear.MERGE_IMPLS``; every one gives the same bits).
    """
    return _fused_query(
        x, index, q, k=k, alpha=alpha, beta=beta, metric=metric, tiles=tiles,
        merge_impl=merge_impl,
    )[0]


_MODES = ("auto", "dense", "streaming", "fused")


def _resolve_mode(mode: str, n: int) -> str:
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "auto":
        return "fused" if n >= STREAMING_MIN_N else "dense"
    return mode


def _query(
    x: torch.Tensor,
    index: SuCoIndex,
    q: torch.Tensor,
    *,
    k: int,
    alpha: float,
    beta: float,
    metric: Metric,
    mode: str,
    block_n: int,
    tiles: TileConfig | None,
    merge_impl: str = DEFAULT_MERGE_IMPL,
) -> tuple[QueryResult, int]:
    """:func:`suco_query` plus the number of host synchronisations it made
    (the fused mode's, one per chunk; the other modes make none)."""
    mode = _resolve_mode(mode, x.shape[0])
    kw = dict(k=k, alpha=alpha, beta=beta, metric=metric)
    if mode == "fused":
        return _fused_query(x, index, q, tiles=tiles, merge_impl=merge_impl, **kw)
    if mode == "streaming":
        return suco_query_streaming(x, index, q, block_n=block_n, merge_impl=merge_impl, **kw), 0
    return _dense_query(x, index, q, **kw), 0


@torch.inference_mode()
def suco_query(
    x: torch.Tensor,
    index: SuCoIndex,
    q: torch.Tensor,
    *,
    k: int,
    alpha: float,
    beta: float,
    metric: Metric = "l2",
    mode: str = "auto",
    block_n: int = 4096,
    tiles: TileConfig | None = None,
    merge_impl: str = DEFAULT_MERGE_IMPL,
) -> QueryResult:
    """Algorithm 4: k-ANN for a batch ``q: (m, d)`` with the SuCo index, on
    the device ``x`` lies on.

    ``mode``: ``"dense"`` | ``"streaming"`` | ``"fused"`` | ``"auto"``
    (fused iff ``n >= STREAMING_MIN_N``, else dense).  Every mode returns
    the same answers.  ``block_n`` sizes the streaming mode's chunks; the
    fused mode tiles itself from ``tiles`` (``None`` autotunes).
    ``merge_impl`` (``"topk"`` | ``"sort"`` | ``"counting"`` | ``"auto"``)
    picks the chunk loops' pool merge; every one gives the same answers.
    """
    return _query(
        x, index, q, k=k, alpha=alpha, beta=beta, metric=metric, mode=mode,
        block_n=block_n, tiles=tiles, merge_impl=merge_impl,
    )[0]


# --------------------------------------------------------------------------
# SuCoEngine: batched serving over one (x, index)
# --------------------------------------------------------------------------

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def batch_bucket(m: int, buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS) -> int:
    """The padded batch size serving ``m`` queries: the smallest bucket
    ``>= m``, doubling above the largest bucket."""
    if m < 1:
        raise ValueError(f"batch size must be >= 1, got {m}")
    if not buckets:
        raise ValueError("buckets must be non-empty")
    for b in sorted(buckets):
        if m <= b:
            return int(b)
    b = int(max(buckets))
    while b < m:
        b *= 2
    return b


def padding_waste(
    histogram: Mapping[int, int], buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS
) -> int:
    """Padding rows of serving ``histogram`` (batch size -> count) with
    ``buckets``: ``sum(count * (batch_bucket(m) - m))``, the all-zero query
    rows the engine computes and throws away."""
    return sum(
        int(c) * (batch_bucket(int(m), buckets) - int(m))
        for m, c in histogram.items()
        if c
    )


def autoscale_buckets(
    histogram: Mapping[int, int],
    max_buckets: int = 8,
    *,
    fallback: Sequence[int] = DEFAULT_BATCH_BUCKETS,
) -> tuple[int, ...]:
    """At most ``max_buckets`` bucket sizes minimising the padding waste
    (:func:`padding_waste`) of replaying ``histogram``, by exact dynamic
    programming over the distinct observed sizes (an optimal bucket always
    equals some observed size, so the proposal always covers the largest
    observed batch).  An empty or all-zero histogram returns ``fallback``."""
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    hist = {int(m): int(c) for m, c in histogram.items() if int(c) > 0}
    if not hist:
        fb = tuple(sorted(set(int(b) for b in fallback)))
        if not fb:
            raise ValueError(
                "autoscale_buckets: empty traffic histogram and empty "
                "fallback bucket set — configure at least one bucket"
            )
        return fb
    if min(hist) < 1:
        raise ValueError(f"batch sizes must be >= 1, got {sorted(hist)[0]}")
    sizes = sorted(hist)
    u = len(sizes)
    n_b = min(max_buckets, u)
    # prefix sums: serving sizes[i..j] with bucket sizes[j] wastes
    # sizes[j] * sum(count) - sum(count * size) over the segment
    pc = [0] * (u + 1)
    pm = [0] * (u + 1)
    for i, sz in enumerate(sizes):
        pc[i + 1] = pc[i] + hist[sz]
        pm[i + 1] = pm[i] + hist[sz] * sz

    def seg(i: int, j: int) -> int:
        return sizes[j] * (pc[j + 1] - pc[i]) - (pm[j + 1] - pm[i])

    inf = float("inf")
    dp = [[inf] * u for _ in range(n_b + 1)]
    parent: list[list[int]] = [[-1] * u for _ in range(n_b + 1)]
    for j in range(u):
        dp[1][j] = seg(0, j)
    for t in range(2, n_b + 1):
        for j in range(t - 1, u):
            for i in range(t - 2, j):
                c = dp[t - 1][i] + seg(i + 1, j)
                if c < dp[t][j]:
                    dp[t][j] = c
                    parent[t][j] = i
    best_t = min(range(1, n_b + 1), key=lambda t: (dp[t][u - 1], t))
    chosen = []
    t, j = best_t, u - 1
    while j >= 0 and t >= 1:
        chosen.append(sizes[j])
        j = parent[t][j]
        t -= 1
    return tuple(sorted(chosen))


@dataclasses.dataclass(frozen=True)
class EnginePolicy:
    """Query-serving policy of a :class:`SuCoEngine`: the Alg. 4 knobs, the
    query mode (``"auto"`` | ``"dense"`` | ``"streaming"`` | ``"fused"``;
    ``"auto"`` resolves once, at engine construction: fused iff the data
    has at least :data:`STREAMING_MIN_N` points, else dense), the streaming
    mode's chunk ``block_n``, the fused query's tiling (``None`` autotunes
    per padded bucket and ``k``), the batch buckets and the chunk loops'
    pool merge ``merge_impl`` (``sc_linear.MERGE_IMPLS``).

    ``traffic`` is a histogram of served batch sizes (:meth:`observe`, fed
    by every engine query) from which :meth:`autoscale_buckets` proposes a
    bucket set.  It is observed state, not configuration: it takes no part
    in equality or hashing, and holds at most :attr:`TRAFFIC_MAX_BINS`
    sizes."""

    #: distinct batch sizes the traffic histogram holds; past it a new size
    #: evicts the least frequent bin (the smallest size on ties)
    TRAFFIC_MAX_BINS = 512

    alpha: float = 0.05
    beta: float = 0.02
    metric: Metric = "l2"
    mode: str = "auto"
    block_n: int = 4096
    tiles: TileConfig | None = None
    batch_buckets: tuple[int, ...] = DEFAULT_BATCH_BUCKETS
    merge_impl: str = DEFAULT_MERGE_IMPL  # the chunk loops' pool merge
    traffic: collections.Counter = dataclasses.field(
        default_factory=collections.Counter, init=False, repr=False, compare=False
    )

    def observe(self, batch_sizes: Iterable[int]) -> None:
        """Count served batch sizes into the traffic histogram."""
        for m in batch_sizes:
            m = int(m)
            if m < 1:
                raise ValueError(f"batch size must be >= 1, got {m}")
            if m not in self.traffic and len(self.traffic) >= self.TRAFFIC_MAX_BINS:
                victim = min(self.traffic.items(), key=lambda kv: (kv[1], kv[0]))
                del self.traffic[victim[0]]
            self.traffic[m] += 1

    def reset_traffic(self) -> None:
        """Drop the traffic histogram."""
        self.traffic.clear()

    def autoscale_buckets(self, max_buckets: int | None = None) -> tuple[int, ...]:
        """:func:`autoscale_buckets` of the observed traffic (at most as many
        buckets as configured); the configured buckets before any traffic."""
        if max_buckets is None:
            max_buckets = max(len(self.batch_buckets), 1)
        return autoscale_buckets(self.traffic, max_buckets, fallback=self.batch_buckets)

    def autoscaled(self, max_buckets: int | None = None) -> "EnginePolicy":
        """This policy with the autoscale proposal as its buckets; the
        histogram is carried over, so ``SuCoEngine.warmup(None)`` can warm
        exactly the observed sizes."""
        new = dataclasses.replace(self, batch_buckets=self.autoscale_buckets(max_buckets))
        new.traffic.update(self.traffic)
        return new

    def degraded(self, level: int) -> "EnginePolicy":
        """The reduced-budget policy at degradation-ladder step ``level``
        (0: this policy): ``beta`` halves and ``alpha`` shrinks by 0.8 a
        level, and pinned ``tiles`` halve their ``survivor_cap`` a level
        (a multiple of 64, at least 64; autotuned tiles re-derive it from
        the smaller pool).  A fresh traffic histogram."""
        if level < 0:
            raise ValueError(f"degradation level must be >= 0, got {level}")
        if level == 0:
            return self
        tiles = self.tiles
        if tiles is not None:
            cap = max(64, (tiles.survivor_cap >> level) // 64 * 64)
            tiles = dataclasses.replace(tiles, survivor_cap=cap)
        return dataclasses.replace(
            self,
            alpha=max(self.alpha * 0.8**level, 1e-6),
            beta=self.beta * 0.5**level,
            tiles=tiles,
        )


class EngineStats(NamedTuple):
    executables: int  # (bucket, k) pairs warmed or served: the compile_count
    batches: int  # query() calls served
    queries: int  # individual queries served (before padding)
    padded_queries: int  # padding rows across all batches
    buckets: tuple[tuple[int, int], ...]  # (bucket, k) pairs seen
    host_syncs: int  # host synchronisations inside the queries (fused mode only)


class SuCoEngine:
    """Serves ``query(q, k)`` over ``(x, index, policy)`` on one device.

    Each batch is zero-padded to a policy bucket (:func:`batch_bucket`) and
    answered by :func:`suco_query` in the policy's mode, resolved once here
    (:attr:`mode`); padding never changes a row's answer, since every step
    of the query is per row.  ``device`` defaults to the card; pass
    ``"cpu"`` to run the plain versions of the kernels.

    ``capacity`` makes the engine mutable: ``x`` and the index are padded
    to ``capacity`` slots, the empty ones tombstoned and uncounted, and
    :meth:`insert` / :meth:`delete` write into them in place, so no tensor
    changes shape.  A mutable engine owns its copies of ``x``,
    ``cell_ids``, ``cell_counts`` and the tombstone; the caller's tensors
    are never written.
    """

    def __init__(
        self,
        x,
        index: SuCoIndex,
        policy: EnginePolicy | None = None,
        *,
        capacity: int | None = None,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        self.x = torch.as_tensor(x, dtype=torch.float32).to(self.device).contiguous()
        self.index = index.to(self.device)
        self.policy = EnginePolicy() if policy is None else policy
        if self.x.dim() != 2 or self.x.shape[1] != index.spec.d:
            raise ValueError(f"data must be (n, {index.spec.d}), got {tuple(self.x.shape)}")
        n0 = self.x.shape[0]
        if n0 != index.n_points:
            raise ValueError(f"data rows {n0} != index points {index.n_points}")
        if capacity is not None:
            if capacity < n0:
                raise ValueError(f"capacity={capacity} must be >= current n={n0}")
            pad = capacity - n0
            cells, tomb = self.index.cell_ids, self.index.tombstone
            if tomb is None:
                tomb = torch.zeros(n0, dtype=torch.bool, device=self.device)
            self.x = torch.cat([self.x, self.x.new_zeros((pad, self.x.shape[1]))])
            self.index = dataclasses.replace(
                self.index,
                cell_ids=torch.cat([cells, cells.new_zeros((cells.shape[0], pad))], dim=1),
                cell_counts=self.index.cell_counts.clone(),
                tombstone=torch.cat([tomb, tomb.new_ones(pad)]),
            )
        self._capacity = capacity
        self._next_slot = n0
        self._n_live = self.index.n_live
        self._insert_inertia = torch.zeros((), dtype=torch.float32, device=self.device)
        self._inserted = 0
        self._mode = _resolve_mode(self.policy.mode, self.x.shape[0])
        if self.policy.block_n < 1:
            raise ValueError(f"block_n must be >= 1, got {self.policy.block_n}")
        self._batches = 0
        self._queries = 0
        self._padded = 0
        self._syncs = 0
        self._buckets_seen: set[tuple[int, int]] = set()
        self._retired: tuple[torch.Tensor, SuCoIndex] | None = None

    # ---- lifecycle -------------------------------------------------------

    @classmethod
    def build(
        cls,
        x,
        config: SuCoConfig = SuCoConfig(),
        *,
        spec: sub.SubspaceSpec | None = None,
        policy: EnginePolicy | None = None,
        device: torch.device | str = "cuda",
        init_centroids: torch.Tensor | None = None,
    ) -> "SuCoEngine":
        """Build the index (Algorithm 2) on ``device`` and serve it."""
        xt = torch.as_tensor(x, dtype=torch.float32).to(device).contiguous()
        index = build_index(xt, config, spec=spec, init_centroids=init_centroids)
        return cls(xt, index, policy, device=device)

    @classmethod
    def from_artifact(
        cls,
        path,
        x,
        policy: EnginePolicy | None = None,
        *,
        device: torch.device | str = "cuda",
    ) -> "SuCoEngine":
        """Serve an index artifact (:meth:`SuCoIndex.save`) over ``x``."""
        index, _ = load_index_artifact(path, device=device)
        return cls(x, index, policy, device=device)

    def save(
        self,
        path,
        config: SuCoConfig | None = None,
        *,
        extras: Mapping[str, np.ndarray] | None = None,
    ) -> None:
        """Persist this engine's index artifact (:meth:`SuCoIndex.save`)."""
        self.index.save(path, config, extras=extras)

    # ---- live mutation ---------------------------------------------------

    def _require_mutable(self, op: str) -> None:
        if self._capacity is None:
            raise ValueError(
                f"{op} needs a mutable engine: construct it with capacity=<max points> "
                "(pre-allocated slots keep every tensor's shape); this engine is immutable"
            )

    @torch.inference_mode()
    def insert(self, x_new) -> np.ndarray:
        """Insert ``x_new: (b, d)`` (or one ``(d,)`` point) into the next
        free slots and return their ids (slots are never reused before a
        re-index).  Assignment to the existing centroids is
        :func:`assign_points`; ``x``, ``cell_ids``, ``cell_counts`` and the
        tombstone are written in place.  Raises :class:`CapacityError` when
        the batch does not fit in the free slots."""
        self._require_mutable("insert")
        x_new = _points(x_new, self.index.spec.d, self.device)
        b = x_new.shape[0]
        if self._next_slot + b > self._capacity:
            raise CapacityError(
                f"insert of {b} points exceeds capacity {self._capacity} (next free slot "
                f"{self._next_slot}): re-index onto a larger successor engine"
            )
        idx = self.index
        cells, counts_delta, inertia = assign_points(
            x_new, idx.centroids1, idx.centroids2, spec=idx.spec, sqrt_k=idx.sqrt_k,
            block_n=self.policy.block_n,
        )
        lo, hi = self._next_slot, self._next_slot + b
        idx.cell_ids[:, lo:hi] = cells
        idx.cell_counts += counts_delta
        idx.tombstone[lo:hi] = False
        self.x[lo:hi] = x_new
        self._next_slot = hi
        self._n_live += b
        self._insert_inertia += inertia  # on the device: no host sync
        self._inserted += b
        return np.arange(lo, hi)

    @torch.inference_mode()
    def delete(self, ids) -> int:
        """Tombstone the given slot ids in place (idempotent; duplicates
        fine); returns how many were newly dead, whose occupancy leaves
        ``cell_counts``.  Ids outside ``[0, capacity)`` raise."""
        self._require_mutable("delete")
        ids = _checked_ids(ids, self.x.shape[0])
        if ids.size == 0:
            return 0
        idx = self.index
        newly = _tombstone_(idx.tombstone, idx.cell_counts, idx.cell_ids,
                            torch.as_tensor(ids, device=self.device))
        dead = int(newly.sum())
        self._n_live -= dead
        return dead

    def swap(self, successor: "SuCoEngine") -> None:
        """Become ``successor`` (the warm re-index handoff): every serving
        field is rebound in place, so callers holding this engine cut over
        at once.  The successor must already have served or warmed every
        ``(bucket, k)`` pair this engine has seen.  The predecessor's
        tensors stay referenced until :meth:`release_retired`, so the
        handoff itself frees nothing."""
        if successor is self:
            return
        missing = self._buckets_seen - successor._buckets_seen
        if missing:
            raise ValueError(
                "swap target is not warmed over the live traffic mix: missing (bucket, k) "
                f"pairs {sorted(missing)}; run successor.warmup(...) over the seen mix first"
            )
        self._retired = (self.x, self.index)
        self.device = successor.device
        self.x = successor.x
        self.index = successor.index
        self.policy = successor.policy
        self._mode = successor._mode
        self._capacity = successor._capacity
        self._next_slot = successor._next_slot
        self._n_live = successor._n_live
        self._insert_inertia = successor._insert_inertia
        self._inserted = successor._inserted
        self._buckets_seen = self._buckets_seen | successor._buckets_seen

    def release_retired(self) -> None:
        """Drop the predecessor's tensors a :meth:`swap` kept, at a point of
        the caller's choosing off the serving path."""
        self._retired = None

    def _rebind(self, x: torch.Tensor, index: SuCoIndex, *, n_live: int, next_slot: int) -> None:
        """Adopt mutated ``(x, index)`` of the same shapes: the hook for
        sibling engines that share this engine's data."""
        self.x = x
        self.index = index
        self._n_live = n_live
        self._next_slot = next_slot

    # ---- query -----------------------------------------------------------

    @property
    def n_points(self) -> int:
        """Slots, live or not (``capacity`` for a mutable engine)."""
        return self.x.shape[0]

    @property
    def n_live(self) -> int:
        """Live points: neither deleted nor empty slots."""
        return self._n_live

    @property
    def capacity(self) -> int | None:
        """Total slots of a mutable engine (``None``: immutable)."""
        return self._capacity

    @property
    def free_slots(self) -> int:
        """Insert slots left (0 for an immutable engine)."""
        return 0 if self._capacity is None else self._capacity - self._next_slot

    @property
    def insert_inertia_per_point(self) -> float:
        """Mean assignment inertia of every point inserted so far: the drift
        statistic (rising against the build's means the centroids no
        longer describe the incoming data)."""
        return float(self._insert_inertia) / self._inserted if self._inserted else 0.0

    @property
    def mode(self) -> str:
        """The query mode every batch runs: ``"dense"``, ``"streaming"`` or
        ``"fused"`` (the policy's, with ``"auto"`` resolved)."""
        return self._mode

    def tiles_for(self, m: int, k: int) -> TileConfig:
        """The tiling an ``(m, k)`` request runs with: the policy's, or the
        autotune result for its padded bucket."""
        if self.policy.tiles is not None:
            return self.policy.tiles
        n, d = self.x.shape
        return autotune_tiles(
            n, d, batch_bucket(m, self.policy.batch_buckets),
            candidate_pool_size(n, k, self.policy.beta),
            limits=device_limits(self.device), n_subspaces=self.index.spec.n_subspaces,
        )

    def _check_k(self, k: int) -> None:
        # k is bounded by the live points: a larger k would answer empty slots
        if not 1 <= k <= self._n_live:
            raise ValueError(f"k={k} must be in [1, n={self._n_live}]")

    def _padded_query(self, q: torch.Tensor, k: int) -> tuple[QueryResult, int, int]:
        """Answer ``q: (m, d)`` padded to its bucket: the first ``m`` rows'
        result, the bucket and the host synchronisations made.  Counts
        nothing."""
        m = q.shape[0]
        b = batch_bucket(m, self.policy.batch_buckets)
        if b != m:
            q = F.pad(q, (0, 0, 0, b - m))
        p = self.policy
        res, syncs = _query(
            self.x, self.index, q.contiguous(), k=k, alpha=p.alpha, beta=p.beta,
            metric=p.metric, mode=self._mode, block_n=p.block_n,
            tiles=self.tiles_for(m, k) if self._mode == "fused" else None,
            merge_impl=p.merge_impl,
        )
        if b != m:
            res = QueryResult(res.ids[:m], res.dists[:m], res.scores[:m])
        return res, b, syncs

    @torch.inference_mode()
    def query(self, q, k: int) -> QueryResult:
        """Serve a batch ``q: (m, d)`` (or one ``(d,)`` query) -> top-k, on
        the engine's device; the batch size goes into the policy's traffic
        histogram."""
        q = torch.as_tensor(q, dtype=torch.float32).to(self.device)
        single = q.dim() == 1
        if single:
            q = q[None]
        d = self.index.spec.d
        if q.dim() != 2 or q.shape[1] != d:
            raise ValueError(f"queries must be (m, {d}) or ({d},), got {tuple(q.shape)}")
        self._check_k(k)
        m = q.shape[0]
        res, b, syncs = self._padded_query(q, k)
        self._batches += 1
        self._queries += m
        self._padded += b - m
        self._syncs += syncs
        self._buckets_seen.add((b, k))
        self.policy.observe((m,))
        if single:
            return QueryResult(res.ids[0], res.dists[0], res.scores[0])
        return res

    @torch.inference_mode()
    def warmup(
        self, batch_sizes: Sequence[int] | None = (1,), ks: Sequence[int] = (10,)
    ) -> int:
        """Answer one zero batch per (bucket, k) of the traffic mix: builds
        the kernels on first use and touches every path the mix will take,
        without counting as traffic (no batch, query, sync or histogram
        entry).  ``batch_sizes=None`` warms the sizes the policy's traffic
        histogram holds (``(1,)`` when it is empty).  Returns the number of
        (bucket, k) pairs not seen before."""
        if batch_sizes is None:
            batch_sizes = tuple(sorted(self.policy.traffic)) or (1,)
        before = self.compile_count
        d = self.index.spec.d
        for b in sorted({batch_bucket(m, self.policy.batch_buckets) for m in batch_sizes}):
            for k in sorted(set(ks)):
                self._check_k(k)
                self._padded_query(torch.zeros((b, d), device=self.device), k)
                self._buckets_seen.add((b, k))
        if self.device.type == "cuda":
            # this thread's stream only: a re-index prepare on another
            # stream is not waited for
            torch.cuda.current_stream(self.device).synchronize()
        return self.compile_count - before

    @property
    def compile_count(self) -> int:
        """(bucket, k) pairs warmed or served: one for each executable the
        JAX package's engine would have compiled.  After a warm-up that
        covers the traffic mix it stays flat."""
        return len(self._buckets_seen)

    def autoscaled(self, max_buckets: int | None = None) -> "SuCoEngine":
        """A new engine over the same ``(x, index)`` and device whose buckets
        are the autoscale proposal for this engine's observed traffic
        (:meth:`EnginePolicy.autoscaled`); warm it (``warmup(None)`` warms
        the observed sizes) before serving."""
        return SuCoEngine(self.x, self.index, self.policy.autoscaled(max_buckets),
                          device=self.device)

    def host_rows(self, ids) -> np.ndarray:
        """Rows ``ids`` of ``x`` (slots, live or not) as a host array: a
        gather on the device and one copy of just those rows."""
        rows = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
        return self.x[rows].cpu().numpy()

    def stats(self) -> EngineStats:
        return EngineStats(
            executables=self.compile_count,
            batches=self._batches,
            queries=self._queries,
            padded_queries=self._padded,
            buckets=tuple(sorted(self._buckets_seen)),
            host_syncs=self._syncs,
        )


# --------------------------------------------------------------------------
# Static-gate registry hook (see repro_torch.analysis)
# --------------------------------------------------------------------------

#: Shapes of the gate's traces, the JAX package's (``LINT_QUERY_SHAPES``):
#: ``n`` well above ``n_subspaces * block_n``, so the streamed peaks (constant
#: in n) stand clear of the dense (m, n) line.
LINT_QUERY_SHAPES: Mapping[str, int | float] = {
    "n": 60_000,
    "d": 32,
    "m": 32,
    "k": 10,
    "block_n": 2_048,
    "alpha": 0.05,
    "beta": 0.02,
    "n_subspaces": 8,
    "sqrt_k": 16,
}
LINT_BUILD_SHAPES: Mapping[str, int] = {
    "n": 20_000,
    "d": 16,
    "n_subspaces": 4,
    "sqrt_k": 32,
    "block_n": 512,
}


@functools.lru_cache(maxsize=1)
def _lint_problem():
    s = LINT_QUERY_SHAPES
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((s["n"], s["d"])).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((s["m"], s["d"])).astype(np.float32))
    cfg = SuCoConfig(n_subspaces=s["n_subspaces"], sqrt_k=s["sqrt_k"], kmeans_iters=2, seed=0)
    return x, q, build_index(x, cfg)


def lint_query_budget_bytes(block_n: int, m: int | None = None) -> int:
    """``bounded-intermediate`` budget of a streamed query at the gate's
    shapes, the JAX package's formula: the streaming claim O(m (block_n +
    pool)) and the index-scale terms every path carries."""
    s = LINT_QUERY_SHAPES
    n, d, k = s["n"], s["d"], s["k"]
    m = s["m"] if m is None else m
    ns = s["n_subspaces"]
    cells = s["sqrt_k"] ** 2
    pool = max(k, int(s["beta"] * n))
    n_pad = -(-n // block_n) * block_n
    elems = max(
        2 * m * (block_n + pool),  # score block + carried pool (the merge's concat)
        ns * m * block_n,  # a chunk's per-subspace collision gather
        m * pool * d,  # the rerank's candidate gather
        ns * n_pad,  # the index's cell ids
        ns * m * cells,  # the Dynamic-Activation ranks
    )
    return 4 * elems


def lint_dense_peak_bytes() -> int:
    """The dense mode's (m, n) score array, the line the streamed peaks stay
    under."""
    return 4 * LINT_QUERY_SHAPES["m"] * LINT_QUERY_SHAPES["n"]


def _lint_build_budget_bytes() -> int:
    s = LINT_BUILD_SHAPES
    n, d, ns, sqrt_k, bn = s["n"], s["d"], s["n_subspaces"], s["sqrt_k"], s["block_n"]
    h_max = (d // ns + 1) // 2
    n_pad = -(-n // bn) * bn
    codebooks = 2 * ns
    elems = max(
        codebooks * n_pad * h_max,  # the half-subspace views (O(n d))
        n * d,  # the permuted input
        2 * codebooks * bn * max(sqrt_k, h_max),  # a chunk's distances
        ns * sqrt_k * sqrt_k,  # cell_counts
    )
    return 4 * elems


def lint_entries(merge_impl: str = DEFAULT_MERGE_IMPL):
    """Registry hook: the query paths, the engine's per-bucket query and the
    chunked build, with their invariants.  ``merge_impl`` is the chunk
    loops' merge the query entries run (the default's entries; the gate
    also declares ``suco.query_fused_counting``)."""
    from repro_torch.analysis.registry import TraceEntry
    from repro_torch.analysis.trace_rules import trace
    from repro_torch.core.tuning import static_device_limits

    s = LINT_QUERY_SHAPES
    k, alpha, beta = s["k"], s["alpha"], s["beta"]
    scan_rules = ("no-scatter-in-scan", "bounded-intermediate", "pinned-accumulator")
    # tiles pinned to the card's static limits: the gate proves the card's
    # tiling, and the same budgets, on any host
    limits = static_device_limits("h100")

    def _tiles(m: int, beta_: float = beta) -> TileConfig:
        return autotune_tiles(s["n"], s["d"], m, max(k, int(beta_ * s["n"])), limits=limits,
                              n_subspaces=s["n_subspaces"])

    def _degraded_tiles(m: int) -> TileConfig:
        return _tiles(m, EnginePolicy(mode="fused").degraded(1).beta)

    def query(impl: str, **kw):
        def make():
            x, q, index = _lint_problem()
            if kw.get("tombstone"):
                rng = np.random.default_rng(7)
                index = dataclasses.replace(
                    index, tombstone=torch.from_numpy(rng.random(s["n"]) < 0.1))
            mode = kw.get("mode", "fused")
            return trace(suco_query, x, index, q, k=k, alpha=alpha, beta=beta, mode=mode,
                         block_n=s["block_n"], tiles=_tiles(s["m"]) if mode == "fused" else None,
                         merge_impl=impl)
        return make

    def engine(policy_of):
        def make():
            x, q, index = _lint_problem()
            eng = SuCoEngine(x, index, policy_of(), device="cpu")
            # one (bucket 8, k) query: 5 queries padded to their bucket
            return trace(eng._padded_query, q[:batch_bucket(5)], k)
        return make

    def build_chunked():
        b = LINT_BUILD_SHAPES
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.standard_normal((b["n"], b["d"])).astype(np.float32))
        cfg = SuCoConfig(n_subspaces=b["n_subspaces"], sqrt_k=b["sqrt_k"], kmeans_iters=2, seed=0,
                         build_mode="chunked", block_n=b["block_n"])
        return trace(build_index, x, cfg)

    sorted_merge = _resolve_merge_impl(merge_impl, torch.int32, 0) != "counting"
    suppress = ({"no-scatter-in-scan": (
        f"merge_impl={merge_impl!r}: the chunk loops merge by a stable sort, as fast "
        "batches need on the card: fused batches of 1 / 8 / 64 took 12.0 / 19.3 / 31.5 ms "
        "under it and 38.2 / 54.2 / 98.3 ms under the counting merge (H100 80GB HBM3, "
        "700 W; PERF.md section 6); suco.query_fused_counting proves the sort-free route"
    )} if sorted_merge else {})
    b = LINT_BUILD_SHAPES
    fused_budget = lint_query_budget_bytes(_tiles(s["m"]).block_n)
    bucket_budget = lint_query_budget_bytes(_tiles(batch_bucket(5)).block_n)
    entries = [
        TraceEntry(
            name="suco.query_streaming", make=query(merge_impl, mode="streaming"),
            rules=scan_rules, budget_bytes=lint_query_budget_bytes(s["block_n"]),
            suppress=suppress, note="streaming query: a loop over block_n-point chunks",
        ),
        TraceEntry(
            name="suco.query_fused", make=query(merge_impl), rules=scan_rules,
            budget_bytes=fused_budget, suppress=suppress,
            note="single-pass fused query: score / prune / rerank / merge per chunk",
        ),
        TraceEntry(
            name="suco.query_fused_tombstoned", make=query(merge_impl, tombstone=True),
            rules=scan_rules, budget_bytes=fused_budget, suppress=suppress,
            note="fused query over a tombstoned index: the mask folds into the compaction",
        ),
        TraceEntry(
            name="suco.query_dense", make=query(merge_impl, mode="dense"),
            rules=("bounded-intermediate", "pinned-accumulator"),
            budget_bytes=4 * 2 * s["m"] * s["n"] * s["n_subspaces"],
            note=("dense mode: materialises (m, n) and sorts it by design, so "
                  "no-scatter-in-scan is not declared"),
        ),
        TraceEntry(
            name="suco.engine_fused_bucket",
            make=engine(lambda: EnginePolicy(mode="fused", tiles=_tiles(batch_bucket(5)),
                                             merge_impl=merge_impl)),
            rules=scan_rules, budget_bytes=bucket_budget, suppress=suppress,
            note="one SuCoEngine (bucket, k) query, fused mode",
        ),
        TraceEntry(
            name="suco.engine_degraded_bucket",
            make=engine(lambda: dataclasses.replace(
                EnginePolicy(mode="fused", merge_impl=merge_impl).degraded(1),
                tiles=_degraded_tiles(batch_bucket(5)))),
            rules=scan_rules,
            # the full budget bounds the reduced pool too
            budget_bytes=lint_query_budget_bytes(_degraded_tiles(batch_bucket(5)).block_n),
            suppress=suppress,
            note="degradation-ladder level 1: reduced (alpha, beta), the same fused path",
        ),
        TraceEntry(
            name="suco.build_chunked", make=build_chunked, rules=scan_rules,
            budget_bytes=_lint_build_budget_bytes(),
            # small codebook-sized scatters are declared; data-sized ones are not
            scatter_budget_elems=2 * b["n_subspaces"] * b["sqrt_k"] ** 2,
            note="chunked build: each Lloyd step one statistics pass over the data",
        ),
    ]
    if merge_impl == DEFAULT_MERGE_IMPL and sorted_merge:
        entries.append(TraceEntry(
            name="suco.query_fused_counting", make=query("counting"), rules=scan_rules,
            budget_bytes=fused_budget,
            note="the fused query with the counting merge: sort- and scatter-free chunks",
        ))
    return entries
