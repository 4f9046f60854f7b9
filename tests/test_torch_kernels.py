"""The port's kernel modules on the CPU: each op's plain version against
the JAX package's oracle (``impl="jnp"``) on the same numpy inputs, and the
guards around the wrappers (CPU dispatch, argument checks, the build).

Tolerances: integer outputs (scores, survivors, counts, assignments,
histograms) exactly; the rerank distances ``rtol=2e-5`` (sums of
non-negative fp32 terms in another order, at most d * 2^-24 relative); the
Lloyd sums and inertia within ``1e-5 * sum |terms|`` (coordinate sums can
cancel, so the error is relative to the magnitude summed, not the result).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.gather_rerank.ops import gather_rerank_block as j_gather
from repro.kernels.kmeans_assign.ops import (
    kmeans_assign_stats as j_stats,
    kmeans_pair_assign_hist as j_pair,
)
from repro.kernels.pairwise_l2.ops import pairwise_sqdist as j_pairwise
from repro.kernels.sc_score.ops import sc_scores_cells as j_cells
from repro.kernels.sc_score.ops import sc_scores_cells_prefilter as j_prefilter
from repro.kernels.sc_score.ops import sc_scores_cells_prefilter_compact as j_compact
from repro.kernels.sc_score.ops import sc_scores_fused as j_fused

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.gather_rerank import ops as gather_ops
from repro_torch.kernels.kmeans_assign import ops as kmeans_ops
from repro_torch.kernels.pairwise_l2 import ops as pairwise_ops
from repro_torch.kernels.sc_score import kernel as score_kernel
from repro_torch.kernels.sc_score import ops as score_ops

INT32_MAX = np.iinfo(np.int32).max
T = torch.from_numpy


def _score_inputs(seed, ns=6, m=5, k_cells=300, bc=700):
    rng = np.random.default_rng(seed)
    ranks = np.stack([np.stack([rng.permutation(k_cells) for _ in range(m)])
                      for _ in range(ns)]).astype(np.int32)
    cuts = rng.integers(0, k_cells, size=(ns, m)).astype(np.int32)
    cells = rng.integers(0, k_cells, size=(ns, bc)).astype(np.int32)
    thr = rng.integers(-1, ns, size=(m,)).astype(np.int32)
    keep = rng.random(bc) > 0.3
    return ranks, cuts, cells, thr, keep


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("limit_frac", [1.0, 0.6])
@pytest.mark.parametrize("cap", [8, 64, 1024])
@pytest.mark.parametrize("tomb", [False, True])
def test_sc_score_compact_matches_jax_exactly(seed, limit_frac, cap, tomb):
    ranks, cuts, cells, thr, keep = _score_inputs(seed)
    bc = cells.shape[1]
    limit = int(bc * limit_frac)
    keep_cols = keep if tomb else None
    want = j_compact(
        *map(jnp.asarray, (ranks, cuts, cells, thr)), jnp.asarray(limit),
        None if keep_cols is None else jnp.asarray(keep_cols), cap=cap, impl="jnp",
    )
    got = score_ops.sc_scores_cells_prefilter_compact(
        T(ranks), T(cuts), T(cells), T(thr), limit,
        None if keep_cols is None else T(keep_cols), cap=cap,
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if cap == 8:  # overflow: the true count exceeds the slots
        assert (got[3] > cap).any()


def test_sc_score_compact_takes_a_column_slice_of_the_cell_ids():
    ranks, cuts, cells, thr, _ = _score_inputs(5)
    whole = T(cells)
    sl = whole[:, 100:400]  # rows strided by the full width, as the query passes them
    assert not sl.is_contiguous()
    got = score_ops.sc_scores_cells_prefilter_compact(T(ranks), T(cuts), sl, T(thr), 300, cap=32)
    want = score_ops.sc_scores_cells_prefilter_compact(
        T(ranks), T(cuts), sl.contiguous(), T(thr), 300, cap=32
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("pallas", [False, True])
def test_sc_scores_cells_and_prefilter_match_jax_exactly(seed, pallas):
    """The chunk scores and keep mask against the JAX package's oracle and
    its Pallas kernels (interpret mode), on a column slice of the cells."""
    ranks, cuts, cells, thr, _ = _score_inputs(seed)
    sl = cells[:, 37:560]
    impl = dict(impl="pallas", interpret=True) if pallas else dict(impl="jnp")
    j_args = tuple(map(jnp.asarray, (ranks, cuts, sl)))
    want = np.asarray(j_cells(*j_args, **impl))
    got = score_ops.sc_scores_cells(T(ranks), T(cuts), T(cells)[:, 37:560])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want_s, want_k = j_prefilter(*j_args, jnp.asarray(thr), **impl)
    got_s, got_k = score_ops.sc_scores_cells_prefilter(T(ranks), T(cuts), T(cells)[:, 37:560], T(thr))
    assert got_k.dtype == torch.bool
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    assert torch.equal(got_s, got)


H100_SMS = 132  # the card's SM count and shared memory a block may use
H100_SMEM = 232_448


def _bitmap_bytes(ns, k_cells):
    """One query's bitmap: Ns rows of ceil(K/32) words (``csrc/sc_score.cu``'s
    ``sc_score_smem_bytes`` at q = 1, held to this on the card)."""
    return 4 * ns * -(-k_cells // 32)


@pytest.mark.parametrize("ns,k_cells", [(1, 1), (3, 31), (8, 2500), (16, 2500), (8, 65_536),
                                        (16, 65_536), (8, 200_000), (64, 65_536)])
@pytest.mark.parametrize("m", [1, 2, 7, 8, 64, 65])
def test_sc_score_tiling_fits_shared_memory(ns, k_cells, m):
    """The sweep's Q and tile: Q queries' bitmaps fit in shared memory, Q is
    the widest of the query tiles that fits and is no wider than m rounded up
    to a power of two; the tile is 1 to MAX_TILE columns."""
    one = _bitmap_bytes(ns, k_cells)
    for bc in (1, 5, 4096, 70_000):
        if one > H100_SMEM:
            with pytest.raises(ValueError, match="one query's bitmap"):
                score_kernel.tiling(one, H100_SMEM, H100_SMS, m, bc)
            continue
        q, tile = score_kernel.tiling(one, H100_SMEM, H100_SMS, m, bc)
        assert q in score_kernel.QUERY_TILES and q * one <= H100_SMEM
        assert q == 1 or q < 2 * m
        assert q == 16 or 2 * q * one > H100_SMEM or q >= m
        assert 1 <= tile <= score_kernel.MAX_TILE


def test_sc_score_tiling_refuses_exactly_where_one_bitmap_no_longer_fits():
    assert score_kernel.tiling(H100_SMEM, H100_SMEM, H100_SMS, 64, 4096)[0] == 1
    assert score_kernel.tiling(H100_SMEM // 2, H100_SMEM, H100_SMS, 64, 4096)[0] == 2
    with pytest.raises(ValueError, match="one query's bitmap"):
        score_kernel.tiling(H100_SMEM + 1, H100_SMEM, H100_SMS, 1, 4096)


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("bc", [4096, 1_000_000])
def test_sc_score_tiling_gives_two_blocks_an_sm(m, bc):
    """At the streaming (4,096 columns) and dense (n = 1M) shapes of the
    default index (Ns = 8, K = 2,500), every SM gets two sweep blocks."""
    q, tile = score_kernel.tiling(_bitmap_bytes(8, 2500), H100_SMEM, H100_SMS, m, bc)
    assert q == min(m, 16)
    assert -(-m // q) * -(-bc // tile) >= 2 * H100_SMS


def test_sc_scores_cells_on_the_cpu_take_any_bitmap_width():
    """Only the card refuses a bitmap past its shared memory: the plain
    version scores any K."""
    g = torch.Generator().manual_seed(3)
    ns, m, k_cells = 64, 2, 65_536
    assert _bitmap_bytes(ns, k_cells) > H100_SMEM
    ranks = torch.randint(0, k_cells, (ns, m, k_cells), generator=g, dtype=torch.int32)
    cuts = torch.randint(-1, k_cells + 1, (ns, m), generator=g, dtype=torch.int32)
    cells = torch.randint(0, k_cells, (ns, 9), generator=g, dtype=torch.int32)
    got = score_ops.sc_scores_cells(ranks, cuts, cells)
    want = (torch.gather(ranks, 2, cells.long()[:, None].expand(ns, m, 9))
            <= cuts[:, :, None]).sum(0)
    assert torch.equal(got, want.int())


def test_sc_scores_fused_matches_the_jax_kernel_on_integer_data():
    """Integer coordinates make every distance exact in both arithmetics,
    so the counts must agree exactly, ties at the thresholds included."""
    rng = np.random.default_rng(4)
    ns, m, n, s = 3, 5, 700, 3
    qs = rng.integers(-4, 5, size=(ns, m, s)).astype(np.float32)
    xs = rng.integers(-4, 5, size=(ns, n, s)).astype(np.float32)
    tau = rng.integers(0, 30, size=(ns, m)).astype(np.float32)
    want = np.asarray(j_fused(*map(jnp.asarray, (qs, xs, tau)), interpret=True))
    got = score_ops.sc_scores_fused(T(qs), T(xs), T(tau))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n,d", [(1, 5, 3), (9, 300, 16), (17, 200, 130)])
def test_pairwise_sqdist_matches_the_jax_kernel(m, n, d):
    """Within 1e-5 * (|q|^2 + |x|^2): the JAX kernel sums the cross term on
    the MXU's tiling, the port one dim at a time."""
    rng = np.random.default_rng(d)
    q = (rng.normal(size=(m, d)) * 2).astype(np.float32)
    x = (rng.normal(size=(n, d)) * 2).astype(np.float32)
    want = np.asarray(j_pairwise(jnp.asarray(q), jnp.asarray(x), interpret=True))
    got = pairwise_ops.pairwise_sqdist(T(q), T(x))
    scale = (q**2).sum(1)[:, None] + (x**2).sum(1)[None, :]
    assert got.dtype == torch.float32
    assert (np.abs(got.numpy() - want) <= 1e-5 * scale).all()


@pytest.mark.parametrize("d", [32, 30])
def test_gather_rerank_matches_jax(d):
    rng = np.random.default_rng(d)
    n, m, c = 500, 4, 37
    x = rng.normal(size=(n, d)).astype(np.float32) * 3
    q = rng.normal(size=(m, d)).astype(np.float32) * 3
    cols = rng.integers(0, n, size=(m, c)).astype(np.int32)
    cols[0, :3] = [INT32_MAX, -1, n]  # sentinels are clipped at the op boundary
    want = np.asarray(j_gather(jnp.asarray(cols), jnp.asarray(x), jnp.asarray(q), impl="jnp"))
    got = gather_ops.gather_rerank_block(T(cols), T(x), T(q))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    got64 = gather_ops.gather_rerank_block(T(cols).long(), T(x), T(q))
    np.testing.assert_array_equal(got64.numpy(), got.numpy())


def _separated(seed, b, n, k, s):
    """Points tightly around well-separated centroids: no point lies near a
    Voronoi boundary, so assignments are exact in any fp order."""
    rng = np.random.default_rng(seed)
    c = (rng.permutation(k * 4)[:k, None] * 10.0 + rng.normal(size=(k, s))).astype(np.float32)
    c = np.stack([c[rng.permutation(k)] for _ in range(b)])
    who = rng.integers(0, k, size=(b, n))
    x = np.take_along_axis(c, who[:, :, None], 1) + 0.3 * rng.normal(size=(b, n, s))
    # the centroids the pass runs against: perturbed, so no point sits on one
    c0 = c + 0.2 * rng.normal(size=c.shape)
    return x.astype(np.float32), c0.astype(np.float32)


@pytest.mark.parametrize("block_n", [128, 1000, 4096])
def test_kmeans_pair_assign_hist_matches_jax_exactly(block_n):
    x, c = _separated(0, 8, 3000, 12, 5)
    want_a, want_counts = j_pair(jnp.asarray(x), jnp.asarray(c), impl="jnp")
    got_a, got_counts = kmeans_ops.kmeans_pair_assign_hist(T(x), T(c), block_n=block_n)
    assert got_a.dtype == torch.int32 and got_counts.dtype == torch.int32
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
    with pytest.raises(ValueError, match="even batch"):
        kmeans_ops.kmeans_pair_assign_hist(T(x[:3]), T(c[:3]), block_n=block_n)


def _check_stats(got, want_a, x, c):
    """Exact assignments and counts; returns the sums and inertia with the
    magnitudes their fp errors scale with: sum |x| per (centroid, dim), and
    for the inertia the terms |x|^2 + |c|^2 + 2|x.c| of the oracle's matmul
    identity (bounded by 2(|x|^2 + |c|^2))."""
    a, sums, counts, inertia = (t.numpy() for t in got)
    np.testing.assert_array_equal(a, want_a)
    onehot = a[:, :, None] == np.arange(c.shape[1])[None, None, :]
    np.testing.assert_array_equal(counts, onehot.sum(1).astype(np.float32))
    xf = x.astype(np.float64)
    mag = np.einsum("bnk,bns->bks", onehot, np.abs(xf))
    cn = np.take_along_axis((c.astype(np.float64) ** 2).sum(-1), a.astype(np.int64), 1)
    mag_in = 2 * ((xf**2).sum(-1) + cn).sum(1)
    return sums, inertia, mag, mag_in


@pytest.mark.parametrize("block_n", [256, 1000, 4096])
def test_kmeans_stats_matches_jax(block_n):
    x, c = _separated(1, 6, 2500, 9, 7)
    ja, jsums, jcounts, jin = map(
        np.asarray, j_stats(jnp.asarray(x), jnp.asarray(c), impl="jnp", with_assign=True)
    )
    got = kmeans_ops.kmeans_stats(T(x), T(c), block_n=block_n, with_assign=True)
    sums, inertia, mag, mag_in = _check_stats(got, ja, x, c)
    np.testing.assert_array_equal(got[2].numpy(), jcounts)
    assert np.all(np.abs(sums - jsums) <= 1e-5 * mag)
    assert np.all(np.abs(inertia - jin) <= 1e-5 * mag_in)
    assert kmeans_ops.kmeans_stats(T(x), T(c), block_n=block_n)[0] is None


# ---------------------------------------------------------------------------
# Guards: CPU dispatch, argument checks, the build
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached a CUDA kernel")

    from repro_torch.kernels.gather_rerank import kernel as gk
    from repro_torch.kernels.kmeans_assign import kernel as kk
    from repro_torch.kernels.pairwise_l2 import kernel as pk
    from repro_torch.kernels.sc_score import kernel as sk

    for mod, fn in ((sk, "sc_score_compact"), (gk, "gather_rerank_l2"),
                    (kk, "kmeans_stats"), (kk, "kmeans_pair_assign_hist"),
                    (sk, "sc_score_cells"), (sk, "sc_score_cells_prefilter"),
                    (sk, "sc_score_fused"), (pk, "pairwise_sqdist"),
                    (kk, "kmeans_assign_batched"), (kk, "kmeans_assign")):
        monkeypatch.setattr(mod, fn, no_kernel)
    kernels.reset_launch_counts()
    ranks, cuts, cells, thr, keep = _score_inputs(0)
    score_ops.sc_scores_cells_prefilter_compact(T(ranks), T(cuts), T(cells), T(thr), 10, T(keep), cap=4)
    score_ops.sc_scores_cells(T(ranks), T(cuts), T(cells))
    score_ops.sc_scores_cells_prefilter(T(ranks), T(cuts), T(cells), T(thr))
    qs = torch.zeros((2, 3, 4))
    score_ops.sc_scores_fused(qs, torch.zeros((2, 7, 4)), torch.zeros((2, 3)))
    pairwise_ops.pairwise_sqdist(qs[0], qs[1])
    x, c = _separated(0, 4, 100, 3, 2)
    kmeans_ops.kmeans_stats(T(x), T(c), block_n=64)
    kmeans_ops.kmeans_pair_assign_hist(T(x), T(c), block_n=64)
    kmeans_ops.kmeans_assign_batched(T(x), T(c), block_n=64)
    kmeans_ops.kmeans_assign(T(x[0]), T(c[0]))
    gather_ops.gather_rerank_block(torch.zeros((2, 3), dtype=torch.int32), T(x[0]), T(x[0][:2]))
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def _bad_calls():
    ranks, cuts, cells, thr, keep = (T(a) for a in _score_inputs(0))
    x, c = (T(a) for a in _separated(0, 4, 100, 3, 2))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    score = score_ops.sc_scores_cells_prefilter_compact
    return [
        (TypeError, lambda: score(ranks.long(), cuts, cells, thr, 5, cap=4)),
        (ValueError, lambda: score(ranks.transpose(1, 2), cuts, cells, thr, 5, cap=4)),
        (ValueError, lambda: score(ranks, cuts, cells.t().contiguous().t(), thr, 5, cap=4)),
        (ValueError, lambda: score(ranks, cuts, cells, thr[:-1], 5, cap=4)),
        (TypeError, lambda: score(ranks, cuts, cells, thr, 5, keep.int(), cap=4)),
        (ValueError, lambda: score(ranks, cuts, cells, thr, 5, cap=0)),
        (TypeError, lambda: gather_ops.gather_rerank_block(ids.float(), x[0], x[0][:2])),
        (TypeError, lambda: gather_ops.gather_rerank_block(ids, x[0].double(), x[0][:2])),
        (ValueError, lambda: gather_ops.gather_rerank_block(ids, x[0].t(), x[0][:2])),
        (ValueError, lambda: gather_ops.gather_rerank_block(ids, x[0], x[0][:3])),
        (TypeError, lambda: kmeans_ops.kmeans_stats(x.half(), c.half(), block_n=64)),
        (ValueError, lambda: kmeans_ops.kmeans_stats(x.transpose(0, 1), c, block_n=64)),
        (ValueError, lambda: kmeans_ops.kmeans_stats(x, c[:, :, :1].contiguous(), block_n=64)),
        (ValueError, lambda: kmeans_ops.kmeans_stats(x, c[:2].contiguous(), block_n=64)),
        (ValueError, lambda: kmeans_ops.kmeans_stats(x, c, block_n=0)),
        (ValueError, lambda: kmeans_ops.kmeans_pair_assign_hist(
            torch.zeros((3, 10, 4)), torch.zeros((3, 3, 4)), block_n=64)),
        (ValueError, lambda: kmeans_ops.kmeans_pair_assign_hist(
            torch.zeros((2, 10, 4)), torch.zeros((2, 3, 4)), block_n=0)),
        (TypeError, lambda: score_ops.sc_scores_cells(ranks, cuts.float(), cells)),
        (ValueError, lambda: score_ops.sc_scores_cells(ranks, cuts, cells[:2])),
        (ValueError, lambda: score_ops.sc_scores_cells_prefilter(ranks, cuts, cells, thr[:2])),
        (ValueError, lambda: score_ops.sc_scores_fused(x[:2], x[:2].transpose(1, 2), c[:2, :, 0])),
        (ValueError, lambda: score_ops.sc_scores_fused(x[:2], x[:2], c[:3, :, 0].contiguous())),
        (TypeError, lambda: pairwise_ops.pairwise_sqdist(x[0].half(), x[0])),
        (ValueError, lambda: pairwise_ops.pairwise_sqdist(x[0], x[0, :, :1])),
    ]


@pytest.mark.parametrize("case", range(24))
def test_wrapper_checks_raise_before_dispatch(case, monkeypatch):
    def reached(*a, **k):
        raise AssertionError("a bad argument reached a kernel or its plain version")

    for mod, names in (
        (score_ops, ("sc_score_cells_prefilter_compact_ref", "sc_score_cells_ref",
                     "sc_score_cells_prefilter_ref", "sc_score_ref")),
        (gather_ops, ("gather_rerank_block_ref",)),
        (kmeans_ops, ("kmeans_stats_ref", "kmeans_pair_assign_hist_ref")),
        (pairwise_ops, ("pairwise_sqdist_ref",)),
    ):
        for name in names:
            monkeypatch.setattr(mod, name, reached)
    calls = _bad_calls()
    assert len(calls) == 24
    exc, call = calls[case]
    with pytest.raises(exc):
        call()


def test_tensors_on_neither_cpu_nor_card_raise():
    x = torch.empty((4, 10, 2), device="meta")
    with pytest.raises(ValueError, match="no kmeans_stats route"):
        kmeans_ops.kmeans_stats(x, torch.empty((4, 3, 2), device="meta"), block_n=8)


def test_library_hash_follows_the_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` names a new library for every source, so a
    stale one is never loaded; another source's edit changes nothing.  The
    TF32 helpers live in one header that the assignment and linear-attention
    sources include."""
    for name in ("kmeans_assign", "linear_attn"):
        assert '#include "tf32.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n#include "h.cuh"\nint x;\n')
    (tmp_path / "b.cu").write_text("int y;\n")
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("a")
    (tmp_path / "b.cu").write_text("int y, z;\n")
    assert _build.library_path("a") == first
    (tmp_path / "h.cuh").write_text("#pragma once\n// edited\n")
    second = _build.library_path("a")
    assert second != first
    (tmp_path / "g.cuh").write_text("// a new header\n")
    assert _build.library_path("a") not in (first, second)


def test_build_names_libraries_by_source_hash_and_needs_nvcc(tmp_path, monkeypatch):
    paths = {name: _build.library_path(name) for name in _build.SOURCES}
    assert paths == {name: _build.library_path(name) for name in _build.SOURCES}
    assert len(set(paths.values())) == len(_build.SOURCES)
    for name, p in paths.items():
        assert (_build.CSRC / f"{name}.cu").exists()
        assert p.name.startswith(f"lib{name}-") and p.suffix == ".so"
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("sc_score")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
