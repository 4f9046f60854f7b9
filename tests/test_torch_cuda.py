"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, at small shapes; and the fused query on the card
against the same query on the CPU.

Marked ``cuda``: they need an NVIDIA card and skip without one.  On a machine
with the card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.  This
file imports no JAX (that machine has none).  Integer outputs must be equal,
and so must the pairwise distances (kernel and plain version sum in the same
fixed order); the rerank distances agree to ``rtol=2e-5`` and the Lloyd sums
and inertia to ``1e-5 * sum |terms|`` (fp32 sums in another order).  The
query modes on the card equal the fused query there; SC-Linear's SC-scores on
the card equal the CPU's.
"""

import pytest
import torch

from repro_torch import kernels
from repro_torch.core import suco
from repro_torch.core.tuning import TileConfig
from repro_torch.data import gaussian_mixture, make_queries
from repro_torch.kernels.gather_rerank import ops as gather_ops
from repro_torch.kernels.gather_rerank.ref import gather_rerank_block_ref
from repro_torch.kernels.kmeans_assign import ops as kmeans_ops
from repro_torch.kernels.kmeans_assign.ref import kmeans_pair_assign_hist_ref, kmeans_stats_ref
from repro_torch.core import sc_linear, subspace
from repro_torch.kernels.pairwise_l2 import ops as pairwise_ops
from repro_torch.kernels.pairwise_l2.ref import pairwise_sqdist_ref
from repro_torch.kernels.sc_score import ops as score_ops
from repro_torch.kernels.sc_score.ref import (
    sc_score_cells_prefilter_compact_ref,
    sc_score_cells_prefilter_ref,
    sc_score_cells_ref,
    sc_score_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card; the test skips where there is none (decided here, at run
    time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("tomb", [False, True])
@pytest.mark.parametrize("cap", [16, 512])
def test_sc_score_compact_kernel_equals_plain(dev, tomb, cap):
    g = _gen(0)
    ns, m, k_cells, bc = 8, 9, 2500, 3000
    ranks = torch.stack([torch.stack([torch.randperm(k_cells, generator=g) for _ in range(m)])
                         for _ in range(ns)]).int()
    cuts = torch.randint(0, k_cells, (ns, m), generator=g, dtype=torch.int32)
    cells = torch.randint(0, k_cells, (ns, bc + 500), generator=g, dtype=torch.int32)[:, 200:200 + bc]
    thr = torch.randint(-1, ns, (m,), generator=g, dtype=torch.int32)
    keep = (torch.rand(bc, generator=g) > 0.3) if tomb else None
    limit = bc - 77
    want = sc_score_cells_prefilter_compact_ref(ranks, cuts, cells, thr, limit, keep, cap=cap)
    before = kernels.launch_counts()["sc_score_cells_prefilter_compact"]
    got = score_ops.sc_scores_cells_prefilter_compact(
        ranks.to(dev), cuts.to(dev), cells.to(dev), thr.to(dev), limit,
        None if keep is None else keep.to(dev), cap=cap,
    )
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sc_score_cells_prefilter_compact"] == before + 1
    for a, b in zip(got, want):
        assert a.is_cuda and a.dtype == torch.int32
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("d", [128, 30])
def test_gather_rerank_kernel_equals_plain(dev, d):
    g = _gen(1)
    n, m, c = 5000, 7, 300
    x = torch.randn(n, d, generator=g) * 3
    q = torch.randn(m, d, generator=g) * 3
    ids = torch.randint(0, n, (m, c), generator=g, dtype=torch.int32)
    ids[0, 0] = 2**31 - 1  # a sentinel: clipped at the op boundary
    want = gather_rerank_block_ref(ids.clamp(0, n - 1), x, q)
    got = gather_ops.gather_rerank_block(ids.to(dev), x.to(dev), q.to(dev))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=0)


def _blobs(seed, b, n, k, s):
    g = _gen(seed)
    c = torch.randn(b, k, s, generator=g) * 5
    who = torch.randint(0, k, (b, n), generator=g)
    x = torch.gather(c, 1, who[..., None].expand(b, n, s)) + torch.randn(b, n, s, generator=g)
    return x.contiguous(), (c + 0.3 * torch.randn(b, k, s, generator=g)).contiguous()


@pytest.mark.parametrize("s", [8, 13])
def test_kmeans_stats_kernel_equals_plain(dev, s):
    x, c = _blobs(2, 16, 20_000, 50, s)
    a0, sums0, counts0, inertia0 = kmeans_stats_ref(x, c, block_n=4096)
    a, sums, counts, inertia = kmeans_ops.kmeans_stats(
        x.to(dev), c.to(dev), block_n=4096, with_assign=True
    )
    torch.cuda.synchronize()
    assert torch.equal(a.cpu(), a0) and torch.equal(counts.cpu(), counts0)
    onehot = torch.nn.functional.one_hot(a0.long(), 50).double()
    mag = torch.einsum("bnk,bns->bks", onehot, x.double().abs())
    assert ((sums.cpu().double() - sums0.double()).abs() <= 1e-5 * mag).all()
    assert ((inertia.cpu().double() - inertia0.double()).abs() <= 1e-5 * inertia0.double()).all()


def test_kmeans_pair_assign_hist_kernel_equals_plain(dev):
    x, c = _blobs(3, 16, 30_000, 50, 8)
    want = kmeans_pair_assign_hist_ref(x, c, block_n=4096)
    got = kmeans_ops.kmeans_pair_assign_hist(x.to(dev), c.to(dev), block_n=4096)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_mixed_devices_raise(dev):
    x, c = _blobs(4, 4, 100, 3, 2)
    with pytest.raises(ValueError, match="one device"):
        kmeans_ops.kmeans_stats(x.to(dev), c, block_n=64)


def test_fused_query_on_card_equals_cpu(dev):
    x = gaussian_mixture(30_000, 64, 0)
    q = make_queries(x, 8, seed=1)
    xt = torch.from_numpy(x)
    index = suco.build_index(xt.to(dev), suco.SuCoConfig(n_subspaces=8, sqrt_k=16, kmeans_iters=5))
    counts = index.cell_counts.cpu()
    for i in range(8):
        assert torch.equal(counts[i], torch.bincount(index.cell_ids[i].cpu().long(), minlength=256).int())
    kernels.reset_launch_counts()
    kw = dict(k=10, alpha=0.05, beta=0.02, tiles=TileConfig(block_n=4096, survivor_cap=128))
    got = suco.suco_query_fused(xt.to(dev), index, torch.from_numpy(q).to(dev), **kw)
    counts = kernels.launch_counts()
    assert counts["sc_score_cells_prefilter_compact"] == -(-30_000 // 4096)
    assert counts["gather_rerank"] == counts["sc_score_cells_prefilter_compact"]
    want = suco.suco_query_fused(xt, index.to("cpu"), torch.from_numpy(q), **kw)
    torch.testing.assert_close(got.dists.cpu(), want.dists, rtol=2e-5, atol=0)
    same = got.ids.cpu() == want.ids
    assert same.float().mean() >= 0.95
    assert torch.equal(got.scores.cpu()[same], want.scores[same])


def test_engine_padding_never_changes_a_row_on_the_card(dev):
    x = gaussian_mixture(40_000, 32, 3)
    q = torch.from_numpy(make_queries(x, 5, seed=4))
    engine = suco.SuCoEngine.build(
        x, suco.SuCoConfig(n_subspaces=8, sqrt_k=16, kmeans_iters=4), device=dev
    )
    assert engine.warmup(batch_sizes=(3, 5), ks=(10,)) == 2
    padded = engine.query(q[:3], 10)  # bucket 4
    alone = [engine.query(q[i], 10) for i in range(3)]  # bucket 1
    for i, r in enumerate(alone):
        for a, b in zip(r, padded):
            assert torch.equal(a, b[i])
    st = engine.stats()
    assert st.padded_queries == 1 and st.host_syncs >= st.batches


@pytest.mark.parametrize("m,bc", [(1, 5), (9, 3000), (3, 70_000)])
def test_sc_score_cells_and_prefilter_kernels_equal_plain(dev, m, bc):
    """Odd shapes: one query, a chunk narrower than a warp, and a chunk over
    two column blocks; the cells a column slice with row stride > bc."""
    g = _gen(5)
    ns, k_cells = 8, 2500
    ranks = torch.stack([torch.stack([torch.randperm(k_cells, generator=g) for _ in range(m)])
                         for _ in range(ns)]).int()
    cuts = torch.randint(0, k_cells, (ns, m), generator=g, dtype=torch.int32)
    cells = torch.randint(0, k_cells, (ns, bc + 300), generator=g, dtype=torch.int32)[:, 100:100 + bc]
    thr = torch.randint(-1, ns, (m,), generator=g, dtype=torch.int32)
    args = [t.to(dev) for t in (ranks, cuts, cells, thr)]
    counts0 = kernels.launch_counts()
    got = score_ops.sc_scores_cells(*args[:3])
    got_s, got_k = score_ops.sc_scores_cells_prefilter(*args)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["sc_score_cells"] == counts0["sc_score_cells"] + 1
    assert counts["sc_score_cells_prefilter"] == counts0["sc_score_cells_prefilter"] + 1
    want = sc_score_cells_ref(ranks, cuts, cells)
    want_s, want_k = sc_score_cells_prefilter_ref(ranks, cuts, cells, thr)
    assert torch.equal(got.cpu(), want) and torch.equal(got_s.cpu(), want_s)
    assert got_k.dtype == torch.bool and torch.equal(got_k.cpu(), want_k)


@pytest.mark.parametrize("m,n,s", [(1, 1, 3), (33, 1000, 16), (64, 4099, 3), (5, 300, 130)])
def test_pairwise_and_fused_score_kernels_equal_plain_exactly(dev, m, n, s):
    """Both kernels sum in the plain versions' fixed order: the distances are
    the same bits, so the counts against thresholds taken from them are the
    same integers.  The data are strided views, as SC-Linear passes them."""
    g = _gen(6)
    ns = 3
    xw = torch.randn(n, ns * s + 5, generator=g) * 3
    qw = torch.randn(m, ns * s + 5, generator=g) * 3
    xs = xw[:, : ns * s].unflatten(1, (ns, s)).movedim(1, 0)  # (ns, n, s), rows strided
    qs = qw[:, : ns * s].unflatten(1, (ns, s)).movedim(1, 0)
    d0 = pairwise_ops.pairwise_sqdist(qs[0].to(dev), xs[0].to(dev))
    want = pairwise_sqdist_ref(qs[0], xs[0])
    torch.cuda.synchronize()
    assert torch.equal(d0.cpu(), want)
    tau = torch.stack([pairwise_sqdist_ref(qs[i], xs[i]).median(dim=1).values for i in range(ns)])
    xs_d = xw.to(dev)[:, : ns * s].unflatten(1, (ns, s)).movedim(1, 0)
    qs_d = qw.to(dev)[:, : ns * s].unflatten(1, (ns, s)).movedim(1, 0)
    got = score_ops.sc_scores_fused(qs_d, xs_d, tau.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sc_score_ref(qs, xs, tau))


@pytest.fixture(scope="module")
def modes_data():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    x = gaussian_mixture(40_000, 32, 7)
    q = torch.from_numpy(make_queries(x, 8, seed=8))
    idx = suco.build_index(torch.from_numpy(x).cuda(),
                           suco.SuCoConfig(n_subspaces=8, sqrt_k=16, kmeans_iters=4))
    return torch.from_numpy(x), q, idx


def test_dense_and_streaming_on_the_card_equal_fused(dev, modes_data):
    x, q, idx = modes_data
    xd, qd = x.to(dev), q.to(dev)
    kw = dict(k=10, alpha=0.05, beta=0.02)
    fused = suco.suco_query(xd, idx, qd, mode="fused", **kw)
    kernels.reset_launch_counts()
    stream = suco.suco_query(xd, idx, qd, mode="streaming", block_n=4096, **kw)
    assert kernels.launch_counts()["sc_score_cells"] == -(-40_000 // 4096)
    dense = suco.suco_query(xd, idx, qd, mode="dense", **kw)
    for res in (stream, dense):
        for a, b in zip(res, fused):
            assert torch.equal(a, b)
    tomb = torch.zeros(40_000, dtype=torch.bool, device=dev)
    tomb[::7] = True
    tidx = suco.SuCoIndex(idx.centroids1, idx.centroids2, idx.cell_ids, idx.cell_counts,
                          spec=idx.spec, sqrt_k=idx.sqrt_k, tombstone=tomb)
    outs = [suco.suco_query(xd, tidx, qd, mode=mode, **kw) for mode in ("dense", "streaming", "fused")]
    for res in outs[1:]:
        for a, b in zip(res, outs[0]):
            assert torch.equal(a, b)
    assert not (outs[0].ids.long() % 7 == 0).any()


def test_sc_linear_on_the_card_equals_the_cpu(dev, modes_data):
    x, q, _ = modes_data
    spec = subspace.contiguous_spec(32, 4)
    kw = dict(spec=spec, k=10, alpha=0.05, beta=0.02)
    kernels.reset_launch_counts()
    card = sc_linear.sc_linear_query(x.to(dev), q.to(dev), **kw)
    counts = kernels.launch_counts()
    assert counts["pairwise_sqdist"] == 4 and counts["sc_score"] == 1
    cpu = sc_linear.sc_linear_query(x, q, **kw)
    # the same fixed-order distances: the same scores, so the same pool;
    # the rerank distances differ only by the gather kernel's sum order
    torch.testing.assert_close(card.dists.cpu(), cpu.dists, rtol=2e-5, atol=0)
    same = card.ids.cpu() == cpu.ids
    assert same.float().mean() >= 0.95
    assert torch.equal(card.scores.cpu()[same], cpu.scores[same])
    xs = subspace.split_padded(spec, x)
    qs = subspace.split_padded(spec, q)
    count = subspace.collision_count(40_000, 0.05)
    s_card = sc_linear.sc_scores_from_subspaces(xs.to(dev), qs.to(dev), count)
    assert torch.equal(s_card.cpu(), sc_linear.sc_scores_from_subspaces(xs, qs, count))
