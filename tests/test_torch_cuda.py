"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, at small shapes; and the fused query on the card
against the same query on the CPU.

Marked ``cuda``: they need an NVIDIA card and skip without one.  On a machine
with the card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.  This
file imports no JAX (that machine has none).  Integer outputs must be equal;
the rerank distances agree to ``rtol=2e-5`` and the Lloyd sums and inertia to
``1e-5 * sum |terms|`` (fp32 sums in another order).
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
from repro_torch.kernels.sc_score import ops as score_ops
from repro_torch.kernels.sc_score.ref import sc_score_cells_prefilter_compact_ref

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
