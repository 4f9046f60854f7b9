"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, at small shapes; and the fused query on the card
against the same query on the CPU.

Marked ``cuda``: they need an NVIDIA card and skip without one.  On a machine
with the card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.  This
file imports no JAX (that machine has none).  Integer outputs must be equal,
and so must the pairwise distances (kernel and plain version sum in the same
fixed order; NaN where the plain version gives NaN); the rerank distances agree to ``rtol=2e-5`` and the Lloyd sums
and inertia to ``1e-5 * sum |terms|`` (fp32 sums in another order).  The
query modes on the card equal the fused query there; SC-Linear's SC-scores on
the card equal the CPU's.  The K-means library on the card gives the CPU's
assignments on separated data (centroids within ``1e-5``), and a mutable
engine's insert / delete / query sequence on the card gives the CPU's
index exactly and its answers up to fp-distance ties.  The wide variants of
rows 3-5 (s > 64, or a codebook or histogram past shared memory) hold to the
same rules.  The linear-attention kernel (row 11) equals its plain version
at the same chunk, any chunk, within rtol 1e-4 / atol 1e-4 in fp32 and one
bf16 ulp in bf16 (sums in another order), and the reduced RWKV6, granite,
Gemma2, zamba2, olmoe (at 8 and 32 experts), Llama-3.2-Vision (two units,
gates open) and Whisper models on the card give the CPU's logits (zamba2,
olmoe and the cross-attention models also its greedy tokens; olmoe's
prefill twice the same bits).  Row 3 also runs on skewed inputs (one
centroid taking every point, most centroids empty; ``tests/_stats_cases.py``,
which ``tests/test_torch_kmeans.py`` holds to the JAX kernel), where two
launches give equal bits and the screened kernel's best distances equal the
plain minimum.  The sharded engine at world size 1 over NCCL builds the
CPU's index but at Voronoi boundaries and answers as the CPU on one index;
each baseline with a device path gives the CPU's ids but at ties and
boundary cases.
"""

import pytest
import torch

from _stats_cases import KINDS, skewed
from repro_torch import kernels
from repro_torch.core import suco
from repro_torch.core.tuning import TileConfig
from repro_torch.data import gaussian_mixture, make_queries
from repro_torch.kernels.gather_rerank import ops as gather_ops
from repro_torch.kernels.gather_rerank.ref import gather_rerank_block_ref
from repro_torch.kernels.kmeans_assign import ops as kmeans_ops
from repro_torch.kernels.kmeans_assign.ref import (
    kmeans_assign_batched_ref,
    kmeans_assign_ref,
    kmeans_pair_assign_hist_ref,
    kmeans_stats_ref,
)
from repro_torch.core import sc_linear, subspace
from repro_torch.core.distances import sqdist_rowwise
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


@pytest.mark.parametrize("s,k", [(65, 300), (128, 1024), (16, 3000)])
def test_wide_kmeans_kernels_equal_plain(dev, s, k):
    """Rows 3 and 5 past the narrow variants: s > 64, or k*s past shared
    memory (s = 16, k = 3000); ragged chunks (block_n 1000)."""
    x, c = _blobs(20, 2, 6_000, k, s)
    a0, sums0, counts0, inertia0 = kmeans_stats_ref(x, c, block_n=1000)
    a, sums, counts, inertia = kmeans_ops.kmeans_stats(
        x.to(dev), c.to(dev), block_n=1000, with_assign=True
    )
    got5 = kmeans_ops.kmeans_assign_batched(x.to(dev), c.to(dev), block_n=1000)
    torch.cuda.synchronize()
    assert torch.equal(a.cpu(), a0) and torch.equal(counts.cpu(), counts0)
    assert torch.equal(got5.cpu(), a0)
    mag = torch.zeros((2 * k, s), dtype=torch.float64)
    mag.index_add_(0, (a0.long() + torch.arange(2)[:, None] * k).reshape(-1),
                   x.double().abs().reshape(-1, s))
    assert ((sums.cpu().double() - sums0.double()).abs() <= 1e-5 * mag.reshape(2, k, s)).all()
    assert ((inertia.cpu().double() - inertia0.double()).abs() <= 1e-5 * inertia0.double()).all()


def test_wide_stats_kernel_gives_the_narrow_bits(dev):
    """At a shape both variants take, the wide statistics kernel adds the
    same points in the same order as the narrow one: equal bits, also where
    a chunk spans several of the wide kernel's 4,096-point sub-chunks and
    carries its sums from one to the next (block_n 9,000 and 8,192)."""
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel

    x, c = _blobs(21, 4, 20_000, 50, 8)
    for bn in (2048, 9000, 8192):
        narrow = kmeans_kernel.kmeans_stats(x.to(dev), c.to(dev), bn, True, False)
        wide = kmeans_kernel.kmeans_stats(x.to(dev), c.to(dev), bn, True, True)
        torch.cuda.synchronize()
        for g, w in zip(wide, narrow):
            assert torch.equal(g.cpu(), w.cpu())


def _assert_stats_match(got, want, x):
    """A statistics kernel's ``(assign, sums, counts, inertia)`` against the
    plain version's: assignments and counts equal, sums within 1e-5 * sum
    |terms| (fp32 sums in another order), inertia within 1e-5 relative."""
    a, sums, counts, inertia = got
    b, _, s = x.shape
    k = sums.shape[1]
    assert torch.equal(a, want[0]) and torch.equal(counts, want[2])
    mag = torch.zeros((b * k, s), dtype=torch.float64, device=x.device)
    mag.index_add_(0, (a.long() + torch.arange(b, device=x.device)[:, None] * k).reshape(-1),
                   x.abs().double().reshape(-1, s))
    assert ((sums.double() - want[1].double()).abs() <= 1e-5 * mag.reshape(b, k, s)).all()
    assert ((inertia.double() - want[3].double()).abs() <= 1e-5 * want[3].double()).all()


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s,k,n,bn", [
    (1, 50, 3_037, 1_000), (8, 50, 3_037, 1_000), (13, 77, 3_037, 1_000),
    (16, 256, 3_037, 1_000), (65, 300, 3_037, 1_000), (128, 1024, 3_037, 1_000),
    (65, 300, 20_000, 9_000), (128, 1024, 20_000, 9_000)])
@pytest.mark.parametrize("b", [1, 16])
def test_stats_kernel_variants_equal_plain_on_skewed_data(dev, b, s, k, n, bn, kind, integer):
    """Row 3, both variants (the narrow one where it fits), against the plain
    version on the inputs of ``tests/test_torch_kmeans.py``'s skewed cases:
    every point on one centroid (one bucket fills each tile and chunk), most
    centroids empty, points over all; k off every multiple of 32 or 64 (but
    1,024), n off block_n and the 256-point tile.  block_n = 9,000 makes the
    wide kernel carry a chunk's sums over three 4,096-point sub-chunks (the
    last ragged), then run a last chunk of 2,000.  Two launches give equal
    bits, with or without the assignments, and the two variants give the
    same bits.  The plain version runs on the card (the same bits as on the
    CPU for the argmins) to keep the wide cases short."""
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel

    x, c = (torch.from_numpy(a).to(dev) for a in skewed(kind, b, n, k, s, seed=s + k + b,
                                                          integer=integer))
    want = kmeans_stats_ref(x, c, block_n=bn)
    variants = [True] + ([False] if k * s <= 4096 else [])  # the narrow one takes these
    outs = []
    for wide in variants:
        before = kernels.launch_counts()["kmeans_stats"]
        got = kmeans_kernel.kmeans_stats(x, c, bn, True, wide)
        again = kmeans_kernel.kmeans_stats(x, c, bn, False, wide)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["kmeans_stats"] == before + 2
        _assert_stats_match(got, want, x)
        assert again[0] is None
        assert all(torch.equal(g, h) for g, h in zip(got[1:], again[1:]))
        outs.append(got)
    if len(outs) == 2:
        assert all(torch.equal(g, w) for g, w in zip(*outs))
    if kind == "one_takes_all":
        assert ((got[2] > 0).sum(1) == 1).all()


@pytest.mark.parametrize("kind", ["blobs", *KINDS])
@pytest.mark.parametrize("b,n,s,k", [(1, 20_000, 128, 1024), (3, 5_000, 65, 300), (2, 777, 5, 7)])
def test_screened_kernel_gives_the_plain_minimum_distance(dev, kind, b, n, s, k):
    """The screened kernel's d* (row 3's wide variant reads it for the
    inertia) equals the plain version's minimum distance bit for bit, and
    its argmins stay the plain version's."""
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel

    if kind == "blobs":
        x, c = (a.to(dev) for a in _blobs(25, b, n, k, s))
    else:
        x, c = (torch.from_numpy(a).to(dev) for a in skewed(kind, b, n, k, s, seed=26,
                                                              integer=False))
    probe = kmeans_kernel.kmeans_assign_probe(x, c)
    want = kmeans_assign_batched_ref(x, c, block_n=4096)
    d = torch.stack([sqdist_rowwise(x[i], c[i]) for i in range(b)])
    torch.cuda.synchronize()
    assert torch.equal(probe.assign, want)
    assert torch.equal(probe.best, d.gather(2, want.long()[..., None])[..., 0])
    assert torch.equal(kmeans_ops.kmeans_assign_batched(x, c, block_n=4096), want)


@pytest.mark.parametrize("s,k", [(16, 256), (128, 256)])
def test_wide_pair_assign_hist_kernel_equals_plain(dev, s, k):
    """Row 4 at sqrt_k = 256: a 65,536-cell histogram, past shared memory."""
    x, c = _blobs(22, 4, 8_000, k, s)
    want = kmeans_pair_assign_hist_ref(x, c, block_n=3000)
    got = kmeans_ops.kmeans_pair_assign_hist(x.to(dev), c.to(dev), block_n=3000)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


#: row 4's narrow kernel at each instantiation's width (s = 1, 3: MAXS 4;
#: 8; 16; 17, 32: MAXS 32; 64) and k from one centroid to 128
PAIR_SHAPES = [(s, k) for s in (1, 3, 8, 16, 17, 32, 64) for k in (1, 2, 50, 128)]


@pytest.mark.parametrize("s,k", PAIR_SHAPES)
def test_narrow_pair_kernel_equals_plain(dev, s, k):
    """Row 4's FFMA screen (the op's narrow route at these shapes) against
    the plain version: n = 20,011 off every tile and chunk, the plain
    version's chunks an odd block_n (999); two launches give equal bits and
    the histogram counts every point once."""
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel

    assert kmeans_ops._fits(s, kmeans_kernel.pair_smem_bytes(k, s))
    x, c = (a.to(dev) for a in _blobs(40 + s, 6, 20_011, k, s))
    before = kernels.launch_counts()["kmeans_pair_assign_hist"]
    got = kmeans_ops.kmeans_pair_assign_hist(x, c, block_n=999)
    again = kmeans_ops.kmeans_pair_assign_hist(x, c, block_n=999)
    want = kmeans_pair_assign_hist_ref(x, c, block_n=999)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["kmeans_pair_assign_hist"] == before + 2
    assert all(torch.equal(g, w) and torch.equal(a, g) for g, a, w in zip(got, again, want))
    assert int(got[1].sum()) == 3 * 20_011


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("kind", ["duplicates", "mirrored", "integer", "offset", "one", "ragged",
                                  "unaligned"])
def test_pair_kernels_equal_plain_on_adversarial_data(dev, kind, wide):
    """Row 4, both routes forced, on the screened kernels' adversarial cases
    (at most 64 dims and 128 centroids, so the narrow route takes them all)
    in the pair layout (the case, then its rows and centroids reversed, as
    the two halves): exact ties, equidistant pairs, integer data, a large
    common offset (every (point, half) re-checked on the narrow route),
    n = k = s = 1, ragged shapes; two launches give equal bits.  The narrow
    route's probe: the same outputs, every screen value within a quarter of
    its margin, re-checks per (point, half) in [0, 1]."""
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel

    x, c = _screen_case(kind, _gen(42))
    x, c = x[:, :64], c[:128, :64]
    xs, cs = torch.stack([x, x.flip(0)]), torch.stack([c, c.flip(0)])
    want = kmeans_pair_assign_hist_ref(xs, cs, block_n=4096)
    xd, cd = xs.to(dev), cs.to(dev)
    got = kmeans_kernel.kmeans_pair_assign_hist(xd, cd, wide)
    again = kmeans_kernel.kmeans_pair_assign_hist(xd, cd, wide)
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), w) and torch.equal(a, g) for g, a, w in zip(got, again, want))
    if wide:
        return
    probe = kmeans_kernel.kmeans_pair_assign_hist_probe(xd, cd, screen=True)
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(probe[:2], want))
    for h in range(2):
        _screen_within_quarter(probe.screen[h].cpu(), xs[h], cs[h],
                               kmeans_kernel.narrow_margin(x.shape[1]))
    per_point = int(probe.rechecks.sum()) / (2 * x.shape[0])
    assert 0 <= per_point <= 1
    if kind == "offset":
        assert per_point >= 0.9


@pytest.mark.parametrize("s,k", [(8, 50), (16, 128), (3, 7), (64, 50), (1, 2), (17, 50),
                                 (32, 128)])
def test_pair_probe_holds_its_margin(dev, s, k):
    """Row 4's narrow kernel's probe on clustered data: its outputs the
    plain version's and the op's, every screen value within a quarter of its
    margin, and re-checked (point, half)s in [0, 2 Ns n]."""
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel

    x, c = (a.to(dev) for a in _blobs(33, 4, 5_003, k, s))
    probe = kmeans_kernel.kmeans_pair_assign_hist_probe(x, c, screen=True)
    want = kmeans_pair_assign_hist_ref(x, c, block_n=4096)
    op = kmeans_ops.kmeans_pair_assign_hist(x, c, block_n=4096)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) and torch.equal(o, w) for g, o, w in zip(probe[:2], op, want))
    for i in range(4):
        _screen_within_quarter(probe.screen[i], x[i], c[i], kmeans_kernel.narrow_margin(s))
    assert 0 <= int(probe.rechecks.sum()) <= 4 * 5_003


@pytest.mark.parametrize("s,k", [(65, 2), (128, 50), (100, 241), (70, 242)])
def test_wide_pair_routes_equal_plain(dev, s, k):
    """Row 4 past the narrow kernel (s > 64): the screened kernel's argmins
    of all 2 Ns codebooks, then the histogram in device memory, at k^2 up
    to 58,564 cells (k = 242); Ns = 3, ragged n; two launches give equal
    bits."""
    x, c = (a.to(dev) for a in _blobs(34, 6, 5_001, k, s))
    got = kmeans_ops.kmeans_pair_assign_hist(x, c, block_n=2000)
    again = kmeans_ops.kmeans_pair_assign_hist(x, c, block_n=2000)
    want = kmeans_pair_assign_hist_ref(x, c, block_n=2000)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) and torch.equal(a, g) for g, a, w in zip(got, again, want))


def test_kmeans_at_d128_on_the_card_equals_the_cpu(dev):
    """IVF-style Lloyd training at d = 128 (row 3 wide, row 5 wide)."""
    from repro_torch.core import kmeans

    x = torch.from_numpy(gaussian_mixture(8_000, 128, 23))
    c0 = x[torch.randperm(8_000, generator=_gen(24))[:64]]
    kernels.reset_launch_counts()
    card = kmeans.kmeans(x.to(dev), 64, 4, block_n=2048, init_centroids=c0)
    counts = kernels.launch_counts()
    assert counts["kmeans_stats"] == 4 and counts["kmeans_assign_batched"] == 1
    cpu = kmeans.kmeans(x, 64, 4, block_n=2048, init_centroids=c0)
    assert torch.equal(card.assignments.cpu(), cpu.assignments)
    torch.testing.assert_close(card.centroids.cpu(), cpu.centroids, rtol=1e-5, atol=1e-5)


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


# (Ns, K, m, bc, cuts, ranks): Ns 1, 3 and 300 outside the unrolled set
# (4, 8, 16), K from one cell to 65,536 (Q = 2 at Ns = 8, Q = 1
# at Ns = 16), every query tile and its ragged last group (m = 7, 65);
# cuts mixed, all -1 (nothing active) or >= K (all active); ranks aligned
# or one int off 16 bytes
CELL_CASES = [
    (8, 2500, 64, 4096, "mixed", "aligned"),
    (8, 2500, 65, 70_000, "mixed", "aligned"),
    (8, 2500, 1, 1, "mixed", "aligned"),
    (8, 2500, 7, 5, "none", "aligned"),
    (8, 2500, 64, 4096, "all", "offset"),
    (1, 1, 7, 4096, "mixed", "aligned"),
    (1, 31, 65, 5, "mixed", "offset"),
    (3, 31, 64, 70_000, "mixed", "aligned"),
    (3, 2500, 1, 4096, "all", "aligned"),
    (16, 2500, 65, 4096, "mixed", "offset"),
    (16, 31, 1, 70_000, "none", "aligned"),
    (8, 65_536, 7, 4096, "mixed", "aligned"),
    (8, 65_536, 64, 5, "mixed", "offset"),
    (16, 65_536, 65, 1, "mixed", "aligned"),
    (4, 2500, 8, 70_000, "mixed", "aligned"),
    (8, 2500, 1, 4096, "mixed", "aligned"),  # the query modes' batches of 1 and 8
    (8, 2500, 5, 4096, "mixed", "offset"),
    (8, 2500, 6, 70_000, "mixed", "aligned"),
    (8, 2500, 7, 5, "mixed", "aligned"),
    (8, 2500, 8, 4096, "mixed", "aligned"),
    (8, 2500, 8, 70_000, "mixed", "offset"),
    (300, 31, 5, 70, "all", "aligned"),  # more hits than a byte counter holds
]


@pytest.mark.parametrize("ns,k_cells,m,bc,cut_kind,layout", CELL_CASES)
def test_cells_kernels_equal_plain_over_bitmap_widths_and_query_tiles(
        dev, ns, k_cells, m, bc, cut_kind, layout):
    """Rows 7 and 8 against their plain versions on the card: cell ids a
    column slice at an odd offset (rows not 16-byte aligned), ranks
    contiguous but (``offset``) one int past a 16-byte boundary, and two
    launches give equal bits."""
    g = torch.Generator(dev).manual_seed(ns * 7 + m)
    ranks = torch.randint(0, k_cells, (ns * m * k_cells + 1,), generator=g, device=dev,
                          dtype=torch.int32)
    ranks = ranks[1:] if layout == "offset" else ranks[:-1]
    ranks = ranks.view(ns, m, k_cells)
    assert (ranks.data_ptr() % 16 != 0) == (layout == "offset")
    cuts = {"mixed": torch.randint(-1, k_cells + 2, (ns, m), generator=g, device=dev,
                                   dtype=torch.int32),
            "none": torch.full((ns, m), -1, dtype=torch.int32, device=dev),
            "all": torch.full((ns, m), k_cells, dtype=torch.int32, device=dev)}[cut_kind]
    cells = torch.randint(0, k_cells, (ns, bc + 40), generator=g, device=dev,
                          dtype=torch.int32)[:, 13:13 + bc]
    thr = torch.randint(-1, ns + 1, (m,), generator=g, device=dev, dtype=torch.int32)
    counts0 = kernels.launch_counts()
    got = score_ops.sc_scores_cells(ranks, cuts, cells)
    got_s, got_k = score_ops.sc_scores_cells_prefilter(ranks, cuts, cells, thr)
    again = score_ops.sc_scores_cells(ranks, cuts, cells)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["sc_score_cells"] == counts0["sc_score_cells"] + 2
    assert counts["sc_score_cells_prefilter"] == counts0["sc_score_cells_prefilter"] + 1
    want = sc_score_cells_ref(ranks, cuts, cells)
    assert torch.equal(got, want) and torch.equal(again, got)
    assert torch.equal(got_s, want) and torch.equal(got_k, want > thr[:, None])
    if cut_kind != "mixed":
        assert torch.equal(want, torch.full_like(want, 0 if cut_kind == "none" else ns))


def test_cells_tiling_agrees_with_the_source(dev):
    """The source's ``sc_score_smem_bytes`` is Q times one query's bitmap,
    as ``kernel.tiling`` assumes; the Q it picks launches on the shared
    route, and where shared memory held it back, twice that Q is refused by
    the C entry; the L2 route gives the same scores at any Q; where one
    query's bitmap does not fit, the op answers on the card (L2 route) and
    equals the plain version."""
    from repro_torch.kernels.sc_score import kernel as score_kernel

    props = torch.cuda.get_device_properties(dev)
    limit = props.shared_memory_per_block_optin
    for ns, k_cells in [(1, 1), (3, 31), (8, 2500), (16, 2500), (8, 65_536), (16, 65_536)]:
        one = score_kernel.smem_bytes(ns, k_cells, 1)
        assert one == 4 * ns * -(-k_cells // 32)
        for q in score_kernel.QUERY_TILES:
            assert score_kernel.smem_bytes(ns, k_cells, q) == q * one
        m = 64
        q, tile, route = score_kernel.tiling(one, limit, props.multi_processor_count, m, 4096)
        assert route == score_kernel.SHARED
        ranks = torch.zeros((ns, m, k_cells), dtype=torch.int32, device=dev)
        cuts = torch.zeros((ns, m), dtype=torch.int32, device=dev)
        cells = torch.zeros((ns, 4096), dtype=torch.int32, device=dev)
        bitmap = torch.empty((m * ns * -(-k_cells // 32),), dtype=torch.int32, device=dev)
        scores = torch.empty((m, 4096), dtype=torch.int32, device=dev)
        fn = score_kernel._build.entry("sc_score", "sc_score_cells", score_kernel._CELLS_ARGTYPES)

        def launch(q_, l2=0):
            scores.fill_(-7)
            return fn(ranks.data_ptr(), cuts.data_ptr(), cells.data_ptr(), cells.stride(0),
                      ns, m, k_cells, 4096, q_, tile, l2, bitmap.data_ptr(), scores.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)

        assert launch(q) == 0
        torch.cuda.synchronize()
        assert torch.equal(scores, torch.full_like(scores, ns))
        if q < 16:
            assert 2 * q * one > limit and launch(2 * q) != 0
        assert launch(16, l2=1) == 0
        torch.cuda.synchronize()
        assert torch.equal(scores, torch.full_like(scores, ns))
    ranks = torch.zeros((64, 1, 65_536), dtype=torch.int32, device=dev)
    cuts = torch.zeros((64, 1), dtype=torch.int32, device=dev)
    cells = torch.zeros((64, 3), dtype=torch.int32, device=dev)
    assert score_kernel.smem_bytes(64, 65_536, 1) > limit
    got = score_ops.sc_scores_cells(ranks, cuts, cells)
    assert torch.equal(got, sc_score_cells_ref(ranks, cuts, cells))
    assert torch.equal(got, torch.full_like(got, 64))


def _compact_case(dev, seed, ns, k_cells, m, bc, thr_kind, offset=13):
    """Row 1's inputs on the card: ranks and cuts (``warm``: few cells
    active and thresholds of a warm pool, few survivors; ``first``: the
    first chunk's thr = -1, every live column survives; ``mixed``: cuts
    anywhere), and the cell ids a column slice at ``offset``."""
    g = torch.Generator(dev).manual_seed(seed)
    ranks = torch.randint(0, k_cells, (ns, m, k_cells), generator=g, device=dev,
                          dtype=torch.int32)
    hi = k_cells // 8 if thr_kind == "warm" else k_cells + 2
    cuts = torch.randint(-1, max(hi, 1), (ns, m), generator=g, device=dev, dtype=torch.int32)
    cells = torch.randint(0, k_cells, (ns, bc + offset + 40), generator=g, device=dev,
                          dtype=torch.int32)[:, offset:offset + bc]
    if thr_kind == "first":
        thr = torch.full((m,), -1, dtype=torch.int32, device=dev)
    else:
        thr = torch.randint(1 if thr_kind == "warm" else -1, ns // 2 + 1, (m,), generator=g,
                            device=dev, dtype=torch.int32)
    keep = torch.rand(bc, generator=g, device=dev) > 0.1
    return ranks, cuts, cells, thr, keep


# (m, bc, limit, thr, cap): the query tiles Q = 1 ... 16 over the fused
# query's chunks (65,536 columns at m = 1, 27,136 at m = 64); limit < bc; a
# last tile shorter than the tile; chunks narrower than a block (5 columns,
# 1 column); the first chunk (thr = -1: count >> cap, slots full); cap above
# the count (empty slots 0 / -1)
COMPACT_CASES = [
    (1, 65_536, 65_536, "warm", 1024),
    (5, 27_136, 27_136, "warm", 4352),
    (8, 27_136, 27_000, "warm", 4352),
    (16, 27_137, 27_137, "warm", 512),
    (64, 27_136, 27_136, "warm", 4352),
    (64, 27_136, 27_136, "first", 4352),
    (8, 65_536, 60_000, "first", 1024),
    (16, 5, 3, "first", 16),
    (64, 1, 1, "mixed", 64),
    (8, 4096, 4096, "mixed", 4096),
    (1, 4096, 4096, "first", 8192),
]


@pytest.mark.parametrize("tomb", [False, True])
@pytest.mark.parametrize("m,bc,limit,thr_kind,cap", COMPACT_CASES)
def test_compact_kernel_equals_plain_over_query_tiles(dev, m, bc, limit, thr_kind, cap, tomb):
    """Row 1 (bitmap pass, sweep with tile counts, compaction across tiles)
    bit for bit against its plain version, once a launch, and two launches
    give equal bits."""
    ns, k_cells = 8, 2500
    ranks, cuts, cells, thr, keep = _compact_case(dev, m * 31 + bc, ns, k_cells, m, bc, thr_kind)
    kc = keep if tomb else None
    before = kernels.launch_counts()["sc_score_cells_prefilter_compact"]
    got = score_ops.sc_scores_cells_prefilter_compact(ranks, cuts, cells, thr, limit, kc, cap=cap)
    again = score_ops.sc_scores_cells_prefilter_compact(ranks, cuts, cells, thr, limit, kc, cap=cap)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sc_score_cells_prefilter_compact"] == before + 2
    want = sc_score_cells_prefilter_compact_ref(ranks, cuts, cells, thr, limit, kc, cap=cap)
    for a, b, c in zip(got, want, again):
        assert a.dtype == torch.int32
        assert torch.equal(a, b) and torch.equal(a, c)
    count = got[3]
    if thr_kind == "first":
        live = limit if kc is None else int(kc[:limit].sum())
        assert torch.equal(count, torch.full_like(count, live))
    if cap > int(count.max()):  # empty slots hold column 0 and score -1
        empty = torch.arange(cap, device=dev)[None, :] >= count[:, None]
        assert (got[1][empty] == 0).all() and (got[2][empty] == -1).all()


# the smallest index widths whose query bitmap is past a block's shared
# memory: Ns = 16 at sqrt_k = 341, Ns = 8 at sqrt_k = 483
@pytest.mark.parametrize("ns,sqrt_k", [(16, 341), (8, 483)])
@pytest.mark.parametrize("m", [1, 8])
def test_l2_route_rows_1_7_8_equal_plain(dev, ns, sqrt_k, m):
    """Where one query's bitmap does not fit in shared memory, rows 1, 7 and
    8 sweep from the bitmap in L2 and equal their plain versions."""
    from repro_torch.kernels.sc_score import kernel as score_kernel

    k_cells, bc = sqrt_k**2, 4096
    assert score_kernel._plan(dev.index, ns, m, k_cells, bc).l2
    ranks, cuts, cells, thr, keep = _compact_case(dev, ns + m, ns, k_cells, m, bc, "mixed")
    assert torch.equal(score_ops.sc_scores_cells(ranks, cuts, cells),
                       sc_score_cells_ref(ranks, cuts, cells))
    got_s, got_k = score_ops.sc_scores_cells_prefilter(ranks, cuts, cells, thr)
    want_s, want_k = sc_score_cells_prefilter_ref(ranks, cuts, cells, thr)
    assert torch.equal(got_s, want_s) and torch.equal(got_k, want_k)
    for kc in (keep, None):
        got = score_ops.sc_scores_cells_prefilter_compact(ranks, cuts, cells, thr, bc - 9, kc,
                                                          cap=512)
        want = sc_score_cells_prefilter_compact_ref(ranks, cuts, cells, thr, bc - 9, kc, cap=512)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _same_bits(got, want):
    """Equal bits, a NaN anywhere matching a NaN (of any payload: the card's
    arithmetic gives the canonical NaN, the CPU's another)."""
    got, want = got.cpu(), want.cpu()
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.masked_fill(nan, 0).view(torch.int32),
                       want.masked_fill(nan, 0).view(torch.int32))


def _pairwise_views(dev, g, m, n, s, vec, data="normal"):
    """Row 10's operands on the card as views of wider rows: ``vec`` 4 starts
    them on a 16-byte boundary with a row stride of whole 16-byte words (the
    kernel's 16-byte copies), 1 one float off (4-byte copies).  ``data``:
    ``normal`` or ``nan_inf`` (NaN and +-inf coordinates in points and
    queries, and a point of zeros: NaN from a NaN coordinate, inf - inf and
    0 * inf; +inf from an inf point against a finite query)."""
    from repro_torch.kernels.pairwise_l2 import kernel as pairwise_kernel

    x = torch.randn(n, s, generator=g) * 3
    q = torch.randn(m, s, generator=g) * 3
    if data == "nan_inf":
        x[n // 2, s - 1], x[n - 1, 0], x[0] = float("nan"), float("-inf"), 0.0
        q[0, s // 2], q[m - 1, s - 1] = float("-inf"), float("nan")
        if m > 2:
            q[1, 0], q[2, 0] = float("inf"), 1.0
    width = -(-s // 4) * 4 + 4
    off = 4 if vec == 4 else 1
    xw, qw = torch.zeros(n, width), torch.zeros(m, width)
    xw[:, off:off + s], qw[:, off:off + s] = x, q
    xv, qv = xw.to(dev)[:, off:off + s], qw.to(dev)[:, off:off + s]
    assert pairwise_kernel.vec(xv) == vec
    return qv, xv


@pytest.mark.parametrize("vec", [4, 1])
@pytest.mark.parametrize("s", [1, 3, 12, 16, 20, 120, 130])
@pytest.mark.parametrize("n", [1, 300, 4_099, 20_000])
@pytest.mark.parametrize("m", [1, 8, 33, 64, 65, 200])
def test_pairwise_kernel_equals_plain_bit_for_bit(dev, m, n, s, vec):
    """Row 10 equals ``pairwise_sqdist_ref`` (run on the card, the same
    elementwise fp32 operations) bit for bit on both copy widths, through
    one and several query groups, ragged point tiles and one or several
    16-dim slabs; two launches give equal bits, and one launch a call."""
    g = _gen(m * 100_003 + n * 131 + s * 7 + vec)
    q, x = _pairwise_views(dev, g, m, n, s, vec)
    before = kernels.launch_counts()["pairwise_sqdist"]
    got = pairwise_ops.pairwise_sqdist(q, x)
    again = pairwise_ops.pairwise_sqdist(q, x)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pairwise_sqdist"] == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _same_bits(got, pairwise_sqdist_ref(q, x))


@pytest.mark.parametrize("vec", [4, 1])
@pytest.mark.parametrize("m,n,s", [(1, 8, 3), (8, 300, 16), (64, 4_099, 16), (65, 700, 20),
                                   (33, 300, 130)])
def test_pairwise_kernel_keeps_nan_and_inf_as_plain(dev, m, n, s, vec):
    """NaN and +-inf coordinates in q and x: the card gives NaN exactly where
    the plain version does, on the card and on the CPU (inf - inf, 0 * inf,
    a NaN coordinate), and their other bits (inf included)."""
    g = _gen(m + n + s)
    q, x = _pairwise_views(dev, g, m, n, s, vec, "nan_inf")
    got = pairwise_ops.pairwise_sqdist(q, x)
    torch.cuda.synchronize()
    want = pairwise_sqdist_ref(q.cpu(), x.cpu())
    assert want.isnan().any() and (want.isinf().any() or m <= 2)
    _same_bits(got, want)
    _same_bits(got, pairwise_sqdist_ref(q, x))
    assert torch.equal(got.view(torch.int32), pairwise_ops.pairwise_sqdist(q, x).view(torch.int32))


@pytest.mark.parametrize("ns,m,n,s", [(8, 16, 2_000, 16), (8, 64, 3_000, 16), (4, 8, 700, 20)])
def test_pairwise_kernel_keeps_nan_on_the_fused_views(dev, ns, m, n, s):
    """On ``_fused_views``' ``nan_inf`` data (NaN and inf coordinates in
    points and queries), every subspace's distances equal the plain
    version's, NaN where it is NaN."""
    g = _gen(ns * 1000 + m + n + 1)
    qs, xs = _fused_views(dev, g, ns, m, n, s, 4, "nan_inf")
    for i in range(ns):
        got = pairwise_ops.pairwise_sqdist(qs[i], xs[i])
        _same_bits(got, pairwise_sqdist_ref(qs[i].cpu(), xs[i].cpu()))


@pytest.mark.parametrize("m,n,s", [(1, 1, 3), (33, 1000, 16), (64, 4099, 3), (5, 300, 130),
                                   (8, 20_000, 16), (65, 4_099, 12), (200, 300, 20),
                                   (64, 20_000, 120), (1, 4_099, 1)])
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
    again = score_ops.sc_scores_fused(qs_d, xs_d, tau.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sc_score_ref(qs, xs, tau))
    assert torch.equal(again, got)


def _fused_views(dev, g, ns, m, n, s, vec, data="normal"):
    """Row 9's operands on the card as SC-Linear passes them: the subspace
    views of ``(n, Ns*s)`` data and ``(m, Ns*s)`` queries (strided rows, no
    copy).  ``vec`` 4: 16-byte aligned views with strides in whole 16-byte
    words (the op's 16-byte copies); 1: views one float off (4-byte
    copies).  ``data``: ``normal``; ``offset`` (1e3 + N(0, 1): a common
    offset that dwarfs the spread); ``duplicates`` (points repeated, and
    each query one of the points); ``nan_inf`` (a NaN and an inf
    coordinate in points and in queries)."""
    d = ns * s
    x = torch.randn(n, d, generator=g) * 3
    q = torch.randn(m, d, generator=g) * 3
    if data == "offset":
        x, q = 1e3 + x / 3, 1e3 + q / 3
    elif data == "duplicates":
        x[n // 2:] = x[: n - n // 2]
        q = x[torch.randint(0, n, (m,), generator=g)].clone()
    elif data == "nan_inf":
        x[3, 1], x[7, d - 1], q[0, 2] = float("nan"), float("inf"), float("-inf")
        q[m - 1, d // 2] = float("nan")
    pad = 4 if vec == 4 else 1
    xw = torch.zeros(n, d + pad)
    qw = torch.zeros(m, d + pad)
    xw[:, pad:], qw[:, pad:] = x, q
    xw, qw = xw.to(dev), qw.to(dev)
    return (qw[:, pad:].unflatten(1, (ns, s)).movedim(1, 0),
            xw[:, pad:].unflatten(1, (ns, s)).movedim(1, 0))


def _fused_tau(qs, xs, kind, g):
    """Thresholds ``(Ns, m)``: ``rank`` the 5%-th smallest of row 10's
    distances (SC-Linear's rule: every (query, subspace) has a pair exactly
    at it), or ``zero``, ``negative``, ``inf``, ``mixed`` (all four kinds
    and NaN)."""
    from repro_torch.core.collision import kth_smallest

    ns, m, n = qs.shape[0], qs.shape[1], xs.shape[1]
    if kind == "rank":
        count = max(1, n // 20)
        return torch.stack([kth_smallest(pairwise_ops.pairwise_sqdist(qs[i], xs[i]), count)
                            for i in range(ns)])
    if kind == "mixed":
        pick = torch.randint(0, 5, (ns, m), generator=g)
        vals = torch.tensor([0.0, -1.0, float("inf"), float("nan"), 40.0])
        return vals[pick].to(qs.device)
    val = {"zero": 0.0, "negative": -3.0, "inf": float("inf")}[kind]
    return torch.full((ns, m), val, device=qs.device)


# (Ns, m, n, s, vec, tau, data): SC-Linear's shape (Ns = 8, s = 16) at m = 1,
# 8 and 64 on both copy widths; several query groups; a ragged tile; Ns 4
# and 16; the thresholds 0, negative, +inf and mixed with NaN; duplicates
# (d = 0 under the clamp); a common offset (every pair re-checked); NaN and
# inf coordinates; 16-byte copies of a partial 16-dim step (s = 12, Deep1M's
# d = 96 at Ns = 8; s = 20) and re-checks read from device memory where a
# subspace takes several steps (s = 20; s = 120, GIST1M's d = 960 at Ns = 8),
# offset data re-checking every pair there
FUSED_CASES = [
    (8, 1, 20_000, 16, 4, "rank", "normal"),
    (8, 8, 20_000, 16, 4, "rank", "normal"),
    (8, 64, 20_000, 16, 4, "rank", "normal"),
    (8, 1, 20_000, 16, 1, "rank", "normal"),
    (8, 8, 20_000, 16, 1, "rank", "normal"),
    (8, 64, 20_000, 16, 1, "rank", "normal"),
    (8, 65, 3_000, 16, 4, "rank", "normal"),
    (8, 200, 3_000, 16, 4, "rank", "normal"),
    (8, 64, 4_099, 16, 4, "rank", "normal"),
    (4, 64, 5_000, 16, 4, "rank", "normal"),
    (16, 64, 5_000, 16, 4, "rank", "normal"),
    (8, 33, 3_000, 16, 4, "zero", "normal"),
    (8, 33, 3_000, 16, 4, "negative", "normal"),
    (8, 33, 3_000, 16, 4, "inf", "normal"),
    (8, 33, 3_000, 16, 1, "mixed", "normal"),
    (8, 64, 3_000, 16, 4, "rank", "duplicates"),
    (8, 64, 3_000, 16, 4, "zero", "duplicates"),
    (8, 16, 2_000, 16, 4, "rank", "offset"),
    (8, 16, 2_000, 16, 4, "rank", "nan_inf"),
    (8, 16, 2_000, 16, 4, "inf", "nan_inf"),
    (8, 64, 3_000, 12, 4, "rank", "normal"),
    (8, 64, 3_000, 20, 4, "rank", "normal"),
    (8, 64, 3_000, 120, 4, "rank", "normal"),
    (8, 16, 2_000, 20, 4, "rank", "offset"),
]


@pytest.mark.parametrize("ns,m,n,s,vec,tau_kind,data", FUSED_CASES)
def test_fused_score_kernel_equals_plain_bit_for_bit(dev, ns, m, n, s, vec, tau_kind, data):
    """Row 9 (the 3xTF32 screen with its exact re-check) equals
    ``sc_score_ref`` bit for bit, and, with thresholds taken from row 10's
    distances, the collisions of those distances; two launches give equal
    bits; the probe instantiation gives the same counts, re-checks at least
    the pair at each (query, subspace)'s threshold (every pair of offset
    data), and its screen distances stay within a quarter of the margin."""
    from repro_torch.kernels.pairwise_l2.ref import _sq_norms
    from repro_torch.kernels.sc_score import kernel as score_kernel

    g = _gen(ns * 1000 + m + n)
    qs, xs = _fused_views(dev, g, ns, m, n, s, vec, data)
    assert score_kernel.fused_vec(qs, xs) == vec
    tau = _fused_tau(qs, xs, tau_kind, g)
    before = kernels.launch_counts()["sc_score"]
    got = score_ops.sc_scores_fused(qs, xs, tau)
    again = score_ops.sc_scores_fused(qs, xs, tau)
    probe = score_kernel.sc_score_fused_probe(qs, xs, tau)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sc_score"] == before + 2
    want = sc_score_ref(qs.cpu(), xs.cpu(), tau.cpu())
    assert torch.equal(got.cpu(), want)
    assert torch.equal(again, got) and torch.equal(probe.scores, got)
    rechecks = int(probe.rechecks.sum())
    assert probe.rechecks.numel() == score_kernel.fused_blocks(m, n)
    if data == "offset":
        assert rechecks == ns * m * n
    if tau_kind == "rank":  # NaN distances included: row 10 keeps them NaN, as row 9 does
        collisions = sum(pairwise_ops.pairwise_sqdist(qs[i], xs[i]) <= tau[i][:, None]
                         for i in range(ns))
        assert torch.equal(got, collisions)
    if tau_kind == "rank" and data != "nan_inf":
        assert rechecks >= ns * m
        mu, eta = score_kernel.fused_screen_margin(s), score_kernel.fused_screen_floor(s)
        for i in range(ns):
            t = (_sq_norms(qs[i])[:, None] + _sq_norms(xs[i])[None, :]).double()
            err = (probe.screen[i].double()
                   - pairwise_ops.pairwise_sqdist(qs[i], xs[i]).double()).abs()
            assert float((err / (mu * t + eta)).max()) <= 0.25


def test_fused_score_kernel_counts_past_65535_subspaces(dev):
    """The kernel counts in 16 bits and its C entry launches once per 65,535
    subspaces, each later launch adding to the counts: at Ns = 65,537 a
    query whose threshold is +inf everywhere counts 65,537 for every point,
    and the other query's counts equal the plain version's."""
    g = _gen(78)
    ns, m, n, s = 65_537, 2, 40, 1
    qs = torch.randn(ns, m, s, generator=g)
    xs = torch.randn(ns, n, s, generator=g)
    tau = torch.full((ns, m), float("inf"))
    tau[:, 1] = torch.rand(ns, generator=g) * 2
    got = score_ops.sc_scores_fused(qs.to(dev), xs.to(dev), tau.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sc_score_ref(qs, xs, tau))
    assert (got[0] == ns).all()


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


#: the largest k whose split codebook a narrow block holds at s = 64
NARROW_K_MAX_64 = "k_max"
NARROW_SHAPES = [(s, k) for s in (1, 3, 8, 13, 16, 17, 32, 64) for k in (1, 7, 50, 256)]


def _narrow_k_max(s):
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel

    k = 8
    while kmeans_kernel.narrow_smem_bytes(k + 8, s) <= kmeans_ops._SMEM_LIMIT:
        k += 8
    return k


@pytest.mark.parametrize("s,k", [*NARROW_SHAPES, (64, NARROW_K_MAX_64), (128, 1024),
                                 (130, 300)])
def test_kmeans_assign_batched_kernel_equals_plain(dev, s, k):
    """The narrow kernel at s = 1..64 (s off every multiple of 4 and 8,
    k < 8, ragged n, the largest k that fits at s = 64), and the wide shapes
    (s > 64) that take the screened kernel; two launches give equal bits.
    Where the op takes the screen at s <= 64 (past 32 dims, a codebook past
    half an SM's shared memory) the narrow kernel is held too, forced.
    The plain version runs on the card (the same bits as on the CPU:
    separate elementwise ops, no contraction) to keep the wide cases
    short."""
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel

    if k == NARROW_K_MAX_64:
        k = _narrow_k_max(s)
        assert kmeans_kernel.narrow_smem_bytes(k, s) <= kmeans_ops._SMEM_LIMIT < \
            kmeans_kernel.narrow_smem_bytes(k + 1, s)
    x, c = (a.to(dev) for a in _blobs(8, 8, 20_011, k, s))
    before = kernels.launch_counts()["kmeans_assign_batched"]
    got = kmeans_ops.kmeans_assign_batched(x, c, block_n=4096)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["kmeans_assign_batched"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, kmeans_assign_batched_ref(x, c, block_n=4096))
    assert torch.equal(kmeans_ops.kmeans_assign_batched(x, c, block_n=4096), got)
    if s <= kmeans_ops.MAX_DIM:
        assert torch.equal(kmeans_kernel.kmeans_assign_batched(x, c, False), got)


def _screen_within_quarter(t, x, c, mu):
    """The narrow screen distance ``|x|^2 - 2 t`` (fp64) within a quarter of
    its margin of the plain distance, for ``t (n, k)``, ``x (n, s)``,
    ``c (k, s)``; returns the largest error over the margin."""
    d = sqdist_rowwise(x, c).double()
    nx = (x.double() ** 2).sum(1)
    big = nx + (c.double() ** 2).sum(1).max()
    ratio = ((nx[:, None] - 2 * t.double() - d).abs() / (mu * big)[:, None]).max()
    assert ratio <= 0.25, float(ratio)
    return float(ratio)


@pytest.mark.parametrize("s,k", [(16, 256), (8, 50), (3, 7), (64, 256), (17, 1)])
def test_narrow_assign_probe_holds_its_margin(dev, s, k):
    """The narrow kernel's probe: its argmins the plain version's, each
    point's best distance the plain minimum bit for bit, every screen value
    within a quarter of its margin, and re-checks per point in [0, k]."""
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel

    x, c = (a.to(dev) for a in _blobs(31, 3, 5_003, k, s))
    probe = kmeans_kernel.kmeans_assign_narrow_probe(x, c, screen=True)
    want = kmeans_assign_batched_ref(x, c, block_n=4096)
    torch.cuda.synchronize()
    assert torch.equal(probe.assign, want)
    for i in range(3):
        d = sqdist_rowwise(x[i], c[i])
        assert torch.equal(probe.best[i], d.gather(1, want[i].long()[:, None])[:, 0])
        _screen_within_quarter(probe.screen[i], x[i], c[i], kmeans_kernel.narrow_margin(s))
    assert 0 <= int(probe.rechecks.sum()) <= k * 3 * 5_003


def _screen_case(kind, g):
    """``(x (n, s), c (k, s))`` on the CPU for the adversarial checks of the
    screened kernel (rows 6 and 5-wide)."""
    if kind == "duplicates":  # exact ties: the lowest index must win
        c = torch.randn(50, 40, generator=g) * 3
        c[25:] = c[:25]
        c[7] = c[3]
        x = c[torch.randint(0, 50, (3000,), generator=g)] + 0.5 * torch.randn(3000, 40, generator=g)
    elif kind == "mirrored":  # integer points equidistant from c = x +- v
        x = torch.randint(-20, 21, (2000, 36), generator=g).float()
        v = torch.randint(-5, 6, (2000, 36), generator=g).float()
        c = torch.stack([x[:64] + v[:64], x[:64] - v[:64]], 1).reshape(128, 36)
    elif kind == "integer":
        x = torch.randint(-30, 31, (4000, 100), generator=g).float()
        c = torch.randint(-30, 31, (333, 100), generator=g).float()
    elif kind == "offset":  # |x|^2 >> the distances: every pair within the margin
        x = 1e3 + torch.randn(1000, 128, generator=g)
        c = 1e3 + torch.randn(200, 128, generator=g)
    elif kind == "one":
        x, c = torch.randn(1, 1, generator=g), torch.randn(1, 1, generator=g)
    elif kind == "ragged":  # n, k, s off every tile; s % 4 != 0 takes 4-byte copies
        x, c = torch.randn(1001, 37, generator=g) * 4, torch.randn(77, 37, generator=g) * 4
    else:  # "unaligned": s % 4 == 0 but rows 4 bytes off a 16-byte boundary
        x = torch.randn(777 * 64 + 1, generator=g)[1:].view(777, 64)
        c = torch.randn(70 * 64 + 1, generator=g)[1:].view(70, 64)
    return x, c


@pytest.mark.parametrize("kind", ["duplicates", "mirrored", "integer", "offset", "one", "ragged",
                                  "unaligned"])
def test_screened_assign_kernel_equals_plain_on_adversarial_data(dev, kind):
    """Rows 6 and 5-wide bit-equal to the plain version on ties, equidistant
    pairs, integer data, a large common offset (which must re-check nearly
    every pair), n = k = s = 1 and ragged / unaligned shapes; the screen's
    largest error within a quarter of its margin."""
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel

    x, c = _screen_case(kind, _gen(40))
    want = kmeans_assign_ref(x, c)
    xd, cd = x.to(dev), c.to(dev)
    assert torch.equal(kmeans_ops.kmeans_assign(xd, cd).cpu(), want)
    got, rechecks, screen, best = kmeans_kernel.kmeans_assign_probe(xd[None], cd[None],
                                                                     screen=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want)
    n, k = x.shape[0], c.shape[0]
    d = sqdist_rowwise(x, c).double()
    big = (x.double() ** 2).sum(1) + (c.double() ** 2).sum(1).max()
    delta = kmeans_kernel.screen_margin(x.shape[1]) * big
    assert ((screen[0].cpu().double() - d).abs() <= delta[:, None] / 4).all()
    assert torch.equal(best[0].cpu(), d.float().gather(1, want.long()[:, None])[:, 0])
    per_point = int(rechecks.sum()) / n
    assert 1 <= per_point <= k
    if kind == "offset":
        assert per_point >= 0.9 * k


@pytest.mark.parametrize("kind", ["duplicates", "mirrored", "integer", "offset", "one", "ragged",
                                  "unaligned"])
def test_narrow_assign_kernel_equals_plain_on_adversarial_data(dev, kind):
    """Row 5's narrow kernel (the ``(1, n, s)`` batch, the cases' first 64
    dims at most) bit-equal to the plain version on the screened kernel's
    adversarial cases: ties, equidistant pairs, integer data, a large common
    offset (every point re-checks every centroid: right and slow), n = k =
    s = 1, ragged and unaligned shapes; two launches give equal bits, the
    screen's largest error within a quarter of its margin."""
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel

    x, c = _screen_case(kind, _gen(41))
    x, c = x[:, :64], c[:, :64]  # views: "unaligned" stays off a 16-byte boundary
    want = kmeans_assign_ref(x, c)
    xd, cd = x.to(dev)[None], c.to(dev)[None]
    got = kmeans_ops.kmeans_assign_batched(xd, cd, block_n=4096)
    assert torch.equal(got[0].cpu(), want)
    assert torch.equal(kmeans_ops.kmeans_assign_batched(xd, cd, block_n=4096), got)
    probe = kmeans_kernel.kmeans_assign_narrow_probe(xd, cd, screen=True)
    torch.cuda.synchronize()
    assert torch.equal(probe.assign[0].cpu(), want)
    _screen_within_quarter(probe.screen[0].cpu(), x, c, kmeans_kernel.narrow_margin(x.shape[1]))
    d = sqdist_rowwise(x, c)
    assert torch.equal(probe.best[0].cpu(), d.gather(1, want.long()[:, None])[:, 0])
    n, k = x.shape[0], c.shape[0]
    per_point = int(probe.rechecks.sum()) / n
    assert 0 <= per_point <= k
    if kind == "offset":
        assert per_point >= 0.9 * k


def _nan_inf_data(kind, b, n, k, s, seed):
    """``(x (b, n, s), c (b, k, s))`` on the CPU, integer-valued (every fp32
    sum exact in any order) with NaN or +-inf entries by codebook: 0 a
    non-finite centroid coordinate, 1 non-finite points (every 7th), 2 both
    (inf - inf makes NaN distances), the rest clean.  ``kind``: "nan", "inf"
    or "mixed" (NaN in codebooks 0 and 1, inf in 2)."""
    g = _gen(seed)
    x = torch.randint(-5, 6, (b, n, s), generator=g).float()
    c = torch.randint(-5, 6, (b, k, s), generator=g).float()
    bad = {"nan": (float("nan"),) * 3, "inf": (float("inf"), -float("inf"), float("inf")),
           "mixed": (float("nan"), float("nan"), float("inf"))}[kind]
    c[0, k // 2, s - 1] = bad[0]
    x[1, ::7, 0] = bad[1]
    x[2, 3::7, s - 1] = bad[2]
    c[2, k - 1, s - 1] = bad[2]
    return x, c


#: (row, wide variant, s, k): both variants of rows 3-5 at s <= 64, the
#: wide ones (and row 6) also at s = 70; row 4's narrow variant holds its
#: k^2 histogram in shared memory, so k = 100 there in place of 256; row 4
#: also at its narrowest and widest instantiations (s = 1, 64)
NAN_CASES = [(row, wide, s, 100 if (row, wide, k) == (4, False, 256) else k)
             for row, wide in [(3, False), (3, True), (4, False), (4, True), (5, False),
                               (5, True), (6, True)]
             for s, k in [(5, 23), (8, 50), (16, 256), (70, 40)] if wide or s <= 64]
NAN_CASES += [(4, wide, s, k) for wide in (False, True)
              for s, k in [(1, 3), (17, 50), (32, 29), (64, 50)]]


@pytest.mark.parametrize("kind", ["nan", "inf", "mixed"])
@pytest.mark.parametrize("row,wide,s,k", NAN_CASES)
def test_assign_kernels_equal_plain_on_nan_and_inf_data(dev, row, wide, s, k, kind):
    """Rows 3-6, each variant the op may take, against the plain version on
    NaN and inf data: torch.argmin's index (the first NaN distance; else the
    lowest index of the minimum), never one outside [0, k); row 3's sums,
    counts and inertia bit-equal (NaN where the plain version's are), row
    4's histogram equal."""
    from repro_torch.kernels.kmeans_assign import kernel as kmeans_kernel

    b, n, bn = 4, 3_001, 1_000
    x, c = (a.to(dev) for a in _nan_inf_data(kind, b, n, k, s, seed=s + k))
    if row == 3:
        got = kmeans_kernel.kmeans_stats(x, c, bn, True, wide)
        want = kmeans_stats_ref(x, c, block_n=bn)
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=0, atol=0, equal_nan=True)
        a = got[0]
    elif row == 4:
        got = kmeans_kernel.kmeans_pair_assign_hist(x, c, wide)
        want = kmeans_pair_assign_hist_ref(x, c, block_n=bn)
        assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
        a = got[0]
    elif row == 5:
        a = kmeans_kernel.kmeans_assign_batched(x, c, wide)
        assert torch.equal(a, kmeans_assign_batched_ref(x, c, block_n=bn))
    else:
        a = torch.stack([kmeans_ops.kmeans_assign(x[i], c[i]) for i in range(b)])
        assert torch.equal(a, torch.stack([kmeans_assign_ref(x[i], c[i]) for i in range(b)]))
    torch.cuda.synchronize()
    assert int(a.min()) >= 0 and int(a.max()) < k


def test_smallest_nan_inputs_take_the_first_nan(dev):
    """The smallest inputs that showed the fault: the narrow route with
    centroid 1 NaN (B = 1, n = 2, s = 4, k = 3) gives [1, 1]; the screened
    kernel with x = [NaN, 0, 0, 0] (n = 1, s = 4, k = 2) gives 0, not -1."""
    c = torch.zeros(1, 3, 4)
    c[0, 1, 0] = float("nan")
    x = torch.ones(1, 2, 4)
    assert kmeans_ops.kmeans_assign_batched(x.to(dev), c.to(dev), block_n=4).tolist() == [[1, 1]]
    assert kmeans_assign_batched_ref(x, c, block_n=4).tolist() == [[1, 1]]
    x1 = torch.tensor([[float("nan"), 0.0, 0.0, 0.0]])
    c1 = torch.randn(2, 4, generator=_gen(3))
    assert kmeans_ops.kmeans_assign(x1.to(dev), c1.to(dev)).tolist() == [0]
    assert kmeans_assign_ref(x1, c1).tolist() == [0]


@pytest.mark.parametrize("n,s,k", [(20_000, 128, 1024), (5_000, 130, 300), (777, 5, 7), (1, 1, 1)])
def test_kmeans_assign_kernel_equals_plain(dev, n, s, k):
    """Wider than a 32-dim slice and more centroids than a 32-row tile,
    with ragged edges in both; duplicated centroids test the tie rule."""
    g = _gen(9)
    x = torch.randn(n, s, generator=g) * 3
    c = torch.randn(k, s, generator=g) * 3
    c[k // 2] = c[k // 3]  # an exact tie: the lower index must win
    before = kernels.launch_counts()["kmeans_assign"]
    got = kmeans_ops.kmeans_assign(x.to(dev), c.to(dev))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["kmeans_assign"] == before + 1
    assert torch.equal(got.cpu(), kmeans_assign_ref(x, c))
    if k > 2:
        assert not (got == k // 2).any() or k // 2 == k // 3


@pytest.mark.parametrize("algo,block_n", [("lloyd", 0), ("lloyd", 3000), ("minibatch", 2048)])
def test_kmeans_library_on_the_card_equals_the_cpu(dev, algo, block_n):
    from repro_torch.core import kmeans

    x, c0 = _blobs(10, 4, 12_000, 20, 6)
    sample = torch.randint(0, 12_000, (5, block_n), generator=_gen(11))
    kw = dict(algo=algo, block_n=block_n, init_centroids=c0, pair_sqrt_k=0,
              sample_idx=sample if algo == "minibatch" else None)
    kernels.reset_launch_counts()
    card = kmeans.kmeans_batched(x.to(dev), 20, 5, **kw)
    counts = kernels.launch_counts()
    final = "kmeans_stats" if algo == "minibatch" else "kmeans_assign_batched"
    assert counts[final] >= 1 and counts["kmeans_stats"] >= 5
    cpu = kmeans.kmeans_batched(x, 20, 5, **kw)
    assert torch.equal(card.assignments.cpu(), cpu.assignments) and card.cell_counts is None
    torch.testing.assert_close(card.centroids.cpu(), cpu.centroids, rtol=1e-5, atol=1e-5)
    one = kmeans.assign(x[0].to(dev), card.centroids[0])
    assert torch.equal(one.cpu(), cpu.assignments[0])


def _same_answers(card, cpu, rtol=2e-5):
    """Ids equal except where the CPU's distances tie within ``rtol``;
    distances within ``rtol``; scores of the ids both return equal."""
    ci, cd, cs = (t.cpu() for t in card)
    pi, pd, ps = cpu
    torch.testing.assert_close(cd, pd, rtol=rtol, atol=0)
    for r in range(ci.shape[0]):
        for c in torch.nonzero(ci[r] != pi[r]).flatten().tolist():
            assert ((pd[r] - pd[r, c]).abs() <= rtol * pd[r, c]).sum() > 1, (r, c)
        scores = dict(zip(pi[r].tolist(), ps[r].tolist()))
        for i, s_ in zip(ci[r].tolist(), cs[r].tolist()):
            assert scores.get(i, s_) == s_


@pytest.mark.parametrize("mode", ["fused", "dense"])
def test_engine_mutation_on_the_card_equals_the_cpu(dev, mode):
    x = gaussian_mixture(20_000, 32, 12)
    new = gaussian_mixture(3_000, 32, 13)
    q = torch.from_numpy(make_queries(x, 8, seed=14))
    idx = suco.build_index(torch.from_numpy(x), suco.SuCoConfig(n_subspaces=8, sqrt_k=16,
                                                                 kmeans_iters=4))
    policy = suco.EnginePolicy(mode=mode, tiles=TileConfig(block_n=4096, survivor_cap=128))
    engines = [suco.SuCoEngine(x, idx, policy, capacity=24_000, device=d) for d in (dev, "cpu")]
    dead = torch.randperm(21_000, generator=_gen(15))[:2_500]
    for eng in engines:
        eng.warmup(batch_sizes=(8,))
        for lo in range(0, 3_000, 1_000):
            eng.insert(new[lo:lo + 1_000])
        assert eng.delete(dead) == 2_500 and eng.delete(dead[:10]) == 0
    card, cpu = engines
    for name in ("cell_ids", "cell_counts", "tombstone"):
        assert torch.equal(getattr(card.index, name).cpu(), getattr(cpu.index, name))
    assert card.n_live == cpu.n_live == 23_000 - 2_500 and card.free_slots == 1_000
    assert abs(card.insert_inertia_per_point - cpu.insert_inertia_per_point) <= (
        1e-5 * cpu.insert_inertia_per_point)
    want = cpu.query(q, 10)
    got = card.query(q, 10)
    _same_answers(got, want)
    assert not torch.isin(got.ids.cpu(), dead.int()).any()


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _assert_o_close(got: torch.Tensor, want: torch.Tensor) -> None:
    """fp32: rtol 1e-4 / atol 1e-4 (sums in another order).  bf16: the two
    fp32 results may round to neighbouring bf16 values, so one bf16 ulp of
    the larger, on top of the fp32 atol."""
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    else:
        assert ((g - w).abs() <= _bf16_ulp(torch.maximum(g.abs(), w.abs())) + 1e-4).all()


def _decays(kind: str, shape: tuple, g: torch.Generator) -> torch.Tensor:
    """Decays of the kind ``kind``: ``model`` as the tests always drew them,
    ``clip`` every decay at the clip (1e-6), ``below_clip`` 1e-9 (clipped to
    1e-6 by both versions), ``mixed`` w = 1 or 1e-6 at random per token and
    dim: a sub-block's cumulative log-decay then reaches -884 in 64 tokens,
    where one reference point per chunk would overflow fp32."""
    if kind == "model":
        return torch.exp(-torch.exp(torch.randn(shape, generator=g) - 2))
    if kind in ("clip", "below_clip"):
        return torch.full(shape, 1e-6 if kind == "clip" else 1e-9)
    return torch.where(torch.rand(shape, generator=g) < 0.5, 1.0, 1e-6)


@pytest.mark.parametrize("w_kind", ["model", "clip", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("bh,t,dk,dv,chunk", [
    (4, 200, 64, 64, 64),    # RWKV6 widths, a ragged last chunk
    (2, 130, 64, 128, 64),   # Zamba2 widths: two value slices
    (3, 100, 12, 20, 32),    # odd widths of the reference's tests
    (2, 64, 16, 24, 16),
    (2, 96, 96, 40, 32),     # dk past one 64-dim slice
    (3, 150, 64, 64, 8),     # chunks other than a tile: c live rows of a larger tile
    (3, 150, 64, 40, 40),
    (2, 300, 64, 64, 128),   # the 128 tile
    (2, 450, 32, 64, 200),   # past 128: sub-chunks of 128
])
def test_linear_attn_kernel_equals_plain(dev, dtype, shift, bh, t, dk, dv, chunk, w_kind):
    """The kernel against its plain version, with the model's decays and
    with decays at the clip (all, or mixed with w = 1); a second launch
    gives the same bits."""
    from repro_torch.kernels.linear_attn import ops as la_ops

    g = _gen(30)
    q, k = (torch.randn(bh, t, dk, generator=g).to(dtype) for _ in range(2))
    v = torch.randn(bh, t, dv, generator=g).to(dtype)
    w = _decays(w_kind, (bh, t, dk), g).to(dtype)
    u = (0.5 * torch.randn(bh, 1, dk, generator=g)).to(dtype)
    want_o, want_s = la_ops.linear_attention_with_state(q, k, v, w, u, chunk=chunk, shift=shift)
    before = kernels.launch_counts()["linear_attn"]
    args = [a.to(dev) for a in (q, k, v, w, u)]
    got_o, got_s = la_ops.linear_attention_with_state(*args, chunk=chunk, shift=shift)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["linear_attn"] == before + 1
    assert got_o.dtype == dtype and got_s.dtype == torch.float32
    _assert_o_close(got_o.cpu(), want_o)
    torch.testing.assert_close(got_s.cpu(), want_s, rtol=1e-4, atol=1e-4)
    again_o, again_s = la_ops.linear_attention_with_state(*args, chunk=chunk, shift=shift)
    assert torch.equal(again_o, got_o) and torch.equal(again_s, got_s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("chunk", [16, 64, 128, 200])
@pytest.mark.parametrize("w_kind", ["0.2", "clip", "below_clip", "mixed"])
def test_linear_attn_kernel_small_decay_stays_finite(dev, w_kind, chunk, shift, dtype):
    """Small decays over whole chunks: w = 0.2 (the cumulative decay reaches
    0.2**64), every decay at the clip (1e-6, or 1e-9 clipped to it), and w
    = 1 or 1e-6 at random per token and dim.  Every exponent the kernel
    takes is <= 0 (the sub-blocks' factors too), so o and the state stay
    finite and within the plain version's tolerance."""
    from repro_torch.kernels.linear_attn import ops as la_ops

    g = _gen(31)
    t = 128 if w_kind == "0.2" else 400  # w = 0.2 at 128 tokens: the test's first case
    q, k, v = (torch.randn(2, t, 16, generator=g) for _ in range(3))
    w = torch.full_like(q, 0.2) if w_kind == "0.2" else _decays(w_kind, q.shape, g)
    u = torch.randn(2, 1, 16, generator=g)
    q, k, v, w, u = (a.to(dtype) for a in (q, k, v, w, u))
    o, s = la_ops.linear_attention_with_state(*(a.to(dev) for a in (q, k, v, w, u)),
                                              chunk=chunk, shift=shift)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    want_o, want_s = la_ops.linear_attention_with_state(q, k, v, w, u, chunk=chunk, shift=shift)
    _assert_o_close(o.cpu(), want_o)
    torch.testing.assert_close(s.cpu(), want_s, rtol=1e-4, atol=1e-4)


def test_rwkv_model_on_the_card_equals_the_cpu(dev):
    """The reduced RWKV6 in fp32: prefill through the 3-D entry, the forward
    pass through the 4-D entry, one decode step; one launch per layer."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import Model, backbone

    cfg = dataclasses.replace(reduced_config("rwkv6-1.6b"), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(2))
    card = _to(params, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=_gen(32))
    kernels.reset_launch_counts()
    lc, cache_c = model.prefill(card, toks.to(dev))
    assert kernels.launch_counts()["linear_attn"] == cfg.n_layers
    lp, cache_p = model.prefill(params, toks)
    torch.testing.assert_close(lc.cpu(), lp, rtol=1e-3, atol=2e-4)
    dc, _ = model.decode_step(card, cache_c, lc.argmax(-1), 40)
    dp, _ = model.decode_step(params, cache_p, lp.argmax(-1), 40)
    torch.testing.assert_close(dc.cpu(), dp, rtol=1e-3, atol=2e-4)
    hc = backbone.forward_hidden(cfg, card, toks.to(dev))
    hp = backbone.forward_hidden(cfg, params, toks)
    torch.testing.assert_close(hc.cpu(), hp, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,t", [("rwkv", 200), ("ssd", 77)])
def test_row_11_autograd_function_gives_the_plain_versions_gradients(dev, mode, t, dtype):
    """``linear_attention`` on the card under autograd: the forward launches
    the kernel once (held to the plain version as above), and the gradients
    of q, k, v, w and the bonus equal autograd of the plain version on the
    card, the backward being that version recomputed."""
    from repro_torch.kernels.linear_attn import ops as la_ops
    from repro_torch.kernels.linear_attn.ref import linear_attn_chunked

    g = _gen(41)
    b, h, dk, dv = 2, 3, 64, 64
    q, k = (torch.randn((b, h, t, dk), generator=g) * 0.3 for _ in range(2))
    v = torch.randn((b, h, t, dv), generator=g)
    w = torch.rand((b, h, t, dk), generator=g) * 0.5 + 0.5
    u = torch.randn((h, dk), generator=g) * 0.3 if mode == "rwkv" else None
    ct = torch.randn((b, h, t, dv), generator=g).to(dev)
    args = [a.to(dev, dtype) for a in (q, k, v, w, u) if a is not None]
    leaves = [a.clone().requires_grad_() for a in args]
    kernels.reset_launch_counts()
    o = la_ops.linear_attention(*leaves, mode=mode)
    assert kernels.launch_counts()["linear_attn"] == 1
    got = torch.autograd.grad((o.float() * ct).sum(), leaves)
    assert kernels.launch_counts()["linear_attn"] == 1  # the backward launches nothing

    plain = [a.clone().requires_grad_() for a in args]
    shift = 1 if mode == "rwkv" else 0
    qf, kf, vf, wf = (a.reshape(b * h, t, -1) for a in plain[:4])
    hk = plain[4] if mode == "rwkv" else torch.zeros((h, dk), dtype=dtype, device=dev)
    u_b = hk[None].expand(b, h, dk).reshape(b * h, 1, dk)
    pad = -(-t // 64) * 64 - t
    pads = [torch.nn.functional.pad(a, (0, 0, 0, pad), value=val)
            for a, val in ((qf, 0.0), (kf, 0.0), (vf, 0.0), (wf, 1.0))]
    want_o = linear_attn_chunked(*pads, u_b, chunk=64, shift=shift)[0][:, :t].reshape(b, h, t, dv)
    _assert_o_close(o.detach().cpu(), want_o.detach().cpu())
    want = torch.autograd.grad((want_o.float() * ct).sum(), plain)
    for name, a, b_ in zip("qkvwu", got, want):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-6, msg=name)


def test_train_step_on_the_card_equals_the_cpu(dev):
    """One AdamW step of the reduced RWKV6 in fp32 on the card and on the
    CPU from the same weights and batch: the loss, every gradient (through
    row 11's autograd.Function on the card) and the new parameters."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import loss_and_grads, make_train_step

    cfg = dataclasses.replace(reduced_config("rwkv6-1.6b"), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(LMDataConfig(cfg.vocab_size, 80, 2, seed=4)).batch_at(0).items()}
    card = _to(params, dev)
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    kernels.reset_launch_counts()
    lc, gc = loss_and_grads(model, card, card_batch)
    assert kernels.launch_counts()["linear_attn"] == 2 * cfg.n_layers  # remat recomputes
    lp, gp = loss_and_grads(model, params, batch)
    torch.testing.assert_close(lc.cpu(), lp, rtol=1e-5, atol=1e-6)
    for key in gp:
        _assert_tree_close(gc[key], gp[key], 2e-3)
    step = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=0, total_steps=10))
    pc, _, mc = step(card, init_opt_state(card), card_batch)
    pp, _, mp = step(params, init_opt_state(params), batch)
    torch.testing.assert_close(mc["grad_norm"].cpu(), mp["grad_norm"], rtol=1e-4, atol=0)
    # Adam moves an element by ~lr * sign(g): a gradient within rounding of 0
    # may take the other sign on the other device, a move of at most 2 lr
    far = total = 0
    for a, b_ in zip(_flat(pc), _flat(pp)):
        d = (a.cpu() - b_).abs()
        assert float(d.max()) <= 2e-3 + 1e-6
        far, total = far + int((d > 1e-5).sum()), total + d.numel()
    assert far <= 1e-3 * total, (far, total)


def _flat(tree):
    return [x for k in sorted(tree) for x in (_flat(tree[k]) if isinstance(tree[k], dict)
                                              else [tree[k]])]


def _assert_tree_close(card, cpu, tol):
    if isinstance(cpu, dict):
        for key in cpu:
            _assert_tree_close(card[key], cpu[key], tol)
        return
    scale = float(cpu.abs().max()) if cpu.numel() else 0.0
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=tol * max(scale, 1e-30))


def test_int8_allreduce_over_nccl_at_world_size_one(dev):
    """At world size 1 over NCCL the mean is the local dequantised payload
    and the residual the local quantisation error."""
    import socket

    import torch.distributed as dist

    from repro_torch.train import compression as C

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        x = torch.randn(1000, generator=_gen(5)).to(dev)
        q, s = C.quantize_int8(x)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert torch.equal(C.int8_allreduce(x), C.dequantize_int8(q, s))
        g = {"a": x, "b": {"c": x[:10] * 3}}
        out, r = C.compressed_grad_allreduce(g, None, C.ErrorFeedback.init(g))
        assert torch.equal(out["a"], C.dequantize_int8(q, s))
        assert torch.equal(r["a"], x - C.dequantize_int8(q, s))
        qq, ss = C.quantize_int8(x.cpu())
        assert torch.equal(qq, q.cpu()) and torch.equal(ss, s.cpu())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-9b"])
def test_dense_model_on_the_card_equals_the_cpu(dev, arch):
    """Reduced granite (GQA 4) and Gemma2 (GQA 2, local / global windows at
    a prompt past the window, softcaps, GeGLU) in fp32: prefill into an fp32
    cache, two decode steps with the cache written in place, the forward
    pass; no port kernel is launched on this path."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import Model, backbone
    from repro_torch.models import prefill as P

    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    card = _to(params, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=_gen(33))
    kernels.reset_launch_counts()
    lc, cache_c = P.prefill(cfg, card, toks.to(dev), max_seq=43, cache_dtype=torch.float32)
    lp, cache_p = P.prefill(cfg, params, toks, max_seq=43, cache_dtype=torch.float32)
    torch.testing.assert_close(lc.cpu(), lp, rtol=1e-3, atol=2e-4)
    ptr = cache_c["k"].data_ptr()
    nxt = lp.argmax(-1)
    for pos in (40, 41):
        dc, cache_c = model.decode_step(card, cache_c, nxt.to(dev), pos)
        dp, cache_p = model.decode_step(params, cache_p, nxt, pos)
        torch.testing.assert_close(dc.cpu(), dp, rtol=1e-3, atol=2e-4)
        nxt = dp.argmax(-1)
    assert cache_c["k"].data_ptr() == ptr
    for name in ("k", "v"):
        torch.testing.assert_close(cache_c[name].cpu(), cache_p[name], rtol=1e-3, atol=2e-4)
    hc = backbone.forward_hidden(cfg, card, toks.to(dev))
    torch.testing.assert_close(hc.cpu(), backbone.forward_hidden(cfg, params, toks),
                               rtol=1e-3, atol=2e-4)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_hybrid_model_on_the_card_equals_the_cpu(dev):
    """Reduced zamba2 (8 Mamba2 layers, the shared block after layers 2 and
    5) in fp32: prefill into an fp32 cache launches row 11 once a layer, in
    SSD mode, and a decode step launches nothing; two decode steps write the
    shared K / V in place; the logits and every cache array equal the CPU's;
    the card's server gives the CPU server's greedy tokens."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve
    from repro_torch.models import Model, backbone
    from repro_torch.models import prefill as P

    cfg = dataclasses.replace(reduced_config("zamba2-1.2b"), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(4))
    card = _to(params, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 70), generator=_gen(34))
    kernels.reset_launch_counts()
    lc, cache_c = P.prefill(cfg, card, toks.to(dev), max_seq=73, cache_dtype=torch.float32)
    assert kernels.launch_counts() == dict(dict.fromkeys(kernels.KERNELS, 0),
                                           linear_attn=cfg.n_layers)
    lp, cache_p = P.prefill(cfg, params, toks, max_seq=73, cache_dtype=torch.float32)
    torch.testing.assert_close(lc.cpu(), lp, rtol=1e-3, atol=2e-4)
    ptr = cache_c["sk"].data_ptr()
    nxt = lp.argmax(-1)
    for pos in (70, 71):
        kernels.reset_launch_counts()
        dc, cache_c = model.decode_step(card, cache_c, nxt.to(dev), pos)
        assert not any(kernels.launch_counts().values())
        dp, cache_p = model.decode_step(params, cache_p, nxt, pos)
        torch.testing.assert_close(dc.cpu(), dp, rtol=1e-3, atol=2e-4)
        nxt = dp.argmax(-1)
    assert cache_c["sk"].data_ptr() == ptr
    for name in ("conv", "ssm", "sk", "sv"):
        torch.testing.assert_close(cache_c[name].cpu(), cache_p[name], rtol=1e-3, atol=2e-4)
    hc = backbone.forward_hidden(cfg, card, toks.to(dev))
    torch.testing.assert_close(hc.cpu(), backbone.forward_hidden(cfg, params, toks),
                               rtol=1e-3, atol=2e-4)
    prompts = toks[:, :24].numpy()
    got = serve.Server(model, card, 2, 37).run(
        [serve.Request(i, prompts[i]) for i in range(2)], 12)
    want = serve.Server(model, params, 2, 37).run(
        [serve.Request(i, prompts[i]) for i in range(2)], 12)
    assert [r.generated for r in got] == [r.generated for r in want]


@pytest.mark.parametrize("n_experts,top_k", [(8, 2), (32, 4)])
def test_moe_model_on_the_card_equals_the_cpu(dev, n_experts, top_k):
    """Reduced olmoe in fp32 at E = 8 and at E = 32 (the reference's
    expert-major branch, E > 16): prefill of 40 tokens into an fp32 cache
    and two decode steps, the
    logits at the dense tests' tolerance, the cache written in place; the
    card's server gives the CPU server's greedy tokens; no port kernel is
    launched; two prefills on the card, in fp32 and with the bf16 compute
    tree, give equal bits (the combine adds in a fixed order, no atomics)."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.models import prefill as P

    cfg = dataclasses.replace(reduced_config("olmoe-1b-7b"), dtype="float32",
                              n_experts=n_experts, top_k_experts=top_k)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(5))
    card = _to(params, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=_gen(35))
    kernels.reset_launch_counts()
    lc, cache_c = P.prefill(cfg, card, toks.to(dev), max_seq=43, cache_dtype=torch.float32)
    lp, cache_p = P.prefill(cfg, params, toks, max_seq=43, cache_dtype=torch.float32)
    torch.testing.assert_close(lc.cpu(), lp, rtol=1e-3, atol=2e-4)
    ptr = cache_c["k"].data_ptr()
    nxt = lp.argmax(-1)
    for pos in (40, 41):
        dc, cache_c = model.decode_step(card, cache_c, nxt.to(dev), pos)
        dp, cache_p = model.decode_step(params, cache_p, nxt, pos)
        torch.testing.assert_close(dc.cpu(), dp, rtol=1e-3, atol=2e-4)
        nxt = dp.argmax(-1)
    assert cache_c["k"].data_ptr() == ptr
    for name in ("k", "v"):
        torch.testing.assert_close(cache_c[name].cpu(), cache_p[name], rtol=1e-3, atol=2e-4)
    again, _ = P.prefill(cfg, card, toks.to(dev), max_seq=43, cache_dtype=torch.float32)
    assert torch.equal(again, lc)
    bf16 = Model(dataclasses.replace(cfg, dtype="bfloat16"))
    compute = bf16.compute_params(card)
    assert torch.equal(bf16.prefill(compute, toks.to(dev))[0],
                       bf16.prefill(compute, toks.to(dev))[0])
    prompts = toks[:, :24].numpy()
    got = serve.Server(model, card, 2, 37).run(
        [serve.Request(i, prompts[i]) for i in range(2)], 12)
    want = serve.Server(model, params, 2, 37).run(
        [serve.Request(i, prompts[i]) for i in range(2)], 12)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-large-v3"],
                         ids=["vlm", "audio"])
def test_cross_attention_model_on_the_card_equals_the_cpu(dev, arch):
    """Reduced Llama-3.2-Vision at two units (``n_layers`` 10, period 5,
    every gate 0.7) and reduced Whisper in fp32, over seeded ``extras``
    (1,030 patches / 1,100 frames: a padded second chunk of 1,024 keys):
    prefill of 40 tokens into an fp32 cache and two decode steps, the
    logits and every cache array (``k``, ``v``, ``xk``, ``xv``) at the dense
    tests' tolerance, ``k`` written in place and ``xk`` untouched, the
    forward pass; the card's server gives the CPU server's greedy tokens; no
    port kernel is launched."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve
    from repro_torch.models import Model, backbone
    from repro_torch.models import prefill as P

    kw = (dict(n_layers=10, vision_tokens=1030) if arch == "llama-3.2-vision-11b"
          else dict(encoder_seq=1100))
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32", **kw)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(6))
    if cfg.family == "vlm":
        params["cross_blocks"]["gate"].fill_(0.7)
    card = _to(params, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=_gen(36))
    ex = torch.randn((2, backbone.memory_tokens(cfg), cfg.d_model), generator=_gen(37))
    kernels.reset_launch_counts()
    lc, cache_c = P.prefill(cfg, card, toks.to(dev), extras=ex.to(dev), max_seq=43,
                            cache_dtype=torch.float32)
    lp, cache_p = P.prefill(cfg, params, toks, extras=ex, max_seq=43,
                            cache_dtype=torch.float32)
    torch.testing.assert_close(lc.cpu(), lp, rtol=1e-3, atol=2e-4)
    ptr, xk = cache_c["k"].data_ptr(), cache_c["xk"].clone()
    nxt = lp.argmax(-1)
    for pos in (40, 41):
        dc, cache_c = model.decode_step(card, cache_c, nxt.to(dev), pos)
        dp, cache_p = model.decode_step(params, cache_p, nxt, pos)
        torch.testing.assert_close(dc.cpu(), dp, rtol=1e-3, atol=2e-4)
        nxt = dp.argmax(-1)
    assert cache_c["k"].data_ptr() == ptr and torch.equal(cache_c["xk"], xk)
    for name in ("k", "v", "xk", "xv"):
        torch.testing.assert_close(cache_c[name].cpu(), cache_p[name], rtol=1e-3, atol=2e-4)
    hc = backbone.forward_hidden(cfg, card, toks.to(dev), extras=ex.to(dev))
    torch.testing.assert_close(hc.cpu(), backbone.forward_hidden(cfg, params, toks, extras=ex),
                               rtol=1e-3, atol=2e-4)
    prompts = toks[:, :24].numpy()
    got = serve.Server(model, card, 2, 37).run(
        [serve.Request(i, prompts[i]) for i in range(2)], 12)
    want = serve.Server(model, params, 2, 37).run(
        [serve.Request(i, prompts[i]) for i in range(2)], 12)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_init_cache_defaults_to_the_card(dev):
    from repro_torch.configs import reduced_config
    from repro_torch.models import Model

    for arch in ("rwkv6-1.6b", "gemma2-9b"):
        cache = Model(reduced_config(arch)).init_cache(2, 8)
        assert all(t.is_cuda for t in cache.values())


def _to(tree, dev):
    return {k_: _to(v_, dev) if isinstance(v_, dict) else v_.to(dev) for k_, v_ in tree.items()}


# ---- the ANN serving layer on the card -------------------------------------

_SERVE_KS = (10, 10, 5, 10, 5, 5, 10, 5, 10, 10, 5, 10, 5, 10, 10, 5, 10, 5)


@pytest.fixture(scope="module")
def serve_data():
    """The CPU serving tests' size (4,000 x 32, Ns = 8, sqrt_k = 16) with an
    index built on the CPU, served in the fused mode (rows 1 and 2) with
    the tiling pinned, so card and CPU run the same chunks."""
    x = gaussian_mixture(4000, 32, 0)
    index = suco.build_index(torch.from_numpy(x),
                             suco.SuCoConfig(n_subspaces=8, sqrt_k=16, kmeans_iters=4))
    policy = dict(alpha=0.05, beta=0.02, mode="fused", tiles=TileConfig(2048, 256),
                  batch_buckets=(4, 16))
    return x, make_queries(x, 40, seed=1), index, policy


def _serve_engine(serve_data, device):
    x, _, index, policy = serve_data
    return suco.SuCoEngine(x, index, suco.EnginePolicy(**policy), device=device)


def _same_request_answers(want, got, rtol=2e-5):
    """Request by request: ids equal except at the CPU's fp-distance ties."""
    by = {r.rid: r for r in want}
    assert sorted(by) == sorted(r.rid for r in got)
    for r in got:
        w = by[r.rid]
        assert r.done and w.done and r.ids.dtype == w.ids.dtype
        torch.testing.assert_close(torch.from_numpy(r.dists), torch.from_numpy(w.dists),
                                   rtol=rtol, atol=0)
        for c in (r.ids != w.ids).nonzero()[0]:
            assert ((abs(w.dists - w.dists[c]) <= rtol * w.dists[c]).sum() > 1), (r.rid, c)


def test_ann_servers_on_the_card_answer_as_the_cpu(dev, serve_data):
    from repro_torch.serve import AnnRequest, AnnServer, AsyncAnnServer

    q = serve_data[1]
    reqs = lambda: [AnnRequest(i, q[i], k=k) for i, k in enumerate(_SERVE_KS)]
    cpu = AnnServer(_serve_engine(serve_data, "cpu"), max_batch=4)
    cpu.submit_many(reqs())
    cpu.run_until_drained()
    card = _serve_engine(serve_data, dev)
    card.warmup(batch_sizes=(1, 4), ks=(5, 10))
    kernels.reset_launch_counts()
    for server in (AnnServer(card, max_batch=4), AsyncAnnServer(card, max_batch=4, depth=2)):
        server.submit_many(reqs())
        server.run_until_drained()
        _same_request_answers(cpu.completed, server.completed)
        assert [(s.k, s.n_requests, s.bucket) for s in server.steps] == [
            (s.k, s.n_requests, s.bucket) for s in cpu.steps]
    counts = kernels.launch_counts()
    assert counts["sc_score_cells_prefilter_compact"] > 0 and counts["gather_rerank"] > 0


def test_ladder_on_the_card_carries_its_bounds(dev, serve_data):
    from repro_torch.serve import AnnRequest, AnnServer, DegradationLadder

    q = serve_data[1]
    servers = []
    for device in ("cpu", dev):
        engine = _serve_engine(serve_data, device)
        ladder = DegradationLadder(engine, levels=2)
        ladder.warmup(batch_sizes=(4,), ks=(10,))
        assert all(e.device == engine.device and e.x is engine.x for e in ladder.engines)
        server = AnnServer(engine, max_batch=4, ladder=ladder)
        for level in (0, 1, 2, 1, 0):
            server.level = level
            n0 = len(server.completed)
            server.submit_many([AnnRequest(n0 + i, q[n0 + i], k=10) for i in range(4)])
            for r in server.step():
                assert r.degrade_level == level
                assert r.quality_bound == ladder.quality_bound(level, 10)
        servers.append(server)
    cpu, card = servers
    assert (card.ladder.m_stat, card.ladder.sigma_stat) == (cpu.ladder.m_stat, cpu.ladder.sigma_stat)
    _same_request_answers(cpu.completed, card.completed)


def test_loaded_libraries_stay_flat_after_warmup(dev, serve_data):
    from repro_torch.kernels import _build
    from repro_torch.serve import AnnRequest, AsyncAnnServer, DegradationLadder

    q = serve_data[1]
    engine = _serve_engine(serve_data, dev)
    ladder = DegradationLadder(engine, levels=2)
    ladder.warmup(batch_sizes=range(1, 5), ks=(5, 10))
    warm, loaded = ladder.compile_count, _build.loaded()
    assert {"sc_score", "gather_rerank"} <= set(loaded)
    for level in range(3):
        server = AsyncAnnServer(engine, max_batch=4, ladder=ladder, depth=2)
        server.level = level
        server.submit_many([AnnRequest(i, q[i], k=k) for i, k in enumerate(_SERVE_KS)])
        server.run_until_drained()
        assert all(r.done for r in server.completed)
        assert [s.compile_count for s in server.steps] == [warm] * len(server.steps)
    assert ladder.compile_count == warm and _build.loaded() == loaded


# ---- the durable mutable serving stack on the card ---------------------------

_MCFG = dict(n_subspaces=8, sqrt_k=16, kmeans_iters=4, seed=0, block_n=1024)


def _mutable_stack(serve_data, device, root=None):
    """A mutable fused engine (capacity 5,000) over the serving data, a
    1-level ladder warmed at batches 1-4, ``AnnServer``, a
    ``MutationManager``, and with ``root`` a ``Durability`` (no worker)."""
    from repro_torch.serve import AnnServer, DegradationLadder, Durability, MutationManager

    x, _, index, policy = serve_data
    engine = suco.SuCoEngine(x, index, suco.EnginePolicy(**policy), capacity=5000,
                             device=device)
    ladder = DegradationLadder(engine, levels=1)
    ladder.warmup(batch_sizes=range(1, 5), ks=(10,))
    server = AnnServer(engine, max_batch=4, ladder=ladder)
    manager = MutationManager(server, suco.SuCoConfig(**_MCFG), capacity_factor=1.25)
    dur = None
    if root is not None:
        dur = Durability(root, start_worker=False).attach(server, manager)
    return server, manager, dur


def _mutate_stack(manager, seed=5):
    manager.insert(gaussian_mixture(300, 32, seed))
    manager.delete(torch.arange(0, 4000, 9).numpy())


def _answers(engine, q):
    res = engine.query(q, k=10)
    return res.ids.cpu(), res.dists.cpu()


def test_reindex_async_on_its_own_stream_equals_a_sync_reindex(dev, serve_data):
    """The prepare runs on the manager's stream while this thread serves on
    its own; the committed successor is bit for bit a synchronous build of
    the same gather on this thread's stream, and its answers are too."""
    from repro_torch.serve import AnnRequest, AnnServer, mutation
    from repro_torch.serve.durability import fingerprint_diff, state_fingerprint
    from repro_torch.kernels import _build

    server, manager, _ = _mutable_stack(serve_data, dev)
    _mutate_stack(manager)
    q = serve_data[1]
    serving = torch.cuda.current_stream(dev)
    seen = {}
    real = mutation.build_index

    def spy(x, config, **kw):
        seen["stream"] = torch.cuda.current_stream(dev)
        seen["inference"] = torch.is_inference_mode_enabled()
        return real(x, config, **kw)

    mutation.build_index = spy
    loaded = _build.loaded()
    try:
        job = manager.reindex_async()
        served = 0
        while not job.done or served == 0:
            server.submit_many([AnnRequest(served + i, q[(served + i) % 40], k=10)
                                for i in range(4)])
            server.step()
            served += 4
        engine = manager.finish_reindex(timeout=600)
    finally:
        mutation.build_index = real
    assert seen["stream"] != serving and seen["stream"] == job._stream
    assert seen["inference"] and torch.cuda.current_stream(dev) == serving
    assert all(r.done for r in server.completed)
    assert _build.loaded() == loaded
    prepared = manager._build_successor(job._gathered)  # synchronously, this stream
    again = AnnServer(prepared.successor)
    assert not fingerprint_diff(state_fingerprint(server), state_fingerprint(again))
    for a, b in zip(_answers(engine, q[:16]), _answers(prepared.successor, q[:16])):
        assert torch.equal(a, b)


def test_durable_recover_on_the_card_is_bit_identical(dev, serve_data, tmp_path):
    """Snapshot, insert, delete, re-index, insert, kill: ``recover`` on the
    card gives the live stack's fingerprint and answers bit for bit, serving
    with no new (bucket, k) pair."""
    from repro_torch.serve import recover
    from repro_torch.serve.durability import fingerprint_diff, state_fingerprint

    server, manager, dur = _mutable_stack(serve_data, dev, tmp_path / "root")
    dur.snapshot()
    _mutate_stack(manager)
    manager.reindex()
    manager.insert(gaussian_mixture(50, 32, 6))
    want = state_fingerprint(server, manager)
    dur.abandon()
    res = recover(tmp_path / "root", device=dev, start_worker=False)
    assert res.server.engine.device.type == "cuda" and res.report.replayed == 1
    assert not fingerprint_diff(state_fingerprint(res.server, res.manager), want)
    q = serve_data[1]
    exe = res.server.executables
    for a, b in zip(_answers(res.server.engine, q[:4]), _answers(server.engine, q[:4])):
        assert torch.equal(a, b)
    assert res.server.executables == exe
    res.durability.close()


@pytest.mark.parametrize("point", ["wal.append.torn", "reindex.mid-prepare"])
def test_durable_drill_on_the_card(dev, serve_data, tmp_path, point):
    from repro_torch.serve import Durability, drill_steps, recovery_drill

    def build(root, injector):
        server, manager, _ = _mutable_stack(serve_data, dev)
        dur = Durability(root, crash=injector, start_worker=False).attach(server, manager)
        return server, manager, dur

    rep = recovery_drill(tmp_path, build, drill_steps(32, seed=3), point,
                         queries=serve_data[1][:4], k=10)
    assert rep.fired and rep.lost_acked == 0 and rep.bit_identical and rep.answers_match
    assert rep.retraces_after_warmup == 0 and rep.quality_bounds_match


def test_warmup_during_a_reindex_waits_for_its_own_stream_only(dev, serve_data):
    """A warm-up synchronises its thread's current stream, not the card: work
    queued on another stream (a re-index prepare's) is still running when it
    returns.  Its answers and pair count are a plain warm-up's."""
    engine = _serve_engine(serve_data, dev)
    engine.warmup(batch_sizes=(4,), ks=(10,))
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(2_000_000_000)  # about a second of spinning
        busy = torch.cuda.Event()
        busy.record(side)
    assert engine.warmup(batch_sizes=(16,), ks=(10,)) == 1
    assert not busy.query()  # the warm-up returned before the side stream finished
    torch.cuda.synchronize(dev)
    assert engine.compile_count == 2


def test_sharded_engine_over_nccl_at_world_size_one_equals_the_cpu(dev):
    """The sharded engine on a (1, 1) mesh over NCCL, at the reference
    test's sizes (4,096 x 64, Ns = 8, sqrt_k = 16): the card's build gives
    the CPU's cell ids in at least 99.9% of places (Lloyd sums in another
    order), centroids within 1e-5; on one index the card's answers are the
    CPU's but at distance ties (rtol 2e-5); the streaming and dense queries
    equal bit for bit; rows 2, 3, 4 and 7 launch; a pool's warm-up covers
    its traffic."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from repro_torch.distributed import (
        DistSuCoConfig, Mesh, ShardedEnginePool, build_sharded, index_to_host, query_sharded,
    )
    from repro_torch.serve.chaos import kill_pool_engine

    x = torch.from_numpy(gaussian_mixture(4096, 64, 0))
    q = torch.from_numpy(make_queries(x.numpy(), 16, seed=1))
    cfg = DistSuCoConfig(n_subspaces=8, sqrt_k=16, kmeans_iters=6, alpha=0.05, beta=0.02, k=10,
                         q_chunk=16)
    cpu_mesh = Mesh((1, 1), ("data", "model"))  # no process group: the identity collectives
    cpu_idx = build_sharded(cpu_mesh, x, cfg, device="cpu")
    want_ids, want_d = query_sharded(cpu_mesh, cfg, x, cpu_idx, q)
    with __import__("socket").socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = Mesh((1, 1), ("data", "model"))
        kernels.reset_launch_counts()
        idx = build_sharded(mesh, x, cfg, device=dev)
        card, cpu = index_to_host(idx), index_to_host(cpu_idx)
        assert (card["cell_ids"] == cpu["cell_ids"]).mean() >= 0.999
        for name in ("centroids1", "centroids2"):
            np.testing.assert_allclose(card[name], cpu[name], rtol=1e-5, atol=1e-5)
        on_card = dataclasses.replace(cpu_idx, cell_ids=cpu_idx.cell_ids.to(dev),
                                      centroids1=cpu_idx.centroids1.to(dev),
                                      centroids2=cpu_idx.centroids2.to(dev),
                                      cell_counts=cpu_idx.cell_counts.to(dev), mesh=mesh)
        ids, d = query_sharded(mesh, cfg, x, on_card, q)
        _assert_answers_tie_equal(ids.cpu().numpy(), d.cpu().numpy(), want_ids.numpy(),
                                  want_d.numpy())
        dense = query_sharded(mesh, dataclasses.replace(cfg, block_n=0), x, on_card, q)
        streaming = query_sharded(mesh, dataclasses.replace(cfg, block_n=300), x, on_card, q)
        assert all(torch.equal(a, b) for a, b in zip(dense, streaming))
        counts = kernels.launch_counts()
        for name in ("kmeans_stats", "kmeans_pair_assign_hist", "sc_score_cells", "gather_rerank"):
            assert counts[name] > 0, name
        pool = ShardedEnginePool(mesh, cfg, x, on_card, ks=(5, 10), device=dev)
        warm = pool.warmup((1, 3, 16))
        for m, k in ((16, 10), (1, 5), (3, 10)):
            ids_k, _, info = pool.query_resilient(q[:m], k)
            assert ids_k.shape == (m, k) and not info["degraded"]
        assert pool.compile_count == warm
        kill_pool_engine(pool, 5)
        ids5, _, info = pool.query_resilient(q, 5)
        assert info["degraded"] and torch.equal(ids5, pool.query(q, 10)[0][:, :5])
    finally:
        dist.destroy_process_group()


def _assert_answers_tie_equal(gi, gd, wi, wd, rtol=2e-5):
    import numpy as np

    np.testing.assert_allclose(gd, wd, rtol=rtol)
    for r in range(wi.shape[0]):
        for c in np.flatnonzero(wi[r] != gi[r]):
            assert (np.abs(wd[r] - wd[r, c]) <= rtol * wd[r, c]).sum() > 1, (r, c)


@pytest.mark.parametrize("name", ["ivf", "lsh", "imi_pq", "rpforest"])
def test_baselines_on_the_card_equal_the_cpu(dev, name):
    """Each baseline with a device path, built and queried on the card and on
    the CPU from the same data and seed: the same memory, and the same ids
    but at exact-distance ties (fp64, 1e-5) and at most 1% boundary cases
    (an fp32 argmin, hash floor or median split within a few ulp)."""
    import numpy as np

    from repro_torch import baselines as B

    cls, ctor, qkw = {
        "ivf": (B.IVFFlat, dict(n_cells=32, iters=5), dict(nprobe=8)),
        "lsh": (B.E2LSH, dict(n_tables=8, n_bits=10), dict(threshold=1)),
        "imi_pq": (B.IMIPQ, dict(sqrt_k=16, iters=5), dict(n_candidates=200)),
        "rpforest": (B.RPForest, dict(n_trees=10, leaf_size=64), dict()),
    }[name]
    x = gaussian_mixture(4000, 32, 0)
    q = make_queries(x, 20, seed=1)
    card = cls(**ctor, device=dev).build(x)
    cpu = cls(**ctor, device="cpu").build(x)
    assert card.memory_bytes() == cpu.memory_bytes()
    gi = card.query(q, 10, **qkw).cpu().numpy()
    wi = cpu.query(q, 10, **qkw).numpy()

    def d(ids):
        return ((x[ids].astype(np.float64) - q.astype(np.float64)[:, None]) ** 2).sum(-1)

    diff = gi != wi
    tied = np.abs(d(gi) - d(wi)) <= 1e-5 * np.maximum(d(gi), d(wi))
    assert (diff & ~tied).sum() <= 0.01 * gi.size
