"""SC-Linear (paper Algorithm 1) and its pieces in the port against the JAX
package, on the CPU: the same numpy inputs go through both.

Tolerances, and why:

* ``split_padded``, ``kth_smallest``, ``collision_mask``, ``sc_scores``,
  the SC-scores of integer-valued data, the pool merges and the rerank's
  ties: **exactly** equal.  Given the same distances the selections are the
  same, and integer coordinates make every distance exact in both
  packages' arithmetic.
* ``pairwise_sqdist``: within ``1e-5 * (|q|^2 + |x|^2)``.  Both take the
  identity ``|q|^2 + |x|^2 - 2 q.x``; the reference sums the cross term with
  a matmul, the port one dim at a time (the order of its CUDA kernel), so
  they differ by a few ulp of the norms.
* ``sc_linear_query`` on float data: the SC-scores may differ only at a
  point whose subspace distance lies within ``2e-5`` relative of that
  subspace's ``tau`` (the test counts them: they are rare), the ids on
  well-separated clustered data are the reference's, and distances agree
  to ``rtol=2e-5``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, strategies as st

from repro.core import collision as jcol
from repro.core import sc_linear as jlin
from repro.core import subspace as jsub
from repro.core import suco as jsuco
from repro.core.distances import pairwise_dist as j_pairwise_dist
from repro.core.distances import pairwise_sqdist as j_pairwise_sqdist
from repro.kernels.sc_score.ref import sc_score_ref as j_sc_score_ref

from repro_torch.core import collision as pcol
from repro_torch.core import sc_linear as plin
from repro_torch.core import subspace as psub
from repro_torch.core import suco as psuco
from repro_torch.core.distances import pairwise_dist, pairwise_sqdist
from repro_torch.data import exact_knn, gaussian_mixture, make_queries, recall
from repro_torch.kernels.pairwise_l2.ops import pairwise_sqdist as op_pairwise_sqdist
from repro_torch.kernels.sc_score.ops import sc_scores_fused

INT32_MAX = np.iinfo(np.int32).max
T = torch.from_numpy


def _specs(d, ns, seed):
    if seed is None:
        return jsub.contiguous_spec(d, ns), psub.contiguous_spec(d, ns)
    return jsub.sampled_spec(d, ns, seed), psub.sampled_spec(d, ns, seed)


@pytest.mark.parametrize("d,ns,seed", [(32, 4, None), (30, 4, None), (29, 3, 5)])
def test_split_padded_matches(d, ns, seed):
    js, ps = _specs(d, ns, seed)
    assert js.max_size == ps.max_size
    x = np.random.default_rng(0).normal(size=(7, d)).astype(np.float32)
    want = jsub.split_padded(js, jsub.permute(js, jnp.asarray(x)))
    got = psub.split_padded(ps, psub.permute(ps, T(x)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = psub.split_query_padded(ps, psub.permute(ps, T(x[0])))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want)[:, 0])


def test_split_padded_is_a_view_when_the_subspaces_are_equal():
    x = torch.arange(64, dtype=torch.float32).reshape(2, 32)
    xs = psub.split_padded(psub.contiguous_spec(32, 4), x)
    assert xs.shape == (4, 2, 8) and xs.data_ptr() == x.data_ptr()
    assert torch.equal(xs[1], x[:, 8:16])


@pytest.mark.parametrize("count", [1, 7, 40, 200])
def test_collision_counting_is_exactly_the_reference(count):
    rng = np.random.default_rng(count)
    d = rng.gamma(2.0, size=(4, 200)).astype(np.float32)
    d[:, 50:80] = d[:, :30]  # exact ties around many thresholds
    d[0] = np.round(d[0])  # heavy ties
    jd, pd = jnp.asarray(d), T(d)
    np.testing.assert_array_equal(
        pcol.kth_smallest(pd, count).numpy(), np.asarray(jcol.kth_smallest(jd, count))
    )
    np.testing.assert_array_equal(
        pcol.collision_thresholds(pd, count).numpy(),
        np.asarray(jcol.collision_thresholds(jd, count)),
    )
    np.testing.assert_array_equal(
        pcol.collision_mask(pd, count).numpy(), np.asarray(jcol.collision_mask(jd, count))
    )
    got = pcol.sc_scores(pd, count)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcol.sc_scores(jd, count)))
    with pytest.raises(ValueError):
        pcol.kth_smallest(pd, 201)


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_sc_scores_from_subspaces_exact_on_integer_data(metric):
    """Integer coordinates: every distance is an exact integer in both
    packages' arithmetic, so thresholds and scores must be equal (with many
    exact ties at the thresholds)."""
    rng = np.random.default_rng(1)
    spec = jsub.contiguous_spec(24, 4)
    x = rng.integers(-6, 7, size=(1500, 24)).astype(np.float32)
    q = rng.integers(-6, 7, size=(5, 24)).astype(np.float32)
    xs = jsub.split_padded(spec, jnp.asarray(x))
    qs = jsub.split_padded(spec, jnp.asarray(q))
    want = jlin.sc_scores_from_subspaces(xs, qs, 75, metric)
    got = plin.sc_scores_from_subspaces(T(np.array(xs)), T(np.array(qs)), 75, metric)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,n,d", [(1, 1, 3), (5, 300, 16), (33, 129, 40)])
def test_pairwise_sqdist_within_tolerance_of_the_reference(m, n, d):
    rng = np.random.default_rng(m + n)
    q = (rng.normal(size=(m, d)) * 3).astype(np.float32)
    x = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    scale = (q**2).sum(1)[:, None] + (x**2).sum(1)[None, :]
    want = np.asarray(j_pairwise_sqdist(jnp.asarray(q), jnp.asarray(x)))
    for impl in ("auto", "jnp", "rowwise"):
        got = pairwise_sqdist(T(q), T(x), impl=impl).numpy()
        assert got.dtype == np.float32 and got.shape == (m, n)
        assert (np.abs(got - want) <= 1e-5 * scale).all(), impl
        assert (got >= 0).all()
    with pytest.raises(ValueError, match="impl"):
        pairwise_sqdist(T(q), T(x), impl="pallas")


def test_pairwise_sqdist_takes_strided_rows_and_checks_its_arguments():
    x = torch.randn(50, 32, generator=torch.Generator().manual_seed(0))
    q = torch.randn(3, 32, generator=torch.Generator().manual_seed(1))
    view = op_pairwise_sqdist(q[:, 8:16], x[:, 8:16])  # row stride 32, no copy
    assert torch.equal(view, op_pairwise_sqdist(q[:, 8:16].contiguous(), x[:, 8:16].contiguous()))
    with pytest.raises(ValueError, match="dims"):
        op_pairwise_sqdist(q, x[:, :5])
    with pytest.raises(TypeError):
        op_pairwise_sqdist(q.double(), x)
    with pytest.raises(ValueError, match="contiguous rows"):
        op_pairwise_sqdist(q.T, x[:3].T)


def test_l1_pairwise_dist_is_blocked_without_changing_a_value():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(4, 12)).astype(np.float32)
    x = rng.normal(size=(1000, 12)).astype(np.float32)
    whole = pairwise_dist(T(q), T(x), "l1", block=1 << 20)
    np.testing.assert_array_equal(pairwise_dist(T(q), T(x), "l1", block=333).numpy(), whole.numpy())
    want = np.asarray(j_pairwise_dist(jnp.asarray(q), jnp.asarray(x), "l1", block=333))
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-6)


def test_sc_scores_fused_counts_the_collisions_of_pairwise_sqdist():
    """Row 9 fed thresholds taken from row 10's distances counts exactly
    those distances' collisions; against the reference's oracle it differs
    only at distances within 2e-5 relative of a threshold."""
    rng = np.random.default_rng(3)
    ns, m, n, s = 4, 6, 900, 5
    qs = rng.normal(size=(ns, m, s)).astype(np.float32)
    xs = rng.normal(size=(ns, n, s)).astype(np.float32)
    dists = torch.stack([op_pairwise_sqdist(T(qs[i]), T(xs[i])) for i in range(ns)])
    tau = pcol.kth_smallest(dists, 45)  # (Ns, m)
    got = sc_scores_fused(T(qs), T(xs), tau)
    want = (dists <= tau[..., None]).sum(0, dtype=torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    ref = np.asarray(j_sc_score_ref(jnp.asarray(qs), jnp.asarray(xs), jnp.asarray(tau.numpy())))
    border = (np.abs(dists.numpy() - tau.numpy()[..., None]) <= 2e-5 * tau.numpy()[..., None])
    diff = np.abs(got.numpy() - ref)
    assert (diff <= border.sum(0)).all()
    with pytest.raises(ValueError, match="xs must be"):
        sc_scores_fused(T(qs), T(xs[:, :, :4].copy()), tau)


@pytest.fixture(scope="module")
def clustered():
    x = gaussian_mixture(4000, 32, 0, n_clusters=32, spread=8.0)
    q = make_queries(x, 8, seed=1)
    return x, q


def test_sc_linear_beta_one_is_exact(clustered):
    x, q = clustered
    res = plin.sc_linear_query(
        T(x), T(q), spec=psub.contiguous_spec(32, 4), k=10, alpha=0.05, beta=1.0
    )
    gt_ids, gt_d = exact_knn(x, q, 10)
    assert recall(res.ids.numpy(), gt_ids) == 1.0
    assert res.ids.dtype == torch.int32 and res.scores.dtype == torch.int32
    np.testing.assert_allclose(res.dists.numpy(), gt_d, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_sc_linear_matches_the_reference(clustered, metric):
    x, q = clustered
    spec_j, spec_p = _specs(32, 4, None)
    kw = dict(k=10, alpha=0.05, beta=0.02, metric=metric)
    want = jlin.sc_linear_query(jnp.asarray(x), jnp.asarray(q), spec=spec_j, **kw)
    got = plin.sc_linear_query(T(x), T(q), spec=spec_p, **kw)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), rtol=2e-5)
    # the SC-scores of every point: equal except at borderline distances
    xs = jsub.split_padded(spec_j, jnp.asarray(x))
    qs = jsub.split_padded(spec_j, jnp.asarray(q))
    count = jsub.collision_count(4000, 0.05)
    j_scores = np.asarray(jlin.sc_scores_from_subspaces(xs, qs, count, metric))
    p_scores = plin.sc_scores_from_subspaces(T(np.array(xs)), T(np.array(qs)), count, metric)
    dist = np.stack([np.asarray(j_pairwise_dist(qs[i], xs[i], metric)) for i in range(4)])
    tau = np.asarray(jcol.kth_smallest(jnp.asarray(dist), count))[..., None]
    border = (np.abs(dist - tau) <= 2e-5 * tau).sum(0)
    mismatched = p_scores.numpy() != j_scores
    assert (np.abs(p_scores.numpy() - j_scores) <= border).all()
    assert mismatched.sum() <= 4, int(mismatched.sum())  # rare: a few ulp of 4000 * 8 points


def test_sc_linear_checks_k(clustered):
    x, q = clustered
    with pytest.raises(ValueError, match="k="):
        plin.sc_linear_query(T(x[:20]), T(q), spec=psub.contiguous_spec(32, 4), k=21,
                             alpha=0.5, beta=1.0)


# ------------------------------ rerank ---------------------------------------


def test_rerank_tie_breaking_matches_the_reference():
    """Duplicate points tie exactly in distance; both packages resolve the
    tie to the earlier pool position (higher score, then lower id)."""
    rng = np.random.default_rng(3)
    n, d, k = 24, 8, 6
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[9] = x[4]
    x[17] = x[4]
    x[11] = x[2]
    q = rng.normal(size=(2, d)).astype(np.float32)
    scores = rng.integers(0, 4, size=(2, n)).astype(np.int32)
    want = jlin.rerank(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scores), k, n_candidates=16)
    got = plin.rerank(T(x), T(q), T(scores), k, n_candidates=16)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), rtol=2e-5)
    vals, cand = jax.lax.top_k(jnp.asarray(scores), 16)
    via_pool = plin.rerank_candidates(T(x), T(q), T(np.array(cand)), T(np.array(vals)), k)
    for a, b in zip(via_pool, got):
        assert torch.equal(a, b)


def test_rerank_candidates_never_returns_a_masked_slot():
    x = np.zeros((6, 4), np.float32)  # every distance ties
    q = np.zeros((1, 4), np.float32)
    cand = np.array([[5, 4, 3, 2, 1, 0]], np.int32)
    cs = np.array([[-1, 2, -1, 2, 1, 0]], np.int32)
    want = jlin.rerank_candidates(jnp.asarray(x), jnp.asarray(q), jnp.asarray(cand),
                                  jnp.asarray(cs), 4)
    got = plin.rerank_candidates(T(x), T(q), T(cand), T(cs), 4)
    assert got.ids.tolist() == [[4, 2, 1, 0]] == np.asarray(want.ids).tolist()
    assert np.isinf(plin.rerank_candidates(T(x), T(q), T(cand), T(cs), 6).dists[0, -2:]).all()


# ------------------------------ pool merges ----------------------------------


def _lawful_blocks(rng, m, n, smax):
    """Scores 0..smax with dense ties over ids 0..n-1, cut into ascending-id
    chunks: the streaming invariant under which the reference's three
    merge methods are bit-compatible."""
    scores = rng.integers(0, smax + 1, size=(m, n)).astype(np.int32)
    ids = np.broadcast_to(np.arange(n, dtype=np.int32), (m, n))
    cuts, at = [], 0
    while at < n:
        step = int(rng.integers(1, n - at + 1))
        cuts.append((at, at + step))
        at += step
    return scores, ids, cuts


def _fold(merge, blocks, m, p, **kw):
    pool_s = np.full((m, p), -1, np.int32)
    pool_i = np.full((m, p), INT32_MAX, np.int32)
    for s, i in blocks:
        pool_s, pool_i = (np.asarray(a) for a in merge(pool_s, pool_i, s, i, **kw))
    return pool_s, pool_i


_j_merge_jit = jax.jit(jlin.merge_topk_pool, static_argnames=("impl", "smax"))


def _j_merge(ps, pi, s, i, **kw):
    return _j_merge_jit(*map(jnp.asarray, (ps, pi, s, i)), **kw)


def _p_merge(ps, pi, s, i, **kw):
    return plin.merge_topk_pool(*map(torch.from_numpy, (ps, pi, np.ascontiguousarray(s),
                                                         np.ascontiguousarray(i))), **kw)


@given(st.integers(0, 2**31 - 1), st.integers(1, 4), st.integers(1, 40), st.integers(1, 12))
@settings(max_examples=6, deadline=None)  # each new shape compiles the reference merges
def test_merge_topk_pool_chunking_invariant_equals_every_reference_merge(seed, m, n, p):
    """Any ascending-id chunking merges to the dense (score desc, id asc)
    top p, equal to the reference's topk, sort and counting merges,
    including pools wider than the data (sentinel tail)."""
    smax = 3
    scores, ids, cuts = _lawful_blocks(np.random.default_rng(seed), m, n, smax)
    blocks = [(scores[:, a:b], ids[:, a:b]) for a, b in cuts]
    got = _fold(_p_merge, blocks, m, p, smax=smax)
    for impl in ("topk", "sort", "counting"):
        want = _fold(_j_merge, blocks, m, p, impl=impl, smax=smax)
        np.testing.assert_array_equal(got[0], want[0], err_msg=impl)
        np.testing.assert_array_equal(got[1], want[1], err_msg=impl)
    order = [np.lexsort((ids[r], -scores[r]))[:p] for r in range(m)]
    dense = np.stack([scores[r][o] for r, o in enumerate(order)])
    np.testing.assert_array_equal(got[0][:, : dense.shape[1]], dense)


@given(st.integers(0, 2**31 - 1), st.integers(1, 4), st.integers(1, 40), st.integers(1, 12))
@settings(max_examples=4, deadline=None)
def test_merge_topk_pool_is_order_invariant_as_the_reference_sort(seed, m, n, p):
    """Blocks arriving in any order merge to the same pool: the port's one
    merge owes callers what the reference's ``impl="sort"`` does."""
    scores, ids, cuts = _lawful_blocks(np.random.default_rng(seed), m, n, 3)
    blocks = [(scores[:, a:b], ids[:, a:b]) for a, b in cuts]
    fwd = _fold(_p_merge, blocks, m, p, smax=3)
    rev = _fold(_p_merge, blocks[::-1], m, p, smax=3)
    want = _fold(_j_merge, blocks[::-1], m, p, impl="sort")
    for a, b, c in zip(fwd, rev, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)


@given(st.integers(0, 2**31 - 1), st.integers(1, 4), st.integers(1, 40), st.integers(1, 12))
@settings(max_examples=4, deadline=None)
def test_merge_topk_pool_is_idempotent_on_an_exhausted_stream(seed, m, n, p):
    scores, ids, cuts = _lawful_blocks(np.random.default_rng(seed), m, n, 3)
    pool = _fold(_p_merge, [(scores[:, a:b], ids[:, a:b]) for a, b in cuts], m, p, smax=3)
    sent_s = np.full((m, 7), -1, np.int32)
    sent_i = np.full((m, 7), INT32_MAX, np.int32)
    again = pool
    for _ in range(2):
        again = tuple(a.numpy() for a in _p_merge(*again, sent_s, sent_i, smax=3))
        want = tuple(np.asarray(a) for a in _j_merge(*pool, sent_s, sent_i, impl="counting", smax=3))
        np.testing.assert_array_equal(again[0], want[0])
    np.testing.assert_array_equal(again[0], pool[0])
    np.testing.assert_array_equal(again[1], pool[1])


# --------------------------- Dynamic Activation -------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_dynamic_activation_loop_equals_the_sort_prefix_and_the_reference(seed):
    rng = np.random.default_rng(seed)
    k1 = 12
    d1 = rng.gamma(2.0, size=k1).astype(np.float32)
    d2 = rng.gamma(2.0, size=k1).astype(np.float32)
    counts = rng.integers(0, 9, size=k1 * k1).astype(np.int32)
    for target in (1, 40, int(counts.sum()), int(counts.sum()) + 5):
        sorted_mask = psuco.activate_cells_sorted(T(d1), T(d2), T(counts), target)
        loop_mask = psuco.dynamic_activation_lax(T(d1), T(d2), T(counts), target)
        j_args = (jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(counts), target)
        np.testing.assert_array_equal(sorted_mask.numpy(),
                                      np.asarray(jsuco.activate_cells_sorted(*j_args)))
        np.testing.assert_array_equal(loop_mask.numpy(),
                                      np.asarray(jsuco.dynamic_activation_lax(*j_args)))
        assert torch.equal(sorted_mask, loop_mask)
