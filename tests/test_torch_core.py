"""Parity of the port's core modules (``repro_torch.core``) with the JAX
package, on the CPU: the same numpy inputs go through both.

Subspace specs and views, the rowwise centroid distances and the Dynamic
Activation ranks and cuts must be bit-identical; the pool merge must equal
the JAX merge (every ``merge_impl``) and the lexicographic (score desc,
id asc) reference; the autotuner must pick the same chunk and cap from the
same memory limits.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import subspace as jsub
from repro.core import suco as jsuco
from repro.core import tuning as jtuning
from repro.core.distances import _sqdist_rowwise, rowwise_candidate_dist
from repro.core.sc_linear import merge_topk_pool_with_dists as jmerge

from repro_torch.core import subspace as psub
from repro_torch.core import suco as psuco
from repro_torch.core import tuning as ptuning
from repro_torch.core.distances import rowwise_candidate_dist as p_candidate_dist
from repro_torch.core.distances import sqdist_rowwise
from repro_torch.core.sc_linear import (
    INT32_MAX,
    candidate_pool_size,
    merge_topk_pool_with_dists,
)


@pytest.mark.parametrize("d,ns,seed", [(32, 8, None), (30, 4, 3), (128, 8, 7)])
def test_subspace_specs_and_half_views_match(d, ns, seed):
    if seed is None:
        js, ps = jsub.contiguous_spec(d, ns), psub.contiguous_spec(d, ns)
    else:
        js, ps = jsub.sampled_spec(d, ns, seed), psub.sampled_spec(d, ns, seed)
    assert (js.perm, js.bounds, js.half_sizes) == (ps.perm, ps.bounds, ps.half_sizes)
    x = np.random.default_rng(0).normal(size=(5, d)).astype(np.float32)
    jh = jsub.split_halves_padded(js, jsub.permute(js, jnp.asarray(x)))
    ph = psub.split_halves_padded(ps, psub.permute(ps, torch.from_numpy(x)))
    for a, b in zip(jh, ph):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert psub.collision_count(1000, 0.05) == jsub.collision_count(1000, 0.05)
    with pytest.raises(ValueError):
        psub.collision_count(10, 0.0)


@pytest.mark.parametrize("h", [1, 4, 8, 16])
def test_rowwise_sqdist_is_bitwise_the_jax_centroid_distance(h):
    rng = np.random.default_rng(h)
    q = rng.normal(size=(3, 7, h)).astype(np.float32) * 4
    c = rng.normal(size=(3, 16, h)).astype(np.float32) * 4
    want = np.stack([np.asarray(_sqdist_rowwise(jnp.asarray(a), jnp.asarray(b)))
                     for a, b in zip(q, c)])
    got = sqdist_rowwise(torch.from_numpy(q), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
    # padding rows onto the batch never changes a row's distances
    qp = np.concatenate([q, np.zeros((3, 5, h), np.float32)], axis=1)
    got_p = sqdist_rowwise(torch.from_numpy(qp), torch.from_numpy(c)).numpy()[:, :7]
    np.testing.assert_array_equal(got_p, got)


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_candidate_distances_match(metric):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    xc = rng.normal(size=(4, 9, 32)).astype(np.float32)
    want = np.asarray(rowwise_candidate_dist(jnp.asarray(q), jnp.asarray(xc), metric))
    got = p_candidate_dist(torch.from_numpy(q), torch.from_numpy(xc), metric).numpy()
    # sums of 32 non-negative fp32 terms in another order: <= d * 2^-24 relative
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_candidate_pool_size_matches():
    from repro.core.sc_linear import candidate_pool_size as jpool

    for n, k, beta in [(1000, 10, 0.02), (50, 10, 0.01), (100, 5, 2.0), (0, 1, 0.5)]:
        assert candidate_pool_size(n, k, beta) == jpool(n, k, beta)
    with pytest.raises(ValueError):
        candidate_pool_size(10, 0, 0.1)


def _lawful_pool(rng, m, p, smax, id_hi):
    """A pool as the merge carries it: sorted (score desc, id asc), the
    sentinels (-1, INT32_MAX, +inf) last."""
    s = rng.integers(-1, smax + 1, size=(m, p)).astype(np.int32)
    i = np.stack([rng.choice(id_hi, p, replace=False) for _ in range(m)]).astype(np.int32)
    i = np.where(s < 0, INT32_MAX, i)
    order = np.stack([np.lexsort((ir, -sr)) for sr, ir in zip(s, i)])
    s = np.take_along_axis(s, order, 1)
    i = np.take_along_axis(i, order, 1)
    d = rng.random((m, p)).astype(np.float32)
    d = np.where(s < 0, np.inf, d).astype(np.float32)
    return s, d, i


@pytest.mark.parametrize("seed", range(6))
def test_merge_matches_jax_and_the_lexicographic_order(seed):
    rng = np.random.default_rng(seed)
    m, smax = 3, 4
    p, b = int(rng.integers(1, 12)), int(rng.integers(1, 20))
    ps, pd, pi = _lawful_pool(rng, m, p, smax, 1000)
    # block ids all exceed pool ids (the streaming invariant), dense ties
    bs = rng.integers(-1, smax + 1, size=(m, b)).astype(np.int32)
    bi = (1000 + np.arange(b)[None, :].repeat(m, 0)).astype(np.int32)
    bi = np.where(bs < 0, INT32_MAX, bi).astype(np.int32)
    bd = np.where(bs < 0, np.inf, rng.random((m, b))).astype(np.float32)
    got = merge_topk_pool_with_dists(*map(torch.from_numpy, (ps, pd, pi, bs, bd, bi)), smax=smax)
    got = [t.numpy() for t in got]
    for impl in ("topk", "counting", "sort"):
        want = jmerge(*map(jnp.asarray, (ps, pd, pi, bs, bd, bi)), impl=impl, smax=smax)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    cs, ci = np.concatenate([ps, bs], 1), np.concatenate([pi, bi], 1)
    for r in range(m):
        order = np.lexsort((ci[r], -cs[r]))[:p]
        np.testing.assert_array_equal(got[0][r], cs[r][order])
        np.testing.assert_array_equal(got[2][r], ci[r][order])


def test_autotune_matches_jax_from_the_same_limits():
    for fast in (2 * 2**20, 50 * 2**20):
        jl = jtuning.MemoryLimits(fast_bytes=fast, hbm_bytes=80 * 2**30)
        pl = ptuning.MemoryLimits(fast_bytes=fast, hbm_bytes=80 * 2**30)
        for n, d, m, pool in [(1_000_000, 128, 64, 20_000), (50_000, 128, 8, 1000),
                              (1_000_000, 128, 1, 20_000), (32_768, 16, 1, 33)]:
            jt = jtuning.autotune_tiles(n, d, m, pool, limits=jl)
            pt = ptuning.autotune_tiles(n, d, m, pool, limits=pl)
            assert (pt.block_n, pt.survivor_cap) == (jt.block_n, jt.survivor_cap)
        for n, d, sk in [(1_000_000, 128, 50), (20_000, 32, 16)]:
            assert ptuning.autotune_build_block_n(n, d, sqrt_k=sk, limits=pl) == (
                jtuning.autotune_build_block_n(n, d, sqrt_k=sk, limits=jl)
            )
    assert ptuning.device_limits("cpu") == ptuning.CPU_LIMITS
    with pytest.raises(ValueError):
        ptuning.TileConfig(block_n=0)


@pytest.mark.parametrize("seed,target", [(0, 50), (1, 400), (2, 10**9)])
def test_cell_ranks_and_cuts_are_exact_given_jax_distances(seed, target):
    rng = np.random.default_rng(seed)
    ns, m, sk = 4, 5, 12
    # coarse values: many exact ties in d1 + d2, broken by cell id
    d1 = rng.integers(0, 6, size=(ns, m, sk)).astype(np.float32)
    d2 = rng.integers(0, 6, size=(ns, m, sk)).astype(np.float32)
    counts = rng.integers(0, 20, size=(ns, sk * sk)).astype(np.int32)
    want_r, want_c = jax.vmap(
        lambda a, b, c: jax.vmap(lambda x, y: jsuco._cell_ranks_and_cut(x, y, c, target))(a, b)
    )(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(counts))
    got_r, got_c = psuco._cell_ranks_and_cut(
        torch.from_numpy(d1), torch.from_numpy(d2), torch.from_numpy(counts)[:, None, :], target
    )
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_r.dtype == torch.int32 and got_c.dtype == torch.int32


def test_batch_bucket_matches():
    for m in (1, 3, 8, 9, 64, 65, 200):
        assert psuco.batch_bucket(m) == jsuco.batch_bucket(m)
    with pytest.raises(ValueError):
        psuco.batch_bucket(0)
