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


# --------------------------------------------------------------------------
# Row 9 on the card is a 3xTF32 screen with an exact re-check near tau: its
# margin, held to its derivation by an emulation of the screen in fp64
# --------------------------------------------------------------------------


def _f32(a):
    return np.asarray(a, dtype=np.float64).astype(np.float32).astype(np.float64)


def _tf32(a):
    """The kernel's TF32 cut (``split_trunc``) on the float32 bits: the 13
    low mantissa bits cleared, 10 left (toward zero)."""
    b = np.asarray(a, dtype=np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)


def _fused_screen_emulated(q, x):
    """Row 9's screen distance ``d~ (m, n)`` of one subspace, emulated in
    fp64: both operands split ``a = big + small`` (``big = tf32(a)``, ``small
    = tf32(a - big)``, each cut to TF32 as the kernel cuts them); per 16-dim step and per 8-dim k-step (dims 4t, 4t + 1
    then 4t + 2, 4t + 3, t < 4: the kernel's grouping) the small x big,
    big x small and big x big products (exact) each added to an fp32
    accumulator with one rounding; the norms fp32 sums in dim order (the
    plain version's bits); ``t = fl(qn + xn)``, ``d~ = max(fl(t - 2 c~),
    0)``.  Returns ``(d~, t)``."""
    qd, xd = q.astype(np.float64), x.astype(np.float64)
    qb, xb = _tf32(qd), _tf32(xd)
    qsm, xsm = _tf32(_f32(qd - qb)), _tf32(_f32(xd - xb))
    s = q.shape[1]
    acc = np.zeros((q.shape[0], x.shape[0]))
    for k16 in range(0, s, 16):
        for step in (0, 1):
            dims = [k16 + 4 * t + 2 * step + e for t in range(4) for e in (0, 1)]
            for a, b in ((qsm, xb), (qb, xsm), (qb, xb)):
                for i in (i for i in dims if i < s):
                    acc = _f32(acc + a[:, i, None] * b[None, :, i])
    qn, xn = np.zeros(len(q)), np.zeros(len(x))
    for i in range(s):
        qn, xn = _f32(qn + _f32(qd[:, i] ** 2)), _f32(xn + _f32(xd[:, i] ** 2))
    t = _f32(qn[:, None] + xn[None])
    return np.maximum(_f32(t - 2.0 * acc), 0.0), t, qn, xn


def _fused_adversarial(kind, s, seed):
    """``(q (12, s), x (300, s))`` float32: ``normal``; ``offset_1e3`` (1e3 +
    N(0, 1)); ``near_2^-126`` (magnitudes 2^-126 .. 2^-123, every square
    flushed to 0 in fp32); ``squares_near_2^-126`` (magnitudes 2^-64 ..
    2^-62: squares and products in fp32's subnormal range); ``near_1e18``
    (norms near and past the screen's 2^125 guard at s >= 16);
    ``q_equals_x`` (each query one of the points, and points repeated)."""
    rng = np.random.default_rng(seed)
    m, n = 12, 300
    sign = lambda shape: rng.choice([-1.0, 1.0], shape)  # noqa: E731
    if kind == "normal":
        q, x = rng.normal(size=(m, s)) * 3, rng.normal(size=(n, s)) * 3
    elif kind == "offset_1e3":
        q, x = 1e3 + rng.normal(size=(m, s)), 1e3 + rng.normal(size=(n, s))
    elif kind == "near_2^-126":
        q = sign((m, s)) * 2.0**-126 * rng.uniform(1, 8, (m, s))
        x = sign((n, s)) * 2.0**-126 * rng.uniform(1, 8, (n, s))
    elif kind == "squares_near_2^-126":
        q = sign((m, s)) * 2.0**-64 * rng.uniform(1, 4, (m, s))
        x = sign((n, s)) * 2.0**-64 * rng.uniform(1, 4, (n, s))
    elif kind == "near_1e18":  # rows scaled 0.5 .. 2.5: at s = 16 some norms pass 2^125
        q = rng.normal(size=(m, s)) * 1e18 * rng.uniform(0.5, 2.5, (m, 1))
        x = rng.normal(size=(n, s)) * 1e18 * rng.uniform(0.5, 2.5, (n, 1))
    else:  # q_equals_x
        x = np.round(rng.normal(size=(n, s)) * 30) / 8
        x[n // 2:] = x[: n - n // 2]
        q = x[rng.choice(n, m, replace=False)]
    return q.astype(np.float32), x.astype(np.float32)


FUSED_KINDS = ["normal", "offset_1e3", "near_2^-126", "squares_near_2^-126", "near_1e18",
               "q_equals_x"]


@pytest.mark.parametrize("kind", FUSED_KINDS)
@pytest.mark.parametrize("s", [1, 3, 16, 130])
def test_fused_screen_margin_holds_the_emulated_screen_to_its_derivation(s, kind):
    """|d~ - d_plain| <= E_s t + eta_s / 8 = delta / 8 for every pair whose
    norms lie below the guard (``FUSED_NORM_LIMIT``; the others take the
    re-check); and the kernel's decision rule on those distances, in fp32
    -- count where fl(d~ + delta) <= tau, leave out where fl(d~ - delta) >
    tau, re-check the rest in the plain arithmetic -- gives the plain
    version's counts, with tau the 5%-th smallest plain distance (a pair at
    tau in every row) and with tau = 0.  A common offset re-checks every
    pair."""
    from repro_torch.kernels.pairwise_l2.ref import pairwise_sqdist_ref
    from repro_torch.kernels.sc_score import kernel as score_kernel

    q, x = _fused_adversarial(kind, s, seed=s)
    with np.errstate(over="ignore", invalid="ignore"):
        d_t, t, qn, xn = _fused_screen_emulated(q, x)
    d = pairwise_sqdist_ref(T(q), T(x)).double().numpy()
    mu = float(np.float32(score_kernel.fused_screen_margin(s)))
    eta = float(np.float32(score_kernel.fused_screen_floor(s)))
    lim = score_kernel.FUSED_NORM_LIMIT
    screened = (qn[:, None] <= lim) & (xn[None, :] <= lim)
    delta = _f32(mu * t + eta)
    with np.errstate(invalid="ignore"):
        ratio = np.abs(d_t - d) / delta
    assert np.isfinite(ratio[screened]).all()
    assert (ratio[screened] <= 1 / 8).all(), float(ratio[screened].max())
    delta = np.where(screened, delta, np.nan)  # a norm past the guard: NaN
    at_tau = np.argsort(d, axis=1, kind="stable")[:, 14]
    for tau in (d[np.arange(len(q)), at_tau], np.zeros(len(q))):
        with np.errstate(invalid="ignore"):
            count = _f32(d_t + delta) <= tau[:, None]
            recheck = ~count & ~(_f32(d_t - delta) > tau[:, None])
        got = np.where(recheck, d <= tau[:, None], count)
        want = pairwise_sqdist_ref(T(q), T(x)).numpy() <= tau.astype(np.float32)[:, None]
        np.testing.assert_array_equal(got, want)
    # the pair at the threshold is always re-checked (here tau = 0: every
    # pair at 0, duplicates and q = x included)
    assert recheck[d == 0].all()
    tau = d[np.arange(len(q)), at_tau]
    with np.errstate(invalid="ignore"):
        assert (~(_f32(d_t + delta) <= tau[:, None]) & ~(_f32(d_t - delta) > tau[:, None]))[
            np.arange(len(q)), at_tau].all()
    if kind == "offset_1e3" and s >= 16:
        assert recheck.all()
    if kind == "near_1e18" and s == 16:
        assert 0 < screened.mean() < 1


def _source_header():
    from repro_torch.kernels import _build

    return (_build.CSRC / "sc_score_fused.cu").read_text()


@pytest.mark.parametrize("s", [1, 3, 16, 130, 1000])
def test_fused_screen_margin_states_the_source_header(s):
    """``fused_screen_margin`` and ``fused_screen_floor`` give the constants
    the header of csrc/sc_score_fused.cu derives (E_s = (5 s + 60) u, mu_s =
    8 E_s, eta_s = s 2^-119) and cover its first-order bound, and the
    wrapper's guard and tile are the ones the kernel is compiled with."""
    import re

    from repro_torch.kernels.sc_score import kernel as score_kernel

    src = _source_header()
    a, b = map(int, re.search(r"E_s = \((\d+) s \+ (\d+)\) u", src).groups())
    f = int(re.search(r"passes mu_s = (\d+) E_s", src).group(1))
    e = int(re.search(r"eta_s = s 2\^-(\d+)", src).group(1))
    assert score_kernel.fused_screen_margin(s) == f * (a * s + b) * 2.0**-24
    assert score_kernel.fused_screen_floor(s) == s * 2.0**-e
    c1, c0 = map(int, re.search(r"Together \|d~ - d_plain\| <= \((\d+) s \+ (\d+)\) u N",
                                src).groups())
    assert a * s + b >= c1 * s + c0  # the statement covers the first-order bound
    lim = int(re.search(r"kNormLimit = 0x1p(\d+)f", src).group(1))
    assert score_kernel.FUSED_NORM_LIMIT == 2.0**lim
    bm = re.search(r"kBM = kWM \* kMT \* 16;\s+// query rows of a group: (\d+)", src)
    bn = re.search(r"kBN = kWN \* kNT \* 8;\s+// points of a tile: (\d+)", src)
    wm, wn, mt, nt = (int(re.search(rf"{k} = (\d+)", src).group(1))
                      for k in ("kWM", "kWN", "kMT", "kNT"))
    assert (score_kernel.FUSED_QUERIES, score_kernel.FUSED_POINTS) == (
        wm * mt * 16, wn * nt * 8) == (int(bm.group(1)), int(bn.group(1)))


def test_fused_grid_and_copy_width():
    """One block a work item (64 queries x 128 points); 16-byte copies only
    for 16-byte aligned views with strides of whole 16-byte words; the op's
    limits on m, n and the blocks are the source's, where a block's row
    indices stay C ints and the grid fits its x extent."""
    from repro_torch.kernels.sc_score import kernel as score_kernel
    from repro_torch.kernels.sc_score import ops as score_ops

    fb = score_kernel.fused_blocks
    assert (fb(1, 1), fb(64, 128), fb(65, 129), fb(64, 1_000_000)) == (1, 1, 4, 7813)
    assert fb(10**6, 10**9) == 15_625 * 7_812_500
    w = torch.zeros(10, 132)  # rows of 132 floats: 16-byte aligned views at dim 4
    aligned = w[:, 4:132].unflatten(1, (8, 16)).movedim(1, 0)
    assert score_kernel.fused_vec(aligned, aligned) == 4
    assert score_kernel.fused_vec(aligned, w[:, 1:129].unflatten(1, (8, 16)).movedim(1, 0)) == 1
    odd = torch.zeros(10, 133)[:, 4:132].unflatten(1, (8, 16)).movedim(1, 0)  # rows of 133
    assert score_kernel.fused_vec(odd, aligned) == 1
    narrow = w[:, 4:124].unflatten(1, (8, 15)).movedim(1, 0)  # subspaces 15 floats apart
    assert score_kernel.fused_vec(narrow, narrow) == 1
    src = _source_header()
    assert "kMaxRows = INT_MAX - kBM + 1, kMaxPoints = INT_MAX - kBN + 1;" in src
    assert "work > INT_MAX" in src
    int_max = 2**31 - 1
    assert score_ops.MAX_FUSED_ROWS == int_max - score_kernel.FUSED_QUERIES + 1
    assert score_ops.MAX_FUSED_POINTS == int_max - score_kernel.FUSED_POINTS + 1
    assert score_ops.MAX_FUSED_BLOCKS == int_max
    # the last block's rows and points are ints at the limits
    assert -(-score_ops.MAX_FUSED_ROWS // 64) * 64 - 1 <= int_max
    assert -(-score_ops.MAX_FUSED_POINTS // 128) * 128 - 1 <= int_max


def test_sc_scores_fused_refuses_more_rows_than_its_limit(monkeypatch):
    from repro_torch.kernels.sc_score import ops as score_ops

    monkeypatch.setattr(score_ops, "MAX_FUSED_ROWS", 4)
    qs, xs, tau = torch.zeros(2, 5, 3), torch.zeros(2, 7, 3), torch.zeros(2, 5)
    with pytest.raises(ValueError, match="exceeds the kernel's 4 query rows"):
        score_ops.sc_scores_fused(qs, xs, tau)
    assert score_ops.sc_scores_fused(qs[:, :4], xs, tau[:, :4].contiguous()).shape == (4, 7)


@pytest.mark.parametrize("limit,value,match", [
    ("MAX_FUSED_POINTS", 6, "n=7 exceeds the kernel's 6 points"),
    ("MAX_FUSED_BLOCKS", 3, "m=65 x n=129 exceeds the kernel's 3 blocks of 64 x 128"),
])
def test_sc_scores_fused_refuses_points_and_blocks_past_its_limits(monkeypatch, limit, value,
                                                                   match):
    """Past ``MAX_FUSED_POINTS`` a column index would leave the C int, past
    ``MAX_FUSED_BLOCKS`` the grid its x extent: the op refuses, on the CPU
    as on the card, and takes the shape one short of the limit."""
    from repro_torch.kernels.sc_score import ops as score_ops

    monkeypatch.setattr(score_ops, limit, value)
    m, n = (5, 7) if limit == "MAX_FUSED_POINTS" else (65, 129)
    qs, xs, tau = torch.zeros(2, m, 3), torch.zeros(2, n, 3), torch.zeros(2, m)
    with pytest.raises(ValueError, match=match):
        score_ops.sc_scores_fused(qs, xs, tau)
    fits = xs[:, :6] if limit == "MAX_FUSED_POINTS" else xs[:, :128]
    assert score_ops.sc_scores_fused(qs, fits, tau).shape == (m, fits.shape[1])


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
