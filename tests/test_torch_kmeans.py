"""The port's K-means library against the JAX package's, on the CPU.

* **Assignment kernels** (rows 5 and 6 of the kernel table): the port's
  plain versions against the JAX Pallas kernels in interpret mode, exactly
  on integer-valued data (both arithmetics are exact there) and, on float
  data, equal except at near-ties: points whose two nearest centroids lie
  within ``1e-5 * (|x|^2 + |c|^2)`` of each other in float64 (the JAX
  kernels sum by the matmul identity, the port dim by dim).
* **Training**: ``kmeans`` / ``kmeans_batched`` in dense and chunked
  Lloyd and minibatch, fed the JAX package's own draws (its initial
  centroids, and for minibatch its samples ``randint(fold_in(key, t))``):
  centroids within ``1e-5``, assignments equal on data whose ties are far
  apart, inertia within ``1e-5`` relative.
* **Wide shapes** (rows 3-5 past ``s = 64`` or shared memory): the plain
  versions against the Pallas kernels in interpret mode on integer data
  (exact), and ``kmeans`` / ``kmeans_batched`` at d = 65..128 against the
  JAX package fed its own initial centroids.
* **Skewed statistics** (row 3 at the (s, k) of its three shapes on the
  card): one centroid taking every point, most centroids empty, a ragged
  last chunk; exact on integer data against the Pallas kernel.
* **The screens of rows 6, 5 and 4** (the card's kernels): their arithmetic
  emulated in fp64 on adversarial inputs stays within ``delta_p / 8`` of the
  plain distances, with the margin the wrapper passes, and each kernel's
  re-check rule on it gives the plain argmins.  Row 4's op also equals the
  Pallas kernel in interpret mode at the build's layout.
* **Helpers**: the chunking helpers and the paired histogram (the padded
  tail counts nothing), kmeans++ seeding, the argument checks.
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

from repro.core import kmeans as jkm
from repro.kernels.kmeans_assign.ops import kmeans_assign as j_assign
from repro.kernels.kmeans_assign.ops import kmeans_assign_batched as j_assign_batched
from repro.kernels.kmeans_assign.ops import kmeans_assign_stats as j_stats
from repro.kernels.kmeans_assign.ops import kmeans_pair_assign_hist as j_pair_hist

from _stats_cases import KINDS, SHAPES, skewed
from repro_torch import kernels
from repro_torch.core import kmeans as pkm
from repro_torch.data import gaussian_mixture
from repro_torch.kernels.kmeans_assign import ops as kmeans_ops

T = torch.from_numpy


def _near_tie(x, c, rel=1e-5):
    """``x: (n, s)``, ``c: (k, s)`` -> (n,) bool: the float64 gap between
    the two nearest centroids is below ``rel * (|x|^2 + |c|^2)``."""
    xd, cd = x.astype(np.float64), c.astype(np.float64)
    d2 = ((xd[:, None, :] - cd[None]) ** 2).sum(-1)
    if d2.shape[1] < 2:
        return np.zeros(len(x), bool)
    two = np.sort(d2, axis=1)[:, :2]
    scale = (xd**2).sum(1) + (cd**2).sum(1)[np.argmin(d2, axis=1)]
    return two[:, 1] - two[:, 0] < rel * scale


def _assert_assign_equal(got, want, x, c):
    """Equal, or a near-tie of ``x`` against ``c``."""
    diff = got != want
    assert not diff.any() or _near_tie(x[diff], c).all()


# --------------------------------------------------------------------------
# Rows 5 and 6: the assignment kernels' plain versions
# --------------------------------------------------------------------------


@settings(max_examples=12, deadline=None)
@given(n=st.integers(1, 300), k=st.integers(1, 80), s=st.integers(1, 40),
       seed=st.integers(0, 99), integer=st.booleans())
def test_kmeans_assign_matches_the_jax_kernel(n, k, s, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-6, 7, size=(n, s)).astype(np.float32)
        c = rng.integers(-6, 7, size=(k, s)).astype(np.float32)
    else:
        x = rng.normal(size=(n, s)).astype(np.float32)
        c = rng.normal(size=(k, s)).astype(np.float32)
    want = np.asarray(j_assign(jnp.asarray(x), jnp.asarray(c), interpret=True))
    got = kmeans_ops.kmeans_assign(T(x), T(c))
    assert got.dtype == torch.int32 and got.shape == (n,)
    if integer:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _assert_assign_equal(got.numpy(), want, x, c)


@settings(max_examples=10, deadline=None)
@given(b=st.integers(1, 6), n=st.integers(1, 200), k=st.integers(1, 60),
       s=st.integers(1, 30), block_n=st.integers(1, 256), seed=st.integers(0, 99))
def test_kmeans_assign_batched_matches_the_jax_kernel(b, n, k, s, block_n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-6, 7, size=(b, n, s)).astype(np.float32)
    c = rng.integers(-6, 7, size=(b, k, s)).astype(np.float32)
    want = j_assign_batched(jnp.asarray(x), jnp.asarray(c), bn=64, impl="pallas", interpret=True)
    got = kmeans_ops.kmeans_assign_batched(T(x), T(c), block_n=block_n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("integer", [True, False])
def test_kmeans_assign_batched_on_float_data(integer):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 900, 9)).astype(np.float32) * 4
    c = rng.normal(size=(4, 37, 9)).astype(np.float32) * 4
    if integer:
        x, c = np.round(x), np.round(c)
    want = np.asarray(j_assign_batched(jnp.asarray(x), jnp.asarray(c), impl="jnp"))
    got = kmeans_ops.kmeans_assign_batched(T(x), T(c), block_n=128).numpy()
    for i in range(4):
        if integer:
            np.testing.assert_array_equal(got[i], want[i])
        else:
            _assert_assign_equal(got[i], want[i], x[i], c[i])


def test_kmeans_assign_at_full_width_beyond_one_tile():
    """s = 128 and k = 300: wider than the kernel's 32-dim slice and more
    centroids than its 32-row tile, neither a multiple of the plain
    version's 4096-point chunk."""
    x = gaussian_mixture(5000, 128, 4)
    c = x[np.random.default_rng(5).choice(5000, 300, replace=False)] + 0.5
    want = np.asarray(j_assign(jnp.asarray(x), jnp.asarray(c), interpret=True))
    got = pkm.assign(T(x), T(c))
    _assert_assign_equal(got.numpy(), want, x, c)
    xi, ci = np.round(x), np.round(c)
    want_i = np.asarray(j_assign(jnp.asarray(xi), jnp.asarray(ci), interpret=True))
    np.testing.assert_array_equal(pkm.assign(T(xi), T(ci)).numpy(), want_i)


def test_assignment_ties_go_to_the_lowest_index():
    x = torch.zeros((5, 3))
    c = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    assert (kmeans_ops.kmeans_assign(x, c) == 0).all()
    assert (kmeans_ops.kmeans_assign_batched(x[None], c[None], block_n=2) == 0).all()


# --------------------------------------------------------------------------
# Rows 6 and 5-wide on the card: the screen's margin, held to its derivation
# --------------------------------------------------------------------------


def _f32(a):
    return a.astype(np.float32).astype(np.float64)


def _tf32(a):
    """fp32 values (held in fp64) rounded to TF32: nearest, ties away from
    zero, on 10 mantissa bits (11 significant), as cvt.rna.tf32.f32."""
    m, e = np.frexp(a)
    return np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5), e - 11)


def _screen_emulated(x, c):
    """The screened kernel's distances ``(n, k)`` emulated in fp64: the TF32
    split of both operands; per 8-dim k-step (in each 16 dims, dims 4t, 4t+1
    and then 4t+2, 4t+3 for t < 4, the kernel's grouping) the small x big,
    big x small and big x big products (exact), each added to an fp32
    accumulator with one rounding; fp32 norms summed in dim order; then
    ``(nx + nc) - 2 x.c``."""
    xd, cd = x.astype(np.float64), c.astype(np.float64)
    xb, cb = _tf32(xd), _tf32(cd)
    xs, cs = _tf32(xd - xb), _tf32(cd - cb)
    s = x.shape[1]
    acc = np.zeros((x.shape[0], c.shape[0]))
    for k16 in range(0, s, 16):
        for step in (0, 1):
            dims = [k16 + 4 * t + 2 * step + e for t in range(4) for e in (0, 1)]
            for a, b in ((xs, cb), (xb, cs), (xb, cb)):
                for i in (i for i in dims if i < s):
                    acc = _f32(acc + a[:, i, None] * b[None, :, i])
    nx, nc = np.zeros(len(x)), np.zeros(len(c))
    for i in range(s):
        nx, nc = _f32(nx + _f32(xd[:, i] ** 2)), _f32(nc + _f32(cd[:, i] ** 2))
    return _f32(_f32(nx[:, None] + nc[None]) - 2.0 * acc)


def _adversarial(kind, s, seed):
    """``(x (48, s), c (40, s))`` float32: values up to 1e4; a common offset of
    1e3 with a spread of 1; duplicated centroids and centroids mirrored about
    points (equidistant pairs); integer-valued."""
    rng = np.random.default_rng(seed)
    n, k = 48, 40
    if kind == "uniform_1e4":
        x, c = rng.uniform(-1e4, 1e4, (n, s)), rng.uniform(-1e4, 1e4, (k, s))
    elif kind == "offset_1e3":
        x, c = 1e3 + rng.normal(size=(n, s)), 1e3 + rng.normal(size=(k, s))
    elif kind == "integer":
        x, c = rng.integers(-50, 51, (n, s)), rng.integers(-50, 51, (k, s))
    elif kind == "far_clusters":  # 4 clusters 1e3 from the origin: |x| >> |x - c|
        centers = rng.normal(size=(4, s))
        centers *= 1e3 / np.linalg.norm(centers, axis=1, keepdims=True)
        c = centers[rng.integers(0, 4, k)] + rng.normal(size=(k, s))
        x = c[rng.integers(0, k, n)] + 0.3 * rng.normal(size=(n, s))
    else:  # duplicated and mirrored: c[2i + 1] = 2 x[i] - c[2i], c[30:] = c[:10]
        x = rng.normal(size=(n, s)) * 30
        v = rng.normal(size=(k // 2, s)) * 30
        x[: k // 2] = np.round(x[: k // 2])  # x +- v exactly in fp32
        v = np.round(v)
        c = np.empty((k, s))
        c[0::2], c[1::2] = x[: k // 2] + v, x[: k // 2] - v
        c[30:] = c[:10]
    return x.astype(np.float32), c.astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform_1e4", "offset_1e3", "mirrored_duplicates", "integer"])
@pytest.mark.parametrize("s", [1, 5, 128, 130, 300])
def test_screen_margin_holds_the_emulated_screen_to_its_derivation(s, kind):
    """|screen - d_plain| <= delta_p / 8 = E_s (|x_p|^2 + max |c|^2) with the
    mu_s the wrapper passes (``screen_margin``); and the kernel's one-pass
    rule on those distances gives the plain version's argmins, ties
    included: tiles of 64 centroids; after each, the running minimum m
    takes the tile's and every a_j <= m + delta_p joins the point's list of
    8 (past 8 it is re-checked at once); at the end the listed a_j still
    <= m + delta_p are re-checked.  A large common offset re-checks nearly
    every pair."""
    from repro_torch.core.distances import sqdist_rowwise
    from repro_torch.kernels.kmeans_assign.kernel import screen_margin

    x, c = _adversarial(kind, s, seed=s)
    a = _screen_emulated(x, c)
    d = sqdist_rowwise(T(x), T(c)).double().numpy()
    big = (x.astype(np.float64) ** 2).sum(1) + (c.astype(np.float64) ** 2).sum(1).max()
    delta = screen_margin(s) * big
    ratio = np.abs(a - d) / delta[:, None]
    assert (ratio <= 1 / 8).all(), float(ratio.max())
    # the kernel's rule, tile by tile
    m = np.full(len(x), np.inf)
    best = np.full(len(x), -1)
    bestd = np.full(len(x), np.inf)
    listed = [[] for _ in x]
    rechecks = 0

    def recheck(p, j):
        nonlocal rechecks
        rechecks += 1
        if d[p, j] < bestd[p] or (d[p, j] == bestd[p] and j < best[p]):
            best[p], bestd[p] = j, d[p, j]

    for j0 in range(0, len(c), 64):
        tile = a[:, j0:j0 + 64]
        m = np.minimum(m, tile.min(1))
        for p, jj in zip(*np.nonzero(tile <= (m + delta)[:, None])):
            if len(listed[p]) < 8:
                listed[p].append(j0 + jj)
            else:
                recheck(p, j0 + jj)
    for p, js in enumerate(listed):
        for j in js:
            if a[p, j] <= m[p] + delta[p]:
                recheck(p, j)
    np.testing.assert_array_equal(best, kmeans_ops.kmeans_assign(T(x), T(c)).numpy())
    if kind == "offset_1e3" and s >= 128:
        assert rechecks > 0.9 * a.size


def _frag_dim(ks, kk, kf):
    """The dim fragment column ``kf`` of k-step ``kk`` carries in the narrow
    kernel (``frag_dim`` in the source)."""
    if ks == 1:
        return kf
    return 16 * (kk >> 1) + 4 * (kf & 3) + 2 * (kk & 1) + (kf >> 2)


def _narrow_screen_emulated(x, c):
    """The narrow kernel's screen values ``t (n, k) = x.c_j - |c_j|^2 / 2``
    emulated in fp64: fp32 ``|c_j|^2`` summed in dim order, halved (exact);
    the TF32 split of both operands; dims zero-padded to 8 KS; per k-step
    the small x big, big x small and big x big products of its 8 dims (the
    source's ``frag_dim`` map), each added to the fp32 accumulator, which
    starts at ``-|c_j|^2 / 2``, with one rounding."""
    xd, cd = x.astype(np.float64), c.astype(np.float64)
    s = x.shape[1]
    ks = 1 if s <= 8 else 2 if s <= 16 else 4 if s <= 32 else 8
    xb, cb = _tf32(xd), _tf32(cd)
    xs, cs = _tf32(xd - xb), _tf32(cd - cb)
    cn = np.zeros(len(c))
    for i in range(s):
        cn = _f32(cn + _f32(cd[:, i] ** 2))
    acc = np.broadcast_to(-cn / 2, (len(x), len(c))).copy()
    for kk in range(ks):
        dims = [d for d in (_frag_dim(ks, kk, kf) for kf in range(8)) if d < s]
        for a, b in ((xs, cb), (xb, cs), (xb, cb)):
            for i in dims:
                acc = _f32(acc + a[:, i, None] * b[None, :, i])
    return acc


@pytest.mark.parametrize("kind", ["uniform_1e4", "offset_1e3", "mirrored_duplicates", "integer"])
@pytest.mark.parametrize("s", [1, 5, 16, 17, 64])
def test_narrow_margin_holds_the_emulated_screen_to_its_derivation(s, kind):
    """The narrow kernel (row 5 at s <= 64): its screen distance ``|x_p|^2 -
    2 t_j`` within ``delta_p / 8`` of the plain distance, with the
    ``narrow_margin`` the wrapper passes; and its decision rule on those
    values gives the plain argmins, ties included.  The rule: centroid j
    belongs to lane ``(j % 8) // 2`` of its point's quad; each lane keeps its
    largest t (the first on ties) and its second largest; lim = the largest
    t - delta_p / 2; the lanes at or above lim hold the candidates.  If a
    lane's second largest is at or above lim too, every centroid is
    re-checked; else one candidate is the argmin and several are re-checked
    (the least (d, j)).  A large common offset re-checks nearly every
    point."""
    from repro_torch.core.distances import sqdist_rowwise
    from repro_torch.kernels.kmeans_assign.kernel import narrow_margin

    x, c = _adversarial(kind, s, seed=s + 1)
    t = _narrow_screen_emulated(x, c)
    d = sqdist_rowwise(T(x), T(c)).double().numpy()
    nx = (x.astype(np.float64) ** 2).sum(1)
    big = nx + (c.astype(np.float64) ** 2).sum(1).max()
    delta = narrow_margin(s) * big
    ratio = np.abs(nx[:, None] - 2 * t - d) / delta[:, None]
    assert (ratio <= 1 / 8).all(), float(ratio.max())
    lane = (np.arange(len(c)) % 8) // 2
    got = np.empty(len(x), dtype=np.int64)
    whole = 0
    for p in range(len(x)):
        lim = t[p].max() - delta[p] / 2
        cands, unsettled = [], False
        for q in range(4):
            js = np.nonzero(lane == q)[0]
            if not len(js):
                continue
            vals = t[p, js]
            top = js[np.argmax(vals)]  # the first of the largest, as the kernel's strict >
            if t[p, top] >= lim:
                cands.append(top)
            unsettled |= len(js) > 1 and np.sort(vals)[-2] >= lim
        if unsettled:
            whole += 1
            got[p] = np.argmin(d[p])
        else:
            got[p] = min(cands, key=lambda j: (d[p, j], j))
    want = kmeans_ops.kmeans_assign_batched(T(x)[None], T(c)[None], block_n=16).numpy()[0]
    np.testing.assert_array_equal(got, want)
    if kind == "offset_1e3" and s >= 16:
        assert whole > 0.9 * len(x)


def _pair_screen_emulated(x, c):
    """The narrow pair kernel's screen values ``t (n, k) = x.c_j - |c_j|^2 /
    2`` emulated in fp64: fp32 ``|c_j|^2`` summed in dim order, halved
    (exact); then per dim in order one fused multiply-add, the exact product
    added to the fp32 accumulator with one rounding to fp32 (after fp64's
    own, far below it)."""
    xd, cd = x.astype(np.float64), c.astype(np.float64)
    cn = np.zeros(len(c))
    for i in range(x.shape[1]):
        cn = _f32(cn + _f32(cd[:, i] ** 2))
    t = np.broadcast_to(-cn / 2, (len(x), len(c))).copy()
    for i in range(x.shape[1]):
        t = _f32(xd[:, i, None] * cd[None, :, i] + t)
    return t


@pytest.mark.parametrize("kind", ["uniform_1e4", "offset_1e3", "far_clusters",
                                  "mirrored_duplicates", "integer"])
@pytest.mark.parametrize("s", [1, 3, 8, 16, 33, 64])
def test_pair_margin_holds_the_emulated_ffma_screen(s, kind):
    """Row 4's narrow kernel: its screen distance ``|x_p|^2 - 2 t_j`` (an
    FFMA chain from ``-|c_j|^2 / 2``) within ``delta_p / 8`` of the plain
    distance with the ``narrow_margin`` the wrapper passes (the derivation
    gives delta_p / 16; exactness needs delta_p / 2); and its rule on those
    values gives the op's outputs: a point whose runner-up t lies below
    ``lim = max t - delta_p / 2`` takes the first index of the largest t,
    any other point the plain argmin.  Far clusters (|x| >> |x - c|, the
    worst cancellation) and a large common offset re-check most points;
    integer data, duplicated and mirrored centroids give exact ties.  The
    pair layout: the case, then its rows and centroids reversed."""
    from repro_torch.core.distances import sqdist_rowwise
    from repro_torch.kernels.kmeans_assign.kernel import narrow_margin

    x, c = _adversarial(kind, s, seed=s + 2)
    xs, cs = np.stack([x, x[::-1]]), np.stack([c, c[::-1]])
    got = []
    whole = 0
    for h in range(2):
        t = _pair_screen_emulated(xs[h], cs[h])
        d = sqdist_rowwise(T(xs[h].copy()), T(cs[h].copy())).double().numpy()
        nx = (xs[h].astype(np.float64) ** 2).sum(1)
        delta = narrow_margin(s) * (nx + (cs[h].astype(np.float64) ** 2).sum(1).max())
        ratio = np.abs(nx[:, None] - 2 * t - d) / delta[:, None]
        assert (ratio <= 1 / 8).all(), float(ratio.max())
        runner_up = np.sort(t, axis=1)[:, -2]
        settled = runner_up < t.max(1) - delta / 2
        whole += int((~settled).sum())
        got.append(np.where(settled, np.argmax(t, axis=1), np.argmin(d, axis=1)))
    a, counts = kmeans_ops.kmeans_pair_assign_hist(T(xs.copy()), T(cs.copy()), block_n=17)
    np.testing.assert_array_equal(a.numpy(), np.stack(got))
    k = c.shape[0]
    np.testing.assert_array_equal(counts.numpy()[0], np.bincount(got[0] * k + got[1],
                                                                 minlength=k * k))
    if kind in ("offset_1e3", "far_clusters") and s >= 8:
        assert whole > 0.9 * 2 * len(x)


@pytest.mark.parametrize("kind", ["integer", "nan"])
def test_pair_assign_hist_matches_the_jax_kernel_at_the_build_layout(kind):
    """Row 4's op on the CPU (its plain version, which the card is held to)
    against the Pallas kernel in interpret mode at the SuCo build's layout,
    Ns = 8 (16 half-subspace codebooks), s = 8, k = 50, on integer data
    (exact in both arithmetics, ties included) and with NaN entries (a NaN
    centroid in codebook 0, NaN points in codebook 1); n off the Pallas
    kernel's chunk and the op's odd block_n."""
    b, n, k, s = 16, 2_500, 50, 8
    if kind == "nan":
        x, c = _nan_data(b, n, k, s, seed=26)
    else:
        rng = np.random.default_rng(26)
        x = rng.integers(-4, 5, size=(b, n, s)).astype(np.float32)
        c = rng.integers(-4, 5, size=(b, k, s)).astype(np.float32)
    ja, jcounts = j_pair_hist(jnp.asarray(x), jnp.asarray(c), bn=256, impl="pallas",
                              interpret=True)
    a, counts = kmeans_ops.kmeans_pair_assign_hist(T(x), T(c), block_n=999)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.shape == (b // 2, k * k) and int(counts.sum()) == b // 2 * n


# --------------------------------------------------------------------------
# Rows 3-6 on NaN data: the plain versions against the Pallas kernels in
# interpret mode.  torch.argmin and jnp.argmin both take the first NaN
# distance (a NaN point goes to centroid 0, a NaN centroid takes every point
# of its codebook); integer-valued finite entries, so both arithmetics are
# exact elsewhere.
# --------------------------------------------------------------------------


def _nan_data(b, n, k, s, seed):
    """``(x (b, n, s), c (b, k, s))`` integer-valued, with NaN entries:
    codebook 0 has a NaN centroid, codebook 1 NaN points (every 7th), the
    rest are clean."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-5, 6, size=(b, n, s)).astype(np.float32)
    c = rng.integers(-5, 6, size=(b, k, s)).astype(np.float32)
    c[0, k // 2, s - 1] = np.nan
    x[1, ::7, 0] = np.nan
    return x, c


@pytest.mark.parametrize("row", [3, 4, 5, 6])
def test_plain_versions_match_the_jax_kernels_on_nan_data(row):
    b, n, k, s = 4, 300, 23, 5
    x, c = _nan_data(b, n, k, s, seed=row)
    jx, jc = jnp.asarray(x), jnp.asarray(c)
    if row == 3:
        ja, jsums, jcounts, jinertia = j_stats(jx, jc, bn=64, impl="pallas", interpret=True)
        a, sums, counts, inertia = kmeans_ops.kmeans_stats(T(x), T(c), block_n=100,
                                                           with_assign=True)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        np.testing.assert_array_equal(inertia.numpy(), np.asarray(jinertia))
        # a NaN point's coordinates reach every centroid's sums through the
        # Pallas kernel's one-hot product (NaN * 0), and only its own here
        keep = [i for i in range(b) if i != 1]
        np.testing.assert_array_equal(sums.numpy()[keep], np.asarray(jsums)[keep])
        assert (a.numpy()[0] == k // 2).all() and (a.numpy()[1, ::7] == 0).all()
        assert np.isnan(inertia.numpy()[:2]).all()
    elif row == 4:
        ja, jcounts = j_pair_hist(jx, jc, bn=64, impl="pallas", interpret=True)
        a, counts = kmeans_ops.kmeans_pair_assign_hist(T(x), T(c), block_n=100)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    elif row == 5:
        want = j_assign_batched(jx, jc, bn=64, impl="pallas", interpret=True)
        got = kmeans_ops.kmeans_assign_batched(T(x), T(c), block_n=100)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        for i in range(2):
            want = j_assign(jnp.asarray(x[i]), jnp.asarray(c[i]), interpret=True)
            got = kmeans_ops.kmeans_assign(T(x[i]), T(c[i]))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# Rows 3-5 at the shapes their wide variants take (s > 64, k*s past shared
# memory), against the Pallas kernels in interpret mode.  Integer-valued
# data: both arithmetics are exact there, so assignments, sums, counts and
# inertia must be equal, ties included.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("s,k", [(65, 300), (65, 1024), (128, 300), (128, 1024)])
def test_wide_stats_and_batched_assign_match_the_jax_kernels(s, k):
    rng = np.random.default_rng(s + k)
    b, n = 2, 2500
    x = rng.integers(-4, 5, size=(b, n, s)).astype(np.float32)
    c = rng.integers(-4, 5, size=(b, k, s)).astype(np.float32)
    ja, jsums, jcounts, jinertia = j_stats(jnp.asarray(x), jnp.asarray(c), bn=1024,
                                           impl="pallas", interpret=True)
    a, sums, counts, inertia = kmeans_ops.kmeans_stats(T(x), T(c), block_n=700, with_assign=True)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(sums.numpy(), np.asarray(jsums))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(inertia.numpy(), np.asarray(jinertia))
    want = j_assign_batched(jnp.asarray(x), jnp.asarray(c), bn=1024, impl="pallas",
                            interpret=True)
    got = kmeans_ops.kmeans_assign_batched(T(x), T(c), block_n=700)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s,k", SHAPES)
def test_stats_on_skewed_data_match_the_jax_kernel(s, k, kind):
    """Row 3 at the (s, k) of its three shapes on the card (the build's
    half-subspaces, PQ8x8, IVF1024) on skewed integer data: every point on
    one centroid, most centroids empty, points over all of them; n = 700 is
    off both chunkings (300 here, 256 there), so each has a ragged last
    chunk.  The card's tests hold both kernel variants to this plain version
    on the same inputs."""
    b, n = 2, 700
    x, c = skewed(kind, b, n, k, s, seed=s + k)
    ja, jsums, jcounts, jinertia = j_stats(jnp.asarray(x), jnp.asarray(c), bn=256,
                                           impl="pallas", interpret=True)
    a, sums, counts, inertia = kmeans_ops.kmeans_stats(T(x), T(c), block_n=300, with_assign=True)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(sums.numpy(), np.asarray(jsums))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(inertia.numpy(), np.asarray(jinertia))
    used = (counts > 0).sum(1)
    if kind == "one_takes_all":
        assert (used == 1).all() and (counts.max(1).values == n).all()
    elif kind == "most_empty":
        assert (used <= 3).all()


@pytest.mark.parametrize("s", [16, 65])
def test_pair_assign_hist_past_shared_memory_matches_the_jax_kernel(s):
    """sqrt_k = 240: a 57,600-cell histogram per subspace, past what the
    narrow kernel holds in shared memory."""
    rng = np.random.default_rng(s)
    ns, n, k = 2, 3000, 240
    x = rng.integers(-3, 4, size=(2 * ns, n, s)).astype(np.float32)
    c = rng.integers(-3, 4, size=(2 * ns, k, s)).astype(np.float32)
    ja, jcounts = j_pair_hist(jnp.asarray(x), jnp.asarray(c), bn=1024, impl="pallas",
                              interpret=True)
    a, counts = kmeans_ops.kmeans_pair_assign_hist(T(x), T(c), block_n=1000)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.shape == (ns, k * k) and int(counts.sum()) == ns * n


@pytest.mark.parametrize("block_n", [0, 700])
def test_kmeans_at_d128_matches_jax_with_its_draws(block_n):
    """IVF-style training at SIFT's width: one problem at d = 128."""
    n, d, k, iters = 3000, 128, 16, 5
    x = _mixture(n, d, 10, seed=21)
    key = jax.random.key(11)
    want = jkm.kmeans(key, jnp.asarray(x), k, iters, block_n=block_n)
    c0 = np.asarray(jkm._init_centroids(key, jnp.asarray(x), k))
    got = pkm.kmeans(T(x), k, iters, block_n=block_n, init_centroids=T(c0))
    _close(got, want)


@pytest.mark.parametrize("s", [65, 96, 128])
def test_kmeans_batched_at_wide_subspaces_matches_jax(s):
    b, n, k, iters = 2, 2000, 12, 4
    xs = np.stack([_mixture(n, s, 8, seed=30 + i) for i in range(b)])
    key = jax.random.key(s)
    want = jkm.kmeans_batched(key, jnp.asarray(xs), k, iters, block_n=600)
    c0 = np.asarray(jkm._init_batched(key, jnp.asarray(xs), k, "auto", "lloyd"))
    got = pkm.kmeans_batched(T(xs), k, iters, block_n=600, init_centroids=T(c0))
    _close(got, want)


# --------------------------------------------------------------------------
# Training against the JAX package with its own draws
# --------------------------------------------------------------------------


def _mixture(n, s, k_true, seed=0, spread=3.0):
    """A gaussian mixture near the origin: its norms are small beside the
    gaps between competing centroids, so the two arithmetics pick the same
    argmin."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k_true, s)) * spread
    who = rng.integers(0, k_true, n)
    return (centers[who] + rng.normal(size=(n, s))).astype(np.float32)


def _samples(key, iters, bn, n):
    """The JAX package's minibatch samples (``kmeans.py`` ``mb_body``)."""
    return np.stack([np.asarray(jax.random.randint(jax.random.fold_in(key, t), (bn,), 0, n))
                     for t in range(iters)])


def _close(got, want):
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.assignments.numpy(), np.asarray(want.assignments))
    np.testing.assert_allclose(got.inertia.numpy(), np.asarray(want.inertia), rtol=1e-5)


@pytest.mark.parametrize("algo,block_n", [
    ("lloyd", 0), ("lloyd", 500), ("lloyd", 333), ("minibatch", 512), ("minibatch", 0),
])
def test_kmeans_matches_jax_with_its_draws(algo, block_n):
    """block_n = 500 divides n = 3000, 333 does not (a padded tail);
    minibatch at block_n = 0 samples the default 4096 (> n: all n)."""
    n, s, k, iters = 3000, 6, 12, 6
    x = _mixture(n, s, 9)
    key = jax.random.key(3)
    want = jkm.kmeans(key, jnp.asarray(x), k, iters, algo=algo, block_n=block_n)
    if algo == "minibatch":
        bn = min(block_n or 4096, n)
        c0 = jkm.init_centroids_pp(key, jnp.asarray(x), k, sample_n=jkm._PP_SAMPLE_MIN)
        sample = T(_samples(key, iters, bn, n))
    else:
        c0, sample = jkm._init_centroids(key, jnp.asarray(x), k), None
    got = pkm.kmeans(T(x), k, iters, algo=algo, block_n=block_n,
                     init_centroids=T(np.asarray(c0)), sample_idx=sample)
    assert got.assignments.dtype == torch.int32 and got.cell_counts is None
    _close(got, want)


@pytest.mark.parametrize("algo,block_n,pair", [
    ("lloyd", 0, 0), ("lloyd", 700, 0), ("lloyd", 1000, 8), ("minibatch", 600, 8),
    ("minibatch", 600, 0),
])
def test_kmeans_batched_matches_jax_with_its_draws(algo, block_n, pair):
    b, n, s, k, iters = 4, 2000, 5, 8, 5
    xs = np.stack([_mixture(n, s, 6, seed=i) for i in range(b)])
    key = jax.random.key(7)
    want = jkm.kmeans_batched(key, jnp.asarray(xs), k, iters, algo=algo, block_n=block_n,
                              pair_sqrt_k=pair)
    c0 = np.asarray(jkm._init_batched(key, jnp.asarray(xs), k, "auto", algo))
    sample = T(_samples(key, iters, block_n, n)) if algo == "minibatch" else None
    kernels.reset_launch_counts()
    got = pkm.kmeans_batched(T(xs), k, iters, algo=algo, block_n=block_n, pair_sqrt_k=pair,
                             init_centroids=T(c0), sample_idx=sample)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)  # the CPU: no kernel
    _close(got, want)
    if pair:
        np.testing.assert_array_equal(got.cell_counts.numpy(), np.asarray(want.cell_counts))
    else:
        assert got.cell_counts is None and want.cell_counts is None


@pytest.mark.parametrize("block_n", [0, 256, 999])
def test_lloyd_dense_and_chunked_agree_in_the_port(block_n):
    """Integer data and centroids: every sum is exact, so the dense and the
    chunked passes give the same bits; float data the same assignments."""
    rng = np.random.default_rng(8)
    xs = rng.integers(-20, 21, size=(2, 2500, 4)).astype(np.float32)
    c0 = xs[:, :10].copy()
    kw = dict(init_centroids=T(c0), pair_sqrt_k=10)
    dense = pkm.kmeans_batched(T(xs), 10, 1, block_n=0, **kw)
    chunk = pkm.kmeans_batched(T(xs), 10, 1, block_n=block_n, **kw)
    for a, b in zip(dense, chunk):
        assert torch.equal(a, b)
    x = _mixture(2500, 6, 7)
    dense = pkm.kmeans(T(x), 9, 5, init_centroids=T(x[:9]))
    chunk = pkm.kmeans(T(x), 9, 5, block_n=block_n or 512, init_centroids=T(x[:9]))
    assert torch.equal(dense.assignments, chunk.assignments)
    torch.testing.assert_close(dense.centroids, chunk.centroids, rtol=1e-5, atol=1e-5)


def test_empty_clusters_keep_their_centroid():
    x = np.repeat(np.eye(3, dtype=np.float32), 50, axis=0)
    c0 = np.concatenate([np.eye(3, dtype=np.float32), np.full((2, 3), 50.0, np.float32)])
    for block_n in (0, 40):
        res = pkm.kmeans(T(x), 5, 3, block_n=block_n, init_centroids=T(c0))
        np.testing.assert_array_equal(res.centroids.numpy(), c0)
        assert torch.isfinite(res.centroids).all()


# --------------------------------------------------------------------------
# Chunking helpers and the paired histogram
# --------------------------------------------------------------------------


@pytest.mark.parametrize("block_n", [64, 100, 300])
def test_assign_scan_pair_histogram_counts_nothing_from_the_padded_tail(block_n):
    """n = 700: block_n = 100 divides it; 64 and 300 leave a padded tail of
    4 and 200 zero rows, which would all land in one cell if counted."""
    rng = np.random.default_rng(9)
    xs = rng.integers(-5, 6, size=(6, 700, 3)).astype(np.float32)
    c = rng.integers(-5, 6, size=(6, 7, 3)).astype(np.float32)
    jb, jv = jkm.block_batched(jnp.asarray(xs), block_n)
    ja, jin, jcounts = jkm.assign_scan(jb, jv, jnp.asarray(c), pair_sqrt_k=7)
    pb, pv = pkm.block_batched(T(xs), block_n)
    assert pb.shape == tuple(jb.shape) and torch.equal(pv, T(np.asarray(jv)))
    pa, pin, pcounts = pkm.assign_scan(pb, pv, T(c), pair_sqrt_k=7)
    np.testing.assert_array_equal(pa[:, :700].numpy(), np.asarray(ja)[:, :700])
    np.testing.assert_array_equal(pcounts.numpy(), np.asarray(jcounts))
    assert int(pcounts.sum()) == 3 * 700
    np.testing.assert_array_equal(pin.numpy(), np.asarray(jin))  # integers: exact
    # the card's route: an integer bincount of the assignments
    np.testing.assert_array_equal(pkm.pair_cell_counts(pa[:, :700], 7).numpy(),
                                  np.asarray(jcounts))
    sums, counts, inertia = pkm.lloyd_stats_scan(pb, pv, T(c))
    js, jc, ji = jkm.lloyd_stats_scan(jb, jv, jnp.asarray(c))
    for g, w in ((sums, js), (counts, jc), (inertia, ji)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# kmeans++ seeding
# --------------------------------------------------------------------------


def _start_inertia(x, c):
    return float(((x[:, None, :] - c[None]) ** 2).sum(-1).min(1).values.sum())


def test_kmeanspp_is_deterministic_per_seed_and_honours_sample_n():
    x = T(gaussian_mixture(3000, 8, 1))
    g = lambda seed: torch.Generator().manual_seed(seed)
    a = pkm.init_centroids_pp(x, 12, sample_n=200, generator=g(4))
    assert torch.equal(a, pkm.init_centroids_pp(x, 12, sample_n=200, generator=g(4)))
    assert not torch.equal(a, pkm.init_centroids_pp(x, 12, sample_n=200, generator=g(5)))
    sample = x[torch.randperm(3000, generator=g(4))[:200]]  # the first draw of the seeding
    assert all((sample == row).all(1).any() for row in a)
    assert len({tuple(r.tolist()) for r in a}) == 12  # D^2 never redraws a seed


def test_kmeanspp_never_starts_worse_than_random_on_average():
    """The guarantee is an expectation, so the mean over 8 seeds, on
    clustered data with as many clusters as seeds (the regime D^2 seeding
    is for; with 256 clusters or none at the scale of 12 seeds the two
    starts are alike, and either may win)."""
    k = 12
    for x in (gaussian_mixture(3000, 16, 0, n_clusters=k), _mixture(3000, 16, k),
              _mixture(3000, 8, k, seed=1, spread=6.0)):
        x = T(x)
        rand, pp = [], []
        for seed in range(8):
            g = torch.Generator().manual_seed(seed)
            rand.append(_start_inertia(x, pkm.init_random(x[None], k, g)[0]))
            g = torch.Generator().manual_seed(seed)
            pp.append(_start_inertia(x, pkm.init_centroids_pp(x, k, generator=g)))
        assert np.mean(pp) <= np.mean(rand)


def test_init_auto_is_kmeanspp_for_minibatch_and_random_for_lloyd():
    xs = T(np.stack([_mixture(1500, 8, 6, seed=i) for i in range(3)]))
    g = lambda: torch.Generator().manual_seed(5)
    for algo, mode in (("minibatch", "kmeans++"), ("lloyd", "random")):
        auto = pkm.kmeans_batched(xs, 6, 2, algo=algo, block_n=256, generator=g())
        explicit = pkm.kmeans_batched(xs, 6, 2, algo=algo, block_n=256, init=mode, generator=g())
        assert torch.equal(auto.centroids, explicit.centroids)
    # minibatch samples block_n points; kmeans++ from min(n, max(32k, 2048)) rows
    res = pkm.kmeans_batched(xs, 6, 3, algo="minibatch", block_n=256, generator=g())
    assert res.inertia.shape == (3,) and res.assignments.shape == (3, 1500)


# --------------------------------------------------------------------------
# Argument checks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(algo="elkan"), "algo must be one of"),
    (dict(block_n=-1), r"block_n must be >= 0 \(0 = dense\)"),
    (dict(init="forgy"), "init must be one of"),
])
def test_check_args_messages_match_the_jax_package(kw, match):
    x = T(_mixture(100, 4, 3))
    args = dict(dict(algo="lloyd", block_n=0, init="auto"), **kw)
    with pytest.raises(ValueError, match=match):
        jkm._check_args(args["algo"], args["block_n"], args["init"])
    with pytest.raises(ValueError, match=match):
        pkm.kmeans(x, 3, 1, generator=torch.Generator(), **kw)
    with pytest.raises(ValueError, match=match):
        pkm.kmeans_batched(x[None], 3, 1, generator=torch.Generator(), **kw)


def test_draws_need_a_generator_or_injected_draws():
    x = T(_mixture(100, 4, 3))
    with pytest.raises(ValueError, match="generator"):
        pkm.kmeans(x, 3, 1)
    with pytest.raises(ValueError, match="generator"):
        pkm.kmeans(x, 3, 1, algo="minibatch", init_centroids=x[:3])
    with pytest.raises(ValueError, match="sample_idx"):
        pkm.kmeans(x, 3, 2, algo="minibatch", block_n=10, init_centroids=x[:3],
                   sample_idx=torch.zeros((1, 10), dtype=torch.long))
    with pytest.raises(ValueError, match="init_centroids"):
        pkm.kmeans(x, 3, 1, init_centroids=x[:2])


@pytest.mark.parametrize("case", range(5))
def test_assignment_ops_check_arguments(case):
    x, c = torch.zeros((2, 10, 4)), torch.zeros((2, 3, 4))
    calls = [
        (TypeError, lambda: kmeans_ops.kmeans_assign(x[0].double(), c[0])),
        (ValueError, lambda: kmeans_ops.kmeans_assign(x[0], c[0, :, :3].contiguous())),
        (ValueError, lambda: kmeans_ops.kmeans_assign(x[0].t(), c[0])),
        (ValueError, lambda: kmeans_ops.kmeans_assign_batched(x, c, block_n=0)),
        (ValueError, lambda: kmeans_ops.kmeans_assign_batched(
            torch.zeros((1, 5, 8)), torch.zeros((2, 7, 8)), block_n=4)),
    ]
    exc, call = calls[case]
    with pytest.raises(exc):
        call()
