"""The port's competitor baselines (``repro_torch.baselines``) against the
JAX package's numpy ones (``repro.baselines``), on the CPU, at n = 2,000,
d = 32, 20 queries, k = 10, for each of the five classes:

* **state**: the port's build from the same data and seed holds the
  reference's state (the same random draws, so the same seed rows, planes,
  offsets, multipliers and hyperplanes, bit for bit), except where an fp32
  value the two packages sum in another order lies within a few ulp of the
  threshold it is compared with: a nearest-centroid argmin (IVF, IMI-PQ),
  ``floor((a.x + b) / w)`` (E2LSH), a median split (RP-forest).  Each such
  point is counted (:func:`_near_tie`, ``REL`` of the value; a median
  split's projection, which cancels, within ``GAMMA_D`` of the sum of its
  terms' magnitudes) and at most ``MAX_BOUNDARY`` are allowed; every other
  point sits where the reference put it;
* **queries on the reference's state** (``from_state``): ids equal, except
  at a rank where the two answers' exact distances tie (``REL``);
* **recall** of the port's own build within 0.02 of the reference's;
* ``memory_bytes`` equal for equal state.
"""

import numpy as np
import pytest
import torch

from repro import baselines as R
from repro_torch import baselines as P
from repro_torch.data import exact_knn, gaussian_mixture, make_queries, recall

N, D, M, K = 2000, 32, 20, 10
REL = 1e-5  # a few fp32 ulps of the compared value
MAX_BOUNDARY = 2  # 0.1% of the points

#: (reference class, port class, constructor args, query args) at fig9_12's
#: parameters, scaled to n = 2,000
CASES = {
    "ivf": (R.IVFFlat, P.IVFFlat, (32, 5), dict(nprobe=8)),
    "lsh": (R.E2LSH, P.E2LSH, (8, 10), dict(threshold=1)),
    "imi_pq": (R.IMIPQ, P.IMIPQ, (16, 5), dict(n_candidates=200)),
    "rpforest": (R.RPForest, P.RPForest, (10, 64), dict()),
    "hnsw": (R.HNSWLite, P.HNSWLite, (12, 48), dict(ef_search=64)),
}


@pytest.fixture(scope="module")
def data():
    x = gaussian_mixture(N, D, 0)
    q = make_queries(x, M, seed=1)
    return x, q, exact_knn(x, q, K)[0]


@pytest.fixture(scope="module")
def built(data):
    x = data[0]
    out = {}
    for name, (rc, pc, args, _) in CASES.items():
        kw = {} if name == "hnsw" else dict(device="cpu")
        out[name] = rc(*args).build(x), pc(*args, **kw).build(torch.from_numpy(x))
    return out


def _near_tie(a, b):
    """Where two fp32 values of the same comparison lie within ``REL`` of
    each other (either side of a threshold, or two candidates' distances)."""
    return np.abs(np.asarray(a, np.float64) - b) <= REL * np.maximum(np.abs(a), np.abs(b))


def _sqdist64(x, ids, q):
    return ((x[ids].astype(np.float64) - q.astype(np.float64)[:, None, :]) ** 2).sum(-1)


def _assert_ids_equal_but_ties(x, q, got, want):
    got = np.asarray(got)
    assert got.shape == want.shape and got.dtype == np.int64
    diff = got != want
    tied = _near_tie(_sqdist64(x, got, q), _sqdist64(x, want, q))
    assert (tied | ~diff).all(), np.argwhere(diff & ~tied)[:5]


def _moved(own, ref, ok):
    """Indices where ``own`` and ``ref`` differ; each must satisfy ``ok``
    (a near tie) and there may be at most ``MAX_BOUNDARY``."""
    moved = np.flatnonzero(np.asarray(own) != np.asarray(ref))
    assert len(moved) <= MAX_BOUNDARY, len(moved)
    assert all(ok(i) for i in moved), moved
    return moved


def _assign_near_tie(xs, c, a_ref, a_own):
    """Point ``i``'s two cells are equally near within ``REL`` (the
    reference's centroids, fp64)."""
    def ok(i):
        d = ((c[[a_ref[i], a_own[i]]].astype(np.float64) - xs[i]) ** 2).sum(1)
        return _near_tie(d[0], d[1])
    return ok


def _cells(lists, n):
    a = np.empty(n, np.int64)
    for j, ids in enumerate(lists):
        a[ids] = j
    return a


def test_ivf_state(data, built):
    x = data[0]
    ref, own = built["ivf"]
    moved = _moved(_cells(own.lists, N), _cells(ref.lists, N),
                   _assign_near_tie(x, ref.centroids, _cells(ref.lists, N), _cells(own.lists, N)))
    if not len(moved):
        np.testing.assert_allclose(own.centroids.numpy(), ref.centroids, rtol=REL, atol=1e-6)


def test_lsh_state(data, built):
    x = data[0]
    ref, own = built["lsh"]
    for name in ("a", "b", "mult"):
        assert np.array_equal(getattr(own, name).numpy(), getattr(ref, name)), name
    proj = np.einsum("lkd,nd->lnk", ref.a.astype(np.float64), x) + ref.b[:, None, :]
    v = proj / ref.w  # (L, n, K): a code flips only where v is near an integer
    for li, tab in enumerate(ref.tables):
        want = np.empty(N, np.int64)
        for h, ids in tab.items():
            want[ids] = h
        got = np.empty(N, np.int64)
        got[own.ids[li].numpy()] = own.hashes[li].numpy()
        _moved(got, want, lambda i: _near_tie(v[li, i], np.round(v[li, i])).any())


def test_imi_pq_state(data, built):
    x = data[0]
    ref, own = built["imi_pq"]
    h = D // 2
    cell_ref = _cells(np.split(ref.sorted_ids, ref.offsets[1:-1]), N)
    cell_own = _cells(np.split(own.sorted_ids.numpy(), own.offsets[1:-1].numpy()), N)

    def ok(i):
        a, b = divmod(cell_ref[i], own.sqrt_k), divmod(cell_own[i], own.sqrt_k)
        return (_assign_near_tie(x[:, :h], ref.c1, [a[0]] * N, [b[0]] * N)(i)
                or _assign_near_tie(x[:, h:], ref.c2, [a[1]] * N, [b[1]] * N)(i))

    if not len(_moved(cell_own, cell_ref, ok)):
        for c_ref, c_own in ((ref.c1, own.c1), (ref.c2, own.c2)):
            np.testing.assert_allclose(c_own.numpy(), c_ref, rtol=REL, atol=1e-6)
        assert np.array_equal(own.counts.numpy(), ref.counts)


def _splits(tree):
    """Every split of a reference tree: its hyperplane, offset and the ids
    of the points under it."""
    out = []

    def walk(nd):
        if nd.ids is not None:
            return nd.ids
        ids = np.concatenate([walk(nd.left), walk(nd.right)])
        out.append((nd.w, nd.b, ids))
        return ids

    walk(tree)
    return out


def _own_splits(rp):
    """Every split of the port's forest: ``(w, b, ids under it)``."""
    left, right = rp.left.numpy(), rp.right.numpy()
    start, size, leaf = rp.leaf_start.numpy(), rp.leaf_size_.numpy(), rp.leaf_ids.numpy()
    w, b = rp.w.numpy(), rp.b.numpy()
    out = []

    def walk(i):
        if left[i] < 0:
            return leaf[start[i]:start[i] + size[i]]
        ids = np.concatenate([walk(left[i]), walk(right[i])])
        out.append((w[i], b[i], ids))
        return ids

    for root in rp.roots.numpy():
        walk(root)
    return out


#: gamma_D = D u / (1 - D u), u = 2^-24: a D-term fp32 dot product in any
#: order lies within gamma_D * sum |x_i w_i| of its exact value
GAMMA_D = D * 2.0**-24 / (1 - D * 2.0**-24)


def _median_bound(x, ids, w):
    """``(median, bound)``: the fp64 median of the projections ``x[ids] @ w``
    (the middle one, or the mean of the two middle ones, as ``np.median``),
    and how far an fp32 evaluation of it may lie: gamma_D * sum |x_i w_i| of
    its median point or points, and the rounding of the mean."""
    terms = x[ids].astype(np.float64) * np.asarray(w, np.float64)
    proj, size = terms.sum(1), np.abs(terms).sum(1)
    order = np.argsort(proj, kind="stable")
    h = len(ids) // 2
    mid = order[[h]] if len(ids) % 2 else order[[h - 1, h]]
    med = proj[mid].mean()
    return med, GAMMA_D * size[mid].max() + 2.0**-24 * abs(med)


def test_rpforest_state(data, built):
    """The same hyperplanes bit for bit; each offset within its fp32 bound
    of the exact median of its node's projections (two packages that sum
    the D terms in another order part by up to gamma_D * sum |x_i w_i|,
    which at a cancelling projection is far more than a few ulp of the
    offset); each tree a partition; a point in another leaf than the
    reference put it lies within the same bounds of some split."""
    x = data[0]
    ref, own = built["rpforest"]
    back = P.RPForest.from_state(x, ref.trees, leaf_size=64, device="cpu")
    assert torch.equal(back.left, own.left) and torch.equal(back.right, own.right)
    assert torch.equal(back.w, own.w)  # the same draws, in the same order
    for w, b, ids in _own_splits(own):
        med, bound = _median_bound(x, ids, w)
        assert abs(float(b) - med) <= bound, (float(b), med, bound)
    got = np.sort(own.leaf_ids.numpy().reshape(own.n_trees, N), axis=1)
    assert (got == np.arange(N)).all()  # each tree partitions the points
    moved = np.flatnonzero(own.leaf_ids.numpy() != back.leaf_ids.numpy())
    splits = [s for tree in ref.trees for s in _splits(tree)]
    if len(moved):
        # a point in another leaf lies within its own and the offset's bounds of some split
        def near(i, w, b, ids):
            w64 = np.asarray(w, np.float64)
            reach = GAMMA_D * np.abs(x[i] * w64).sum() + 2 * _median_bound(x, ids, w)[1]
            return abs(x[i] @ w64 - b) <= reach

        assert all(any(near(i, *s) for s in splits) for i in own.leaf_ids.numpy()[moved])
        assert len(set(own.leaf_ids.numpy()[moved])) <= MAX_BOUNDARY


def test_hnsw_state(data, built):
    ref, own = built["hnsw"]
    assert own.links == ref.links and own.entry == ref.entry


@pytest.mark.parametrize("name", list(CASES))
def test_queries_on_the_reference_state_match(name, data, built):
    x, q, _ = data
    ref, _ = built[name]
    kw = CASES[name][3]
    if name == "ivf":
        port = P.IVFFlat.from_state(x, ref.centroids, ref.lists, device="cpu")
    elif name == "lsh":
        port = P.E2LSH.from_state(x, ref.a, ref.b, ref.mult, ref.tables, device="cpu")
    elif name == "imi_pq":
        port = P.IMIPQ.from_state(x, ref.c1, ref.c2, ref.counts, ref.sorted_ids, device="cpu")
    elif name == "rpforest":
        port = P.RPForest.from_state(x, ref.trees, leaf_size=64, device="cpu")
    else:
        port = P.HNSWLite.from_state(x, ref.links, ref.entry)
    assert port.memory_bytes() == ref.memory_bytes()
    _assert_ids_equal_but_ties(x, q, port.query(q, K, **kw).numpy(), ref.query(q, K, **kw))


@pytest.mark.parametrize("name", list(CASES))
def test_own_build_reaches_the_references_recall(name, data, built):
    x, q, gt = data
    ref, own = built[name]
    kw = CASES[name][3]
    r_ref = recall(ref.query(q, K, **kw), gt)
    r_own = recall(own.query(torch.from_numpy(q), K, **kw).numpy(), gt)
    assert abs(r_own - r_ref) <= 0.02, (r_own, r_ref)


@pytest.mark.parametrize("name", list(CASES))
def test_memory_bytes_equal_for_equal_state(name, built):
    ref, own = built[name]
    assert own.memory_bytes() == ref.memory_bytes()


def test_short_candidate_lists_follow_the_references_rules(data):
    """IVF without probes reranks the first k ids; E2LSH with an unreachable
    threshold, IMI-PQ with one candidate and RP-forest with a tiny
    ``search_k`` fall back to brute force; HNSW pads a short answer."""
    x, q, _ = data
    ivf = R.IVFFlat(32, 5).build(x)
    port = P.IVFFlat.from_state(x, ivf.centroids, ivf.lists, device="cpu")
    assert np.array_equal(port.query(q, K, nprobe=0).numpy(), ivf.query(q, K, nprobe=0))
    lsh = R.E2LSH(4, 4).build(x)
    plsh = P.E2LSH.from_state(x, lsh.a, lsh.b, lsh.mult, lsh.tables, device="cpu")
    _assert_ids_equal_but_ties(x, q, plsh.query(q, K, threshold=5).numpy(),
                               lsh.query(q, K, threshold=5))
    imi = R.IMIPQ(16, 5).build(x)
    pimi = P.IMIPQ.from_state(x, imi.c1, imi.c2, imi.counts, imi.sorted_ids, device="cpu")
    _assert_ids_equal_but_ties(x, q, pimi.query(q, K, n_candidates=1).numpy(),
                               imi.query(q, K, n_candidates=1))
    rp = R.RPForest(2, 4).build(x)
    prp = P.RPForest.from_state(x, rp.trees, leaf_size=4, device="cpu")
    _assert_ids_equal_but_ties(x, q, prp.query(q, K, search_k=1).numpy(),
                               rp.query(q, K, search_k=1))
    small = x[:6]
    hn = R.HNSWLite(2, 4).build(small)
    phn = P.HNSWLite.from_state(small, hn.links, hn.entry)
    assert np.array_equal(phn.query(q[:3], 8, ef_search=2).numpy(), hn.query(q[:3], 8, ef_search=2))
