"""SC-attention (``repro_torch.core.sc_attention``) against the JAX
package's ``repro.core.sc_attention`` on the CPU, on the same seeded keys,
values and queries: the reference's three cases on the port, the selected
ids and the outputs against the reference's, and the tie rule.

SC-scores are integers in ``0..n_subspaces``, so nearly every score ties;
``jax.lax.top_k`` keeps the lower index first among equals, and the port
keeps that order by a stable descending sort.  Ids must equal the
reference's except where a partial product lies within a few ulp of its
subspace's ``tau`` (the two packages round ``-(k . q)`` apart), which the
test then shows; outputs agree to 1e-5 (fp32 softmax over the same keys).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sc_attention as J

from repro_torch.core.sc_attention import (attention_mass_recall, sc_key_scores,
                                           sc_select_keys, sc_sparse_attention)


def _data(h=4, s=2048, hd=32, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.normal(size=(h, s, hd)).astype(np.float32)
    values = rng.normal(size=(h, s, hd)).astype(np.float32)
    q = rng.normal(size=(h, hd)).astype(np.float32) + keys[:, -1]
    return q, keys, values


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@functools.partial(jax.jit, static_argnames=("n_subspaces", "alpha", "n_keep"))
def _j_select(q, keys, n_subspaces, alpha, n_keep):
    return J.sc_select_keys(q, keys, n_subspaces=n_subspaces, alpha=alpha, n_keep=n_keep)


def _j_scores(q, keys, n_subspaces, count):
    return np.stack([np.asarray(J._subspace_scores(jnp.asarray(q[i]), jnp.asarray(keys[i]),
                                                   n_subspaces, count))
                     for i in range(q.shape[0])])


def _tau_ties(q, keys, n_subspaces, count, rel=1e-5):
    """Per head, the keys whose partial product in some subspace lies within
    ``rel`` of that subspace's ``tau`` (fp64)."""
    h, s, hd = keys.shape
    w = hd // n_subspaces
    near = np.zeros((h, s), bool)
    for i in range(n_subspaces):
        d = -np.einsum("hsw,hw->hs", keys[..., i * w:(i + 1) * w].astype(np.float64),
                       q[:, i * w:(i + 1) * w].astype(np.float64))
        tau = np.sort(d, axis=-1)[:, count - 1]
        near |= np.abs(d - tau[:, None]) <= rel * np.abs(tau[:, None]) + 1e-6
    return near


def test_sc_selection_beats_random():
    q, keys = _t(*_data()[:2])
    ids = sc_select_keys(q, keys, n_subspaces=4, alpha=0.05, n_keep=128)
    mass = float(attention_mass_recall(q, keys, ids).mean())
    rnd = torch.from_numpy(np.random.default_rng(1).choice(2048, size=(4, 128), replace=False))
    assert mass > 3 * float(attention_mass_recall(q, keys, rnd).mean())


def test_sc_sparse_attention_converges_to_exact():
    q, keys, values = _t(*_data())
    out, _ = sc_sparse_attention(q, keys, values, n_subspaces=4, alpha=0.2, n_keep=2048)
    w = torch.softmax(torch.einsum("hd,hsd->hs", q, keys) / np.sqrt(32), dim=-1)
    exact = torch.einsum("hs,hsd->hd", w, values)
    np.testing.assert_allclose(out.numpy(), exact.numpy(), atol=1e-4, rtol=1e-4)


def test_sc_mass_recall_monotone_in_budget():
    q, keys, values = _t(*_data(seed=2))
    masses = [float(attention_mass_recall(q, keys, sc_sparse_attention(
        q, keys, values, n_subspaces=4, alpha=0.05, n_keep=n)[1]).mean())
        for n in (64, 256, 1024)]
    assert masses[0] <= masses[1] <= masses[2] and masses[2] > 0.6


@pytest.mark.parametrize("seed,n_subspaces,alpha,n_keep", [(0, 4, 0.05, 128), (3, 8, 0.1, 512),
                                                          (5, 3, 0.02, 1024)])
def test_ids_scores_and_outputs_match_jax(seed, n_subspaces, alpha, n_keep):
    """``hd`` 32 at 3 subspaces leaves 2 dims unused, as the reference."""
    q, keys, values = _data(seed=seed)
    count = max(1, int(alpha * keys.shape[1]))
    got = sc_key_scores(*_t(q, keys), n_subspaces, count).numpy()
    want = _j_scores(q, keys, n_subspaces, count)
    apart = got != want
    assert not (apart & ~_tau_ties(q, keys, n_subspaces, count)).any()
    out, ids = sc_sparse_attention(*_t(q, keys, values), n_subspaces=n_subspaces, alpha=alpha,
                                   n_keep=n_keep)
    jout, jids = J.sc_sparse_attention(jnp.asarray(q), jnp.asarray(keys), jnp.asarray(values),
                                       n_subspaces=n_subspaces, alpha=alpha, n_keep=n_keep)
    if not apart.any():
        assert np.array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    mass = attention_mass_recall(*_t(q, keys), ids).numpy()
    jmass = np.asarray(J.attention_mass_recall(jnp.asarray(q), jnp.asarray(keys), jids))
    np.testing.assert_allclose(mass, jmass, rtol=1e-5)


def test_ties_take_the_lower_index_first_as_lax_top_k():
    """Keys in a few repeated rows, so the 2,048 scores take 2-3 values and
    almost all tie: the kept ids are ``jax.lax.top_k``'s, lowest index first
    among equal scores (``torch.topk`` keeps another set on this input)."""
    rng = np.random.default_rng(11)
    h, s, hd = 2, 2048, 16
    rows = rng.normal(size=(h, 3, hd)).astype(np.float32)
    keys = rows[:, rng.integers(0, 3, s)].copy()
    q = rng.normal(size=(h, hd)).astype(np.float32)
    ids = sc_select_keys(*_t(q, keys), n_subspaces=4, alpha=0.05, n_keep=300).numpy()
    want = np.asarray(_j_select(jnp.asarray(q), jnp.asarray(keys), 4, 0.05, 300))
    assert np.array_equal(ids, want)
    sc = sc_key_scores(*_t(q, keys), 4, int(0.05 * s))
    assert len(torch.unique(sc)) <= 3 * h
    assert all((np.diff(ids[i][sc[i].numpy()[ids[i]] == sc[i].numpy()[ids[i]][-1]]) > 0).all()
               for i in range(h))
