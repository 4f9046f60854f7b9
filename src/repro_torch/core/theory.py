"""Theoretical guarantees (paper Theorems 1 & 2) as executable calculators.

These functions turn the proofs' parameter recipes into code so that the
framework can (a) validate the guarantees numerically (tests) and (b) suggest
``(Ns, alpha, beta)`` for a dataset from its subspace statistics ``(m, sigma)``
— the mean/stddev of per-subspace squared distances.

A copy of the JAX package's ``repro.core.theory`` (numpy and the standard
library only), which cannot be imported without JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

__all__ = [
    "GuaranteeReport",
    "subspace_statistics",
    "estimate_subspace_statistics",
    "theorem1_bound",
    "theorem2_bound",
    "degraded_budget_bound",
    "suggest_parameters",
]

_GAMMA = 0.375  # Blom's constant for normal order statistics


def _ndtri(p: float) -> float:
    """Inverse standard normal CDF (Acklam's rational approximation).

    Avoids a scipy dependency; |error| < 1.2e-8 over (0, 1).
    """
    if not 0.0 < p < 1.0:
        raise ValueError("p must be in (0,1)")
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        ql = math.sqrt(-2 * math.log(p))
        return (((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql + c[5]) / (
            (((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1
        )
    if p > phigh:
        ql = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql + c[5]) / (
            (((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1
        )
    qm = p - 0.5
    r = qm * qm
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * qm / (
        ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1
    )


def _phi(x: float) -> float:
    return math.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)


class GuaranteeReport(NamedTuple):
    success_prob: float  # lower bound on the success probability
    alpha_min: float  # smallest admissible collision ratio
    c1: float
    c2: float


def subspace_statistics(x: np.ndarray, q: np.ndarray, n_subspaces: int) -> tuple[float, float]:
    """Empirical (m, sigma) of per-subspace squared distances ``Z_i^j``."""
    n, d = x.shape
    s = d // n_subspaces
    z = np.abs(x - q[None, :]) ** 2
    zs = np.add.reduceat(z, np.arange(0, s * n_subspaces, s), axis=1)  # (n, Ns)
    return float(zs.mean()), float(zs.std())


def estimate_subspace_statistics(
    x: np.ndarray,
    n_subspaces: int,
    *,
    n_queries: int = 8,
    n_points: int = 2048,
    seed: int = 0,
) -> tuple[float, float]:
    """Deterministic sampled ``(m, sigma)`` estimate for a serving dataset.

    :func:`subspace_statistics` needs a concrete query; a serving process
    has none at policy time, so this draws ``n_queries`` probe queries from
    the data itself, measures each against an ``n_points`` sample, and
    averages — the same estimator the recall test harness applies per
    query, collapsed to one number pair.  Deterministic in ``seed`` so a
    degradation ladder's recall floors are stable across restarts.
    """
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    xs = x[rng.choice(n, size=min(n_points, n), replace=False)]
    qs = x[rng.choice(n, size=min(n_queries, n), replace=False)]
    stats = [subspace_statistics(xs, q, n_subspaces) for q in qs]
    return float(np.mean([s[0] for s in stats])), float(np.mean([s[1] for s in stats]))


def theorem1_bound(m: float, sigma: float, n_subspaces: int, alpha: float) -> GuaranteeReport:
    """Theorem 1: SC-score ordering implies distance ordering w.p. >= 1/2-1/e^2.

    Implements the proof's explicit ``c1, c2`` recipe.  The bound holds for
    ``alpha > max(1/(1+m^2/s^2), 1 - e^2/(1+m^2/s^2))``.
    """
    r2 = (m / sigma) ** 2  # m^2/sigma^2
    alpha_min = max(1.0 / (1.0 + r2), 1.0 - math.e**2 / (1.0 + r2))
    root = math.sqrt(max((1.0 - alpha) * (1.0 + r2), 0.0))
    denom = m / sigma - root
    if alpha <= alpha_min or denom <= 0:
        return GuaranteeReport(0.0, alpha_min, float("nan"), float("nan"))
    c1 = math.sqrt(8.0 * max(n_subspaces - 1, 1)) / denom
    c2 = (math.e - root) / denom
    p = (
        1.0
        - (2.0 * (n_subspaces - 1) / c1**2) * denom**-2
        - (c2 * (m / sigma) + root * (1.0 - c2)) ** -2
    )
    return GuaranteeReport(p, alpha_min, c1, c2)


def theorem2_bound(
    n: int, k: int, n_subspaces: int, m: float, sigma: float, alpha: float
) -> float:
    """Theorem 2: probability lower bound that Alg. 1 answers a k-ANN query.

    Uses Blom's normal order-statistic approximations (paper Eq. 11-12) for
    ``E_{k,n}`` / ``V_{k,n}`` and the Chebyshev step of the proof.  Returns a
    probability in [0, 1] (>= 1/2 for admissible parameters).
    """
    ns = n_subspaces
    e_kn = ns * m + math.sqrt(ns) * sigma * _ndtri((k - _GAMMA) / (n - 2 * _GAMMA + 1))
    v_kn = (
        ns
        * sigma**2
        * (k * (n - k + 1) / ((n + 1) ** 2 * (n + 2)))
        * _phi(_ndtri(k / (n + 1))) ** -2
    )
    # Collision bound on ||z||^2 when C = Ns (all subspaces collide).
    bound = ns * m * math.sqrt((1.0 - alpha) * (1.0 + (sigma / m) ** 2))
    t = bound - e_kn
    if t <= 0:
        # Candidate radius below the k-th order statistic: the Chebyshev step
        # is vacuous; the proof's recipe asks for a larger alpha/beta.
        return 0.0
    return max(0.0, 1.0 - v_kn / t**2)


def degraded_budget_bound(
    n: int,
    k: int,
    n_subspaces: int,
    m: float,
    sigma: float,
    alpha: float,
    beta: float,
) -> float:
    """Theorem-2 success bound recomputed for a reduced ``(alpha, beta)``
    serving budget — the quantified floor a degraded-mode answer carries.

    :func:`theorem2_bound` assumes the candidate set retains every
    full-collision point; a load-shedding policy truncates the candidate
    pool at ``beta * n`` entries, which breaks that premise in two ways:

    * **infeasible pool** — ``int(beta * n) < k``: the pool cannot even
      hold a top-k answer, so the guarantee is vacuous (0.0).  A
      degradation ladder must not step past this point if it wants to
      keep returning quantified answers.
    * **pool spill** — the true neighbour can be evicted by spurious
      full-collision points.  Per Definition 1 each subspace's activated
      prefix covers ``alpha * n`` points, so under the proof's
      independence step a random point fully collides w.p.
      ``alpha ** Ns`` and the expected impostor count is
      ``n * alpha**Ns``; Markov bounds the spill probability by
      ``alpha**Ns / beta``.  The term is monotone in the budget: shrinking
      ``beta`` at fixed ``alpha`` strictly lowers the floor.

    Returns ``max(0, theorem2 - spill)`` clamped to [0, 1].
    """
    if beta <= 0.0:
        return 0.0
    if int(beta * n) < k:
        return 0.0
    base = theorem2_bound(n, k, n_subspaces, m, sigma, alpha)
    spill = min(1.0, alpha**n_subspaces / beta)
    return max(0.0, min(1.0, base - spill))


def suggest_parameters(
    n: int, d: int, k: int, m: float, sigma: float, *, target_prob: float = 0.5
) -> dict:
    """Search a small grid for (Ns, alpha) meeting the Theorem 2 bound.

    beta is set by the paper's practical recipe (Section 5.3.3):
    beta in [0.003, 0.005], larger for harder (higher-LID) data.
    """
    best = None
    for ns in (6, 8, 10, 12, 16):
        if d // ns < 2:
            continue
        for alpha in (0.01, 0.03, 0.05, 0.1, 0.2):
            p = theorem2_bound(n, k, ns, m, sigma, alpha)
            if p >= target_prob and (best is None or alpha < best["alpha"]):
                best = dict(n_subspaces=ns, alpha=alpha, beta=0.005, prob=p)
    return best or dict(n_subspaces=8, alpha=0.1, beta=0.005, prob=0.0)
