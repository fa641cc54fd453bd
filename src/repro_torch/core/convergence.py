"""Convergence-analysis machinery from Section III (Lemmas 1-3, Theorems 1-2).

Copy-port of ``repro.core.convergence`` (pure ``math``): the port keeps its
own copy so that it imports nothing of the JAX package.

These closed forms are used three ways:
  1. tests assert the paper's qualitative claims (Remarks 1-2) hold for the
     implemented formulas;
  2. the divergence probes (``core.divergence``) feed *measured* delta /
     Delta (and the beta estimate) into the bounds to predict convergence
     behaviour;
  3. the kappa auto-tuner (``core.cost_model.tune_kappas``) minimizes
     time-to-accuracy under the bound inverted.

Paper erratum (as in the JAX package): the printed
``h(x, delta, eta) = delta/beta ((eta*beta+1)^x - 1) - eta*beta*x`` has a
typo in the linear term — with delta = 0 it would give h < 0, contradicting
Remark 2's "delta = Delta = 0  =>  G_c = 0" and the source analysis it cites
(Wang et al. 2019, where g(x) = delta/beta((eta*beta+1)^x - 1) - eta*delta*x).
We implement ``- eta*delta*x``, which satisfies h(x, 0, eta) = 0 and
reproduces every property the paper derives from it.
"""
from __future__ import annotations

import math


def h(x: float, delta: float, eta: float, beta: float) -> float:
    """Weight-divergence growth over x local steps under gradient divergence delta."""
    if x <= 0:
        return 0.0
    return (delta / beta) * ((eta * beta + 1.0) ** x - 1.0) - eta * delta * x


def p_of_k(k: int, q: int, kappa1: int, kappa2: int) -> int:
    """Edge-interval index [p] of local step k inside cloud interval {q}."""
    return math.ceil(k / kappa1 - (q - 1) * kappa2)


def G_c(
    k: int,
    kappa1: int,
    kappa2: int,
    delta: float,
    Delta: float,
    eta: float,
    beta: float,
    *,
    q: int = 1,
) -> float:
    """Lemma 2: deviation bound ||w(k) - u_{q}(k)|| for convex losses at step k."""
    p = p_of_k(k, q, kappa1, kappa2)
    t_cloud = k - (q - 1) * kappa1 * kappa2
    t_edge = k - ((q - 1) * kappa2 + p - 1) * kappa1
    return (
        h(t_cloud, Delta, eta, beta)
        + h(t_edge, delta, eta, beta)
        + 0.5 * kappa1 * (p * p + p - 2) * h(kappa1, delta, eta, beta)
    )


def G_c_max(kappa1: int, kappa2: int, delta: float, Delta: float, eta: float, beta: float) -> float:
    """Eq. (2): interval-end upper bound G_c(kappa1*kappa2, eta)."""
    return h(kappa1 * kappa2, Delta, eta, beta) + 0.5 * (
        kappa2 * kappa2 + kappa2 - 1.0
    ) * (kappa1 + 1.0) * h(kappa1, delta, eta, beta)


def G_nc(kappa1: int, kappa2: int, delta: float, Delta: float, eta: float, beta: float) -> float:
    """Lemma 3: deviation bound for non-convex losses."""
    base = (1.0 + eta * beta) ** kappa1 - 1.0
    if base == 0.0:  # eta == 0
        ratio = float(kappa2)
    else:
        ratio = ((1.0 + eta * beta) ** (kappa1 * kappa2) - 1.0) / base
    return (
        h(kappa1 * kappa2, Delta, eta, beta)
        + kappa1 * kappa2 * ratio * h(kappa1, delta, eta, beta)
        + h(kappa1, delta, eta, beta)
    )


def theorem1_bound(
    K: int,
    kappa1: int,
    kappa2: int,
    delta: float,
    Delta: float,
    eta: float,
    beta: float,
    rho: float,
    epsilon: float,
    varphi: float,
) -> float:
    """Theorem 1: F(w(K)) - F(w*) upper bound (convex, fixed step size).

    Returns +inf when the bound's positivity condition fails (the paper's
    condition 2: eta*varphi - rho*G/(kappa1*kappa2*eps^2) > 0).
    """
    B = K / (kappa1 * kappa2)
    g = G_c_max(kappa1, kappa2, delta, Delta, eta, beta)
    denom_term = eta * varphi - rho * g / (kappa1 * kappa2 * epsilon * epsilon)
    if denom_term <= 0 or B <= 0:
        return math.inf
    return 1.0 / (B * denom_term)


def theorem2_bound(
    K: int,
    kappa1: int,
    kappa2: int,
    delta: float,
    Delta: float,
    eta: float,
    beta: float,
    rho: float,
    f0_minus_fstar: float,
) -> float:
    """Theorem 2: bound on the weighted average squared gradient norm
    (non-convex, fixed eta per cloud interval; we take eta constant)."""
    B = K // (kappa1 * kappa2)
    sum_eta = eta * K
    g = G_nc(kappa1, kappa2, delta, Delta, eta, beta)
    return (
        4.0 * f0_minus_fstar / sum_eta
        + 4.0 * rho * B * g / sum_eta
        + 2.0 * beta * beta * B * kappa1 * kappa2 * g * g / sum_eta
    )


# ---------------------------------------------------------------------------
# Qualitative guidelines (Section III-B remarks) as predicates — used by the
# tuner and asserted by tests.
# ---------------------------------------------------------------------------

def guideline_smaller_kappa1(product: int, delta: float, Delta: float, eta: float, beta: float):
    """Remark 2 guideline 1: with kappa1*kappa2 fixed, smaller kappa1 gives a
    smaller deviation bound. Returns the list of (kappa1, kappa2, G) sorted by
    kappa1 so callers/tests can check monotonicity."""
    out = []
    for k1 in range(1, product + 1):
        if product % k1 == 0:
            k2 = product // k1
            out.append((k1, k2, G_c_max(k1, k2, delta, Delta, eta, beta)))
    return out


def guideline_edge_iid_kappa2_free(kappa1: int, delta: float, eta: float, beta: float, kappa2s):
    """Remark 2 guideline 2: with Delta = 0 (edge-IID), G grows only
    quadratically (not exponentially) in kappa2."""
    return [(k2, G_c_max(kappa1, k2, delta, 0.0, eta, beta)) for k2 in kappa2s]
