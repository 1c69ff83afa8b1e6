"""Special functions for the probability model (host-side, float64).

The reference memoizes log-factorial / log-binomial tables
(sm-spline.c:18-46).  Here these are vectorized numpy
expressions over ``gammaln``.  They run once per scan during table
construction (O(n^2 G) work for n = sample depth, G = log-ad grid), so they
live on the host in float64: differences of large log-gammas are
catastrophically inaccurate in f32, while the hot per-site scan path consumes
only the resulting small f32 tables.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaln

NEG_INF = -np.inf


def log_fact(n):
    """log(n!) elementwise; -inf for n < 0 (sm-spline.c:18-39 semantics)."""
    n = np.asarray(n)
    out = np.where(n < 0, NEG_INF, gammaln(np.maximum(n, 0) + 1.0))
    return out


def lchoose(n, k):
    """log C(n, k) elementwise.

    Mirrors sm-spline.c:41-46: returns 0 for (n==0,k==0); -inf when k > n or
    n == 0; additionally -inf for k < 0 (the reference reaches that case only
    in expressions whose results are masked out — we mask here instead).
    """
    n = np.asarray(n, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    invalid = (k > n) | (k < 0) | (n < 0)
    ns = np.where(invalid, 0.0, n)
    ks = np.where(invalid, 0.0, k)
    val = gammaln(ns + 1.0) - gammaln(ks + 1.0) - gammaln(ns - ks + 1.0)
    return np.where(invalid, NEG_INF, val)


def exp_lchoose_ratio(a_n, a_k, b_n, b_k, c_n, c_k):
    """exp(lchoose(a) + lchoose(b) - lchoose(c)) with -inf handled as 0."""
    e = lchoose(a_n, a_k) + lchoose(b_n, b_k) - lchoose(c_n, c_k)
    with np.errstate(over="ignore", invalid="ignore"):
        out = np.exp(e)
    return np.where(np.isfinite(e), out, 0.0)
