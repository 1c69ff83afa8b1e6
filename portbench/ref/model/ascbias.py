"""Ascertainment-bias correction for SNP-array style data.

Reference: asc-bias.c:12-109.  A site with k derived alleles
out of n is "ascertained" if a subsample of depth d contains at least
``min_obs`` copies of *each* allele.  The miss probability is a hypergeometric
tail summed over the ways either allele appears fewer than min_obs times:

  P(no asc) = sum_{i<min_obs} [C(k, d-i) C(n-k, i) + C(n-k, d-i) C(k, i)]
              / C(n, d)                                    (asc-bias.c:12-25)

Two adjustments (both vectorized here):
  * ``ascbias_adjust_background``: divide the observed background spectrum by
    the (normalized) asc probability and renormalize -> estimate of the
    pre-ascertainment spectrum (asc-bias.c:27-95).  Interior bins only.
  * ``ascbias_adjust_expect``: multiply a model-expected spectrum by the asc
    probability and renormalize -> post-ascertainment expectation
    (asc-bias.c:97-109), applied inside the sweep-model build.
"""

from __future__ import annotations

import numpy as np

from .special import lchoose


def ascprob_subsample(k, d, min_obs, n):
    """P(ascertained) for k derived of n, asc depth d, min obs per allele.

    Vectorized over k (and n).  Mirrors asc-bias.c:12-25 including its
    convention that out-of-range binomials contribute zero.
    """
    k = np.asarray(k, dtype=np.float64)
    i = np.arange(int(min_obs), dtype=np.float64)  # i = 0..min_obs-1
    kk = k[..., None]
    with np.errstate(over="ignore", invalid="ignore"):
        t1 = lchoose(kk, d - i) + lchoose(n - kk, i)
        t2 = lchoose(n - kk, d - i) + lchoose(kk, i)
        no_asc = np.where(np.isfinite(t1), np.exp(t1), 0.0) + np.where(
            np.isfinite(t2), np.exp(t2), 0.0
        )
    denom = np.exp(lchoose(np.float64(n), np.float64(d)))
    return 1.0 - no_asc.sum(axis=-1) / denom


def ascbias_adjust_background(bsf, n, asc_depth, min_obs):
    """Observed background -> estimated pre-ascertainment background.

    asc[i] is normalized over interior bins before dividing, exactly as
    asc-bias.c:33-51 (the normalization cancels in the final renormalize but
    is kept for numerical parity).  Bins 0 and n are zeroed.
    """
    bsf = np.asarray(bsf, dtype=np.float64)
    k = np.arange(n + 1)
    asc = np.zeros(n + 1, dtype=np.float64)
    asc[1:n] = ascprob_subsample(k[1:n], asc_depth, min_obs, n)
    s = asc[1:n].sum()
    if s > 0:
        asc[1:n] /= s
    adj = np.zeros(n + 1, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        adj[1:n] = np.where(asc[1:n] > 0, bsf[1:n] / asc[1:n], 0.0)
    t = adj.sum()
    if t > 0:
        adj /= t
    return adj


def ascbias_adjust_expect(fsp, n, min_obs, d):
    """Model-expected spectrum -> expected *ascertained* spectrum.

    Applies over all bins 0..n (asc-bias.c:97-109 does not zero boundaries).
    Returns a new array (the reference mutates in place).
    """
    fsp = np.asarray(fsp, dtype=np.float64)
    asc = ascprob_subsample(np.arange(n + 1), d, min_obs, n)
    out = fsp * asc
    s = out.sum()
    if s > 0:
        out = out / s
    return out
