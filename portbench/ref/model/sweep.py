"""Sweep-model construction: post-sweep allele-frequency spectra.

Reference: sm-spline.c:316-484 (compute_sweep_model_fsp).
The model, per sample depth n:

  pjh[j, h]  = P(j derived in a subsample of size h | background spectrum at
               depth n), a hypergeometric mixture (sm-spline.c:336-352).
  pbk[b, k]  = P(observe b derived of n | k lineages escaped the sweep),
               mixing over whether the swept MRCA is derived
               (sm-spline.c:354-403; see the long derivation comment there).
  p_kescape(k, n, ad) = C(n,k) (1-e^-ad)^k e^-(n-k)ad — probability k of n
               lineages escape a sweep with composite parameter
               ad = alpha * distance (sm-spline.c:236-240).
  post-sweep spectrum at ad:
       p[f] = p_kescape(n,n,ad) * fsp[f] + sum_k p_kescape(k,n,ad) pbk[f,k]
               (sm-spline.c:423-441), optionally dropping invariant bins and
               applying ascertainment adjustment, then log.

TPU-native redesign: instead of fitting 201-knot cubic splines per allele
count (sm-spline.c:468-471), we evaluate log p[f](log_ad) on a dense grid of
G points over [LOG_AD_MIN, LOG_AD_MAX] and let the scan kernel do a linear
interpolation gather.  The spline only existed to amortize the O(n^2) mixture;
a dense grid is cheaper to evaluate on TPU and more accurate (no fit error).
All construction is float64 einsum on host (runs once; output is a small f32
table).
"""

from __future__ import annotations

import numpy as np

from . import LOG_AD_MAX, LOG_AD_MIN
from .ascbias import ascbias_adjust_expect
from .special import lchoose

LOG_DBL_MIN = float(np.log(np.finfo(np.float64).tiny))  # log(DBL_MIN), sm-spline.c:447


def compute_pjh(fsp, n):
    """pjh[j, h] for j, h in 0..n (only j <= h is meaningful; rest zero).

    pjh[j][h] = sum_{i=j}^{n} fsp[i] * exp(lchoose(i,j) + lchoose(n-i,h-j)
                                            - lchoose(n,h))
    (sm-spline.c:336-352).  The reference leaves pjh[j>h] as garbage/inf and
    never reads it (pbk only indexes j <= h); we zero it.
    """
    fsp = np.asarray(fsp, dtype=np.float64)
    idx = np.arange(n + 1, dtype=np.float64)
    j = idx[:, None, None]  # [j, 1, 1]
    h = idx[None, :, None]  # [1, h, 1]
    i = idx[None, None, :]  # [1, 1, i]
    log_t = lchoose(i, j) + lchoose(n - i, h - j) - lchoose(n, h)
    with np.errstate(over="ignore", invalid="ignore"):
        t = np.where(np.isfinite(log_t), np.exp(log_t), 0.0)
    pjh = np.einsum("jhi,i->jh", t, fsp)
    # zero the unused j > h triangle
    jj, hh = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    pjh[jj > hh] = 0.0
    return pjh


def compute_pbk(pjh, n):
    """pbk[b, k]: P(b observed derived of n | k lineages escaped the sweep).

    For k escaped lineages there are k+1 ancestral lineages just before the
    sweep (the k escapees + the swept MRCA).  If the swept MRCA is derived
    (prob q/(k+1) when the ancestral sample of k+1 has q = b-(n-k)+1 derived)
    the n-k swept descendants are all derived; otherwise (prob (k+1-b)/(k+1)
    with b ancestral derived) they are all ancestral (sm-spline.c:354-403).

    Valid for k in 0..n-1; column k=n is zero (the all-escape term uses the
    raw background spectrum instead, see post_sweep_spectra).
    """
    b = np.arange(n + 1)[:, None]  # [b, 1]
    k = np.arange(n)[None, :]  # [1, k], k = 0..n-1
    q = b - (n - k) + 1
    kp1 = (k + 1).astype(np.float64)

    # gather pjh[q, k+1] where q > 0, else 0
    q_safe = np.clip(q, 0, n)
    term1 = np.where(q > 0, pjh[q_safe, k + 1] * (q / kp1), 0.0)
    # gather pjh[b, k+1] where b < k+1, else 0
    b_safe = np.clip(np.broadcast_to(b, q.shape), 0, n)
    term2 = np.where(b < k + 1, pjh[b_safe, k + 1] * ((k + 1 - b) / kp1), 0.0)

    pbk = np.zeros((n + 1, n + 1), dtype=np.float64)
    pbk[:, :n] = term1 + term2
    return pbk


def log_ad_grid(grid_points):
    """Dense grid over [LOG_AD_MIN, LOG_AD_MAX] inclusive."""
    return np.linspace(LOG_AD_MIN, LOG_AD_MAX, grid_points)


def p_kescape_grid(n, log_ad):
    """pesc[k, g] = P(k of n lineages escape | ad = exp(log_ad[g])).

    p_kescape(k,n,ad) = exp(lchoose(n,k) + k log(1-e^-ad) - (n-k) ad)
    (sm-spline.c:236-240).  log(1-e^-ad) via log(-expm1(-ad)) for accuracy at
    tiny ad.
    """
    log_ad = np.asarray(log_ad, dtype=np.float64)
    ad = np.exp(log_ad)[None, :]  # [1, g]
    k = np.arange(n + 1, dtype=np.float64)[:, None]  # [k, 1]
    with np.errstate(divide="ignore"):
        log1m = np.log(-np.expm1(-ad))  # log(1 - e^-ad)
    log_p = lchoose(float(n), k) + k * log1m - (n - k) * ad
    return np.exp(log_p)


def post_sweep_spectra(
    fsp,
    n,
    log_ad,
    include_invariant=False,
    asc_depth=0,
    asc_min_freq=1,
    ascbias_background_only=False,
):
    """Expected post-sweep spectrum P[f, g] over the log_ad grid, normalized.

    Follows sm-spline.c:423-444: mix the escape distribution with pbk, add the
    all-escape background term, normalize over f, optionally zero invariant
    bins and renormalize, optionally apply the ascertainment expectation
    adjustment.
    """
    fsp = np.asarray(fsp, dtype=np.float64)
    pjh = compute_pjh(fsp, n)
    pbk = compute_pbk(pjh, n)
    pesc = p_kescape_grid(n, log_ad)  # [k, g], k=0..n

    # p[f, g] = pesc[n, g] * fsp[f] + sum_{k<n} pbk[f, k] * pesc[k, g]
    P = fsp[:, None] * pesc[n, :][None, :] + pbk[:, :n] @ pesc[:n, :]
    P /= P.sum(axis=0, keepdims=True)
    if not include_invariant:
        P[0, :] = 0.0
        P[n, :] = 0.0
        P /= P.sum(axis=0, keepdims=True)
    if asc_depth > 0 and not ascbias_background_only:
        for g in range(P.shape[1]):
            P[:, g] = ascbias_adjust_expect(P[:, g], n, asc_min_freq, asc_depth)
    return P, pbk


def compute_sweep_logprob_grid(
    fsp,
    n,
    grid_points,
    include_invariant=False,
    asc_depth=0,
    asc_min_freq=1,
    ascbias_background_only=False,
):
    """Dense log-prob tables for one sample depth.

    Returns (log_ad[g], y[f, g] unfolded log-probs for f=0..n,
    fy[f, g] folded log-probs for f=0..n//2, pbk) mirroring the spline targets
    of sm-spline.c:446-471 (zero probabilities clamp to log(DBL_MIN)).
    """
    la = log_ad_grid(grid_points)
    P, pbk = post_sweep_spectra(
        fsp,
        n,
        la,
        include_invariant=include_invariant,
        asc_depth=asc_depth,
        asc_min_freq=asc_min_freq,
        ascbias_background_only=ascbias_background_only,
    )
    with np.errstate(divide="ignore"):
        y = np.where(P > 0.0, np.log(np.maximum(P, 1e-320)), LOG_DBL_MIN)

    nf = n // 2
    fP = P[: nf + 1, :] + P[n - np.arange(nf + 1), :]
    if n % 2 == 0:
        fP[nf, :] = P[nf, :]  # f == n-f: not doubled (sm-spline.c:455-458)
    with np.errstate(divide="ignore"):
        fy = np.where(fP > 0.0, np.log(np.maximum(fP, 1e-320)), LOG_DBL_MIN)
    return la, y, fy, pbk
