"""p-value computation: empirical ratios + chi-square tail projection.

Numpy copy of fscl_tpu/engine/pvalues.py.

Empirical rule mirrors scan_output (scan-chromosome.c:718-728):
p = (permute_p - 1) / (permute_n - 1), or 1 / permute_n when permute_p < 2.

The reference README (README.md:9-13) additionally describes projecting the
tail by estimating the noncentrality of the chi-square distribution of the
CLR — described but NOT implemented in the C code (SURVEY.md section 7).  We
implement it in the ANCHORED tail-ratio form (chi2_tail_projection): where
the null reservoir resolves the p-value, the projection is the empirical
rank estimate; beyond resolution it extrapolates from the anchor (the
anchor_rank-th largest null) by the conditional tail ratio
sf(obs)/sf(anchor) of a scaled chi-square whose (k, df) are fitted to the
positive nulls by upper-quantile matching.  Only the fitted SHAPE enters —
anchor-point miscalibration cancels — and when the reservoir is too small
to fit a shape at all, the projection floors at the anchor instead of
extrapolating through a placeholder.  This gives usable p-values far
beyond 1/n_permute resolution.

The observed value entering the projection must be the PERMUTATION
statistic's value on the observed data (ScanResult.stat_threshold — the
threshold the exceedance counts used), not the reported dense-scan CLR:
the two differ by the statistic's decimation/interpolation offset.
"""

from __future__ import annotations

import numpy as np
from scipy import stats


def empirical_pvalues(permute_p, permute_n):
    permute_p = np.asarray(permute_p, dtype=np.float64)
    permute_n = np.asarray(permute_n, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(
            permute_p < 2,
            1.0 / np.maximum(permute_n, 1.0),
            (permute_p - 1.0) / np.maximum(permute_n - 1.0, 1.0),
        )
    return p


def fit_scaled_chi2(null_clr, eps=1e-6):
    """Fit (frac_pos, scale k, df) of a scaled chi-square to null CLRs.

    Upper-quantile matched: k and df solve q75 and q95 of the positive
    part exactly, so the fitted curve is anchored in the region the tail
    projection extrapolates from (a plain moment fit is dominated by the
    bulk and was ~2x off in log10(p) at genome scale — round-2
    calibration measurement, BASELINE.md).  Falls back to the moment fit
    when the reservoir is too small or degenerate for quantiles, and to
    (frac, None, None) when even the moment fit is impossible — callers
    must not extrapolate a tail from that.
    """
    x = np.asarray(null_clr, dtype=np.float64)
    x = x[np.isfinite(x)]
    if len(x) == 0:
        return 0.0, None, None
    pos = x[x > eps]
    frac = len(pos) / len(x)
    if len(pos) < 10:
        return frac, None, None
    m, v = pos.mean(), pos.var()
    if m <= 0 or v <= 0:
        return frac, None, None
    k = v / (2.0 * m)  # mean = k df, var = 2 k^2 df
    df = m / k
    q1, q2 = np.quantile(pos, [0.75, 0.95])
    if len(pos) >= 40 and q1 > eps and q2 > q1 * (1 + 1e-9):
        # ratio chi2.ppf(.95,df)/chi2.ppf(.75,df) decreases monotonically
        # in df; bisect df to match, then k sets the scale
        target = q2 / q1
        lo_df, hi_df = 1e-2, 1e3
        ratio = lambda d: stats.chi2.ppf(0.95, d) / stats.chi2.ppf(0.75, d)
        if ratio(hi_df) <= target <= ratio(lo_df):
            for _ in range(60):
                mid = np.sqrt(lo_df * hi_df)
                if ratio(mid) > target:
                    lo_df = mid
                else:
                    hi_df = mid
            df = np.sqrt(lo_df * hi_df)
            k = q1 / stats.chi2.ppf(0.75, df)
    return frac, k, max(df, 1e-3)


def chi2_tail_projection(obs_clr, null_clr, eps=1e-6, anchor_rank=10):
    """Projected tail p-value for one scan point from its null reservoir.

    Anchored tail-ratio form (the peaks-over-threshold recipe standard for
    permutation tails, cf. Knijnenburg et al. 2009; the README's
    chi-square tail description, README.md:9-13, described-but-never-
    implemented in the C):

      * where the reservoir RESOLVES the p-value (>= anchor_rank nulls at
        or above the observed CLR) the projection IS the empirical rank
        estimate r/(n+1) — no parametric error where data suffices;
      * beyond resolution, the p-value extrapolates from the anchor (the
        anchor_rank-th largest null) by the fitted scaled-chi-square's
        conditional tail ratio sf(obs)/sf(anchor) — only the SHAPE of the
        fit matters, so anchor-point miscalibration cancels.

    A reservoir with NO positive values carries no tail model at all —
    there the result is floored at 1/(n_null+1) instead of reporting an
    exact 0 (infinite significance) from a few uninformative
    permutations."""
    x = np.asarray(null_clr, dtype=np.float64)
    x = x[np.isfinite(x)]
    n = x.size
    if n == 0:
        return 1.0
    obs = max(float(obs_clr), 0.0)
    r_obs = int(np.sum(x >= obs)) if obs > eps else n
    if obs <= eps:
        return 1.0
    if r_obs >= anchor_rank:
        return float((r_obs + 1.0) / (n + 1.0))
    frac, k, df = fit_scaled_chi2(x, eps)
    if frac == 0.0:
        return 1.0 / (n + 1.0)
    r = min(anchor_rank, int(round(frac * n))) or 1
    x0 = np.sort(x)[-r]  # r-th largest null = the anchor
    p_anchor = (r + 1.0) / (n + 1.0)
    if k is None:
        # too few positive nulls to fit a tail shape: floor at the anchor
        # rather than extrapolate decades below it through a placeholder
        return float(p_anchor)
    sf0 = stats.chi2.sf(max(x0, eps) / k, df)
    if sf0 <= 0:
        return float(p_anchor)  # anchor already past fp tail resolution
    ratio = stats.chi2.sf(obs / k, df) / sf0
    return float(min(p_anchor * ratio, p_anchor))


def projected_pvalues(result):
    """Vector of projected p-values (NaN where no null reservoir exists).

    Uses the observed permutation-statistic value (stat_threshold) where
    the engine recorded one — the same threshold the exceedance counting
    compared the nulls against — falling back to the reported CLR for
    results that never ran a permutation phase.
    """
    out = np.full(result.n_points, np.nan)
    thr = getattr(result, "stat_threshold", None)
    for i in range(result.n_points):
        res = result.null_clr[i]
        if res:
            obs = result.clr[i]
            if thr is not None and np.isfinite(thr[i]):
                obs = thr[i]
            out[i] = chi2_tail_projection(obs, res)
    return out
