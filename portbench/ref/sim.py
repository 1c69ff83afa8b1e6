"""Frozen copy of the forward simulator (fscl_tpu_torch/sim/sample.py):
draw SNP frequencies from the sweep model itself, NumPy only.

Standard neutral spectrum (sm-sample.c:105-121), evenly placed sweeps of
strength alpha (125-139), and per-site frequencies drawn from the
post-sweep spectrum at each site's distance to the nearest sweep
(164-212): each site's log_ad maps to a column of the dense post-sweep
table, and the inverse-CDF draw is batched against per-column CDFs.
"""

from __future__ import annotations

import numpy as np

from .model import LOG_AD_MAX
from .model.sweep import log_ad_grid, post_sweep_spectra


def standard_neutral_spectrum(n):
    fsp = np.zeros(n + 1)
    fsp[1:n] = 1.0 / np.arange(1, n)
    fsp[1:n] /= fsp[1:n].sum()
    return fsp


def place_sweeps(n_sweeps, bp_length, alpha):
    """Evenly spaced sweeps at (i + 0.5) * spacing (sm-sample.c:125-139)."""
    spacing = bp_length / n_sweeps
    pos = ((np.arange(n_sweeps) + 0.5) * spacing).astype(np.int64)
    return pos, np.full(n_sweeps, alpha, dtype=np.float64)


def sample_snps(rng, n_snps, bp_length, sweep_pos, sweep_alpha, fsp, n,
                grid_points=1024):
    """Positions uniform on [0, bp_length); freqs from the post-sweep model.

    Returns (pos sorted, freq) with freq in 1..n-1 (interior bins only, as
    sm-sample.c:186,202 restricts draws to segregating classes).
    """
    la_grid = log_ad_grid(grid_points)
    P, _ = post_sweep_spectra(fsp, n, la_grid)  # [n+1, G]
    P = P[1:n, :]  # interior classes only
    P = P / P.sum(axis=0, keepdims=True)
    cdf = np.cumsum(P, axis=0)  # [n-1, G]
    bg = fsp[1:n] / fsp[1:n].sum()
    bg_cdf = np.cumsum(bg)

    pos = np.sort(rng.integers(0, bp_length, size=n_snps))
    if len(sweep_pos) > 0:
        j = np.argmin(
            np.abs(pos[:, None] - np.asarray(sweep_pos)[None, :]), axis=1
        )
        d = np.maximum(np.abs(pos - np.asarray(sweep_pos)[j]), 1)
        log_ad = np.log(d * np.asarray(sweep_alpha)[j])
    else:
        log_ad = np.full(n_snps, LOG_AD_MAX + 1.0)

    g = np.clip(
        np.round((log_ad - la_grid[0]) / (la_grid[1] - la_grid[0])).astype(int),
        0,
        grid_points - 1,
    )
    u = rng.random(n_snps)
    freq = np.empty(n_snps, dtype=np.int64)
    near = log_ad < LOG_AD_MAX
    # batched inverse-CDF: for near sites use their grid column, else background
    for_mask = np.where(near)[0]
    if len(for_mask):
        cols = cdf[:, g[for_mask]]  # [n-1, m]
        freq[for_mask] = 1 + (u[for_mask][None, :] > cols).sum(axis=0)
    far = np.where(~near)[0]
    if len(far):
        freq[far] = 1 + (u[far][None, :] > bg_cdf[:, None]).sum(axis=0)
    return pos, np.clip(freq, 1, n - 1)
