"""Forward simulator: draw SNP frequency data from the sweep model itself.

Equivalent of the reference's sm-sample binary (sm-sample.c):
standard neutral spectrum (sm-sample.c:105-121), evenly placed sweeps of
strength alpha (125-139), per-SNP frequency sampled from the post-sweep
spectrum at its distance to the nearest sweep (164-212), an
ascertainment-biased subsample (220-240) and a density-matched random
subsample (253-270).  Used for scanner validation on data with known sweep
positions/strengths (SURVEY.md section 4).

TPU-native redesign: frequencies for all sites draw in one vectorized pass —
each site's log_ad maps to a column of the dense post-sweep table, and the
inverse-CDF draw is a batched searchsorted against per-column CDFs.

Output rows are ``chr pos freq depth folded`` (loadable by our reader and by
the reference's).  Note the reference's own writer omits the chr column
(sm-sample.c:284), producing files its reader cannot parse; we default to
writing a chr label and offer chr=None for byte-parity with the C output.
"""

from __future__ import annotations

import numpy as np

from .. import LOG_AD_MAX
from ..models.ascbias import ascprob_subsample
from ..models.sweep import log_ad_grid, post_sweep_spectra


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


def subsample_ascertainment(rng, freq, n, asc_depth):
    """Keep each SNP with its double-allele discovery probability
    (sm-sample.c:220-240, min_obs = 1)."""
    p = ascprob_subsample(freq, asc_depth, 1, n)
    return rng.random(len(freq)) < p


def random_ascertainment(rng, n_snps_total, n_keep):
    """Density-matched uniform random subsample (sm-sample.c:253-270)."""
    keep = np.zeros(n_snps_total, dtype=bool)
    keep[rng.choice(n_snps_total, size=n_keep, replace=False)] = True
    return keep


def write_snp_file(path, pos, freq, n, folded=False, chrom="1"):
    with open(path, "w") as f:
        for p, q in zip(pos, freq):
            if chrom is None:
                f.write(f"{p}\t{q}\t{n}\t{int(folded)}\n")
            else:
                f.write(f"{chrom}\t{p}\t{q}\t{n}\t{int(folded)}\n")


def simulate_dataset(
    seed=0,
    sample_size=128,
    snp_density=1.0,
    mb_length=10.0,
    alpha=1e-4,
    n_sweeps=1,
    asc_depth=0,
    grid_points=1024,
):
    """One-call synthetic dataset; returns dict of arrays (used by tests)."""
    rng = np.random.default_rng(seed)
    bp_length = int(mb_length * 1e6)
    n_snps = int(snp_density * bp_length / 1000.0)
    fsp = standard_neutral_spectrum(sample_size)
    spos, salpha = place_sweeps(n_sweeps, bp_length, alpha) if n_sweeps else (
        np.array([], dtype=np.int64), np.array([]),
    )
    pos, freq = sample_snps(
        rng, n_snps, bp_length, spos, salpha, fsp, sample_size, grid_points
    )
    out = dict(pos=pos, freq=freq, n=sample_size, sweep_pos=spos, alpha=salpha)
    if asc_depth >= 2:
        keep = subsample_ascertainment(rng, freq, sample_size, asc_depth)
        out["asc_keep"] = keep
        out["rnd_keep"] = random_ascertainment(rng, n_snps, int(keep.sum()))
    return out
