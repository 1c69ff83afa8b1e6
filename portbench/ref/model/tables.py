"""Packed sweep-model tables consumed by the scan kernels.

The reference keeps, per distinct sample depth, an array of cubic splines per
allele count (sm_ptable_t, fscl.h:70-76) and dispatches per
SNP via (depth_p, folded, obs_freq) pointer chasing (sm-search.c:85-103).

TPU-native layout: ONE dense f32 matrix ``table[R, G]`` where row r holds
log P(freq | log_ad grid) for one (depth, folded, freq) combination and G is
the log_ad grid.  Each site precomputes a single int32 ``row`` index, so the
hot kernel does one 2-element gather + lerp per (site, position, alpha)
evaluation — no ragged structures, no per-depth dispatch (SURVEY.md section 7,
"Mixed sample depths").
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ascbias import ascbias_adjust_background
from .sweep import LOG_DBL_MIN, compute_sweep_logprob_grid
from . import LOG_AD_MAX, LOG_AD_MIN

DEFAULT_GRID_POINTS = 2048


@dataclasses.dataclass
class SweepModelTables:
    """Dense packed sweep-model log-prob tables for all sample depths."""

    sample_depths: np.ndarray  # [D] int
    log_ad: np.ndarray  # [G] float64 grid over [LOG_AD_MIN, LOG_AD_MAX]
    table: np.ndarray  # [R, G] float32 log-prob rows
    row_unfolded: np.ndarray  # [D] int32: row = row_unfolded[d] + f
    row_folded: np.ndarray  # [D] int32: row = row_folded[d] + f  (f <= n//2)
    fsp: list  # per-depth raw background spectra (null model uses these)
    fsp_model: list  # per-depth background used in the sweep model (asc-adj)
    pbk: list  # per-depth escape-mixing matrices (kept for simulators/tests)

    @property
    def grid_points(self) -> int:
        return int(self.table.shape[1])

    @property
    def log_ad_step(self) -> float:
        return float(self.log_ad[1] - self.log_ad[0])

    def site_rows(self, depth_p, folded, obs_freq):
        """Flat table row per site from (depth index, folded flag, freq)."""
        depth_p = np.asarray(depth_p)
        folded = np.asarray(folded, dtype=bool)
        obs_freq = np.asarray(obs_freq)
        base = np.where(
            folded, self.row_folded[depth_p], self.row_unfolded[depth_p]
        )
        return (base + obs_freq).astype(np.int32)

    def null_logl(self, depth_p, folded, obs_freq):
        """Per-site null log-likelihood from the raw background spectrum.

        Mirrors compute_snp_null_model (scan-chromosome.c:23-37): folded sites
        with f != depth-f use log(fsp[f] + fsp[depth-f]).  Zero probabilities
        clamp to log(DBL_MIN) instead of -inf.
        """
        depth_p = np.asarray(depth_p, dtype=np.int64)
        folded = np.asarray(folded, dtype=bool)
        obs_freq = np.asarray(obs_freq, dtype=np.int64)
        out = np.empty(depth_p.shape, dtype=np.float64)
        for d in range(len(self.sample_depths)):
            n = int(self.sample_depths[d])
            fsp = self.fsp[d]
            sel = depth_p == d
            if not sel.any():
                continue
            f = obs_freq[sel]
            p = fsp[f]
            mirror = folded[sel] & (f != n - f)
            p = np.where(mirror, p + fsp[np.clip(n - f, 0, n)], p)
            out[sel] = np.where(p > 0.0, np.log(np.maximum(p, 1e-320)), LOG_DBL_MIN)
        return out


def build_tables(
    fsp_list,
    sample_depths,
    grid_points=DEFAULT_GRID_POINTS,
    asc_depth=0,
    asc_min_freq=1,
    ascbias_background_only=False,
    include_invariant=False,
) -> SweepModelTables:
    """Build packed tables for every distinct sample depth.

    Mirrors compute_sweep_model_tables (sm-spline.c:486-520): when asc_depth
    is set, the background handed to the model is first adjusted to its
    pre-ascertainment estimate (asc-bias.c:27-95); the raw background is kept
    for the null model.  The reference's OpenMP loop over depths becomes a
    plain loop — each depth is one batch of dense einsums.
    """
    sample_depths = np.asarray(sample_depths, dtype=np.int64)
    D = len(sample_depths)
    row_unf = np.zeros(D, dtype=np.int32)
    row_fol = np.zeros(D, dtype=np.int32)

    rows = []
    fsp_model_list = []
    pbk_list = []
    log_ad = None
    r = 0
    for d in range(D):
        n = int(sample_depths[d])
        fsp = np.asarray(fsp_list[d], dtype=np.float64)
        if asc_depth > 0:
            model_fsp = ascbias_adjust_background(fsp, n, asc_depth, asc_min_freq)
        else:
            model_fsp = fsp
        la, y, fy, pbk = compute_sweep_logprob_grid(
            model_fsp,
            n,
            grid_points,
            include_invariant=include_invariant,
            asc_depth=asc_depth,
            asc_min_freq=asc_min_freq,
            ascbias_background_only=ascbias_background_only,
        )
        log_ad = la
        row_unf[d] = r
        rows.append(y)
        r += n + 1
        row_fol[d] = r
        rows.append(fy)
        r += n // 2 + 1
        fsp_model_list.append(model_fsp)
        pbk_list.append(pbk)

    table = np.concatenate(rows, axis=0).astype(np.float32)
    return SweepModelTables(
        sample_depths=sample_depths,
        log_ad=log_ad,
        table=table,
        row_unfolded=row_unf,
        row_folded=row_fol,
        fsp=[np.asarray(f, dtype=np.float64) for f in fsp_list],
        fsp_model=fsp_model_list,
        pbk=pbk_list,
    )
