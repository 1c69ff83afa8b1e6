"""Background site-frequency-spectrum estimation.

Reference: background-fsp.c:182-316.  Three sources:
  (a) estimate from the data — accumulate weighted counts at the maximum
      observed depth (folded sites split between the two compatible derived
      counts with a 1/j neutral prior, background-fsp.c:212-240), normalize,
      then hypergeometric-downsample to every other observed depth
      (background-fsp.c:72-88, 248-266);
  (b) forced neutral 1/i spectrum scaled by observed invariant/fixed counts
      (background-fsp.c:19-51);
  (c) load per-depth spectra from a file (handled by io.spectra_io).

TPU-native redesign: the per-SNP accumulation is an ``np.add.at`` scatter and
the downsampling is one dense hypergeometric matrix-vector product per depth
(no OpenMP loop).  All float64 host math — this runs once per scan; the scan
kernels consume only derived f32 tables.

Known reference quirk (NOT replicated by default): for *unfolded* sites the
reference accumulates the site's mass at bin ``depth - obs_freq`` instead of
``obs_freq`` (background-fsp.c:226-233: wa=0, wd=1, and the wd mass goes to
the mirrored bin), i.e. the estimated spectrum of unfolded data is mirrored.
We accumulate at ``obs_freq``.  Pass ``compat_mirror_unfolded=True`` to
reproduce the reference bit-for-bit (used by parity tests against the C
binary).
"""

from __future__ import annotations

import numpy as np

from .special import lchoose


def neutral_spectra(obs_freq, depth_p, sample_depths):
    """Forced neutral spectra: 1/i scaled by observed invariant/fixed counts.

    Mirrors background-fsp.c:19-51: count invariant (obs_freq==0) and fixed
    (obs_freq==depth) sites over the whole dataset, then for each distinct
    depth m build fsp with fsp[0]=n_invariant, fsp[m]=n_fixed and the
    segregating mass distributed as (1/k)/sum(1/k), all normalized by the
    total SNP count.
    """
    obs_freq = np.asarray(obs_freq)
    depth_p = np.asarray(depth_p)
    sample_depths = np.asarray(sample_depths)
    n_snps = obs_freq.shape[0]
    site_depth = sample_depths[depth_p]
    n_invariant = int(np.sum(obs_freq == 0))
    n_fixed = int(np.sum(obs_freq == site_depth))
    n_segregating = n_snps - n_fixed - n_invariant

    out = []
    for m in sample_depths.tolist():
        k = np.arange(1, m, dtype=np.float64)
        w = 1.0 / k
        fsp = np.zeros(m + 1, dtype=np.float64)
        fsp[0] = n_invariant
        fsp[m] = n_fixed
        fsp[1:m] = w / w.sum() * n_segregating
        out.append(fsp / n_snps)
    return out


def hypergeometric_downsample(fsp_N, n, N, include_invariant):
    """Project a depth-N spectrum onto depth n < N by hypergeometric sampling.

    d_fsp[k] = sum_m P_hypergeom(k; N, m, n) * fsp_N[m], normalized.
    Mirrors background-fsp.c:72-88 (including the include_invariant variant
    that drops m=0 and k in {0, n} from the sum) followed by the caller's
    normalization (background-fsp.c:257-259).
    """
    fsp_N = np.asarray(fsp_N, dtype=np.float64)
    m = np.arange(N + 1, dtype=np.float64)[None, :]  # [1, N+1]
    k = np.arange(n + 1, dtype=np.float64)[:, None]  # [n+1, 1]
    log_h = lchoose(m, k) + lchoose(N - m, n - k) - lchoose(N, n)
    with np.errstate(over="ignore", invalid="ignore"):
        H = np.where(np.isfinite(log_h), np.exp(log_h), 0.0)
    if not include_invariant:
        H[:, 0] = 0.0  # m = 0 excluded
        H[0, :] = 0.0  # k = 0 excluded
        H[n, :] = 0.0  # k = n excluded (loop bound k < n)
    d = H @ fsp_N
    s = d.sum()
    return d / s if s > 0 else d


def estimate_background_fsp(
    obs_freq,
    depth_p,
    folded,
    sample_depths,
    include_invariant=False,
    compat_mirror_unfolded=False,
):
    """Estimate per-depth background spectra from observed allele frequencies.

    Accumulation at max depth mirrors background-fsp.c:212-240: only sites at
    the maximum observed depth contribute (lower-depth upsampling is disabled
    in the reference, background-fsp.c:234-239); folded sites split mass
    between derived counts f and depth-f with the 1/j neutral prior:
      wa = 1/f, wd = 1/(depth-f)  =>  mass (depth-f)/depth at f,
                                      mass f/depth at depth-f.
    Returns a list of float64 spectra, one per entry of ``sample_depths``.
    """
    obs_freq = np.asarray(obs_freq, dtype=np.int64)
    depth_p = np.asarray(depth_p, dtype=np.int64)
    folded = np.asarray(folded, dtype=bool)
    sample_depths = np.asarray(sample_depths, dtype=np.int64)

    max_depth = int(sample_depths.max())
    site_depth = sample_depths[depth_p]
    at_max = site_depth == max_depth

    f = obs_freq[at_max].astype(np.float64)
    fl = folded[at_max]
    d = site_depth[at_max].astype(np.float64)

    # weights: folded interior sites get the 1/j prior split; folded boundary
    # sites (f==0 or f==depth) and unfolded sites put all mass in one bin.
    interior = fl & (f > 0) & (f < d)
    w_at_f = np.where(interior, (d - f) / d, 1.0)
    w_at_mirror = np.where(interior, f / d, 0.0)
    bin_f = f.astype(np.int64)
    bin_mirror = (d - f).astype(np.int64)
    if compat_mirror_unfolded:
        # reference quirk: unfolded mass lands at depth-f (and folded f==0 /
        # f==depth boundary handling follows background-fsp.c:216-221).
        unf = ~fl
        bin_f = np.where(unf, (d - f).astype(np.int64), bin_f)
        is0 = fl & (f == 0)
        isd = fl & (f == d)
        # folded f==0: wa=1,wd=0 -> all mass at bin 0 (already bin_f=0);
        # folded f==depth: wa=0,wd=1 -> all mass at bin 0 via depth-f... the
        # reference puts it at tmp_fsp[depth-obs_freq] = tmp_fsp[0]? No:
        # wd mass goes to bin depth-obs_freq = 0. Net: bin 0. Same as ours
        # except ours placed it at f=depth; fix:
        bin_f = np.where(isd, 0, bin_f)
        del is0

    tmp = np.zeros(max_depth + 1, dtype=np.float64)
    np.add.at(tmp, bin_f, w_at_f)
    np.add.at(tmp, bin_mirror, w_at_mirror)
    s = tmp.sum()
    if s > 0:
        tmp /= s

    out = []
    for m in sample_depths.tolist():
        if m == max_depth:
            if include_invariant:
                fsp = tmp.copy()
            else:
                fsp = tmp.copy()
                fsp[0] = 0.0
                fsp[m] = 0.0
                t = fsp.sum()
                if t > 0:
                    fsp /= t
        else:
            fsp = hypergeometric_downsample(tmp, m, max_depth, include_invariant)
        out.append(fsp)
    return out


def background_fsp(
    obs_freq,
    depth_p,
    folded,
    sample_depths,
    force_neutral_spectrum=False,
    loaded_spectra=None,
    include_invariant=False,
    compat_mirror_unfolded=False,
):
    """Dispatch between the three background-spectrum sources.

    Mirrors background_fsp (background-fsp.c:182-316).  ``loaded_spectra`` is
    a pre-parsed {depth: spectrum} mapping from io.spectra_io.load_spectra.
    """
    if force_neutral_spectrum:
        return neutral_spectra(obs_freq, depth_p, sample_depths)
    if loaded_spectra is not None:
        out = []
        for m in np.asarray(sample_depths).tolist():
            if m not in loaded_spectra:
                raise ValueError(
                    f"data requires background frequency spectrum for sample "
                    f"depth {m}, not found in loaded spectra"
                )
            out.append(np.asarray(loaded_spectra[m], dtype=np.float64))
        return out
    return estimate_background_fsp(
        obs_freq,
        depth_p,
        folded,
        sample_depths,
        include_invariant=include_invariant,
        compat_mirror_unfolded=compat_mirror_unfolded,
    )
