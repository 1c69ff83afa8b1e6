"""The check that decides ``correct``: what the window's steps produced,
against the plain reference (ref/), after the window has closed.

The reference rebuilds everything from the generated sites alone: the
background spectrum and the sweep-model table (ref/model), each site's
table row and null log-likelihood, the genome coordinate and the
permutation stream (ref/stream.py), and the statistics (ref/stat.py).

Numbers compared (each against its limit in the cell's workload file;
the gaps in CLR units):

scan steps, on a sample of intervals drawn from the seed (the genome's
highest-CLR interval always among them):
  bad_rows   intervals whose chromosome or bounds differ from the
             configuration's grid, whose position lies outside them, or
             whose CLR is not finite, over every interval of every scan;
  clr_gap    |reported CLR - reference|, where the reference is the
             statistic at the reported position: the hist path's best over
             its tie grid's alphas (the reported alpha's), the lattice
             path's at the reported lattice alpha;
  shortfall  how far the reported CLR lies below the reference's best
             over the interval's 1 kb grid and the reported position (hist:
             the tie grid's alphas; lattice: the 11 coarse offsets of the
             first alpha stage, which the later stages only raise).
permute steps:
  count_faults   points whose exceedance count, rounds and finished flag
                 disagree with their saved null values and threshold
                 under the >= 20-exceedance rule (all points of the tail;
                 a sample of each pass otherwise);
  threshold_gap  |observed statistic - reference| at sampled points;
  null_gap       |saved null value of replicate r - reference on the
                 stream's replicate r| at sampled (pass, point, r),
                 the longest-running point of each pass among them.

The control is this reference in the program's place at a lower
precision (``precision``): its values at the same sampled items are
compared in the same way (control.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .genome import seed_entropy
from .ref.model import background_fsp, build_tables
from .ref.stat import (
    HistStat,
    fine_positions,
    grid_positions,
    lattice_clr,
)
from .ref.stream import group_sigma, site_sigma
from .ref.windows import candidate_windows

PRUNE_THRESHOLD = 20  # scan-chromosome.c:490
N_COARSE = 11  # the lattice path's coarse alpha grid (sm-search.c:276-282)


class Reference:
    """The reference's view of one generated genome."""

    def __init__(self, genome, cfg, device):
        self.g = genome
        self.device = device
        n = genome.depth
        W = genome.n_sites
        depth_p = np.zeros(W, np.int64)
        folded = np.full(W, bool(cfg["folded"]))
        fsp = background_fsp(genome.freq, depth_p, folded, np.array([n]))
        self.tables = build_tables(fsp, np.array([n]),
                                   grid_points=int(cfg["grid_points"]))
        rows = self.tables.site_rows(depth_p, folded, genome.freq)
        null = self.tables.null_logl(depth_p, folded, genome.freq)
        self.null_row = np.zeros(self.tables.table.shape[0])
        self.null_row[rows] = null
        self.rows_used = np.unique(rows)
        self.rows = torch.as_tensor(rows.astype(np.int64), device=device)
        self.pos = torch.as_tensor(genome.pos, device=device)
        self.extent = max(int(genome.pos[genome.chrom_slice(c)][-1]
                              - genome.pos[genome.chrom_slice(c)][0]) + 1
                          for c in range(len(genome.chrom)))
        self.table_t = torch.as_tensor(
            self.tables.table.astype(np.float64) - self.null_row[:, None],
            device=device)
        self._hist = {}
        self._gpos = None

    def hist(self, decimate, n_alpha):
        key = (decimate, n_alpha)
        if key not in self._hist:
            self._hist[key] = HistStat(
                self.tables.table, self.null_row, self.rows_used,
                self.extent, decimate=decimate, n_alpha=n_alpha,
                device=self.device)
        return self._hist[key]

    def chrom(self, c):
        sl = self.g.chrom_slice(c)
        return sl, self.g.pos[sl]

    def windows(self, c, cands, eval_range):
        _, pos_np = self.chrom(c)
        lo, hi = candidate_windows(pos_np, cands, eval_range)
        t = lambda x: torch.as_tensor(np.asarray(x, np.int64),  # noqa: E731
                                      device=self.device)
        return t(cands), t(lo), t(hi)

    def genome_pos(self):
        if self._gpos is None:
            self._gpos = self.g.genome_pos()
        return self._gpos


def _rng(seed, tag):
    return np.random.default_rng([seed_entropy(seed), tag])


# -- scans ---------------------------------------------------------------

def expected_intervals(genome, large_grid_sp):
    """(chr_id, start, end) of every coarse interval the configuration's
    grid gives (scan-chromosome.c:177-204)."""
    cid, st, en = [], [], []
    for c in range(len(genome.chrom)):
        p = genome.pos[genome.chrom_slice(c)]
        s = np.arange(p[0], p[-1], large_grid_sp, dtype=np.int64)
        if len(s) == 0:
            s = np.array([p[0]], np.int64)
        cid.append(np.full(len(s), c))
        st.append(s)
        en.append(np.minimum(s + large_grid_sp, p[-1]))
    return np.concatenate(cid), np.concatenate(st), np.concatenate(en)


def bad_rows(result, want):
    cid, st, en = want
    if result.n_points != len(cid):
        return max(result.n_points, len(cid))
    bad = ((result.chr_id != cid) | (result.interval_start != st)
           | (result.interval_end != en)
           | (result.sweep_pos < result.interval_start)
           | (result.sweep_pos > result.interval_end)
           | ~np.isfinite(result.clr))
    return int(bad.sum())


def _hist_interval(ref, c, cands, rep_pos, scan_cfg, precision):
    """(value at the reported position, best over the candidates) of the
    hist path's tie statistic."""
    hs = ref.hist(scan_cfg["tie_decimate"], scan_cfg["hist_alphas"])
    eval_range = scan_cfg["eval_range"]
    sl, _ = ref.chrom(c)
    allc = np.append(cands, rep_pos)
    cand, lo, hi = ref.windows(c, allc, eval_range)
    rows = hs.compact(ref.rows[sl])[None]
    clr = hs.clr(ref.pos[sl], rows, cand, lo, hi, precision=precision)[0]
    return float(clr[-1].max()), float(clr.max())


def _lattice_interval(ref, c, cands, rep_pos, rep_m, eval_range, precision):
    """The same for the lattice path: the value at the reported position
    and lattice offset, and the best over the grid and the reported
    position at the coarse offsets (every candidate's first alpha stage,
    which the later stages only raise)."""
    G = ref.tables.table.shape[1]
    sl, _ = ref.chrom(c)
    pos, rows = ref.pos[sl], ref.rows[sl]
    step = 24.0 / (G - 1)
    coarse = np.round((np.linspace(-20.0, 4.0, N_COARSE) + 20.0)
                      / step).astype(np.int64)
    cand, lo, hi = ref.windows(c, np.append(cands, rep_pos), eval_range)
    g_clr = lattice_clr(ref.table_t, pos, rows, cand, lo, hi, coarse, G,
                        precision=precision)
    cand, lo, hi = ref.windows(c, np.array([rep_pos]), eval_range)
    r_clr = lattice_clr(ref.table_t, pos, rows, cand, lo, hi,
                        np.array([rep_m]), G, precision=precision)
    return float(r_clr[0, 0]), float(g_clr.max())


def check_scans(ref, results, scan_cfg, n_sample, seed, precision=None):
    """({name: value} of the scan numbers, {name: its worst item}).
    With ``precision`` (a control) the control's values stand in the
    reported CLR at each sampled interval, which the program's reported
    positions and alphas still pick."""
    want = expected_intervals(ref.g, scan_cfg["large_grid_sp"])
    out = {"bad_rows": sum(bad_rows(r, want) for r in results)}
    rng = _rng(seed, 11)
    r0 = results[0]
    picks = [(0, int(np.argmax(r0.clr)))]
    for _ in range(n_sample - 1):
        picks.append((int(rng.integers(len(results))),
                      int(rng.integers(r0.n_points))))
    gap = short = 0.0
    worst = {}
    G = ref.tables.table.shape[1]
    step = 24.0 / (G - 1)
    for k, i in picks:
        r = results[k]
        c = int(r.chr_id[i])
        ist, ien = int(r.interval_start[i]), int(r.interval_end[i])
        cands = grid_positions(ist, ien, scan_cfg["small_grid_sp"])
        rep_pos, rep = int(r.sweep_pos[i]), float(r.clr[i])
        if scan_cfg["use_hist"]:
            val, best = _hist_interval(ref, c, cands, rep_pos,
                                               scan_cfg, "f64")
            if precision:
                rep = _hist_interval(ref, c, cands, rep_pos, scan_cfg,
                                     precision)[0]
        else:
            m = int(round((float(r.lalpha[i]) + 20.0) / step))
            val, best = _lattice_interval(
                ref, c, cands, rep_pos, m, scan_cfg["eval_range"], "f64")
            if precision:
                rep = _lattice_interval(ref, c, cands, rep_pos, m,
                                        scan_cfg["eval_range"], precision)[0]
        item = dict(scan=k, interval=i, position=rep_pos, program=rep,
                    reference=val, reference_best=best)
        if abs(rep - val) >= gap:
            gap, worst["clr_gap"] = abs(rep - val), item
        if best - rep >= short:
            short, worst["shortfall"] = max(best - rep, 0.0), item
    out["clr_gap"] = gap
    out["shortfall"] = short
    return out, worst


# -- permutation passes --------------------------------------------------

def count_fault(nulls, thr, n, p, fin, n_permute):
    """Whether a point's counts disagree with its saved nulls."""
    nulls = [] if nulls is None else nulls
    if not math.isfinite(thr) or n < 0 or n > n_permute or n > len(nulls):
        return True
    v = np.asarray(nulls[:n], np.float64)
    if int((v >= thr).sum()) != p:
        return True
    if fin:
        return p < PRUNE_THRESHOLD or n == 0 or not v[n - 1] >= thr
    return n != n_permute


def _stat(ref, hs, c, pt_interval, rows_c, eval_range, n_pos, precision):
    """[Rr] the permutation statistic (max over the point's positions and
    the alpha grid) of replicate rows rows_c [Rr, n] (compact ids)."""
    sl, _ = ref.chrom(c)
    cands = fine_positions(*pt_interval, n_pos)
    cand, lo, hi = ref.windows(c, cands, eval_range)
    clr = hs.clr(ref.pos[sl], rows_c, cand, lo, hi, precision=precision)
    return clr.flatten(1).max(1).values.cpu().numpy()


def check_passes(ref, steps, active, perm_cfg, scan_cfg, n_permute,
                 n_sample, n_count, seed, precision=None):
    """({name: value}, {name: worst item}) of the permutation numbers
    over the window's passes
    (steps: traffic.Step with .seed and .result)."""
    rng = _rng(seed, 13)
    hs = ref.hist(perm_cfg["hist_decimate"], perm_cfg["hist_alphas"])
    n_pos = perm_cfg["hist_positions"]
    er = scan_cfg["eval_range"]
    faults = 0
    for st in steps:
        r = st.result
        pts = (active if len(active) <= n_count
               else rng.choice(active, n_count, replace=False))
        for pt in pts:
            faults += count_fault(
                r.null_clr[pt], r.stat_threshold[pt], int(r.permute_n[pt]),
                int(r.permute_p[pt]), bool(r.permute_finished[pt]),
                n_permute)
    # (pass, point, replicate): each pass's longest-running point, then
    # draws over the window's passes
    picks = []
    for k, st in enumerate(steps):
        pt = int(active[np.argmax(st.result.permute_n[active])])
        picks.append((k, pt))
    while len(picks) < n_sample:
        picks.append((int(rng.integers(len(steps))),
                      int(active[rng.integers(len(active))])))
    picks = picks[:max(n_sample, 1)]
    thr_gap = null_gap = 0.0
    gpos = ref.genome_pos()
    W = ref.g.n_sites
    seen_thr = set()
    worst = {}
    for k, pt in picks:
        r = steps[k].result
        nulls = r.null_clr[pt]
        c = int(r.chr_id[pt])
        sl, _ = ref.chrom(c)
        iv = (int(r.interval_start[pt]), int(r.interval_end[pt]))
        if pt not in seen_thr:
            seen_thr.add(pt)
            ident = hs.compact(ref.rows[sl])[None]
            v = _stat(ref, hs, c, iv, ident, er, n_pos, "f64")
            got = float(r.stat_threshold[pt])
            if precision:
                got = float(_stat(ref, hs, c, iv, ident, er, n_pos,
                                  precision)[0])
            g = abs(got - v[0]) if math.isfinite(got) else math.inf
            if g >= thr_gap:
                thr_gap = float(g)
                worst["threshold_gap"] = dict(
                    point=pt, program=got, reference=float(v[0]))
        if not nulls:
            continue
        rep = int(rng.integers(len(nulls)))
        sig = site_sigma(group_sigma(steps[k].seed, gpos,
                                     perm_cfg["scan_width_mb"] * 1e6, [rep],
                                     ref.device), W)
        prow = hs.compact(ref.rows[sig[0]][sl])[None]
        v = _stat(ref, hs, c, iv, prow, er, n_pos, "f64")
        got = float(nulls[rep])
        if precision:
            got = float(_stat(ref, hs, c, iv, prow, er, n_pos,
                              precision)[0])
        if abs(got - v[0]) >= null_gap:
            null_gap = float(abs(got - v[0]))
            worst["null_gap"] = dict(step=k, point=pt, replicate=rep,
                                     program=got, reference=float(v[0]))
    return ({"count_faults": faults, "threshold_gap": thr_gap,
             "null_gap": null_gap}, worst)


def judge(numbers, limits):
    """(correct, [(name, value, limit)]) over the numbers the cell's
    limits name: every one within its limit; a number that is missing or
    not finite fails."""
    rows, ok = [], True
    for name, lim in limits.items():
        value = numbers.get(name, math.nan)
        good = math.isfinite(value) and value <= lim
        ok &= good
        rows.append((name, value, lim))
    return ok, rows
