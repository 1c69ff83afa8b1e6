"""The statistics the program reports, in plain PyTorch (float64 unless a
control asks for less), from the sites, the sweep-model table and the
candidates alone.

Composite likelihood ratio of a sweep at candidate c and log-alpha
lalpha (Nielsen et al. 2005; sm-search.c:269-300):

    CLR = 2 * sum over window sites w with x_w <= LOG_AD_MAX of
          (log P_sweep(row_w | x_w) - log P_null(row_w)),
    x_w = lalpha + log(max(|pos_w - c|, 1)),

with log P_sweep read from the table [rows, G] by linear interpolation on
its log_ad lattice and the window +-eval_range sites around c
(windows.py).

``lattice_clr`` evaluates this per site, at alphas on the table's
lattice.  ``HistStat`` evaluates fscl_tpu's histogram form of it (the
program's hist path): the sites on each side of c fall into cells of
one lattice step of log distance; a cell's sites share one interpolation
fraction, taken at the mean position of the cell's sites, so a cell
contributes counts per table row times the lerped table.  The cells, the
mean positions and the fractions follow fscl_tpu/ops/histclr.py
(float32 fractions from the float32 sum of the cell's positions, as that
package states them); the counts and the contraction are exact here.

``precision`` selects the control's arithmetic: "f64" (the reference),
"tf32" (float32 operands rounded to TF32, float32 sums) and "fp8"
(float8 e4m3 operands, each tensor scaled to its range, float32 sums).
"""

from __future__ import annotations

import numpy as np
import torch

from .model import LOG_AD_MAX, LOG_AD_MIN

# elements of one chunk's [candidates, sites(, alphas)] temporaries
CHUNK_ELEMS = 1 << 25


def lattice_step(grid_points, decimate=1):
    return (LOG_AD_MAX - LOG_AD_MIN) / (grid_points - 1) * decimate


def round_tf32(x):
    """float32 ``x`` rounded to TF32's 10 mantissa bits (to nearest)."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def round_fp8(x):
    """float32 ``x`` through float8 e4m3 at a per-tensor scale that maps
    its largest magnitude to the format's largest finite value."""
    x = x.float()
    amax = float(x.abs().max()) if x.numel() else 0.0
    if amax == 0.0:
        return x
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def _operands(precision):
    if precision == "f64":
        return torch.float64, (lambda t: t.double())
    if precision == "tf32":
        return torch.float32, round_tf32
    if precision == "fp8":
        return torch.float32, round_fp8
    raise ValueError(f"unknown precision {precision!r}")


def lattice_clr(table_t, pos, rows, cand, lo, hi, offsets, grid_points,
                precision="f64"):
    """[C, A] per-site CLR at lattice offsets ``offsets`` [A] (lalpha =
    LOG_AD_MIN + m * step).

    table_t: [rows_all, G] table minus the row's null log-likelihood
    (float64); pos, rows: [n] int64 tensors of one chromosome; cand, lo,
    hi: [C] int64 (inclusive site windows)."""
    dev = table_t.device
    G = grid_points
    inv = 1.0 / lattice_step(G)
    dt, rnd = _operands(precision)
    tab = rnd(table_t)
    m = torch.as_tensor(np.asarray(offsets), dtype=torch.float64, device=dev)
    C, A = cand.shape[0], m.shape[0]
    out = torch.zeros((C, A), dtype=torch.float64, device=dev)
    if C == 0:
        return out
    L = int((hi - lo).max()) + 1
    k = torch.arange(L, device=dev)
    a_per = max(1, min(A, CHUNK_ELEMS // L))
    c_per = max(1, CHUNK_ELEMS // (L * a_per))
    for c0 in range(0, C, c_per):
        cs = slice(c0, c0 + c_per)
        w = lo[cs, None] + k  # [c, L]
        inw = w <= hi[cs, None]
        w = torch.where(inw, w, lo[cs, None])
        logd = torch.log((pos[w] - cand[cs, None]).abs().clamp_min(1)
                         .double())
        r = rows[w][..., None]
        for a0 in range(0, A, a_per):
            u = logd[..., None] * inv + m[a0:a0 + a_per]  # [c, L, a]
            i0 = u.floor().clamp(0, G - 1).long()
            frac = (u - i0).clamp(0.0, 1.0)
            v0 = tab[r, i0]
            v1 = tab[r, (i0 + 1).clamp_max(G - 1)]
            if dt == torch.float64:
                y = v0 + frac * (v1 - v0)
            else:
                y = v0 + rnd(frac.float()) * (v1 - v0)
            y = torch.where(inw[..., None] & (u <= G - 1), y, 0.0)
            out[cs, a0:a0 + a_per] = 2.0 * y.sum(1, dtype=dt).double()
    return out


class HistStat:
    """fscl_tpu's histogram statistic at one lattice decimation and one
    alpha grid (module doc).

    table: [rows_all, G] float32 sweep-model table; null_row: [rows_all]
    float64 null log-likelihood per row; rows_used: the table rows the
    data uses; extent_bp: the widest chromosome's extent (last - first
    site + 1), which sets the number of cells."""

    def __init__(self, table, null_row, rows_used, extent_bp, *, decimate,
                 n_alpha, device):
        G = table.shape[1]
        cols = np.arange(0, G, decimate)
        self.step = lattice_step(G, decimate)
        self.G = len(cols)
        inv = 1.0 / self.step
        self.NC = min(self.G, int(np.log(max(float(extent_bp), 2.0)) * inv)
                      + 2)
        self.q = np.round(np.linspace(0, self.G - 1, n_alpha)).astype(
            np.int64)
        self.lalpha = LOG_AD_MIN + self.q * self.step
        self.d_ceil = torch.as_tensor(np.ceil(np.exp(
            np.arange(1, self.NC + 1, dtype=np.float64) * self.step)).astype(
                np.int64), device=device)
        rows_used = np.asarray(rows_used, np.int64)
        self.R = len(rows_used)
        self.row_map = np.full(table.shape[0], -1, np.int64)
        self.row_map[rows_used] = np.arange(self.R)
        t = (np.asarray(table, np.float64)[rows_used][:, cols]
             - np.asarray(null_row, np.float64)[rows_used][:, None])
        i = np.arange(self.NC)[:, None] + self.q[None, :]  # [NC, A]
        act = (i <= self.G - 1).astype(np.float64)
        p0 = t[:, np.clip(i, 0, self.G - 1)] * act  # [R, NC, A]
        p1 = t[:, np.clip(i + 1, 0, self.G - 1)] * act
        # [2 (lerp end), NC * R, A]: row k = cell * R + row
        pk = np.stack([p0.transpose(1, 0, 2), p1.transpose(1, 0, 2)])
        self.pack = torch.as_tensor(
            pk.reshape(2, self.NC * self.R, -1), device=device)
        self.inv_f32 = float(np.float32(inv))
        self.device = device

    def compact(self, rows):
        """Compact row ids of table rows (numpy or tensor)."""
        m = torch.as_tensor(self.row_map, device=self.device)
        return m[torch.as_tensor(rows, device=self.device).long()]

    def weights(self, pos, rows, cand, lo, hi):
        """(W0, W1) [Rr, C, 2 * NC * R] float64: each (side, cell, row)'s
        site count times 1 - fbar and fbar.  pos: [n] int64; rows: [Rr,
        n] compact ids; cand, lo, hi: [C] int64."""
        dev = self.device
        NC, R = self.NC, self.R
        Rr, C = rows.shape[0], cand.shape[0]
        L = int((hi - lo).max()) + 1
        k = torch.arange(L, device=dev)
        w = lo[:, None] + k[None, :]  # [C, L]
        inw = w <= hi[:, None]
        w = torch.where(inw, w, lo[:, None])
        p = pos[w]
        d = (p - cand[:, None]).abs()
        side = (p >= cand[:, None]).long()
        cell = torch.searchsorted(self.d_ceil, d, right=True)
        ok = inw & (cell < NC)
        cell = cell.clamp_max(NC - 1)
        run = (torch.arange(C, device=dev)[:, None] * 2 + side) * NC + cell
        run = torch.where(ok, run, 2 * C * NC)  # dropped slot
        h = torch.zeros(2 * C * NC + 1, dtype=torch.int64, device=dev)
        h.scatter_add_(0, run.flatten(), torch.ones_like(run).flatten())
        s = torch.zeros_like(h)
        s.scatter_add_(0, run.flatten(), p.flatten())
        h, s = h[:-1].view(C, 2, NC), s[:-1].view(C, 2, NC)
        # fbar as fscl_tpu states it: float32 mean position, float32 log
        pbar = s.to(torch.float32) / h.clamp_min(1).to(torch.float32)
        dbar = (pbar - cand.to(torch.float32)[:, None, None]).abs()
        logd = torch.log(dbar.clamp_min(1))
        icell = torch.arange(NC, dtype=torch.float32, device=dev)
        fbar = (logd * self.inv_f32 - icell).clamp(0.0, 1.0).double()
        key = ((torch.arange(C, device=dev)[:, None] * 2 + side) * NC
               + cell) * R  # [C, L]
        key = torch.where(ok, key, 2 * C * NC * R)
        out = torch.zeros((Rr, 2 * C * NC * R + 1), dtype=torch.float64,
                          device=dev)
        idx = key[None] + rows[:, w]  # [Rr, C, L]
        idx = torch.where(ok[None], idx, 2 * C * NC * R)
        out.scatter_add_(1, idx.flatten(1), torch.ones(
            idx.flatten(1).shape, dtype=torch.float64, device=dev))
        n = out[:, :-1].view(Rr, C, 2, NC, R)
        f = fbar[None, :, :, :, None]
        return ((n * (1.0 - f)).reshape(Rr, C, -1),
                (n * f).reshape(Rr, C, -1))

    def clr(self, pos, rows, cand, lo, hi, precision="f64"):
        """[Rr, C, A] the statistic at each candidate and alpha."""
        C = cand.shape[0]
        L = int((hi - lo).max()) + 1 if C else 1
        per = max(1, CHUNK_ELEMS // (L * rows.shape[0]))
        outs = []
        p0, p1 = self.pack[0], self.pack[1]
        for c0 in range(0, C, per):
            sl = slice(c0, c0 + per)
            w0, w1 = self.weights(pos, rows, cand[sl], lo[sl], hi[sl])
            Rr, c = w0.shape[:2]
            w0 = w0.view(Rr, c, 2, -1)
            w1 = w1.view(Rr, c, 2, -1)
            # side s reads the cells of both lerp ends; the pack is shared
            a = torch.cat([w0[:, :, 0], w0[:, :, 1]], 2)
            b = torch.cat([w1[:, :, 0], w1[:, :, 1]], 2)
            P0 = torch.cat([p0, p0], 0)
            P1 = torch.cat([p1, p1], 0)
            if precision == "f64":
                outs.append(2.0 * (a @ P0 + b @ P1))
                continue
            _, rnd = _operands(precision)
            lhs = torch.cat([rnd(a), rnd(b)], 2).float()
            rhs = torch.cat([rnd(P0), rnd(P1)], 0).float()
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
            try:
                outs.append(2.0 * (lhs @ rhs).double())
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
        return torch.cat(outs, 1)


def fine_positions(istart, iend, n):
    """The permutation statistic's n positions of an interval: istart +
    linspace(0, 1, n) * (iend - istart), truncated (fscl_tpu's grid)."""
    f = np.linspace(0.0, 1.0, n)
    return (istart + f * (iend - istart)).astype(np.int64)


def grid_positions(istart, iend, pitch):
    """An interval's fine scan grid: istart + k * pitch up to iend, and
    iend."""
    g = np.arange(istart, iend + 1, pitch, dtype=np.int64)
    return np.unique(np.append(g, iend))
