"""Histogram/prefix-sum CLR engine (port of the main-path subset of
fscl_tpu/ops/histclr.py).

Block permutations shuffle SNP attributes and never positions, so every
distance-derived quantity is replicate-invariant.  For candidate c the
table coordinate of site w at lattice alpha offset q is
u(c, w) + q with u = log|pos_w - c| / step; sites sorted by position map
to contiguous runs per integer cell of u on each side of c.  The run
boundaries (bounds) and run-mean interpolation fractions (fbar) are built
once per candidate set; each replicate then needs only

  1. the one-hot prefix sums PS[w, r] of its site rows,
  2. one R-wide row gather PS[bounds] per (candidate, cell),
  3. one contraction [C, 2*NC*R] @ [2*NC*R, A] against the table pack t3,

which evaluates a dense grid of A alpha values at once.

Reference semantics mirrored: window clamping (scan-chromosome.c:73-89),
distance clamp to >= 1 bp, active-site cutoff at x <= LOG_AD_MAX, CLR =
2*(sm_logl - null_logl) over active sites (sm-search.c:269-300).

Up to ROWS_MAX distinct table rows run the exact one-hot mode (integer
prefix counts).  Above it, up to COMPRESS_ROWS_MAX, the row family is
SVD-compressed to f32 weight channels (_build_hist_tables_compressed)
where the rank ladder reaches COMPRESS_TOL: each site contributes its
weight row instead of a one-hot indicator, and the prefix sums become
f32 sums of weights.  A family the ladder cannot compress (one large
depth: its frequency classes are not low rank) keeps exact one-hot
tables up to WIDE_ROWS_MAX rows, and past that takes the lattice path
(build_hist_tables returns None).

Step 1 has several sources, one statistic: the stacked segmented prefix
(build_prefix_sums_seg, the permutation driver's main path), the prefix
of replicate-stacked row ids (build_prefix_sums, hist_clr_reps), the
prefix of one chromosome's permuted stream (build_prefix_sums_oh), and,
in the pruning tail, the run-decomposed prefix assembled at the bounds
from one unpermuted site prefix (rdp_clr_reps, whose two large row
gathers are ops/gather.py:row_gather).  Steps 2-3 are one function,
_clr_from_windows: one kernel for the gather, difference, lerp and
contraction, with bfloat16 operands (ops/window_clr.py:window_clr) or
float32-accurate products (window_clr_f32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import LOG_AD_MAX, LOG_AD_MIN
from ..device import parse_device
from .gather import row_gather
from .lattice import log_distance
from .permute import PERM_GROUP, sigma_from_runs
from .prefix_sums import (
    onehot_prefix_sums,
    perm_prefix_sums,
    rowid_prefix_sums,
    weighted_prefix_sums,
)
from .window_clr import (
    bf16_pack, f32_pack, window_clr, window_clr_f32, window_clr_f32_plain,
    window_clr_plain,
)
from .windows import candidate_windows

DEFAULT_N_ALPHA = 128
ROWS_MAX = 128  # exact one-hot gate: above this the tables are compressed
# widest exact one-hot tables, taken above ROWS_MAX where the rank ladder
# does not reach COMPRESS_TOL (the window kernels' wide variants)
WIDE_ROWS_MAX = 256
COMPRESS_ROWS_MAX = 8192  # hard cap for the SVD row-compression path
COMPRESS_TOL = 1e-3  # max-entry residual target for the rank choice
COMPRESS_RANKS = (8, 16, 24, 32, 48, 64, 96)  # the rank ladder
# table sets built, by mode: exact one-hot up to ROWS_MAX rows, exact
# one-hot above it (the ladder missed its tolerance), SVD-compressed
table_modes = {"exact": 0, "exact_wide": 0, "compressed": 0}
SITES_MAX = 4_000_000  # [W, R] state cap
# transient bytes of one rdp_clr_reps candidate chunk (the assembled
# [c, 2, NC+1, P*R] int32 prefix rows): bounds device memory only, the
# values do not depend on it
CHUNK_BYTES = 1 << 30


def hist_supported(n_rows_used, n_sites):
    """Whether the hist engine may cover this dataset: exact one-hot mode
    up to ROWS_MAX distinct rows, compressed or exact-wide mode up to
    COMPRESS_ROWS_MAX (fscl_tpu/ops/histclr.py:64).  Above WIDE_ROWS_MAX
    the rank ladder decides (build_hist_tables)."""
    return n_rows_used <= COMPRESS_ROWS_MAX and n_sites <= SITES_MAX


def dense_alpha_offsets(grid_points, n_alpha=DEFAULT_N_ALPHA):
    """Integer lattice offsets covering [LOG_AD_MIN, LOG_AD_MAX] densely."""
    return np.round(np.linspace(0, grid_points - 1, n_alpha)).astype(np.int32)


@dataclasses.dataclass
class HistTables:
    """Row-compacted table pack for one chromosome extent."""

    t3: torch.Tensor  # [2*NC*R, A] f32: (w0/w1, cell, row) -> alpha row
    rows_used: np.ndarray  # [R_used] original row ids (sorted)
    # [n_rows_total] -> compact id; absent rows map to the sentinel id
    # (R in one-hot mode, R_used in compressed mode)
    row_map: np.ndarray
    n_cells: int  # NC
    n_rows: int  # R (padded compact row count, or weight-channel count)
    n_alpha: int
    grid_points: int  # lattice points actually packed (after decimation)
    step: float  # log_ad pitch between packed lattice points
    offsets: np.ndarray  # [A] absolute lattice offsets
    lalpha: np.ndarray  # [A] f32 log-alpha values
    # compressed mode: [R_used + 1, n_rows] f32 weight channels per row
    # (SVD factors, site-mix-centred, + a count channel; the last row is
    # the all-zero sentinel).  None = exact one-hot mode.
    weights: torch.Tensor | None = None
    # compressed mode: the largest entry residual |M - Uw @ V| of the rank
    # taken; None in exact one-hot mode
    residual: float | None = None

    @property
    def sentinel(self) -> int:
        """The row id that counts nowhere: absent rows and padding."""
        return self.n_rows if self.weights is None else len(self.rows_used)


def build_hist_tables(table_np, grid_points, null_row, rows_used, extent_bp,
                      n_alpha=DEFAULT_N_ALPHA, row_pad=8, decimate=1,
                      site_row_counts=None, compress=None, device="cuda"):
    """Pack (table - null) rows for the histogram contraction.

    table_np: [n_rows_total, G]; null_row: [n_rows_total] per-row null
    logl.  decimate=s > 1 keeps every s-th lattice column
    (fscl_tpu/ops/histclr.py:103-182).  compress=None (the gate) keeps
    exact one-hot tables up to ROWS_MAX rows; above it, SVD-compressed
    tables where the rank ladder reaches COMPRESS_TOL, else exact one-hot
    tables up to WIDE_ROWS_MAX rows, else None (the lattice path).
    compress=True forces the compressed tables (the ladder's largest rank
    where no rank reaches the tolerance; ``residual`` says how far off),
    compress=False the exact ones.  site_row_counts ([n_rows_total] site
    counts) weights the centring of the compressed channels by the
    data's site mix.
    """
    device = parse_device(device)
    if len(rows_used) > COMPRESS_ROWS_MAX:
        raise ValueError(
            f"{len(rows_used)} distinct table rows (> {COMPRESS_ROWS_MAX}): "
            "past the hist gate, the engines take the lattice path"
        )
    s = max(int(decimate), 1)
    if compress or (compress is None and len(rows_used) > ROWS_MAX):
        M = (
            np.asarray(table_np, dtype=np.float64)[rows_used][
                :, np.arange(0, grid_points, s)]
            - np.asarray(null_row, dtype=np.float64)[rows_used][:, None]
        )
        svd, r, resid = _rank_ladder(M)
        if r is not None or compress:
            table_modes["compressed"] += 1
            return _build_hist_tables_compressed(
                table_np, grid_points, null_row, rows_used, extent_bp, svd,
                r or COMPRESS_RANKS[-1], resid, n_alpha=n_alpha,
                row_pad=row_pad, decimate=decimate,
                site_row_counts=site_row_counts, device=device,
            )
        if len(rows_used) > WIDE_ROWS_MAX:
            return None
    table_modes["exact" if len(rows_used) <= ROWS_MAX else "exact_wide"] += 1
    if s > 1:
        cols = np.arange(0, grid_points, s)
        table_np = np.asarray(table_np)[:, cols]
        step = (LOG_AD_MAX - LOG_AD_MIN) / (grid_points - 1) * s
        grid_points = len(cols)
    else:
        step = (LOG_AD_MAX - LOG_AD_MIN) / (grid_points - 1)
    G = grid_points
    inv_step = 1.0 / step
    NC = min(G, int(np.log(max(float(extent_bp), 2.0)) * inv_step) + 2)
    q = dense_alpha_offsets(G, n_alpha)
    A = len(q)
    rows_used = np.asarray(rows_used, dtype=np.int64)
    Ru = len(rows_used)
    R = -(-Ru // row_pad) * row_pad
    row_map = np.full(np.asarray(table_np).shape[0], R, dtype=np.int32)
    row_map[rows_used] = np.arange(Ru, dtype=np.int32)

    i = np.arange(NC)[:, None]
    idx0 = i + q[None, :]  # [NC, A]
    active = (idx0 <= G - 1).astype(np.float32)
    dev = torch.device(device)
    sub_d = torch.as_tensor(
        np.asarray(table_np)[rows_used].astype(np.float32), device=dev
    )
    nr_d = torch.as_tensor(
        np.asarray(null_row, dtype=np.float64)[rows_used].astype(np.float32),
        device=dev,
    )
    idx0_d = torch.as_tensor(np.clip(idx0, 0, G - 1), device=dev)
    idx1_d = torch.as_tensor(np.clip(idx0 + 1, 0, G - 1), device=dev)
    act_d = torch.as_tensor(active, device=dev)
    lalpha = (LOG_AD_MIN + q.astype(np.float64) * step).astype(np.float32)
    return HistTables(
        t3=_device_pack(sub_d, nr_d, idx0_d, idx1_d, act_d, row_pad=R),
        rows_used=rows_used,
        row_map=row_map,
        n_cells=NC,
        n_rows=R,
        n_alpha=A,
        grid_points=G,
        step=float(step),
        offsets=q,
        lalpha=lalpha,
    )


def _rank_ladder(M, tol=COMPRESS_TOL):
    """((U, S, Vt), r, residual) of M's f64 SVD: r the smallest rank of
    COMPRESS_RANKS whose largest entry residual is below tol (all of S
    where a rank reaches its length), or None where none does; residual
    that rank's, or the largest rank's where r is None."""
    U, S, Vt = np.linalg.svd(M, full_matrices=False)
    r, resid = None, None
    for cand_r in COMPRESS_RANKS:
        k = min(cand_r, len(S))
        resid = float(np.abs(M - (U[:, :k] * S[:k]) @ Vt[:k]).max())
        if cand_r >= len(S):
            r = len(S)
            break
        if resid < tol:
            r = cand_r
            break
    return (U, S, Vt), r, resid


def _build_hist_tables_compressed(table_np, grid_points, null_row, rows_used,
                                  extent_bp, svd, r, resid, *, n_alpha,
                                  row_pad, decimate, site_row_counts, device):
    """SVD row compression, the mixed-depth mode
    (fscl_tpu/ops/histclr.py:198-295, same numpy operations in the same
    order, so weights and t3 equal the JAX package's on one machine).

    M[row, g] = table - null at the decimated columns is numerically low
    rank where depths derive from one spectrum by smooth downsampling
    (many depths); the frequency classes of one large depth are not.  The
    f64 SVD M ~= Uw @ V at rank r (_rank_ladder: svd, r and its entry
    residual resid) gives each row an f32 weight vector Uw[row] in place
    of its one-hot indicator.  Channels are centred by the site-mix mean
    (prefix magnitudes then grow as sqrt(W)), and one count channel
    restores the means exactly through the pack row mu @ V.
    """
    s = max(int(decimate), 1)
    step = (LOG_AD_MAX - LOG_AD_MIN) / (grid_points - 1) * s
    G = len(range(0, grid_points, s))
    inv_step = 1.0 / step
    NC = min(G, int(np.log(max(float(extent_bp), 2.0)) * inv_step) + 2)
    q = dense_alpha_offsets(G, n_alpha)
    A = len(q)
    rows_used = np.asarray(rows_used, dtype=np.int64)
    Ru = len(rows_used)
    row_map = np.full(np.asarray(table_np).shape[0], Ru, dtype=np.int32)
    row_map[rows_used] = np.arange(Ru, dtype=np.int32)

    U, S, Vt = svd
    Uw = U[:, :r] * S[:r]  # [Ru, r]
    V = Vt[:r]  # [r, G]

    if site_row_counts is not None:
        cnt = np.asarray(site_row_counts, dtype=np.float64)[rows_used]
    else:
        cnt = np.ones(Ru)
    mu = (cnt @ Uw) / max(cnt.sum(), 1.0)  # site-mix channel means
    Vhat = np.concatenate([V, (mu @ V)[None, :]], axis=0)  # [r+1, G]
    Wt = np.concatenate(
        [Uw - mu[None, :], np.ones((Ru, 1))], axis=1
    )  # [Ru, r+1]: centred channels + count channel

    R = -(-(r + 1) // row_pad) * row_pad
    Wt = np.pad(Wt, ((0, 1), (0, R - (r + 1))))  # + zero sentinel row
    Vhat = np.pad(Vhat, ((0, R - (r + 1)), (0, 0)))

    i = np.arange(NC)[:, None]
    idx0 = i + q[None, :]
    active = (idx0 <= G - 1).astype(np.float32)
    dev = torch.device(device)
    sub_d = torch.as_tensor(Vhat.astype(np.float32), device=dev)  # [R, G]
    nr_d = torch.zeros(R, dtype=torch.float32, device=dev)  # null inside M
    idx0_d = torch.as_tensor(np.clip(idx0, 0, G - 1), device=dev)
    idx1_d = torch.as_tensor(np.clip(idx0 + 1, 0, G - 1), device=dev)
    act_d = torch.as_tensor(active, device=dev)
    lalpha = (LOG_AD_MIN + q.astype(np.float64) * step).astype(np.float32)
    return HistTables(
        t3=_device_pack(sub_d, nr_d, idx0_d, idx1_d, act_d, row_pad=R),
        rows_used=rows_used,
        row_map=row_map,
        n_cells=NC,
        n_rows=R,
        n_alpha=A,
        grid_points=G,
        step=float(step),
        offsets=q,
        lalpha=lalpha,
        weights=torch.as_tensor(Wt.astype(np.float32), device=dev),
        residual=resid,
    )


def _device_pack(sub_d, nr_d, idx0_d, idx1_d, act_d, *, row_pad):
    """[2*NC*row_pad, A] pack = (table[r, cell+q] - null[r]) * active."""
    t0 = sub_d[:, idx0_d].permute(1, 0, 2) - nr_d[None, :, None]
    t1 = sub_d[:, idx1_d].permute(1, 0, 2) - nr_d[None, :, None]
    t0 = t0 * act_d[:, None, :]
    t1 = t1 * act_d[:, None, :]
    out = torch.stack([t0, t1])  # [2, NC, Ru, A]
    out = torch.nn.functional.pad(out, (0, 0, 0, row_pad - t0.shape[1]))
    nc, a = act_d.shape
    return out.reshape(2 * nc * row_pad, a).contiguous()


@dataclasses.dataclass
class HistPoints:
    """Run geometry for one fixed candidate set."""

    bounds: torch.Tensor  # [C, 2, NC+1] i32 prefix indices into the sites
    fbar: torch.Tensor  # [C, 2, NC] f32 per-run interpolation fraction
    n_cand: int  # C (padded)
    n_real: int  # real candidate count


_LIMB_BITS = 20  # position prefix limbs: S = hi * 2^20 + lo


def build_pos_prefix(pos_np, device="cuda"):
    """[W+1, 2] int32 limbs (hi, lo) of the exact position prefix sum.

    fbar's f32 arithmetic (hi * 2^20 + lo, fscl_tpu/ops/histclr.py:
    440-449) is kept in the same order so fbar agrees with the JAX
    package to f32 rounding."""
    device = parse_device(device)
    pos = np.asarray(pos_np, dtype=np.int64)
    ps = np.zeros(len(pos) + 1, dtype=np.int64)
    np.cumsum(pos, out=ps[1:])
    assert ps[-1] < (1 << (31 + _LIMB_BITS)), "position prefix overflows limbs"
    return torch.as_tensor(
        np.stack(
            [
                (ps >> _LIMB_BITS).astype(np.int32),
                (ps & ((1 << _LIMB_BITS) - 1)).astype(np.int32),
            ],
            axis=1,
        ),
        device=device,
    )


def _block_search(block_tab, qbits, q):
    """Exact vectorized searchsorted(pos, q, 'left') via the block table:
    block_tab[b] = [coarse_b, pos[coarse_b : coarse_b + K]]."""
    qb = torch.clamp(q >> qbits, 0, block_tab.shape[0] - 1)
    row = block_tab[qb.to(torch.int64)]  # [..., 1 + K]
    return row[..., 0] + (row[..., 1:] < q[..., None]).sum(
        -1, dtype=torch.int32
    )


_POINTS_CHUNK = 4096  # candidates per geometry chunk (bounds temporaries)


def _device_points(ps_hl, d_ceil, block_tab, cand, lo, hi, sp, *, qbits):
    """Run boundaries + run-mean fractions (fscl_tpu/ops/histclr.py:358,
    quantum=0): bounds [C, 2, NC+1] i32, signed run lengths h [C, 2, NC]
    and mean distances dbar [C, 2, NC] f32."""
    out_b, out_h, out_d = [], [], []
    sign = torch.tensor([-1, 1], dtype=torch.int32, device=cand.device)
    for c0 in range(0, cand.shape[0], _POINTS_CHUNK):
        cand_c = cand[c0:c0 + _POINTS_CHUNK]
        lo_c = lo[c0:c0 + _POINTS_CHUNK]
        hi_c = hi[c0:c0 + _POINTS_CHUNK]
        sp_c = sp[c0:c0 + _POINTS_CHUNK]
        qL = cand_c[:, None] - d_ceil[None, :] + 1  # [chunk, NC]
        qR = cand_c[:, None] + d_ceil[None, :]
        BL = _block_search(block_tab, qbits, qL)
        BR = _block_search(block_tab, qbits, qR)
        BL = torch.minimum(torch.maximum(BL, lo_c[:, None]), sp_c[:, None])
        BR = torch.minimum(torch.maximum(BR, sp_c[:, None]),
                           hi_c[:, None] + 1)
        bounds = torch.stack(
            [torch.cat([sp_c[:, None], BL], 1),
             torch.cat([sp_c[:, None], BR], 1)], 1,
        ).to(torch.int32)  # [chunk, 2, NC+1]
        hl = ps_hl[bounds.to(torch.int64)]  # [chunk, 2, NC+1, 2]
        dh = hl[:, :, 1:, 0] - hl[:, :, :-1, 0]
        dl = hl[:, :, 1:, 1] - hl[:, :, :-1, 1]
        h = (bounds[:, :, 1:] - bounds[:, :, :-1]) * sign[None, :, None]
        s = (dh.to(torch.float32) * float(1 << _LIMB_BITS)
             + dl.to(torch.float32)) * sign[None, :, None].to(torch.float32)
        pbar = s / torch.clamp(h, min=1).to(torch.float32)
        dbar = torch.abs(pbar - cand_c[:, None, None].to(torch.float32))
        out_b.append(bounds)
        out_h.append(h)
        out_d.append(dbar)
    return torch.cat(out_b), torch.cat(out_h), torch.cat(out_d)


def build_hist_points(ht: HistTables, pos_np, cand_pos, eval_range,
                      cand_pad=64, device_arrays=None):
    """Run boundaries + mean-position fractions for a fixed candidate set
    (fscl_tpu/ops/histclr.py:461, quantum=0).

    Host does the O(C) window geometry (exact int64); the O(C * NC)
    boundary search and fraction math run on the tables' device.
    """
    pos = np.asarray(pos_np, dtype=np.int64)
    cand = np.asarray(cand_pos, dtype=np.int64)
    Creal = len(cand)
    C = -(-max(Creal, 1) // cand_pad) * cand_pad
    NC = ht.n_cells
    inv_step = 1.0 / ht.step
    dev = ht.t3.device

    _, lo, hi = candidate_windows(pos, cand, eval_range)
    sp = np.clip(np.searchsorted(pos, cand, side="left"), lo, hi + 1)
    cand_p = np.pad(cand, (0, C - Creal))
    lo_p = np.pad(lo, (0, C - Creal), constant_values=1)
    hi_p = np.pad(hi, (0, C - Creal), constant_values=0)
    sp_p = np.pad(sp, (0, C - Creal), constant_values=1)

    if device_arrays is None:
        device_arrays = make_hist_device_arrays(ht, pos)

    def up(x):
        return torch.as_tensor(x.astype(np.int32), device=dev)

    bounds, h, dbar = _device_points(
        *device_arrays[:-1], up(cand_p), up(lo_p), up(hi_p), up(sp_p),
        qbits=device_arrays[-1],
    )
    logd = log_distance(dbar)
    icell = torch.arange(NC, dtype=torch.float32, device=dev)[None, None, :]
    fbar = torch.clamp(logd * inv_step - icell, 0.0, 1.0)
    fbar = torch.where(h > 0, fbar, 0.5).to(torch.float32)
    return HistPoints(bounds=bounds, fbar=fbar, n_cand=C, n_real=Creal)


_SLAB_K = 16  # sites per contiguous slab fetched by _block_search
_IDX_TAB_MAX = 4_000_000  # block-table size cap


def _choose_block_table(pos, qbits=None):
    """(qbits, idx_tab) with <= _SLAB_K sites per 2^qbits-bp block, or
    (None, None) when no table within _IDX_TAB_MAX entries achieves it."""
    pos = np.asarray(pos, dtype=np.int64)
    max_pos = int(pos[-1]) if len(pos) else 0
    rng = range(16, 0, -1) if qbits is None else (qbits,)
    for qb in rng:
        n_blk = (max_pos >> qb) + 2
        if n_blk > _IDX_TAB_MAX:
            return None, None
        idx_tab = np.searchsorted(
            pos, np.arange(n_blk, dtype=np.int64) << qb, side="left"
        )
        if np.diff(idx_tab).max(initial=0) <= _SLAB_K:
            return qb, idx_tab
    return None, None


def hist_geometry_ok(pos_np) -> bool:
    """Whether the block-search geometry supports this chromosome."""
    q, _ = _choose_block_table(np.asarray(pos_np, dtype=np.int64))
    return q is not None


def dataset_qbits(pos_by_chr):
    """One shared block quantum for every chromosome (None if any fails)."""
    q = 16
    for pos in pos_by_chr:
        qc, _ = _choose_block_table(np.asarray(pos, dtype=np.int64))
        if qc is None:
            return None
        q = min(q, qc)
    return q


def make_hist_device_arrays(ht: HistTables, pos_np, qbits=None):
    """Chromosome-resident inputs for build_hist_points:
    (pos prefix limbs, d_ceil, block table, qbits)."""
    dev = ht.t3.device
    pos = np.asarray(pos_np, dtype=np.int64)
    n = len(pos)
    d_ceil = np.ceil(
        np.exp(np.arange(1, ht.n_cells + 1, dtype=np.float64) * ht.step)
    ).astype(np.int64)
    w_pad = max(-(-n // 4096) * 4096, 4096)
    pos_zero = np.zeros(w_pad, dtype=np.int64)
    pos_zero[:n] = pos  # zero tail: prefix differences in the pad are 0
    ps_hl = build_pos_prefix(pos_zero, device=dev)

    qbits, idx_tab = _choose_block_table(pos, qbits=qbits)
    if qbits is None:
        raise ValueError(
            "site density too high for the block index table: past the "
            "hist gate, the engines take the lattice path"
        )
    nb_pad = max(-(-len(idx_tab) // 4096) * 4096, 4096)
    idx_tab = np.pad(idx_tab, (0, nb_pad - len(idx_tab)), constant_values=n)
    # block table rows [coarse_b, pos[coarse_b : coarse_b+K]] with
    # int32-max tail sentinels
    pos_sent = np.full(w_pad + _SLAB_K + 1, np.iinfo(np.int32).max,
                       dtype=np.int32)
    pos_sent[:w_pad] = np.iinfo(np.int32).max // 2
    pos_sent[:n] = pos
    win = np.stack(
        [pos_sent[idx_tab + k] for k in range(_SLAB_K)], axis=1
    )
    block_tab = np.concatenate(
        [idx_tab[:, None].astype(np.int32), win], axis=1
    )
    return (
        ps_hl,
        torch.as_tensor(
            np.minimum(d_ceil, np.iinfo(np.int32).max // 2).astype(np.int32),
            device=dev,
        ),
        torch.as_tensor(block_tab, device=dev),
        int(qbits),
    )


def make_row_index_group_table(row_compact, *, sentinel):
    """[G+1, PERM_GROUP] int16 compact-row-index table (thin gather form,
    fscl_tpu/ops/histclr.py:741).  Ids are clamped at ``sentinel`` (the
    tables' ``HistTables.sentinel``: R in one-hot mode, where it expands
    to an all-zero one-hot row; R_used in compressed mode, where it reads
    the zero weight row), which also fills the tail pad and the sentinel
    row G.  In compressed mode this replaces the fat [G+1, PERM_GROUP*R]
    f32 table of make_row_weight_group_table (histclr.py:789): the
    permutation stream gathers int16 ids and expands them through the
    [R_used+1, R] weight table (R_used <= COMPRESS_ROWS_MAX fits int16)."""
    W = row_compact.shape[0]
    G = -(-W // PERM_GROUP) if W else 1
    idx = torch.clamp(row_compact.to(torch.int32), max=sentinel)
    idx = torch.nn.functional.pad(
        idx, (0, G * PERM_GROUP - W), value=sentinel
    ).reshape(G, PERM_GROUP)
    idx = torch.nn.functional.pad(idx, (0, 0, 0, 1), value=sentinel)
    return idx.to(torch.int16).contiguous()


def build_prefix_sums_seg(table, sig, seg_g0, *, w_seg_p, n_rows,
                          weights=None):
    """[S*w_seg_p, P*n_rows] segmented prefix sums of the permuted stream.

    Dispatches to the fused gather + expand + scan (ops/prefix_sums.py):
    one-hot counts, or with ``weights`` ([R_used+1, n_rows] f32) f32 sums
    of weight channels.  The plain version runs for CPU tensors, the CUDA
    kernel for CUDA tensors.
    """
    if weights is None:
        return onehot_prefix_sums(
            table, sig, seg_g0, w_seg_p=w_seg_p, n_rows=n_rows
        )
    return weighted_prefix_sums(table, weights, sig, seg_g0, w_seg_p=w_seg_p)


def build_prefix_sums_oh(table, sig, *, start, n, w_pad, n_rows):
    """[w_pad+1, P*n_rows] prefix sums of one chromosome's permuted
    one-hot stream, row 0 zero (fscl_tpu/ops/histclr.py:811 with the
    gather, shift and mask of its caller _perm_ps fused in front:
    ops/prefix_sums.py:perm_prefix_sums, a CUDA kernel on the card).
    int16 where counts fit (w_pad <= 32767), else int32."""
    return perm_prefix_sums(table, sig, start=start, n=n, w_pad=w_pad,
                            n_rows=n_rows)


def build_prefix_sums(row_rep, *, n_rows):
    """[W+1, P*n_rows] one-hot prefix sums of replicate-stacked row ids,
    row 0 zero (fscl_tpu/ops/histclr.py:873).

    row_rep: [P, W] integer compact row ids per replicate (ids >= n_rows
    count nowhere).  int16 where counts fit (W <= 32767), else int32.
    ops/prefix_sums.py:rowid_prefix_sums builds them: a CUDA kernel on
    the card, the plain version on the CPU.
    """
    return rowid_prefix_sums(row_rep.to(torch.int32).contiguous(),
                             n_rows=n_rows)


def build_site_prefix(row_compact, *, n_rows):
    """[W+1, R] int32 prefix of the unpermuted genome one-hot stream
    (fscl_tpu/ops/histclr.py:930): built once a permutation run, the
    table rdp_clr_reps assembles every replicate's permuted prefix from.
    The row-id prefix sum of one replicate (rowid_prefix_sums, mode (a):
    the chained-scan kernel on the card; a cumsum along the sites there
    runs one thread a row lane, 6 s at 14M sites and 216 rows)."""
    return rowid_prefix_sums(row_compact.to(torch.int32)[None].contiguous(),
                             n_rows=n_rows, out_dtype=torch.int32)


def _clr_from_windows(ps, bounds, fbar, t3, *, n_rep, n_cells, n_rows,
                      n_alpha, mm_bf16):
    """2 * contraction of the window operand with the table pack, shared
    by hist_clr_reps_ps and rdp_clr_reps; [c, P, A] f32.

    ps: [*, P*R] prefix rows; bounds: [c, 2, NC+1] int32 rows of ps;
    fbar: [c, 2, NC]; t3: [2*NC*R, A] f32 pack.  The operand is built and
    contracted in one kernel on the card (ops/window_clr.py): mm_bf16 (the
    JAX package's bfloat16 operands, float32 products and sums)
    window_clr against the pack rounded once (bf16_pack); else
    window_clr_f32, float32-accurate products against f32_pack.
    """
    kw = dict(n_rep=n_rep, n_cells=n_cells, n_rows=n_rows, n_alpha=n_alpha)
    if mm_bf16:
        return window_clr(ps, bounds, fbar, bf16_pack(t3), **kw)
    return window_clr_f32(ps, bounds, fbar, f32_pack(t3), **kw)


def _clr_from_windows_plain(ps, bounds, fbar, t3, *, n_rep, n_cells, n_rows,
                            n_alpha, mm_bf16):
    """_clr_from_windows through the plain versions of both kernels."""
    kw = dict(n_rep=n_rep, n_cells=n_cells, n_rows=n_rows, n_alpha=n_alpha)
    if mm_bf16:
        return window_clr_plain(ps, bounds, fbar, bf16_pack(t3), **kw)
    return window_clr_f32_plain(ps, bounds, fbar, f32_pack(t3), **kw)


def _chunk_rows(n_cells, n_rep, n_rows):
    """Candidates per rdp_clr_reps chunk: the assembled [c, 2, NC+1, P*R]
    prefix rows stay within CHUNK_BYTES at 4 bytes an entry."""
    return max(1, CHUNK_BYTES // max(2 * (n_cells + 1) * n_rep * n_rows * 4,
                                     1))


def hist_clr_reps_ps(t3, bounds, fbar, ps, *, n_rep, n_cells, n_rows,
                     n_alpha, mm_bf16=False, clr_fn=_clr_from_windows):
    """CLR[p, c, a] given prebuilt prefix sums ps [W+1, P*R]
    (fscl_tpu/ops/histclr.py:1078).

    clr_fn (_clr_from_windows, or _clr_from_windows_plain) turns the
    windows into the statistic: the bounds gather ps[bounds], the signed
    adjacent difference in the prefix dtype -- int16 wraps mod 2^16
    exactly as the JAX package's mod-2^16 rule relies on -- the fbar lerp
    and the contraction.  mm_bf16 rounds both operands to bfloat16 and
    keeps the float32 product and accumulation (the JAX package's bf16
    inputs with preferred_element_type=f32).  Neither route writes the
    operand, so every candidate goes in one call.  Returns [P, C, A] f32.
    """
    return clr_fn(
        ps, bounds, fbar, t3, n_rep=n_rep, n_cells=n_cells, n_rows=n_rows,
        n_alpha=n_alpha, mm_bf16=mm_bf16,
    ).permute(1, 0, 2)


def hist_clr_reps(t3, bounds, fbar, row_rep, *, n_cells, n_rows, n_alpha,
                  mm_bf16=False):
    """CLR[p, c, a] for every (replicate, candidate, lattice alpha) from
    per-replicate row ids (fscl_tpu/ops/histclr.py:907).

    Run geometry is replicate-invariant, so the replicates stack into the
    prefix columns: build_prefix_sums of row_rep ([P, W] int32 compact
    row ids of each permuted stream), then hist_clr_reps_ps.  Returns
    [P, C, A] f32.
    """
    ps = build_prefix_sums(row_rep, n_rows=n_rows)
    return hist_clr_reps_ps(
        t3, bounds, fbar, ps, n_rep=row_rep.shape[0], n_cells=n_cells,
        n_rows=n_rows, n_alpha=n_alpha, mm_bf16=mm_bf16,
    )


def rdp_clr_reps(t3, bounds_gen, fbar, psite, src_starts, dst_starts,
                 sizes, *, n_rep, n_cells, n_rows, n_alpha, pg, n_groups,
                 mm_bf16=False):
    """CLR[p, c, a] via the run-decomposed permuted prefix (RDP,
    fscl_tpu/ops/histclr.py:951).

    A replicate's block permutation is B contiguous source runs: output
    groups [dst[k], dst[k] + sz[k]) take source groups [src[k], ...)
    (ops/permute.py:block_permutation_runs).  Its permuted one-hot prefix
    at genome site b telescopes to

        A(b) = D[k(b)] + psite[sigma8[b // pg] * pg + b % pg]

    with k(b) the run of b's group, D[k] = (exclusive prefix of the run
    totals)[k] - psite[src[k] * pg], and psite the unpermuted site prefix
    (build_site_prefix).  Per (bound, replicate) that is two row gathers
    against precomputed tables, so the cost follows bounds x replicates,
    not sites x replicates.

    Layout: the small per-group tables (run id and source group, [G, P])
    are transposed and row-gathered at the bound groups, so the large
    gathers d_flat[k + p_off] + psite[src_site] (row_gather, a CUDA
    kernel on the card) land directly in [M, P, R] consumption order;
    nothing large is transposed.  Their int32 sum, read through identity
    bounds, gives window differences equal to the stacked prefix
    differences exactly (the same integers), and _clr_from_windows turns
    them into the same statistic.

    bounds_gen: [C, 2, NC+1] int32 genome-site bounds (all-zero rows, the
    padding candidates, give h = 0 and CLR exactly 0); fbar [C, 2, NC];
    psite [W+1, R] int32; src/dst/sizes: [P, B] int32 group-level runs;
    n_groups = G.  Returns [P, C, A] f32.
    """
    NC, R, A, P = n_cells, n_rows, n_alpha, n_rep
    tabs = _rdp_tables(psite, src_starts, dst_starts, sizes, pg=pg,
                       n_groups=n_groups)
    C = bounds_gen.shape[0]
    c_sub = _chunk_rows(NC, P, R)
    ident = torch.arange(min(C, c_sub) * 2 * (NC + 1), dtype=torch.int32,
                         device=psite.device)
    outs = []
    for c0 in range(0, C, c_sub):
        bc = bounds_gen[c0:c0 + c_sub]
        c, M = bc.shape[0], bc.numel()
        d_idx, s_idx = _rdp_rows(bc, tabs, pg=pg, n_sites1=psite.shape[0])
        # [M*P, R] int32: the assembled prefix rows in consumption order
        a = row_gather(tabs[0], d_idx) + row_gather(psite, s_idx)
        # identity bounds: window j of candidate c reads assembled rows
        # (c, s, j) and (c, s, j+1), as the stacked path reads ps rows
        outs.append(_clr_from_windows(
            a.view(M, P * R), ident[:M].view(c, 2, NC + 1),
            fbar[c0:c0 + c_sub], t3, n_rep=P, n_cells=NC, n_rows=R,
            n_alpha=A, mm_bf16=mm_bf16,
        ))
    out = torch.cat(outs) if outs else t3.new_zeros((0, P, A))
    return out.permute(1, 0, 2)


def _rdp_tables(psite, src_starts, dst_starts, sizes, *, pg, n_groups):
    """Per-slice tables of rdp_clr_reps: (d_flat [P*B, R] int32 run
    constants D, run_of_t [G, P] and sigma8_t [G, P] int64 per-group run
    ids and source groups, p_off [1, P] row offsets of each replicate's
    runs in d_flat)."""
    P, B = src_starts.shape
    G = int(n_groups)
    W1, R = psite.shape
    dev = psite.device
    src = src_starts.to(torch.int64)
    dst = dst_starts.to(torch.int64)
    sz = sizes.to(torch.int64)

    # per-run constants D[p, k]: [P, B] row gathers and a small cumsum
    s_sites = torch.clamp(src * pg, 0, W1 - 1)
    e_sites = torch.clamp((src + sz) * pg, 0, W1 - 1)
    pst_s = psite[s_sites]  # [P, B, R]
    run_tot = psite[e_sites] - pst_s
    rps = torch.cumsum(run_tot, 1, dtype=torch.int32) - run_tot  # exclusive
    d_flat = (rps - pst_s).reshape(P * B, R)

    # per-group tables [G, P]: run ids (a 1 at each run's start + cumsum,
    # so empty runs' shared starts telescope to the owning run) and the
    # source group map (the sigma construction itself)
    ones = torch.zeros((P, G + 1), dtype=torch.int64, device=dev)
    ones.scatter_add_(1, dst, torch.ones_like(dst))  # dst == G is dropped
    run_of_t = (torch.cumsum(ones[:, :G], 1) - 1).T.contiguous()
    sigma8_t = sigma_from_runs(src, dst, G).to(torch.int64).T.contiguous()
    p_off = torch.arange(P, device=dev)[None, :] * B  # [1, P]
    return d_flat, run_of_t, sigma8_t, p_off


def _rdp_rows(bc, tabs, *, pg, n_sites1):
    """Row indices of rdp_clr_reps' two large gathers for bounds bc
    [c, 2, NC+1]: (d_flat rows, psite rows), each [M*P] int32 in (bound,
    replicate) order, M = bc.numel().  The bound's group and its source
    site are clamped into the tables here, so the gathers see only rows
    that exist."""
    _, run_of_t, sigma8_t, p_off = tabs
    G = run_of_t.shape[0]
    flat_b = bc.reshape(-1).to(torch.int64)  # [M] genome site bounds
    g_b = torch.clamp(flat_b // pg, 0, G - 1)
    o_b = flat_b - g_b * pg
    src_site = torch.clamp(sigma8_t[g_b] * pg + o_b[:, None], 0,
                           n_sites1 - 1)
    d_rows = run_of_t[g_b] + p_off  # [M, P]
    return (d_rows.reshape(-1).to(torch.int32),
            src_site.reshape(-1).to(torch.int32))
