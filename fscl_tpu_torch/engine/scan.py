"""Genome scan engine (port of fscl_tpu/engine/scan.py).

Reference: scan_chromosome (scan-chromosome.c:228-329).
The C bisects each coarse interval greedily to bp_resl; here every
fine-grid position of every interval is evaluated in one batch (dense
stage), the per-interval top branches are zoomed to sub-bp_resl pitch
(multi-branch refine), and the per-interval winners are reported.

Two evaluators.  The hist path (ops/histclr.py, on prefix sums built
once per chromosome, or once per chromosome and table on compressed
mixed-depth tables) adds SNP-anchored probes to the dense stage and
re-ranks every probed position within hist_tie_margin of the winner on
the decimate-2 lattice (tie resolution); when even that table is
coarser than exact_step_max, the tie pool is re-evaluated with the
per-site lattice kernel instead.  The lattice path (ops/lattice.py,
_ChromosomeBlock) runs every stage with the per-site kernel and its
three-stage alpha search: under --no-hist (use_hist=False) and for
datasets the hist engine does not cover (make_scan_hist_tables returns
None).

Under a split over ranks (parallel/), every dense, refine and decimate
stage meets in eval_stage: each rank evaluates its contiguous share of
the stage's candidates (all chromosomes' flats end to end), and the
stage's [2, C] is gathered to every rank, so that every rank makes the
same selections and holds the same ScanResult.  The tie stage is split
the same way (_eval_flats), so that a rank builds the tie table's
prefix sums only for the chromosomes of its share.  ``last_stats`` holds
the last scan's split_world, split_gather_s and split_gather_bytes.

Spans (utils/timing.py; recorded only while the recorder is on): the
call is ``scan.genome`` (a step); ``scan.tables`` the tables, prefix
sums and device arrays built for a cold data object (also where a stage
builds them at first use); ``scan.setup`` the chromosome states and SNP
probes; one ``scan.stage`` (attribute ``stage``: dense, refine, tie) a
stage, holding ``scan.eval`` (the host's enqueue of every chromosome's
statistic), ``scan.readback`` (the wait for it and the split's gather)
and ``scan.select`` (the numpy candidates and selections around it);
``scan.output`` the result's assembly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import LOG_AD_MAX, LOG_AD_MIN
from ..device import canonical, parse_device
from ..ops.histclr import (
    build_hist_points,
    build_hist_tables,
    dataset_qbits,
    hist_clr_reps_ps,
    hist_supported,
    make_hist_device_arrays,
)
from ..ops.lattice import LatticeTables, two_stage_lattice_max
from ..ops.windows import candidate_windows
from ..parallel import shard
from ..parallel.mesh import SOLO
from ..utils.logging import MSG_STATUS, cr_logmsg
from ..utils.timing import phase, span, traced

# the last scan_genome call's split: its world and its gathers' wall and
# received bytes (parallel/shard.py)
last_stats: dict = {}


@dataclasses.dataclass
class ScanConfig:
    """Same fields and defaults as fscl_tpu.engine.scan.ScanConfig."""

    eval_range: int = 81920  # +- SNPs per window (fscl.c:175)
    bp_resl: int = 128  # position refinement resolution (fscl.c:174)
    small_grid_sp: int = 1000  # fine grid pitch in bp (fscl.c:158)
    large_grid_sp: int = 100000  # coarse interval width in bp (fscl.c:159)
    chunk: int = 32  # kept for config compatibility (the lattice kernel
    # takes every candidate of a stage in one launch)
    hist_c_sub: int = 256  # kept for config compatibility
    refine: bool = True  # bp_resl refinement pass
    branch_k: int = 6  # dense-stage branches zoomed per interval
    branch_margin: float = 3.0
    dispatch_cap: int = 4096 * 24576  # kept for config compatibility
    use_hist: bool = True  # False: the per-site lattice path everywhere
    hist_alphas: int = 128
    hist_tie_margin: float = 2.0  # probes this close to the winner re-rank
    hist_tie_cap: int = 8  # tie-resolution candidates per interval
    tie_decimate: int = 2  # lattice decimation of the tie stage
    exact_step_max: float = 0.035  # coarser tie tables: exact lattice
    # re-evaluation of the tie pool
    refine_halfwidth: int = 4
    refine_subresl: bool = True
    dense_stride: int = 1
    selection_bf16: bool = True  # bf16 contraction in dense/refine stages
    snp_probes: bool = True
    snp_probe_min_gain: float = 0.25
    hist_decimate: int = 8  # lattice decimation of the selection stages


@dataclasses.dataclass
class ScanResult:
    """One entry per coarse interval (the reference's scan_pt_t array)."""

    chr_id: np.ndarray  # [K] i32
    sweep_pos: np.ndarray  # [K] i64
    clr: np.ndarray  # [K] f64
    lalpha: np.ndarray  # [K] f64
    nearest: np.ndarray  # [K] global site index
    window_start: np.ndarray  # [K] global site index
    window_end: np.ndarray  # [K] global site index
    interval_start: np.ndarray  # [K] bp (coarse interval, for permutation)
    interval_end: np.ndarray  # [K] bp
    permute_n: np.ndarray  # [K] i64
    permute_p: np.ndarray  # [K] i64
    permute_finished: np.ndarray  # [K] bool
    null_clr: list  # per point: list of saved null CLRs
    # observed value of the permutation statistic (the threshold the
    # exceedance counts compare against); NaN until permuted
    stat_threshold: np.ndarray = None

    @property
    def n_points(self) -> int:
        return len(self.sweep_pos)


def chromosome_candidates(cl, cfg, stride=1):
    """Fine-grid candidates for one chromosome: (cand [n_int, J],
    valid [n_int, J], istart [n_int], iend [n_int]).

    Intervals start at start_pos + k*large_grid_sp while < bp_length
    (scan-chromosome.c:177-204); each has candidates at small_grid_sp
    pitch (x stride) plus the clamped interval end."""
    coarse = cfg.large_grid_sp
    fine = cfg.small_grid_sp * max(int(stride), 1)
    cpf = coarse // fine
    starts = np.arange(cl.start_pos, cl.bp_length, coarse, dtype=np.int64)
    if len(starts) == 0:
        starts = np.array([cl.start_pos], dtype=np.int64)
    ends = np.minimum(starts + coarse, cl.bp_length)
    J = cpf + 2
    j = np.arange(cpf + 1, dtype=np.int64)
    cand = np.empty((len(starts), J), dtype=np.int64)
    cand[:, : cpf + 1] = starts[:, None] + j[None, :] * fine
    cand[:, cpf + 1] = ends
    valid = cand <= ends[:, None]
    cand = np.minimum(cand, ends[:, None])
    return cand, valid, starts, ends


def _port_cache(data, device):
    """Per-dataset memo of the port's tables and device arrays.

    Kept under its own attribute (the JAX package caches its own arrays
    on the same SNPData) and dropped whenever the dataset's row array is
    replaced (attach_model) or another device is asked for."""
    device = canonical(device)
    c = getattr(data, "_torch_port_cache", None)
    if c is None or c["row"] is not data.row or c["device"] != device:
        c = {"row": data.row, "device": device}
        data._torch_port_cache = c
    return c


def make_scan_hist_tables(data, tables, n_alpha=128, decimate=1,
                          device="cuda"):
    """Genome-wide HistTables (memoized per (n_alpha, decimation)), or
    None where the hist engine does not cover the dataset (more than
    COMPRESS_ROWS_MAX distinct rows, a chromosome over SITES_MAX sites,
    sites too dense for the block table, or more than WIDE_ROWS_MAX rows
    that the rank ladder cannot compress): callers then take the lattice
    path (fscl_tpu/engine/scan.py:710-761).

    Decimation is capped so the decimated lattice step stays under ~0.1
    log_ad units.  Above ROWS_MAX distinct rows the tables are
    SVD-compressed, their channels centred by the dataset's site mix,
    where the rank ladder reaches its tolerance, else exact one-hot
    (build_hist_tables decides, once a table set)."""
    device = parse_device(device)
    base_step = (LOG_AD_MAX - LOG_AD_MIN) / max(tables.grid_points - 1, 1)
    decimate = max(1, min(int(decimate), int(0.1 / base_step)))
    cache = _port_cache(data, device)
    key = ("tables", n_alpha, decimate)
    if key in cache:
        return cache[key]
    row = np.asarray(data.row)
    rows_used = np.unique(row)
    max_n = max((cl.n_snps for cl in data.chr_limits), default=0)
    extents = [
        int(data.pos[cl.start_index + cl.n_snps - 1]
            - data.pos[cl.start_index])
        for cl in data.chr_limits if cl.n_snps > 0
    ]
    qb = dataset_qbits([
        data.pos[cl.start_index : cl.start_index + cl.n_snps]
        for cl in data.chr_limits if cl.n_snps > 0
    ])
    if not (hist_supported(len(rows_used), max_n) and extents
            and qb is not None):
        cache[key] = None
        return None
    cache["qbits"] = qb
    null_row = np.zeros(tables.table.shape[0])
    null_row[row] = np.asarray(data.null_logl)
    with span("scan.tables"):
        ht = build_hist_tables(
            tables.table, tables.grid_points, null_row, rows_used,
            extent_bp=max(extents) + 1, n_alpha=n_alpha, decimate=decimate,
            site_row_counts=np.bincount(row,
                                        minlength=tables.table.shape[0]),
            device=device,
        )
    cache[key] = ht
    return ht


def get_hist_device_arrays(data, ht, pos_np, start_index):
    """Memoized make_hist_device_arrays for one chromosome of a dataset."""
    cache = _port_cache(data, ht.t3.device)
    qb = cache.get("qbits")
    key = ("dev", start_index, len(pos_np), qb, ht.n_cells,
           round(float(ht.step), 12))
    if key not in cache:
        with span("scan.tables"):
            cache[key] = make_hist_device_arrays(ht, pos_np, qbits=qb)
    return cache[key]


def get_lattice_tables(tables, device="cuda"):
    """Memoized LatticeTables of a model on one device: the three packs
    are built on the host and uploaded once per (tables, device), at the
    first scan or permutation run that needs them."""
    device = parse_device(device)
    memo = getattr(tables, "_torch_lattice", None)
    if memo is None:
        memo = tables._torch_lattice = {}
    if str(device) not in memo:
        with phase("lattice-pack", device):
            memo[str(device)] = LatticeTables.from_table(
                tables.table, tables.grid_points, device=device)
    return memo[str(device)]


class _ChromosomeBlock:
    """One chromosome's sites on the device for the lattice kernel
    (fscl_tpu/engine/scan.py:227-367 without the dispatch-cap splitting:
    every candidate of a stage goes in one launch)."""

    def __init__(self, data, cl, lt):
        sl = slice(cl.start_index, cl.start_index + cl.n_snps)
        self.lt = lt
        self.pos_np = np.asarray(data.pos[sl])
        cache = _port_cache(data, lt.device)
        key = ("blk", cl.start_index, cl.n_snps)
        if key not in cache:
            dev = lt.device
            cache[key] = (
                torch.as_tensor(self.pos_np.astype(np.int32), device=dev),
                torch.as_tensor(np.asarray(data.row[sl], dtype=np.int32),
                                device=dev)[None],
                torch.as_tensor(np.asarray(data.null_logl[sl],
                                           dtype=np.float32),
                                device=dev)[None],
            )
        self.pos, self.row, self.null = cache[key]

    def eval_device(self, cand_flat, cfg):
        """[2, P] device (max CLR, lalpha) of the three-stage lattice
        alpha search at each candidate position."""
        _, lo, hi = candidate_windows(self.pos_np, cand_flat, cfg.eval_range)
        cand, lo, hi = (torch.as_tensor(np.asarray(x).astype(np.int32),
                                        device=self.lt.device)
                        for x in (cand_flat, lo, hi))
        clr, la = two_stage_lattice_max(self.lt, self.row, self.pos,
                                        self.null, cand, lo, hi)
        return torch.stack([clr[0], la[0]])


def _eval_flats(evaluate, states, flats, split):
    """[(clr, la)] of every chromosome's flat, one readback:
    evaluate(st, piece) -> [2, len(piece)] on the device for this rank's
    share of the flats end to end (all of them in a world of one), the
    whole gathered to every rank."""
    n = sum(len(f) for f in flats)
    r0, r1 = shard.split_range(n, split)
    pend, off = [], 0
    with span("scan.eval"):
        for st, f in zip(states, flats):
            a, b = max(r0 - off, 0), min(r1 - off, len(f))
            if a < b:
                pend.append(evaluate(st, f[a:b]))
            off += len(f)
    with span("scan.readback"):
        mine = (torch.cat(pend, 1).cpu().numpy() if pend
                else np.zeros((2, 0), np.float32))
        host = shard.gather_cols(mine, n, split)
    outs, off = [], 0
    for f in flats:
        outs.append((host[0, off:off + len(f)], host[1, off:off + len(f)]))
        off += len(f)
    return outs


def _dataset_mod16(data, ht):
    """Whether int16 mod-2^16 prefix sums are exact for every chromosome:
    every per-(chromosome, row) site count fits in int16.  Never under
    weights (f32 prefix sums)."""
    if ht.weights is not None:
        return False
    cache = _port_cache(data, ht.t3.device)
    key = ("mod16", ht.n_rows)
    if key not in cache:
        row = ht.row_map[np.asarray(data.row)]
        mx = 0
        for cl in data.chr_limits:
            if cl.n_snps == 0:
                continue
            sl = slice(cl.start_index, cl.start_index + cl.n_snps)
            mx = max(mx, int(np.bincount(row[sl]).max()))
        cache[key] = mx <= 32767
    return cache[key]


def _chrom_row_stream(data, ht, st):
    """[w_pad] compact-row stream of one chromosome, padded to the
    4096-site quantum with the sentinel row id (which counts nowhere: R in
    one-hot mode, the zero weight row R_used in compressed mode)."""
    cache = _port_cache(data, ht.t3.device)
    n = st.cl.n_snps
    w_pad = max(-(-n // 4096) * 4096, 4096)
    key = ("chrom-row", st.cl.start_index, n, ht.n_rows, ht.sentinel)
    if key not in cache:
        rc = np.full(w_pad, ht.sentinel, dtype=np.int32)
        sl = slice(st.cl.start_index, st.cl.start_index + n)
        rc[:n] = ht.row_map[np.asarray(data.row[sl])]
        cache[key] = torch.as_tensor(rc, device=ht.t3.device)
    return cache[key]


def _build_scan_ps(row_c, *, n_rows, mod16):
    """[w_pad+1, R] one-hot prefix sums of one chromosome's site stream
    (single replicate; fscl_tpu builds these with an XLA cumsum too).
    ``mod16`` keeps int16 through mod-2^16 wraparound.  The cumsum
    writes behind the zero row in place: at 216 rows a 1.25M-site
    chromosome's [W+1, R] int32 prefix is 1.1 GB."""
    W = row_c.shape[0]
    oh = row_c[:, None] == torch.arange(
        n_rows, dtype=row_c.dtype, device=row_c.device
    )
    ps = torch.zeros((W + 1, n_rows), dtype=torch.int32, device=row_c.device)
    torch.cumsum(oh.to(torch.int32), 0, dtype=torch.int32, out=ps[1:])
    idt = torch.int16 if (W <= 32767 or mod16) else torch.int32
    return ps.to(idt)


def _build_scan_ps_w(row_c, weights):
    """[w_pad+1, R] f32 weight-channel prefix sums of one chromosome's
    site stream (compressed mode; XLA in fscl_tpu/engine/scan.py:510).
    Summed in float64 and rounded once: centred channels reach about
    sqrt(W) in magnitude, and the statistic reads their differences."""
    ps = torch.cumsum(weights.to(torch.float64)[row_c.to(torch.int64)], 0)
    return torch.nn.functional.pad(ps.to(torch.float32), (0, 0, 1, 0))


def _chrom_scan_ps(data, ht, st, mod16):
    """Memoized per-chromosome prefix sums, shared across scan stages.

    One-hot mode: shared across decimation tables too (same row map,
    same row pad).  Compressed mode: per table, since each table's
    channels are the SVD factors of its own decimated columns."""
    cache = _port_cache(data, ht.t3.device)
    if ht.weights is None:
        key = ("scan-ps", st.cl.start_index, st.cl.n_snps, ht.n_rows, mod16)
    else:
        key = ("scan-ps-w", st.cl.start_index, st.cl.n_snps, ht.n_cells,
               round(float(ht.step), 12))
    if key not in cache:
        with span("scan.tables"):
            row_c = _chrom_row_stream(data, ht, st)
            cache[key] = (
                _build_scan_ps(row_c, n_rows=ht.n_rows, mod16=mod16)
                if ht.weights is None else _build_scan_ps_w(row_c, ht.weights))
    return cache[key]


def _fused_max(t3, bounds, fbar, ps, lalpha, *, n_cells, n_rows, n_alpha,
               mm_bf16=False):
    """[2, C] (max CLR over the alpha grid, its lalpha) per candidate."""
    clr = hist_clr_reps_ps(
        t3, bounds, fbar, ps, n_rep=1, n_cells=n_cells, n_rows=n_rows,
        n_alpha=n_alpha, mm_bf16=mm_bf16,
    )[0]
    best, a = torch.max(clr, dim=1)
    return torch.stack([best, lalpha[a]])


class _FusedHistEval:
    """Hist evaluation for the scan's stages: ``evaluate`` one
    chromosome's candidates (_eval_flats drains every chromosome's
    together)."""

    def __init__(self, ht, data, cfg, mm_bf16=False):
        self.ht = ht
        self.data = data
        self.mm_bf16 = mm_bf16
        self.eval_range = cfg.eval_range
        self.mod16 = _dataset_mod16(data, ht)
        self.lalpha_dev = torch.as_tensor(ht.lalpha, device=ht.t3.device)

    def evaluate(self, st, flat):
        """[2, len(flat)] device (max CLR, lalpha) at one chromosome's
        candidates."""
        ht = self.ht
        dev = get_hist_device_arrays(self.data, ht, st.pos_np,
                                     st.cl.start_index)
        hp = build_hist_points(
            ht, st.pos_np, flat, self.eval_range, cand_pad=1,
            device_arrays=dev,
        )
        return _fused_max(
            ht.t3, hp.bounds, hp.fbar,
            _chrom_scan_ps(self.data, ht, st, self.mod16), self.lalpha_dev,
            n_cells=ht.n_cells, n_rows=ht.n_rows, n_alpha=ht.n_alpha,
            mm_bf16=self.mm_bf16,
        )[:, : len(flat)]


def _snp_probe_positions(data, tables, st, cfg, row_gain=None):
    """SNP-anchored probe positions for one chromosome (owner-filtered)."""
    if row_gain is None:
        row_all = np.asarray(data.row)
        null_row = np.zeros(tables.table.shape[0])
        null_row[row_all] = np.asarray(data.null_logl)
        row_gain = tables.table.max(axis=1) - null_row
    sl = slice(st.cl.start_index, st.cl.start_index + st.cl.n_snps)
    g = row_gain[np.asarray(data.row[sl])]
    keep = g > cfg.snp_probe_min_gain
    pos = st.pos_np[keep].astype(np.int64)
    owner = np.searchsorted(st.istart, pos, side="right") - 1
    ok = (owner >= 0) & (pos <= st.iend[np.clip(owner, 0, None)])
    return pos[ok], owner[ok]


def _report_pool_max(st, cand, clr, la):
    """Per-interval (pos, clr, lalpha) = max over the evaluated tie pool."""
    st.best_clr = np.full(st.n_int, -np.inf)
    st.best_la = np.zeros(st.n_int)
    st.best_pos = np.zeros(st.n_int, dtype=cand.dtype)
    for k in np.argsort(clr):  # last write wins = max
        st.best_clr[st.owner_x[k]] = clr[k]
        st.best_la[st.owner_x[k]] = la[k]
        st.best_pos[st.owner_x[k]] = cand[k]


def _tie_candidates(st, cfg):
    """Tie-resolution set for one chromosome: flat (positions, owners).

    Per interval: the selection winner plus every probed position whose
    selection-grade CLR lies within hist_tie_margin of the winner's,
    deduplicated and capped at hist_tie_cap by CLR rank."""
    pools = [(st.r, st.best_pos, st.best_clr)]
    if st.bkeep is not None:
        bi, bj = np.nonzero(st.bkeep)
        pools.append((bi, st.bpos[bi, bj], st.bclr[bi, bj]))
    if st.probe_owner is not None:
        pools.append((st.probe_owner, st.probe_pos, st.probe_clr))
    if st.snp_clr is not None:
        pools.append((st.snp_owner, st.snp_cand, st.snp_clr))
    owner = np.concatenate([p[0] for p in pools])
    pos = np.concatenate([p[1] for p in pools])
    clr = np.concatenate([p[2] for p in pools])
    near = clr >= st.best_clr[owner] - cfg.hist_tie_margin
    owner, pos, clr = owner[near], pos[near], clr[near]
    o = np.lexsort((-clr, pos, owner))
    owner, pos, clr = owner[o], pos[o], clr[o]
    first = np.ones(len(owner), dtype=bool)
    first[1:] = (owner[1:] != owner[:-1]) | (pos[1:] != pos[:-1])
    owner, pos, clr = owner[first], pos[first], clr[first]
    o = np.lexsort((-clr, owner))
    owner, pos = owner[o], pos[o]
    rank = np.arange(len(owner)) - np.searchsorted(owner, owner)
    keep = rank < cfg.hist_tie_cap
    return pos[keep], owner[keep]


class _ChrScanState:
    """Per-chromosome mutable state for the pipelined scan."""

    def __init__(self, c, cl, data, cfg, blk=None, stride=1):
        self.c = c
        self.cl = cl
        self.data = data
        self.stride = stride
        self.blk = blk  # lattice evaluator (the lattice path)
        sl = slice(cl.start_index, cl.start_index + cl.n_snps)
        self.pos_np = np.asarray(data.pos[sl])
        self.cand, self.valid, self.istart, self.iend = (
            chromosome_candidates(cl, cfg, stride=stride)
        )
        self.n_int, self.J = self.cand.shape
        self.r = np.arange(self.n_int)
        self.best_pos = self.best_clr = self.best_la = None
        self.bpos = self.bclr = self.bla = self.bkeep = None
        self.flat_cand = self.flat_bi = self.flat_bj = None
        self.probe_owner = self.probe_pos = self.probe_clr = None
        self.snp_cand = self.snp_owner = None
        self.snp_clr = self.snp_la = None
        self.cand_x = self.owner_x = None


def _tie_stage(data, tables, cfg, states, hist_ht, device, split):
    """Tie pool: every probed position within hist_tie_margin of the
    selection winner, re-ranked on the (nearly) undecimated hist lattice,
    or, when even that table's step exceeds exact_step_max, re-evaluated
    with the per-site lattice kernel; its winner is reported.  Without a
    finer tie table (the selection table is already at tie_decimate) the
    refine winners stand.  Under a split, each rank evaluates its share
    of the pool, as in every other stage (_eval_flats)."""
    with span("scan.select"):
        for st in states:
            st.cand_x, st.owner_x = _tie_candidates(st, cfg)
    ht1 = (
        make_scan_hist_tables(
            data, tables, cfg.hist_alphas, decimate=cfg.tie_decimate,
            device=device,
        )
        if cfg.tie_decimate < cfg.hist_decimate else None
    )
    if ht1 is hist_ht:
        ht1 = None
    ht_report = ht1 if ht1 is not None else hist_ht
    flats = [st.cand_x for st in states]
    if float(ht_report.step) > cfg.exact_step_max:
        with span("scan.tables"):
            for st in states:
                if st.blk is None:
                    st.blk = _ChromosomeBlock(
                        data, st.cl, get_lattice_tables(tables, device))

        def evaluate(st, f):
            return st.blk.eval_device(f, cfg)
    elif ht1 is not None:
        with span("scan.tables"):
            evaluate = _FusedHistEval(ht1, data, cfg).evaluate
    else:
        return
    outs = _eval_flats(evaluate, states, flats, split)
    with span("scan.select"):
        for st, (clr, la) in zip(states, outs):
            _report_pool_max(st, st.cand_x, clr, la)


@traced("scan.genome", step=True)
def scan_genome(data, tables, cfg: ScanConfig, device="cuda",
                split=None) -> ScanResult:
    """Scan all chromosomes; returns one scan point per coarse interval.

    All chromosomes advance through each stage (dense grid, refine
    rounds, tie resolution) together, with one host readback per stage.
    The lattice tables are built (get_lattice_tables) only when the run
    takes the lattice path or its exact tie stage.  ``split``: this
    process's parallel.Split (None: a world of one); see the module doc.
    """
    device = parse_device(device)
    split = split or SOLO
    g0 = dict(shard.stats)
    with span("scan.tables"):
        hist_ht = (
            make_scan_hist_tables(
                data, tables, cfg.hist_alphas, decimate=cfg.hist_decimate,
                device=device,
            )
            if cfg.use_hist else None
        )
        fused = (
            _FusedHistEval(hist_ht, data, cfg, mm_bf16=cfg.selection_bf16)
            if hist_ht is not None else None
        )
    stride = (
        max(int(cfg.dense_stride), 1)
        if (cfg.refine and hist_ht is not None) else 1
    )

    with span("scan.setup"):
        states = []
        for c, cl in enumerate(data.chr_limits):
            blk = None
            if hist_ht is None:
                with span("scan.tables"):
                    blk = _ChromosomeBlock(data, cl,
                                           get_lattice_tables(tables, device))
            st = _ChrScanState(c, cl, data, cfg, blk=blk, stride=stride)
            cr_logmsg(
                MSG_STATUS,
                "Scanning chromosome %s - %d intervals x %d candidates",
                cl.name, st.n_int, st.J,
            )
            states.append(st)
        if hist_ht is not None and cfg.snp_probes:
            row_all = np.asarray(data.row)
            null_row = np.zeros(tables.table.shape[0])
            null_row[row_all] = np.asarray(data.null_logl)
            row_gain = tables.table.max(axis=1) - null_row
            for st in states:
                st.snp_cand, st.snp_owner = _snp_probe_positions(
                    data, tables, st, cfg, row_gain
                )

    def eval_stage(get_cand):
        """get_cand(st) for every chromosome, one readback: the hist
        statistic, or the lattice search on the lattice path; under a
        split, this rank's share, gathered (_eval_flats)."""
        with span("scan.select"):
            flats = [get_cand(st) for st in states]
        return _eval_flats(
            fused.evaluate if fused is not None
            else lambda st, f: st.blk.eval_device(f, cfg),
            states, flats, split)

    def _dense_cand(st):
        flat = st.cand.reshape(-1)
        if st.snp_cand is not None:
            flat = np.concatenate([flat, st.snp_cand])
        return flat

    # dense fine-grid stage (+ SNP-anchored probes in the same evaluation)
    with span("scan.stage", stage="dense"):
        outs = eval_stage(_dense_cand)
        with span("scan.select"):
            for st, (clr_all, la_all) in zip(states, outs):
                _select_dense(st, clr_all, la_all, cfg)

    if cfg.refine:
        # iterative zoom: re-center each kept branch on its running winner
        # and shrink the pitch ~8x per round, one round below bp_resl
        pitch = cfg.small_grid_sp * stride
        offs_w = cfg.refine_halfwidth
        floor = (
            max(cfg.bp_resl // 4, 16) if cfg.refine_subresl else cfg.bp_resl
        )
        while pitch > floor:
            pitch = max(pitch // 8, floor)
            final_round = pitch <= floor

            def rcand(st, pitch=pitch):
                bi, bj = np.nonzero(st.bkeep)
                offs = np.arange(-offs_w, offs_w + 1, dtype=np.int64) * pitch
                c = st.bpos[bi, bj][:, None] + offs[None, :]
                c = np.clip(c, st.istart[bi][:, None], st.iend[bi][:, None])
                st.flat_bi, st.flat_bj = bi, bj
                st.flat_cand = c.reshape(-1)
                return st.flat_cand

            with span("scan.stage", stage="refine", pitch=pitch):
                outs = eval_stage(rcand)
                with span("scan.select"):
                    for st, (clr2, la2) in zip(states, outs):
                        _select_refine(st, clr2, la2, offs_w, final_round)

        with span("scan.select"):
            for st in states:
                bb = np.argmax(np.where(st.bkeep, st.bclr, -np.inf), axis=1)
                st.best_pos = st.bpos[st.r, bb]
                st.best_clr = st.bclr[st.r, bb]
                st.best_la = st.bla[st.r, bb]

    if hist_ht is not None:
        with span("scan.stage", stage="tie"):
            _tie_stage(data, tables, cfg, states, hist_ht, device, split)

    with span("scan.output"):
        return _scan_result(states, cfg, g0, split)


def _select_dense(st, clr_all, la_all, cfg):
    """The dense stage's winner and refine branches of one chromosome."""
    ng = st.n_int * st.J
    clr = np.where(
        st.valid.reshape(-1), clr_all[:ng], -np.inf
    ).reshape(st.n_int, st.J)
    la = la_all[:ng].reshape(st.n_int, st.J)
    jbest = np.argmax(clr, axis=1)
    st.best_pos = st.cand[st.r, jbest]
    st.best_clr = clr[st.r, jbest]
    st.best_la = la[st.r, jbest]
    # top-k dense cells within branch_margin of the winner each get a
    # refine zoom
    k = max(1, min(cfg.branch_k, st.J))
    order = np.argsort(clr, axis=1)[:, -k:]
    st.bpos = st.cand[st.r[:, None], order]
    st.bclr = clr[st.r[:, None], order]
    st.bla = la[st.r[:, None], order]
    if st.snp_cand is not None:
        st.snp_clr = clr_all[ng : ng + len(st.snp_cand)]
        st.snp_la = la_all[ng : ng + len(st.snp_cand)]
        # top-2 SNP probes per interval join the branch pool
        o = np.lexsort((-st.snp_clr, st.snp_owner))
        so, sp = st.snp_owner[o], st.snp_cand[o]
        sc, sl = st.snp_clr[o], st.snp_la[o]
        rank = np.arange(len(so)) - np.searchsorted(so, so)
        ext_pos = np.tile(st.best_pos[:, None], (1, 2))
        ext_clr = np.full((st.n_int, 2), -np.inf)
        ext_la = np.zeros((st.n_int, 2))
        for rk in (0, 1):
            m = rank == rk
            ext_pos[so[m], rk] = sp[m]
            ext_clr[so[m], rk] = sc[m]
            ext_la[so[m], rk] = sl[m]
        st.bpos = np.concatenate([st.bpos, ext_pos], axis=1)
        st.bclr = np.concatenate([st.bclr, ext_clr], axis=1)
        st.bla = np.concatenate([st.bla, ext_la], axis=1)
        st.best_clr = np.maximum(st.best_clr, st.bclr.max(axis=1))
    st.bkeep = st.bclr >= (st.best_clr - cfg.branch_margin)[:, None]
    st.bkeep[:, min(k, st.bkeep.shape[1]) - 1] = True


def _select_refine(st, clr2, la2, offs_w, final_round):
    """One refine round's running branch winners of one chromosome, and
    in the final round its probes for the tie stage."""
    nb = len(st.flat_bi)
    no = 2 * offs_w + 1
    cand2 = st.flat_cand.reshape(nb, no)
    clr2 = clr2[: nb * no].reshape(nb, no)
    la2 = la2[: nb * no].reshape(nb, no)
    j2 = np.argmax(clr2, axis=1)
    rows = np.arange(nb)
    fb, fj = st.flat_bi, st.flat_bj
    better = clr2[rows, j2] > st.bclr[fb, fj]
    st.bpos[fb, fj] = np.where(better, cand2[rows, j2], st.bpos[fb, fj])
    st.bla[fb, fj] = np.where(better, la2[rows, j2], st.bla[fb, fj])
    st.bclr[fb, fj] = np.maximum(st.bclr[fb, fj], clr2[rows, j2])
    if final_round:
        st.probe_owner = np.repeat(st.flat_bi, no)
        st.probe_pos = cand2.reshape(-1)
        st.probe_clr = clr2.reshape(-1)


def _scan_result(states, cfg, g0, split):
    """The ScanResult of the chromosomes' winners; records last_stats."""
    out = {k: [] for k in (
        "chr_id", "sweep_pos", "clr", "lalpha", "nearest", "window_start",
        "window_end", "interval_start", "interval_end",
    )}
    for st in states:
        ns, lo, hi = candidate_windows(st.pos_np, st.best_pos, cfg.eval_range)
        cl = st.cl
        out["chr_id"].append(np.full(st.n_int, st.c, dtype=np.int32))
        out["sweep_pos"].append(st.best_pos)
        out["clr"].append(st.best_clr)
        out["lalpha"].append(st.best_la)
        out["nearest"].append(ns + cl.start_index)
        out["window_start"].append(lo + cl.start_index)
        out["window_end"].append(hi + cl.start_index)
        out["interval_start"].append(st.istart)
        out["interval_end"].append(st.iend)
    cat = {k: np.concatenate(v) for k, v in out.items()}
    K = len(cat["sweep_pos"])
    last_stats.clear()
    last_stats.update(shard.split_stats(g0, split))
    return ScanResult(
        chr_id=cat["chr_id"],
        sweep_pos=cat["sweep_pos"],
        clr=cat["clr"].astype(np.float64),
        lalpha=cat["lalpha"].astype(np.float64),
        nearest=cat["nearest"],
        window_start=cat["window_start"],
        window_end=cat["window_end"],
        interval_start=cat["interval_start"],
        interval_end=cat["interval_end"],
        permute_n=np.zeros(K, dtype=np.int64),
        permute_p=np.zeros(K, dtype=np.int64),
        permute_finished=np.zeros(K, dtype=bool),
        null_clr=[None] * K,
        stat_threshold=np.full(K, np.nan),
    )
