"""Exact one-hot hist tables past ROWS_MAX rows: the gate of
build_hist_tables and the statistic at 160 and 214 rows of one depth,
against the benchmark's plain float64 reference (portbench/ref/stat.py:
HistStat), which computes fscl_tpu's histogram form of the CLR with exact
counts.

The gate (ops/histclr.py): above ROWS_MAX rows the tables are
SVD-compressed where the rank ladder reaches COMPRESS_TOL, and equal
fscl_tpu's bit for bit there; else exact one-hot up to WIDE_ROWS_MAX
rows, else the lattice path.  One depth of 162 or 216 haplotypes (160 or
214 frequency classes) under a neutral spectrum misses the tolerance at
every rank of the ladder (rank 96 leaves 0.003-0.009 and 5.4-16 log-
likelihood units an entry).

Tolerances, in CLR units:
  * the scan's statistic (the float32 route of its tie stage, decimation
    2) at 24 candidates and 32 alphas: 2e-3 + 1e-5 |CLR| each.  The
    program's table pack, fractions and sums are float32 against the
    reference's float64 (measured: under 1.1e-5 beyond the relative
    term); the benchmark's scan cells hold the same route to 6e-4 at the
    reported point (PERF.md).
  * a stacked permutation chunk (the bfloat16 route, decimation 8), its
    maximum over 7 positions and 32 alphas a replicate and point: 2e-3 +
    2^-7 S, S = 2 sum |w t| of the reference's window weights and pack at
    the reference's maximum (each bfloat16 operand carries 2^-9 of
    relative rounding; measured: 0.0053-0.015 against 0.084-0.11).
The compressed route, forced on, misses both: the scan by 0.5 (160 rows)
and 119 (214 rows) CLR units, the chunk by 0.18 and 1.04 beyond the
tolerance.
"""

import numpy as np
import pytest
import torch

import fscl_tpu.ops.histclr as JH
from fscl_tpu_torch.data import ChrLimits, SNPData
from fscl_tpu_torch.engine import ScanConfig, scan_genome
from fscl_tpu_torch.engine import permute as TP
from fscl_tpu_torch.engine.scan import _build_scan_ps, make_scan_hist_tables
from fscl_tpu_torch.models import background_fsp, build_tables
from fscl_tpu_torch.ops import histclr as TH
from fscl_tpu_torch.ops.permute import PERM_GROUP, block_permutation_groups
from portbench.ref.sim import standard_neutral_spectrum
from portbench.ref.stat import HistStat
from portbench.ref.windows import candidate_windows

EVAL_RANGE = 4096


def _one_depth(n, *, n_sites, bp, seed, grid_points=2048):
    """One chromosome of ``n_sites`` sites at depth n: every frequency
    class 2..n-1 once (so every table row is used), the rest drawn from
    the standard neutral spectrum, in random order: pos, row, tables,
    null row, rows used."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(bp, size=n_sites, replace=False)).astype(
        np.int64)
    p = standard_neutral_spectrum(n)[2:n]
    freq = rng.permutation(np.concatenate([
        np.arange(2, n), 2 + rng.choice(n - 2, n_sites - (n - 2),
                                        p=p / p.sum())]))
    depth_p = np.zeros(n_sites, np.int32)
    folded = np.zeros(n_sites, bool)
    fsp = background_fsp(freq, depth_p, folded, np.array([n]))
    tables = build_tables(fsp, np.array([n]), grid_points=grid_points)
    row = tables.site_rows(depth_p, folded, freq).astype(np.int64)
    null = np.zeros(tables.table.shape[0])
    null[row] = tables.null_logl(depth_p, folded, freq)
    return dict(pos=pos, freq=freq, row=row, tables=tables, null=null,
                rows_used=np.unique(row), n=n)


@pytest.fixture(scope="module", params=[162, 216])
def depth(request):
    """160 and 214 rows of one depth: 400 kb, 3,000 sites."""
    return _one_depth(request.param, n_sites=3000, bp=400_000, seed=24)


def _extent(d):
    return int(d["pos"][-1] - d["pos"][0]) + 1


def _tables(d, *, decimate, n_alpha, compress):
    t = d["tables"]
    return TH.build_hist_tables(
        t.table, t.grid_points, d["null"], d["rows_used"], _extent(d),
        n_alpha=n_alpha, decimate=decimate,
        site_row_counts=np.bincount(d["row"], minlength=t.table.shape[0]),
        compress=compress, device="cpu")


def _reference(d, *, decimate, n_alpha):
    t = d["tables"]
    return HistStat(t.table, d["null"], d["rows_used"], _extent(d),
                    decimate=decimate, n_alpha=n_alpha, device="cpu")


def _cands(d, k):
    p = d["pos"]
    return np.linspace(p[0] + 2000, p[-1] - 2000, k).astype(np.int64)


def _windows(d, cand):
    lo, hi = candidate_windows(d["pos"], cand, EVAL_RANGE)
    return [torch.as_tensor(np.asarray(x, np.int64)) for x in (cand, lo, hi)]


def _scan_stat(d, ht):
    """[C, A] the scan's float32 statistic at 24 candidates."""
    cand = _cands(d, 24)
    hp = TH.build_hist_points(ht, d["pos"], cand, EVAL_RANGE, cand_pad=1)
    n = len(d["pos"])
    rc = np.full(max(-(-n // 4096) * 4096, 4096), ht.sentinel, np.int32)
    rc[:n] = ht.row_map[d["row"]]
    if ht.weights is None:
        ps = _build_scan_ps(torch.as_tensor(rc), n_rows=ht.n_rows,
                            mod16=False)
    else:
        ps = torch.nn.functional.pad(torch.cumsum(
            ht.weights.double()[torch.as_tensor(rc).long()], 0).float(),
            (0, 0, 1, 0))
    return TH.hist_clr_reps_ps(ht.t3, hp.bounds, hp.fbar, ps, n_rep=1,
                               n_cells=ht.n_cells, n_rows=ht.n_rows,
                               n_alpha=ht.n_alpha)[0][:len(cand)], cand


def _scan_ref(d, cand, n_alpha):
    hs = _reference(d, decimate=2, n_alpha=n_alpha)
    rows = hs.compact(d["row"])[None]
    return hs.clr(torch.as_tensor(d["pos"]), rows, *_windows(d, cand))[0]


def _scan_err(got, want):
    return float(((got.double() - want).abs()
                  - 1e-5 * want.abs()).max())


# ---- the gate ---------------------------------------------------------------

def test_one_large_depth_goes_exact_wide():
    d = _one_depth(216, n_sites=3000, bp=400_000, seed=24)
    assert len(d["rows_used"]) == 214
    before = dict(TH.table_modes)
    for dec in (8, 2):
        ht = _tables(d, decimate=dec, n_alpha=32, compress=None)
        assert ht.weights is None and ht.residual is None
        assert ht.n_rows == 216 and ht.sentinel == 216
    assert TH.table_modes["exact_wide"] == before["exact_wide"] + 2
    assert TH.table_modes["compressed"] == before["compressed"]
    forced = _tables(d, decimate=2, n_alpha=32, compress=True)
    assert forced.weights is not None
    assert forced.residual > TH.COMPRESS_TOL
    assert TH.table_modes["compressed"] == before["compressed"] + 1


def _depth_family(depths, grid_points=256):
    """fscl_tpu/tests/test_mixed_depth.py's row family: 1/i spectra."""
    fsp = []
    for n in depths:
        f = 1.0 / np.arange(1, n)
        fsp.append(np.concatenate([[0.0], f / f.sum(), [0.0]]))
    tables = build_tables(fsp, depths, grid_points=grid_points)
    rng = np.random.default_rng(5)
    m = 3000
    depth_p = rng.integers(0, len(depths), m)
    folded = rng.random(m) < 0.4
    n_arr = depths[depth_p]
    freq = np.where(folded, rng.integers(1, np.maximum(n_arr // 2, 1) + 1),
                    rng.integers(1, n_arr))
    row = tables.site_rows(depth_p, folded, freq).astype(np.int64)
    null = np.zeros(tables.table.shape[0])
    null[row] = tables.null_logl(depth_p, folded, freq)
    return tables, row, null


@pytest.mark.parametrize("dec", [1, 8])
def test_mixed_depths_within_tolerance_stay_compressed_as_fscl_tpu(dec):
    tables, row, null = _depth_family(np.arange(20, 45))
    rows_used = np.unique(row)
    assert TH.ROWS_MAX < len(rows_used)
    args = (tables.table, tables.grid_points, null, rows_used, 2_000_000)
    kw = dict(n_alpha=32, decimate=dec,
              site_row_counts=np.bincount(row,
                                          minlength=tables.table.shape[0]))
    ht = TH.build_hist_tables(*args, **kw, device="cpu")
    hj = JH.build_hist_tables(*args, **kw)
    assert ht.weights is not None and ht.residual < TH.COMPRESS_TOL
    assert ht.n_rows == hj.n_rows
    np.testing.assert_array_equal(ht.row_map, np.asarray(hj.row_map))
    np.testing.assert_array_equal(ht.weights.numpy(),
                                  np.asarray(hj.weights))
    np.testing.assert_array_equal(ht.t3.numpy(), np.asarray(hj.t3))


def _chromosome_data(d, tables):
    n_sites = len(d["pos"])
    data = SNPData(
        pos=d["pos"], obs_freq=d["freq"].astype(np.int32),
        depth_p=np.zeros(n_sites, np.int32),
        folded=np.zeros(n_sites, bool),
        chr_id=np.zeros(n_sites, np.int32),
        sample_depths=np.array([d["n"]], np.int64),
        chr_limits=[ChrLimits(name="1", start_index=0, n_snps=n_sites,
                              start_pos=int(d["pos"][0]),
                              bp_length=int(d["pos"][-1]))])
    data.attach_model(tables)
    return data


def test_past_wide_rows_a_missed_ladder_takes_the_lattice_path():
    """298 rows of one depth at grid 512: the scan's tables (decimation
    capped at 2 there) miss the tolerance, so build_hist_tables gives
    None, make_scan_hist_tables too, and the scan and the permutations
    run the lattice path."""
    d = _one_depth(300, n_sites=1500, bp=300_000, seed=3, grid_points=512)
    assert len(d["rows_used"]) > TH.WIDE_ROWS_MAX
    assert _tables(d, decimate=2, n_alpha=32, compress=None) is None
    data = _chromosome_data(d, d["tables"])
    assert make_scan_hist_tables(data, d["tables"], 32, decimate=8,
                                 device="cpu") is None
    cfg = ScanConfig(eval_range=2048, small_grid_sp=10_000,
                     large_grid_sp=100_000, hist_alphas=32)
    result = scan_genome(data, d["tables"], cfg, device="cpu")
    assert np.isfinite(result.clr).all()
    pc = TP.PermuteConfig(n_permute=4, chunk_replicates=4, hist_alphas=32,
                          hist_positions=3)
    TP.scan_permute(data, d["tables"], result, cfg, pc, device="cpu")
    assert TP.last_stats["lattice_dispatches"] > 0
    assert TP.last_stats["stack_dispatches"] == 0


# ---- the statistic against the float64 reference --------------------------

def test_scan_statistic_at_wide_rows_matches_reference(depth):
    ht = _tables(depth, decimate=2, n_alpha=32, compress=None)
    assert ht.weights is None and ht.n_rows > TH.ROWS_MAX
    got, cand = _scan_stat(depth, ht)
    want = _scan_ref(depth, cand, 32)
    assert _scan_err(got, want) <= 2e-3


def test_compressed_route_misses_the_scan_tolerance(depth):
    got, cand = _scan_stat(depth, _tables(depth, decimate=2, n_alpha=32,
                                          compress=True))
    assert _scan_err(got, _scan_ref(depth, cand, 32)) > 0.1


def _tail_chunk(d, ht, *, P, seed, Jf=7):
    """A stacked permutation chunk's statistic (engine/permute.py:
    _stack_stat, one chromosome stacked alone) at three points: [P, 3]
    maxima over Jf positions and the tables' alphas, and the replicates'
    site rows."""
    n = len(d["pos"])
    row_cg = torch.as_tensor(ht.row_map[d["row"]].astype(np.int32))
    table = TH.make_row_index_group_table(row_cg, sentinel=ht.sentinel)
    n_groups = table.shape[0] - 1
    w_seg_p = -(-(n + 2 * PERM_GROUP) // 4096) * 4096
    gpos = d["pos"] - d["pos"][0]
    sig = block_permutation_groups(seed, gpos, 50_000, P, device="cpu")
    sig = torch.as_tensor(np.asarray(sig), dtype=torch.int32)
    margin = w_seg_p // PERM_GROUP + 2
    sig_p = torch.cat([sig, torch.full((P, margin), n_groups,
                                       dtype=torch.int32)], 1).contiguous()
    cand = np.concatenate([np.linspace(a, a + 20_000, Jf).astype(np.int64)
                           for a in (60_000, 180_000, 300_000)])
    hp = TH.build_hist_points(ht, d["pos"], cand, EVAL_RANGE, cand_pad=Jf)
    out = TP._stack_stat(
        table, sig_p, torch.zeros(1, dtype=torch.int32),
        hp.bounds + PERM_GROUP - 1, hp.fbar, ht.t3, w_seg_p=w_seg_p,
        n_rows=ht.n_rows, n_cells=ht.n_cells, n_alpha=ht.n_alpha,
        sub_rep=2, n_pts=3, Jf=Jf, mm_bf16=True, weights=ht.weights)
    site = (sig.numpy().astype(np.int64)[:, np.arange(n) // PERM_GROUP]
            * PERM_GROUP + np.arange(n) % PERM_GROUP)  # [P, n]
    return out, cand, d["row"][np.minimum(site, n - 1)], site < n


def _tail_ref(d, cand, rows_p, Jf=7):
    """[P, 3] the reference's maxima, and S = 2 sum |w t| of the entry
    (position, alpha) each maximum is taken at."""
    hs = _reference(d, decimate=8, n_alpha=32)
    rows = hs.compact(rows_p)
    cand_t, lo, hi = _windows(d, cand)
    pos = torch.as_tensor(d["pos"])
    clr = hs.clr(pos, rows, cand_t, lo, hi)  # [P, C, A]
    w0, w1 = hs.weights(pos, rows, cand_t, lo, hi)
    P, C = w0.shape[:2]
    p0, p1 = hs.pack[0].abs(), hs.pack[1].abs()
    # side s reads the cells of both lerp ends, as HistStat.clr does
    s = 2.0 * (w0.view(P, C, 2, -1).abs().sum(2) @ p0
               + w1.view(P, C, 2, -1).abs().sum(2) @ p1)  # [P, C, A]
    at = clr.reshape(P, 3, Jf * 32).argmax(2, keepdim=True)
    return (clr.reshape(P, 3, Jf * 32).gather(2, at)[..., 0],
            s.reshape(P, 3, Jf * 32).gather(2, at)[..., 0])


def test_tail_chunk_at_wide_rows_matches_reference(depth):
    ht = _tables(depth, decimate=8, n_alpha=32, compress=None)
    assert ht.weights is None and ht.n_rows > TH.ROWS_MAX
    out, cand, rows_p, live = _tail_chunk(depth, ht, P=4, seed=7)
    assert live.all()
    want, s = _tail_ref(depth, cand, rows_p)
    err = (out.double() - want).abs()
    assert bool((err <= 2e-3 + 2.0 ** -7 * s).all()), float(err.max())


def test_compressed_route_misses_the_tail_tolerance(depth):
    ht = _tables(depth, decimate=8, n_alpha=32, compress=True)
    out, cand, rows_p, _ = _tail_chunk(depth, ht, P=4, seed=7)
    want, s = _tail_ref(depth, cand, rows_p)
    excess = (out.double() - want).abs() - (2e-3 + 2.0 ** -7 * s)
    assert float(excess.max()) > 0.05
