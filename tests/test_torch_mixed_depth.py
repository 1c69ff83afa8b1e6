"""The compressed mixed-depth path: the port against fscl_tpu.

Data with missing genotype calls has many sample depths, so more than
ROWS_MAX distinct (depth, folded, freq) table rows; both packages then
SVD-compress the rows to f32 weight channels.  The same numpy inputs go
through fscl_tpu and fscl_tpu_torch.  Stated tolerances:
  * compressed tables: rows_used, row_map, n_rows and n_cells equal;
    weights and t3 within 1e-6 (both run the same numpy SVD; measured
    bitwise equal here);
  * _stack_stat on compressed tables against JAX _stack_stat fed its fat
    f32 weight table: float32 1e-4 relative plus 5e-3 CLR units
    absolute, bfloat16 1e-2 relative.  The port sums weight prefixes in
    float64 and rounds once; the JAX package runs a pairwise float32
    scan, a few ulps of the sqrt(W)-sized prefixes apart, which the
    statistic's prefix differences and its 2*NC*R-term contraction
    carry;
  * scan_genome (grid 1024, exact_step_max=1.0, selection_bf16=False on
    both sides, so the hist tie stage reports): CLR within 5e-3
    absolute, lalpha equal and sweep_pos equal wherever the JAX tie-stage
    winner beats its runner-up by more than 5e-3;
  * scan_permute with the JAX sigma injected and hist_bf16=False:
    stat_threshold within 5e-3; permute_n, permute_p and permute_finished
    equal away from near-ties, the points where some replicate's
    statistic lies within 1e-3 of its threshold (listed, and excluded);
  * the CLI (subprocess, --device cpu) never imports jax, and every TSV
    CLR lies within 0.5 of fscl_tpu's CLI, the parity band of PARITY.md.
"""

import copy
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fscl_tpu.engine.permute as JP
import fscl_tpu.engine.scan as JS
import fscl_tpu.ops.histclr as JH
import fscl_tpu_torch.engine.permute as TP
import fscl_tpu_torch.engine.scan as TS
import fscl_tpu_torch.ops.histclr as TH
from fscl_tpu.data import build_snp_data
from fscl_tpu.models import background_fsp, build_tables
from fscl_tpu.ops.permute import block_permutation_groups as jax_sigma
from fscl_tpu.sim import simulate_dataset
from fscl_tpu_torch.convert import hist_tables_from_numpy

REPO = pathlib.Path(__file__).resolve().parents[1]
SCAN = dict(eval_range=1500, small_grid_sp=10000, large_grid_sp=200000,
            exact_step_max=1.0, selection_bf16=False)
TOL = 5e-3  # CLR units: scan CLR, thresholds, statistic (absolute part)
BAND = 1e-3  # near-tie band of the exceedance-count comparison


def _mixed_sites(n_chr, mb, seed, full_depth=40):
    """Columns (chr, pos, freq, depth, folded) of depth-``full_depth``
    samples with missing calls: each site keeps 20..full_depth of them
    (hypergeometric subsample), 30% folded."""
    rng = np.random.default_rng(seed)
    cols = [[], [], [], [], []]
    for c in range(n_chr):
        sim = simulate_dataset(seed=seed + c, sample_size=full_depth,
                               mb_length=mb, alpha=3e-5)
        d = rng.integers(20, full_depth + 1, len(sim["pos"]))
        f = rng.hypergeometric(sim["freq"], full_depth - sim["freq"], d)
        folded = rng.random(len(d)) < 0.3
        f = np.where(folded, np.minimum(f, d - f), f)
        keep = (f >= 1) & (f <= d - 1)
        for col, x in zip(cols, ([f"c{c + 1}"] * int(keep.sum()),
                                 sim["pos"][keep], f[keep], d[keep],
                                 folded[keep])):
            col.append(np.asarray(x))
    return [np.concatenate(col) for col in cols]


@pytest.fixture(scope="module")
def mixed():
    """Two 2 Mb chromosomes, 21 depths, grid 1024; JAX scan result."""
    chrs, pos, f, d, folded = _mixed_sites(2, 2.0, 90)
    data = build_snp_data(list(chrs), pos, f, d, folded)
    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths)
    tables = build_tables(fsp, data.sample_depths, grid_points=1024)
    data.attach_model(tables)
    assert len(np.unique(data.row)) > TH.ROWS_MAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "device_count", lambda: 1)
        result = JS.scan_genome(data, tables, JS.ScanConfig(**SCAN))
    return data, tables, result


def _fresh(result):
    r = copy.deepcopy(result)
    r.permute_n[:] = 0
    r.permute_p[:] = 0
    r.permute_finished[:] = False
    r.null_clr = [None] * r.n_points
    return r


# ---- compressed tables -----------------------------------------------------

def _depth_tables(depths, grid_points=256):
    """fscl_tpu/tests/test_mixed_depth.py's row family: 1/i spectra."""
    fsp = []
    for n in depths:
        f = 1.0 / np.arange(1, n)
        fsp.append(np.concatenate([[0.0], f / f.sum(), [0.0]]))
    return build_tables(fsp, depths, grid_points=grid_points)


@pytest.fixture(scope="module")
def row_family():
    depths = np.arange(20, 45)
    tables = _depth_tables(depths)
    rng = np.random.default_rng(3)
    n = 2000
    pos = np.sort(rng.choice(2_000_000, size=n, replace=False))
    depth_p = rng.integers(0, len(depths), n)
    folded = rng.random(n) < 0.4
    n_arr = depths[depth_p]
    freq = np.where(folded, rng.integers(1, np.maximum(n_arr // 2, 1) + 1),
                    rng.integers(1, n_arr))
    row = tables.site_rows(depth_p, folded, freq).astype(np.int64)
    null = np.zeros(tables.table.shape[0])
    null[row] = tables.null_logl(depth_p, folded, freq)
    return tables, pos, row, null


@pytest.mark.parametrize("dec, counts", [(1, True), (8, True), (2, False)])
def test_compressed_tables_match(row_family, dec, counts):
    tables, pos, row, null = row_family
    rows_used = np.unique(row)
    assert len(rows_used) > TH.ROWS_MAX
    kw = dict(extent_bp=int(pos[-1] - pos[0]) + 1, n_alpha=32, decimate=dec,
              site_row_counts=(np.bincount(row, minlength=len(null))
                               if counts else None))
    args = (tables.table, tables.grid_points, null, rows_used)
    hj = JH.build_hist_tables(*args, **kw)
    ht = TH.build_hist_tables(*args, **kw, device="cpu")
    assert hj.weights is not None and ht.weights is not None
    np.testing.assert_array_equal(ht.rows_used, hj.rows_used)
    np.testing.assert_array_equal(ht.row_map, hj.row_map)
    assert (ht.n_rows, ht.n_cells, ht.n_alpha, ht.grid_points) == (
        hj.n_rows, hj.n_cells, hj.n_alpha, hj.grid_points)
    assert ht.step == hj.step
    np.testing.assert_allclose(ht.weights.numpy(), np.asarray(hj.weights),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ht.t3.numpy(), np.asarray(hj.t3),
                               rtol=0, atol=1e-6)
    assert ht.sentinel == len(rows_used) == ht.weights.shape[0] - 1
    assert not ht.weights[-1].any()


def test_exact_mode_below_rows_max_unchanged(row_family):
    """compress=False, or at most ROWS_MAX rows, keeps one-hot tables."""
    tables, pos, row, null = row_family
    args = (tables.table, tables.grid_points, null)
    few = np.unique(row)[:TH.ROWS_MAX]
    ht = TH.build_hist_tables(*args, few, extent_bp=10**6, n_alpha=32,
                              device="cpu")
    assert ht.weights is None and ht.sentinel == ht.n_rows
    many = np.unique(row)
    ht = TH.build_hist_tables(*args, many, extent_bp=10**6, n_alpha=32,
                              compress=False, device="cpu")
    assert ht.weights is None and ht.sentinel == ht.n_rows >= len(many)


def test_convert_carries_weights(row_family):
    tables, pos, row, null = row_family
    hj = JH.build_hist_tables(tables.table, tables.grid_points, null,
                              np.unique(row), extent_bp=10**6, n_alpha=32)
    ht = hist_tables_from_numpy(
        t3=np.asarray(hj.t3), row_map=hj.row_map, rows_used=hj.rows_used,
        lalpha=hj.lalpha, offsets=hj.offsets, n_cells=hj.n_cells,
        n_rows=hj.n_rows, n_alpha=hj.n_alpha, step=hj.step,
        grid_points=hj.grid_points, weights=np.asarray(hj.weights),
        device="cpu",
    )
    assert ht.weights.dtype == torch.float32
    np.testing.assert_array_equal(ht.weights.numpy(), np.asarray(hj.weights))
    assert ht.sentinel == len(hj.rows_used)


# ---- sentinels and the byte count ------------------------------------------

def test_row_index_table_keeps_ids_above_channel_count(mixed):
    """In compressed mode compact ids run to R_used (far above the channel
    count R): the thin table must clamp at R_used, not at R."""
    data, tables, _ = mixed
    ht = TS.make_scan_hist_tables(data, tables, 32, decimate=8,
                                  device="cpu")
    rc = ht.row_map[np.asarray(data.row)].astype(np.int32)
    assert rc.max() > ht.n_rows  # ids that a clamp at R would fold
    got = TH.make_row_index_group_table(torch.as_tensor(rc),
                                        sentinel=ht.sentinel).numpy()
    G = -(-len(rc) // 32)
    want = np.full((G + 1) * 32, ht.sentinel, np.int16)
    want[:len(rc)] = rc
    np.testing.assert_array_equal(got, want.reshape(G + 1, 32))


def test_chrom_row_stream_pads_with_zero_weight_row(mixed):
    data, tables, _ = mixed
    ht = TS.make_scan_hist_tables(data, tables, 32, decimate=8,
                                  device="cpu")
    st = SimpleNamespace(cl=data.chr_limits[0])
    rc = TS._chrom_row_stream(data, ht, st).numpy()
    n = st.cl.n_snps
    assert len(rc) % 4096 == 0 and len(rc) > n
    assert (rc[n:] == len(ht.rows_used)).all()
    assert not ht.weights[rc[n:]].any()
    np.testing.assert_array_equal(rc[:n], ht.row_map[data.row[:n]])


def test_sub_rep_counts_four_bytes_under_weights():
    """f32 weight prefixes take twice the int16 bytes, so the replicate
    slice that fits PS_BUDGET_BYTES halves (fscl_tpu permute.py:1053)."""
    S, w, R = 8, 1 << 20, 40
    # one-hot: 2 bytes an element
    exact = TP._sub_rep_for(SimpleNamespace(n_rows=R, weights=None), S, w)
    comp = TP._sub_rep_for(SimpleNamespace(n_rows=R, weights=True), S, w)
    assert S * w * exact * R * 2 <= TP.PS_BUDGET_BYTES
    assert S * w * comp * R * 4 <= TP.PS_BUDGET_BYTES
    assert comp == exact // 2 and comp >= 1
    # at the mixed-depth headline shape both fit the top slice
    mix = TP._sub_rep_for(SimpleNamespace(n_rows=32, weights=True), 4, 24576)
    assert mix == 2 * TP.HIST_REP_SUB


# ---- the statistic on compressed tables ------------------------------------

@pytest.mark.parametrize("mm_bf16", [False, True])
def test_stack_stat_matches_fat_jax(mixed, mm_bf16):
    data, tables, result = mixed
    cfg = TP.PermuteConfig(n_permute=8, hist_bf16=mm_bf16)
    hs = TP.setup_hist(data, tables, result, TS.ScanConfig(**SCAN), cfg,
                       "cpu")
    ht = hs.ht
    assert ht.weights is not None
    st = hs.stacks[0]
    st.rebuild(result, TP.active_by_chr(result, st,
                                        np.ones(result.n_points, bool)))
    P = 4
    sig = np.asarray(jax_sigma(jax.random.key(3), data.genome_pos(), 1e6, P))
    sig_p = hs.pad_sigma(sig)
    got = TP._stack_stat(
        hs.table, sig_p, st.seg_g0, st.bounds, st.fbar, ht.t3,
        w_seg_p=st.w_seg_p, n_rows=ht.n_rows, n_cells=ht.n_cells,
        n_alpha=ht.n_alpha, sub_rep=2, n_pts=len(st.pts), Jf=st.Jf,
        mm_bf16=mm_bf16, weights=ht.weights,
    ).numpy()
    # JAX's fat f32 table (make_row_weight_group_table) over the same rows
    row_cg = jnp.asarray(ht.row_map[np.asarray(data.row)].astype(np.int32))
    fat = JH.make_row_weight_group_table(row_cg, jnp.asarray(ht.weights))
    assert fat.shape[0] == hs.table.shape[0]
    S = st.n_seg_pad
    z = jnp.zeros(S, jnp.int32)
    want = np.asarray(JP._stack_stat(
        fat, jnp.asarray(sig_p.numpy()), jnp.asarray(st.seg_g0.numpy()), z,
        z, jnp.asarray(st.bounds.numpy()), jnp.asarray(st.fbar.numpy()),
        jnp.asarray(ht.t3.numpy()),
        w_seg_p=st.w_seg_p, n_seg=S, n_rows=ht.n_rows,
        n_cells=ht.n_cells, n_alpha=ht.n_alpha, sub_rep=2,
        n_slices=P // 2, n_pts=len(st.pts), Jf=st.Jf, mm_bf16=mm_bf16,
    ))
    assert got.shape == want.shape == (P, len(st.pts))
    if mm_bf16:
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=TOL)


def test_hist_clr_reps_ps_on_float_prefix(mixed):
    """hist_clr_reps_ps needs no change for f32 prefixes: the sign takes
    the prefix dtype and the bf16 mode rounds the weight sums as JAX."""
    data, tables, _ = mixed
    ht = TS.make_scan_hist_tables(data, tables, 64, decimate=2,
                                  device="cpu")
    hj = JS.make_scan_hist_tables(data, tables, 64, decimate=2)
    n = data.chr_limits[0].n_snps
    pos = data.pos[:n]
    cand = np.linspace(pos[0], pos[-1], 40).astype(np.int64)
    pj = JH.build_hist_points(hj, pos, cand, 1500)
    pt = TH.build_hist_points(ht, pos, cand, 1500)
    rng = np.random.default_rng(1)
    rc = ht.row_map[data.row[:n]]
    w = ht.weights.numpy().astype(np.float64)
    reps = np.stack([rng.permutation(rc) for _ in range(3)])  # [P, W]
    ps = np.cumsum(w[reps].transpose(1, 0, 2).reshape(n, -1), axis=0)
    ps = np.concatenate([np.zeros((1, ps.shape[1])), ps]).astype(np.float32)
    for mm_bf16 in (False, True):
        kw = dict(n_rep=3, n_cells=ht.n_cells, n_rows=ht.n_rows,
                  n_alpha=ht.n_alpha, mm_bf16=mm_bf16)
        want = np.asarray(JH.hist_clr_reps_ps(hj.t3, pj.bounds, pj.fbar,
                                              jnp.asarray(ps), **kw))
        got = TH.hist_clr_reps_ps(ht.t3, pt.bounds, pt.fbar,
                                  torch.as_tensor(ps), **kw).numpy()
        if mm_bf16:
            np.testing.assert_allclose(got, want, rtol=1e-2,
                                       atol=1e-2 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=TOL)


# ---- the genome scan -------------------------------------------------------

def test_scan_genome_matches(mixed, monkeypatch):
    data, tables, _ = mixed
    gaps = {}
    orig = JS._report_pool_max

    def spy(st, cand, clr, la):
        for k in range(st.n_int):
            v = np.sort(np.asarray(clr)[st.owner_x == k])[::-1]
            gaps[(st.c, k)] = v[0] - v[1] if len(v) > 1 else np.inf
        return orig(st, cand, clr, la)

    monkeypatch.setattr(JS, "_report_pool_max", spy)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    want = JS.scan_genome(data, tables, JS.ScanConfig(**SCAN))
    got = TS.scan_genome(data, tables, TS.ScanConfig(**SCAN), device="cpu")
    assert got.n_points == want.n_points > 0
    np.testing.assert_array_equal(got.chr_id, want.chr_id)
    np.testing.assert_array_equal(got.interval_start, want.interval_start)
    np.testing.assert_allclose(got.clr, want.clr, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.lalpha, want.lalpha)
    idx = np.zeros(len(want.chr_id), np.int64)
    for c in np.unique(want.chr_id):
        idx[want.chr_id == c] = np.arange((want.chr_id == c).sum())
    clear = np.array([gaps[(int(c), k)] > TOL
                      for c, k in zip(want.chr_id, idx)])
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.sweep_pos[clear], want.sweep_pos[clear])


def test_scan_tables_do_not_share_a_prefix(mixed):
    """The selection (decimation 8) and tie (decimation 2) tables have
    different SVD channels, so each needs its own prefix sums."""
    data, tables, _ = mixed
    h8 = TS.make_scan_hist_tables(data, tables, 128, decimate=8,
                                  device="cpu")
    h2 = TS.make_scan_hist_tables(data, tables, 128, decimate=2,
                                  device="cpu")
    assert h8.n_rows == h2.n_rows  # one row pad: an R-keyed cache would mix
    st = SimpleNamespace(cl=data.chr_limits[1])
    p8 = TS._chrom_scan_ps(data, h8, st, False)
    p2 = TS._chrom_scan_ps(data, h2, st, False)
    assert p8 is not p2 and not torch.equal(p8, p2)
    for ht, ps in ((h8, p8), (h2, p2)):
        rc = TS._chrom_row_stream(data, ht, st)
        want = np.cumsum(ht.weights.numpy().astype(np.float64)[rc.numpy()],
                         axis=0)
        want = np.concatenate([np.zeros((1, ht.n_rows)), want])
        np.testing.assert_array_equal(ps.numpy(), want.astype(np.float32))
    assert TS._dataset_mod16(data, h8) is False


# ---- the permutation engine ------------------------------------------------

def test_scan_permute_matches_with_shared_sigma(mixed):
    data, tables, result = mixed
    pc = dict(n_permute=64, seed=5, chunk_replicates=16, hist_bf16=False,
              scan_width_mb=0.1)
    r_jax = _fresh(result)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "device_count", lambda: 1)
        JP.scan_permute(data, tables, r_jax, JS.ScanConfig(**SCAN),
                        JP.PermuteConfig(**pc))
    key, gp = jax.random.key(5), data.genome_pos()

    def sigma_source(n, start):
        return np.asarray(jax_sigma(key, gp, 1e5, n, start=start))

    r_port = _fresh(result)
    TP.scan_permute(data, tables, r_port, TS.ScanConfig(**SCAN),
                    TP.PermuteConfig(**pc), device="cpu",
                    sigma_source=sigma_source)

    np.testing.assert_allclose(r_port.stat_threshold, r_jax.stat_threshold,
                               rtol=0, atol=TOL)
    near = sorted({
        i for i in range(result.n_points) for r in (r_jax, r_port)
        if np.any(np.abs(np.asarray(r.null_clr[i]) - r.stat_threshold[i])
                  < BAND)
    })
    keep = np.setdiff1d(np.arange(result.n_points), near)
    print("near-tie points excluded:", near)
    assert len(keep) >= 0.7 * result.n_points
    assert r_jax.permute_finished[keep].any()  # pruning engaged
    np.testing.assert_array_equal(r_port.permute_p[keep],
                                  r_jax.permute_p[keep])
    np.testing.assert_array_equal(r_port.permute_n[keep],
                                  r_jax.permute_n[keep])
    np.testing.assert_array_equal(r_port.permute_finished[keep],
                                  r_jax.permute_finished[keep])


# ---- the CLI ---------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed_file(tmp_path_factory):
    chrs, pos, f, d, folded = _mixed_sites(1, 2.0, 120)
    path = tmp_path_factory.mktemp("mixed") / "mixed.sf"
    with open(path, "w") as fh:
        for row in zip(chrs, pos, f, d, folded.astype(int)):
            fh.write("\t".join(map(str, row)) + "\n")
    return path


CLI_ARGS = ["-g", "10000", "-G", "200000", "-p", "24",
            "--chunk-replicates", "8", "-v", "1"]

_RUN_PORT = (
    "import sys\n"
    "from fscl_tpu_torch.cli import main\n"
    "rc = main(sys.argv[1:])\n"
    "assert 'jax' not in sys.modules, 'fscl_tpu_torch imported jax'\n"
    "print('jax-free', rc)\n"
)


def _read_tsv(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def test_cli_runs_mixed_depth_without_jax(mixed_file, tmp_path,
                                          monkeypatch):
    out_port = tmp_path / "port.tsv"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_PORT, "-f", str(mixed_file),
         "-o", str(out_port), "--device", "cpu", *CLI_ARGS],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "jax-free 0" in proc.stdout

    from fscl_tpu.cli import main as jax_main

    monkeypatch.setattr(jax, "device_count", lambda: 1)
    out_jax = tmp_path / "jax.tsv"
    assert jax_main(["-f", str(mixed_file), "-o", str(out_jax),
                     *CLI_ARGS]) == 0
    rows_p, rows_j = _read_tsv(out_port), _read_tsv(out_jax)
    assert len(rows_p) == len(rows_j) > 0
    assert [r[0] for r in rows_p] == [r[0] for r in rows_j]
    clr_p = np.array([float(r[2]) for r in rows_p])
    clr_j = np.array([float(r[2]) for r in rows_j])
    np.testing.assert_allclose(clr_p, clr_j, rtol=0, atol=0.5)
    n_p = np.array([int(r[5]) for r in rows_p])
    assert (n_p > 0).all() and (n_p <= 24).all()
