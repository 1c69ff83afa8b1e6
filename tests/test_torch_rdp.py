"""The run-decomposed pruning tail (RDP) and the replicate-batched
statistics: the port against fscl_tpu.

Four routes compute one statistic from one permutation stream: the
stacked segmented prefix (the main path), hist_clr_reps on the expanded
site-level sigma, _hist_perm_batch for one chromosome, and rdp_clr_reps
on the stream's runs.  Stated tolerances:
  * runs and sigma: exact (integers);
  * site prefix: bitwise;
  * hist_clr_reps, rdp_clr_reps and _hist_perm_batch, port against JAX on
    JAX's tables, geometry, sigma and runs, and the port's routes against
    each other: float32 1e-5 relative plus 1e-3 CLR units absolute
    (tests/test_rdp.py:85; the window counts are the same integers, the
    float32 sums are taken in other orders);
  * padding candidates with all-zero bounds: CLR exactly 0;
  * the driver with hist_bf16=False, JAX's sigma and runs injected: the
    port's thresholds equal exactly with RDP on and off (both come from
    the stacked path) and lie within 1e-3 of JAX's; permute_n and
    permute_p equal between the port's RDP and stacked runs and JAX's RDP
    run (and between both drivers under "auto" when it switches
    mid-run), except at points where some replicate's statistic lies
    within 1e-4 of its threshold (listed and excluded: two float32 sums
    in different orders can fall on either side of >=).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fscl_tpu.engine.permute as JP
import fscl_tpu.engine.scan as JS
import fscl_tpu.ops.histclr as JH
import fscl_tpu_torch.engine.permute as TP
import fscl_tpu_torch.ops.histclr as TH
from fscl_tpu.data import build_snp_data
from fscl_tpu.models import background_fsp, build_tables
from fscl_tpu.ops.permute import (
    block_permutation_groups as jax_sigma,
    block_permutation_runs as jax_runs,
    expand_group_sigma as jax_expand,
)
from fscl_tpu.sim import simulate_dataset
from fscl_tpu_torch.convert import hist_points_from_numpy, hist_tables_from_numpy
from fscl_tpu_torch.ops.permute import (
    PERM_GROUP,
    block_permutation_groups,
    block_permutation_runs,
    expand_group_sigma,
    runs_from_sigma,
    sigma_from_runs,
)

from tests.test_histclr import _hist_setup
from tests.test_ops import _mk_data


def _rebuild(src, dst, sz, G):
    out = np.full(G, -1, np.int64)
    for s, d, n in zip(src, dst, sz):
        out[d:d + n] = np.arange(s, s + n)
    return out


# ---- runs ------------------------------------------------------------------

@pytest.mark.parametrize("span, width, start", [
    (5_000_000, 300_000, 3),  # many blocks
    (2_500_000, 1_000_000, 0),  # 2-3 movable blocks: identity redraws
])
def test_runs_rebuild_sigma_with_redraws(span, width, start):
    """block_permutation_runs rebuilds block_permutation_groups exactly,
    redraws included (the analogue of tests/test_rdp.py:36), and both are
    fscl_tpu's rows bit for bit (whose rule redraws an identity block
    order)."""
    rng = np.random.default_rng(0)
    gpos = np.sort(rng.choice(span, 9_000, replace=False))
    sig = block_permutation_groups(7, gpos, width, 24, start=start,
                                   device="cpu").numpy()
    src, dst, sz = (x.numpy() for x in block_permutation_runs(
        7, gpos, width, 24, start=start, device="cpu"))
    G = sig.shape[1]
    assert src.dtype == dst.dtype == sz.dtype == np.int32
    for r in range(24):
        np.testing.assert_array_equal(_rebuild(src[r], dst[r], sz[r], G),
                                      sig[r])
        assert sz[r].sum() == G
    want = [np.asarray(x) for x in jax_runs(jax.random.key(7), gpos, width,
                                            24, start=start)]
    for got, w in zip((src, dst, sz), want):
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(
        sig, np.asarray(jax_sigma(jax.random.key(7), gpos, width, 24,
                                  start=start)))


def test_runs_chunking_and_expansion():
    rng = np.random.default_rng(1)
    gpos = np.sort(rng.choice(4_000_000, 5_000, replace=False))
    full = block_permutation_runs(3, gpos, 4e5, 10, start=2, device="cpu")
    part = block_permutation_runs(3, gpos, 4e5, 4, start=7, device="cpu")
    for a, b in zip(full, part):
        np.testing.assert_array_equal(a[5:9].numpy(), b.numpy())
    sig = sigma_from_runs(full[0], full[1], -(-len(gpos) // PERM_GROUP))
    got = expand_group_sigma(sig, len(gpos)).numpy()
    want = np.asarray(jax_expand(jnp.asarray(sig.numpy()), len(gpos)))
    np.testing.assert_array_equal(got, want)
    # runs_from_sigma gives a run decomposition of the same sigma
    s2, d2, z2 = runs_from_sigma(sig)
    np.testing.assert_array_equal(
        sigma_from_runs(s2, d2, sig.shape[1]).numpy(), sig.numpy())
    for r in range(sig.shape[0]):
        np.testing.assert_array_equal(
            _rebuild(s2[r].numpy(), d2[r].numpy(), z2[r].numpy(),
                     sig.shape[1]), sig[r].numpy())


# ---- the statistic on shared inputs ----------------------------------------

@pytest.fixture(scope="module")
def shared():
    """JAX tables, geometry, sigma and runs (tests/test_rdp.py:56), and
    the port's copies of the tables and geometry."""
    tables, pos, row, null = _mk_data(seed=11)
    hj = _hist_setup(tables, pos, row, null, n_alpha=16)
    cand = np.linspace(int(pos[5]), int(pos[-5]), 9).astype(np.int64)
    pj = JH.build_hist_points(hj, pos, cand, eval_range=150, cand_pad=3)
    row_c = hj.row_map[row].astype(np.int32)
    P = 4
    key = jax.random.key(3)
    sigma8 = np.asarray(jax_sigma(key, pos, 250_000, P, start=5))
    runs = [np.asarray(x) for x in jax_runs(key, pos, 250_000, P, start=5)]
    ht = hist_tables_from_numpy(
        t3=np.asarray(hj.t3), row_map=hj.row_map, rows_used=hj.rows_used,
        lalpha=hj.lalpha, offsets=hj.offsets, n_cells=hj.n_cells,
        n_rows=hj.n_rows, n_alpha=hj.n_alpha, step=hj.step,
        grid_points=hj.grid_points, device="cpu",
    )
    pt = hist_points_from_numpy(np.asarray(pj.bounds), np.asarray(pj.fbar),
                                device="cpu")
    return dict(hj=hj, pj=pj, ht=ht, pt=pt, pos=pos, row_c=row_c, P=P,
                sigma8=sigma8, runs=runs)


def _kw(ht):
    return dict(n_cells=ht.n_cells, n_rows=ht.n_rows, n_alpha=ht.n_alpha)


def test_site_prefix_bitwise(shared):
    s = shared
    want = np.asarray(JH.build_site_prefix(jnp.asarray(s["row_c"]),
                                           n_rows=s["hj"].n_rows))
    got = TH.build_site_prefix(torch.as_tensor(s["row_c"]),
                               n_rows=s["ht"].n_rows).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_hist_clr_reps_matches_jax(shared):
    s = shared
    W = len(s["pos"])
    sig = np.asarray(jax_expand(jnp.asarray(s["sigma8"]), W))
    row_rep = s["row_c"][sig]  # [P, W] permuted row streams
    hj, pj, ht, pt = s["hj"], s["pj"], s["ht"], s["pt"]
    want = np.asarray(JH.hist_clr_reps(
        hj.t3, pj.bounds, pj.fbar, jnp.asarray(row_rep), c_sub=4, **_kw(hj)))
    got = TH.hist_clr_reps(ht.t3, pt.bounds, pt.fbar,
                           torch.as_tensor(row_rep), **_kw(ht)).numpy()
    assert got.shape == want.shape == (s["P"], pt.bounds.shape[0],
                                       ht.n_alpha)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def _port_rdp(s, bounds, fbar, runs, mm_bf16=False):
    ht = s["ht"]
    psite = TH.build_site_prefix(torch.as_tensor(s["row_c"]),
                                 n_rows=ht.n_rows)
    src, dst, sz = (torch.as_tensor(np.array(x)) for x in runs)
    return TH.rdp_clr_reps(
        ht.t3, bounds, fbar, psite, src, dst, sz,
        n_rep=s["P"], pg=PERM_GROUP, n_groups=s["sigma8"].shape[1],
        mm_bf16=mm_bf16, **_kw(ht),
    )


def test_rdp_matches_jax_and_hist_clr_reps(shared):
    """rdp_clr_reps on JAX's runs == JAX's rdp_clr_reps and the port's
    hist_clr_reps on the same stream."""
    s = shared
    hj, pj, pt = s["hj"], s["pj"], s["pt"]
    psite = JH.build_site_prefix(jnp.asarray(s["row_c"]), n_rows=hj.n_rows)
    want = np.asarray(JH.rdp_clr_reps(
        hj.t3, pj.bounds, pj.fbar, psite, *map(jnp.asarray, s["runs"]),
        n_rep=s["P"], pg=PERM_GROUP, n_groups=s["sigma8"].shape[1], c_sub=4,
        **_kw(hj)))
    got = _port_rdp(s, pt.bounds, pt.fbar, s["runs"]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    W = len(s["pos"])
    sig = np.asarray(jax_expand(jnp.asarray(s["sigma8"]), W))
    ref = TH.hist_clr_reps(s["ht"].t3, pt.bounds, pt.fbar,
                           torch.as_tensor(s["row_c"][sig]),
                           **_kw(s["ht"])).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)


def test_rdp_runs_from_sigma_give_the_same_statistic(shared):
    s = shared
    pt = s["pt"]
    a = _port_rdp(s, pt.bounds, pt.fbar, s["runs"])
    b = _port_rdp(s, pt.bounds, pt.fbar,
                  [x.numpy() for x in runs_from_sigma(s["sigma8"])])
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)


def test_rdp_padding_candidates_are_exactly_zero(shared):
    """All-zero bound rows (padding candidates) give h = 0, CLR 0."""
    s = shared
    pt = s["pt"]
    bounds = torch.cat([pt.bounds, torch.zeros_like(pt.bounds[:5])])
    fbar = torch.cat([pt.fbar, torch.full_like(pt.fbar[:5], 0.5)])
    for mm_bf16 in (False, True):
        out = _port_rdp(s, bounds, fbar, s["runs"], mm_bf16=mm_bf16)
        assert (out[:, -5:] == 0).all()


# ---- _hist_perm_batch: one chromosome --------------------------------------

@pytest.mark.parametrize("chrom", [0, 1])
def test_hist_perm_batch_matches_jax(chrom):
    """Two chromosomes whose second starts off a group boundary, so
    _perm_ps shifts by off != 0; sites past n are masked."""
    data, tables = _two_chr(41, mb=1.0, depth=20)
    hj = JS.make_scan_hist_tables(data, tables, 16, decimate=8)
    cl = data.chr_limits[chrom]
    start, n = cl.start_index, cl.n_snps
    w_pad = -(-(n + 2 * PERM_GROUP) // 4096) * 4096
    pos = data.pos[start:start + n]
    cand = np.linspace(pos[0], pos[-1], 3 * 5).astype(np.int64)
    pj = JH.build_hist_points(hj, pos, cand, 300, cand_pad=5)
    row_cg = hj.row_map[np.asarray(data.row)].astype(np.int32)
    P = 3
    G = -(-data.n_snps // PERM_GROUP)
    sig = np.asarray(jax_sigma(jax.random.key(2), data.genome_pos(), 2e5, P))
    sig = np.concatenate(
        [sig, np.full((P, w_pad // PERM_GROUP + 2), G, np.int32)], 1)
    kw = dict(n_cells=hj.n_cells, n_rows=hj.n_rows, n_alpha=hj.n_alpha,
              start=start, n=n, w_pad=w_pad, n_pts=5, Jf=3)
    want = np.asarray(JP._hist_perm_batch(
        hj.t3, pj.bounds, pj.fbar, jnp.asarray(row_cg), jnp.asarray(sig),
        c_sub=8, **kw))
    got = TP._hist_perm_batch(
        *(torch.as_tensor(np.array(x)) for x in (hj.t3, pj.bounds, pj.fbar)),
        torch.as_tensor(row_cg), torch.as_tensor(sig), **kw).numpy()
    assert start % PERM_GROUP or chrom == 0
    assert got.shape == want.shape == (P, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


# ---- the driver ------------------------------------------------------------

def _two_chr(seed0, mb, depth, grid=512):
    chrs, pos, fr = [], [], []
    for c in range(2):
        sim = simulate_dataset(seed=seed0 + c, sample_size=depth,
                               snp_density=1.0, mb_length=mb, alpha=3e-5,
                               n_sweeps=1)
        chrs += [str(c + 1)] * len(sim["pos"])
        pos.append(sim["pos"])
        fr.append(sim["freq"])
    pos, fr = np.concatenate(pos), np.concatenate(fr)
    data = build_snp_data(chrs, pos, fr, np.full(len(pos), depth),
                          np.zeros(len(pos), bool))
    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths)
    tables = build_tables(fsp, data.sample_depths, grid_points=grid)
    data.attach_model(tables)
    return data, tables


SCAN = dict(eval_range=1500, small_grid_sp=25_000, large_grid_sp=500_000)


@pytest.fixture(scope="module")
def driver_runs():
    """The input of tests/test_rdp.py:88-150: JAX's driver with RDP on,
    and the port's with RDP on and off, on JAX's sigma and runs.  Blocks
    of 0.1 Mb: with 1 Mb blocks on two 3 Mb chromosomes most replicates
    leave a point's window in place and tie its threshold exactly."""
    data, tables = _two_chr(21, mb=3.0, depth=24)
    pc = dict(n_permute=96, chunk_replicates=16, seed=4, hist_bf16=False,
              scan_width_mb=0.1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "device_count", lambda: 1)
        result = JS.scan_genome(data, tables, JS.ScanConfig(**SCAN))
        r_jax = copy.deepcopy(result)
        mp.setattr(JP, "RDP_FORCE", "on")
        JP.scan_permute(data, tables, r_jax, JS.ScanConfig(**SCAN),
                        JP.PermuteConfig(**pc))
        st_jax = dict(JP.last_stats)
    key, gp = jax.random.key(4), data.genome_pos()

    def sigma_source(n, start):
        return np.asarray(jax_sigma(key, gp, 1e5, n, start=start))

    def runs_source(n, start):
        return [np.asarray(x) for x in jax_runs(key, gp, 1e5, n,
                                                start=start)]

    from fscl_tpu_torch.engine.scan import ScanConfig

    out = {}
    for force in ("on", "off"):
        r = copy.deepcopy(result)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TP, "RDP_FORCE", force)
            TP.scan_permute(data, tables, r, ScanConfig(**SCAN),
                            TP.PermuteConfig(**pc), device="cpu",
                            sigma_source=sigma_source,
                            runs_source=runs_source)
        out[force] = (r, dict(TP.last_stats))
    return result, (r_jax, st_jax), out


def test_rdp_driver_dispatch_counts(driver_runs):
    _, (_, st_jax), out = driver_runs
    (_, st_on), (_, st_off) = out["on"], out["off"]
    assert st_jax["rdp_dispatches"] > 0
    assert st_on["rdp_dispatches"] > 0 and st_on["stack_dispatches"] == 0
    assert st_off["rdp_dispatches"] == 0 and st_off["stack_dispatches"] > 0


def _counts_match(result, runs):
    """permute_p and permute_n equal across runs off the 1e-4 near-ties
    (listed); the kept point ids."""
    near = sorted({
        i for i in range(result.n_points) for r in runs
        if np.any(np.abs(np.asarray(r.null_clr[i]) - r.stat_threshold[i])
                  < 1e-4)
    })
    keep = np.setdiff1d(np.arange(result.n_points), near)
    print("near-tie points excluded:", near)
    assert len(keep) >= 0.7 * result.n_points
    assert runs[0].permute_finished[keep].any()  # pruning engaged
    for r in runs[1:]:
        np.testing.assert_array_equal(r.permute_p[keep],
                                      runs[0].permute_p[keep])
        np.testing.assert_array_equal(r.permute_n[keep],
                                      runs[0].permute_n[keep])
    return keep


def test_rdp_driver_matches_stacked_and_jax(driver_runs):
    result, (r_jax, _), out = driver_runs
    (r_on, _), (r_off, _) = out["on"], out["off"]
    np.testing.assert_array_equal(r_on.stat_threshold, r_off.stat_threshold)
    np.testing.assert_allclose(r_on.stat_threshold, r_jax.stat_threshold,
                               rtol=0, atol=1e-3)
    for i in _counts_match(result, (r_jax, r_on, r_off)):
        np.testing.assert_allclose(r_on.null_clr[i], r_off.null_clr[i],
                                   rtol=1e-5, atol=1e-3)


def test_auto_switch_mid_run_matches_jax(monkeypatch):
    """FSCL_RDP=auto switches from the stacked path to RDP when the
    active bounds thin out, at the same chunk as the JAX driver.  This
    input has 8,000 sites and 2,296 bound entries a point (Jf 7, NC 163);
    with the crossover factor at 0.06 the chunks at 80 active points are
    stacked and the last, at 43, is RDP, in both packages.  The port
    draws its runs from the injected JAX sigma (runs_from_sigma)."""
    data, tables = _two_chr(40, mb=4.0, depth=24, grid=256)
    scan = dict(eval_range=300, small_grid_sp=10000, large_grid_sp=100000,
                exact_step_max=1.0, selection_bf16=False)
    pc = dict(n_permute=96, seed=5, chunk_replicates=16, hist_bf16=False,
              scan_width_mb=0.1)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.setattr(JP, "RDP_FORCE", "auto")
    monkeypatch.setattr(TP, "RDP_FORCE", "auto")
    monkeypatch.setattr(JP, "RDP_BOUNDS_FACTOR", 0.06)
    monkeypatch.setattr(TP, "RDP_BOUNDS_FACTOR", 0.06)
    result = JS.scan_genome(data, tables, JS.ScanConfig(**scan))
    r_jax = copy.deepcopy(result)
    JP.scan_permute(data, tables, r_jax, JS.ScanConfig(**scan),
                    JP.PermuteConfig(**pc))
    st_jax = dict(JP.last_stats)
    key, gp = jax.random.key(5), data.genome_pos()

    def sigma_source(n, start):
        return np.asarray(jax_sigma(key, gp, 1e5, n, start=start))

    from fscl_tpu_torch.engine.scan import ScanConfig

    r_port = copy.deepcopy(result)
    TP.scan_permute(data, tables, r_port, ScanConfig(**scan),
                    TP.PermuteConfig(**pc), device="cpu",
                    sigma_source=sigma_source)
    st_port = dict(TP.last_stats)
    assert st_jax["rdp_dispatches"] > 0
    assert st_jax["hist_unsharded_dispatches"] > 0
    assert st_port["rdp_dispatches"] > 0 and st_port["stack_dispatches"] > 0
    np.testing.assert_allclose(r_port.stat_threshold, r_jax.stat_threshold,
                               rtol=0, atol=1e-3)
    _counts_match(result, (r_jax, r_port))
