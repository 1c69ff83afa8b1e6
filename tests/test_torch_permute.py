"""Block permutations and the hist permutation driver: port vs fscl_tpu.

Stated tolerances:
  * sigma generator (fscl_tpu's threefry stream): exact properties —
    bijection made of contiguous group runs, pinned tail, chunked
    generation equal to one-shot generation — and the rows of fscl_tpu's
    block_permutation_groups bit for bit, whose rule redraws an identity
    block order (tests/test_torch_stream.py holds the stream in full);
  * _stack_stat on a shared table, sigma, seg_g0, geometry and t3: float32
    1e-5 relative plus 1e-3 CLR units absolute, bfloat16 1e-2 relative;
  * scan_permute with the JAX sigma injected and hist_bf16=False:
    permute_n, permute_p and permute_finished equal, stat_threshold
    within 1e-3.  Points where some replicate's statistic lies within
    1e-4 of its threshold are listed and excluded: there the two float32
    sums (taken in different orders) can fall on either side of >=.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import fscl_tpu.engine.permute as JP
import fscl_tpu.engine.scan as JS
import fscl_tpu_torch.engine.permute as TP
from fscl_tpu.data import build_snp_data
from fscl_tpu.models import background_fsp, build_tables
from fscl_tpu.ops.permute import block_permutation_groups as jax_sigma
from fscl_tpu.sim import simulate_dataset
from fscl_tpu_torch.ops.permute import (
    PERM_GROUP,
    block_permutation_groups,
    n_blocks_for,
)

SCAN = dict(eval_range=300, small_grid_sp=10000, large_grid_sp=100000,
            exact_step_max=1.0, selection_bf16=False)


def _dataset(n_chr, mb, depth, seed0):
    chrs, pos, fr = [], [], []
    for c in range(n_chr):
        sim = simulate_dataset(seed=seed0 + c, sample_size=depth,
                               mb_length=mb, alpha=3e-5)
        chrs += [str(c + 1)] * len(sim["pos"])
        pos.append(sim["pos"])
        fr.append(sim["freq"])
    pos, fr = np.concatenate(pos), np.concatenate(fr)
    data = build_snp_data(chrs, pos, fr, np.full(len(pos), depth),
                          np.zeros(len(pos), bool))
    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths)
    tables = build_tables(fsp, data.sample_depths, grid_points=256)
    data.attach_model(tables)
    return data, tables


@pytest.fixture(scope="module")
def scanned():
    data, tables = _dataset(2, 4.0, 24, 40)
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


# ---- the sigma generator ----------------------------------------------------

@pytest.fixture(scope="module")
def gpos():
    rng = np.random.default_rng(0)
    return np.cumsum(rng.integers(1, 2000, 6000)).astype(np.int64)


def test_sigma_rows_are_block_bijections(gpos):
    sig = block_permutation_groups(7, gpos, 1e6, 24, device="cpu").numpy()
    G = -(-len(gpos) // PERM_GROUP)
    assert sig.shape == (24, G) and sig.dtype == np.int32
    for row in sig:
        np.testing.assert_array_equal(np.sort(row), np.arange(G))
        assert row[-1] == G - 1  # pinned tail group
        # contiguous runs: each block is a run of consecutive groups
        breaks = np.count_nonzero(np.diff(row) != 1)
        span = int(gpos[-1] - gpos[0])
        assert breaks + 1 <= span // 1_000_000 + 3
    np.testing.assert_array_equal(
        sig, np.asarray(jax_sigma(jax.random.key(7), gpos, 1e6, 24)))


def test_sigma_chunking_replays_stream(gpos):
    full = block_permutation_groups(11, gpos, 5e5, 12, start=4,
                                    device="cpu").numpy()
    part = block_permutation_groups(11, gpos, 5e5, 5, start=9,
                                    device="cpu").numpy()
    np.testing.assert_array_equal(full[5:10], part)
    other = block_permutation_groups(12, gpos, 5e5, 12, start=4,
                                     device="cpu").numpy()
    assert not np.array_equal(full, other)


def test_short_genome_still_mixes():
    """Two to four shuffled blocks: an identity block order is redrawn
    from fold_in(key, 1), as fscl_tpu does, so some rows here are
    redraws, and every row is fscl_tpu's bit for bit."""
    g = np.arange(0, 2_500_000, 400, dtype=np.int64)
    sig = block_permutation_groups(3, g, 1e6, 16, device="cpu").numpy()
    np.testing.assert_array_equal(
        sig, np.asarray(jax_sigma(jax.random.key(3), g, 1e6, 16)))
    B = n_blocks_for(int(g[-1] - g[0]), 1e6) - 1
    first = [np.asarray(jax.random.permutation(
        jax.random.split(jax.random.fold_in(jax.random.key(3), r))[1], B))
        for r in range(16)]
    assert any(np.array_equal(o, np.arange(B)) for o in first)


# ---- the statistic ---------------------------------------------------------

@pytest.mark.parametrize("mm_bf16", [False, True])
def test_stack_stat_matches(scanned, mm_bf16):
    data, tables, result = scanned
    cfg = TP.PermuteConfig(n_permute=8, hist_bf16=mm_bf16)
    hs = TP.setup_hist(data, tables, result, _scan_cfg(), cfg, "cpu")
    st = hs.stacks[0]
    st.rebuild(result, TP.active_by_chr(result, st,
                                        np.ones(result.n_points, bool)))
    P = 4
    sig = np.asarray(jax_sigma(jax.random.key(3), data.genome_pos(), 1e6, P))
    sig_p = hs.pad_sigma(sig)
    got = TP._stack_stat(
        hs.table, sig_p, st.seg_g0, st.bounds, st.fbar, hs.ht.t3,
        w_seg_p=st.w_seg_p, n_rows=hs.ht.n_rows, n_cells=hs.ht.n_cells,
        n_alpha=hs.ht.n_alpha, sub_rep=2, n_pts=len(st.pts), Jf=st.Jf,
        mm_bf16=mm_bf16,
    ).numpy()
    S = st.n_seg_pad
    z = jnp.zeros(S, jnp.int32)
    want = np.asarray(JP._stack_stat(
        jnp.asarray(hs.table.numpy()), jnp.asarray(sig_p.numpy()),
        jnp.asarray(st.seg_g0.numpy()), z, z,
        jnp.asarray(st.bounds.numpy()), jnp.asarray(st.fbar.numpy()),
        jnp.asarray(hs.ht.t3.numpy()),
        w_seg_p=st.w_seg_p, n_seg=S, n_rows=hs.ht.n_rows,
        n_cells=hs.ht.n_cells, n_alpha=hs.ht.n_alpha, sub_rep=2,
        n_slices=P // 2, n_pts=len(st.pts), Jf=st.Jf, mm_bf16=mm_bf16,
    ))
    assert got.shape == want.shape == (P, len(st.pts))
    if mm_bf16:
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def _scan_cfg():
    from fscl_tpu_torch.engine.scan import ScanConfig

    return ScanConfig(**SCAN)


# ---- the driver ------------------------------------------------------------

def test_scan_permute_matches_with_shared_sigma(scanned):
    data, tables, result = scanned
    pc = dict(n_permute=96, seed=5, chunk_replicates=16, hist_bf16=False,
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
    TP.scan_permute(data, tables, r_port, _scan_cfg(),
                    TP.PermuteConfig(**pc), device="cpu",
                    sigma_source=sigma_source)

    np.testing.assert_allclose(r_port.stat_threshold, r_jax.stat_threshold,
                               rtol=0, atol=1e-3)
    near = [
        i for i in range(result.n_points)
        for r in (r_jax, r_port)
        if np.any(np.abs(np.asarray(r.null_clr[i]) - r.stat_threshold[i])
                  < 1e-4)
    ]
    keep = np.setdiff1d(np.arange(result.n_points), near)
    print("near-tie points excluded:", sorted(set(near)))
    assert len(keep) >= 0.7 * result.n_points
    assert r_jax.permute_finished[keep].any()  # pruning engaged
    np.testing.assert_array_equal(r_port.permute_p[keep],
                                  r_jax.permute_p[keep])
    np.testing.assert_array_equal(r_port.permute_n[keep],
                                  r_jax.permute_n[keep])
    np.testing.assert_array_equal(r_port.permute_finished[keep],
                                  r_jax.permute_finished[keep])


def test_round_updates_match_jax():
    """The copied pruning update consumes the host RNG stream exactly as
    fscl_tpu's does (one draw per exceedance past the threshold)."""
    class Res:
        pass

    class Cfg:
        null_dist_save = 11

    g = np.random.default_rng(0)
    for trial in range(10):
        K, R = int(g.integers(3, 40)), int(g.integers(1, 64))
        act = np.sort(g.choice(K, size=int(g.integers(1, K + 1)),
                               replace=False))
        thr = g.random(K) * 2
        nm = g.random((R, len(act))) * 2.5
        runs = []
        for mod in (JP, TP):
            r = Res()
            h = np.random.default_rng(trial)
            r.permute_p = h.integers(0, 30, K).astype(np.int64)
            r.permute_n = h.integers(1, 200, K).astype(np.int64)
            r.permute_finished = h.random(K) < 0.2
            r.null_clr = [list(h.random(int(n)))
                          for n in h.integers(0, 13, K)]
            active = ~r.permute_finished.copy()
            mod._apply_round_updates(r, active, thr,
                                     np.random.default_rng(99 + trial),
                                     Cfg, act, nm, 100, R)
            runs.append((r, active))
        (a, aa), (b, ab) = runs
        np.testing.assert_array_equal(a.permute_p, b.permute_p)
        np.testing.assert_array_equal(a.permute_n, b.permute_n)
        np.testing.assert_array_equal(a.permute_finished, b.permute_finished)
        np.testing.assert_array_equal(aa, ab)
