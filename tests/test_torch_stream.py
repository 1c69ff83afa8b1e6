"""fscl_tpu's block-permutation stream in the port (fscl_tpu_torch/ops/
permute.py, kernel csrc/replicate_runs.cu) and the hist driver's
speculation and sigma cap (fscl_tpu_torch/engine/permute.py), against
fscl_tpu.

Stated tolerances:
  * the stream: the plain version's sigma and runs equal fscl_tpu's
    (_replicates, _replicates_runs, block_permutation_groups,
    block_permutation_runs) bit for bit, at seeds 0, 1 and 2^31 - 1,
    starts 0, 37 and 2^32 - 5 (across the uint32 wrap), a genome of 2-3
    shuffled blocks (redraws fire), more than 1,625 blocks (two sort
    rounds), empty blocks with a partial tail group, and coordinates past
    2^24 (float32 rounding of the group positions);
  * scan_permute on its default stream against fscl_tpu's default, at
    hist_bf16=False (the stacked path, RDP forced on, the lattice path):
    stat_threshold within 1e-3; permute_n, permute_p and
    permute_finished equal off listed near-tie points (a saved replicate
    within 1e-4 of its threshold, and not at it: there the two float32
    statistics can fall on either side of >=, as in
    tests/test_torch_lattice.py);
  * both CLIs with one --seed: positions equal, CLR within 1e-3, the
    permute_p and permute_n columns equal and -log10(p) within 1e-3 off
    the near-tie rows;
  * the chunk schedule: boost_cap and the first tier equal fscl_tpu's
    _boost_levels on a grid; later tiers follow the rule of
    fscl_tpu/engine/permute.py:1447-1466, the cap halving them;
  * speculation (FSCL_STAT_SPEC): every result bit for bit equal on and
    off, taken chunks counted, a miss counted once, the speculative chunk
    dropped before an RDP chunk runs, a break resumed bit for bit;
  * a checkpoint written by fscl_tpu resumed by the port: as the
    scan_permute comparison above, against fscl_tpu's unbroken run;
  * on the card (gpu): the kernel's runs and sigma equal its plain
    version's bit for bit, at the shapes above, at genome1m's chunks (R =
    2,048 and 16, G = 24,304), at B = 1, 2, 3, 31-33, 8,192-8,193,
    16,384-16,385 and 65,536-65,537, with more blocks than groups, and
    at about 33,000 blocks (R = 256); the launch plan's byte counts are
    the kernel's.

This file imports nothing of tests/: on the card machine such imports do
not collect.
"""

import copy
import gc
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fscl_tpu.engine.permute as JP
import fscl_tpu.engine.scan as JS
import fscl_tpu.ops.permute as JO
import fscl_tpu_torch.engine.permute as TP
import fscl_tpu_torch.engine.scan as TS
import fscl_tpu_torch.ops.permute as TO
from fscl_tpu.data import build_snp_data
from fscl_tpu.models import background_fsp, build_tables
from fscl_tpu.sim import simulate_dataset

SCAN = dict(eval_range=100, small_grid_sp=10000, large_grid_sp=100000,
            exact_step_max=1.0, selection_bf16=False)
# 0.1 Mb blocks: at 1 Mb this 4 Mb genome has four blocks, and replicates
# that leave a chromosome's neighbourhood in place tie its threshold
PC = dict(chunk_replicates=1, seed=5, hist_positions=2, hist_alphas=16,
          hist_bf16=False, scan_width_mb=0.1)
NEAR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this file runs (the suite runs files in
    several processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the stream -----------------------------------------------------------

def _gpos(kind):
    rng = np.random.default_rng(11)
    if kind == "spread":  # 6,000 sites, ~6 Mb
        return np.cumsum(rng.integers(1, 2000, 6000)).astype(np.int64)
    if kind == "short":  # 2-3 shuffled blocks at 1 Mb
        return np.sort(rng.choice(1_900_000, 3_000, replace=False))
    if kind == "many":  # > 1,625 blocks at 1.5 kb: two sort rounds
        return np.cumsum(rng.integers(1, 60, 100_000)).astype(np.int64)
    if kind == "gaps":  # empty blocks, a partial tail group (W % 32 != 0)
        parts = [np.sort(rng.choice(np.arange(a, a + 800_000), 900,
                                    replace=False))
                 for a in (0, 3_000_000, 3_900_000, 9_000_000)]
        return np.concatenate(parts)[:3_583].astype(np.int64)
    # genome-scale coordinates: float32 rounds the group positions
    return np.sort(rng.choice(900_000_000, 20_000, replace=False)) + 7


def _jax_stream(seed, gpos, width, n, start):
    key = jax.random.key(seed)
    sig = np.asarray(JO.block_permutation_groups(key, gpos, width, n,
                                                 start=start))
    runs = [np.asarray(x) for x in JO.block_permutation_runs(
        key, gpos, width, n, start=start)]
    return sig, runs


def _port_stream(seed, gpos, width, n, start):
    sig = TO.block_permutation_groups(seed, gpos, width, n, start=start,
                                      device="cpu").numpy()
    runs = [x.numpy() for x in TO.block_permutation_runs(
        seed, gpos, width, n, start=start, device="cpu")]
    return sig, runs


def _assert_stream_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert got[0].dtype == np.int32 and got[1][0].dtype == np.int32


def test_threefry_partitionable_is_the_copied_mode():
    """The port copies split and random_bits as JAX computes them under
    jax_threefry_partitionable; a JAX whose default differs fails here,
    not silently in the stream."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("start", [0, 37, 2**32 - 5])
@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
def test_plain_stream_matches_fscl_tpu(seed, start):
    g = _gpos("spread")
    _assert_stream_equal(_port_stream(seed, g, 1e5, 6, start),
                         _jax_stream(seed, g, 1e5, 6, start))


@pytest.mark.parametrize("kind, width", [("short", 1e6), ("many", 1500.0),
                                         ("gaps", 3e5), ("genome", 1e6)])
def test_plain_stream_shapes_match_fscl_tpu(kind, width):
    g = _gpos(kind)
    want = _jax_stream(3, g, width, 12, 5)
    _assert_stream_equal(_port_stream(3, g, width, 12, 5), want)
    span = int(g[-1] - g[0])
    B = TO.n_blocks_for(span, width) - 1
    if kind == "short":
        assert B <= 3
        # redraws fired: some row's first block order was the identity
        ident = 0
        for r in range(12):
            k = jax.random.fold_in(jax.random.key(3), jnp.uint32(5 + r))
            first = np.asarray(jax.random.permutation(
                jax.random.split(k)[1], B))
            ident += np.array_equal(first, np.arange(B))
        assert ident > 0
    if kind == "many":
        assert B > 1625 and TO.shuffle_rounds(B) == 2
    if kind == "gaps":
        assert len(g) % TO.PERM_GROUP and (want[1][2] == 0).any()


def test_private_draws_match_fscl_tpu():
    """The jitted _replicates and _replicates_runs on fscl_tpu's own
    group positions against replicate_runs_plain on the port's."""
    g = _gpos("gaps")
    g0_j, span = JO._group_first_positions(g)
    nb = JO.n_blocks_for(span, 3e5)
    w = JO.effective_block_width(span, 3e5)
    key, n = jax.random.key(2**31 - 1), 9
    sig_j = np.asarray(JO._replicates(key, jnp.uint32(2**32 - 5), g0_j,
                                      n_blocks=nb, n_replicates=n, width=w))
    runs_j = JO._replicates_runs(key, jnp.uint32(2**32 - 5), g0_j,
                                 n_blocks=nb, n_replicates=n, width=w)
    g0f, span_t = TO._g0_device(g, "cpu")
    assert span_t == span and nb == TO.n_blocks_for(span, 3e5)
    src, dst, sz, sig = TO.replicate_runs_plain(2**31 - 1, 2**32 - 5, g0f,
                                                nb, w, n, with_sigma=True)
    np.testing.assert_array_equal(sig.numpy(), sig_j)
    for a, b in zip((src, dst, sz), runs_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the wrapper on CPU tensors: the plain version, in its two forms
    runs, sig2 = TO.replicate_runs(2**31 - 1, 2**32 - 5, g0f, nb, w, n,
                                   with_runs=False, with_sigma=True)
    assert runs is None and torch.equal(sig2, sig)


# ---- scan_permute and the CLIs on the default stream ------------------------

def _data(n_chr, mb, seed0, depth=24):
    chrs, pos, fr = [], [], []
    for c in range(n_chr):
        sim = simulate_dataset(seed=seed0 + c, sample_size=depth,
                               mb_length=mb, alpha=3e-5)
        keep = (sim["freq"] >= 1) & (sim["freq"] <= depth - 1)
        chrs += [str(c + 1)] * int(keep.sum())
        pos.append(sim["pos"][keep])
        fr.append(sim["freq"][keep])
    pos, fr = np.concatenate(pos), np.concatenate(fr)
    data = build_snp_data(chrs, pos, fr, np.full(len(pos), depth),
                          np.zeros(len(pos), bool))
    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths)
    tables = build_tables(fsp, data.sample_depths, grid_points=256)
    data.attach_model(tables)
    return data, tables


@pytest.fixture(scope="module")
def onehot():
    data, tables = _data(2, 2.0, 40)
    cfg = TS.ScanConfig(**SCAN)
    return data, tables, TS.scan_genome(data, tables, cfg, device="cpu"), cfg


@pytest.fixture(scope="module")
def lattice():
    data, tables = _data(1, 2.0, 70)
    cfg = TS.ScanConfig(**dict(SCAN, use_hist=False))
    return data, tables, TS.scan_genome(data, tables, cfg, device="cpu"), cfg


def _fresh(result):
    r = copy.deepcopy(result)
    r.permute_n[:] = 0
    r.permute_p[:] = 0
    r.permute_finished[:] = False
    r.null_clr = [[] for _ in range(r.n_points)]
    r.stat_threshold = None
    return r


def _near_ties(*results):
    """Points with a saved replicate within NEAR of, and not at, its
    threshold (a replicate at it left the point's windows in place, and
    both packages count it)."""
    out = set()
    for r in results:
        for i in range(r.n_points):
            d = np.abs(np.asarray(r.null_clr[i]) - r.stat_threshold[i])
            if np.any((d < NEAR) & (d > 0)):
                out.add(i)
    return sorted(out)


def _assert_counts_match(r_port, r_jax, min_keep=0.7):
    np.testing.assert_allclose(r_port.stat_threshold, r_jax.stat_threshold,
                               rtol=0, atol=1e-3)
    near = _near_ties(r_port, r_jax)
    keep = np.setdiff1d(np.arange(r_jax.n_points), near)
    print("near-tie points excluded:", near)
    assert len(keep) >= min_keep * r_jax.n_points
    for f in ("permute_p", "permute_n", "permute_finished"):
        np.testing.assert_array_equal(getattr(r_port, f)[keep],
                                      getattr(r_jax, f)[keep])
    return keep


@pytest.mark.parametrize("path", ["stacked", "rdp", "lattice"])
def test_scan_permute_default_stream_matches_fscl_tpu(path, onehot, lattice,
                                                      monkeypatch):
    data, tables, result, scan_cfg = lattice if path == "lattice" else onehot
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    rdp = "on" if path == "rdp" else "off"
    monkeypatch.setattr(JP, "RDP_FORCE", rdp)
    monkeypatch.setattr(TP, "RDP_FORCE", rdp)
    pc = dict(PC, n_permute=48, chunk_replicates=16,
              use_hist=path != "lattice")
    r_jax = _fresh(result)
    JP.scan_permute(data, tables, r_jax,
                    JS.ScanConfig(**dict(SCAN, use_hist=scan_cfg.use_hist)),
                    JP.PermuteConfig(**pc))
    r_port = _fresh(result)
    TP.scan_permute(data, tables, r_port, scan_cfg, TP.PermuteConfig(**pc),
                    device="cpu")
    keep = _assert_counts_match(r_port, r_jax)
    assert r_jax.permute_finished[keep].any()  # pruning engaged
    if path == "rdp":
        assert TP.last_stats["rdp_dispatches"] > 0
    if path == "lattice":
        assert TP.last_stats["lattice_dispatches"] > 0


def _write_sf(path, data):
    with open(path, "w") as f:
        for cl in data.chr_limits:
            sl = slice(cl.start_index, cl.start_index + cl.n_snps)
            np.savetxt(f, np.column_stack([
                data.pos[sl], data.obs_freq[sl],
                np.asarray(data.sample_depths)[data.depth_p[sl]],
                data.folded[sl].astype(int)]),
                fmt=cl.name + "\t%d\t%d\t%d\t%d")


def test_clis_same_seed_same_pvalues(onehot, tmp_path, monkeypatch):
    import fscl_tpu.cli as JCLI
    import fscl_tpu_torch.cli as TCLI
    from fscl_tpu.cli import main as jax_main
    from fscl_tpu_torch.cli import main

    monkeypatch.setattr(jax, "device_count", lambda: 1)
    sf = tmp_path / "d.sf"
    _write_sf(sf, onehot[0])
    kept = {"port": [], "jax": []}

    def capture(mod, attr, store):
        orig = getattr(mod, attr)

        def wrap(data, tables, result, *a, **kw):
            out = orig(data, tables, result, *a, **kw)
            store.append(result)
            return out

        monkeypatch.setattr(mod, attr, wrap)

    capture(TCLI, "scan_permute", kept["port"])
    capture(JCLI, "scan_permute", kept["jax"])
    args = ["-f", str(sf), "-p", "40", "--seed", "77", "--eval-range", "100",
            "-w", "0.1",
            "-G", "100000", "-g", "10000", "--grid-points", "256", "-v", "1"]
    out_t, out_j = tmp_path / "port.tsv", tmp_path / "jax.tsv"
    assert main([*args, "-o", str(out_t), "--device", "cpu"]) == 0
    assert jax_main([*args, "-o", str(out_j)]) == 0
    (rt,), (rj,) = kept["port"], kept["jax"]
    near = set(_near_ties(rt, rj))
    rows_t = [ln.split("\t") for ln in out_t.read_text().splitlines()]
    rows_j = [ln.split("\t") for ln in out_j.read_text().splitlines()]
    assert len(rows_t) == len(rows_j) == rj.n_points > 0
    keep = [i for i in range(len(rows_j)) if i not in near]
    print("near-tie rows excluded:", sorted(near))
    assert len(keep) >= 0.7 * len(rows_j)
    assert [r[:2] for r in rows_t] == [r[:2] for r in rows_j]
    np.testing.assert_allclose([float(r[2]) for r in rows_t],
                               [float(r[2]) for r in rows_j], atol=1e-3)
    for i in keep:
        assert rows_t[i][4:6] == rows_j[i][4:6], i
        np.testing.assert_allclose(float(rows_t[i][6]), float(rows_j[i][6]),
                                   rtol=0, atol=1e-3)


def test_fscl_tpu_checkpoint_resumes_in_port(onehot, tmp_path, monkeypatch):
    """fscl_tpu broken at a chunk boundary (16 of 32 rounds, chunks of
    16, before any pruning draw), resumed by the port from fscl_tpu's
    file, against fscl_tpu's unbroken run."""
    data, tables, result, scan_cfg = onehot
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    pc = dict(PC, n_permute=32)
    ck = str(tmp_path / "j.npz")
    j_scan = JS.ScanConfig(**SCAN)
    part = _fresh(result)
    JP.scan_permute(data, tables, part, j_scan,
                    JP.PermuteConfig(**dict(pc, n_permute=16,
                                            checkpoint_path=ck)))
    assert part.permute_p.max() < TP.PRUNE_THRESHOLD
    r_port = _fresh(result)
    TP.scan_permute(data, tables, r_port, scan_cfg,
                    TP.PermuteConfig(**dict(pc, checkpoint_path=ck)),
                    device="cpu")
    r_jax = _fresh(result)
    JP.scan_permute(data, tables, r_jax, j_scan, JP.PermuteConfig(**pc))
    assert (r_port.permute_n[~r_port.permute_finished] == 32).all()
    keep = _assert_counts_match(r_port, r_jax)
    assert r_jax.permute_finished[keep].any()


# ---- the chunk schedule ---------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 16, 17, 32, 100])
def test_boost_cap_and_first_tier_match_fscl_tpu(chunk):
    cfg = JP.PermuteConfig(chunk_replicates=chunk)
    for n_groups in (1, 625, 24_304, 131_060, 2_000_000, 64_000_001):
        cap = TP.boost_cap(n_groups, chunk)
        for n_act in (1, 8, 31, 32, 33, 63, 64, 65, 300, 1024, 1025, 10_010):
            assert (TP.boost_tier(n_act, 0, chunk, cap), cap) == \
                JP._boost_levels(n_act, n_groups, cfg), (n_groups, n_act)


def _tier_rule(n_act, rounds_done, chunk, cap):
    """fscl_tpu/engine/permute.py:1447-1466, written out."""
    b = 4 if n_act <= 1024 and rounds_done >= 8 * chunk else 1
    b = 16 if n_act <= 64 else b
    b = 64 if n_act <= 32 else b
    b = 128 if n_act <= 32 and rounds_done > 0 else b
    while b > cap:
        b //= 2
    return max(b, 1)


def test_boost_later_tiers_and_the_cap():
    assert TP.boost_cap(24_304, 32) == 82  # genome1m: 777,727 sites
    assert TP.boost_tier(22, 128, 32, 82) == 64  # 2,048-replicate chunks
    assert TP.boost_tier(22, 0, 32, 82) == 64
    assert TP.boost_tier(22, 128, 32, TP.boost_cap(625, 32)) == 128
    for chunk in (1, 16, 32):
        for n_groups in (625, 24_304, 131_060, 2_000_000):
            cap = TP.boost_cap(n_groups, chunk)
            for rounds in (4, 128):
                for n_act in (1, 22, 32, 33, 64, 65, 1024, 1025):
                    assert TP.boost_tier(n_act, rounds, chunk, cap) == \
                        _tier_rule(n_act, rounds, chunk, cap)


# ---- speculation -----------------------------------------------------------

def _tail(result):
    """The deep tail of bench/run_tail.py in small: one point a
    chromosome left active (its largest CLR), the rest finished."""
    r = _fresh(result)
    keep = [np.where(r.chr_id == c)[0][np.argmax(r.clr[r.chr_id == c])]
            for c in np.unique(r.chr_id)]
    r.permute_finished[:] = True
    r.permute_finished[keep] = False
    return r


def _spec_run(scanned, spec, n, ck=None, **pc):
    data, tables, result, scan_cfg = scanned
    r = _tail(result)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "STAT_SPEC", spec)
        TP.scan_permute(data, tables, r, scan_cfg,
                        TP.PermuteConfig(**dict(PC, n_permute=n,
                                                checkpoint_path=ck, **pc)),
                        device="cpu")
    return r, dict(TP.last_stats)


def _assert_same(got, want):
    for f in ("permute_n", "permute_p", "permute_finished",
              "stat_threshold"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for i, (a, b) in enumerate(zip(got.null_clr, want.null_clr)):
        assert a == b, f"point {i}: null_clr differs"


@pytest.fixture(scope="module")
def spec_runs(onehot):
    """The tail at chunks of 64, 128 and 128 (tiers 64 and 128), with
    speculation on and off, RDP off."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "RDP_FORCE", "off")
        on = _spec_run(onehot, True, 320)
        off = _spec_run(onehot, False, 320)
    return on, off


def test_speculation_is_bitwise_and_taken(spec_runs):
    (r_on, st_on), (r_off, st_off) = spec_runs
    _assert_same(r_on, r_off)
    assert st_on["hist_spec_chunks"] == 2 and st_on["hist_spec_misses"] == 0
    assert st_off["hist_spec_chunks"] == st_off["hist_spec_misses"] == 0
    assert st_on["stack_dispatches"] == st_off["stack_dispatches"]
    assert (r_on.permute_n[~r_on.permute_finished] == 320).all()


def test_a_miss_counts_once(onehot, spec_runs, monkeypatch):
    """Every speculative chunk refused (a compaction said due): each is
    one miss, its dispatches are not counted, and the results are those
    of the run without speculation."""
    monkeypatch.setattr(TP, "RDP_FORCE", "off")
    monkeypatch.setattr(TP, "_compaction_due", lambda *a: True)
    calls = []
    orig = TP._stack_chunk

    def spy(hs, cfg, result, active, R, start, *a, **kw):
        out = orig(hs, cfg, result, active, R, start, *a, **kw)
        calls.append((start, len(out)))
        return out

    monkeypatch.setattr(TP, "_stack_chunk", spy)
    r, st = _spec_run(onehot, True, 320)
    _assert_same(r, spec_runs[1][0])
    starts = [s for s, _ in calls]
    twice = [s for s in set(starts) if starts.count(s) == 2]
    assert len(twice) == 2 and st["hist_spec_misses"] == 2
    assert st["hist_spec_chunks"] == 0
    assert st["stack_dispatches"] == spec_runs[1][1]["stack_dispatches"]


def test_rdp_engaging_drops_the_speculative_chunk(onehot, monkeypatch):
    """RDP is predicted off when the next chunk is enqueued, and engages
    at its top: the speculative chunk's tensors are freed before the RDP
    chunk runs, and it counts one miss."""
    answers = iter([False, False])  # chunk 1's top, its speculation
    monkeypatch.setattr(TP._RdpTail, "wanted",
                        lambda self, active: next(answers, True))
    refs = []  # the speculative chunk's outputs (the chunk at 64)
    orig_chunk, orig_stack = TP._RdpTail.chunk, TP._stack_chunk

    def stack_spy(hs, cfg, result, active, R, start, *a, **kw):
        out = orig_stack(hs, cfg, result, active, R, start, *a, **kw)
        if start == 64:
            refs.extend(weakref.ref(o) for _, o in out)
        return out

    freed = []

    def rdp_spy(self, *a, **kw):
        gc.collect()
        freed.append(all(x() is None for x in refs))
        return orig_chunk(self, *a, **kw)

    monkeypatch.setattr(TP, "_stack_chunk", stack_spy)
    monkeypatch.setattr(TP._RdpTail, "chunk", rdp_spy)
    r, st = _spec_run(onehot, True, 320)
    assert refs and freed and freed[0]
    assert st["hist_spec_misses"] == 1 and st["hist_spec_chunks"] == 0
    assert st["rdp_dispatches"] == 2
    answers = iter([False, False])
    refs.clear()
    r_off, _ = _spec_run(onehot, False, 320)
    _assert_same(r, r_off)


def test_break_and_resume_with_speculation(onehot, spec_runs, tmp_path,
                                           monkeypatch):
    """Broken at 192 of 320 rounds (a chunk boundary, a speculative
    chunk in flight at the save), resumed: bit for bit the unbroken run.
    No point reaches PRUNE_THRESHOLD exceedances in the tail here, so
    the resume's re-seeded pruning RNG is never drawn."""
    monkeypatch.setattr(TP, "RDP_FORCE", "off")
    ck = str(tmp_path / "s.npz")
    part, st_part = _spec_run(onehot, True, 192, ck)
    assert part.permute_p.max() < TP.PRUNE_THRESHOLD
    assert st_part["hist_spec_chunks"] == 1
    resumed, _ = _spec_run(onehot, True, 320, ck)
    _assert_same(resumed, spec_runs[0][0])


# ---- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _genome1m_gpos():
    """22 chromosomes of 45.5 Mb, 777,727 sites (bench/headline.py's
    genome1m layout), positions from a seed."""
    rng = np.random.default_rng(5)
    per = np.full(22, 777_727 // 22)
    per[: 777_727 % 22] += 1
    parts, off = [], 0
    for n in per:
        parts.append(np.sort(rng.choice(45_500_000, n, replace=False)) + off)
        off += 45_500_000
    return np.concatenate(parts).astype(np.int64)


@pytest.mark.gpu
@pytest.mark.parametrize("kind, width, nb, seed, start, n", [
    ("spread", 1e5, None, 0, 0, 32), ("spread", 1e5, None, 1, 37, 32),
    ("spread", 1e5, None, 2**31 - 1, 2**32 - 5, 32),
    ("short", 1e6, None, 3, 5, 64), ("many", 1500.0, None, 3, 5, 16),
    ("gaps", 3e5, None, 3, 5, 32), ("genome", 1e6, None, 3, 5, 32),
    ("genome1m", 1e6, None, 4, 96, 2048),
    # genome1m's first chunk at the CLI's default: 12 tiles a row
    ("genome1m", 1e6, None, 0, 0, 16),
    # B = 1, 2 (half the rows redraw) and 3 at few replicates
    ("spread", 1e5, 2, 3, 5, 8), ("spread", 1e5, 3, 3, 5, 64),
    ("spread", 1e5, 4, 9, 0, 4),
    # B = 31, 32 (32 radix buckets), 33 (64)
    ("spread", 3e3, 32, 7, 0, 32), ("spread", 3e3, 33, 7, 0, 32),
    ("spread", 3e3, 34, 7, 0, 32),
    # G = 112 groups in 600 blocks: most blocks empty
    ("gaps", 1e3, 600, 3, 5, 16),
    # B = 8,192 (the largest sort in shared memory) and 8,193 (global
    # scratch), the old cap 16,384 and 16,385, about 33,000 at genome1m's
    # coordinates (a 3.1 Gb genome at -w 0.1), and 65,536-65,537 (P
    # from 65,536 to 131,072)
    ("many", 100.0, 8193, 3, 5, 8), ("many", 100.0, 8194, 3, 5, 8),
    ("many", 100.0, 16385, 3, 5, 8), ("many", 100.0, 16386, 3, 5, 8),
    ("genome1m", 3e4, None, 4, 96, 256), ("many", 100.0, 65537, 3, 5, 4),
    ("many", 100.0, 65538, 3, 5, 4)])
def test_kernel_matches_plain_on_card(kind, width, nb, seed, start, n):
    dev = _card()
    g = _genome1m_gpos() if kind == "genome1m" else _gpos(kind)
    g0f, span = TO._g0_device(g, dev)
    nb = nb or TO.n_blocks_for(span, width)
    w = TO.effective_block_width(span, width)
    before = TO.replicate_runs_launches
    runs, sig = TO.replicate_runs(seed, start, g0f, nb, w, n,
                                  with_sigma=True)
    runs_only, none = TO.replicate_runs(seed, start, g0f, nb, w, n)
    again = TO.replicate_runs(seed, start, g0f, nb, w, n, with_runs=False,
                              with_sigma=True)[1]
    assert none is None and TO.replicate_runs_launches == before + 3
    src, dst, sz, sig_p = TO.replicate_runs_plain(seed, start, g0f, nb, w, n,
                                                  with_sigma=True)
    torch.cuda.synchronize()
    assert torch.equal(sig, sig_p) and torch.equal(again, sig_p)
    for a, b, c in zip(runs, runs_only, (src, dst, sz)):
        assert torch.equal(a, c) and torch.equal(b, c)
    if kind == "genome1m" and width == 1e6:
        assert sig.shape == (n, 24_304)
    if kind == "genome1m" and width == 3e4:
        assert 32_000 < nb - 1 < 34_000


@pytest.mark.gpu
@pytest.mark.parametrize("n, G, nb, sigma", [
    (32, 625, 22, True), (2048, 24_304, 1003, True), (16, 24_304, 1003, True),
    (16, 131_060, 122, True), (256, 24_304, 33_369, True),
    (256, 24_304, 33_369, False), (8, 3125, 16_386, True),
    (8, 3125, 70_000, True)])
def test_plan_bytes_match_the_kernel_on_card(n, G, nb, sigma):
    """The planner's shared-memory and scratch sizes are the kernel's."""
    _card()
    from fscl_tpu_torch import kernels

    plan = TO.plan_replicate_runs(n, G, nb, sigma)
    tbl_len = (plan.tile_len >> plan.shift) + 2
    got = kernels.load().fscl_replicate_runs_bytes(plan.P, nb, tbl_len)
    assert got == TO.replicate_runs_bytes(plan.P, nb, tbl_len)
    assert got == (plan.slot_bytes if plan.on_global else plan.smem_bytes)
