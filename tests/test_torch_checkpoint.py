"""Checkpoint, SIGINT and resume of the port (fscl_tpu_torch/engine/
checkpoint.py and the drivers of engine/permute.py), against itself and
against fscl_tpu.

Stated tolerances:
  * one save sequence through both packages' Checkpointers: the replayed
    states equal (counters, thresholds, the float32 reservoir values),
    whichever package replays; the port refuses fscl_tpu's files (no
    sigma-stream entry) with a ValueError naming the stream, and
    fscl_tpu, which checks only positions and CLRs, accepts the port's
    (stated here, not changed: fscl_tpu is not edited);
  * a resumed run against the uninterrupted run, the break on a chunk
    boundary of the uninterrupted run and before any point reached
    PRUNE_THRESHOLD exceedances (no pruning draw yet): permute_n,
    permute_p, permute_finished, stat_threshold and every null_clr equal
    bit for bit (hist stacked, RDP forced on, compressed mixed depth, the
    lattice path, a run killed mid-chunk, a run that took one SIGINT);
  * a break after pruning draws (the pruning RNG is re-seeded on resume,
    as in fscl_tpu): tests/test_engine_extras.py's contract, the
    reservoirs of points pruned in neither run equal within 1e-5
    (sorted), every stat_threshold restored within 1e-5, permute_n of
    those points at the target;
  * across packages: fscl_tpu's interrupted and resumed run against the
    port's, fed the JAX sigma, at hist_bf16=False: stat_threshold within
    1e-3; permute_n, permute_p and permute_finished equal off listed
    near-tie points (a saved replicate within 1e-4 of its threshold, as
    in tests/test_torch_permute.py).

This file imports nothing of tests/: on the card machine such imports do
not collect.
"""

import copy
import os
import signal

import numpy as np
import pytest
import torch

import jax

import fscl_tpu.engine.checkpoint as JC
import fscl_tpu.engine.permute as JP
import fscl_tpu.ops.histclr as JH
import fscl_tpu_torch.engine.checkpoint as TC
import fscl_tpu_torch.engine.permute as TP
import fscl_tpu_torch.engine.scan as TS
from fscl_tpu.data import build_snp_data
from fscl_tpu.models import background_fsp, build_tables
from fscl_tpu.ops.permute import block_permutation_groups as jax_sigma
from fscl_tpu.sim import simulate_dataset
from fscl_tpu_torch.ops.permute import (
    block_permutation_groups,
    block_permutation_runs,
)

SCAN = dict(eval_range=100, small_grid_sp=10000, large_grid_sp=100000,
            exact_step_max=1.0, selection_bf16=False)
# 40 points at chunk_replicates=1: the boost tiers take chunks of 16
# while more than 32 points are active, so 16 and 32 are boundaries of
# the uninterrupted run; a statistic of 2 positions x 16 alphas an
# interval, over windows of +-100 sites, keeps the file short
PC = dict(n_permute=48, chunk_replicates=1, seed=5, hist_positions=2,
          hist_alphas=16)
BREAK = 16


def _data(n_chr, mb, seed0, depth=24, mixed=False):
    """Simulated chromosomes; with ``mixed``, missing calls leave each
    site 12..depth samples (more than ROWS_MAX table rows: compressed
    tables)."""
    rng = np.random.default_rng(seed0)
    chrs, pos, fr, dp = [], [], [], []
    for c in range(n_chr):
        sim = simulate_dataset(seed=seed0 + c, sample_size=depth,
                               mb_length=mb, alpha=3e-5)
        f, d = sim["freq"], np.full(len(sim["pos"]), depth)
        if mixed:
            d = rng.integers(12, depth + 1, len(f))
            f = rng.hypergeometric(f, depth - f, d)
        keep = (f >= 1) & (f <= d - 1)
        chrs += [str(c + 1)] * int(keep.sum())
        pos.append(sim["pos"][keep])
        fr.append(f[keep])
        dp.append(d[keep])
    pos, fr, dp = (np.concatenate(x) for x in (pos, fr, dp))
    data = build_snp_data(chrs, pos, fr, dp, np.zeros(len(pos), bool))
    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths)
    tables = build_tables(fsp, data.sample_depths, grid_points=256)
    data.attach_model(tables)
    return data, tables


def _scanned(data, tables, **kw):
    cfg = TS.ScanConfig(**dict(SCAN, **kw))
    return data, tables, TS.scan_genome(data, tables, cfg, device="cpu"), cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this file runs: the suite runs files in
    several processes at once, where torch's default of a thread a core
    oversubscribes the CPU and small ops wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def onehot():
    return _scanned(*_data(2, 2.0, 40))


@pytest.fixture(scope="module")
def compressed():
    data, tables = _data(2, 2.0, 90, depth=40, mixed=True)
    assert len(np.unique(data.row)) > JH.ROWS_MAX
    return _scanned(data, tables)


@pytest.fixture(scope="module")
def lattice():
    return _scanned(*_data(1, 2.0, 70), use_hist=False)


def _fresh(result, empty=None):
    r = copy.deepcopy(result)
    r.permute_n[:] = 0
    r.permute_p[:] = 0
    r.permute_finished[:] = False
    r.null_clr = [copy.copy(empty) for _ in range(r.n_points)]
    r.stat_threshold = None
    return r


def _run(scanned, n, ck=None, starts=None, stop_at=None, dump_fn=None,
         on_start=None, **pc):
    """The port's scan_permute on the CPU with its default streams,
    recording each chunk's start; ``stop_at``: raise KeyboardInterrupt
    where a chunk starts there; ``on_start(start)`` runs as a chunk
    starts.  (result, last_stats)."""
    data, tables, result, scan_cfg = scanned
    cfg = TP.PermuteConfig(**dict(PC, n_permute=n, checkpoint_path=ck,
                                  use_hist=scan_cfg.use_hist, **pc))
    gp, width = data.genome_pos(), cfg.scan_width_mb * 1e6
    starts = [] if starts is None else starts

    def mark(start):
        starts.append(start)
        if start == stop_at:
            raise KeyboardInterrupt("killed mid-chunk")
        if on_start is not None:
            on_start(start)

    def sigma_source(n, start):
        mark(start)
        return block_permutation_groups(cfg.seed, gp, width, n, start=start,
                                        device="cpu")

    def runs_source(n, start):
        mark(start)
        return block_permutation_runs(cfg.seed, gp, width, n, start=start,
                                      device="cpu")

    r = _fresh(result)
    TP.scan_permute(data, tables, r, scan_cfg, cfg, dump_fn=dump_fn,
                    device="cpu", sigma_source=sigma_source,
                    runs_source=runs_source)
    return r, dict(TP.last_stats)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.permute_n, want.permute_n)
    np.testing.assert_array_equal(got.permute_p, want.permute_p)
    np.testing.assert_array_equal(got.permute_finished, want.permute_finished)
    np.testing.assert_array_equal(got.stat_threshold, want.stat_threshold)
    for i, (a, b) in enumerate(zip(got.null_clr, want.null_clr)):
        assert a == b, f"point {i}: null_clr differs"


def _interrupted(scanned, ck, n=PC["n_permute"], brk=BREAK, **pc):
    """(uninterrupted run, its chunk starts, the run stopped at ``brk`` with
    a checkpoint, the run resumed from it to ``n``, the three legs'
    last_stats)."""
    s_full = []
    full, st_full = _run(scanned, n, starts=s_full, **pc)
    part, st_part = _run(scanned, brk, ck, **pc)
    resumed, st_res = _run(scanned, n, ck, **pc)
    return full, s_full, part, resumed, (st_full, st_part, st_res)


@pytest.fixture(scope="module")
def stacked_runs(onehot, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ck") / "stacked.npz")
    return ck, _interrupted(onehot, ck)


# ---- (1) the file format ---------------------------------------------------

def _save_sequence(ck_cls, path, result, empty):
    """Two saves of a small state change through ``ck_cls``."""
    r = _fresh(result, empty)
    c = ck_cls(path, r, seed=5)
    r.permute_n[:] = 8
    r.permute_p[0] = 3
    r.stat_threshold = np.arange(r.n_points, dtype=np.float64)
    r.null_clr[0] = [1.0, 2.0]
    c.save(r, 8)
    r.permute_n[:] = 16
    r.permute_finished[1] = True
    r.null_clr[0].extend([3.5])
    r.null_clr[1] = [0.25]
    c.save(r, 16)
    c.close()
    return r


def _state(r):
    return (r.permute_n.tolist(), r.permute_p.tolist(),
            r.permute_finished.tolist(), np.asarray(r.stat_threshold).tolist(),
            [list(x or []) for x in r.null_clr])


@pytest.mark.parametrize("empty", [None, []])
def test_both_checkpointers_replay_one_save_sequence(onehot, tmp_path,
                                                     empty):
    """Each package replays its own file, and fscl_tpu the port's, to the
    same state; the port replays records fscl_tpu appended to its log.
    Reservoirs start as None (the reference's results) or [] (the port's
    drivers): the replay creates or extends them."""
    result = onehot[2]
    saved = _state(_save_sequence(TC.Checkpointer, str(tmp_path / "t.npz"),
                                  result, empty))
    _save_sequence(JC.Checkpointer, str(tmp_path / "j.npz"), result, empty)
    for ck_cls, path in ((TC.Checkpointer, "t.npz"),
                         (JC.Checkpointer, "j.npz"),
                         (JC.Checkpointer, "t.npz")):  # fscl_tpu accepts
        r = _fresh(result, empty)
        c = ck_cls(str(tmp_path / path), r, seed=5)
        assert c.rounds_done == 16
        assert _state(r) == saved
        c.close()
    # fscl_tpu appends a record to the port's log; the port replays it
    r = _fresh(result, empty)
    c = JC.Checkpointer(str(tmp_path / "t.npz"), r, seed=5)
    r.permute_n[:] = 24
    r.null_clr[2] = [7.0]
    c.save(r, 24)
    c.close()
    r2 = _fresh(result, empty)
    c = TC.Checkpointer(str(tmp_path / "t.npz"), r2, seed=5)
    assert c.rounds_done == 24 and r2.null_clr[2] == [7.0]
    assert _state(r2) == _state(r)
    c.close()


def test_port_refuses_fscl_tpu_files(onehot, tmp_path):
    result = onehot[2]
    _save_sequence(JC.Checkpointer, str(tmp_path / "j.npz"), result, None)
    JC.save_checkpoint(str(tmp_path / "full.npz"), _fresh(result), 4, 5)
    with pytest.raises(ValueError, match="another package.*stream"):
        TC.Checkpointer(str(tmp_path / "j.npz"), _fresh(result), seed=5)
    with pytest.raises(ValueError, match="another package.*stream"):
        TC.load_checkpoint(str(tmp_path / "full.npz"), _fresh(result))
    with pytest.raises(ValueError, match="another package.*stream"):
        TC.Checkpointer(str(tmp_path / "full.npz"), _fresh(result), seed=5)


def test_torn_tail_falls_back_to_last_whole_record(onehot, tmp_path):
    result = onehot[2]
    ck = str(tmp_path / "t.npz")
    _save_sequence(TC.Checkpointer, ck, result, [])
    size = os.path.getsize(ck + ".log")
    with open(ck + ".log", "r+b") as fh:
        fh.truncate(size - 4)
    r = _fresh(result, [])
    c = TC.Checkpointer(ck, r, seed=5)
    assert c.rounds_done == 8
    assert r.null_clr[0] == [1.0, 2.0] and r.null_clr[1] == []
    assert (r.permute_n == 8).all() and not r.permute_finished.any()
    c.close()


def test_full_snapshot_resumes(onehot, tmp_path):
    """The port's full snapshot: load_checkpoint restores it, the
    Checkpointer continues on it, and fscl_tpu reads it too."""
    result = onehot[2]
    ck = str(tmp_path / "full.npz")
    r1 = _fresh(result)
    r1.permute_n[:] = 12
    r1.null_clr[2] = [4.0]
    r1.stat_threshold = np.full(r1.n_points, 0.5)
    TC.save_checkpoint(ck, r1, rounds_done=12, seed=5)
    for load in (TC.load_checkpoint, JC.load_checkpoint):
        r = _fresh(result)
        assert load(ck, r) == (12, 5)
        assert _state(r) == _state(r1)
    r = _fresh(result)
    c = TC.Checkpointer(ck, r, seed=5)
    assert c.rounds_done == 12 and r.null_clr[2] == [4.0]
    assert (r.permute_n == 12).all()
    r.permute_n[:] = 20
    r.null_clr[2].append(5.0)
    c.save(r, 20)
    c.close()
    r2 = _fresh(result)
    c = TC.Checkpointer(ck, r2, seed=5)
    assert c.rounds_done == 20 and r2.null_clr[2] == [4.0, 5.0]
    c.close()


@pytest.mark.parametrize("fmt", ["log", "snapshot"])
def test_mismatched_scan_is_refused(onehot, tmp_path, fmt):
    result = onehot[2]
    ck = str(tmp_path / "x.npz")
    if fmt == "log":
        TC.Checkpointer(ck, _fresh(result), seed=5).close()
    else:
        TC.save_checkpoint(ck, _fresh(result), rounds_done=4, seed=5)
    other = _fresh(result)
    other.clr = other.clr + 5.0
    with pytest.raises(ValueError, match="does not match this scan"):
        TC.Checkpointer(ck, other, seed=5)


# ---- (2), (3) resume bit for bit -------------------------------------------

def _check_break(s_full, part, brk=BREAK):
    assert brk in s_full, f"{brk} is not a chunk boundary of {s_full}"
    assert part.permute_p.max() < TP.PRUNE_THRESHOLD  # no draw yet


def test_hist_resume_bitwise_stacked(stacked_runs):
    _, (full, s_full, part, resumed, stats) = stacked_runs
    _check_break(s_full, part)
    assert full.permute_finished.any()  # pruning engaged after the break
    _assert_same(resumed, full)
    assert stats[0]["stack_dispatches"] == \
        stats[1]["stack_dispatches"] + stats[2]["stack_dispatches"]


@pytest.mark.parametrize("case", ["rdp", "compressed"])
def test_hist_resume_bitwise(case, onehot, compressed, tmp_path,
                             monkeypatch):
    """RDP forced on (every chunk, before and after the break, through the
    run-decomposed statistic: the resumed leg engages it at its first
    chunk, as the uninterrupted run does at that round), and compressed
    mixed depth (stacked)."""
    scanned = onehot
    if case == "rdp":
        monkeypatch.setattr(TP, "RDP_FORCE", "on")
    else:
        scanned = compressed
        assert scanned[2].n_points > TP.HIST_POINT_BUCKET // 8
    full, s_full, part, resumed, stats = _interrupted(
        scanned, str(tmp_path / "c.npz"), n=32)
    _check_break(s_full, part)
    _assert_same(resumed, full)
    key = "rdp_dispatches" if case == "rdp" else "stack_dispatches"
    other = "stack_dispatches" if case == "rdp" else "rdp_dispatches"
    assert stats[2][key] > 0
    assert stats[0][key] == stats[1][key] + stats[2][key]
    assert all(s[other] == 0 for s in stats)


def test_lattice_resume_bitwise(lattice, tmp_path):
    full, s_full, part, resumed, stats = _interrupted(
        lattice, str(tmp_path / "l.npz"), n=24, brk=8, chunk_replicates=8)
    _check_break(s_full, part, brk=8)
    _assert_same(resumed, full)
    assert stats[2]["lattice_dispatches"] > 0
    assert all(s["stack_dispatches"] == s["rdp_dispatches"] == 0
               for s in stats)


# ---- (4) a break after pruning draws ---------------------------------------

def test_resume_after_pruning_draws(onehot, stacked_runs, tmp_path):
    full = stacked_runs[1][0]
    ck = str(tmp_path / "late.npz")
    part, _ = _run(onehot, 32, ck)
    assert part.permute_p.max() >= TP.PRUNE_THRESHOLD  # draws were taken
    assert part.permute_finished.any()
    resumed, _ = _run(onehot, PC["n_permute"], ck)
    never = ~(full.permute_finished | resumed.permute_finished)
    assert never.any()
    for i in np.where(never)[0]:
        np.testing.assert_allclose(sorted(full.null_clr[i]),
                                   sorted(resumed.null_clr[i]), rtol=1e-5)
        assert resumed.permute_n[i] == PC["n_permute"]
    assert np.isfinite(resumed.stat_threshold).all()
    np.testing.assert_allclose(resumed.stat_threshold, full.stat_threshold,
                               rtol=1e-5)
    # finished points keep what the checkpoint held
    done = np.where(part.permute_finished)[0]
    np.testing.assert_array_equal(resumed.permute_n[done],
                                  part.permute_n[done])


# ---- (5) across packages ---------------------------------------------------

def test_interrupted_runs_match_fscl_tpu(onehot, tmp_path, monkeypatch):
    data, tables, result, scan_cfg = onehot
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    pc = dict(PC, n_permute=32, hist_bf16=False, scan_width_mb=0.1)
    key, gp = jax.random.key(pc["seed"]), data.genome_pos()

    def sigma_source(n, start):
        return np.asarray(jax_sigma(key, gp, 1e5, n, start=start))

    import fscl_tpu.engine.scan as JS

    j_scan = JS.ScanConfig(**SCAN)
    r_jax = r_port = None
    for n in (BREAK, pc["n_permute"]):
        r_jax = _fresh(result)
        JP.scan_permute(data, tables, r_jax, j_scan, JP.PermuteConfig(
            **dict(pc, n_permute=n,
                   checkpoint_path=str(tmp_path / "j.npz"))))
        r_port = _fresh(result)
        TP.scan_permute(data, tables, r_port, scan_cfg, TP.PermuteConfig(
            **dict(pc, n_permute=n,
                   checkpoint_path=str(tmp_path / "t.npz"))),
            device="cpu", sigma_source=sigma_source)
        if n == BREAK:
            assert max(r_jax.permute_p.max(), r_port.permute_p.max()) \
                < TP.PRUNE_THRESHOLD
    np.testing.assert_allclose(r_port.stat_threshold, r_jax.stat_threshold,
                               rtol=0, atol=1e-3)
    near = sorted({
        i for i in range(result.n_points) for r in (r_jax, r_port)
        if np.any(np.abs(np.asarray(r.null_clr[i]) - r.stat_threshold[i])
                  < 1e-4)
    })
    keep = np.setdiff1d(np.arange(result.n_points), near)
    print("near-tie points excluded:", near)
    assert len(keep) >= 0.7 * result.n_points
    assert r_jax.permute_finished[keep].any()  # pruning engaged
    for f in ("permute_p", "permute_n", "permute_finished"):
        np.testing.assert_array_equal(getattr(r_port, f)[keep],
                                      getattr(r_jax, f)[keep])


# ---- (6) - (8) kills, SIGINT, a finished run -------------------------------

def test_run_killed_mid_chunk_resumes(onehot, tmp_path, monkeypatch):
    """The sigma draw of the chunk starting at 32 (chunks of 32) raises
    KeyboardInterrupt: the file holds the 32 rounds before it, and the
    resume equals the uninterrupted run.  The break lies past the rounds
    where points reach PRUNE_THRESHOLD exceedances, and a resume re-seeds
    the pruning RNG (test_resume_after_pruning_draws holds that case to
    fscl_tpu's contract), so both runs here take no pruning draw: the
    threshold is set past the run's 64 rounds."""
    n, pc = 64, dict(chunk_replicates=2)
    monkeypatch.setattr(TP, "PRUNE_THRESHOLD", n + 1)
    s_full = []
    full, _ = _run(onehot, n, starts=s_full, **pc)
    assert 32 in s_full
    ck = str(tmp_path / "k.npz")
    with pytest.raises(KeyboardInterrupt):
        _run(onehot, n, ck, stop_at=32, **pc)
    r = _fresh(onehot[2])
    c = TC.Checkpointer(ck, r, seed=PC["seed"])
    assert c.rounds_done == 32 and (r.permute_n == 32).all()
    c.close()
    resumed, _ = _run(onehot, n, ck, **pc)
    _assert_same(resumed, full)


def test_one_sigint_dumps_once_and_continues(onehot, stacked_runs,
                                             monkeypatch):
    """A SIGINT as the chunk at 16 starts: dump_fn runs once, at that
    chunk's end, and the run goes on to the uninterrupted result.  The
    signal is raised only where the driver's handler is installed (the
    main thread); elsewhere the handler is called directly."""
    states = []

    class Spy(TP._InterruptState):
        def __enter__(self):
            states.append(self)
            return super().__enter__()

    monkeypatch.setattr(TP, "_InterruptState", Spy)
    dumps = []

    def interrupt(start):
        if start != BREAK:
            return
        st = states[-1]
        if signal.getsignal(signal.SIGINT) == st.handler:
            signal.raise_signal(signal.SIGINT)
        else:
            st.handler(signal.SIGINT, None)

    got, _ = _run(onehot, PC["n_permute"], on_start=interrupt,
                  dump_fn=lambda: dumps.append(1))
    assert len(dumps) == 1 and not states[-1].requested
    _assert_same(got, stacked_runs[1][0])


@pytest.mark.parametrize("n", [BREAK, PC["n_permute"]])
def test_resume_of_a_finished_run(onehot, stacked_runs, n):
    """n_permute at or below the checkpoint's rounds: no chunk runs, and
    the state is the checkpoint's."""
    ck, (_, _, _, resumed, _) = stacked_runs
    got, stats = _run(onehot, n, ck)
    assert stats["stack_dispatches"] == stats["rdp_dispatches"] == 0
    _assert_same(got, resumed)
