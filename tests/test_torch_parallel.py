"""The split over ranks (fscl_tpu_torch/parallel/) on the CPU: gloo, 2 and
3 ranks started with torch.multiprocessing (spawn, a file:// rendezvous
under tmp_path, so that no TCP port is shared between test processes),
against the single-process port and against fscl_tpu's meshed runs on
conftest's 8 virtual devices.

Every rank and the single-process reference run at one torch thread: on
the CPU the plain statistic's float32 bits depend on the thread count
(torch.distributed.run gives each rank one), not on the split.

Stated tolerances:
  * split against the single-process port, every rank: the scan (hist,
    --no-hist, and at grid 1024 with a hist and with the exact lattice
    tie stage) sweep_pos, clr and lalpha equal; the permutations
    (hist stacked and compressed, the lattice path, chunks of fewer
    replicates than ranks) permute_n, permute_p, permute_finished,
    stat_threshold and every saved null equal bit for bit;
  * every rank ends with identical results;
  * a break under 2 ranks (16 of 48 rounds, a chunk boundary before any
    pruning draw, as tests/test_torch_checkpoint.py) resumed under 2 and
    under 1 rank: equal to the unbroken single-process run bit for bit;
  * against fscl_tpu's meshed scan_genome: CLR within 1e-5 |CLR| + 1e-3,
    sweep_pos and lalpha equal in at least 80% of the intervals
    (tests/test_sharded_paths.py's bar for fscl_tpu's own mesh against
    one device), the others listed;
  * against fscl_tpu's meshed scan_permute, the port fed the JAX sigma
    (tests/test_permute_hist.py:85's bar: counts equal, nulls within
    rtol 1e-5, atol 1e-4), hist_bf16=False: stat_threshold within 1e-3
    (one-hot, lattice) or 5e-3 (compressed); permute_n, permute_p and
    permute_finished equal and the saved nulls within rtol 1e-5 and atol
    1e-4 (compressed: atol 5e-3, tests/test_torch_mixed_depth.py's
    bound on the statistic) off listed near-tie points (a saved null
    within 1e-4 of its threshold, 1e-3 compressed: there the two float32
    statistics, summed in different orders, can fall on either side of
    >=), at least 70% of the points kept;
  * psum_counts over the ranks' exceedance counts, each rank the port's
    lattice statistic on its share of the replicates, against the
    exceedance psum of fscl_tpu's sharded_permute_chunk on
    __graft_entry__._example_problem: equal off candidates where some
    replicate's JAX statistic lies within 2e-3 of the threshold;
  * --device cuda with LOCAL_RANK past the device count raises;
  * the CLI under torch.distributed.run with --device cpu (2 ranks, -f
    and -m) writes one TSV and one nulldist file, byte for byte those of
    the plain CLI; each rank's [split] line holds its gathers' wall under
    phases["gather"], equal to its split_gather_s.

This file imports nothing of tests/ (the card machine does not collect
such imports), and jax only inside the tests: the spawned ranks import
this module, and only the port.
"""

import copy
import os
import pathlib
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from fscl_tpu_torch.data import build_snp_data
from fscl_tpu_torch.models import background_fsp, build_tables
from fscl_tpu_torch.sim import simulate_dataset

REPO = pathlib.Path(__file__).resolve().parents[1]
SCAN = dict(eval_range=100, small_grid_sp=10000, large_grid_sp=100000,
            exact_step_max=1.0, selection_bf16=False)
# the permutation runs: hist_bf16=False to hold them to fscl_tpu
PC = dict(n_permute=48, seed=5, chunk_replicates=16, hist_bf16=False,
          scan_width_mb=0.1)
# the resume: tests/test_torch_checkpoint.py's run (chunks of 16 while
# more than 32 of the 40 points are active), broken at 16
RESUME = dict(n_permute=48, chunk_replicates=1, seed=5, hist_positions=2,
              hist_alphas=16)
BREAK = 16
WORLDS = (2, 3)
DATASETS = ("onehot", "compressed", "lattice")


def _sites(kind):
    """(chr, pos, freq, depth, folded) of a dataset: ``onehot`` two 2 Mb
    chromosomes at depth 24; ``compressed`` one at depth 40 with missing
    calls (more than ROWS_MAX table rows); ``lattice`` one at depth 24."""
    n_chr, seed0, depth = {"onehot": (2, 40, 24), "compressed": (1, 90, 40),
                           "lattice": (1, 70, 24)}[kind]
    rng = np.random.default_rng(seed0)
    cols = [[], [], [], []]
    for c in range(n_chr):
        sim = simulate_dataset(seed=seed0 + c, sample_size=depth,
                               mb_length=2.0, alpha=3e-5)
        f, d = sim["freq"], np.full(len(sim["pos"]), depth)
        if kind == "compressed":
            d = rng.integers(12, depth + 1, len(f))
            f = rng.hypergeometric(f, depth - f, d)
        keep = (f >= 1) & (f <= d - 1)
        for col, x in zip(cols, ([str(c + 1)] * int(keep.sum()),
                                 sim["pos"][keep], f[keep], d[keep])):
            col.append(np.asarray(x))
    chrs, pos, f, d = (np.concatenate(x) for x in cols)
    return list(chrs), pos, f, d, np.zeros(len(pos), bool)


def _model(kind, pkg_data=build_snp_data, pkg_fsp=background_fsp,
           pkg_tables=build_tables, grid_points=256):
    data = pkg_data(*_sites(kind))
    fsp = pkg_fsp(data.obs_freq, data.depth_p, data.folded,
                  data.sample_depths)
    tables = pkg_tables(fsp, data.sample_depths, grid_points=grid_points)
    data.attach_model(tables)
    return data, tables


def _scan_cfg(kind):
    from fscl_tpu_torch.engine.scan import ScanConfig

    return ScanConfig(**SCAN, use_hist=kind != "lattice")


def _fresh(fields):
    """A port ScanResult with no permutation state, from a dict of the
    scan's fields."""
    from fscl_tpu_torch.engine.scan import ScanResult

    K = len(fields["sweep_pos"])
    return ScanResult(**fields, permute_n=np.zeros(K, np.int64),
                      permute_p=np.zeros(K, np.int64),
                      permute_finished=np.zeros(K, bool),
                      null_clr=[None] * K, stat_threshold=None)


SCAN_FIELDS = ("chr_id", "sweep_pos", "clr", "lalpha", "nearest",
               "window_start", "window_end", "interval_start", "interval_end")
PERM_FIELDS = ("permute_n", "permute_p", "permute_finished",
               "stat_threshold")


def _perm_state(r):
    return {**{f: np.asarray(getattr(r, f)) for f in PERM_FIELDS},
            "null_clr": [list(x or []) for x in r.null_clr]}


# ---- the jobs every rank (and the single-process reference) runs --------

def _permute(kind, fields, sigma, split, **pc):
    from fscl_tpu_torch.engine.permute import PermuteConfig, scan_permute

    data, tables = _model(kind)
    cfg = PermuteConfig(**dict(PC, use_hist=kind != "lattice", **pc))
    r = _fresh(fields)
    scan_permute(data, tables, r, _scan_cfg(kind), cfg, device="cpu",
                 sigma_source=lambda n, s: sigma[s:s + n], split=split)
    return _perm_state(r)


def _resume_legs(split, tmp):
    """(unbroken run, break resumed under this world) of the resume
    case, on the port's own sigma stream; rank 0 copies the broken run's
    files to ``tmp/one`` for a resume under one rank."""
    from fscl_tpu_torch.engine.permute import PermuteConfig, scan_permute
    from fscl_tpu_torch.engine.scan import scan_genome
    from fscl_tpu_torch.parallel import shard

    data, tables = _model("onehot")
    scanned = scan_genome(data, tables, _scan_cfg("onehot"), device="cpu")

    def run(n, ck=None):
        r = copy.deepcopy(scanned)
        scan_permute(data, tables, r, _scan_cfg("onehot"), PermuteConfig(
            **dict(RESUME, n_permute=n, checkpoint_path=ck)), device="cpu",
            split=split)
        return r

    ck = os.path.join(tmp, "ck.npz")
    full = run(RESUME["n_permute"])
    run(BREAK, ck)
    if split is None or split.writer:
        os.makedirs(os.path.join(tmp, "one"), exist_ok=True)
        for f in ("ck.npz", "ck.npz.log"):
            shutil.copy(os.path.join(tmp, f), os.path.join(tmp, "one", f))
    shard.broadcast_flag(True, split)  # the copy is made before a resume
    resumed = run(RESUME["n_permute"], ck)
    return _perm_state(full), _perm_state(resumed)


def _psum(split, payload):
    """The port's exceedance counts over this rank's share of the
    replicates, summed over the ranks with psum_counts."""
    from fscl_tpu_torch.ops.lattice import (LatticeTables,
                                            two_stage_lattice_max)
    from fscl_tpu_torch.parallel import psum_counts, split_range

    p = payload
    lt = LatticeTables.from_table(p["table"], p["grid_points"],
                                  device="cpu")
    sig = p["sigma"]
    r0, r1 = split_range(len(sig), split)
    t = {k: torch.as_tensor(p[k]) for k in ("pos", "cand", "lo", "hi")}
    row = torch.as_tensor(p["row"][sig[r0:r1]])
    null = torch.as_tensor(p["null"][sig[r0:r1]])
    clr, _ = two_stage_lattice_max(lt, row, t["pos"], null, t["cand"],
                                   t["lo"], t["hi"], ultra=False)
    counts = (clr.numpy() >= p["thr"][None]).sum(0)
    return psum_counts(counts, split)


def _jobs(split, tmp, payload):
    """Every case's result under ``split`` (None: the single process)."""
    from fscl_tpu_torch.engine.scan import scan_genome

    from fscl_tpu_torch.engine.scan import ScanConfig

    out = {}
    for kind in ("onehot", "lattice"):
        data, tables = _model(kind)
        r = scan_genome(data, tables, _scan_cfg(kind), device="cpu",
                        split=split)
        out[f"scan-{kind}"] = {f: getattr(r, f) for f in SCAN_FIELDS}
    # grid 1024: a hist tie stage (exact_step_max 1.0), and the exact
    # lattice tie stage (the default 0.035 under the tie step, 0.047)
    data, tables = _model("onehot", grid_points=1024)
    for name, cfg in (("tie", ScanConfig(**SCAN)),
                      ("exact", ScanConfig(**dict(SCAN,
                                                  exact_step_max=0.035)))):
        r = scan_genome(data, tables, cfg, device="cpu", split=split)
        out[f"scan-{name}"] = {f: getattr(r, f) for f in SCAN_FIELDS}
    for kind in DATASETS:
        out[f"permute-{kind}"] = _permute(kind, payload[kind]["scan"],
                                          payload[kind]["sigma"], split)
    # chunks of fewer replicates than ranks: a last chunk of 1 (hist: 16
    # then 1; lattice: 2, 2, 1)
    out["short-onehot"] = _permute("onehot", payload["onehot"]["scan"],
                                   payload["onehot"]["sigma"], split,
                                   n_permute=17, chunk_replicates=1)
    out["short-lattice"] = _permute("lattice", payload["lattice"]["scan"],
                                    payload["lattice"]["sigma"], split,
                                    n_permute=5, chunk_replicates=2)
    out["resume"] = _resume_legs(split, tmp)
    out["psum"] = _psum(split, payload["psum"])
    return out


def _rank_main(rank, world, tmp, payload):
    """One spawned rank: every job at one torch thread, pickled to
    tmp/rank{rank}.pkl (a world of one: the single-process reference).
    The group starts here, at a file:// rendezvous with a bounded wait;
    init_split joins it."""
    import datetime

    import torch.distributed as dist

    from fscl_tpu_torch.parallel import close_split, init_split

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    if world > 1:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=300))
    split = init_split("cpu")
    try:
        out = _jobs(split, tmp, payload)
    finally:
        close_split(split)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---- the fixtures ----------------------------------------------------------

def _jax_model(kind):
    from fscl_tpu.data import build_snp_data as jd
    from fscl_tpu.models import background_fsp as jf
    from fscl_tpu.models import build_tables as jt

    return _model(kind, jd, jf, jt)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run the tests compare, overlapped: fscl_tpu's meshed scans,
    JAX sigma and psum chunk first (the ranks' inputs); then a world of
    one (the single-process reference) and the worlds of WORLDS started
    together, and while they run, fscl_tpu's meshed permutations.
    {"jax": ..., "single": jobs, world: [each rank's jobs], "dirs":
    {world: its directory}}."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as g
    import fscl_tpu.engine.permute as JP
    import fscl_tpu.engine.scan as JS
    from fscl_tpu.ops.lattice import LatticeTables
    from fscl_tpu.ops.permute import block_permutation_groups as jax_sigma
    from fscl_tpu.ops.permute import block_permutation_indices
    from fscl_tpu.parallel import make_scan_mesh, sharded_permute_chunk

    assert jax.device_count() == 8
    payload, jx, scanned = {}, {}, {}
    for kind in DATASETS:
        data, tables = _jax_model(kind)
        cfg = JS.ScanConfig(**SCAN, use_hist=kind != "lattice")
        res = JS.scan_genome(data, tables, cfg)
        scanned[kind] = (data, tables, cfg, res)
        payload[kind] = dict(
            scan={f: np.asarray(getattr(res, f)) for f in SCAN_FIELDS},
            sigma=np.asarray(jax_sigma(jax.random.key(PC["seed"]),
                                       data.genome_pos(),
                                       PC["scan_width_mb"] * 1e6,
                                       PC["n_permute"])))
    tables, pos, row, null, cand, lo, hi = g._example_problem(
        n_sites=512, n_cand=32, grid_points=256)
    sig = np.asarray(block_permutation_indices(
        jax.random.key(0), jnp.asarray(pos.astype(np.int64)), 200_000, 8))
    thr = np.full(len(cand), 1.0, np.float32)
    clr, exceed = sharded_permute_chunk(
        make_scan_mesh(), LatticeTables(tables.table, tables.grid_points),
        jnp.asarray(row), jnp.asarray(null), jnp.asarray(sig),
        jnp.asarray(pos), jnp.asarray(cand), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(thr), chunk=8, start=0, n=512,
        w_pad=512)
    payload["psum"] = dict(table=np.asarray(tables.table),
                           grid_points=tables.grid_points, pos=pos, row=row,
                           null=null, cand=cand, lo=lo, hi=hi,
                           sigma=sig.astype(np.int64), thr=thr)
    jx["psum"] = (np.asarray(clr), np.asarray(exceed))

    dirs, ctxs = {}, {}
    for w in (1, *WORLDS):
        dirs[w] = str(tmp_path_factory.mktemp(f"world{w}"))
        ctxs[w] = mp.start_processes(_rank_main, args=(w, dirs[w], payload),
                                     nprocs=w, join=False,
                                     start_method="spawn")
    for kind, (data, tables, cfg, res) in scanned.items():
        r = copy.deepcopy(res)
        r.null_clr = [None] * r.n_points
        JP.scan_permute(data, tables, r, cfg, JP.PermuteConfig(
            **PC, use_hist=kind != "lattice"))
        jx[kind] = dict(scan=payload[kind]["scan"], permute=_perm_state(r))
    out = {}
    for w in (1, *WORLDS):
        while not ctxs[w].join():
            pass
        out[w] = []
        for r in range(w):
            with open(os.path.join(dirs[w], f"rank{r}.pkl"), "rb") as f:
                out[w].append(pickle.load(f))
    out["single"] = out.pop(1)[0]
    out.update(jax=jx, dirs=dirs)
    return out


def _same_perm(got, want, what):
    for f in PERM_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what}: {f}")
    for i, (a, b) in enumerate(zip(got["null_clr"], want["null_clr"])):
        assert a == b, f"{what}: point {i} null_clr differs"


# ---- the split against the single-process port -------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["onehot", "lattice", "tie", "exact"])
def test_split_scan_equals_single_process(runs, world, kind):
    want = runs["single"][f"scan-{kind}"]
    for r, got in enumerate(runs[world]):
        for f in SCAN_FIELDS:
            np.testing.assert_array_equal(
                got[f"scan-{kind}"][f], want[f],
                err_msg=f"{kind} scan, rank {r} of {world}: {f}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [*(f"permute-{k}" for k in DATASETS),
                                  "short-onehot", "short-lattice"])
def test_split_permutations_equal_single_process(runs, world, case):
    for r, got in enumerate(runs[world]):
        _same_perm(got[case], runs["single"][case],
                   f"{case}, rank {r} of {world}")


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_holds_the_same_result(runs, world):
    first = runs[world][0]
    for r, got in enumerate(runs[world][1:], 1):
        assert set(got) == set(first)
        for case, v in got.items():
            if case.startswith("scan-"):
                for f in SCAN_FIELDS:
                    np.testing.assert_array_equal(v[f], first[case][f])
            elif case == "resume":
                for a, b in zip(v, first[case]):
                    _same_perm(a, b, f"resume, rank {r}")
            elif case == "psum":
                np.testing.assert_array_equal(v, first[case])
            else:
                _same_perm(v, first[case], f"{case}, rank {r}")


@pytest.mark.parametrize("resume_world", [2, 1])
def test_break_under_two_ranks_resumes_under_two_and_one(runs, resume_world):
    from fscl_tpu_torch.engine.permute import PermuteConfig, scan_permute
    from fscl_tpu_torch.engine.scan import scan_genome

    unbroken = runs["single"]["resume"][0]
    _same_perm(runs[2][0]["resume"][0], unbroken, "unbroken under 2")
    if resume_world == 2:
        got = runs[2][0]["resume"][1]
    else:
        data, tables = _model("onehot")
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            r = scan_genome(data, tables, _scan_cfg("onehot"), device="cpu")
            ck = os.path.join(runs["dirs"][2], "one", "ck.npz")
            scan_permute(data, tables, r, _scan_cfg("onehot"),
                         PermuteConfig(**dict(RESUME, checkpoint_path=ck)),
                         device="cpu")
        finally:
            torch.set_num_threads(n)
        got = _perm_state(r)
    assert not unbroken["permute_finished"].all()
    _same_perm(got, unbroken, f"break under 2, resumed under {resume_world}")


# ---- against fscl_tpu's meshed runs ----------------------------------------

@pytest.mark.parametrize("kind", ["onehot", "lattice"])
def test_split_scan_matches_fscl_tpu_mesh(runs, kind):
    want = runs["jax"][kind]["scan"]
    for world in WORLDS:
        got = runs[world][0][f"scan-{kind}"]
        np.testing.assert_array_equal(got["interval_start"],
                                      want["interval_start"])
        tol = 1e-5 * np.abs(want["clr"]) + 1e-3
        assert (np.abs(got["clr"] - want["clr"]) <= tol).all()
        differ = ((got["sweep_pos"] != want["sweep_pos"])
                  | (got["lalpha"] != want["lalpha"]))
        print(f"{kind}, {world} ranks: intervals off fscl_tpu's mesh:",
              list(np.nonzero(differ)[0]))
        assert differ.mean() <= 0.2


@pytest.mark.parametrize("kind", DATASETS)
def test_split_permutations_match_fscl_tpu_mesh(runs, kind):
    want = runs["jax"][kind]["permute"]
    thr_tol, band, null_atol = ((5e-3, 1e-3, 5e-3) if kind == "compressed"
                                else (1e-3, 1e-4, 1e-4))
    for world in WORLDS:
        got = runs[world][0][f"permute-{kind}"]
        np.testing.assert_allclose(got["stat_threshold"],
                                   want["stat_threshold"], rtol=0,
                                   atol=thr_tol)
        K = len(want["permute_n"])
        near = sorted({
            i for i in range(K) for r in (got, want)
            if np.any((np.abs(np.asarray(r["null_clr"][i])
                              - r["stat_threshold"][i]) < band)
                      & (np.asarray(r["null_clr"][i])
                         != r["stat_threshold"][i]))
        })
        keep = np.setdiff1d(np.arange(K), near)
        print(f"{kind}, {world} ranks: near-tie points excluded:", near)
        assert len(keep) >= 0.7 * K
        for f in ("permute_p", "permute_n", "permute_finished"):
            np.testing.assert_array_equal(got[f][keep], want[f][keep],
                                          err_msg=f"{kind}: {f}")
        for i in keep:
            np.testing.assert_allclose(got["null_clr"][i],
                                       want["null_clr"][i], rtol=1e-5,
                                       atol=null_atol)
    assert want["permute_finished"].any()  # pruning engaged


def test_psum_counts_matches_sharded_permute_chunk(runs):
    clr_jax, exceed = runs["jax"]["psum"]
    thr = np.float32(1.0)
    near = np.abs(clr_jax - thr[None]).min(0) < 2e-3
    print("near-tie candidates:", list(np.nonzero(near)[0]))
    assert near.mean() < 0.3 and exceed[~near].any()
    for world in WORLDS:
        got = runs[world][0]["psum"]
        np.testing.assert_array_equal(got[~near], exceed[~near])


# ---- start-up --------------------------------------------------------------

def test_split_range_shares():
    from fscl_tpu_torch.parallel import Split, split_range

    for n in (0, 1, 2, 5, 16, 17):
        for world in (1, 2, 3):
            shares = [split_range(n, Split(rank=r, world=world))
                      for r in range(world)]
            assert shares[0][0] == 0 and shares[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
            sizes = [b - a for a, b in shares]
            assert max(sizes) - min(sizes) <= 1


def test_cuda_local_rank_past_the_device_count_raises(monkeypatch):
    from fscl_tpu_torch.parallel import init_split

    n = torch.cuda.device_count() + 1
    monkeypatch.setenv("RANK", str(n))
    monkeypatch.setenv("LOCAL_RANK", str(n))
    monkeypatch.setenv("WORLD_SIZE", str(n + 1))
    with pytest.raises(RuntimeError, match=f"local rank {n} to cuda:{n}"):
        init_split("cuda")


def test_no_environment_is_a_world_of_one(monkeypatch):
    from fscl_tpu_torch.parallel import init_split

    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    split = init_split("cpu")
    assert (split.rank, split.world, split.group) == (0, 1, None)
    assert split.device == torch.device("cpu") and split.writer


# ---- the CLI under torch.distributed.run ----------------------------------

@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    chrs, pos, f, depth, _ = _sites("onehot")
    with open(d / "in.sf", "w") as fh:
        for row in zip(chrs, pos, f, depth):
            fh.write("\t".join(map(str, row)) + "\t0\n")
    rng = np.random.default_rng(3)
    with open(d / "in.ms", "w") as fh:
        fh.write("ms 12 2 -t 20\n1 2\n")
        for _ in range(2):
            s = 200
            fh.write(f"\n//\nsegsites: {s}\npositions: "
                     + " ".join(f"{x:.4f}" for x in np.sort(rng.random(s)))
                     + "\n")
            for _ in range(12):
                fh.write("".join(map(str, rng.integers(0, 2, s))) + "\n")
    return d


def _start(cmd, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.Popen([sys.executable, *cmd], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def cli_runs(cli_inputs):
    """{mode: (the plain CLI's stderr, the split CLI's stderr)}: both
    modes' plain and torch.distributed.run CLIs, started together."""
    d = cli_inputs
    procs = {}
    for mode in ("-f", "-m"):
        args = ["-p", "24", "--chunk-replicates", "8", "--grid-points",
                "256", "--device", "cpu", "-v", "4"]
        if mode == "-f":
            args += ["-f", "in.sf", "-g", "10000", "-G", "100000",
                     "--eval-range", "100"]
        else:
            args += ["-m", "in.ms", "--ms-segment-length", "500000",
                     "--ms-folded", "-g", "5000", "-G", "50000"]
        tag = mode.strip("-")
        procs[mode] = (
            _start(["-m", "fscl_tpu_torch", *args, "-o", f"plain_{tag}.tsv"],
                   d),
            _start(["-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", "2", "-m", "fscl_tpu_torch", *args,
                    "-o", f"split_{tag}.tsv"], d))
    out = {}
    for mode, pair in procs.items():
        errs = []
        for p in pair:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            errs.append(err)
        out[mode] = errs
    return out


@pytest.mark.parametrize("mode", ["-f", "-m"])
def test_cli_under_torchrun_matches_plain_cli(cli_inputs, cli_runs, mode):
    d = cli_inputs
    tag = mode.strip("-")
    for suffix in ("", "-nulldist"):
        a = (d / f"plain_{tag}.tsv{suffix}").read_bytes()
        b = (d / f"split_{tag}.tsv{suffix}").read_bytes()
        assert a and a == b, f"{mode}: {suffix or 'TSV'} differs"
    err = cli_runs[mode][1]
    reports = [line for line in err.splitlines()
               if line.startswith("[split] ")]
    assert len(reports) == 2, err[-3000:]  # rank 0 logs both ranks'
    assert all('"world": 2' in r and '"split_gather_bytes": 0' not in r
               for r in reports)
    assert "[rank 1]" not in err  # rank 1 logs warnings only


@pytest.mark.parametrize("mode", ["-f", "-m"])
def test_split_report_gather_phase_is_the_gathers_wall(cli_runs, mode):
    """Each rank's phase table holds its gathers under ``gather``, the
    same seconds as its split_gather_s: one split.gather span times
    both (utils/timing.py, parallel/shard.py)."""
    import json

    err = cli_runs[mode][1]
    reports = [json.loads(line[len("[split] "):])
               for line in err.splitlines() if line.startswith("[split] ")]
    assert len(reports) == 2, err[-3000:]
    for r in reports:
        assert r["split_gathers"] > 0
        assert r["phases"]["gather"] == r["split_gather_s"] > 0
