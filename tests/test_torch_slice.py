"""The port's main path as a whole: scan parity and the CLI.

Stated tolerances:
  * scan_genome with selection_bf16=False on both sides, exact_step_max
    =1.0 so the hist tie stage reports, and grid 1024 (the smallest grid
    whose decimation caps leave separate selection and tie tables; at
    256 both caps are 1 and no tie stage runs): CLR within 1e-3
    absolute, lalpha equal, sweep_pos equal wherever the JAX tie-stage
    winner beats its runner-up by more than 1e-3;
  * the two scans this port once refused, the lattice path
    (use_hist=False) and a hist scan at grid 1024 whose tie step (0.047)
    exceeds exact_step_max (the exact lattice tie stage): CLR within
    1e-5 |CLR| + 1e-3 (inside tests/test_torch_lattice.py's 1e-5 S +
    1e-3, S >= |CLR|), sweep_pos and lalpha equal off listed near-ties
    (intervals whose two CLRs lie within that tolerance);
  * the CLI (subprocess, --device cpu) never imports jax, and its TSV has
    the rows of fscl_tpu's CLI with every CLR within 0.5, the parity band
    of PARITY.md; with --no-hist (the lattice path in both packages) every
    printed CLR (two decimals) within 0.01 and positions equal off
    near-ties.  Permutation p-values differ by design (each package draws
    its own permutations) and are not compared.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import fscl_tpu.engine.scan as JS
from fscl_tpu.data import build_snp_data
from fscl_tpu.models import background_fsp, build_tables
from fscl_tpu.sim import simulate_dataset, write_snp_file
from fscl_tpu_torch import NotPortedError
from fscl_tpu_torch.engine.scan import ScanConfig, scan_genome

REPO = pathlib.Path(__file__).resolve().parents[1]
SCAN = dict(eval_range=1500, small_grid_sp=10000, large_grid_sp=200000,
            exact_step_max=1.0, selection_bf16=False)


@pytest.fixture(scope="module")
def dataset():
    chrs, pos, fr = [], [], []
    for c in range(2):
        sim = simulate_dataset(seed=60 + c, sample_size=30, mb_length=3.0,
                               alpha=3e-5)
        chrs += [f"c{c + 1}"] * len(sim["pos"])
        pos.append(sim["pos"])
        fr.append(sim["freq"])
    pos, fr = np.concatenate(pos), np.concatenate(fr)
    data = build_snp_data(chrs, pos, fr, np.full(len(pos), 30),
                          np.zeros(len(pos), bool))
    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths)
    tables = build_tables(fsp, data.sample_depths, grid_points=1024)
    data.attach_model(tables)
    return data, tables


def test_scan_genome_matches(dataset, monkeypatch):
    data, tables = dataset
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
    got = scan_genome(data, tables, ScanConfig(**SCAN), device="cpu")
    assert got.n_points == want.n_points > 0
    np.testing.assert_array_equal(got.chr_id, want.chr_id)
    np.testing.assert_array_equal(got.interval_start, want.interval_start)
    np.testing.assert_allclose(got.clr, want.clr, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.lalpha, want.lalpha)
    clear = np.array([gaps[(int(c), k)] > 1e-3 for c, k in zip(
        want.chr_id, _interval_index(want.chr_id))])
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.sweep_pos[clear], want.sweep_pos[clear])
    np.testing.assert_array_equal(got.window_start, want.window_start)


def _interval_index(chr_id):
    out = np.zeros(len(chr_id), np.int64)
    for c in np.unique(chr_id):
        m = chr_id == c
        out[m] = np.arange(m.sum())
    return out


def test_scan_refuses_unported_paths(dataset, monkeypatch):
    """The two scans the port refused before the lattice path (the name
    is kept): --no-hist, and grid 1024 (tie step 0.047 > exact_step_max
    0.035, the exact lattice tie stage).  Both now run and match the JAX
    package."""
    data, tables = dataset
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    for kw in (dict(SCAN, use_hist=False), dict(eval_range=1500)):
        want = JS.scan_genome(data, tables, JS.ScanConfig(**kw))
        got = scan_genome(data, tables, ScanConfig(**kw), device="cpu")
        assert got.n_points == want.n_points > 0
        np.testing.assert_array_equal(got.interval_start,
                                      want.interval_start)
        tol = 1e-5 * np.abs(want.clr) + 1e-3
        assert (np.abs(got.clr - want.clr) <= tol).all(), kw
        differ = ((got.sweep_pos != want.sweep_pos)
                  | (got.lalpha != want.lalpha))
        print(kw, "near-tie intervals:", list(np.nonzero(differ)[0]))
        assert differ.mean() <= 0.1, kw


@pytest.fixture(scope="module")
def snp_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    sim = simulate_dataset(seed=8, sample_size=20, mb_length=2.0,
                           alpha=3e-5, n_sweeps=1)
    path = d / "tiny.sf"
    write_snp_file(path, sim["pos"], sim["freq"], sim["n"])
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


def test_cli_runs_without_jax_and_matches(snp_file, tmp_path, monkeypatch):
    out_port = tmp_path / "port.tsv"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_PORT, "-f", str(snp_file),
         "-o", str(out_port), "--device", "cpu", *CLI_ARGS],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "jax-free 0" in proc.stdout

    from fscl_tpu.cli import main as jax_main

    monkeypatch.setattr(jax, "device_count", lambda: 1)
    out_jax = tmp_path / "jax.tsv"
    assert jax_main(["-f", str(snp_file), "-o", str(out_jax),
                     *CLI_ARGS]) == 0
    rows_p, rows_j = _read_tsv(out_port), _read_tsv(out_jax)
    assert len(rows_p) == len(rows_j) > 0
    assert [len(r) for r in rows_p] == [len(r) for r in rows_j]
    assert [r[0] for r in rows_p] == [r[0] for r in rows_j]
    clr_p = np.array([float(r[2]) for r in rows_p])
    clr_j = np.array([float(r[2]) for r in rows_j])
    np.testing.assert_allclose(clr_p, clr_j, rtol=0, atol=0.5)
    n_p = np.array([int(r[5]) for r in rows_p])
    assert (n_p > 0).all() and (n_p <= 24).all()
    assert pathlib.Path(f"{out_port}-nulldist").exists()


def test_cli_device_cuda_without_card_raises(snp_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from fscl_tpu_torch.cli import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-f", str(snp_file), "-o", str(tmp_path / "x.tsv"),
              "--device", "cuda", "-v", "0"])


def test_cli_no_hist_matches_jax(snp_file, tmp_path, monkeypatch):
    """--no-hist: the lattice scan and permutations in both CLIs."""
    from fscl_tpu.cli import main as jax_main
    from fscl_tpu_torch.cli import main

    args = ["-f", str(snp_file), *CLI_ARGS, "--no-hist"]
    assert main([*args, "-o", str(tmp_path / "port.tsv"),
                 "--device", "cpu"]) == 0
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    assert jax_main([*args, "-o", str(tmp_path / "jax.tsv")]) == 0
    rows_p = _read_tsv(tmp_path / "port.tsv")
    rows_j = _read_tsv(tmp_path / "jax.tsv")
    assert len(rows_p) == len(rows_j) > 0
    assert [r[0] for r in rows_p] == [r[0] for r in rows_j]
    clr_p = np.array([float(r[2]) for r in rows_p])
    clr_j = np.array([float(r[2]) for r in rows_j])
    np.testing.assert_allclose(clr_p, clr_j, rtol=0, atol=0.01)
    moved = [i for i, (a, b) in enumerate(zip(rows_p, rows_j))
             if a[1] != b[1]]
    print("near-tie positions:", moved)
    assert len(moved) <= 0.1 * len(rows_p)
    n_p = np.array([int(r[5]) for r in rows_p])
    assert (n_p > 0).all() and (n_p <= 24).all()


@pytest.mark.parametrize("flag", [["--checkpoint", "c.npz"],
                                  ["-b", "bs.txt"], ["--output-bs", "o.bs"]])
def test_cli_unported_flags_raise(snp_file, tmp_path, flag, monkeypatch):
    """--checkpoint, the one flag the port still lacks, raises
    NotPortedError.  -b and --output-bs raised until the spectrum files
    were ported; now they run (tests/test_torch_ms.py holds them to the
    JAX package)."""
    from fscl_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    args = ["-f", str(snp_file), "-o", str(tmp_path / "x.tsv"),
            "--device", "cpu", "-v", "0", *flag]
    if flag[0] == "--checkpoint":
        with pytest.raises(NotPortedError):
            main(args)
        return
    if flag[0] == "-b":
        assert main([*args[:-2], "--output-bs", "bs.txt", "--no-scan"]) == 0
    assert main([*args, "--output-bs", "back.bs", "--no-scan"]) == 0
    assert (tmp_path / "back.bs").stat().st_size > 0
