"""The port stands alone and runs on the card unless asked for the CPU.

  * no module of fscl_tpu_torch, and not chip_smoke.py or a script of
    tools/, imports jax or anything of fscl_tpu: checked in the source
    (every import statement, at any depth) and in sys.modules of a fresh
    interpreter after every module is imported and the CLI has run with
    --device cpu, and after ``import chip_smoke``;
  * the port's copy of the sweep-model code builds tables bitwise equal to
    fscl_tpu.models on a seeded input;
  * every public entry point called without a device, on a machine with no
    CUDA card, raises instead of running on the CPU.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import fscl_tpu.models as JM
import fscl_tpu_torch.models as TM

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "fscl_tpu_torch"


def _foreign(name):
    return name == "jax" or name.startswith("jax.") or name == "fscl_tpu" \
        or name.startswith("fscl_tpu.")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PORT.rglob("*.py"),
                                       REPO / "chip_smoke.py",
                                       *(REPO / "tools").glob("*.py")]))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse((REPO / path).read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _foreign(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _foreign(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def _run(code, *args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


_CHECK = (
    "bad = sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith(('jax.', 'fscl_tpu.')) or m == 'fscl_tpu')\n"
    "assert not bad, bad\n"
    "print('standalone', rc)\n"
)


def test_every_module_and_the_cli_load_no_jax(tmp_path):
    from fscl_tpu_torch.sim import simulate_dataset, write_snp_file

    sim = simulate_dataset(seed=5, sample_size=16, mb_length=1.0,
                           alpha=3e-5, n_sweeps=1)
    snp = tmp_path / "tiny.sf"
    write_snp_file(snp, sim["pos"], sim["freq"], sim["n"])
    code = (
        "import importlib, pkgutil, sys\n"
        "import fscl_tpu_torch\n"
        "for m in pkgutil.walk_packages(fscl_tpu_torch.__path__,\n"
        "                               'fscl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from fscl_tpu_torch.cli import main\n"
        "rc = main(sys.argv[1:])\n" + _CHECK
    )
    proc = _run(code, "-f", str(snp), "-o", str(tmp_path / "o.tsv"),
                "--device", "cpu", "-g", "10000", "-G", "200000", "-p", "8",
                "-v", "0", cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "standalone 0" in proc.stdout
    assert (tmp_path / "o.tsv").stat().st_size > 0


def test_import_chip_smoke_loads_no_jax(tmp_path):
    proc = _run("import sys\nimport chip_smoke\nrc = 0\n" + _CHECK,
                cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "standalone 0" in proc.stdout


@pytest.mark.parametrize("folded, depths", [
    (False, [30]),
    (True, [20, 26, 31]),  # mixed depths, folded sites
])
def test_model_copy_builds_bitwise_equal_tables(folded, depths):
    rng = np.random.default_rng(17)
    n_sites = 3000
    depth = rng.choice(depths, n_sites)
    obs = rng.integers(1, depth)
    fold = rng.random(n_sites) < 0.4 if folded else np.zeros(n_sites, bool)
    obs = np.where(fold, np.minimum(obs, depth - obs), obs)
    sample_depths = np.unique(depth)
    depth_p = np.searchsorted(sample_depths, depth)
    kw = dict(compat_mirror_unfolded=True)
    fsp_j = JM.background_fsp(obs, depth_p, fold, sample_depths, **kw)
    fsp_t = TM.background_fsp(obs, depth_p, fold, sample_depths, **kw)
    for a, b in zip(fsp_j, fsp_t):
        np.testing.assert_array_equal(a, b)
    tj = JM.build_tables(fsp_j, sample_depths, grid_points=256)
    tt = TM.build_tables(fsp_t, sample_depths, grid_points=256)
    assert tj.table.dtype == tt.table.dtype
    np.testing.assert_array_equal(tt.table, tj.table)
    np.testing.assert_array_equal(tt.log_ad, tj.log_ad)
    np.testing.assert_array_equal(tt.site_rows(depth_p, fold, obs),
                                  tj.site_rows(depth_p, fold, obs))
    np.testing.assert_array_equal(tt.null_logl(depth_p, fold, obs),
                                  tj.null_logl(depth_p, fold, obs))


def _entry_points():
    from types import SimpleNamespace

    from fscl_tpu_torch.convert import (
        clr_inputs_from_numpy,
        hist_points_from_numpy,
        hist_tables_from_numpy,
        lattice_tables_from_numpy,
    )
    from fscl_tpu_torch.engine import scan_genome, scan_permute
    from fscl_tpu_torch.engine.scan import (
        get_lattice_tables,
        make_scan_hist_tables,
    )
    from fscl_tpu_torch.io.ms_input import ms_pipeline
    from fscl_tpu_torch.ops.clr import clr_grid, two_stage_alpha_max
    from fscl_tpu_torch.ops.lattice import LatticeTables
    from fscl_tpu_torch.ops.histclr import build_hist_tables, build_pos_prefix
    from fscl_tpu_torch.ops.permute import (
        block_permutation_groups,
        block_permutation_runs,
    )

    g = np.arange(0, 3_000_000, 500)
    z = np.zeros((2, 2, 3))
    site = (np.zeros(32, np.float32), np.zeros(3, np.int32),
            np.arange(3, dtype=np.int32), np.zeros(3, np.float32),
            np.ones(2, np.int32), np.zeros(2, np.int32),
            np.full(2, 2, np.int32))
    return {
        "scan_genome": lambda: scan_genome(None, None, None),
        "scan_permute": lambda: scan_permute(None, None, None, None, None),
        "make_scan_hist_tables": lambda: make_scan_hist_tables(None, None),
        "build_hist_tables": lambda: build_hist_tables(
            np.zeros((3, 16)), 16, np.zeros(3), [0, 1], 10**6),
        "build_pos_prefix": lambda: build_pos_prefix(g),
        "block_permutation_groups": lambda: block_permutation_groups(
            1, g, 1e6, 2),
        "block_permutation_runs": lambda: block_permutation_runs(
            1, g, 1e6, 2),
        "hist_tables_from_numpy": lambda: hist_tables_from_numpy(
            t3=z, row_map=[0], rows_used=[0], lalpha=[0.0], offsets=[0],
            n_cells=1, n_rows=8, n_alpha=1, step=0.1, grid_points=16),
        "hist_points_from_numpy": lambda: hist_points_from_numpy(z, z),
        "get_lattice_tables": lambda: get_lattice_tables(None),
        "LatticeTables.from_table": lambda: LatticeTables.from_table(
            np.zeros((2, 16), np.float32), 16),
        "lattice_tables_from_numpy": lambda: lattice_tables_from_numpy(
            grid_points=16, pack_coarse=z, pack_fine=z, pack_ultra=z,
            m_coarse=[0], m_fine=[0], m_ultra=[0]),
        "clr_grid": lambda: clr_grid(*site, np.zeros(3, np.float32),
                                     grid_points=16),
        "two_stage_alpha_max": lambda: two_stage_alpha_max(
            *site, grid_points=16),
        "clr_inputs_from_numpy": lambda: clr_inputs_from_numpy(*site[:4]),
        "ms_pipeline": lambda: ms_pipeline(
            SimpleNamespace(ms_segment_length=10**6)),
    }


@pytest.mark.parametrize("name", [
    "scan_genome", "scan_permute", "make_scan_hist_tables",
    "build_hist_tables", "build_pos_prefix", "block_permutation_groups",
    "block_permutation_runs", "hist_tables_from_numpy",
    "hist_points_from_numpy", "get_lattice_tables",
    "LatticeTables.from_table", "lattice_tables_from_numpy", "clr_grid",
    "two_stage_alpha_max", "clr_inputs_from_numpy", "ms_pipeline",
])
def test_entry_point_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
