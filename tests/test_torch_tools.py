"""The port's tools: the ascertainment-biased ms generator
(fscl_tpu_torch/sim/ascbias_segments.py) against fscl_tpu's, and the
phase timers (fscl_tpu_torch/utils/timing.py).

Stated tolerances:
  * draw_samples with the neutral block source: the stream byte-equal to
    fscl_tpu's on the same seeds; extract_snps: positions and alleles
    equal (the same numpy code on the same input);
  * the generator's command line writes a file that the port's CLI scans
    with -m (a subprocess that imports no jax);
  * phase: logs "[timing] <name>" at -v 4 (MSG_DEBUG1) and not at -v 3,
    accumulates every phase of a CLI run (load, tables, scan, permute,
    output; and lattice-pack on the lattice path) into phase_report(); with
    FSCL_TPU_TRACE_DIR set, one Chrome trace per outermost phase, read
    back as JSON with its events; the scan and permute phases' traces
    hold the drivers' spans (utils/timing.py span) as annotations.

This file imports nothing of tests/: on the card machine such imports do
not collect.
"""

import glob
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import fscl_tpu.sim.ascbias_segments as JA
import fscl_tpu_torch.sim.ascbias_segments as TA
import fscl_tpu_torch.utils.timing as TT
from fscl_tpu.io.ms_parser import MsBlock as JMsBlock
from fscl_tpu_torch.io.ms_parser import MsBlock, MsParser
from fscl_tpu_torch.sim import simulate_dataset, write_snp_file

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this file runs: the suite runs files in
    several processes at once, where torch's default of a thread a core
    oversubscribes the CPU and small ops wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(mod, **kw):
    buf = io.StringIO()
    args = dict(n_repl=2, sample_size=10, mb_length=2, n_snps=50,
                asc_depth=4, double_hit=False, rho_mb=0.0, rho_std=0.0)
    args.update(kw)
    mod.draw_samples(buf, **args,
                     block_source=mod.neutral_block_source(
                         np.random.default_rng(0)), seed=1)
    return buf.getvalue()


@pytest.mark.parametrize("kw", [{}, dict(double_hit=True, asc_depth=6),
                                dict(asc_depth=0, n_repl=3)])
def test_draw_samples_byte_equal(kw):
    got = _draw(TA, **kw)
    assert got == _draw(JA, **kw)
    parser = MsParser(io.StringIO(got.split("\n", 2)[2]))
    blocks = []
    while (b := parser.next_block()) is not None:
        blocks.append(b)
    assert len(blocks) == kw.get("n_repl", 2)
    assert all(b.n_poly == 50 and (np.diff(b.positions) >= 0).all()
               for b in blocks)


@pytest.mark.parametrize("asc_depth, double_hit", [(0, False), (2, False),
                                                   (5, False), (5, True)])
def test_extract_snps_matches(asc_depth, double_hit):
    rng = np.random.default_rng(asc_depth + 10 * double_hit)
    haps = (rng.random((12, 40)) < 0.3).astype(np.uint8)
    pos = np.sort(rng.random(40))
    got = TA.extract_snps(MsBlock(segments=[], prob=0.0, positions=pos,
                                  haplotypes=haps),
                          1000, 5000.0, asc_depth, double_hit)
    want = JA.extract_snps(JMsBlock(segments=[], prob=0.0, positions=pos,
                                    haplotypes=haps),
                           1000, 5000.0, asc_depth, double_hit)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert 0 < len(got[0]) <= 40


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def test_generator_cli_output_scans(tmp_path):
    ms = tmp_path / "asc.ms"
    assert TA.main(["-N", "2", "-n", "16", "-s", "400", "-l", "2", "-d", "6",
                    "--seed", "3", "-o", str(ms)]) == 0
    out = tmp_path / "asc.tsv"
    code = ("import sys, runpy\n"
            "sys.argv = ['fscl_tpu_torch'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('fscl_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "assert 'jax' not in sys.modules\n"
            "print('scanned')\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "-m", str(ms), "-o", str(out),
         "--ms-segment-length", "2000000", "-g", "20000", "-G", "200000",
         "--max-only", "--device", "cpu", "-v", "1"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "scanned" in proc.stdout
    rows = [line.split("\t") for line in out.read_text().splitlines()]
    assert len(rows) == 2  # one maximum a block
    assert np.isfinite([float(r[2]) for r in rows]).all()


@pytest.fixture(scope="module")
def snp_file(tmp_path_factory):
    sim = simulate_dataset(seed=9, sample_size=20, mb_length=1.0,
                           alpha=3e-5, n_sweeps=1)
    path = tmp_path_factory.mktemp("timing") / "t.sf"
    write_snp_file(path, sim["pos"], sim["freq"], sim["n"])
    return path


@pytest.mark.parametrize("verbosity, extra", [
    ("4", []), ("3", []), ("4", ["--no-hist"])])
def test_cli_phases_log_and_accumulate(snp_file, tmp_path, monkeypatch,
                                       capsys, verbosity, extra):
    from fscl_tpu_torch.cli import main

    monkeypatch.setattr(TT, "_phases", {})
    assert main(["-f", str(snp_file), "-o", str(tmp_path / "o.tsv"),
                 "-g", "20000", "-G", "200000", "-p", "8", "--device",
                 "cpu", "-v", verbosity, *extra]) == 0
    names = {"load", "tables", "scan", "permute", "output"} | (
        {"lattice-pack"} if extra else set())
    report = TT.phase_report()
    assert set(report) == names
    assert all(t > 0 for t in report.values())
    err = capsys.readouterr().err
    for name in names:
        assert (f"[timing] {name}: " in err) == (verbosity == "4")


def test_trace_dir_writes_one_trace_a_phase(tmp_path, monkeypatch):
    monkeypatch.setenv("FSCL_TPU_TRACE_DIR", str(tmp_path / "traces"))
    monkeypatch.setattr(TT, "_phases", {})
    with TT.phase("outer", "cpu"):
        torch.arange(1000.0).cumsum(0)
        with TT.phase("inner", "cpu"):  # inside the outer trace
            torch.ones(10).sum()
    files = glob.glob(str(tmp_path / "traces" / "*.pt.trace.json"))
    assert len(files) == 1 and os.path.basename(files[0]).startswith("outer.")
    with open(files[0]) as f:
        assert json.load(f)["traceEvents"]
    assert set(TT.phase_report()) == {"outer", "inner"}


def test_trace_dir_traces_hold_the_drivers_spans(snp_file, tmp_path,
                                                  monkeypatch):
    from fscl_tpu_torch.cli import main

    tdir = tmp_path / "traces"
    monkeypatch.setenv("FSCL_TPU_TRACE_DIR", str(tdir))
    monkeypatch.setattr(TT, "_phases", {})
    assert main(["-f", str(snp_file), "-o", str(tmp_path / "o.tsv"),
                 "-g", "20000", "-G", "200000", "-p", "8", "--device",
                 "cpu"]) == 0

    def annotations(phase):
        (path,) = glob.glob(str(tdir / f"{phase}.*.pt.trace.json"))
        with open(path) as f:
            return {e["name"] for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "user_annotation"}

    assert {"permute.pass", "permute.setup", "permute.chunk",
            "permute.stat", "permute.drain", "permute.update",
            "permute.save"} <= annotations("permute")
    assert {"scan.genome", "scan.stage", "scan.eval", "scan.readback",
            "scan.select", "scan.output"} <= annotations("scan")
    assert TT.span("after") is TT._NOOP  # off again once the trace ends
