"""The control fails the check: the reference put in the program's place
at the cell's control precision (fp8 operands for the bf16 permutation
statistic, TF32 for the float32 scans) reads over a limit on every seed,
where the program reads within every limit.  At test size on the CPU,
one step a run (a window of 0 s), so each seed reads the same each time;
the cells' own readings on the card are in PERF.md."""

from __future__ import annotations

import argparse
import pathlib
import time

import pytest

from portbench import check, harness

TINY = pathlib.Path(__file__).resolve().parent / "tiny"


@pytest.mark.parametrize("workload", [
    "tiny.tail", "tiny.perm", "tiny.split", "tiny.scan", "tiny_exact.scan"])
@pytest.mark.parametrize("seed", [50, 51, 52])
def test_control_fails_where_the_program_passes(workload, seed):
    args = argparse.Namespace(workload=workload, seed=seed, seconds=0,
                              trace=0)
    code, res = harness.run_cell(args, time.monotonic(), device="cpu",
                                 root=TINY, control=True)
    assert code == 0 and res["correct"], res["checks"]
    limits = harness.load_json("workloads", workload, TINY)["limits"]
    ok, rows = check.judge(res["control"], limits)
    assert not ok, rows
