"""The check fails a broken program: each cell's traffic run at test size
on the CPU (the harness's look for a card skipped) with the timed path
broken underneath reads ``correct`` false, and the unbroken program
reads true.  Faults (faults.py): a pass that leaves its state unchanged;
half of the candidates left out of the statistic (the rest's maximum
taken); an answer altered where it is produced: the nulls, the reported
CLR, and the hist scan's bf16 selection with its f32 tie stage whole.
(One chip: no exchange to leave out.)"""

from __future__ import annotations

import argparse
import pathlib
import time

import pytest

from portbench import harness
from portbench.faults import planted

TINY = pathlib.Path(__file__).resolve().parent / "tiny"


def run(workload, faults=None, seed=51):
    args = argparse.Namespace(workload=workload, seed=seed, seconds=0,
                              trace=0)
    code, res = harness.run_cell(args, time.monotonic(), device="cpu",
                                 faults=faults, root=TINY)
    assert code == 0
    return res


@pytest.mark.parametrize("workload", [
    "tiny.tail", "tiny.perm", "tiny.scan", "tiny_exact.scan"])
def test_sound_program_is_correct(workload):
    assert run(workload)["correct"]


@pytest.mark.parametrize("workload,fault", [
    ("tiny.tail", "unchanged_pass"),
    ("tiny.tail", "altered_nulls"),
    ("tiny.tail", "half_candidates"),
    ("tiny.perm", "unchanged_pass"),
    ("tiny.scan", "altered_clr"),
    ("tiny.scan", "half_candidates"),
    ("tiny.scan", "selection"),
    ("tiny_exact.scan", "altered_clr"),
    ("tiny_exact.scan", "half_lattice"),
])
def test_broken_program_is_not_correct(workload, fault):
    res = run(workload, planted(fault))
    assert not res["correct"], res["checks"]


def test_selection_fault_is_judged_by_shortfall():
    """The selection fault leaves the tie stage's values right, so only
    the shortfall behind the reference's best can fail it."""
    res = run("tiny.scan", planted("selection"))
    failed = {c["name"] for c in res["checks"] if c["value"] > c["limit"]}
    assert failed == {"shortfall"}, res["checks"]
