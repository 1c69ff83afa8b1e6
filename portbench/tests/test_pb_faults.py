"""The check fails a broken program: each cell's traffic run at test size
on the CPU (the harness's look for a card skipped) with the timed path
broken underneath reads ``correct`` false, and the unbroken program
reads true.  Faults (faults.py): a pass that leaves its state unchanged;
half of the candidates left out of the statistic (the rest's maximum
taken); an answer altered where it is produced: the nulls, the reported
CLR, and the hist scan's bf16 selection with its f32 tie stage whole;
in the split cell also the exchange between ranks left out (each rank's
gather holds its own rows), which the saved nulls and ``rank_mismatch``
read, and rank 0 evaluating rank 1's rows (test_pb_split.py)."""

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
    "tiny.tail", "tiny.perm", "tiny.split", "tiny.scan", "tiny_exact.scan"])
def test_sound_program_is_correct(workload):
    assert run(workload)["correct"]


@pytest.mark.parametrize("workload,fault", [
    ("tiny.tail", "unchanged_pass"),
    ("tiny.tail", "altered_nulls"),
    ("tiny.tail", "half_candidates"),
    ("tiny.perm", "unchanged_pass"),
    ("tiny.split", "unchanged_pass"),
    ("tiny.split", "half_candidates"),
    ("tiny.split", "altered_nulls"),
    ("tiny.split", "no_gather"),
    ("tiny.scan", "altered_clr"),
    ("tiny.scan", "half_candidates"),
    ("tiny.scan", "selection"),
    ("tiny_exact.scan", "altered_clr"),
    ("tiny_exact.scan", "half_lattice"),
])
def test_broken_program_is_not_correct(workload, fault):
    res = run(workload, planted(fault))
    assert not res["correct"], res["checks"]


def test_left_out_exchange_splits_the_ranks():
    """Without the exchange each rank records its own rows alone, so the
    ranks' results differ as well as rank 0's nulls."""
    res = run("tiny.split", planted("no_gather"))
    failed = {c["name"] for c in res["checks"] if c["value"] > c["limit"]}
    assert {"rank_mismatch", "null_gap"} <= failed, res["checks"]


def test_selection_fault_is_judged_by_shortfall():
    """The selection fault leaves the tie stage's values right, so only
    the shortfall behind the reference's best can fail it."""
    res = run("tiny.scan", planted("selection"))
    failed = {c["name"] for c in res["checks"] if c["value"] > c["limit"]}
    assert failed == {"shortfall"}, res["checks"]
