"""The check at 216 haplotypes (yri_1kg's depth, 214 table rows of one
depth: exact one-hot tables at R = 216): the tail traffic at test size on
the CPU reads ``correct`` true, and false with the tables forced onto the
compressed route, whose rank ladder misses its tolerance at one large
depth (``compressed_route``; the card's readings of both are in
PERF.md)."""

from __future__ import annotations

import argparse
import time

from portbench import harness


def compressed_route(prog):
    """The hist tables forced onto the SVD-compressed route (its largest
    rank where no rank reaches the tolerance), undone when the run
    releases its program."""
    from fscl_tpu_torch.engine import scan

    orig = scan.build_hist_tables

    def f(*a, **kw):
        return orig(*a, **{**kw, "compress": True})

    scan.build_hist_tables = f
    release = prog.release

    def undo():
        scan.build_hist_tables = orig
        release()

    prog.release = undo


def run(faults=None, seed=2**31 + 77):
    from portbench.tests.test_pb_faults import TINY

    args = argparse.Namespace(workload="tiny_yri.tail", seed=seed,
                              seconds=0, trace=0)
    code, res = harness.run_cell(args, time.monotonic(), device="cpu",
                                 faults=faults, root=TINY)
    assert code == 0
    return res


def test_wide_rows_tail_is_correct():
    from fscl_tpu_torch.ops import histclr

    before = dict(histclr.table_modes)
    res = run()
    assert res["correct"], res["checks"]
    assert histclr.table_modes["exact_wide"] > before["exact_wide"]
    assert histclr.table_modes["compressed"] == before["compressed"]


def test_compressed_route_is_not_correct():
    res = run(compressed_route)
    assert not res["correct"], res["checks"]
