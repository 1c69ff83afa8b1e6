"""The split kind (traffic/permute_split.py) on the CPU: two gloo ranks,
one torch thread each (on the CPU the statistic's float32 bits follow
the thread count), at test size.

  * its passes equal a one-rank ``permute`` kind's passes of the same
    traffic bit for bit (permute_n, permute_p, permute_finished,
    stat_threshold, every saved null), and ``rank_mismatch`` reads 0;
  * the planted split fault (rank 0 evaluates rank 1's replicate rows)
    reads ``correct`` false, by the saved nulls;
  * a child rank killed mid-window ends the run with an error and a
    non-zero exit, well inside the gloo timeout, and leaves no rank
    running;
  * ``harness._cards`` combines a kind's ``cards()`` entries, and a
    one-card kind's ``device`` fields are those it always printed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.faults import planted

TINY = pathlib.Path(__file__).resolve().parent / "tiny"
ROOT = TINY.parents[2]
SEED = 51


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kind_args(traffic):
    params = harness.load_json("traffic", traffic, TINY)
    cfg = harness.load_json("configs", "tiny", TINY)
    return harness.load_kind(params["kind"]), params, cfg


def _passes(traffic, n):
    kind, params, cfg = _kind_args(traffic)
    gen = kind.Traffic(params, cfg, SEED, "cpu")
    gen.setup(0)
    steps = [gen.step(i) for i in range(n)]
    gen.release()
    return gen, steps


def test_split_passes_equal_one_rank(one_thread):
    split, s_steps = _passes("split", 1)
    _, o_steps = _passes("perm", 1)
    assert split.mismatch == 0
    for s, o in zip(s_steps, o_steps):
        assert s.seed == o.seed and s.work == o.work
        a, b = s.result, o.result
        for f in ("permute_n", "permute_p", "permute_finished",
                  "stat_threshold"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
        assert a.null_clr == b.null_clr
        assert s.counters["split_gathers"] > 0
        assert s.counters["split_gather_s_max"] >= s.counters[
            "split_gather_s"]
        assert {k: s.counters[k] for k in o.counters} == o.counters


def test_split_fault_is_not_correct(one_thread):
    args = argparse.Namespace(workload="tiny.split", seed=SEED, seconds=0,
                              trace=0)
    code, res = harness.run_cell(args, time.monotonic(), device="cpu",
                                 faults=planted("split_rows"), root=TINY)
    assert code == 0 and not res["correct"], res["checks"]
    failed = {c["name"] for c in res["checks"] if c["value"] > c["limit"]}
    assert "null_gap" in failed, res["checks"]
    assert [e["rank"] for e in res["device"]["ranks"]] == [0, 1]


KILL = """
import json, os, pathlib, signal, sys, time, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(1)
from portbench import harness
tiny = pathlib.Path({tiny!r})
params = dict(harness.load_json("traffic", "split", tiny), ranks=3)
cfg = harness.load_json("configs", "tiny", tiny)
gen = harness.load_kind("permute_split").Traffic(params, cfg, 51, "cpu")
gen.setup(0)
gen.step(0)
print(json.dumps([p.pid for p in gen.procs]), flush=True)
os.kill(gen.procs[0].pid, signal.SIGKILL)
gen.step(1)
gen.step(2)
print("no error", flush=True)
"""


def _running(pid):
    try:
        status = pathlib.Path(f"/proc/{pid}/status").read_text()
    except OSError:
        return False
    return "\nState:\tZ" not in status


def test_a_killed_rank_ends_the_run():
    t0 = time.monotonic()
    p = subprocess.run(
        [sys.executable, "-c", KILL.format(root=str(ROOT),
                                           tiny=str(TINY))],
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0, p.stdout
    assert "no error" not in p.stdout
    assert time.monotonic() - t0 < 200
    pids = json.loads(p.stdout.splitlines()[0])
    assert len(pids) == 2
    time.sleep(1)
    assert not any(_running(pid) for pid in pids)


class _Ranks:
    def __init__(self, entries):
        self.entries = entries

    def cards(self):
        return self.entries


def test_cards_combines_the_ranks_entries():
    entries = [dict(rank=r, card=r, name="H100", memory_peak_bytes=b)
               for r, b in enumerate((3, 9, 0, 5))]
    n, peak, ranks = harness._cards(_Ranks(entries))
    assert (n, peak, ranks) == (3, 9, entries)
    # two ranks on one card count it once
    shared = [dict(e, card=0) for e in entries]
    assert harness._cards(_Ranks(shared))[:2] == (1, 9)


def test_one_card_kind_device_is_unchanged():
    assert harness._cards(object(), "cpu") == (1, 0, None)
    args = argparse.Namespace(workload="tiny.perm", seed=SEED, seconds=0,
                              trace=0)
    code, res = harness.run_cell(args, time.monotonic(), device="cpu",
                                 root=TINY)
    assert code == 0
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
