"""portbench/spans.py and the span readers: self intervals less
children, the window's idle intervals from a devtrace Trace (overlapping
events, idle before the first and after the last), the idle time by
span name and in the drivers' pieces of work, against counts made by hand; the six
readers on synthetic spans, the recorder taken once; the readers in
``--trace 1`` runs of the tiny cells through the harness as it is, and
on a program without the recorder (None, no error)."""

import argparse
import json
import math
import pathlib
import shutil
import time

import numpy as np
import pytest

from portbench import devtrace, harness
from portbench import spans as SP

TINY = pathlib.Path(__file__).resolve().parent / "tiny"
PERM_READERS = ("update_ms_per_chunk.perm", "compact_ms_per_chunk.perm",
                "launch_ms_per_chunk.perm")
SCAN_READERS = ("tables_s.scan", "eval_s.scan", "select_s.scan")


def _span(i, name, a, b, parent=0):
    return dict(name=name, start_ns=a, end_ns=b, id=i, parent=parent,
                step=1, attrs={})


# pass [0, 100] holds chunk [10, 60] (holding stat [20, 30] and update
# [40, 55]) and save [70, 80]
SPANS = [_span(3, "stat", 20, 30, 2), _span(4, "update", 40, 55, 2),
         _span(2, "chunk", 10, 60, 1), _span(5, "save", 70, 80, 1),
         _span(1, "pass", 0, 100)]
# device busy [5, 25] and [22, 35] (overlapping), [50, 52], [90, 120]
EVENTS = [("k", 5, 25), ("k", 22, 35), ("m", 50, 52), ("k", 90, 120)]


def test_self_intervals_leave_out_children():
    got = {s["name"]: p for s, p in SP.self_intervals(SPANS)}
    assert got == {"pass": [(0, 10), (60, 70), (80, 100)],
                   "chunk": [(10, 20), (30, 40), (55, 60)],
                   "stat": [(20, 30)], "update": [(40, 55)],
                   "save": [(70, 80)]}


def test_idle_is_the_window_less_the_device_union():
    idle = SP.Idle(devtrace.Trace(EVENTS, 1.0), 0, 100)
    assert list(zip(idle.start, idle.end)) == [(0, 5), (35, 50), (52, 90)]
    assert idle.total_s() * 1e9 == 5 + 15 + 38
    assert list(idle.within(np.array([0, 30, 95]),
                            np.array([100, 60, 99]))) == [58, 23, 0]
    empty = SP.Idle(devtrace.Trace([], 1.0), 10, 30)
    assert empty.total_s() * 1e9 == 20


def test_idle_by_span_name():
    idle = SP.Idle(devtrace.Trace(EVENTS, 1.0), 0, 100)
    table = SP.by_name(SPANS, idle)
    got = {n: (r["n"], round(r["self_s"] * 1e9), round(r["idle_s"] * 1e9))
           for n, r in table.items()}
    # idle [0,5) [35,50) [52,90): pass self (0,10)->5, (60,70)->10,
    # (80,100)->10; chunk (10,20)->0, (30,40)->5, (55,60)->5; stat 0;
    # update (40,55)->10+3; save (70,80)->10
    assert got == {"pass": (1, 40, 25), "chunk": (1, 25, 10),
                   "stat": (1, 10, 0), "update": (1, 15, 13),
                   "save": (1, 10, 10)}
    assert sum(r[1] for r in got.values()) == 100  # the pass, once
    assert sum(r[2] for r in got.values()) == 58  # every idle ns once
    assert "idle_s" not in SP.by_name(SPANS)["pass"]


def test_idle_table_leaves_out_the_containers():
    # the window runs from the first span's start to the last one's end
    # (idle 58 ns); the drivers' work: every span but the step and the
    # loop turn, so the synthetic names as a pass, a chunk, a stage in it
    spans = [dict(s, name={"pass": "permute.pass", "chunk": "permute.chunk",
                           "save": "scan.stage"}.get(s["name"], s["name"]))
             for s in SPANS]
    t = SP.idle_table(spans, devtrace.Trace(EVENTS, 1.0))
    assert round(t["idle_s"] * 1e9) == 58
    # stat 0 + update 13 of 58 (pass 25, chunk 10, stage 10 left out)
    assert t["work_idle_share"] == pytest.approx(13 / 58)
    assert t["by_name"]["update"]["idle_s"] * 1e9 == pytest.approx(13)


# ---- the readers ------------------------------------------------------------

def _perm_window():
    """Two passes of two chunks each: draw 1, compact 2, stat 3,
    speculate 4, update 10, drain 20 (a container's self 5) ns a chunk;
    every number is its span's self time."""
    out, i = [], 0

    def add(name, a, b, parent):
        nonlocal i
        i += 1
        out.append(dict(name=name, start_ns=a, end_ns=b, id=i,
                        parent=parent, step=1, attrs={}))
        return i

    t = 0
    for _ in range(2):
        p = add("permute.pass", t, t + 100, 0)
        add("permute.setup", t, t + 2, p)
        t += 2
        for _ in range(2):
            c = add("permute.chunk", t, t + 45, p)
            a = t
            for name, d in (("permute.draw", 1), ("permute.compact", 2),
                            ("permute.stat", 3), ("permute.speculate", 4),
                            ("permute.drain", 20), ("permute.update", 10)):
                add(name, a, a + d, c)
                a += d
            t += 45
        t += 6
    return out


def _scan_window():
    """Three scans: tables 100 ns on the first only, and two stages of
    eval 7, readback 1, select 3 ns each."""
    out, i = [], 0

    def add(name, a, b, parent):
        nonlocal i
        i += 1
        out.append(dict(name=name, start_ns=a, end_ns=b, id=i,
                        parent=parent, step=1, attrs={}))
        return i

    t = 0
    for k in range(3):
        g = add("scan.genome", t, t + 200, 0)
        if k == 0:
            add("scan.tables", t, t + 100, g)
        a = t + 100
        for _ in range(2):
            st = add("scan.stage", a, a + 11, g)
            add("scan.eval", a, a + 7, st)
            add("scan.readback", a + 7, a + 8, st)
            add("scan.select", a + 8, a + 11, st)
            a += 11
        t += 200
    return out


class _Timing:
    """A stand-in for the program's recorder, holding given spans."""

    def __init__(self, got):
        self.got, self.starts, self.takes = got, 0, 0

    def start_spans(self):
        self.starts += 1

    def take_spans(self):
        self.takes += 1
        return self.got


@pytest.fixture
def window(monkeypatch):
    """A fresh window of spans.py, and the program's recorder off after
    the test (loading a reader turns it on)."""
    from fscl_tpu_torch.utils import timing

    monkeypatch.setattr(SP, "_window", {"on": False, "spans": None,
                                        "table": None})
    yield monkeypatch
    timing.take_spans()


def _reading(events=()):
    return harness.Reading(trace=devtrace.Trace(list(events), 1.0),
                           least={}, counters={}, host={})


@pytest.mark.parametrize("kind,want", [
    ("perm", {"update_ms_per_chunk.perm": 10e-6,
              "compact_ms_per_chunk.perm": 2e-6,
              "launch_ms_per_chunk.perm": 8e-6}),
    ("scan", {"tables_s.scan": 100e-9 / 3, "eval_s.scan": 14e-9,
              "select_s.scan": 6e-9}),
])
def test_readers_on_synthetic_spans(window, kind, want, capsys):
    from fscl_tpu_torch.utils import timing

    got = _perm_window() if kind == "perm" else _scan_window()
    fake = _Timing(got)
    window.setattr(timing, "start_spans", fake.start_spans)
    window.setattr(timing, "take_spans", fake.take_spans)
    mods = {m: harness.load_metric(m) for m in want}
    assert fake.starts == 1  # the first reader turned the recorder on
    r = _reading([("k", 0, 5)])
    for m, v in want.items():
        assert mods[m].UNIT == ("ms" if kind == "perm" else "s")
        assert mods[m].read(r) == pytest.approx(v, rel=1e-12)
    assert fake.takes == 1  # taken once, for every reader
    line = [x for x in capsys.readouterr().err.splitlines()
            if x.startswith("spans ")]
    assert len(line) == 1
    table = json.loads(line[0][len("spans "):])
    assert set(table["by_name"]) == {s["name"] for s in got}


def test_readers_without_spans_give_none(window):
    from fscl_tpu_torch.utils import timing

    # a program older than the recorder
    window.delattr(timing, "start_spans")
    for m in PERM_READERS + SCAN_READERS:
        assert harness.load_metric(m).read(_reading()) is None
    # a recorder that saw no scan: the scan readers have no denominator
    window.setattr(SP, "_window", {"on": True, "spans": _perm_window(),
                                   "table": None})
    assert harness.load_metric("eval_s.scan").read(_reading()) is None


def _tiny_root(tmp_path, readers):
    """The tiny cells, their workloads listing the span readers too."""
    root = tmp_path / "tiny"
    shutil.copytree(TINY, root)
    for cell, names in (("tiny.perm", PERM_READERS),
                        ("tiny.scan", SCAN_READERS)):
        path = root / "workloads" / f"{cell}.json"
        w = json.loads(path.read_text())
        w["per_layer"] += list(names) if readers else []
        path.write_text(json.dumps(w))
    return root


@pytest.mark.parametrize("cell,names", [("tiny.perm", PERM_READERS),
                                        ("tiny.scan", SCAN_READERS)])
def test_readers_in_a_traced_run(window, tmp_path, cell, names):
    args = argparse.Namespace(workload=cell, seed=2**31 + 77, seconds=0,
                              trace=1)
    code, res = harness.run_cell(args, time.monotonic(), device="cpu",
                                 root=_tiny_root(tmp_path, True))
    assert code == 0 and res["correct"]
    for m in names:
        v = res["metrics"][m]["value"]
        assert math.isfinite(v) and v > 0, (m, v)


def test_readers_on_a_program_without_the_recorder(window, tmp_path):
    from fscl_tpu_torch.utils import timing

    window.delattr(timing, "start_spans")
    args = argparse.Namespace(workload="tiny.perm", seed=91, seconds=0,
                              trace=1)
    code, res = harness.run_cell(args, time.monotonic(), device="cpu",
                                 root=_tiny_root(tmp_path, True))
    assert code == 0 and res["correct"]
    assert not set(PERM_READERS) & set(res["metrics"])
