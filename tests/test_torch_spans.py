"""The drivers' spans (fscl_tpu_torch/utils/timing.py span, the
recorder, and their places in engine/permute.py, engine/scan.py and
parallel/shard.py).

  * off (the default): span() is one shared no-op; a whole scan and
    permutation run with the clock and record_function patched to raise;
  * on: nesting, parent ids, step ids, attributes, and self times
    (portbench/spans.py) on a patched clock, exactly;
  * a CPU scan_permute (stacked, RDP forced on, lattice): one
    permute.chunk a loop turn (counted by its progress lines), each
    holding permute.stat, permute.drain and permute.update, every
    permute.draw inside a chunk, every span in the pass's step;
  * a CPU scan_genome (hist, lattice): scan.stage spans (dense, refine
    rounds, tie on the hist path), each holding scan.eval,
    scan.readback and scan.select, the cold data object's scan.tables;
  * on the card (gpu): a span around a kernel launch and a
    synchronize contains the kernel's interval as portbench/devtrace.py
    records it: the spans' clock is the device trace's; and over a
    30 s window of such spans the device side of that clock stays
    within DRIFT_NS of the host's.

This file imports nothing of tests/: on the card machine such imports do
not collect.
"""

import re
import time
import types

import numpy as np
import pytest
import torch

import fscl_tpu_torch.engine.permute as TP
import fscl_tpu_torch.engine.scan as TS
import fscl_tpu_torch.utils.timing as TT
from fscl_tpu_torch.data import build_snp_data
from fscl_tpu_torch.models import background_fsp, build_tables
from fscl_tpu_torch.sim import simulate_dataset
from portbench import spans as SP

SCAN = dict(eval_range=100, small_grid_sp=5000, large_grid_sp=20000)
PERM = dict(n_permute=48, chunk_replicates=2, seed=5, hist_positions=2,
            hist_alphas=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    yield
    TT.take_spans()


def _model(grid_points=256):
    chrs, pos, fr = [], [], []
    for c in range(2):
        sim = simulate_dataset(seed=40 + c, sample_size=24, mb_length=0.6,
                               alpha=3e-5)
        keep = (sim["freq"] >= 1) & (sim["freq"] <= 23)
        chrs += [str(c + 1)] * int(keep.sum())
        pos.append(sim["pos"][keep])
        fr.append(sim["freq"][keep])
    pos, fr = np.concatenate(pos), np.concatenate(fr)
    data = build_snp_data(chrs, pos, fr, np.full(len(pos), 24),
                          np.zeros(len(pos), bool))
    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths)
    tables = build_tables(fsp, data.sample_depths, grid_points=grid_points)
    data.attach_model(tables)
    return data, tables


@pytest.fixture(scope="module")
def model():
    return _model()


def _scan(model, **kw):
    data, tables = model
    return TS.scan_genome(data, tables, TS.ScanConfig(**dict(SCAN, **kw)),
                          device="cpu")


def _unpermuted(result):
    import copy

    r = copy.deepcopy(result)
    r.null_clr = [None] * r.n_points
    return r


def _kids(spans):
    out = {}
    for s in spans:
        out.setdefault(s["parent"], []).append(s)
    return out


def _descendants(s, kids):
    todo, out = list(kids.get(s["id"], ())), []
    while todo:
        c = todo.pop()
        out.append(c)
        todo += kids.get(c["id"], ())
    return out


def test_off_path_is_one_noop_and_calls_nothing(model, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the off path called it")

    # the spans' clock; the phase table keeps its own (time.monotonic)
    monkeypatch.setattr(TT, "time", types.SimpleNamespace(
        time_ns=boom, monotonic=time.monotonic))
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    a = TT.span("a", x=1)
    assert a is TT.span("b") is TT._NOOP
    with TT.span("permute.chunk") as ch:
        ch.set(path="hist")
    data, tables = model
    r = _unpermuted(_scan(model))
    TP.scan_permute(data, tables, r, TS.ScanConfig(**SCAN),
                    TP.PermuteConfig(**dict(PERM, n_permute=8)),
                    device="cpu")
    assert r.permute_n.max() == 8
    assert TT.take_spans() == []


def test_nesting_parents_steps_and_self_time(monkeypatch):
    clock = iter(range(0, 10_000, 10))
    monkeypatch.setattr(TT, "time", types.SimpleNamespace(
        time_ns=lambda: next(clock)))
    TT.start_spans()
    with TT.span("pass", step=True, k=1):          # 0 .. 70
        with TT.span("chunk") as ch:               # 10 .. 40
            ch.set(R=16)
            with TT.span("stat"):                  # 20 .. 30
                pass
        with TT.span("update"):                    # 50 .. 60
            pass
    with TT.span("other"):                         # 80 .. 90
        pass
    got = TT.take_spans()
    assert TT.take_spans() == []  # taken: the recorder is off
    by = {s["name"]: s for s in got}
    assert [s["name"] for s in got] == ["stat", "chunk", "update", "pass",
                                        "other"]
    p = by["pass"]
    assert (p["start_ns"], p["end_ns"], p["parent"], p["step"]) == (
        0, 70, 0, p["id"])
    assert by["chunk"]["parent"] == p["id"]
    assert by["stat"]["parent"] == by["chunk"]["id"]
    assert by["update"]["parent"] == p["id"]
    assert all(by[n]["step"] == p["id"]
               for n in ("chunk", "stat", "update"))
    assert by["other"]["step"] == 0 and by["other"]["parent"] == 0
    assert by["chunk"]["attrs"] == {"R": 16} and p["attrs"] == {"k": 1}
    table = SP.by_name(got)
    # pass 70 less chunk 30 and update 10; chunk 30 less stat 10
    got = {n: (r["n"], round(r["self_s"] * 1e9)) for n, r in table.items()}
    assert got == {"pass": (1, 30), "chunk": (1, 20), "stat": (1, 10),
                   "update": (1, 10), "other": (1, 10)}


def test_table_span_times_the_phase_table_on_or_off(monkeypatch):
    monkeypatch.setattr(TT, "_phases", {})
    for _ in range(2):
        with TT.span("split.gather", table="gather") as sp:
            pass
        assert sp.seconds >= 0
    assert set(TT.phase_report()) == {"gather"}
    assert TT.take_spans() == []  # off: timed, not recorded


def test_table_span_ignores_a_step_of_the_wall_clock(monkeypatch):
    # the recorder's stamps jump back an hour; the table's seconds do not
    stamps = iter([3_600_000_000_000, 0])
    monkeypatch.setattr(TT, "time", types.SimpleNamespace(
        time_ns=lambda: next(stamps), monotonic=time.monotonic))
    monkeypatch.setattr(TT, "_phases", {})
    with TT.span("split.gather", table="gather") as sp:
        pass
    assert 0 <= sp.seconds < 1
    assert TT.phase_report()["gather"] == sp.seconds


@pytest.mark.parametrize("path", ["stacked", "rdp", "lattice"])
def test_permute_spans_a_chunk_a_loop_turn(model, path, monkeypatch,
                                            capsys):
    data, tables = model
    scanned = _scan(model)
    monkeypatch.setattr(TP, "RDP_FORCE", "on" if path == "rdp" else "off")
    cfg = TP.PermuteConfig(**dict(PERM, use_hist=path != "lattice"))
    r = _unpermuted(scanned)
    capsys.readouterr()
    TT.start_spans()
    TP.scan_permute(data, tables, r, TS.ScanConfig(**SCAN), cfg,
                    device="cpu")
    got = TT.take_spans()
    turns = len(re.findall(r"permutations\.\.\. +\d+ \(",
                           capsys.readouterr().err))
    kids = _kids(got)
    (p,) = [s for s in got if s["name"] == "permute.pass"]
    chunks = [s for s in got if s["name"] == "permute.chunk"]
    assert turns > 1 and len(chunks) == turns
    assert all(s["step"] == p["id"] for s in got)
    want = "lattice" if path == "lattice" else (
        "rdp" if path == "rdp" else "hist")
    assert {c["attrs"]["path"] for c in chunks} == {want}
    assert sum(c["attrs"]["R"] for c in chunks) == PERM["n_permute"]
    for c in chunks:
        assert c["parent"] == p["id"]
        names = {d["name"] for d in _descendants(c, kids)}
        assert {"permute.stat", "permute.drain", "permute.update",
                "permute.save"} <= names, names
        assert set(c["attrs"]) == {"path", "R", "boost", "n_active"}
    inside = {d["id"] for c in chunks for d in _descendants(c, kids)}
    draws = [s for s in got if s["name"] == "permute.draw"]
    assert draws and all(d["id"] in inside for d in draws)
    assert [s["name"] for s in got if s["parent"] == p["id"]].count(
        "permute.setup") >= 1


@pytest.mark.parametrize("use_hist", [True, False])
def test_scan_spans_each_stage(use_hist):
    model = _model()  # a cold data object: its tables built in the scan
    TT.start_spans()
    _scan(model, use_hist=use_hist)
    got = TT.take_spans()
    kids = _kids(got)
    (g,) = [s for s in got if s["name"] == "scan.genome"]
    assert all(s["step"] == g["id"] for s in got)
    stages = [s for s in got if s["name"] == "scan.stage"]
    kinds = [s["attrs"]["stage"] for s in sorted(
        stages, key=lambda s: s["start_ns"])]
    assert kinds[0] == "dense" and kinds.count("refine") >= 2
    assert kinds[-1] == ("tie" if use_hist else "refine")
    for s in stages:
        assert s["parent"] == g["id"]
        names = {d["name"] for d in _descendants(s, kids)}
        assert {"scan.eval", "scan.readback", "scan.select"} <= names
    names = {s["name"] for s in got}
    assert {"scan.tables", "scan.setup", "scan.output"} <= names


# ---- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the device trace's clock is the card's")
    return torch.device("cuda")


@pytest.mark.gpu
def test_span_contains_its_kernel_on_the_device_trace():
    from portbench import devtrace

    dev = _card()
    a = torch.randn(4096, 4096, device=dev)
    a @ a  # the library loaded and warm
    torch.cuda.synchronize()
    prof = devtrace.start(True)
    TT.start_spans()
    with TT.span("matmul"):
        b = a @ a
        torch.cuda.synchronize()
    events = devtrace.stop(prof)
    (s,) = TT.take_spans()
    assert b.shape == a.shape
    kernels = [e for e in events if not e[0].startswith(("Memcpy",
                                                         "Memset"))]
    assert kernels, events
    for name, k0, k1 in kernels:
        assert s["start_ns"] <= k0 <= k1 <= s["end_ns"], (
            name, k0 - s["start_ns"], s["end_ns"] - k1)


# the most the card's timestamps may lead or trail the spans' clock over
# a 45 s window, as the idle table of portbench/spans.py reads them: a
# few ms of it were seen on the H100 (PERF.md)
DRIFT_NS = 10_000_000


@pytest.mark.gpu
def test_device_clock_stays_near_the_spans_over_a_long_window(capsys):
    from portbench import devtrace

    dev = _card()
    x = torch.zeros(1024, device=dev)
    x.add_(1)
    torch.cuda.synchronize()
    prof = devtrace.start(True)
    TT.start_spans()
    t_end = time.monotonic() + 30.0
    while time.monotonic() < t_end:
        with TT.span("add"):
            x.add_(1)  # one elementwise kernel
            torch.cuda.synchronize()
        time.sleep(0.004)
    events = devtrace.stop(prof)
    got = TT.take_spans()
    kernels = sorted(e for e in events if "elementwise" in e[0])
    assert len(kernels) == len(got) > 1000, (len(kernels), len(got))
    lead = np.array([s["start_ns"] - k[1] for s, k in zip(got, kernels)])
    lag = np.array([k[2] - s["end_ns"] for s, k in zip(got, kernels)])
    t = np.array([s["start_ns"] for s in got]) - got[0]["start_ns"]
    bins = (t // 5_000_000_000).astype(int)
    with capsys.disabled():
        print("\ndevice clock against the spans, ms by 5 s of window "
              "(most a kernel starts before its span; most it ends "
              "after it; kernels starting early):")
        for b in np.unique(bins):
            m = bins == b
            print(f"  {5 * b:3d} s: lead {lead[m].max() / 1e6:.3f}, "
                  f"lag {lag[m].max() / 1e6:.3f}, "
                  f"{int((lead[m] > 0).sum())} of {int(m.sum())}")
    assert lead.max() <= DRIFT_NS and lag.max() <= DRIFT_NS
