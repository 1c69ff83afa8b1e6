"""The yardstick's arithmetic on synthetic inputs: the trace's busy,
idle and gap arithmetic, roofline shares, kernel names, and the inputs
made from a seed (the same seed, the same genome and pass seeds)."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

from portbench import devtrace, work
from portbench.genome import make_genome
from portbench import harness
from portbench.harness import Reading

TINY = pathlib.Path(__file__).resolve().parent / "tiny"


def synthetic():
    # 0-10 ms kernel A, 5-12 ms copy (overlaps), 20-30 ms kernel B,
    # 40-41 ms kernel A: busy 12 + 10 + 1 = 23 ms of a 50 ms window
    ev = [("void ns::window_clr_kernel<float>(int)", 0, 10_000_000),
          ("Memcpy HtoD (Pageable -> Device)", 5_000_000, 12_000_000),
          ("void (anonymous namespace)::lattice_clr_kernel(int)",
           20_000_000, 30_000_000),
          ("void ns::window_clr_kernel<float>(int)", 40_000_000,
           41_000_000)]
    return devtrace.Trace(ev, 0.050)


def test_busy_idle_and_gaps():
    tr = synthetic()
    assert tr.busy_s() == pytest.approx(0.023)
    assert tr.idle_share() == pytest.approx(54.0)
    assert list(tr.gaps_ns()) == [0, 8_000_000, 10_000_000]
    assert tr.device_s(("window_clr_kernel",)) == pytest.approx(0.011)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["window_clr_kernel", 0.011]
    assert b["idle_gaps"][0] == ["before window_clr_kernel", 0.010]
    assert b["idle_gaps"][1] == ["before lattice_clr_kernel", 0.008]


def test_roofline_share():
    tr = synthetic()
    r = Reading(trace=tr, least={"window_clr": (2, 0.0055)}, counters={},
                host={})
    assert work.roofline_share(r, "window_clr") == pytest.approx(50.0)
    assert work.roofline_share(r, "clr_lattice") is None


def test_least_time_is_the_larger_term():
    p = work.PEAKS
    t = work.least_s(p["hbm_bytes_per_s"], [(p["fp32_flops"] * 2,
                                             p["fp32_flops"])])
    assert t == pytest.approx(2.0)
    t = work.window_least(10, row_bytes=100, fixed_bytes=0, c=1, P=1,
                          n_cells=1, n_rows=1, n_alpha=1, pack_bytes=2,
                          mma_rate=1.0, mma_passes=3)
    # K = 2 * n_cells * n_rows = 2: three MMAs of 2 c P K A = 4 ops at
    # 1 op/s, above 6 c P K lerp ops at the FP32 rate and the bytes
    assert t == pytest.approx(12.0)


def test_kernel_names():
    assert devtrace.short_name(
        "void (anonymous namespace)::onehot_chained_scan<(anonymous "
        "namespace)::SegmentSource, short>(int, short*)") == \
        "onehot_chained_scan"
    assert devtrace.short_name("Memset (Device)") == "Memset"


@pytest.mark.parametrize("sites", ["shuffled", "per_seed"])
def test_genome_is_a_function_of_the_seed(sites):
    cfg = json.loads((TINY / "configs" / "tiny.json").read_text())
    layouts, first = set(), make_genome(cfg, 7, sites)
    for seed in (*range(10), 2**31 + 5, 2**40 + 3):
        a, b = make_genome(cfg, seed, sites), make_genome(cfg, seed, sites)
        assert np.array_equal(a.pos, b.pos)
        assert np.array_equal(a.freq, b.freq)
        assert (a.freq >= cfg["min_derived_count"]).all()
        same_chrom = np.diff(np.repeat(np.arange(len(a.count)), a.count)) == 0
        assert (np.diff(a.pos)[same_chrom] >= 0).all()
        if sites == "shuffled":
            # the same sites, the chromosomes in another order
            assert sorted(a.count) == sorted(first.count)
            assert np.array_equal(np.sort(a.pos), np.sort(first.pos))
        else:
            # the chromosomes in the configuration's order, drawn anew
            assert a.chrom == first.chrom
            assert abs(a.n_sites - first.n_sites) < 0.05 * first.n_sites
        layouts.add((tuple(a.chrom), a.pos[0], a.n_sites))
    assert len(layouts) > 1


def test_pass_seeds():
    pass_seed = harness.load_kind("permute").pass_seed
    s = [pass_seed(2**33 + 1, i) for i in range(-1, 50)]
    assert s == [pass_seed(2**33 + 1, i) for i in range(-1, 50)]
    assert len(set(s)) == len(s)
    assert all(0 <= x < 2**31 for x in s)


def test_capture_reduces_after_the_window():
    """A launch's data-dependent count is reduced by least(), not when the
    launch is recorded; each held tensor once; a tensor changed in place
    after its launch leaves its family out; past the held budget a launch
    is reduced when recorded and counted as inline."""
    import torch

    calls = []

    def reduce(t):
        calls.append(t)
        return t.sum()

    cap = work.Capture(["window_clr", "clr_lattice"])
    a, b = torch.arange(4), torch.ones(3, dtype=torch.int64)
    cap._record("window_clr", lambda d: d * 1.0, reduce, a)
    cap._record("window_clr", lambda d: d * 2.0, reduce, a)
    cap._record("clr_lattice", lambda d: d * 1.0, reduce, b)
    assert calls == [] and cap.stats() == {
        "held_bytes": a.numel() * 8 + b.numel() * 8, "inline": 0}
    b.add_(1)  # changed in place after its launch
    least = cap.least()
    assert least == {"window_clr": (2, 18.0)}
    assert len(calls) == 1

    cap = work.Capture(["window_clr"])
    cap.HOLD_BYTES = 8
    cap._record("window_clr", lambda d: d * 1.0, reduce, a)
    assert cap.stats()["inline"] == 1
    assert cap.least() == {"window_clr": (1, 6.0)}
