"""The device trace of a ``--trace 1`` run: torch.profiler's CUDA activity
over the measured window, reduced to device intervals, and the arithmetic
the per-layer readers share (busy and idle time, gaps, time by kernel).

Only CUDA activity is recorded (kernels, copies, memsets; no host ops),
so a long window stays within memory.  Each interval is (name, start,
end) in ns on the profiler's clock; ``Trace`` holds them sorted by start
with the window's length on the host clock.
"""

from __future__ import annotations

import re

import numpy as np


def start(cuda=True):
    """A running profiler that records the card's activity (the host's
    where ``cuda`` is false: a CPU run of the tests, with no device
    events)."""
    from torch.profiler import ProfilerActivity, profile

    act = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    prof = profile(activities=[act])
    prof.start()
    return prof


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


def stop(prof):
    """Stop ``prof``; [(name, start_ns, end_ns)] of every device event."""
    from torch.autograd import DeviceType

    prof.stop()
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        if name.startswith("Command Buffer"):
            continue
        t0 = _ns(e, "start")
        dur = (int(e.duration_ns()) if hasattr(e, "duration_ns")
               else int(e.duration_us() * 1000))
        out.append((name, t0, t0 + dur))
    return out


def short_name(name):
    """A kernel's base name: C++ return type, namespaces and template
    arguments dropped ("void (anonymous namespace)::window_clr_kernel<
    float, ...>(...)" -> "window_clr_kernel")."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    base = re.sub(r"\(anonymous namespace\)::", "", name)
    base = re.sub(r"\(.*$", "", base)
    depth, out = 0, []
    for ch in base:  # drop template arguments
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    base = "".join(out).strip()
    base = base.split("::")[-1].split(" ")[-1]
    return base or name[:60]


class Trace:
    """Device intervals of one traced window."""

    def __init__(self, events, window_s):
        self.window_s = float(window_s)
        ev = sorted(events, key=lambda e: e[1])
        self.names = [e[0] for e in ev]
        self.start = np.array([e[1] for e in ev], np.int64)
        self.end = np.array([e[2] for e in ev], np.int64)

    @property
    def n(self):
        return len(self.names)

    def busy_s(self):
        """Seconds in which some device event ran (the union)."""
        if self.n == 0:
            return 0.0
        reach = np.maximum.accumulate(self.end)
        gaps = np.maximum(self.start[1:] - reach[:-1], 0)
        span = int(reach[-1] - self.start[0])
        return (span - int(gaps.sum())) / 1e9

    def gaps_ns(self):
        """[n - 1] idle ns before each event after the first (0 where it
        overlaps what ran before it)."""
        if self.n < 2:
            return np.zeros(0, np.int64)
        reach = np.maximum.accumulate(self.end)
        return np.maximum(self.start[1:] - reach[:-1], 0)

    def idle_share(self):
        """1 - busy over the window, in percent."""
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def device_s(self, pattern):
        """Summed durations of the events whose name matches every
        substring of ``pattern`` (a tuple)."""
        tot = 0
        for name, a, b in zip(self.names, self.start, self.end):
            if all(p in name for p in pattern):
                tot += int(b - a)
        return tot / 1e9

    def breakdown(self, top=10):
        """The device operations that took most time, and the longest
        idle time by the operation that ended it (what the host was
        preparing), each [[name, seconds], ...]."""
        ops, idle = {}, {}
        for name, a, b in zip(self.names, self.start, self.end):
            k = short_name(name)
            ops[k] = ops.get(k, 0) + int(b - a)
        for name, g in zip(self.names[1:], self.gaps_ns()):
            if g > 0:
                k = "before " + short_name(name)
                idle[k] = idle.get(k, 0) + int(g)

        def topk(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": topk(ops), "idle_gaps": topk(idle)}
