"""The program's spans in a ``--trace 1`` window, for the span readers
(metrics/*_per_chunk.perm.py, metrics/*_s.scan.py), and the spans set
against the window's device trace.

The program's recorder is fscl_tpu_torch/utils/timing.py:
``start_spans()`` turns it on, ``take_spans()`` gives each span closed
since as a dict with name, start_ns, end_ns, id and parent (0 at the
top).  A span reader calls ``record()`` as it loads, which the harness
does in ``--trace 1`` runs only, after the set-up and before the
window; its ``read`` calls ``self_per``, whose first call takes the
window's spans (after the window's last sync and the check, which runs
only the plain reference).  A program without a recorder (a commit
older than the spans) gives no spans and every span reader None.

Spans nest on the program's one host thread, so the self intervals of
all spans (a span's interval less its children's) are disjoint: each
instant belongs to the innermost span open then.  ``by_name`` reduces
the spans to {name: {"n", "self_s"}}: the count and the summed self
time, and with an ``Idle`` the card's idle time inside the self
intervals ("idle_s").  The first take writes ``spans {json}``
(``idle_table``) to standard error: where the window's idle time went,
by span.

Starts and ends are ``time.time_ns()``; devtrace's intervals are on
torch.profiler's unix-epoch clock.  On the H100 the device side of that
clock drifted from the host's by up to a few ms within a 45 s window
(PERF.md), so idle time near a span's boundary may be put down to the
span beside it; the self times, which the readers report, are the
host's clock alone.
"""

from __future__ import annotations

import json
import sys

import numpy as np

# the window's spans once taken; "on": the recorder was turned on
_window = {"on": False, "spans": None, "table": None}

# spans that only hold others: a step (one scan_permute or scan_genome
# call) and a loop turn; idle time in their self intervals is put down to
# no piece of the drivers' work (nor is a CLI phase's, "phase.<name>")
CONTAINERS = ("permute.pass", "permute.chunk", "scan.genome", "scan.stage")


def record():
    """Turn the program's span recorder on, once a process.  False where
    the program has none."""
    if _window["on"]:
        return True
    try:
        from fscl_tpu_torch.utils import timing
    except ImportError:
        return False
    if not hasattr(timing, "start_spans"):
        return False
    timing.start_spans()
    _window["on"] = True
    return True


def taken(trace=None):
    """The window's spans, taken from the program at the first call ([]
    where the recorder was never turned on); that call writes the idle
    table where ``trace`` (a devtrace.Trace) holds device intervals."""
    if _window["spans"] is None:
        if not _window["on"]:
            return []
        from fscl_tpu_torch.utils import timing

        _window["spans"] = timing.take_spans()
        if _window["spans"] and trace is not None and trace.n:
            print("spans " + json.dumps(idle_table(_window["spans"],
                                                   trace)),
                  file=sys.stderr, flush=True)
    return _window["spans"]


def self_per(reading, names, per, scale=1.0):
    """``scale`` times the summed self seconds of the window's spans
    named in ``names``, over the count of its spans named ``per``; None
    where the window has none of either."""
    got = taken(reading.trace)
    if not got:
        return None
    if _window["table"] is None:
        _window["table"] = by_name(got)
    table = _window["table"]
    n = table.get(per, {}).get("n", 0)
    if n == 0 or not any(k in table for k in names):
        return None
    return scale * sum(table[k]["self_s"] for k in names if k in table) / n


def self_intervals(spans):
    """[(span, [(a, b), ...])]: each span with its interval less its
    children's, in ns."""
    kids = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    out = []
    for s in spans:
        a, pieces = s["start_ns"], []
        for c in sorted(kids.get(s["id"], ()), key=lambda c: c["start_ns"]):
            if c["start_ns"] > a:
                pieces.append((a, c["start_ns"]))
            a = max(a, c["end_ns"])
        if s["end_ns"] > a:
            pieces.append((a, s["end_ns"]))
        out.append((s, pieces))
    return out


class Idle:
    """The card's idle intervals in a window [t0_ns, t1_ns]: the window
    less the union of a devtrace.Trace's device intervals."""

    def __init__(self, trace, t0_ns, t1_ns):
        t0, t1 = int(t0_ns), int(t1_ns)
        if trace.n == 0:
            s, e = np.array([t0]), np.array([t1])
        else:
            reach = np.maximum.accumulate(trace.end)
            new = np.ones(trace.n, bool)
            new[1:] = trace.start[1:] > reach[:-1]
            first = np.nonzero(new)[0]
            busy_s = trace.start[first]
            busy_e = reach[np.r_[first[1:] - 1, trace.n - 1]]
            s = np.clip(np.r_[t0, busy_e], t0, t1)
            e = np.clip(np.r_[busy_s, t1], t0, t1)
        keep = e > s
        self.start, self.end = s[keep].astype(np.int64), e[keep].astype(
            np.int64)
        self.cum = np.r_[0, np.cumsum(self.end - self.start)]

    def total_s(self):
        return int(self.cum[-1]) / 1e9

    def upto(self, x):
        """Idle ns before each time in ``x`` (an array of ns)."""
        x = np.asarray(x, np.int64)
        j = np.searchsorted(self.start, x, side="right") - 1
        jc = np.maximum(j, 0)
        part = np.clip(x - self.start[jc], 0, self.end[jc] - self.start[jc]) \
            if len(self.start) else np.zeros_like(x)
        return np.where(j >= 0, self.cum[jc] + part, 0)

    def within(self, a, b):
        """Idle ns inside each interval [a, b]."""
        return self.upto(b) - self.upto(a)


def by_name(spans, idle=None):
    """{name: {"n", "self_s"}} (and "idle_s" where ``idle`` is an Idle of
    the window)."""
    out = {}
    for s, pieces in self_intervals(spans):
        row = out.setdefault(s["name"], {"n": 0, "self_s": 0.0})
        row["n"] += 1
        if idle is not None:
            row.setdefault("idle_s", 0.0)
        if pieces:
            a, b = np.array(pieces, np.int64).T
            row["self_s"] += int((b - a).sum()) / 1e9
            if idle is not None:
                row["idle_s"] += int(idle.within(a, b).sum()) / 1e9
    return out


def idle_table(spans, trace):
    """The card's idle seconds from the first span's start to the last
    one's end, the share of them inside the self intervals of the
    drivers' pieces of work (spans but ``CONTAINERS`` and phases), and
    ``by_name`` with idle seconds."""
    idle = Idle(trace, min(s["start_ns"] for s in spans),
                max(s["end_ns"] for s in spans))
    table = by_name(spans, idle)
    work = sum(r["idle_s"] for k, r in table.items()
               if k not in CONTAINERS and not k.startswith("phase."))
    return {"idle_s": idle.total_s(),
            "work_idle_share": work / max(idle.total_s(), 1e-12),
            "by_name": table}
