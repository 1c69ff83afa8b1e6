"""Phase timing and the drivers' spans (the counterpart of
fscl_tpu/utils/timing.py).

The reference's only observability is cr_logmsg progress lines and an unused
elapsed_time helper (SURVEY.md section 5).  Here: scoped phase timers that
report at MSG_DEBUG1, plus an opt-in hook into torch.profiler where the JAX
package uses jax.profiler (set FSCL_TPU_TRACE_DIR to write one Chrome
trace per phase, CPU and CUDA activity, into that directory).

A phase on a CUDA device ends with torch.cuda.synchronize(), so that its
time holds the card's work and not only its enqueue.  A phase inside
another is timed, and traced within the outer phase's trace (the
profiler does not nest).

Spans time the host's work inside a step without waiting for the card:
``span(name, **attrs)`` around a piece of a driver, ``step=True`` on the
span of one ``scan_genome`` or ``scan_permute`` call, which numbers the
step every span inside it carries.  Off (the default) a span is one
shared no-op context: it reads no clock, makes no profiler call and
keeps nothing.  The
recorder (``start_spans()`` ... ``take_spans()``) keeps each span's name,
start and end, its id, its parent's id, its step and its attributes in
memory until they are taken.  Starts and ends are ``time.time_ns()``,
the unix-epoch clock on which torch.profiler stamps its events, host and
device, so a span and the card's intervals compare directly.  Inside a
profiler of this module (a FSCL_TPU_TRACE_DIR phase, or ``annotating()``)
each span also opens a ``record_function`` range of its name, so the
Chrome traces show the drivers' spans.  A span with ``table=`` is timed
always, on ``time.monotonic()`` as the phases are, and adds its seconds
(``.seconds``) to that entry of the phase table (the split's gathers,
parallel/shard.py).  Spans nest on one thread: the
drivers' host thread.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

from .logging import MSG_DEBUG1, logmsg

_phases: dict[str, float] = {}
_trace_count = 0  # traces written, numbering the files
_tracing = False  # inside a traced phase

_spans: list | None = None  # the recorder's spans while it is on
_annotate = False  # spans open record_function ranges
_live = False  # _spans is not None or _annotate
_open: list = []  # ids of the open spans, innermost last
_next_id = 0
_step = 0  # id of the innermost open step span (0: none)


def _set(spans, annotate):
    global _spans, _annotate, _live
    _spans, _annotate = spans, annotate
    _live = spans is not None or annotate


class _Noop:
    """The span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "attrs", "table", "is_step", "id", "parent",
                 "outer_step", "t0", "m0", "seconds", "_rf")

    def __init__(self, name, attrs, table, is_step):
        self.name, self.attrs, self.table = name, attrs, table
        self.is_step = is_step
        self._rf = None

    def set(self, **attrs):
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        global _next_id, _step
        _next_id += 1
        self.id = _next_id
        self.parent = _open[-1] if _open else 0
        if self.is_step:
            self.outer_step, _step = _step, self.id
        _open.append(self.id)
        if _annotate:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self.table is not None:
            self.m0 = time.monotonic()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _step
        t1 = time.time_ns()
        if self.table is not None:
            self.seconds = time.monotonic() - self.m0
            _phases[self.table] = _phases.get(self.table, 0.0) + self.seconds
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _open.pop()
        step = _step
        if self.is_step:
            _step = self.outer_step
        if _spans is not None:
            _spans.append((self.name, self.t0, t1, self.id, self.parent,
                           step, self.attrs))
        return False


def span(name: str, *, step: bool = False, table: str | None = None,
         **attrs):
    """A context timing one piece of a driver (module doc).  ``step``: the
    span of one scan_genome or scan_permute call; ``table``: an entry of
    the phase table the span's seconds add to, on or off; ``attrs``: what
    the recorder keeps beside it (more by ``.set(**attrs)`` inside)."""
    if not _live and table is None:
        return _NOOP
    return _Span(name, attrs, table, step)


def traced(name: str, step: bool = False):
    """Decorator: each call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, step=step):
                return fn(*args, **kwargs)

        return call

    return wrap


def start_spans() -> None:
    """Turn the recorder on, from no spans."""
    _set([], _annotate)


def take_spans() -> list[dict]:
    """The spans closed since start_spans(), in the order they closed,
    and turn the recorder off: each {"name", "start_ns", "end_ns", "id",
    "parent" (0 at the top), "step" (0 outside any step), "attrs"}."""
    got = _spans or []
    _set(None, _annotate)
    return [dict(name=n, start_ns=a, end_ns=b, id=i, parent=p, step=s,
                 attrs=at) for n, a, b, i, p, s, at in got]


@contextlib.contextmanager
def annotating():
    """Spans open record_function ranges of their names while the body
    runs (for a torch.profiler the caller runs around it)."""
    prev = _annotate
    _set(_spans, True)
    try:
        yield
    finally:
        _set(_spans, prev)


@contextlib.contextmanager
def _trace(name):
    """Profile the body into ``name``'s trace under FSCL_TPU_TRACE_DIR
    (nothing without it, or inside a traced phase), the spans annotated."""
    global _trace_count, _tracing
    trace_dir = os.environ.get("FSCL_TPU_TRACE_DIR")
    if not trace_dir or _tracing:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    _trace_count += 1
    path = os.path.join(trace_dir, f"{name}.{os.getpid()}.{_trace_count}"
                        ".pt.trace.json")
    _tracing = True
    try:
        with profile(activities=activities) as prof, annotating():
            yield
    finally:
        _tracing = False
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def phase(name: str, device=None):
    """Time a pipeline phase; accumulates into the module-level table, and
    is the span ``phase.<name>`` where spans are on.  ``device``: where
    the phase's work runs (a CUDA device is synchronised before the clock
    stops)."""
    sync = device is not None and torch.device(device).type == "cuda"
    t0 = time.monotonic()
    with span(f"phase.{name}"), _trace(name):
        yield
        if sync:
            torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    _phases[name] = _phases.get(name, 0.0) + dt
    logmsg(MSG_DEBUG1, "[timing] %s: %.2fs (cum %.2fs)", name, dt, _phases[name])


def phase_report() -> dict:
    return dict(_phases)
