"""Phase timing / tracing (the counterpart of fscl_tpu/utils/timing.py).

The reference's only observability is cr_logmsg progress lines and an unused
elapsed_time helper (SURVEY.md section 5).  Here: scoped phase timers that
report at MSG_DEBUG1, plus an opt-in hook into torch.profiler where the JAX
package uses jax.profiler (set FSCL_TPU_TRACE_DIR to write one Chrome
trace per phase, CPU and CUDA activity, into that directory).

A phase on a CUDA device ends with torch.cuda.synchronize(), so that its
time holds the card's work and not only its enqueue.  A phase inside
another is timed, and traced within the outer phase's trace (the
profiler does not nest).  add_time adds to the table without a log
line or a trace: the ``gather`` phase of a split run, one entry for each
of its many exchanges (parallel/shard.py).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .logging import MSG_DEBUG1, logmsg

_phases: dict[str, float] = {}
_trace_count = 0  # traces written, numbering the files
_tracing = False  # inside a traced phase


@contextlib.contextmanager
def _trace(name):
    """Profile the body into ``name``'s trace under FSCL_TPU_TRACE_DIR
    (nothing without it, or inside a traced phase)."""
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
        with profile(activities=activities) as prof:
            yield
    finally:
        _tracing = False
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def phase(name: str, device=None):
    """Time a pipeline phase; accumulates into the module-level table.
    ``device``: where the phase's work runs (a CUDA device is synchronised
    before the clock stops)."""
    sync = device is not None and torch.device(device).type == "cuda"
    t0 = time.monotonic()
    with _trace(name):
        yield
        if sync:
            torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    add_time(name, dt)
    logmsg(MSG_DEBUG1, "[timing] %s: %.2fs (cum %.2fs)", name, dt, _phases[name])


def add_time(name: str, seconds: float) -> None:
    """Add ``seconds`` to phase ``name`` in the table."""
    _phases[name] = _phases.get(name, 0.0) + seconds


def phase_report() -> dict:
    return dict(_phases)
