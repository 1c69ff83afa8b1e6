"""The card's idle time in the window over the statistic dispatches the
permutation driver made in it (engine/permute.py last_stats:
stack_dispatches + rdp_dispatches), in ms a dispatch."""

UNIT = "ms"


def read(r):
    n = (r.counters.get("stack_dispatches", 0)
         + r.counters.get("rdp_dispatches", 0))
    if n == 0 or r.trace.n == 0:
        return None
    return 1e3 * (r.trace.window_s - r.trace.busy_s()) / n
