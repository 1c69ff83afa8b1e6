"""Rank 0's main-thread CPU time in the window over the statistic
dispatches its permutation driver made in it (engine/permute.py
last_stats: stack_dispatches + rdp_dispatches), in ms a dispatch: the
host driver's own work a chunk under the split, which every rank
repeats, and which time that other tasks hold the core does not move."""

UNIT = "ms"


def read(r):
    n = (r.counters.get("stack_dispatches", 0)
         + r.counters.get("rdp_dispatches", 0))
    if n == 0 or "main_cpu_s" not in r.host:
        return None
    return 1e3 * r.host["main_cpu_s"] / n
