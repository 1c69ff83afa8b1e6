"""Rank 0's card's idle share of the window: 1 - the union of its device
events over the window's length (torch.profiler's trace of the harness's
process, which is rank 0), in percent."""

UNIT = "%"


def read(r):
    if r.trace.n == 0:
        return None
    return r.trace.idle_share()
