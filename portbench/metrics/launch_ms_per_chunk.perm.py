"""The permutation driver's launches a chunk (engine/permute.py): the
self time of the window's ``permute.draw`` (the sigma draw),
``permute.stat`` (the statistic's launches) and ``permute.speculate``
(the next chunk's dispatch) spans over its ``permute.chunk`` spans, in
ms, on the host's clock (portbench/spans.py)."""

from portbench import spans

UNIT = "ms"

spans.record()


def read(r):
    return spans.self_per(
        r, ("permute.draw", "permute.stat", "permute.speculate"),
        "permute.chunk", 1e3)
