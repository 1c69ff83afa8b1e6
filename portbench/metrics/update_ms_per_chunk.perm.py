"""The permutation driver's own time in ``_apply_round_updates`` a
chunk (engine/permute.py): the self time of the window's
``permute.update`` spans over its ``permute.chunk`` spans, in ms, on the
host's clock (portbench/spans.py)."""

from portbench import spans

UNIT = "ms"

spans.record()


def read(r):
    return spans.self_per(r, ("permute.update",), "permute.chunk", 1e3)
