"""The permutation driver's stack compaction a chunk (engine/permute.py
``_stack_chunk``: ``st.rebuild`` and its ``build_hist_points``
uploads): the self time of the window's ``permute.compact`` spans over
its ``permute.chunk`` spans, in ms, on the host's clock
(portbench/spans.py)."""

from portbench import spans

UNIT = "ms"

spans.record()


def read(r):
    return spans.self_per(r, ("permute.compact",), "permute.chunk", 1e3)
