"""The split's exchange a chunk (fscl_tpu_torch/parallel/shard.py
``gather_rows``: the gloo all-gather of a chunk's statistic maxima and
the wait for the slowest rank): the self time of rank 0's
``split.gather`` spans in the window over its ``permute.chunk`` spans,
in ms, on the host's clock (portbench/spans.py)."""

from portbench import spans

UNIT = "ms"

spans.record()


def read(r):
    return spans.self_per(r, ("split.gather",), "permute.chunk", 1e3)
