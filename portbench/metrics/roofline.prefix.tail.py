"""Roofline share of the 1b one-hot prefix sum (ops/prefix_sums.py,
csrc/prefix_sums.cu): its launches' least times (work.py, counted from
each call's shapes) over its device time in the trace, in percent."""

from portbench.work import roofline_share

UNIT = "%"
FAMILIES = ("prefix",)


def read(r):
    return roofline_share(r, "prefix")
