"""Roofline share of the bf16 window statistic (ops/window_clr.py,
csrc/window_clr.cu): its launches' least times (work.py, counted from
each call's shapes) over its device time in the trace, in percent."""

from portbench.work import roofline_share

UNIT = "%"
FAMILIES = ("window_clr",)


def read(r):
    return roofline_share(r, "window_clr")
