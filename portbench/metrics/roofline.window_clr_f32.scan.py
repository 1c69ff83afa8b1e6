"""Roofline share of the f32 window statistic of the scan's tie stage
(ops/window_clr.py, csrc/window_clr_f32.cu): its launches' least times
(work.py, counted from each call's shapes) over its device time in the
trace, in percent."""

from portbench.work import roofline_share

UNIT = "%"
FAMILIES = ("window_clr_f32",)


def read(r):
    return roofline_share(r, "window_clr_f32")
