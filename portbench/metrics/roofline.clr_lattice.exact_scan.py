"""Roofline share of the per-site lattice CLR (ops/lattice.py,
csrc/lattice_clr.cu): its launches' least times (work.py, counted from
each call's shapes) over its device time in the trace, in percent."""

from portbench.work import roofline_share

UNIT = "%"
FAMILIES = ("clr_lattice",)


def read(r):
    return roofline_share(r, "clr_lattice")
