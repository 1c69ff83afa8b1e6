"""The scan's tables and prefixes for a cold data object (engine/scan.py
``make_scan_hist_tables``, ``_FusedHistEval``): the self time of the
window's ``scan.tables`` spans over its ``scan.genome`` spans, in s a
scan, on the host's clock (portbench/spans.py)."""

from portbench import spans

UNIT = "s"

spans.record()


def read(r):
    return spans.self_per(r, ("scan.tables",), "scan.genome")
