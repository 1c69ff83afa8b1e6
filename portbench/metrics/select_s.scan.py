"""The numpy selection between the scan's stages (engine/scan.py): the
self time of the window's ``scan.select`` spans over its
``scan.genome`` spans, in s a scan, on the host's clock
(portbench/spans.py)."""

from portbench import spans

UNIT = "s"

spans.record()


def read(r):
    return spans.self_per(r, ("scan.select",), "scan.genome")
