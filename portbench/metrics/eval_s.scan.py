"""The host's enqueue of every chromosome's statistic in the scan's stages
(engine/scan.py, ``_device_points`` included): the self time of the
window's ``scan.eval`` spans over its ``scan.genome`` spans, in s a
scan, on the host's clock (portbench/spans.py)."""

from portbench import spans

UNIT = "s"

spans.record()


def read(r):
    return spans.self_per(r, ("scan.eval",), "scan.genome")
