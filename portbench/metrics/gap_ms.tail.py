"""The mean idle gap between consecutive device events of the window
(0 where one overlaps the one before), in ms: the host's launch pace
against the card's in the permutation driver (engine/permute.py)."""

UNIT = "ms"


def read(r):
    g = r.trace.gaps_ns()
    if len(g) == 0:
        return None
    return float(g.mean()) / 1e6
