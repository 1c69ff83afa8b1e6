"""Scan and permutation engines of the port (hist and lattice paths)."""

from .permute import PermuteConfig, scan_permute  # noqa: F401
from .pvalues import chi2_tail_projection, empirical_pvalues  # noqa: F401
from .scan import ScanConfig, ScanResult, scan_genome  # noqa: F401
