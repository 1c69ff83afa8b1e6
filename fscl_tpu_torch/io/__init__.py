"""SNP and ms readers, spectrum files and result writers (numpy copies
of fscl_tpu.io)."""

from .output import scan_output, write_null_distribution  # noqa: F401
from .snp_reader import load_snp_input  # noqa: F401
from .spectra_io import load_spectra, write_spectra  # noqa: F401
