"""Frozen copy of fscl_tpu_torch/models (special, background, ascbias,
sweep, tables): the background spectrum, the post-sweep spectra and the
packed sweep-model tables, NumPy and SciPy in float64.  A later change to
the program's models does not move the benchmark's inputs or reference.
"""

LOG_AD_MIN = -20.0  # sweep-model grid domain in log(alpha*distance)
LOG_AD_MAX = 4.0

from .background import background_fsp  # noqa: E402,F401
from .tables import build_tables  # noqa: E402,F401
