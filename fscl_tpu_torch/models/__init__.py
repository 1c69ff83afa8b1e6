"""Sweep-model construction on the host (numpy and scipy, float64).

A copy of fscl_tpu/models, so that the port imports nothing of the JAX
package: background spectra, ascertainment bias, post-sweep spectra and
the packed ``SweepModelTables``.
"""

from .special import log_fact, lchoose  # noqa: F401
from .background import (  # noqa: F401
    neutral_spectra,
    estimate_background_fsp,
    hypergeometric_downsample,
    background_fsp,
)
from .ascbias import (  # noqa: F401
    ascprob_subsample,
    ascbias_adjust_background,
    ascbias_adjust_expect,
)
from .sweep import (  # noqa: F401
    p_kescape_grid,
    compute_pjh,
    compute_pbk,
    post_sweep_spectra,
    compute_sweep_logprob_grid,
)
from .tables import SweepModelTables, build_tables  # noqa: F401
