"""fscl_tpu_torch: the PyTorch and CUDA port of fscl_tpu for NVIDIA Hopper.

The JAX package ``fscl_tpu`` is the reference; this package computes the
same scan and block-permutation test on one H100.  Layout mirrors
``fscl_tpu`` so each module's counterpart sits at the same path:

  - ``ops/``     hist tables (exact one-hot and SVD-compressed), run
                 geometry, the hist statistic, the block permutation
                 sigma, and the segmented prefix sums (one-hot counts and
                 weight-channel sums) whose CUDA kernels live in
                 ``csrc/``.
  - ``engine/``  the hist genome scan, the hist permutation driver with
                 >=20-exceedance pruning, p-values.
  - ``io/``      the SNP file reader and the result writers.

The host-only numpy layers are imported from the JAX package unchanged:
``fscl_tpu.models`` (background SFS, sweep tables), ``fscl_tpu.data``,
``fscl_tpu.utils.logging`` and ``fscl_tpu.sim``.  None of them imports
JAX, and this package never does either.

Every function takes its device explicitly.  ``cpu`` runs the plain
PyTorch versions of the kernels (the tests use it); ``cuda`` needs a
Hopper card and launches the hand-written kernels.
"""

from fscl_tpu import LOG_AD_MAX, LOG_AD_MIN  # noqa: F401

from . import device  # noqa: F401  (sets the float32 matmul precision)

__version__ = "0.1.0"


class NotPortedError(NotImplementedError):
    """A flag, input or code path of fscl_tpu that this port lacks yet."""
