"""fscl_tpu_torch: the PyTorch and CUDA port of fscl_tpu for NVIDIA Hopper.

The JAX package ``fscl_tpu`` is the reference; this package computes the
same scan and block-permutation test on one H100.  Layout mirrors
``fscl_tpu`` so each module's counterpart sits at the same path:

  - ``ops/``     hist tables (exact one-hot and SVD-compressed), run
                 geometry, the hist statistic (from per-replicate prefix
                 sums, or run-decomposed from one site prefix), the block
                 permutation sigma and its runs, and the prefix sums
                 (segmented one-hot counts, weight-channel sums, row-id
                 counts) whose CUDA kernels live in ``csrc/``.
  - ``engine/``  the hist genome scan, the hist permutation driver with
                 >=20-exceedance pruning and its run-decomposed pruning
                 tail, p-values.
  - ``io/``      the SNP file reader and the result writers.
  - ``models/``, ``data.py``, ``utils/logging.py``, ``sim/``: host numpy
                 code copied from the JAX package (sweep-model tables, the
                 dataset container, logging, the simulator).

The package stands alone: it imports neither ``jax`` nor anything of
``fscl_tpu``.

Every entry point takes its device, ``cuda`` by default: a Hopper card,
on which the hand-written kernels launch, or a RuntimeError where there
is none.  ``cpu`` must be asked for; it runs the plain PyTorch versions
of the kernels (the tests use it).
"""

from . import device  # noqa: F401  (sets the float32 matmul precision)

__version__ = "0.1.0"

LOG_AD_MIN = -20.0  # sweep-model grid domain in log(alpha*distance)
LOG_AD_MAX = 4.0


class NotPortedError(NotImplementedError):
    """A flag, input or code path of fscl_tpu that this port lacks yet."""
