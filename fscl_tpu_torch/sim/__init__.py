"""Simulators (copies of fscl_tpu/sim/): the forward simulator of SNP
frequency data (sample.py, without its command line), for the tests and
chip_smoke.py, and the ascertainment-biased ms-format generator
(ascbias_segments.py, the reference's ascbias-segments binary, runnable
as ``python -m fscl_tpu_torch.sim.ascbias_segments``)."""

from .sample import (  # noqa: F401
    place_sweeps,
    random_ascertainment,
    sample_snps,
    simulate_dataset,
    standard_neutral_spectrum,
    subsample_ascertainment,
    write_snp_file,
)
