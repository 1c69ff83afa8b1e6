"""Forward simulator of SNP frequency data (a copy of fscl_tpu/sim/sample.py,
without its command line), for the tests and chip_smoke.py."""

from .sample import (  # noqa: F401
    place_sweeps,
    random_ascertainment,
    sample_snps,
    simulate_dataset,
    standard_neutral_spectrum,
    subsample_ascertainment,
    write_snp_file,
)
