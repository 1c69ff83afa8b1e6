"""Command-line driver with the flags of fscl_tpu/cli.py, on PyTorch.

Pipeline (fscl.c:272-341): options -> SNP input -> background SFS ->
sweep-model tables -> null model -> scan -> permutations -> output.  -m
(ms input) runs the two-pass ms pipeline (io/ms_input.py) instead: the
background from all blocks, then each block scanned as its own
chromosome.  -b loads the background spectrum from a file and --output-bs
writes it (io/spectra_io.py).
``--device`` (default ``cuda``) picks where the scan and the permutations
run; ``cpu`` runs the plain PyTorch versions of the kernels.

Mixed-depth data (more than ROWS_MAX distinct table rows, up to
COMPRESS_ROWS_MAX) runs on the SVD-compressed hist tables where they
compress within tolerance; one large depth (up to WIDE_ROWS_MAX rows)
keeps exact one-hot tables.  --no-hist, and datasets past the hist
gate, run the per-site lattice path; its
packs are built only when a run takes it.  --checkpoint saves the
permutation state after every chunk and resumes from the file when it
exists (with -m, one file per block: FILE.block0, FILE.block1, ...).
At -v 4 the phases (load, tables, scan, permute, output, and
lattice-pack where a run builds the packs) log their times
(utils/timing.py), and the run ends with one ``[split]`` line a rank:
its phase times, its gathers' wall and bytes, and its kernel launches.

``python -m torch.distributed.run --standalone --nproc-per-node N -m
fscl_tpu_torch ...`` splits the scan's candidates and the permutations'
replicates over N ranks (parallel/; ``--device cuda`` puts rank r on
card r, ``--device cuda:0`` puts every rank on card 0).  Every rank
reads the input and reaches the same result; rank 0 alone writes the
output, ``--output-bs``, the checkpoint and the status lines, and the
other ranks log warnings and errors only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import __version__
from .engine import PermuteConfig, ScanConfig, scan_genome, scan_permute
from .io import (load_snp_input, load_spectra, scan_output,
                 write_null_distribution, write_spectra)
from .models import background_fsp, build_tables
from .models.tables import DEFAULT_GRID_POINTS
from .parallel import close_split, init_split
from .parallel.mesh import SOLO
from .utils.logging import (MSG_DEBUG1, MSG_ERROR, MSG_STATUS,
                            configure_logmsg, logmsg)
from .utils.timing import phase, phase_report


def build_parser():
    p = argparse.ArgumentParser(
        prog="fscl-tpu-torch",
        description="frequency-spectrum composite-likelihood sweep scan "
        "(PyTorch/CUDA port of fscl-tpu)",
    )
    a = p.add_argument
    a("-f", "--snpfile", help="File name of file with SNP frequency data")
    a("-d", "--asc-depth", type=int, default=0, help="Depth of SNP ascertainment sample")
    a("--asc-minimum-freq", type=int, default=1,
      help="minimum number of observations of both alleles for SNP ascertainment")
    a("-p", "--n-permute", type=int, default=0,
      help="number of snp block permutations for p-value computations")
    a("--permute-nbp", type=float, default=0.1,
      help="probability for switching to a new snp block for permutations")
    a("--n-threads", type=int, default=1,
      help="accepted for compatibility; parallelism is device-level")
    a("-a", "--alpha-factor", type=float, default=1.0,
      help="multiply 1/alpha by this factor to determine single sweep window size")
    a("-g", "--fine-grid-spacing", type=int, default=1000,
      help="Spacing of candidate sweep points along the chromosome (in bp)")
    a("-G", "--coarse-grid-spacing", type=int, default=100000,
      help="Size of coarse grid in which CLR maxima will be selected")
    a("-w", "--sweep-width", type=float, default=1.0,
      help="maximum width of sweep effect in scanning, in Mb")
    a("--minimum-depth", type=int, default=5,
      help="minimum depth of sample (lower depth SNPs ignored)")
    a("-m", "--msfile", help="Name of an ms output file")
    a("--ms-segment-length", type=int, default=0,
      help="Length in bp of simulated ms segments (use with -m option only)")
    a("--ms-folded", action="store_true", help="For ms input, treat all sites as folded")
    a("--max-only", action="store_true",
      help="output only the maximum CLR")
    a("--ms-sample-first", type=int, default=0,
      help="index of first chromosome in ms sample to analyze")
    a("--ms-sample-size", type=int, default=0,
      help="number of consecutive chromosomes in ms output to take as the sample")
    a("--force-neutral-spectrum", action="store_true",
      help="Do not estimate background spectrum from the data. Use sum(1/i)/i")
    a("-b", "--background-spectrum",
      help="Load the background frequency spectrum from a file")
    a("--output-bs", help="write estimated background site-frequency spectra "
      "to file")
    a("--include-invariant", action="store_true",
      help="Include invariant sites in analysis (default is to ignore them)")
    a("--splines", type=int, default=0,
      help="compatibility alias: spline knot count; mapped to --grid-points")
    a("--grid-points", type=int, default=DEFAULT_GRID_POINTS,
      help="dense log(alpha*d) grid resolution for the sweep-model tables")
    a("--prepend-label", help="optional token to prepend to each line of the output")
    a("-v", "--verbosity", type=int, default=3,
      help="verbosity level 0-5, default 3, debug 4 and above")
    a("-o", "--output-file", help="output file for scan results")
    a("--no-scan", action="store_true",
      help="do not scan chromosome, compute background frequency spectrum only")
    a("--ascbias-background-only", action="store_true",
      help="correct for ascertainment bias only in estimating the background "
      "site frequency spectrum")
    a("--eval-range", type=int, default=81920,
      help="+- SNPs in each candidate evaluation window")
    a("--bp-resl", type=int, default=128, help="position refinement resolution (bp)")
    a("--chunk", type=int, default=32, help="accepted for compatibility: the lattice "
      "kernel takes a stage's candidates in one launch")
    a("--chunk-replicates", type=int, default=16,
      help="permutation replicates evaluated per device round")
    a("--seed", type=int, default=0xFD821A6,
      help="RNG seed (reference default is this hard-coded value, fscl.c:134)")
    a("--no-refine", action="store_true", help="skip bp_resl position refinement")
    a("--no-hist", action="store_true",
      help="per-site lattice kernel everywhere")
    a("--checkpoint", help="permutation checkpoint file: saved after every "
      "chunk, resumed from when it exists")
    a("--compat-mirror-unfolded", action="store_true",
      help="replicate the reference's mirrored accumulation of unfolded sites "
      "in the background spectrum (for parity testing)")
    a("--device", default="cuda",
      help="cuda (a Hopper card, default; under torch.distributed.run, "
      "card LOCAL_RANK), cuda:N (card N, for every rank) or cpu (plain "
      "PyTorch versions)")
    a("--version", action="version", version=f"fscl-tpu-torch {__version__}")
    return p


def validate_args(args):
    stop = []
    configure_logmsg(max(args.verbosity, 0))
    if args.minimum_depth < 5:
        args.minimum_depth = 5
    if args.splines:
        if args.splines < 200:
            stop.append("must use at least 200 spline functions / grid points")
        args.grid_points = max(args.splines + 1, args.grid_points)
    if not args.snpfile and not args.msfile:
        stop.append("input snp frequency file or ms file not specified (use -f or -m)")
    if args.snpfile and args.msfile:
        stop.append("specify either a snp frequency file or an ms file, not both")
    if not args.output_file:
        stop.append("specify an output file name with -o option")
    if args.ms_segment_length and not args.msfile:
        logmsg(MSG_ERROR, "--ms-segment-length ignored without -m")
        args.ms_segment_length = 0
    if args.asc_depth == 1 or args.asc_depth < 0:
        stop.append("if specified, ascertainment sample depth must be at least 2")
    if args.asc_depth >= 2 and args.asc_minimum_freq > 2 * args.asc_depth:
        stop.append("SNP ascertainment impossible with these asc settings")
    if args.asc_depth >= 2 and args.asc_minimum_freq == 0:
        args.asc_minimum_freq = 1
    if args.fine_grid_spacing < 1 and not args.output_bs:
        stop.append("specify sweep position grid spacing with -g option (in bp)")
    if (
        not args.output_bs
        and args.fine_grid_spacing >= 1
        and args.coarse_grid_spacing % args.fine_grid_spacing != 0
    ):
        stop.append("fine grid spacing must evenly divide coarse grid spacing")
    if stop:
        for s in stop:
            logmsg(MSG_ERROR, "Error: %s", s)
        raise SystemExit(255)
    return args


def model_tables(data, args, split=SOLO):
    """The background spectrum of ``data`` (loaded with -b, written with
    --output-bs by the writing rank) and the sweep-model tables built on
    it; None with --no-scan.  The -f and -m pipelines both start here."""
    loaded = (load_spectra(args.background_spectrum)
              if args.background_spectrum else None)
    fsp = background_fsp(
        data.obs_freq,
        data.depth_p,
        data.folded,
        data.sample_depths,
        force_neutral_spectrum=args.force_neutral_spectrum,
        loaded_spectra=loaded,
        include_invariant=args.include_invariant,
        compat_mirror_unfolded=args.compat_mirror_unfolded,
    )
    if args.output_bs and split.writer:
        write_spectra(args.output_bs, data.sample_depths, fsp)
    if args.no_scan:
        return None
    logmsg(MSG_STATUS, "Computing sweep models for all sample depths")
    with phase("tables"):
        return build_tables(
            fsp,
            data.sample_depths,
            grid_points=args.grid_points,
            asc_depth=args.asc_depth,
            asc_min_freq=args.asc_minimum_freq,
            ascbias_background_only=args.ascbias_background_only,
            include_invariant=args.include_invariant,
        )


def scan_configs(args):
    """(ScanConfig, PermuteConfig or None without -p) from the flags, the
    same in -f and -m modes (fscl.c:281-314 passes the same globals)."""
    scan_cfg = ScanConfig(
        eval_range=args.eval_range,
        bp_resl=args.bp_resl,
        small_grid_sp=args.fine_grid_spacing,
        large_grid_sp=args.coarse_grid_spacing,
        chunk=args.chunk,
        refine=not args.no_refine,
        use_hist=not args.no_hist,
    )
    if args.n_permute <= 0:
        return scan_cfg, None
    return scan_cfg, PermuteConfig(
        n_permute=args.n_permute,
        permute_nbp=args.permute_nbp,
        scan_width_mb=args.sweep_width,
        chunk_replicates=args.chunk_replicates,
        seed=args.seed,
        alpha_factor=args.alpha_factor,
        checkpoint_path=args.checkpoint,
        use_hist=not args.no_hist,
    )


def run_pipeline(data, args, device, split=SOLO):
    """background -> tables -> scan -> permute for one dataset (this
    rank's share of it under a split)."""
    tables = model_tables(data, args, split)
    if tables is None:
        return None
    data.attach_model(tables)
    scan_cfg, perm_cfg = scan_configs(args)
    with phase("scan", device):
        result = scan_genome(data, tables, scan_cfg, device=device,
                             split=split)
    if perm_cfg is not None:

        def dump():
            if split.writer:
                scan_output(args.output_file, data, result, False,
                            args.n_permute, args.prepend_label)
                write_null_distribution(args.output_file, data, result)

        with phase("permute", device):
            scan_permute(data, tables, result, scan_cfg, perm_cfg,
                         dump_fn=dump, device=device, split=split)
    return result


def split_report(split):
    """One ``[split]`` line a rank at -v 4, logged by rank 0: the rank's
    device, phase times (utils/timing.py, the gathers under ``gather``),
    split_gather_s and split_gather_bytes over the run, and its kernel
    launches (kernels.launch_counts)."""
    from . import kernels
    from .parallel import shard

    mine = dict(rank=split.rank, world=split.world, pid=os.getpid(),
                device=str(split.device), phases=phase_report(),
                split_gather_s=shard.stats["gather_s"],
                split_gather_bytes=shard.stats["gather_bytes"],
                split_gathers=shard.stats["gathers"],
                launches=kernels.launch_counts())
    for rep in shard.gather_objects(mine, split):
        logmsg(MSG_DEBUG1, "[split] %s", json.dumps(rep, sort_keys=True))


def main(argv=None):
    args = validate_args(build_parser().parse_args(argv))
    split = init_split(args.device)
    try:
        configure_logmsg(max(args.verbosity, 0), split.rank)
        _run(args, split)
        if args.verbosity >= MSG_DEBUG1:
            split_report(split)
    finally:
        close_split(split)
    return 0


def _run(args, split):
    device = split.device
    if args.msfile:
        from .io.ms_input import ms_pipeline

        return ms_pipeline(args, device, split)
    with phase("load"):
        data = load_snp_input(
            args.snpfile,
            include_invariant=args.include_invariant,
            minimum_obs_depth=args.minimum_depth,
        )
    result = run_pipeline(data, args, device, split)
    if result is not None and split.writer:
        with phase("output"):
            scan_output(
                args.output_file,
                data,
                result,
                maximum_only=args.max_only,
                n_permute=args.n_permute,
                prepend_label=args.prepend_label,
            )
            if args.n_permute > 0:
                write_null_distribution(args.output_file, data, result)


if __name__ == "__main__":
    sys.exit(main())
