"""ms-driven ascertainment-bias test-data generator (a copy of
fscl_tpu/sim/ascbias_segments.py on the port's own io/ms_parser.py).

Equivalent of the reference's ascbias-segments binary
(/root/reference/ascbias-segments.c): per 1-Mb segment, run Hudson's `ms`
with linearly varying recombination rho (ascbias-segments.c:199-221), apply a
K-of-M ascertainment rule to the simulated haplotypes — keep a site when the
first ``asc_depth`` haplotypes are polymorphic (optionally requiring >= 2
copies of each allele, the "double-hit" rule, ascbias-segments.c:78-110) —
adaptively tune an oversampling factor to hit a target SNP count
(ascbias-segments.c:177-231), and emit a synthetic ms-format stream for
consumption by the -m scan path.  Run as
``python -m fscl_tpu_torch.sim.ascbias_segments``.

When `ms` is not installed, a neutral no-LD block source draws site
frequencies from the 1/i spectrum and scatters derived alleles uniformly —
sufficient for exercising the ascertainment/tuning logic in tests (the
reference hard-requires ms; SURVEY.md section 3.5 marks this as the only
process boundary in the reference).
"""

from __future__ import annotations

import argparse
import shutil
import sys

import numpy as np

from ..io.ms_parser import MsBlock, msparser_execute


def neutral_block_source(rng):
    """Fallback block source: neutral 1/i site frequencies, no LD."""

    def source(sample_size, n_snps, segment_rho, length_bp):
        i = np.arange(1, sample_size)
        w = (1.0 / i) / (1.0 / i).sum()
        freqs = rng.choice(i, p=w, size=n_snps)
        haps = np.zeros((sample_size, n_snps), dtype=np.uint8)
        for j, f in enumerate(freqs):
            haps[rng.choice(sample_size, size=f, replace=False), j] = 1
        pos = np.sort(rng.random(n_snps))
        return MsBlock(segments=[], prob=0.0, positions=pos, haplotypes=haps)

    return source


def ms_block_source():
    """Run the real `ms` binary per segment (ascbias-segments.c:199-221)."""

    def source(sample_size, n_snps, segment_rho, length_bp):
        cmd = f"ms {sample_size} 1 -s {n_snps} -r {segment_rho:1.1f} {int(length_bp)}"
        parser, proc = msparser_execute(cmd)
        blk = parser.next_block()
        proc.wait()
        if blk is None:
            raise RuntimeError(f"ms execution failed: {cmd}")
        return blk

    return source


def extract_snps(blk, s_pos, segment_length, asc_depth, double_hit):
    """Apply the K-of-M ascertainment rule (ascbias-segments.c:78-110).

    Returns (pos, alleles[k, n_hap]) of retained sites.
    """
    haps = blk.haplotypes
    if asc_depth > 0:
        d = haps[:asc_depth, :].sum(axis=0).astype(np.int64)
        if double_hit:
            keep = (d > 1) & (d < asc_depth - 1)
        else:
            keep = (d > 0) & (d < asc_depth)
    else:
        keep = np.ones(blk.n_poly, dtype=bool)
    pos = (s_pos + blk.positions[keep] * segment_length).astype(np.int64)
    return pos, haps[:, keep].T.copy()


def draw_samples(
    out,
    n_repl,
    sample_size,
    mb_length,
    n_snps,
    asc_depth,
    double_hit,
    rho_mb,
    rho_std,
    block_source=None,
    seed=0,
):
    """Generate n_repl ascertained replicates as an ms-format stream."""
    rng = np.random.default_rng(seed)
    if block_source is None:
        block_source = (
            ms_block_source() if shutil.which("ms") else neutral_block_source(rng)
        )

    ms_segments = int(mb_length)
    ms_length_bp = mb_length / ms_segments * 1e6
    mean_rho = rho_mb * (ms_length_bp / 1e6)
    stdv_rho = rho_std * (ms_length_bp / 1e6)

    out.write(
        f"ms {sample_size} {n_repl} -s {n_snps} -r {rho_mb * mb_length:1.1f} "
        f"{int(mb_length * 1e6)}\n"
    )
    out.write(f"{rng.integers(1 << 31)} {rng.integers(1 << 31)} {rng.integers(1 << 31)}\n")

    asc_factor = 1.0 + (12.0 / asc_depth if asc_depth > 0 else 0.0)
    done = 0
    while done < n_repl:
        per_seg = int(n_snps / ms_segments * asc_factor + 1)
        all_pos, all_alleles = [], []
        for b in range(ms_segments):
            # linear rho ramp across segments (ascbias-segments.c:202)
            segment_rho = (mean_rho - stdv_rho) + (
                2 * stdv_rho
            ) * b / ms_segments
            blk = block_source(sample_size, per_seg, max(segment_rho, 0.0),
                               ms_length_bp)
            pos, alleles = extract_snps(
                blk, b * ms_length_bp, ms_length_bp, asc_depth, double_hit
            )
            all_pos.append(pos)
            all_alleles.append(alleles)
        pos = np.concatenate(all_pos)
        alleles = np.vstack(all_alleles) if len(all_pos) else np.zeros((0, sample_size))

        k = len(pos)
        if k < n_snps:
            asc_factor *= 2.0  # not enough ascertained SNPs; oversample more
            continue
        if k > n_snps * 2.0:
            asc_factor *= 0.67
        # uniform thinning to exactly n_snps, order by position
        pick = np.sort(rng.choice(k, size=n_snps, replace=False))
        pos, alleles = pos[pick], alleles[pick]
        order = np.argsort(pos, kind="stable")
        pos, alleles = pos[order], alleles[order]

        out.write("\n//\n")
        out.write(f"segsites: {n_snps}\n")
        out.write(
            "positions: "
            + " ".join(f"{p / (mb_length * 1e6):1.8e}" for p in pos)
            + "\n"
        )
        for j in range(sample_size):
            out.write("".join(chr(ord("0") + int(v)) for v in alleles[:, j]) + "\n")
        done += 1
    out.flush()


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="fscl-tpu-torch-ascbias-segments",
        description="generate ascertainment-biased ms-format test data",
    )
    p.add_argument("-r", "--rho-Mb", type=float, default=100.0, dest="rho_mb")
    p.add_argument("--rho-stdv", type=float, default=0.0)
    p.add_argument("-l", "--mb-length", type=int, default=25)
    p.add_argument("-n", "--sample-size", type=int, default=128)
    p.add_argument("-d", "--asc-depth", type=int, default=0)
    p.add_argument("-s", "--n-snps", type=int, default=4000)
    p.add_argument("-N", "--n-repl", type=int, default=100)
    p.add_argument("--double-hit", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--output", default="-")
    args = p.parse_args(argv)

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        draw_samples(
            out, args.n_repl, args.sample_size, args.mb_length, args.n_snps,
            args.asc_depth, args.double_hit, args.rho_mb, args.rho_stdv,
            seed=args.seed,
        )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
