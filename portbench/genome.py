"""The inputs of a cell, made from ``--seed``: a genome of SNP sites drawn
by the frozen simulator (ref/sim.py) under the sweep model, as the
configuration file states it.

Two ways to make the sites from ``--seed``, which the traffic file
names ("sites"):

  shuffled  the configuration's ``data_seed`` draws one base genome, each
            chromosome from its own generator seeded by (data_seed,
            chromosome), and ``--seed`` shuffles the order of the
            chromosomes.  Every seed scans the same sites; what moves with
            the seed is the genome coordinate, and with it the
            permutation stream's blocks.  The permutation mixes use it:
            which intervals stay significant decides their work, and a
            genome per seed moved that work by up to 14% (PERF.md §6).
  per_seed  every chromosome is drawn anew from (--seed, chromosome), in
            the configuration's order.  The sizes stay (chromosome lengths,
            density, depth, sweeps), the sites and their spectrum move.
            The scan mixes use it: a scan's work follows the sizes.

Either way the same seed gives the same genome.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ref.sim import place_sweeps, sample_snps, standard_neutral_spectrum


@dataclasses.dataclass
class Genome:
    """Sites sorted by (chromosome, position), chromosomes in file order."""

    chrom: list  # chromosome names, one per chromosome
    start: np.ndarray  # [n_chr] first site index of each chromosome
    count: np.ndarray  # [n_chr] sites of each chromosome
    pos: np.ndarray  # [W] int64 bp
    freq: np.ndarray  # [W] int64 derived-allele count
    depth: int  # sample depth of every site (unfolded)

    @property
    def n_sites(self):
        return int(self.pos.shape[0])

    def chrom_slice(self, c):
        return slice(int(self.start[c]), int(self.start[c] + self.count[c]))

    def genome_pos(self):
        """Monotone genome coordinate: each chromosome's positions from
        its first site, offset past the previous chromosome's last site
        (the block permutation runs over the concatenated genome)."""
        g = np.empty(self.n_sites, np.int64)
        off = 0
        for c in range(len(self.chrom)):
            sl = self.chrom_slice(c)
            p = self.pos[sl]
            g[sl] = p - p[0] + off
            off += int(p[-1] - p[0]) + 1
        return g


def seed_entropy(seed):
    """A non-negative entropy word for numpy's SeedSequence from any
    integer seed."""
    return int(seed) & ((1 << 64) - 1)


def base_chromosome(cfg, c, seed=None):
    """(pos, freq) of chromosome c of the configuration's base genome, or
    of the genome drawn from ``seed`` where it is given."""
    n = int(cfg["sample_size"])
    bp = int(cfg["chromosome_bp"][c])
    words = ([seed_entropy(cfg["data_seed"]), c] if seed is None
             else [seed_entropy(seed), 0x517E5, c])
    rng = np.random.default_rng(words)
    n_snps = int(cfg["snp_density_per_kb"] * bp / 1000.0)
    spos, salpha = place_sweeps(int(cfg["sweeps_per_chromosome"]), bp,
                                float(cfg["sweep_alpha"]))
    pos, freq = sample_snps(rng, n_snps, bp, spos, salpha,
                            standard_neutral_spectrum(n), n,
                            int(cfg["sim_grid_points"]))
    keep = freq >= int(cfg["min_derived_count"])
    return pos[keep], freq[keep]


def make_genome(cfg, seed, sites="shuffled"):
    """The configuration's genome for ``seed`` (cfg: the config file's
    dict; ``sites``: "shuffled" or "per_seed", as above)."""
    n_chr = len(cfg["chromosome_bp"])
    if sites == "shuffled":
        order = np.random.default_rng([seed_entropy(seed), 1]).permutation(
            n_chr)
        draw = None
    elif sites == "per_seed":
        order, draw = np.arange(n_chr), seed
    else:
        raise ValueError(f"unknown sites {sites!r}")
    pos_l, freq_l, counts = [], [], []
    for c in order:
        pos, freq = base_chromosome(cfg, int(c), draw)
        pos_l.append(pos)
        freq_l.append(freq)
        counts.append(len(pos))
    counts = np.asarray(counts, np.int64)
    return Genome(
        chrom=[str(int(c) + 1) for c in order],
        start=np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64),
        count=counts,
        pos=np.concatenate(pos_l).astype(np.int64),
        freq=np.concatenate(freq_l).astype(np.int64),
        depth=int(cfg["sample_size"]),
    )
