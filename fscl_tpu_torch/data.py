"""Core dataset container: sites sorted by (chromosome, position).

Mirrors scan_t / snp_t / chr_limits_t (fscl.h:7-62) as a
struct-of-arrays: the TPU kernels consume flat int32/f32 columns, not an
array of structs.  ``depth_p`` indexes ``sample_depths`` in first-seen order
(snp-input.c:97-104); ``row`` and ``null_logl`` are filled in after the
sweep-model tables are built.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ChrLimits:
    """Per-chromosome index range (fscl.h:26-33).

    ``bp_length`` keeps the reference's (misnamed) meaning: the position of
    the *last* SNP, which bounds the scan grid (scan-chromosome.c:180,202).
    """

    name: str
    start_index: int
    n_snps: int
    start_pos: int
    bp_length: int


@dataclasses.dataclass
class SNPData:
    pos: np.ndarray  # [n] int64 bp
    obs_freq: np.ndarray  # [n] int32
    depth_p: np.ndarray  # [n] int32 index into sample_depths
    folded: np.ndarray  # [n] bool
    chr_id: np.ndarray  # [n] int32
    sample_depths: np.ndarray  # [D] int64, first-seen order
    chr_limits: list  # list[ChrLimits], by chr_id
    null_logl: np.ndarray | None = None  # [n] float64, set by attach_model
    row: np.ndarray | None = None  # [n] int32 table row, set by attach_model

    @property
    def n_snps(self) -> int:
        return int(self.pos.shape[0])

    @property
    def n_chromosomes(self) -> int:
        return len(self.chr_limits)

    def attach_model(self, tables) -> None:
        """Precompute per-site table rows and null log-likelihoods.

        The null model is compute_snp_null_model (scan-chromosome.c:23-37)
        evaluated once up front; the row index fuses (depth_p, folded,
        obs_freq) into a single gather key for the kernels.
        """
        self.row = tables.site_rows(self.depth_p, self.folded, self.obs_freq)
        self.null_logl = tables.null_logl(self.depth_p, self.folded, self.obs_freq)
        # row/null changed: drop memoized hist table packs (engine/scan.py)
        self._hist_tables_cache = {}
        self._hist_dev_cache = {}
        self._blk_cache = {}

    def genome_pos(self) -> np.ndarray:
        """Monotone genome-wide coordinate (chromosome offsets accumulated).

        Used by the block permutation: the reference permutes the single
        concatenated SNP array across chromosome boundaries
        (scan-chromosome.c:341-389); a strictly monotone coordinate
        reproduces that while keeping position-width block binning.
        """
        g = self.pos.astype(np.int64).copy()
        offset = 0
        for cl in self.chr_limits:
            sl = slice(cl.start_index, cl.start_index + cl.n_snps)
            g[sl] = self.pos[sl] - cl.start_pos + offset
            offset += int(cl.bp_length - cl.start_pos) + 1
        return g


def build_snp_data(chr_names_per_row, pos, obs_freq, sample_size, folded) -> SNPData:
    """Assemble an SNPData from parsed columns (shared by file and ms input).

    Applies the reference ordering semantics: chromosome ids by first
    appearance, depths deduped in first-seen order, then a stable sort by
    (chr, pos) (snp-input.c:68-79, 97-104, 123).
    """
    pos = np.asarray(pos, dtype=np.int64)
    obs_freq = np.asarray(obs_freq, dtype=np.int32)
    sample_size = np.asarray(sample_size, dtype=np.int64)
    folded = np.asarray(folded, dtype=bool)

    # chromosome ids in first-appearance order
    names = []
    name_index = {}
    chr_id = np.empty(len(pos), dtype=np.int32)
    for i, c in enumerate(chr_names_per_row):
        j = name_index.get(c)
        if j is None:
            j = len(names)
            name_index[c] = j
            names.append(c)
        chr_id[i] = j

    # depths in first-seen order
    depths = []
    depth_index = {}
    depth_p = np.empty(len(pos), dtype=np.int32)
    for i, s in enumerate(sample_size.tolist()):
        j = depth_index.get(s)
        if j is None:
            j = len(depths)
            depth_index[s] = j
            depths.append(s)
        depth_p[i] = j

    order = np.lexsort((pos, chr_id))
    pos = pos[order]
    chr_id = chr_id[order]
    obs_freq = obs_freq[order]
    depth_p = depth_p[order]
    folded = folded[order]

    limits = []
    for c in range(len(names)):
        idx = np.where(chr_id == c)[0]
        limits.append(
            ChrLimits(
                name=names[c],
                start_index=int(idx[0]),
                n_snps=int(len(idx)),
                start_pos=int(pos[idx[0]]),
                bp_length=int(pos[idx[-1]]),
            )
        )

    return SNPData(
        pos=pos,
        obs_freq=obs_freq,
        depth_p=depth_p,
        folded=folded,
        chr_id=chr_id,
        sample_depths=np.asarray(depths, dtype=np.int64),
        chr_limits=limits,
    )
