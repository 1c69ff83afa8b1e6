"""ms-output -> SNPData adapters and the two-pass ms scan pipeline (port
of fscl_tpu/io/ms_input.py).

Reference: the C ms-input.c and the ms branch of main (fscl.c:281-314).
Pass 1 concatenates ALL blocks into one long synthetic chromosome (block
b offset by b * segment_length) to estimate the background spectrum;
pass 2 re-streams the file block by block, scanning each as its own
chromosome on ``device`` and appending per-block output (typically with
--max-only to build null-distribution histograms over replicates).

Reference quirks NOT replicated (both are bugs there), as in fscl_tpu:
  * folded sites whose derived count is already the minor allele got
    obs_freq = 0 (ms-input.c:74-77); we set min(d, n-d).
  * the C reopens the output with mode "w" per block, so only the last
    block's rows survive; we append.

The port has no compile step, so nothing is prewarmed; scan_genome builds
the lattice tables only where a block takes the lattice path.  Under a
split over ranks (parallel/) every rank parses the file and runs each
block's scan and permutations on its share; rank 0 alone writes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..cli import model_tables, scan_configs
from ..data import SNPData, build_snp_data
from ..device import parse_device
from ..engine import scan_genome, scan_permute
from ..parallel.mesh import SOLO
from ..utils.logging import MSG_STATUS, cr_logmsg, logmsg
from .ms_parser import MsParser
from .output import scan_output, write_null_distribution


def _block_sites(msb, seg_len, folded, first, size, offset, chrom):
    n_hap = msb.n_haplotypes
    take = size if size else n_hap - first
    sub = msb.haplotypes[first : first + take, :]
    d = sub.sum(axis=0).astype(np.int64)
    keep = (d > 0) & (d < take)
    pos = (msb.positions * seg_len).astype(np.int64) + offset
    pos = pos[keep]
    d = d[keep]
    if folded:
        freq = np.minimum(d, take - d)
    else:
        freq = d
    return (
        [chrom] * len(pos),
        pos,
        freq,
        np.full(len(pos), take, dtype=np.int64),
        np.full(len(pos), folded, dtype=bool),
    )


def ms_background(path, seg_len, folded, first, size) -> SNPData:
    """Pass 1: one concatenated dataset over all blocks (ms-input.c:25-91)."""
    acc = [[], [], [], [], []]
    n_blocks = 0
    with open(path) as f:
        parser = MsParser(f)
        while True:
            msb = parser.next_block()
            if msb is None:
                break
            parts = _block_sites(
                msb, seg_len, folded, first, size, n_blocks * seg_len, "ms"
            )
            acc[0].extend(parts[0])
            for i in range(1, 5):
                acc[i].append(parts[i])
            n_blocks += 1
    if n_blocks == 0:
        raise ValueError(f"no ms blocks found in {path}")
    cr_logmsg(MSG_STATUS, "ms background: %d blocks", n_blocks)
    return build_snp_data(
        acc[0],
        np.concatenate(acc[1]),
        np.concatenate(acc[2]),
        np.concatenate(acc[3]),
        np.concatenate(acc[4]),
    )


def iter_ms_blocks(path, seg_len, folded, first, size):
    """Pass 2: one SNPData per block (ms-input.c:93-151), block index as name."""
    with open(path) as f:
        parser = MsParser(f)
        b = 0
        while True:
            msb = parser.next_block()
            if msb is None:
                return
            chroms, pos, freq, depth, fold = _block_sites(
                msb, seg_len, folded, first, size, 0, str(b)
            )
            b += 1
            if len(pos) == 0:
                continue
            yield build_snp_data(chroms, pos, freq, depth, fold)


def ms_pipeline(args, device="cuda", split=SOLO):
    """Two-pass ms scan (fscl.c:281-314) on ``device`` (``cuda`` unless
    the caller asks for ``cpu``), this rank's share of it under
    ``split``."""
    if args.ms_segment_length <= 0:
        logmsg(
            2,
            "ms input needs --ms-segment-length > 0 (the reference would "
            "multiply positions by 0); pass e.g. --ms-segment-length 1000000",
        )
        raise SystemExit(255)
    device = parse_device(device)

    bg_data = ms_background(
        args.msfile, args.ms_segment_length, args.ms_folded,
        args.ms_sample_first, args.ms_sample_size,
    )
    tables = model_tables(bg_data, args, split)
    if tables is None:
        return 0
    scan_cfg, perm_cfg = scan_configs(args)

    blocks = iter_ms_blocks(
        args.msfile, args.ms_segment_length, args.ms_folded,
        args.ms_sample_first, args.ms_sample_size,
    )
    for block_i, data in enumerate(blocks):
        data.attach_model(tables)
        result = scan_genome(data, tables, scan_cfg, device=device,
                             split=split)
        if perm_cfg is not None:
            # one checkpoint per block: the identity check
            # (engine/checkpoint.py) ties a file to one scan's
            # positions/CLRs, and each ms block is its own scan
            block_cfg = perm_cfg
            if perm_cfg.checkpoint_path:
                block_cfg = dataclasses.replace(
                    perm_cfg,
                    checkpoint_path=f"{perm_cfg.checkpoint_path}.block{block_i}")
            scan_permute(data, tables, result, scan_cfg, block_cfg,
                         device=device, split=split)
        if not split.writer:
            continue
        scan_output(
            args.output_file, data, result,
            maximum_only=args.max_only, n_permute=args.n_permute,
            prepend_label=args.prepend_label, append=block_i > 0,
        )
        if args.n_permute > 0:
            write_null_distribution(
                args.output_file, data, result, append=block_i > 0
            )
    return 0
