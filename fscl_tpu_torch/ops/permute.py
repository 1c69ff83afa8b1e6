"""Genome-wide block permutation of SNP attributes (port of
fscl_tpu/ops/permute.py, the group-level sigma).

Reference: snp_block_permute (scan-chromosome.c:336-389).
Sites are binned into contiguous blocks of >= scan_width bp by a uniform
random phase, block(w) = floor((gpos_w + phase) / width); the block order
is shuffled, and within-block order is kept.  Block boundaries quantize
to PERM_GROUP-site groups, so sigma is group-level: output group g takes
input group sigma8[g].  The final (possibly partial) group is pinned in
its own tail block, and a shuffle that moves nothing is redrawn whenever
more than one block can move (fscl_tpu/ops/permute.py:71-95).

Random numbers: replicate r of a stream draws from its own
torch.Generator seeded from (seed, start + r), so row r is a pure
function of (seed, start + r) whatever the chunking
(fscl_tpu/ops/permute.py:109-114).  The bits differ from the JAX
package's threefry stream; tests feed the JAX sigma (and runs) to the
port where they compare permutation results.

One draw serves two forms of a replicate: its runs (src, dst, sz), the
contiguous source block behind each stretch of output groups
(block_permutation_runs, consumed by the run-decomposed statistic), and
the group sigma they materialise (block_permutation_groups).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import parse_device

PERM_GROUP = 32  # sites per permutation group (fscl_tpu/ops/permute.py:40)


def _group_first_positions(gpos):
    """([G] first-site genome position of each group, genome span)."""
    gpos = np.asarray(gpos, dtype=np.int64)
    if len(gpos) == 0:
        return np.zeros(0, np.int64), 0
    span = int(gpos[-1]) - int(gpos[0])
    return gpos[::PERM_GROUP] - gpos[0], span


def effective_block_width(span, width_bp):
    """Block span used by the sigma builder (fscl_tpu/ops/permute.py:218)."""
    del span
    return max(float(width_bp), 1.0)


def n_blocks_for(span, width_bp):
    """Shuffled-block count plus the pinned tail block."""
    w = effective_block_width(span, width_bp)
    return max(int(span // w) + 2, 1) + 1


def _replicate_seed(seed, index):
    """32-bit seed of replicate ``index`` (splitmix64 of (seed, index)):
    the CPU generator's Mersenne Twister keeps 32 bits of its seed."""
    m = (1 << 64) - 1
    z = ((((int(seed) & 0xFFFFFFFF) << 32) | (int(index) & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def _blocks(g0, phase, n_blocks, width, device):
    """[N, n_blocks] first group of each block and its group count."""
    N = phase.shape[0]
    g0_d = torch.as_tensor(g0, dtype=torch.float64, device=device)
    ph = torch.as_tensor(phase, dtype=torch.float64, device=device)
    block = torch.floor((g0_d[None, :] + ph[:, None]) / width).to(torch.int64)
    block = block.clamp(0, n_blocks - 2)
    block[:, -1] = n_blocks - 1  # pinned tail block
    b_idx = torch.arange(n_blocks, device=device).expand(N, n_blocks)
    b_idx = b_idx.contiguous()
    starts = torch.searchsorted(block, b_idx, side="left")
    ends = torch.searchsorted(block, b_idx, side="right")
    return starts, ends - starts


def _runs(starts, sizes, order):
    """Runs (src, dst, sz) [N, n_blocks] int64 of per-replicate block
    orders: output groups [dst[j], dst[j] + sz[j]) take source groups
    [src[j], src[j] + sz[j]); the pinned tail block is the last run
    (fscl_tpu/ops/permute.py:96-106)."""
    N, n_blocks = starts.shape
    tail = torch.full((N, 1), n_blocks - 1, dtype=torch.int64,
                      device=starts.device)
    full_order = torch.cat([order.to(starts.device), tail], 1)
    sz = torch.gather(sizes, 1, full_order)
    src = torch.gather(starts, 1, full_order)
    dst = torch.cumsum(sz, 1) - sz  # exclusive prefix
    return src, dst, sz


def sigma_from_runs(src, dst, n_groups):
    """[N, G] int32 group sigma of runs [N, B].

    Output slot s holds group s - dst[j] + src[j], where j is s's run: a
    per-run step function of s, built as a scatter of value deltas at the
    run offsets plus a cumsum (fscl_tpu/ops/permute.py:131-146).  Empty
    runs share an offset and telescope to the last of them; offsets equal
    to G land in a dropped column."""
    G = int(n_groups)
    src = src.to(torch.int64)
    dst = dst.to(torch.int64)
    val = src - dst
    dval = torch.diff(val, dim=1, prepend=torch.zeros_like(val[:, :1]))
    base = torch.zeros((src.shape[0], G + 1), dtype=torch.int64,
                       device=src.device)
    base.scatter_add_(1, dst, dval)
    sig = torch.cumsum(base[:, :G], 1) + torch.arange(G, device=src.device)
    return sig.to(torch.int32)


def _draw_runs(seed, gpos, width_bp, n_replicates, start, device):
    """(src, dst, sz) [N, n_blocks] int64 and G for replicates start..
    start+N-1.  A row that would move nothing (every non-empty run left
    in place) is redrawn from the same generator whenever two or more
    non-empty blocks can move."""
    device = parse_device(device)
    g0, span = _group_first_positions(gpos)
    n_blocks = n_blocks_for(span, width_bp)
    width = effective_block_width(span, width_bp)
    B = n_blocks - 1  # shuffled blocks; the tail block stays last
    N = int(n_replicates)
    gens = []
    phase = np.empty(N, np.float64)
    order = torch.empty((N, B), dtype=torch.int64)
    for r in range(N):
        g = torch.Generator()
        g.manual_seed(_replicate_seed(seed, start + r))
        phase[r] = float(torch.rand((), generator=g, dtype=torch.float64))
        order[r] = torch.randperm(B, generator=g)
        gens.append(g)
    starts, sizes = _blocks(g0, phase * width, n_blocks, width, device)
    src, dst, sz = _runs(starts, sizes, order)
    movable = (sizes[:, :B] > 0).sum(1) > 1
    while True:
        still = ((src == dst) | (sz == 0)).all(1)
        redo = torch.nonzero(still & movable).flatten().cpu().tolist()
        if not redo:
            return src, dst, sz, len(g0)
        for r in redo:
            order[r] = torch.randperm(B, generator=gens[r])
        src[redo], dst[redo], sz[redo] = _runs(
            starts[redo], sizes[redo], order[redo]
        )


def block_permutation_groups(seed, gpos, width_bp, n_replicates, start=0,
                             device="cuda"):
    """Group-level gather indices sigma8 [R, G] int32, G = ceil(W / 32).

    Site-level semantics: sigma[w] = PERM_GROUP * sigma8[w // PERM_GROUP]
    + w % PERM_GROUP.  gpos: [W] genome-wide monotone bp coordinates;
    width_bp: minimum block span; row r is a pure function of
    (seed, start + r).  A row that would move nothing is redrawn (see
    _draw_runs).
    """
    src, dst, _, G = _draw_runs(seed, gpos, width_bp, n_replicates, start,
                                device)
    return sigma_from_runs(src, dst, G)


def block_permutation_runs(seed, gpos, width_bp, n_replicates, start=0,
                           device="cuda"):
    """Runs (src, dst, sz) [R, n_blocks] int32 of the replicates that
    block_permutation_groups materialises (fscl_tpu/ops/permute.py:161).

    Group units: sigma8[r, dst[r, j] + t] == src[r, j] + t for
    t < sz[r, j]; row r comes from exactly the draws and redraws of sigma
    row r, a pure function of (seed, start + r)."""
    src, dst, sz, _ = _draw_runs(seed, gpos, width_bp, n_replicates, start,
                                 device)
    return src.to(torch.int32), dst.to(torch.int32), sz.to(torch.int32)


def expand_group_sigma(sigma8, n_sites):
    """Site-level sigma [R, n_sites] from group-level sigma8 [R, G]
    (fscl_tpu/ops/permute.py:266)."""
    R, G = sigma8.shape
    k = torch.arange(PERM_GROUP, dtype=sigma8.dtype, device=sigma8.device)
    full = (sigma8[:, :, None] * PERM_GROUP + k).reshape(R, G * PERM_GROUP)
    return full[:, :n_sites]


def runs_from_sigma(sigma8):
    """Runs (src, dst, sz) [N, B] int32 of group sigmas [N, G]: one run
    per maximal stretch of consecutive source groups, padded with empty
    runs at dst = G.  Any run decomposition of a sigma gives the
    run-decomposed statistic the same values; this one serves a sigma
    stream injected without its runs."""
    sig = torch.as_tensor(sigma8 if isinstance(sigma8, torch.Tensor)
                          else np.array(sigma8)).to(torch.int64)
    N, G = sig.shape
    brk = torch.ones_like(sig, dtype=torch.bool)
    brk[:, 1:] = sig[:, 1:] != sig[:, :-1] + 1
    rank = torch.cumsum(brk, 1) - 1  # run index of every group
    B = int(rank[:, -1].max()) + 1 if G else 1
    src = torch.zeros((N, B), dtype=torch.int64, device=sig.device)
    dst = torch.full((N, B), G, dtype=torch.int64, device=sig.device)
    sz = torch.zeros((N, B), dtype=torch.int64, device=sig.device)
    r, g = torch.nonzero(brk, as_tuple=True)
    src[r, rank[r, g]] = sig[r, g]
    dst[r, rank[r, g]] = g
    sz.scatter_add_(1, rank, torch.ones_like(rank))
    return src.to(torch.int32), dst.to(torch.int32), sz.to(torch.int32)
