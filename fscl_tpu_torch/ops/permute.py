"""Genome-wide block permutation of SNP attributes: fscl_tpu's threefry
stream (port of fscl_tpu/ops/permute.py:57-188, :242-265), drawn on the
card.

Reference: snp_block_permute (scan-chromosome.c:336-389).
Sites are binned into contiguous blocks of >= scan_width bp by a uniform
random phase, block(w) = floor((gpos_w + phase) / width); the block order
is shuffled, and within-block order is kept.  Block boundaries quantize
to PERM_GROUP-site groups, so sigma is group-level: output group g takes
input group sigma8[g].  The final (possibly partial) group is pinned in
its own tail block.

Random numbers: row r of a stream is row r of fscl_tpu's, bit for bit,
for the same seed.  Its key is threefry2x32 fold_in(key(seed), start + r)
with start + r taken as uint32 (fscl_tpu/ops/permute.py:109-114), so row
r is a pure function of (seed, start + r) whatever the chunking.  The
key splits into a phase key and a permutation key; the phase is a
float32 uniform on [0, width); the block order is jax.random.permutation
of the shuffled blocks as JAX's _shuffle computes it (rounds of 32-bit
sort keys, each sorted stably), redrawn from fold_in(key, 1) while it is
the identity and more than one block can move (:71-95).  What XLA
computes is copied: split and random_bits as under
jax_threefry_partitionable (the installed JAX's default), the block ids
as (float32(g0) + phase) * float32(1 / width), XLA's rewrite of the
division by a constant, each step rounded to float32.

One draw serves two forms of a replicate: its runs (src, dst, sz), the
contiguous source block behind each stretch of output groups
(block_permutation_runs, consumed by the run-decomposed statistic), and
the group sigma they materialise (block_permutation_groups).  On the
card both come from one kernel, csrc/replicate_runs.cu (threefry, the
block starts searched inside per-genome brackets, a radix sort of the
shuffle's keys in shared memory or, for many blocks, global scratch,
with the redraw loop, the runs and, on request, the sigma row, split
over blocks by tiles where a chunk has few replicates; its geometry
from plan_replicate_runs); on the CPU from replicate_runs_plain, the
same function in int64 tensors masked to 32 bits.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..device import parse_device

PERM_GROUP = 32  # sites per permutation group (fscl_tpu/ops/permute.py:40)
# the name of this module's sigma stream, written into every permutation
# checkpoint (engine/checkpoint.py), which refuses a file of another
# stream; change it with any change to the rows a (seed, index) draws
SIGMA_STREAM = ("threefry2x32 fold_in(key(seed), start + r): fscl_tpu's "
                "block-permutation stream, v1")
replicate_runs_launches = 0  # CUDA kernel launches by replicate_runs

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """JAX's threefry2x32 hash (20 rounds) on int64 tensors holding
    uint32 values; broadcasts; returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _fold_in(k, data):
    """fold_in of keys k [N, 2] with uint32 data (int or [N])."""
    return torch.stack(threefry2x32(k[:, 0], k[:, 1], 0, data), 1)


def _split(k):
    """(first, second) of split(k) [N, 2] (partitionable threefry: key i
    hashes the 64-bit counter i)."""
    return _fold_in(k, 0), _fold_in(k, 1)


def _bits32(k, n):
    """random_bits(k, 32, (n,)) for keys [N, 2]: [N, n]."""
    idx = torch.arange(n, dtype=torch.int64, device=k.device)[None, :]
    y0, y1 = threefry2x32(k[:, :1], k[:, 1:], 0, idx)
    return y0 ^ y1


def seed_key(seed):
    """(k0, k1) of jax.random.key(seed): the seed's low 32 bits."""
    return 0, int(seed) & _M32


def shuffle_rounds(n):
    """Sort rounds of jax.random.permutation(key, n) (JAX's _shuffle)."""
    return int(np.ceil(3 * np.log(max(1, n))
                       / np.log(np.iinfo(np.uint32).max)))


def _permutation(kp, B, rounds):
    """[N, B] int64 jax.random.permutation(kp[i], B) for keys [N, 2]."""
    x = torch.arange(B, dtype=torch.int64,
                     device=kp.device).expand(kp.shape[0], B)
    for _ in range(rounds):
        kp, sub = _split(kp)
        order = torch.sort(_bits32(sub, B), dim=1, stable=True).indices
        x = torch.gather(x, 1, order)
    return x


def replicate_runs_plain(seed, start, g0f, n_blocks, width, n,
                         with_sigma=False):
    """Plain PyTorch version of the kernel: runs (src, dst, sz) [n,
    n_blocks] int32 of replicates start..start+n-1, and with_sigma their
    group sigma [n, G] int32 (else None).

    g0f: [G] float32 first-site position of each group (from the genome's
    first site); width: the block width (effective_block_width)."""
    dev = g0f.device
    G, nb, B = g0f.shape[0], int(n_blocks), int(n_blocks) - 1
    k0, k1 = seed_key(seed)
    idx = (int(start) + torch.arange(n, dtype=torch.int64,
                                     device=dev)) & _M32
    key = torch.stack(threefry2x32(k0, k1, 0, idx), 1)
    k_phase, k_perm = _split(key)
    w32 = torch.tensor(np.float32(width), device=dev)
    inv_w = torch.tensor(np.float32(1) / np.float32(width), device=dev)
    fb = ((_bits32(k_phase, 1)[:, 0] >> 9) | 0x3F800000)
    phase = (fb.to(torch.int32).view(torch.float32) - 1.0) * w32
    block = ((g0f[None, :] + phase[:, None]) * inv_w).to(torch.int64)
    block = block.clamp(0, nb - 2)
    block[:, -1] = nb - 1  # pinned tail block
    b_idx = torch.arange(nb, device=dev).expand(n, nb).contiguous()
    starts = torch.searchsorted(block, b_idx, side="left")
    sizes = torch.searchsorted(block, b_idx, side="right") - starts
    rounds = shuffle_rounds(B)
    head = _permutation(k_perm, B, rounds)
    ident = torch.arange(B, device=dev)
    redo = (head == ident).all(1) & (B > 1)
    while bool(redo.any()):
        rows = torch.nonzero(redo).flatten()
        k_perm[rows] = _fold_in(k_perm[rows], 1)
        head[rows] = _permutation(k_perm[rows], B, rounds)
        redo[rows] = (head[rows] == ident).all(1)
    order = torch.cat(
        [head, torch.full((n, 1), nb - 1, dtype=torch.int64, device=dev)], 1
    )
    sz = torch.gather(sizes, 1, order)
    src = torch.gather(starts, 1, order)
    dst = torch.cumsum(sz, 1) - sz  # exclusive prefix
    sigma = sigma_from_runs(src, dst, G) if with_sigma else None
    return (src.to(torch.int32), dst.to(torch.int32), sz.to(torch.int32),
            sigma)


# the kernel's launch plan (csrc/replicate_runs.cu)
SMEM_MAX = 232448  # shared memory a block can use on the H100
GLOBAL_THREADS = 1024  # threads a block where the sort is in global scratch
SCRATCH_MAX = 512 << 20  # global scratch a launch, bytes (one slot at least)
TILE_MIN = 2048  # groups a sigma tile at least
BLOCKS_PER_SM = 2  # work items a chunk aims at, per SM, before tiling


def _pow2(x):
    """The least power of two >= x (1 for x <= 1)."""
    return 1 << max(0, int(x) - 1).bit_length()


def _align16(x):
    return (x + 15) & ~15


def replicate_runs_bytes(P, nb, tbl_len):
    """Bytes of one replicate's arrays in the kernel (its Layout): shared
    memory a block, or global scratch a block."""
    starts = _align16(8 * max(P, nb))
    xa = _align16(starts + 4 * (nb + 1))
    aux = _align16(xa + 4 * (nb - 1))
    stash = _align16(aux + 4 * max(P, tbl_len))
    return _align16(stash + 4 * (nb - 1))


@dataclass(frozen=True)
class RunsPlan:
    """One launch's geometry: the radix sort's buckets P (a power of two
    >= max(B, 32)), threads a block, tiles of tile_len groups a sigma row
    (a block a (replicate, tile)), the sigma table's shift, the blocks
    (grid), and where the arrays lie: shared memory, smem_bytes a block,
    or on_global over global scratch, grid slots of slot_bytes."""
    threads: int
    P: int
    tiles: int
    tile_len: int
    shift: int
    on_global: bool
    grid: int
    slot_bytes: int
    smem_bytes: int


def plan_replicate_runs(n, G, nb, with_sigma, n_sm=132):
    """The kernel's launch plan for n replicates of G groups in nb blocks
    (B = nb - 1 shuffled) on a card of n_sm SMs.

    The radix sort of P = max(B, 32) rounded up to a power of two
    buckets, in shared memory where its arrays fit, else over global
    scratch at 1,024 threads a block.  Threads: one a block start, up to
    512, and at least one for 16 sigma groups, up to 256; 32 at least.
    The sigma row splits into tiles, each redrawing the replicate's runs,
    until the chunk has BLOCKS_PER_SM items an SM or a tile TILE_MIN
    groups (one tile in global scratch and for the runs)."""
    n, G, nb = int(n), int(G), int(nb)
    P = _pow2(max(nb - 1, 32))
    shift = max(0, (G // nb).bit_length() - 1) if with_sigma else 30
    tiles = 1
    if with_sigma:
        want = -(-BLOCKS_PER_SM * n_sm // max(n, 1))
        tiles = max(1, min(want, -(-G // TILE_MIN)))
    tile_len = -(-G // tiles)
    tile_len += -tile_len % 4
    tiles = -(-G // tile_len)
    smem = replicate_runs_bytes(P, nb, (tile_len >> shift) + 2)
    if smem <= SMEM_MAX:
        want = max(_pow2(nb + 1), min(256, _pow2(tile_len // 16))
                   if with_sigma else 0)
        return RunsPlan(max(32, min(512, want)), P, tiles, tile_len, shift,
                        False, n * tiles, 0, smem)
    # global scratch: one tile
    tile_len = G + (-G % 4)
    slot = replicate_runs_bytes(P, nb, (tile_len >> shift) + 2)
    grid = max(1, min(n, BLOCKS_PER_SM * n_sm, SCRATCH_MAX // slot))
    return RunsPlan(GLOBAL_THREADS, P, 1, tile_len, shift, True, grid, slot,
                    0)


_sm_counts: dict = {}


def _sm_count(dev):
    if dev not in _sm_counts:
        _sm_counts[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_counts[dev]


def block_start_brackets(g0f, nb, width):
    """(lo, hi) [nb + 1] int32: the first group of each block id 0..nb at
    phase = width and at phase = 0, in replicate_runs_plain's float32
    arithmetic.  A block id is monotone in the phase, which lies in [0,
    width], so every replicate's start of block b lies in [lo[b],
    hi[b]]."""
    dev = g0f.device
    w32 = torch.tensor(np.float32(width), device=dev)
    inv_w = torch.tensor(np.float32(1) / np.float32(width), device=dev)
    b_idx = torch.arange(int(nb) + 1, device=dev)
    out = []
    for phase in (w32, torch.zeros_like(w32)):
        block = ((g0f + phase) * inv_w).to(torch.int64).clamp(0, nb - 2)
        block[-1] = nb - 1  # pinned tail block
        out.append(torch.searchsorted(block, b_idx, side="left")
                   .to(torch.int32))
    return tuple(out)


# the brackets of a device g0f (one per genome, _g0_device) at a block
# count and width; an entry pairs them with a weakref to the g0f tensor
_bracket_cache: dict = {}


def _brackets(g0f, nb, width):
    key = (id(g0f), int(nb), float(np.float32(width)))
    hit = _bracket_cache.get(key)
    if hit is not None and hit[0]() is g0f:
        return hit[1]
    lohi = block_start_brackets(g0f, nb, width)
    if len(_bracket_cache) > 64:
        _bracket_cache.clear()
    _bracket_cache[key] = (weakref.ref(g0f), lohi)
    return lohi


def launch_replicate_runs(lib, plan, seed, start, g0f, lo, hi, nb, width, n,
                          runs, sigma, scratch=None):
    """Launch the kernel of library lib with plan on the current stream
    (on_global: global scratch, grid slots of the plan's slot_bytes,
    allocated here unless given); its return code."""
    dev = g0f.device
    if plan.on_global and scratch is None:
        scratch = torch.empty(plan.grid * plan.slot_bytes, dtype=torch.uint8,
                              device=dev)
    k0, k1 = seed_key(seed)
    ptr = [t.data_ptr() if t is not None else None
           for t in (*(runs or (None,) * 3), sigma, scratch)]
    with torch.cuda.device(dev):
        return lib.fscl_replicate_runs(
            g0f.data_ptr(), lo.data_ptr(), hi.data_ptr(), g0f.shape[0],
            int(nb), shuffle_rounds(int(nb) - 1), float(np.float32(width)),
            float(np.float32(1) / np.float32(width)), k0, k1,
            int(start) & _M32, int(n), plan.threads, plan.tiles,
            plan.tile_len, plan.shift, plan.grid,
            ptr[4] if plan.on_global else None, plan.slot_bytes, *ptr[:4],
            torch.cuda.current_stream(dev).cuda_stream,
        )


def replicate_runs(seed, start, g0f, n_blocks, width, n, with_runs=True,
                   with_sigma=False):
    """(src, dst, sz) [n, n_blocks] int32 (None unless with_runs) and the
    group sigma [n, G] int32 (None unless with_sigma) of replicates
    start..start+n-1 (see replicate_runs_plain).  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if g0f.device.type == "cpu":
        src, dst, sz, sigma = replicate_runs_plain(
            seed, start, g0f, n_blocks, width, n, with_sigma)
        return ((src, dst, sz) if with_runs else None), sigma
    if g0f.device.type != "cuda":
        raise ValueError(f"replicate_runs: unsupported device {g0f.device}")
    if g0f.dtype != torch.float32 or g0f.dim() != 1 \
            or not g0f.is_contiguous():
        raise ValueError("replicate_runs: g0f must be a contiguous 1-D "
                         f"float32 tensor, got {g0f.dtype} "
                         f"{tuple(g0f.shape)}")
    G, nb = g0f.shape[0], int(n_blocks)
    if nb < 2:
        raise ValueError(f"replicate_runs: {nb} blocks; need the tail block "
                         "and at least one shuffled block")
    if G == 0 or n * max(G, nb) >= 2**31:
        raise ValueError(f"replicate_runs: {n} replicates of {G} groups "
                         f"and {nb} blocks; the kernel needs G >= 1 and "
                         "its int32 outputs of n x G sigma and n x nb run "
                         "entries below 2^31")
    dev = g0f.device
    kw = dict(dtype=torch.int32, device=dev)
    runs = (tuple(torch.empty((n, nb), **kw) for _ in range(3))
            if with_runs else None)
    sigma = torch.empty((n, G), **kw) if with_sigma else None
    if n == 0:
        return runs, sigma
    from .. import kernels

    lib = kernels.load()
    lo, hi = _brackets(g0f, nb, width)
    plan = plan_replicate_runs(n, G, nb, with_sigma, _sm_count(dev))
    rc = launch_replicate_runs(lib, plan, seed, start, g0f, lo, hi, nb,
                               width, n, runs, sigma)
    kernels.check(lib, rc, "replicate_runs")
    global replicate_runs_launches
    replicate_runs_launches += 1
    return runs, sigma


def _group_first_positions(gpos):
    """([G] first-site genome position of each group, genome span)."""
    gpos = np.asarray(gpos, dtype=np.int64)
    if len(gpos) == 0:
        return np.zeros(0, np.int64), 0
    span = int(gpos[-1]) - int(gpos[0])
    return gpos[::PERM_GROUP] - gpos[0], span


# device copies of the callers' host gpos arrays (group first positions
# as float32): the drivers pass one genome_pos() array every chunk, and an
# upload each chunk would be a host copy between two chunks' launches.
# An entry pairs the device tensor with a weakref to the host array, so a
# recycled id() never serves a stale copy (fscl_tpu/ops/permute.py:190).
_g0_cache: dict = {}


def _g0_device(gpos, device):
    """([G] float32 group first positions on device, span)."""
    key = (id(gpos), str(device))
    hit = _g0_cache.get(key)
    if hit is not None and hit[0]() is gpos:
        return hit[1], hit[2]
    g0, span = _group_first_positions(gpos)
    # float32 of the int32 offsets fscl_tpu converts (round to nearest)
    g0f = torch.as_tensor(g0.astype(np.float32), device=device)
    if len(_g0_cache) > 64:
        _g0_cache.clear()
    try:
        _g0_cache[key] = (weakref.ref(gpos), g0f, span)
    except TypeError:  # not weakrefable (a list): no caching
        pass
    return g0f, span


def effective_block_width(span, width_bp):
    """Block span used by the sigma builder (fscl_tpu/ops/permute.py:218)."""
    del span
    return max(float(width_bp), 1.0)


def n_blocks_for(span, width_bp):
    """Shuffled-block count plus the pinned tail block."""
    w = effective_block_width(span, width_bp)
    return max(int(span // w) + 2, 1) + 1


def _draw(seed, gpos, width_bp, n, start, device, with_runs, with_sigma):
    device = parse_device(device)
    g0f, span = _g0_device(gpos, device)
    return replicate_runs(
        seed, start, g0f, n_blocks_for(span, width_bp),
        effective_block_width(span, width_bp), int(n), with_runs=with_runs,
        with_sigma=with_sigma,
    )


def block_permutation_groups(seed, gpos, width_bp, n_replicates, start=0,
                             device="cuda"):
    """Group-level gather indices sigma8 [R, G] int32, G = ceil(W / 32)
    (fscl_tpu/ops/permute.py:229).

    Site-level semantics: sigma[w] = PERM_GROUP * sigma8[w // PERM_GROUP]
    + w % PERM_GROUP.  gpos: [W] genome-wide monotone bp coordinates;
    width_bp: minimum block span; row r is a pure function of
    (seed, start + r).
    """
    return _draw(seed, gpos, width_bp, n_replicates, start, device,
                 with_runs=False, with_sigma=True)[1]


def block_permutation_runs(seed, gpos, width_bp, n_replicates, start=0,
                           device="cuda"):
    """Runs (src, dst, sz) [R, n_blocks] int32 of the replicates that
    block_permutation_groups materialises (fscl_tpu/ops/permute.py:161).

    Group units: sigma8[r, dst[r, j] + t] == src[r, j] + t for
    t < sz[r, j]; row r is a pure function of (seed, start + r)."""
    return _draw(seed, gpos, width_bp, n_replicates, start, device,
                 with_runs=True, with_sigma=False)[0]


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
