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
card both come from one kernel, csrc/replicate_runs.cu (one block a
replicate: threefry, the block sizes, a bitonic sort of the shuffle's
keys in shared memory with the redraw loop, the runs and, on request,
the sigma row); on the CPU from replicate_runs_plain, the same function
in int64 tensors masked to 32 bits.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..device import parse_device

PERM_GROUP = 32  # sites per permutation group (fscl_tpu/ops/permute.py:40)
# the name of this module's sigma stream, written into every permutation
# checkpoint (engine/checkpoint.py), which refuses a file of another
# stream; change it with any change to the rows a (seed, index) draws
SIGMA_STREAM = ("threefry2x32 fold_in(key(seed), start + r): fscl_tpu's "
                "block-permutation stream, v1")
# shuffled blocks the kernel's shared-memory sort holds: 8 bytes a key
# at the next power of two, plus 4 a block of starts, in 227 KB
BLOCKS_MAX = 16384
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
    if not 1 <= nb - 1 <= BLOCKS_MAX:
        raise ValueError(
            f"replicate_runs: {nb - 1} shuffled blocks; the kernel's "
            f"shared-memory sort holds 1 to {BLOCKS_MAX} (raise the block "
            "width)")
    if G == 0 or n * max(G, nb) >= 2**31:
        raise ValueError(f"replicate_runs: {n} replicates of {G} groups "
                         f"and {nb} blocks (need G >= 1, n x G < 2^31)")
    dev = g0f.device
    kw = dict(dtype=torch.int32, device=dev)
    runs = (tuple(torch.empty((n, nb), **kw) for _ in range(3))
            if with_runs else None)
    sigma = torch.empty((n, G), **kw) if with_sigma else None
    if n == 0:
        return runs, sigma
    from .. import kernels

    lib = kernels.load()
    k0, k1 = seed_key(seed)
    ptr = [t.data_ptr() if t is not None else None
           for t in (*(runs or (None,) * 3), sigma)]
    with torch.cuda.device(dev):
        rc = lib.fscl_replicate_runs(
            g0f.data_ptr(), G, nb, shuffle_rounds(nb - 1),
            float(np.float32(width)),
            float(np.float32(1) / np.float32(width)), k0, k1,
            int(start) & _M32, n, *ptr,
            torch.cuda.current_stream(dev).cuda_stream,
        )
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
