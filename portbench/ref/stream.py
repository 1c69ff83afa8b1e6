"""Frozen copy of the block-permutation stream (the plain form of
fscl_tpu_torch/ops/permute.py, itself fscl_tpu's threefry stream,
snp_block_permute in scan-chromosome.c:336-389), in plain PyTorch.

Sites are binned into blocks of >= width bp by a uniform random phase;
the block order is shuffled (jax.random.permutation's sort rounds), the
order within a block kept, and the last group pinned in its own tail
block.  Block boundaries quantize to PERM_GROUP-site groups: output group
g takes input group sigma8[g].  Replicate r of a stream is a pure
function of (seed, r).
"""

from __future__ import annotations

import numpy as np
import torch

PERM_GROUP = 32
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry2x32 (20 rounds) on int64 tensors holding uint32 values."""
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
    return torch.stack(threefry2x32(k[:, 0], k[:, 1], 0, data), 1)


def _split(k):
    return _fold_in(k, 0), _fold_in(k, 1)


def _bits32(k, n):
    idx = torch.arange(n, dtype=torch.int64, device=k.device)[None, :]
    y0, y1 = threefry2x32(k[:, :1], k[:, 1:], 0, idx)
    return y0 ^ y1


def shuffle_rounds(n):
    return int(np.ceil(3 * np.log(max(1, n))
                       / np.log(np.iinfo(np.uint32).max)))


def _permutation(kp, B, rounds):
    x = torch.arange(B, dtype=torch.int64,
                     device=kp.device).expand(kp.shape[0], B)
    for _ in range(rounds):
        kp, sub = _split(kp)
        order = torch.sort(_bits32(sub, B), dim=1, stable=True).indices
        x = torch.gather(x, 1, order)
    return x


def group_sigma(seed, gpos, width_bp, replicates, device):
    """[len(replicates), G] int64 group sigma of the given replicate
    indices of the stream ``seed``, for the genome coordinates ``gpos``
    (int64 [W], monotone) and blocks of ``width_bp``."""
    gpos = np.asarray(gpos, dtype=np.int64)
    g0 = gpos[::PERM_GROUP] - gpos[0]
    span = int(gpos[-1]) - int(gpos[0])
    width = max(float(width_bp), 1.0)
    nb = max(int(span // width) + 2, 1) + 1
    g0f = torch.as_tensor(g0.astype(np.float32), device=device)
    G, B = g0f.shape[0], nb - 1
    n = len(replicates)
    idx = torch.as_tensor(np.asarray(replicates, np.int64) & _M32,
                          device=device)
    key = torch.stack(threefry2x32(0, int(seed) & _M32, 0, idx), 1)
    k_phase, k_perm = _split(key)
    w32 = torch.tensor(np.float32(width), device=device)
    inv_w = torch.tensor(np.float32(1) / np.float32(width), device=device)
    fb = (_bits32(k_phase, 1)[:, 0] >> 9) | 0x3F800000
    phase = (fb.to(torch.int32).view(torch.float32) - 1.0) * w32
    block = ((g0f[None, :] + phase[:, None]) * inv_w).to(torch.int64)
    block = block.clamp(0, nb - 2)
    block[:, -1] = nb - 1  # pinned tail block
    b_idx = torch.arange(nb, device=device).expand(n, nb).contiguous()
    starts = torch.searchsorted(block, b_idx, side="left")
    sizes = torch.searchsorted(block, b_idx, side="right") - starts
    rounds = shuffle_rounds(B)
    head = _permutation(k_perm, B, rounds)
    ident = torch.arange(B, device=device)
    redo = (head == ident).all(1) & (B > 1)
    while bool(redo.any()):
        rows = torch.nonzero(redo).flatten()
        k_perm[rows] = _fold_in(k_perm[rows], 1)
        head[rows] = _permutation(k_perm[rows], B, rounds)
        redo[rows] = (head[rows] == ident).all(1)
    order = torch.cat(
        [head, torch.full((n, 1), nb - 1, dtype=torch.int64, device=device)],
        1)
    sz = torch.gather(sizes, 1, order)
    src = torch.gather(starts, 1, order)
    dst = torch.cumsum(sz, 1) - sz
    # output group s of run j takes input group s - dst[j] + src[j]
    val = src - dst
    dval = torch.diff(val, dim=1, prepend=torch.zeros_like(val[:, :1]))
    base = torch.zeros((n, G + 1), dtype=torch.int64, device=device)
    base.scatter_add_(1, dst, dval)
    return torch.cumsum(base[:, :G], 1) + torch.arange(G, device=device)


def site_sigma(sigma8, n_sites):
    """[R, n_sites]: permuted site w takes the attributes of site
    sigma[w] = PERM_GROUP * sigma8[w // PERM_GROUP] + w % PERM_GROUP."""
    R, G = sigma8.shape
    k = torch.arange(PERM_GROUP, dtype=sigma8.dtype, device=sigma8.device)
    return (sigma8[:, :, None] * PERM_GROUP + k).reshape(
        R, G * PERM_GROUP)[:, :n_sites]
