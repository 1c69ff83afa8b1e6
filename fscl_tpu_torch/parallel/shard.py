"""The split's exchanges (the counterpart of fscl_tpu/parallel/shard.py).

fscl_tpu shards the scan's candidates and the permutations' replicates
over its mesh with shard_map, and gathers each result to every process
(gather_to_host, fscl_tpu/parallel/shard.py:139-161), so that the host
loops that follow (the scan's stage selection, the permutations'
exceedance counting, pruning and null reservoirs) run identically
everywhere.  Here a rank computes its contiguous share (split_range) and
the host arrays it has read back are gathered over the split's gloo
group to every rank, in rank order:

  * a scan stage's [2, C] (max CLR, lalpha) over its candidates
    (gather_cols; engine/scan.py eval_stage);
  * a permutation chunk's [R, n_pts] statistic maxima over its
    replicates (gather_rows; engine/permute.py, both paths).

Shares differ by at most one; each rank pads its share to the largest
and the gather trims, so an axis shorter than the world (a last chunk
of one replicate) works.  ``stats`` accumulates the gathers' wall and
the bytes each rank receives (the whole padded result), which the
drivers copy into their ``last_stats``; each exchange is the span
``split.gather``, whose wall also goes to the ``gather`` entry of
utils/timing.py's phase table.

psum_counts sums an exceedance-count vector over the ranks, the psum of
fscl_tpu's sharded_permute_chunk; no driver needs it (they gather the
whole statistic, since the pruning keeps per-point null reservoirs,
not only counts), and its parity test holds it to fscl_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.timing import span

stats = {"gather_s": 0.0, "gather_bytes": 0, "gathers": 0}


def _share(n, world, rank):
    base, rem = divmod(int(n), world)
    r0 = rank * base + min(rank, rem)
    return r0, r0 + base + (rank < rem)


def split_range(n, split):
    """This rank's contiguous share [r0, r1) of an axis of n entries."""
    if split is None or split.world <= 1:
        return 0, int(n)
    return _share(n, split.world, split.rank)


def gather_rows(x, n, split):
    """The [n, ...] array whose rows [r0, r1) are rank r's ``x`` (its
    share of split_range(n)), on every rank, as a numpy array."""
    x = np.asarray(x)
    if split is None or split.world <= 1:
        return x
    import torch.distributed as dist

    r0, r1 = split_range(n, split)
    if x.shape[0] != r1 - r0:
        raise ValueError(f"rank {split.rank}: {x.shape[0]} rows for a "
                         f"share of {r1 - r0}")
    shares = [_share(n, split.world, r) for r in range(split.world)]
    top = max(b - a for a, b in shares)
    with span("split.gather", table="gather") as sp:
        mine = torch.from_numpy(np.ascontiguousarray(x))
        buf = torch.zeros((top, *x.shape[1:]), dtype=mine.dtype)
        buf[: x.shape[0]] = mine
        outs = [torch.empty_like(buf) for _ in range(split.world)]
        dist.all_gather(outs, buf, group=split.group)
        full = np.concatenate([o[: b - a].numpy()
                               for o, (a, b) in zip(outs, shares)])
    stats["gather_s"] += sp.seconds
    stats["gather_bytes"] += split.world * buf.numel() * buf.element_size()
    stats["gathers"] += 1
    return full


def split_stats(since, split):
    """The drivers' last_stats entries: the world, and the gathers' wall
    and received bytes since the ``stats`` snapshot ``since``."""
    return dict(split_world=1 if split is None else split.world,
                split_gather_s=stats["gather_s"] - since["gather_s"],
                split_gather_bytes=stats["gather_bytes"]
                - since["gather_bytes"])


def gather_cols(x, n, split):
    """gather_rows over the last axis: [..., n] from each rank's
    [..., r1 - r0]."""
    x = np.asarray(x)
    if split is None or split.world <= 1:
        return x
    return np.moveaxis(gather_rows(np.moveaxis(x, -1, 0), n, split), 0, -1)


def psum_counts(counts, split):
    """The elementwise sum of every rank's int64 ``counts`` vector."""
    counts = np.asarray(counts, dtype=np.int64)
    if split is None or split.world <= 1:
        return counts
    import torch.distributed as dist

    t = torch.from_numpy(counts.copy())
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=split.group)
    return t.numpy()


def broadcast_flag(flag, split):
    """Rank 0's ``flag`` on every rank (a barrier too)."""
    if split is None or split.world <= 1:
        return bool(flag)
    import torch.distributed as dist

    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    dist.broadcast(t, src=0, group=split.group)
    return bool(t.item())


def gather_objects(obj, split):
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    if split is None or split.world <= 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * split.world
    dist.all_gather_object(out, obj, group=split.group)
    return out
