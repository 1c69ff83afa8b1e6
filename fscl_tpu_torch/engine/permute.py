"""Block-permutation significance engine with adaptive pruning (port of
fscl_tpu/engine/permute.py): the hist path (_scan_permute_hist), in exact
one-hot and in compressed mixed-depth mode, and the lattice path.

Reference: scan_permute (scan-chromosome.c:336-652).  A
point counts an exceedance when a permuted replicate's statistic is >=
its observed statistic; once it has >= 20 exceedances it finishes with
probability permute_p/permute_n per further exceedance
(scan-chromosome.c:488-494).  The first 10,000 null values per point are
kept (CLR_NULL_DIST_SAVE).

Statistic: per coarse interval, max CLR over a fixed Jf-point position
grid x a dense hist_alphas lattice alpha grid, applied identically to the
observed data (thresholds, identity sigma) and to every permuted
replicate.  Live chromosomes of one padded length stack onto one flat
site axis (_StackGroup); each chunk of replicates runs _stack_stat per
stack: the fused gather + one-hot (or weight-row) expansion + segmented
prefix sum (ops/prefix_sums.py, a CUDA kernel on the card), then
hist_clr_reps_ps and the max.  The host counts exceedances and prunes
between chunks.

Pruning tail (RDP, fscl_tpu/engine/permute.py:1812-1913): once the
active bound set is far smaller than the live genome
(RDP_BOUNDS_FACTOR * bound entries < live sites), a chunk runs through
rdp_clr_reps instead: each replicate's permuted prefix is assembled at the
bounds from the unpermuted site prefix and the replicate's runs, so its
cost follows bounds, not sites.  FSCL_RDP=on/off forces the choice
(exact one-hot tables only; compressed tables keep the stacked path).
Both paths compute the same window counts, hence the same statistic.

Chunk schedule (_boost, with the sigma element cap) and point order
(stacks by segment length, then chromosomes, then point ids, on both
paths) follow the JAX package, so the pruning RNG is consumed in the same
order.  ``last_stats`` counts the last run's dispatches.  Not ported: the
group-granular statistic (GROUP_STAT, off by default there) and the warm
pool (it compiles XLA programs; the port has none).

Speculation (fscl_tpu/engine/permute.py:1983-2124), on the stacked
path: once a chunk's statistic is enqueued, its readback is enqueued
(pinned memory and an event on the card), then the next chunk's sigma
is drawn on the card at the tier predicted from the active count before
the drain, and, where that tier is >= 16, the run a world of one and the
next chunk predicted off the RDP tail (FSCL_STAT_SPEC=1, the default),
the whole next chunk's statistic is enqueued on the present geometry;
then the host waits for the readback.  So the card rolls into the next
chunk while the host counts exceedances.  A speculative chunk is taken
only when its (boost, start, R) is the chunk's and no stack is due a
compaction, so it ran on exactly the geometry a plain dispatch would use
and the results are bitwise those of FSCL_STAT_SPEC=0; otherwise, and
when the RDP tail engages, it is dropped and counted once as a miss
(``hist_spec_misses``; taken: ``hist_spec_chunks``).  A checkpoint holds
only drained chunks: a speculative chunk in flight at a save is dropped
on a resume.

Checkpoint and resume (engine/checkpoint.py), on both paths: with
checkpoint_path, the state is saved after every chunk and a run whose
file exists resumes from it.  Sigma row r is a pure function of (seed,
start + r), and the pruning RNG is re-seeded from cfg.seed as in the JAX
package, so a resume from a break on a chunk boundary of the
uninterrupted run, taken before any point reached PRUNE_THRESHOLD
exceedances (no pruning draw yet), equals the uninterrupted run.

Under a split over ranks (parallel/): each chunk's replicates are
split, rank r drawing and evaluating rows [r0, r1) of the chunk
(sigma_source(r1 - r0, start + r0)), and the chunk's [R, n_pts] maxima
are gathered to every rank before the pruning updates, which then run
identically everywhere from the same host RNG; the chunk schedule does
not depend on the world, so every rank, and a world of one, reach the
same result.  The thresholds (one identity replicate) are computed
unsplit on every rank.  The RDP tail stays off under a split (fscl_tpu
keeps it on one device, fscl_tpu/engine/permute.py:1815-1820).  Only
rank 0 writes the checkpoint; every rank replays it on a resume, so a
file written under one world resumes under any other.

Spans (utils/timing.py; recorded only while the recorder is on): the
call is ``permute.pass`` (a step), set-up and thresholds
``permute.setup``, each loop turn ``permute.chunk`` (attributes path, R,
boost, n_active) holding ``permute.draw`` (sigma), ``permute.compact``
(stack rebuilds and their build_hist_points uploads), ``permute.stat``
(the statistic's launches and its readback's enqueue),
``permute.speculate`` (the next chunk's sigma and statistic),
``permute.drain`` (the readback's wait and the split's gather),
``permute.update`` (_apply_round_updates) and ``permute.save``
(checkpoint and SIGINT dump).

Lattice path (fscl_tpu/engine/permute.py:460-644), under --no-hist
(use_hist=False) and for datasets past the hist gate: the statistic is
the per-interval max over the same Jf-point position grid of the coarse
and fine lattice alpha stages (ops/lattice.py, no ultra stage), per
chromosome and POINT_BUCKET points, every replicate of a chunk of
chunk_replicates in one kernel launch per stage.  Its sigma is the same
group stream as the hist path's, expanded to sites.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import time

import numpy as np
import torch

from ..utils.logging import (
    MSG_STATUS,
    MSG_WARN,
    cr_logmsg,
    logmsg,
)

from ..device import parse_device
from ..ops.histclr import (
    _clr_from_windows,
    build_hist_points,
    build_prefix_sums_oh,
    build_prefix_sums_seg,
    build_site_prefix,
    hist_clr_reps_ps,
    make_row_index_group_table,
    rdp_clr_reps,
)
from ..ops.lattice import two_stage_lattice_max
from ..ops.prefix_sums import ONEHOT_LANES_MAX
from ..ops.permute import (
    PERM_GROUP,
    block_permutation_groups,
    block_permutation_runs,
    expand_group_sigma,
    runs_from_sigma,
)
from ..ops.windows import candidate_windows
from ..parallel import shard
from ..parallel.mesh import SOLO
from ..utils.timing import span, traced
from .checkpoint import Checkpointer
from .scan import (
    _port_cache,
    get_hist_device_arrays,
    get_lattice_tables,
    make_scan_hist_tables,
)

CLR_NULL_DIST_SAVE = 10000  # scan-chromosome.c:227
PRUNE_THRESHOLD = 20  # scan-chromosome.c:490
N_PERM_POS = 7  # the statistic's position grid per interval
STAT_DENSIFY = 1
HIST_REP_SUB = 16  # replicates per prefix-sum slice (doubled when it fits)
HIST_POINT_BUCKET = 256  # point-count scale of the boost tiers
# byte budget of one slice's [S*w, P*R] prefix buffer: bounds device
# memory; the statistic's values do not depend on it
PS_BUDGET_BYTES = 2_400_000_000
# pruning-tail path: "auto" takes RDP when RDP_BOUNDS_FACTOR * active
# bound entries < live sites (the JAX package's measured crossover,
# fscl_tpu/engine/permute.py:93-102); "on"/"off" force it
RDP_FORCE = os.environ.get("FSCL_RDP", "auto")
RDP_BOUNDS_FACTOR = 24
# replicates per RDP slice: each slice builds [slice, groups] run tables
# and launches its gathers and statistic a candidate chunk at a time, so
# fewer, larger slices keep the host's launches behind the card (at 14M
# sites and 216 rows, slices of 16 left the card idle half the time)
RDP_REP_SUB = 128
POINT_BUCKET = 64  # scan points per lattice statistic call
# elements of one chunk's sigma at the largest tier: the boost tiers are
# clamped to it (fscl_tpu/engine/permute.py:131), so at genome1m's 24,304
# groups the deep tail runs 2,048-replicate chunks as there
SIGMA_ELEM_CAP = 64_000_000
# speculative next-chunk statistic on the stacked path (module doc);
# results are bitwise equal either way
STAT_SPEC = os.environ.get("FSCL_STAT_SPEC", "1") == "1"
STAT_SPEC_MIN_BOOST = 16  # tiers from which the whole next chunk is enqueued

# dispatch counts of the last scan_permute call: chunks through the RDP
# path, stacked statistic dispatches of the chunks taken, lattice
# statistic calls (thresholds and chunks), speculative chunks taken and
# dropped; and its split: the world, the gathers' wall and received
# bytes (parallel/shard.py)
last_stats: dict = {}


@dataclasses.dataclass
class PermuteConfig:
    """Same fields and defaults as fscl_tpu.engine.permute.PermuteConfig."""

    n_permute: int = 0
    permute_nbp: float = 0.1  # accepted for CLI compatibility
    scan_width_mb: float = 1.0
    chunk_replicates: int = 16
    seed: int = 0xFD821A6  # the reference's hard-coded seed (fscl.c:134-137)
    null_dist_save: int = CLR_NULL_DIST_SAVE
    alpha_factor: float = 1.0  # accepted and unused, like the reference
    checkpoint_path: str | None = None  # .npz saved after each chunk; a
    # file that exists resumes the run (engine/checkpoint.py)
    use_hist: bool = True  # False: the lattice statistic
    hist_bf16: bool = True  # bf16 statistic contraction
    hist_positions: int = N_PERM_POS
    stat_densify: int | None = None
    hist_alphas: int = 32
    hist_decimate: int = 8


class _InterruptState:
    """SIGINT -> dump current results and continue (scan-chromosome.c:
    554-569); a second interrupt within 10 seconds aborts."""

    def __init__(self, dump_fn):
        self.dump_fn = dump_fn
        self.requested = False
        self._last = None
        self._prev = None

    def handler(self, signum, frame):
        now = time.monotonic()
        if self._last is not None and now - self._last < 10.0:
            raise KeyboardInterrupt("second interrupt, aborting permutation")
        self._last = now
        self.requested = True

    def __enter__(self):
        try:
            self._prev = signal.signal(signal.SIGINT, self.handler)
        except ValueError:  # not main thread
            self._prev = None
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            signal.signal(signal.SIGINT, self._prev)
        return False

    def maybe_dump(self):
        if self.requested:
            self.requested = False
            if self.dump_fn:
                self.dump_fn()


@contextlib.contextmanager
def _checkpoint(cfg, result, split):
    """The run's Checkpointer, resumed where its file exists (None
    without cfg.checkpoint_path); closed when the run ends, also on an
    exception.  Under a split, rank 0's view of the file decides (the
    broadcast is the barrier before any rank reads), and only rank 0
    writes."""
    if not cfg.checkpoint_path:
        yield None
        return
    found = shard.broadcast_flag(os.path.exists(cfg.checkpoint_path), split)
    ckpt = Checkpointer(cfg.checkpoint_path, result, cfg.seed,
                        write=split.writer, resume=found)
    if ckpt.rounds_done:
        logmsg(MSG_STATUS, "Resumed permutation checkpoint at %d rounds",
               ckpt.rounds_done)
    try:
        yield ckpt
    finally:
        ckpt.close()


def stat_positions(cfg: PermuteConfig) -> int:
    """Jf: the statistic's fine position-grid size per interval."""
    return (cfg.stat_densify or STAT_DENSIFY) * (cfg.hist_positions - 1) + 1


def _record_thresholds(result, pts, threshold):
    """Store the observed statistic values on the result (the tail
    projection uses the same threshold the exceedance counts used)."""
    if getattr(result, "stat_threshold", None) is None:
        result.stat_threshold = np.full(result.n_points, np.nan)
    result.stat_threshold[pts] = threshold[pts]


def _apply_round_updates(result, active, threshold, rng, cfg, act, null_max,
                         rounds_done, R):
    """Exceedance counting + probabilistic pruning for one round's results
    (copied from fscl_tpu/engine/permute.py:366).

    One host RNG draw per exceedance past the threshold, points in
    ``act`` order, so the stream is consumed as the reference does."""
    act = np.asarray(act)
    alive = ~result.permute_finished[act]
    a_alive = np.nonzero(alive)[0]
    if len(a_alive) == 0:
        return
    cap = cfg.null_dist_save
    lens = np.fromiter(
        (len(result.null_clr[act[a]]) for a in a_alive), np.int64,
        count=len(a_alive),
    )
    for a in a_alive[lens < cap]:
        pt = act[a]
        res = result.null_clr[pt]
        res.extend(null_max[: cap - len(res), a].tolist())
    exceed_mat = null_max[:, a_alive] >= threshold[act[a_alive]][None, :]
    finished = np.zeros(len(act), dtype=bool)
    for j in np.nonzero(exceed_mat.any(axis=0))[0]:
        a = a_alive[j]
        pt = act[a]
        for e in np.nonzero(exceed_mat[:, j])[0]:
            result.permute_p[pt] += 1
            result.permute_n[pt] = rounds_done + int(e) + 1
            if (
                result.permute_p[pt] >= PRUNE_THRESHOLD
                and result.permute_p[pt] / max(result.permute_n[pt], 1)
                >= rng.random()
            ):
                finished[a] = True
                break
        if finished[a]:
            result.permute_finished[pt] = True
    survivors = act[a_alive[~finished[a_alive]]]
    result.permute_n[survivors] = rounds_done + R
    active[act[a_alive]] = ~finished[a_alive]


def _fine_cand(result, pts, Jf):
    """[len(pts)*Jf] fine-grid candidate positions for a point set."""
    ist = result.interval_start[pts]
    ien = result.interval_end[pts]
    f = np.linspace(0.0, 1.0, Jf)
    return (ist[:, None] + f[None, :] * (ien - ist)[:, None]).astype(
        np.int64
    ).reshape(-1)


# segment-count padding ladder (fscl_tpu/engine/permute.py:742)
_SEG_LADDER = (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _ladder_pad(n):
    for v in _SEG_LADDER:
        if v >= n:
            return v
    return -(-n // 256) * 256


def _sub_rep_for(ht, n_seg_pad, w_seg_p):
    """Largest replicate slice (<= 2*HIST_REP_SUB) whose prefix buffer
    fits PS_BUDGET_BYTES: 2 bytes an element for one-hot counts, 4 for
    compressed f32 weight channels (fscl_tpu/engine/permute.py:1049);
    and whose P*R lanes the one-hot kernel takes (ONEHOT_LANES_MAX: at
    the widest tables, R = 256, 32 replicates)."""
    bpe = 4 if ht.weights is not None else 2
    p = HIST_REP_SUB * 2
    while p > 1 and (
        n_seg_pad * w_seg_p * p * ht.n_rows * bpe > PS_BUDGET_BYTES
        or p * ht.n_rows > ONEHOT_LANES_MAX
    ):
        p //= 2
    return p


def _stack_stat(table, sigma, seg_g0, bounds, fbar, t3, *, w_seg_p, n_rows,
                n_cells, n_alpha, sub_rep, n_pts, Jf, mm_bf16=False,
                weights=None, prefix_fn=build_prefix_sums_seg,
                clr_fn=_clr_from_windows):
    """Statistic maxima for stacked chromosome segments; [rows, n_pts].

    sigma: [rows, n_sig] sentinel-padded group sigma, taken sub_rep rows
    a slice (the last slice short where sub_rep does not divide rows);
    weights: the compressed tables' [R_used+1, R] weight channels, or
    None in one-hot mode.  Per replicate slice: segmented prefix sums of
    the permuted stream (prefix_fn; the slab of segment s starts one
    group before its chromosome's first, so local site k sits at flat
    row PERM_GROUP + off + k, and the leading and trailing spill cancels
    in the bound differences, fscl_tpu/engine/permute.py:776-795), then
    the hist statistic (clr_fn turns the windows into it) and its max
    over (position, alpha)."""
    outs = []
    for r0 in range(0, sigma.shape[0], sub_rep):
        sig = sigma[r0:r0 + sub_rep]
        ps = prefix_fn(table, sig, seg_g0, w_seg_p=w_seg_p, n_rows=n_rows,
                       weights=weights)
        clr = hist_clr_reps_ps(
            t3, bounds, fbar, ps, n_rep=sig.shape[0], n_cells=n_cells,
            n_rows=n_rows, n_alpha=n_alpha, mm_bf16=mm_bf16, clr_fn=clr_fn,
        )  # [P, n_pts*Jf, A]
        outs.append(clr.reshape(sig.shape[0], n_pts, Jf * n_alpha).amax(2))
    return torch.cat(outs)


def _perm_ps(table, sigma8, *, start, n, w_pad, n_rows):
    """Permuted-stream prefix sums [w_pad+1, P*n_rows] of one chromosome
    (fscl_tpu/engine/permute.py:648): sites start..start+n-1 of the
    permuted genome, zero past n.  table: the thin [G+1, PERM_GROUP]
    int16 row-id table; sigma8: [P, n_sig] sentinel-padded group sigma.
    The gather, shift and mask run inside build_prefix_sums_oh."""
    return build_prefix_sums_oh(table, sigma8, start=start, n=n,
                                w_pad=w_pad, n_rows=n_rows)


def _hist_stat(t3, bounds, fbar, ps, *, n_rep, n_cells, n_rows, n_alpha,
               n_pts, Jf, mm_bf16=False):
    """Statistic maxima per (replicate, point) from prebuilt prefix sums;
    [n_rep, n_pts] (fscl_tpu/engine/permute.py:689)."""
    clr = hist_clr_reps_ps(
        t3, bounds, fbar, ps, n_rep=n_rep, n_cells=n_cells, n_rows=n_rows,
        n_alpha=n_alpha, mm_bf16=mm_bf16,
    )  # [P, n_pts*Jf, A]
    return clr.reshape(n_rep, n_pts, Jf * n_alpha).amax(2)


def _hist_perm_batch(t3, bounds, fbar, row_cg, sigma8, *, n_cells, n_rows,
                     n_alpha, start, n, w_pad, n_pts, Jf):
    """_perm_ps + _hist_stat for one chromosome in one call
    (fscl_tpu/engine/permute.py:708, the single-chromosome statistic of
    the micro-benchmarks).  row_cg: [W] int32 compact row ids of the
    genome; sigma8 carries the sentinel padding _perm_ps needs; bounds
    are chromosome-local."""
    table = make_row_index_group_table(row_cg, sentinel=n_rows)
    ps = _perm_ps(table, sigma8, start=start, n=n, w_pad=w_pad,
                  n_rows=n_rows)
    return _hist_stat(
        t3, bounds, fbar, ps, n_rep=sigma8.shape[0], n_cells=n_cells,
        n_rows=n_rows, n_alpha=n_alpha, n_pts=n_pts, Jf=Jf,
    )


def _rdp_stat(t3, bounds_gen, fbar, psite, src, dst, sz, *, n_cells,
              n_rows, n_alpha, pg, n_groups, sub_rep, n_pts, Jf,
              mm_bf16=False):
    """Statistic maxima via the run-decomposed prefix; [rows, n_pts]
    (fscl_tpu/engine/permute.py:918).  src/dst/sz: [rows, B] group-level
    runs, taken sub_rep replicates at a time; bounds_gen: genome-site
    bounds [n_pts*Jf, 2, NC+1]."""
    outs = []
    for r0 in range(0, src.shape[0], sub_rep):
        s, d, z = (x[r0:r0 + sub_rep] for x in (src, dst, sz))
        clr = rdp_clr_reps(
            t3, bounds_gen, fbar, psite, s, d, z, n_rep=s.shape[0],
            n_cells=n_cells, n_rows=n_rows, n_alpha=n_alpha, pg=pg,
            n_groups=n_groups, mm_bf16=mm_bf16,
        )  # [P, n_pts*Jf, A]
        outs.append(clr.reshape(s.shape[0], n_pts, Jf * n_alpha).amax(2))
    return torch.cat(outs)


class _StackGroup:
    """Live chromosomes of one padded-length class, stacked for dispatch.

    Holds per-segment start groups plus the merged run geometry
    (bounds/fbar) over the active points of its chromosomes; rebuilt when
    the active count halves or a rung of the segment ladder drops."""

    def __init__(self, ht, w_seg_p, segs, eval_range, Jf):
        self.ht = ht
        self.w_seg_p = w_seg_p
        self.segs = segs  # [(chr_index, start, n, pos_np, dev_arrays)]
        self.eval_range = eval_range
        self.Jf = Jf
        self.pts = None  # active point ids in geometry order
        self.n_seg_pad = 0
        self.bounds = self.fbar = self.seg_g0 = None
        self.sub_rep = HIST_REP_SUB

    def rebuild(self, result, pts_by_chr):
        """Flat-axis geometry for the given active points
        ({chr_index: point ids}); bounds shift to slot*w_seg_p +
        PERM_GROUP - 1 + off + local (bound b reads the inclusive prefix
        through site b - 1)."""
        ht, Jf = self.ht, self.Jf
        dev = ht.t3.device
        live = [s for s in self.segs if len(pts_by_chr.get(s[0], ())) > 0]
        S_pad = _ladder_pad(max(len(live), 1))
        g0 = np.zeros(S_pad, np.int32)
        b_parts, f_parts, pts_all = [], [], []
        for slot, (c, start, n, pos_np, dev_arrays) in enumerate(live):
            g0[slot] = start // PERM_GROUP
            off = start - int(g0[slot]) * PERM_GROUP
            pts = pts_by_chr[c]
            hp = build_hist_points(
                ht, pos_np, _fine_cand(result, pts, Jf), self.eval_range,
                cand_pad=Jf, device_arrays=dev_arrays,
            )
            base = slot * self.w_seg_p + PERM_GROUP - 1 + off
            b_parts.append(hp.bounds + base)
            f_parts.append(hp.fbar)
            pts_all.append(pts)
        self.pts = (
            np.concatenate(pts_all) if pts_all else np.zeros(0, np.int64)
        )
        NC = ht.n_cells
        self.bounds = torch.cat(b_parts) if b_parts else torch.zeros(
            (0, 2, NC + 1), dtype=torch.int32, device=dev
        )
        self.fbar = torch.cat(f_parts) if f_parts else torch.zeros(
            (0, 2, NC), dtype=torch.float32, device=dev
        )
        self.n_seg_pad = S_pad
        self.seg_g0 = torch.as_tensor(g0, device=dev)
        self.sub_rep = _sub_rep_for(ht, S_pad, self.w_seg_p)

    def due(self, result, active):
        """Whether compaction should rebuild on the current active set."""
        on = self.pts[active[self.pts]]
        if len(on) == 0:
            return False
        n_chr = len(np.unique(result.chr_id[on]))
        return 2 * len(on) <= len(self.pts) or _ladder_pad(n_chr) < \
            self.n_seg_pad

    def stat(self, table, sigma, cfg, prefix_fn=build_prefix_sums_seg,
             clr_fn=_clr_from_windows):
        """[sigma rows, len(pts)] statistic maxima of the active points."""
        ht = self.ht
        return _stack_stat(
            table, sigma, self.seg_g0, self.bounds, self.fbar, ht.t3,
            w_seg_p=self.w_seg_p, n_rows=ht.n_rows, n_cells=ht.n_cells,
            n_alpha=ht.n_alpha, sub_rep=self.sub_rep, n_pts=len(self.pts),
            Jf=self.Jf, mm_bf16=cfg.hist_bf16, weights=ht.weights,
            prefix_fn=prefix_fn, clr_fn=clr_fn,
        )


@dataclasses.dataclass
class HistSetup:
    """Tables, row-id group table and stacks of one permutation run."""

    ht: object
    row_cg: torch.Tensor  # [W] int32 compact row id of every site
    table: torch.Tensor  # [G+1, PERM_GROUP] int16 row ids
    stacks: list
    n_groups: int
    margin: int

    def pad_sigma(self, sig):
        """Append the sentinel columns every segment's slab can reach."""
        if not isinstance(sig, torch.Tensor):
            sig = torch.from_numpy(np.array(sig, dtype=np.int32))
        sig = sig.to(device=self.table.device, dtype=torch.int32)
        pad = torch.full((sig.shape[0], self.margin), self.n_groups,
                         dtype=torch.int32, device=sig.device)
        return torch.cat([sig, pad], 1).contiguous()


def setup_hist(data, tables, result, scan_cfg, cfg, device):
    """Hist tables, the thin row-id group table (whose ids index the
    weight rows in compressed mode) and the stack groups."""
    Jf = stat_positions(cfg)
    ht = make_scan_hist_tables(
        data, tables, n_alpha=cfg.hist_alphas, decimate=cfg.hist_decimate,
        device=device,
    )
    cache = _port_cache(data, device)
    key = ("row-cg", ht.n_rows, ht.sentinel)
    if key not in cache:
        row_cg = torch.as_tensor(
            ht.row_map[np.asarray(data.row)].astype(np.int32), device=device
        )
        cache[key] = (row_cg, make_row_index_group_table(
            row_cg, sentinel=ht.sentinel))
    row_cg, table = cache[key]
    n_groups = table.shape[0] - 1  # sentinel row index
    by_len: dict = {}
    for c, cl in enumerate(data.chr_limits):
        if cl.n_snps == 0 or not (result.chr_id == c).any():
            continue
        w_seg_p = -(-(cl.n_snps + 2 * PERM_GROUP) // 4096) * 4096
        pos_np = np.asarray(
            data.pos[cl.start_index : cl.start_index + cl.n_snps]
        )
        by_len.setdefault(w_seg_p, []).append(
            (c, cl.start_index, cl.n_snps, pos_np,
             get_hist_device_arrays(data, ht, pos_np, cl.start_index))
        )
    stacks = [
        _StackGroup(ht, w, segs, scan_cfg.eval_range, Jf)
        for w, segs in sorted(by_len.items())
    ]
    # sentinel margin: segment s's slab reads groups up to
    # seg_g0 + w_seg_p / PERM_GROUP - 2
    margin = max(
        [2] + [
            2 + seg[1] // PERM_GROUP + st.w_seg_p // PERM_GROUP - 1
            - n_groups
            for st in stacks for seg in st.segs
        ]
    )
    return HistSetup(ht=ht, row_cg=row_cg, table=table, stacks=stacks,
                     n_groups=n_groups, margin=margin)


def active_by_chr(result, st, act):
    """{chr_index: active point ids} for one stack."""
    out = {}
    for c, *_ in st.segs:
        pts = np.where((result.chr_id == c) & act)[0]
        if len(pts):
            out[c] = pts
    return out


class _RdpTail:
    """The run-decomposed pruning-tail path of one permutation run
    (fscl_tpu/engine/permute.py:1812-1913).

    Geometry is genome-site bounds over the active points, in the stacked
    drain order (stacks, then segments, then ascending point ids), so
    _apply_round_updates consumes the host RNG exactly as on the stacked
    path; it is rebuilt whenever the active set changes.  The site prefix
    psite is built once, at the first RDP chunk."""

    def __init__(self, hs, result, eval_range, Jf, runs_source, mm_bf16):
        self.hs = hs
        self.result = result
        self.eval_range = eval_range
        self.Jf = Jf
        self.runs_source = runs_source
        self.mm_bf16 = mm_bf16
        self.chr_sites = {seg[0]: seg[2] for st in hs.stacks
                          for seg in st.segs}
        self.psite = None
        self.ctx = None  # (active-set key, pts, bounds_gen, fbar)

    def wanted(self, active):
        """Whether the next chunk takes the RDP path."""
        if self.hs.ht.weights is not None or RDP_FORCE == "off":
            return False
        if RDP_FORCE == "on":
            return True
        n_act = int(active.sum())
        if n_act == 0:
            return False
        live = np.unique(self.result.chr_id[active])
        live_sites = sum(self.chr_sites.get(int(c), 0) for c in live)
        bound_entries = n_act * self.Jf * 2 * (self.hs.ht.n_cells + 1)
        return RDP_BOUNDS_FACTOR * bound_entries < live_sites

    def _rebuild(self, active):
        ht, result, Jf = self.hs.ht, self.result, self.Jf
        parts_b, parts_f, pts_all = [], [], []
        for st in self.hs.stacks:
            for c, start, _, pos_np, dev_arrays in st.segs:
                pts = np.where((result.chr_id == c) & active)[0]
                if len(pts) == 0:
                    continue
                hp = build_hist_points(
                    ht, pos_np, _fine_cand(result, pts, Jf), self.eval_range,
                    cand_pad=Jf, device_arrays=dev_arrays,
                )
                parts_b.append(hp.bounds + start)
                parts_f.append(hp.fbar)
                pts_all.append(pts)
        return (np.concatenate(pts_all), torch.cat(parts_b),
                torch.cat(parts_f))

    def chunk(self, active, R, start):
        """(pts, [R, len(pts)] statistic maxima) of replicates
        start..start+R-1, RDP_REP_SUB replicates a slice."""
        hs = self.hs
        ht = hs.ht
        if self.psite is None:
            self.psite = build_site_prefix(hs.row_cg, n_rows=ht.n_rows)
        key = active.tobytes()
        if self.ctx is None or self.ctx[0] != key:
            with span("permute.compact"):
                self.ctx = (key, *self._rebuild(active))
        _, pts, bounds, fbar = self.ctx
        rp = -(-R // HIST_REP_SUB) * HIST_REP_SUB
        dev = ht.t3.device
        with span("permute.draw"):
            src, dst, sz = (
                torch.as_tensor(x if isinstance(x, torch.Tensor)
                                else np.array(x))
                .to(device=dev, dtype=torch.int32)
                for x in self.runs_source(rp, start)
            )
        out = _rdp_stat(
            ht.t3, bounds, fbar, self.psite, src, dst, sz,
            n_cells=ht.n_cells, n_rows=ht.n_rows, n_alpha=ht.n_alpha,
            pg=PERM_GROUP, n_groups=hs.n_groups, sub_rep=RDP_REP_SUB,
            n_pts=len(pts), Jf=self.Jf, mm_bf16=self.mm_bf16,
        )
        last_stats["rdp_dispatches"] += 1
        return pts, out[:R]


@traced("permute.pass", step=True)
def scan_permute(data, tables, result, scan_cfg, cfg: PermuteConfig,
                 dump_fn=None, device="cuda", sigma_source=None,
                 runs_source=None, split=None):
    """Run up to cfg.n_permute block-permutation rounds with pruning.

    Mutates ``result`` in place: permute_n / permute_p / permute_finished,
    stat_threshold and the per-point null reservoirs.  sigma_source(n,
    start) -> [n, G] int32 group sigma of replicates start..start+n-1;
    runs_source(n, start) -> their (src, dst, sz) [n, B] int32 runs, for
    the RDP path.  The defaults are this package's
    block_permutation_groups and block_permutation_runs, one stream; an
    injected sigma_source without runs_source gets the runs of its own
    sigma (runs_from_sigma), so both paths see one stream.  The lattice
    path (use_hist=False, or a dataset past the hist gate) expands the
    same group sigma to sites.  ``split``: this process's parallel.Split
    (None: a world of one); see the module doc.
    """
    device = parse_device(device)
    split = split or SOLO
    if cfg.n_permute <= 0:
        return result
    if RDP_FORCE not in ("auto", "on", "off"):
        raise ValueError(f"FSCL_RDP={RDP_FORCE!r}: use auto, on or off")
    use_hist = cfg.use_hist
    if use_hist:
        # the hist gate (rows, sites, block geometry and, past
        # WIDE_ROWS_MAX rows, the rank ladder), decided once a data
        # object where its tables are built and memoized for setup_hist
        with span("permute.setup"):
            use_hist = make_scan_hist_tables(
                data, tables, n_alpha=cfg.hist_alphas,
                decimate=cfg.hist_decimate, device=device,
            ) is not None
        if not use_hist:
            logmsg(MSG_STATUS, "histogram permutation path unsupported here "
                   "(%d distinct rows, %d sites); using the lattice path",
                   len(np.unique(np.asarray(data.row))),
                   max((cl.n_snps for cl in data.chr_limits), default=0))
    # memoized a data object, so that the stream reuses its group
    # positions and brackets (ops/permute.py) from pass to pass
    cache = _port_cache(data, device)
    if "gpos" not in cache:
        cache["gpos"] = data.genome_pos()
    gpos = cache["gpos"]
    width_bp = cfg.scan_width_mb * 1e6
    if sigma_source is None:
        def sigma_source(n, start):
            return block_permutation_groups(
                cfg.seed, gpos, width_bp, n, start=start, device=device
            )

        if runs_source is None:
            def runs_source(n, start):
                return block_permutation_runs(
                    cfg.seed, gpos, width_bp, n, start=start, device=device
                )
    if runs_source is None:
        def runs_source(n, start):
            return runs_from_sigma(sigma_source(n, start))

    last_stats.clear()
    last_stats.update(rdp_dispatches=0, stack_dispatches=0,
                      lattice_dispatches=0, hist_spec_chunks=0,
                      hist_spec_misses=0)
    g0 = dict(shard.stats)
    if use_hist:
        _scan_permute_hist(data, tables, result, scan_cfg, cfg, dump_fn,
                           device, sigma_source, runs_source, split)
    else:
        _scan_permute_lattice(data, tables, result, scan_cfg, cfg, dump_fn,
                              device, sigma_source, split)
    last_stats.update(shard.split_stats(g0, split))
    bad = ~np.isfinite(result.clr)
    if bad.any():
        logmsg(MSG_WARN, "%d scan points with non-finite CLR", int(bad.sum()))
    return result


def boost_cap(n_groups, chunk_replicates):
    """Largest boost tier whose sigma stays within SIGMA_ELEM_CAP
    elements (fscl_tpu/engine/permute.py:1424, :1445): R_gen rounds
    chunk_replicates up to whole HIST_REP_SUB slices."""
    r_gen = -(-chunk_replicates // HIST_REP_SUB) * HIST_REP_SUB
    return max(1, SIGMA_ELEM_CAP // max(n_groups, 1) // max(r_gen, 1))


def boost_tier(n_act, rounds_done, chunk_replicates, cap):
    """Replicates per chunk, in chunk_replicates, as pruning leaves few
    survivors (fscl_tpu/engine/permute.py:1447-1466): 4 mid-run, 16 and
    64 near the tail, 128 in the deep tail after the first chunk, each
    halved while above the cap."""
    b = 1
    if (n_act <= HIST_POINT_BUCKET * 4
            and rounds_done >= 8 * chunk_replicates):
        b = 4
    if n_act <= HIST_POINT_BUCKET // 4:
        b = 16
    if n_act <= HIST_POINT_BUCKET // 8:
        b = 64
    if n_act <= HIST_POINT_BUCKET // 8 and rounds_done > 0:
        b = 128
    while b > cap:
        b //= 2
    return max(b, 1)


class _Readback:
    """A device tensor's copy to the host, enqueued now and awaited by
    wait(): into pinned memory behind an event on the card, so work
    enqueued after it runs on while the host waits; at once on the
    CPU."""

    def __init__(self, t):
        self._src = t
        self._event = None
        if t.device.type == "cuda":
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._buf = t

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
        self._src = None
        return self._buf.numpy()


def _scan_permute_hist(data, tables, result, scan_cfg, cfg, dump_fn, device,
                       sigma_source, runs_source, split):
    rng = np.random.default_rng(cfg.seed)
    with span("permute.setup"):
        hs = setup_hist(data, tables, result, scan_cfg, cfg, device)
        rdp = _RdpTail(hs, result, scan_cfg.eval_range, stat_positions(cfg),
                       runs_source, cfg.hist_bf16)
        K = result.n_points
        for i in range(K):
            if result.null_clr[i] is None:
                result.null_clr[i] = []
    if split.world > 1:
        rdp = None
        logmsg(MSG_STATUS, "Permutation replicates split over %d ranks "
               "(the RDP tail is off under a split)", split.world)
    cap = boost_cap(hs.n_groups, cfg.chunk_replicates)

    def _boost(n_act, rounds_done):
        return boost_tier(n_act, rounds_done, cfg.chunk_replicates, cap)

    # a resume restores the finished flags and every point's threshold
    # before ``active`` is taken: finished points stay finished, and the
    # threshold pass recomputes only the points still active
    with _checkpoint(cfg, result, split) as ckpt:
        active = ~result.permute_finished.copy()
        rounds_done = ckpt.rounds_done if ckpt is not None else 0
        if rounds_done >= cfg.n_permute:
            active[:] = False  # a finished run: no chunk, no threshold
        # observed thresholds under the identical statistic: sigma = identity
        threshold = np.zeros(K)
        with span("permute.setup"):
            obs_sigma = hs.pad_sigma(torch.arange(
                hs.n_groups, dtype=torch.int32, device=device)[None])
            for st in hs.stacks:
                st.rebuild(result, active_by_chr(result, st, active))
                if len(st.pts):
                    sub_save, st.sub_rep = st.sub_rep, 1
                    obs = st.stat(hs.table, obs_sigma, cfg)
                    st.sub_rep = sub_save
                    threshold[st.pts] = obs[0].cpu().numpy()
                    _record_thresholds(result, st.pts, threshold)

        # the next chunk's sigma ((boost, start), padded rows of this
        # rank) and whole statistic ((boost, start, R), blocks), enqueued
        # before the current chunk's drain
        spec_sigma = spec_chunk = None

        def _drop_spec():
            nonlocal spec_chunk
            if spec_chunk is not None:
                last_stats["hist_spec_misses"] += 1
            spec_chunk = None

        def _speculate(start, n_act):
            """Enqueue the next chunk's sigma and, in the tail tiers, its
            statistic; (spec_sigma, spec_chunk)."""
            if rdp is not None and rdp.wanted(active):
                return None, None
            b = _boost(n_act, start)
            R_n = min(cfg.chunk_replicates * b, cfg.n_permute - start)
            q0, q1 = shard.split_range(R_n, split)
            if q1 == q0:
                return None, None
            with span("permute.draw"):
                sig = hs.pad_sigma(sigma_source(q1 - q0, start + q0))
            chunk = None
            if STAT_SPEC and split.world == 1 and b >= STAT_SPEC_MIN_BOOST:
                chunk = ((b, start, R_n),
                         _stack_chunk(hs, cfg, result, active, R_n, start,
                                      sigma_source, sig))
            return ((b, start), sig), chunk

        with _InterruptState(dump_fn) as intr:
            while active.any() and rounds_done < cfg.n_permute:
                with span("permute.chunk") as turn:
                    n_act = int(active.sum())
                    boost = _boost(n_act, rounds_done)
                    R = min(cfg.chunk_replicates * boost,
                            cfg.n_permute - rounds_done)
                    path = ("rdp" if rdp is not None and rdp.wanted(active)
                            else "hist")
                    turn.set(path=path, R=R, boost=boost, n_active=n_act)
                    if path == "rdp":
                        _drop_spec()
                        spec_sigma = None
                        with span("permute.stat"):
                            pts, out = rdp.chunk(active, R, rounds_done)
                        blocks = [(pts, out)]
                        with span("permute.drain"):
                            host = out.cpu().numpy()
                    else:
                        r0, r1 = shard.split_range(R, split)
                        if (spec_chunk is not None
                                and spec_chunk[0] == (boost, rounds_done, R)
                                and not _compaction_due(hs, result, active)):
                            blocks = spec_chunk[1]
                            spec_chunk = None
                            last_stats["hist_spec_chunks"] += 1
                        else:
                            _drop_spec()
                            sig = (spec_sigma[1] if spec_sigma is not None
                                   and spec_sigma[0] == (boost, rounds_done)
                                   else None)
                            blocks = _stack_chunk(hs, cfg, result, active,
                                                  r1 - r0, rounds_done + r0,
                                                  sigma_source, sig)
                        spec_sigma = None
                        if r1 > r0:
                            last_stats["stack_dispatches"] += len(blocks)
                        with span("permute.stat"):
                            pending = _Readback(
                                torch.cat([o for _, o in blocks], 1))
                        if rounds_done + R < cfg.n_permute:
                            with span("permute.speculate"):
                                spec_sigma, spec_chunk = _speculate(
                                    rounds_done + R, int(active.sum()))
                        with span("permute.drain"):
                            host = shard.gather_rows(pending.wait(), R, split)
                    with span("permute.update"):
                        off = 0
                        for pts, _ in blocks:
                            _apply_round_updates(
                                result, active, threshold, rng, cfg, pts,
                                host[:, off:off + len(pts)], rounds_done, R,
                            )
                            off += len(pts)
                    rounds_done += R
                    cr_logmsg(
                        MSG_STATUS,
                        "Scanning snp block permutations... %7d (%d scan "
                        "pts remaining)", rounds_done, int(active.sum()),
                    )
                    with span("permute.save"):
                        if ckpt is not None:
                            ckpt.save(result, rounds_done)
                        intr.maybe_dump()
            _drop_spec()
    logmsg(
        MSG_STATUS,
        "Scanning snp block permutations... finished (%d rounds).",
        rounds_done,
    )
    return result


def _compaction_due(hs, result, active):
    """Whether a live stack is due a compaction on ``active``: a
    speculative chunk, built on the geometry before the drain, is then
    not the chunk a plain dispatch would build."""
    return any(st.due(result, active) for st in hs.stacks
               if st.pts is not None and active[st.pts].any())


def _stack_chunk(hs, cfg, result, active, R, start, sigma_source,
                 sigma=None):
    """[(pts, [R, len(pts)] statistic maxima)] of replicates start ..
    start + R - 1 on the stacked path, one entry per live stack
    (compacted first where due; R = 0, a rank without a share of the
    chunk, compacts and launches nothing).  sigma: the chunk's padded
    rows drawn ahead, else drawn here."""
    with span("permute.compact"):
        live = [st for st in hs.stacks
                if st.pts is not None and active[st.pts].any()]
        for st in live:
            if st.due(result, active):
                st.rebuild(result, active_by_chr(result, st, active))
    if R == 0:
        return [(st.pts, torch.zeros((0, len(st.pts)))) for st in live]
    # exactly the chunk's rows, in slices of sub_rep (the last one
    # short): a rank of a split draws and evaluates its own rows only
    if sigma is None:
        with span("permute.draw"):
            sigma = hs.pad_sigma(sigma_source(R, start))
    with span("permute.stat"):
        return [(st.pts, st.stat(hs.table, sigma, cfg)) for st in live]


class _ChrPermContext:
    """One chromosome's positions on the device and its point ids, for the
    lattice statistic (fscl_tpu/engine/permute.py:306-354)."""

    def __init__(self, data, cl, scan_cfg, pts, Jf, device):
        self.start = cl.start_index
        self.n = cl.n_snps
        self.pos_np = np.asarray(data.pos[self.start:self.start + self.n])
        self.pos = torch.as_tensor(self.pos_np.astype(np.int32),
                                   device=device)
        self.point_ids = pts
        self.Jf = Jf
        self.eval_range = scan_cfg.eval_range
        self.device = device

    def build_batch(self, result, pts_subset):
        """(cand, lo, hi) [len(pts_subset) * Jf] int32 on the device: the
        statistic's position grid (fscl_tpu's perm_positions)."""
        cand = _fine_cand(result, pts_subset, self.Jf)
        _, lo, hi = candidate_windows(self.pos_np, cand, self.eval_range)
        return tuple(torch.as_tensor(x.astype(np.int32), device=self.device)
                     for x in (cand, lo, hi))


def _stat_max(lt, row, null, pos, cand, lo, hi, *, n_pts, Jf):
    """The lattice permutation statistic: per (replicate, interval), the
    max CLR over the fixed Jf-point position grid of the coarse and fine
    lattice alpha stages (no ultra stage, as
    fscl_tpu/engine/permute.py:188-206).  row/null [Rr, n]; [Rr, n_pts]."""
    clr, _ = two_stage_lattice_max(lt, row, pos, null, cand, lo, hi,
                                   ultra=False)
    last_stats["lattice_dispatches"] += 1
    return clr.reshape(row.shape[0], n_pts, Jf).amax(2)


def _scan_permute_lattice(data, tables, result, scan_cfg, cfg, dump_fn,
                          device, sigma_source, split):
    """The lattice branch of fscl_tpu/engine/permute.py:scan_permute
    (:460-644): thresholds per POINT_BUCKET points of each chromosome,
    then chunks of chunk_replicates replicates, pruned between chunks."""
    rng = np.random.default_rng(cfg.seed)
    with span("permute.setup"):
        lt = get_lattice_tables(tables, device)
        Jf = stat_positions(cfg)
        row_gen = torch.as_tensor(np.asarray(data.row, dtype=np.int32),
                                  device=device)
        null_gen = torch.as_tensor(
            np.asarray(data.null_logl, dtype=np.float32), device=device)
        W = row_gen.shape[0]
        K = result.n_points
        for i in range(K):
            if result.null_clr[i] is None:
                result.null_clr[i] = []
        chr_ctx = []
        threshold = np.zeros(K)
        for c, cl in enumerate(data.chr_limits):
            pts = np.where(result.chr_id == c)[0]
            if len(pts) == 0:
                continue
            ctx = _ChrPermContext(data, cl, scan_cfg, pts, Jf, device)
            chr_ctx.append(ctx)
            sl = slice(ctx.start, ctx.start + ctx.n)
            row, null = row_gen[None, sl], null_gen[None, sl]
            for g0 in range(0, len(pts), POINT_BUCKET):
                grp = pts[g0:g0 + POINT_BUCKET]
                obs = _stat_max(lt, row, null, ctx.pos,
                                *ctx.build_batch(result, grp),
                                n_pts=len(grp), Jf=Jf)
                threshold[grp] = obs[0].cpu().numpy()
        _record_thresholds(result, np.arange(K), threshold)

    # opened after the thresholds are recorded, as the JAX package does:
    # a resume's replay overwrites them with the checkpointed values
    with _checkpoint(cfg, result, split) as ckpt, \
            _InterruptState(dump_fn) as intr:
        active = ~result.permute_finished.copy()
        rounds_done = ckpt.rounds_done if ckpt is not None else 0
        while active.any() and rounds_done < cfg.n_permute:
            with span("permute.chunk") as turn:
                R = min(cfg.chunk_replicates, cfg.n_permute - rounds_done)
                turn.set(path="lattice", R=R, boost=1,
                          n_active=int(active.sum()))
                r0, r1 = shard.split_range(R, split)
                sigma = None
                if r1 > r0:
                    with span("permute.draw"):
                        sig8 = sigma_source(r1 - r0, rounds_done + r0)
                        if not isinstance(sig8, torch.Tensor):
                            sig8 = torch.from_numpy(
                                np.array(sig8, dtype=np.int32))
                        sigma = expand_group_sigma(
                            sig8.to(device=device, dtype=torch.int64), W)
                for ctx in chr_ctx:
                    act_all = ctx.point_ids[active[ctx.point_ids]]
                    if len(act_all) == 0:
                        continue
                    groups = [act_all[g0:g0 + POINT_BUCKET]
                              for g0 in range(0, len(act_all), POINT_BUCKET)]
                    out = None
                    if sigma is not None:
                        with span("permute.stat"):
                            idx = sigma[:, ctx.start:ctx.start + ctx.n]
                            row, null = row_gen[idx], null_gen[idx]  # [Rr, n]
                            out = torch.cat([
                                _stat_max(lt, row, null, ctx.pos,
                                          *ctx.build_batch(result, act),
                                          n_pts=len(act), Jf=Jf)
                                for act in groups], 1)
                    with span("permute.drain"):
                        # no replicate of this chunk may be this rank's
                        mine = (out.cpu().numpy() if out is not None else
                                np.zeros((0, len(act_all)), np.float32))
                        host = shard.gather_rows(mine, R, split)
                    with span("permute.update"):
                        off = 0
                        for act in groups:
                            _apply_round_updates(
                                result, active, threshold, rng, cfg, act,
                                host[:, off:off + len(act)], rounds_done, R,
                            )
                            off += len(act)
                rounds_done += R
                cr_logmsg(
                    MSG_STATUS,
                    "Scanning snp block permutations... %7d (%d scan pts "
                    "remaining)", rounds_done, int(active.sum()),
                )
                with span("permute.save"):
                    if ckpt is not None:
                        ckpt.save(result, rounds_done)
                    intr.maybe_dump()
    logmsg(
        MSG_STATUS,
        "Scanning snp block permutations... finished (%d rounds).",
        rounds_done,
    )
    return result
