"""The CLR at arbitrary sweep strengths and the reference's two-stage
alpha search (port of fscl_tpu/ops/clr.py).

``clr_grid`` (fscl_tpu/ops/clr.py:88-166, XLA-fused in the JAX package)
computes, for candidate p and log-alpha a (``lalpha`` [A] shared by every
candidate, or [P, A] with ``paired_alpha``):

    d      = max(|pos_w - cand_p|, 1)
    x      = log(d) + lalpha[., a]
    u      = (x - LOG_AD_MIN) * inv_step
    i      = clamp(int(u), 0, G-2);  frac = clamp(u - i, 0, 1)
    y      = v0 * (1 - frac) + v1 * frac,  v0, v1 = table[row_w*G + i (+1)]
    clr    = 2 * sum over w in [lo_p, hi_p] with x <= LOG_AD_MAX
             of (y - null_w)

in float32, inv_step rounded to float32 once and y one fused
multiply-add, fma(v0, 1 - frac, v1 * frac), as XLA's CPU build fuses
fscl_tpu's expression: the plain version takes it in float64, where the
product is exact, and rounds once; the kernel uses fmaf.  A candidate
with lo > hi gives exactly 0.  ``clr_grid_plain`` is the plain PyTorch
version; the wrapper ``clr_grid`` runs it for CPU tensors and launches
the CUDA kernel (csrc/clr_grid.cu) for CUDA tensors, never falling back
from one to the other.  ``clr_grid_launches`` counts the kernel
launches (two a call: the slice sums, then their sum; one where no
window is live).  The JAX version pads candidates into chunks; this one
walks each candidate's window alone.  The kernel cuts the sites into
slices of SLICE_SITES, a block a group of BLOCK_CANDS candidates, one
slice and a tile of alphas (``clr_grid_plan`` sizes its grid and
scratch); an entry's sum order depends on its window alone, so the
output does not depend on which candidates share a call.

``two_stage_alpha_max`` is the reference's search (sm-search.c:269-300):
the 11 coarse alphas, then 14 fine ones inside the winner's bracket, the
best of the 25 per candidate.  Its stage logic is torch: where values
tie, the first maximum wins, as ``jnp.argmax`` does.

The lattice path's fine list has 16 offsets (ops/lattice.py N_FINE); the
14 here are the reference's fine points.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import LOG_AD_MAX, LOG_AD_MIN
from ..device import parse_device
from .gather import _device
from .lattice import lattice_inv_step  # also clr_grid's inv_step

# C alpha grid: step (MAX-MIN)/10, loop lalpha = MIN; lalpha <= MAX
# (sm-search.c:276-282) -> 11 coarse values.
N_COARSE = 11
# fine stage: 15 subdivisions of the winning +-step bracket, evaluated at
# left + k*fstep for k = 1..14 (sm-search.c:289-295).
N_FINE = 14
# csrc/clr_grid.cu's constants (the wrapper reads the built library's)
BLOCK_CANDS = 32  # candidates a block, one a lane (kGroup)
SLICE_SITES = 1024  # sites a slice (kSlice)
TILE_ALPHAS = 16  # alphas a block (kTileA)
PLAIN_TERMS = 1 << 22  # the plain version's [C, L, A] terms a chunk
clr_grid_launches = 0  # CUDA kernel launches by launch_clr_grid


def coarse_alpha_grid() -> np.ndarray:
    return np.linspace(LOG_AD_MIN, LOG_AD_MAX, N_COARSE).astype(np.float32)


def _f32(v):
    return float(np.float32(v))


def fine_alpha_grids(best_la):
    """Per-candidate fine lalpha grids around the coarse winner, [P] ->
    [P, N_FINE] float32 (sm-search.c:284-295): bracket = best +- coarse
    step clamped to the domain, fstep = width / 15, values at left +
    k*fstep, k = 1..14.  Rounded as XLA's CPU build compiles fscl_tpu's
    version inside its jitted two_stage_alpha_max: fstep a product with
    1/15 in float32, left + k*fstep one fused multiply-add (float64 here:
    the product and the sum are exact)."""
    step = _f32((LOG_AD_MAX - LOG_AD_MIN) / (N_COARSE - 1))
    left = torch.clamp_min(best_la - step, LOG_AD_MIN)
    right = torch.clamp_max(best_la + step, LOG_AD_MAX)
    fstep = (right - left) * _f32(1.0 / 15.0)
    k = torch.arange(1, N_FINE + 1, dtype=torch.float64,
                     device=best_la.device)
    return (k[None, :] * fstep[:, None].double()
            + left[:, None].double()).float()


def _inputs(table_flat, row, pos, null, cand_pos, lo, hi, lalpha, device):
    """Every argument as a contiguous tensor of its type on ``device``."""
    f32, i32 = torch.float32, torch.int32
    return [torch.as_tensor(x, dtype=dt, device=device).contiguous()
            for x, dt in ((table_flat, f32), (row, i32), (pos, i32),
                          (null, f32), (cand_pos, i32), (lo, i32),
                          (hi, i32), (lalpha, f32))]


def _check_shapes(table_flat, row, pos, null, cand_pos, lo, hi, lalpha,
                  grid_points, paired_alpha):
    W, P = row.shape[0] if row.dim() == 1 else -1, cand_pos.shape[0]
    la_ok = (lalpha.dim() == 2 and lalpha.shape[0] == P) if paired_alpha \
        else lalpha.dim() == 1
    if (row.dim() != 1 or tuple(pos.shape) != (W,)
            or tuple(null.shape) != (W,) or cand_pos.dim() != 1
            or tuple(lo.shape) != (P,) or tuple(hi.shape) != (P,)
            or not la_ok or table_flat.dim() != 1 or grid_points < 2
            or table_flat.shape[0] % grid_points):
        raise ValueError(
            f"clr_grid: table {tuple(table_flat.shape)}, row "
            f"{tuple(row.shape)}, pos {tuple(pos.shape)}, null "
            f"{tuple(null.shape)}, cand {tuple(cand_pos.shape)}, lo "
            f"{tuple(lo.shape)}, hi {tuple(hi.shape)}, lalpha "
            f"{tuple(lalpha.shape)} (paired_alpha={paired_alpha}) do not "
            f"fit an [R*{grid_points}] table, [W] sites, [P] candidates "
            f"and [A] or [P, A] alphas"
        )


def _check_ranges(table_flat, row, lo, hi, grid_points):
    """Every live window (lo <= hi) inside [0, W) and every row inside
    [0, R): the kernel reads pos, row, null and the table unchecked.  lo
    and hi (numpy int64) from the one copy to the host."""
    W, R = row.shape[0], table_flat.shape[0] // grid_points
    bad_row = ((row < 0) | (row >= R)).any()
    P = lo.shape[0]
    host = torch.cat([lo.long(), hi.long(), bad_row.long()[None]]).cpu() \
        .numpy()
    lo_h, hi_h, bad_row = host[:P], host[P:2 * P], host[2 * P]
    live = lo_h <= hi_h
    bad_win = bool((live & ((lo_h < 0) | (hi_h >= W))).any())
    if bad_win or bad_row:
        raise ValueError(
            "clr_grid: " + ("a window with lo <= hi outside [0, "
                            f"{W}) sites" if bad_win else
                            f"a table row outside [0, {R})")
        )
    return lo_h, hi_h


def clr_grid_plan(lo, hi, group=BLOCK_CANDS, slice_sites=SLICE_SITES):
    """The kernel's slices, from lo and hi as numpy integer arrays: (the
    most slices one live window meets, the scratch's [slices, P, A]; the
    most that the live windows of one group of ``group`` consecutive
    candidates meet, the grid's second dimension).  Slice s holds the
    sites [s * slice_sites, (s + 1) * slice_sites); a block (group g, j)
    takes slice first_g + j, first_g the group's first."""
    lo, hi = np.asarray(lo, np.int64), np.asarray(hi, np.int64)
    live = lo <= hi
    if not live.any():
        return 0, 0
    first = np.where(live, lo // slice_sites, 1 << 62)
    last = np.where(live, hi // slice_sites, -1)
    starts = np.arange(0, len(lo), group)
    span = (np.maximum.reduceat(last, starts)
            - np.minimum.reduceat(first, starts) + 1)
    return int((last - first)[live].max()) + 1, int(span.max())


def clr_grid_plain(table_flat, row, pos, null, cand_pos, lo, hi, lalpha, *,
                   grid_points, paired_alpha=False):
    """Plain PyTorch version: [P, A] float32 (see module doc).  Each
    candidate's window is gathered as L = the widest window's sites from
    its lo (sites past hi masked), a chunk of candidates at a time."""
    G = grid_points
    P = cand_pos.shape[0]
    A = lalpha.shape[-1]
    dev = table_flat.device
    la = lalpha if paired_alpha else lalpha[None].expand(P, A)
    out = torch.zeros((P, A), dtype=torch.float32, device=dev)
    live = torch.nonzero(lo <= hi).flatten()
    if live.numel() == 0 or A == 0:
        return out
    inv_step = lattice_inv_step(G)
    L = int((hi[live] - lo[live]).max()) + 1
    k = torch.arange(L, device=dev)
    per = max(1, PLAIN_TERMS // (L * A))
    for k0 in range(0, live.numel(), per):
        idx = live[k0:k0 + per]
        w = lo[idx, None] + k  # [C, L]
        in_win = w <= hi[idx, None]
        w = torch.where(in_win, w, lo[idx, None]).long()
        dist = (pos[w] - cand_pos[idx, None]).abs()
        logd = torch.log(dist.clamp_min(1).to(torch.float32))
        x = logd[..., None] + la[idx, None, :]  # [C, L, A]
        u = (x - LOG_AD_MIN) * inv_step
        i = u.to(torch.int32).clamp(0, G - 2)
        frac = (u - i.to(torch.float32)).clamp(0.0, 1.0)
        flat = row[w].to(torch.int64)[..., None] * G + i
        v0, v1 = table_flat[flat], table_flat[flat + 1]
        y = (v0.double() * (1.0 - frac).double()
             + (v1 * frac).double()).float()  # fmaf
        mask = in_win[..., None] & (x <= LOG_AD_MAX)
        contrib = torch.where(mask, y - null[w][..., None], 0.0)
        out[idx] = 2.0 * contrib.sum(1)
    return out


def launch_clr_grid(lib, table_flat, row, pos, null, cand_pos, lo, hi,
                    lalpha, grid_points, paired_alpha, plan=None):
    """One call of ``lib``'s fscl_clr_grid (its two launches, counted in
    clr_grid_launches) on checked inputs; the [P, A] output.  ``plan``:
    clr_grid_plan's two numbers at the library's slice width and group,
    computed here (one copy of lo and hi to the host) where not given."""
    from .. import kernels

    dev = table_flat.device
    P, A = cand_pos.shape[0], lalpha.shape[-1]
    out = torch.empty((P, A), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = clr_grid_plan(lo.cpu().numpy(), hi.cpu().numpy(),
                             lib.fscl_clr_grid_group(),
                             lib.fscl_clr_grid_slice_sites())
    per, span = plan
    part = torch.empty((per, P, A), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fscl_clr_grid(
            table_flat.data_ptr(), row.data_ptr(), pos.data_ptr(),
            null.data_ptr(), cand_pos.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), lalpha.data_ptr(), part.data_ptr(),
            out.data_ptr(), P, A, int(paired_alpha),
            grid_points, lattice_inv_step(grid_points), span,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, rc, "clr_grid")
    global clr_grid_launches
    clr_grid_launches += 2 if span > 0 else 1
    return out


def clr_grid(table_flat, row, pos, null, cand_pos, lo, hi, lalpha, *,
             grid_points, paired_alpha=False, device="cuda"):
    """[P, A] float32 CLR of every (candidate, alpha) pair (see module
    doc).  table_flat [R*G] f32; row [W] int32 table rows; pos [W] int32
    bp positions of one chromosome, or of several whose windows do not
    cross (lo, hi are site indices into these arrays); null [W] f32;
    cand_pos, lo, hi [P] int32 (lo > hi: a padded candidate); lalpha [A]
    f32, or [P, A] with ``paired_alpha``.  A live window outside the
    sites or a row outside the table raises ValueError.  Arrays or
    tensors, moved to
    ``device`` (``cuda`` unless the caller asks for ``cpu``); CPU tensors
    take the plain version, CUDA tensors launch the kernel or raise."""
    dev = parse_device(device)
    args = _inputs(table_flat, row, pos, null, cand_pos, lo, hi, lalpha, dev)
    _check_shapes(*args, grid_points, paired_alpha)
    return _clr_grid(args, _plan(args, grid_points), grid_points,
                     paired_alpha)


def _plan(args, grid_points):
    """clr_grid's checks on its inputs (``_inputs``' list), and for CUDA
    tensors the kernel's slice plan (None on the CPU)."""
    lo_h, hi_h = _check_ranges(args[0], args[1], args[5], args[6],
                               grid_points)
    if _device("clr_grid", args[0]) == "cpu":
        return None
    if (args[0].shape[0] + 1 >= 2**31 or args[4].shape[0] >= 2**31
            or grid_points > 2**22):
        raise ValueError("clr_grid: too many table entries, grid points or "
                         "candidates for one launch")
    from .. import kernels

    lib = kernels.load()
    plan = clr_grid_plan(lo_h, hi_h, lib.fscl_clr_grid_group(),
                         lib.fscl_clr_grid_slice_sites())
    if plan[1] > 65535:
        raise ValueError("clr_grid: windows too wide for one launch")
    return plan


def _clr_grid(args, plan, grid_points, paired_alpha):
    """clr_grid on checked inputs: the plain version (plan None) or one
    kernel call."""
    if plan is None:
        return clr_grid_plain(*args, grid_points=grid_points,
                              paired_alpha=paired_alpha)
    from .. import kernels

    return launch_clr_grid(kernels.load(), *args, grid_points, paired_alpha,
                           plan)


def two_stage_alpha_max(table_flat, row, pos, null, cand_pos, lo, hi, *,
                        grid_points, device="cuda"):
    """Max CLR over the reference's two-stage lalpha search, per candidate:
    (clr [P], lalpha [P]) float32 tensors on ``device``, the best of 11
    coarse and 14 fine lalpha values (sm-search.c:269-300 semantics,
    batched over candidates; arguments as ``clr_grid``'s, checked once
    for both stages)."""
    dev = parse_device(device)
    args = _inputs(table_flat, row, pos, null, cand_pos, lo, hi,
                   coarse_alpha_grid(), dev)
    coarse = args.pop()
    _check_shapes(*args, coarse, grid_points, False)
    plan = _plan(args, grid_points)
    clr_c = _clr_grid([*args, coarse], plan, grid_points, False)  # [P, 11]
    fine = fine_alpha_grids(coarse[torch.argmax(clr_c, dim=1)])  # [P, 14]
    clr_f = _clr_grid([*args, fine], plan, grid_points, True)  # [P, 14]
    all_clr = torch.cat([clr_c, clr_f], dim=1)
    all_la = torch.cat([coarse[None].expand_as(clr_c), fine], dim=1)
    j = torch.argmax(all_clr, dim=1, keepdim=True)
    return (torch.gather(all_clr, 1, j)[:, 0],
            torch.gather(all_la, 1, j)[:, 0])
