"""The per-site lattice CLR: the scan's exact path and its alpha search
(port of fscl_tpu/ops/lattice.py).

The alpha grid is snapped to the table's log_ad lattice, lalpha = m *
step, so the interpolation cell of a site at lattice offset m is an
integer shift of one alpha-independent coordinate.  A pack per offset
list (build_lattice_pack) stores both lerp endpoints of every offset in
one contiguous [2A] row, and one row read per (candidate, site) serves
every alpha of the list.

``clr_lattice`` (fscl_tpu/ops/lattice.py:94-155, XLA-fused in the JAX
package) computes, for replicate r, candidate p and offset a:

    u      = log(max(|pos_w - cand_p|, 1)) / step + m_base[r, p]
    i0     = clamp(int(u), 0, G-1);  frac = clamp(u - i0, 0, 1)
    y      = lerp(pack[row[r, w]*G + i0, 2a : 2a+2], frac)
    clr    = 2 * sum over w in [lo_p, hi_p] with u + m_rel[a] <= G-1
             of (y - null[r, w])

in float32, u and the lerp each rounded once, as the fused multiply-adds
that XLA forms from fscl_tpu's expressions are (and the reported lalpha =
LOG_AD_MIN + m * step likewise): the plain version takes them in float64,
where the product and the sum are exact, and rounds once; the kernel uses
fmaf.  ``row`` and ``null`` carry a replicate axis [Rr, W] (the
permuted attributes of Rr replicates, or Rr = 1 for the scan); positions,
candidates and windows are shared.  A dummy candidate (lo = 1, hi = 0)
gives exactly 0.  ``clr_lattice_plain`` is the plain PyTorch version;
the wrapper ``clr_lattice`` runs it for CPU tensors and launches the CUDA
kernel (csrc/lattice_clr.cu) for CUDA tensors, never falling back from
one to the other.  ``lattice_clr_launches`` counts the kernel's launches.
The kernel reads a pack whose rows are padded to KERNEL_ROW[A] offsets
(``kernel_pack``; LatticeTables keeps its packs so, and the plain version
reads a row's first 2A columns), and takes C consecutive candidates a
block (``block_candidates``; the output does not depend on C).

``two_stage_lattice_max`` (coarse, fine and ultra stages; the
permutation statistic takes coarse and fine only) and
``seeded_lattice_max`` (fine and ultra from a seed) run the stage logic
in torch: the first maximum wins, a refine replaces it only when
strictly larger, and the refined offset is clipped to [0, G-1].
"""

from __future__ import annotations

import numpy as np
import torch

from .. import LOG_AD_MAX, LOG_AD_MIN
from ..device import parse_device
from .gather import _device
from .prefix_sums import _check_inputs

N_COARSE = 11  # sm-search.c:276-282
N_FINE = 16  # 15 C fine points + re-evaluation of the winner
KERNEL_A = (N_COARSE, N_FINE)  # the offset-list lengths the kernel takes
# offsets a kernel pack row holds (lerp pairs of 16-byte lanes; the
# coarse row is padded, csrc/lattice_clr.cu FSCL_LATTICE_COARSE_ROW)
KERNEL_ROW = {N_COARSE: 12, N_FINE: 16}
# candidates a block where that still gives MIN_BLOCKS_PER_SM blocks an
# SM, else 1 (C = 8 and 16 were slower at every shape measured but one,
# where C = 8 gained 0.7%, PERF.md §6; only tools/lattice_variants.py
# builds them)
BLOCK_CANDS = 4
MIN_BLOCKS_PER_SM = 8
PLAIN_BYTES = 1 << 28  # the plain version's gathered pack rows per chunk
lattice_clr_launches = 0  # CUDA kernel launches by clr_lattice


def lattice_step(grid_points):
    return (LOG_AD_MAX - LOG_AD_MIN) / (grid_points - 1)


def lattice_inv_step(grid_points):
    """1 / lattice_step rounded to float32 once, as fscl_tpu's float32
    product with a Python scalar rounds it."""
    return float(np.float32((grid_points - 1) / (LOG_AD_MAX - LOG_AD_MIN)))


def coarse_lattice_offsets(grid_points):
    """Integer lattice offsets approximating the C coarse alpha grid."""
    step = lattice_step(grid_points)
    coarse = np.linspace(LOG_AD_MIN, LOG_AD_MAX, N_COARSE)
    return np.round((coarse - LOG_AD_MIN) / step).astype(np.int32)


def fine_lattice_offsets(grid_points):
    """Relative lattice offsets covering the +-coarse_step fine bracket."""
    step = lattice_step(grid_points)
    fstep = 2.0 * (LOG_AD_MAX - LOG_AD_MIN) / (N_COARSE - 1) / 15.0
    unit = max(int(round(fstep / step)), 1)
    j = np.arange(N_FINE) - N_FINE // 2
    return (j * unit).astype(np.int32)


def ultra_lattice_offsets(grid_points):
    """Third-stage offsets: +-1 fine pitch at quarter resolution."""
    step = lattice_step(grid_points)
    fstep = 2.0 * (LOG_AD_MAX - LOG_AD_MIN) / (N_COARSE - 1) / 15.0
    unit = max(int(round(fstep / step)) // 4, 1)
    j = np.arange(N_FINE) - N_FINE // 2
    return (j * unit).astype(np.int32)


def build_lattice_pack(table, offsets):
    """[R*G, 2A] f32 interleaved lerp pairs for each lattice offset:

    pack[r*G + i, 2a]   = table[r, clip(i + offsets[a])]
    pack[r*G + i, 2a+1] = table[r, clip(i + offsets[a] + 1)]

    Entries past the grid end are masked out at evaluation time, entries
    below clamp to the left edge (the C spline's interval clamp)."""
    R, G = table.shape
    A = len(offsets)
    i = np.arange(G)[:, None]
    idx0 = np.clip(i + offsets[None, :], 0, G - 1)
    idx1 = np.clip(i + offsets[None, :] + 1, 0, G - 1)
    out = np.empty((R, G, 2 * A), dtype=np.float32)
    out[:, :, 0::2] = table[:, idx0]
    out[:, :, 1::2] = table[:, idx1]
    return out.reshape(R * G, 2 * A)


def kernel_pack(pack):
    """The pack [n*G, 2A] as the kernel reads it: each row padded with
    zero columns to 2 * KERNEL_ROW[A] floats (its first 2A columns are
    the pack's); the pack itself where A needs no padding."""
    A = pack.shape[1] // 2
    pad = 2 * (KERNEL_ROW[A] - A)
    return torch.nn.functional.pad(pack, (0, pad)) if pad else pack


def block_candidates(Rr, P, n_sm):
    """Candidates a block: BLOCK_CANDS where the grid, Rr * ceil(P / C)
    blocks, still gives MIN_BLOCKS_PER_SM blocks to each of n_sm SMs,
    else 1."""
    enough = Rr * -(-P // BLOCK_CANDS) >= MIN_BLOCKS_PER_SM * n_sm
    return BLOCK_CANDS if enough else 1


class LatticeTables:
    """The coarse, fine and ultra packs and their offsets on one device.

    ``m_*`` are the offsets as numpy int32, ``m_*_dev`` as tensors;
    ``pack_*`` the packs as the kernel reads them (kernel_pack: the
    build_lattice_pack rows, padded)."""

    def __init__(self, grid_points, packs, offsets, device="cuda"):
        device = parse_device(device)
        self.grid_points = int(grid_points)
        self.step = lattice_step(self.grid_points)
        self.device = device
        self.m_coarse, self.m_fine, self.m_ultra = (
            np.asarray(m, dtype=np.int32) for m in offsets)
        self.pack_coarse, self.pack_fine, self.pack_ultra = (
            kernel_pack(torch.tensor(np.asarray(p, dtype=np.float32),
                                     device=device))
            for p in packs)
        self.m_coarse_dev, self.m_fine_dev, self.m_ultra_dev = (
            torch.tensor(m, device=device)
            for m in (self.m_coarse, self.m_fine, self.m_ultra))

    @classmethod
    def from_table(cls, table_np, grid_points, device="cuda"):
        """Packs built from the sweep-model table [n_rows, G]."""
        device = parse_device(device)
        offsets = (coarse_lattice_offsets(grid_points),
                   fine_lattice_offsets(grid_points),
                   ultra_lattice_offsets(grid_points))
        return cls(grid_points,
                   [build_lattice_pack(table_np, m) for m in offsets],
                   offsets, device=device)


def clr_lattice_plain(pack, row, pos, null, cand, lo, hi, m_base, m_rel, *,
                      grid_points, abs_sum=False):
    """Plain PyTorch version: [Rr, P, A] (see module doc), float32; with
    ``abs_sum``, 2 sum |y - null| instead, the scale S of the float32
    sums' rounding that tolerances are stated against.  Reads the first
    2A columns of the pack's rows (a kernel pack's padding is unread).

    Each candidate's window is gathered as L = the widest window's sites
    from its lo (sites past hi masked), a chunk of candidates at a time,
    so an entry's float32 sum depends on its own window and L alone (all
    windows of a chromosome are min(2 eval_range + 1, n) wide): a
    replicate whose window holds the observed attributes gives the
    observed value bit for bit, whatever the chunk or replicate count."""
    G = grid_points
    Rr, P, A = row.shape[0], cand.shape[0], m_rel.shape[0]
    dev = pack.device
    pack = pack[:, :2 * A]
    out = torch.zeros((Rr, P, A), dtype=torch.float32, device=dev)
    live = torch.nonzero(lo <= hi).flatten()
    if live.numel() == 0:
        return out
    inv_step = lattice_inv_step(G)
    m_rel_f = m_rel.to(torch.float32)
    L = int((hi[live] - lo[live]).max()) + 1
    k = torch.arange(L, device=dev)
    per = max(1, PLAIN_BYTES // (Rr * L * 2 * A * 4))
    for k0 in range(0, live.numel(), per):
        idx = live[k0:k0 + per]
        w = lo[idx, None] + k  # [C, L]
        in_win = w <= hi[idx, None]
        w = torch.where(in_win, w, lo[idx, None]).long()
        dist = (pos[w] - cand[idx, None]).abs()
        logd = torch.log(dist.clamp_min(1).to(torch.float32))
        u = (logd[None].double() * inv_step
             + m_base[:, idx, None].double()).float()  # fmaf
        i0 = u.to(torch.int32).clamp(0, G - 1)  # [Rr, C, L]
        frac = (u - i0.to(torch.float32)).clamp(0.0, 1.0)
        rows = row[:, w].to(torch.int64) * G + i0
        vals = pack[rows]  # [Rr, C, L, 2A]
        v0, v1 = vals[..., 0::2], vals[..., 1::2]
        y = ((v1 - v0).double() * frac[..., None].double()
             + v0.double()).float()  # fmaf
        mask = in_win[None, :, :, None] & (u[..., None] + m_rel_f <= G - 1)
        contrib = torch.where(mask, y - null[:, w, None], 0.0)
        if abs_sum:
            contrib = contrib.abs()
        out[:, idx] = 2.0 * contrib.sum(2)
    return out


def _check_kernel_inputs(pack, row, pos, null, cand, lo, hi, m_base, m_rel,
                         grid_points):
    """Raise unless the CUDA kernel takes these inputs."""
    Rr, W = row.shape if row.dim() == 2 else (0, 0)
    P, A = cand.shape[0], m_rel.shape[0]
    if (row.dim() != 2 or tuple(null.shape) != (Rr, W)
            or tuple(pos.shape) != (W,) or cand.dim() != 1
            or tuple(lo.shape) != (P,) or tuple(hi.shape) != (P,)
            or tuple(m_base.shape) != (Rr, P) or m_rel.dim() != 1
            or A not in KERNEL_A or pack.dim() != 2
            or pack.shape[1] != 2 * KERNEL_ROW[A]
            or pack.shape[0] % grid_points):
        raise ValueError(
            f"clr_lattice: pack {tuple(pack.shape)}, row {tuple(row.shape)}, "
            f"null {tuple(null.shape)}, pos {tuple(pos.shape)}, cand "
            f"{tuple(cand.shape)}, m_base {tuple(m_base.shape)}, m_rel "
            f"{tuple(m_rel.shape)} do not fit [Rr, W] rows, [P] "
            f"candidates, [Rr, P] bases and A in {KERNEL_A} offsets of a "
            f"[n*{grid_points}, 2 * KERNEL_ROW[A]] kernel pack"
        )
    i32 = torch.int32
    _check_inputs("clr_lattice", pack.device, (
        ("pack", pack, torch.float32), ("row", row, i32), ("pos", pos, i32),
        ("null", null, torch.float32), ("cand", cand, i32), ("lo", lo, i32),
        ("hi", hi, i32), ("m_base", m_base, i32), ("m_rel", m_rel, i32)))
    if Rr * P >= 2**31 or pack.shape[0] >= 2**31:
        raise ValueError("clr_lattice: too many (replicate, candidate) "
                         "pairs or pack rows for one launch")
    if pack.data_ptr() % 16:
        raise ValueError("clr_lattice: the pack must be 16-byte aligned")


def launch_lattice(lib, pack, row, pos, null, cand, lo, hi, m_base, m_rel,
                   grid_points, cands):
    """One launch of ``lib``'s fscl_lattice_clr at ``cands`` candidates a
    block on checked inputs (pack: a kernel pack); the [Rr, P, A]
    output."""
    from .. import kernels

    dev = pack.device
    Rr, W = row.shape
    P, A = cand.shape[0], m_rel.shape[0]
    out = torch.empty((Rr, P, A), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.fscl_lattice_clr(
            pack.data_ptr(), row.data_ptr(), pos.data_ptr(),
            null.data_ptr(), cand.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            m_base.data_ptr(), m_rel.data_ptr(), out.data_ptr(), Rr, P, W,
            A, pack.shape[1] // 2, grid_points,
            lattice_inv_step(grid_points), cands,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, rc, "clr_lattice")
    return out


def clr_lattice(pack, row, pos, null, cand, lo, hi, m_base, m_rel, *,
                grid_points):
    """[Rr, P, A] f32 CLR of every (replicate, candidate, offset) (see
    module doc).  pack: [n_rows*G, 2 * KERNEL_ROW[A]] f32, a kernel_pack
    (on the CPU any width from 2A on); row [Rr, W] int32; pos [W] int32;
    null [Rr, W] f32; cand, lo, hi [P] int32; m_base [Rr, P] int32; m_rel
    [A] int32.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if _device("clr_lattice", pack) == "cpu":
        return clr_lattice_plain(pack, row, pos, null, cand, lo, hi, m_base,
                                 m_rel, grid_points=grid_points)
    _check_kernel_inputs(pack, row, pos, null, cand, lo, hi, m_base, m_rel,
                         grid_points)
    from .. import kernels

    n_sm = torch.cuda.get_device_properties(pack.device).multi_processor_count
    out = launch_lattice(kernels.load(), pack, row, pos, null, cand, lo, hi,
                         m_base, m_rel, grid_points,
                         block_candidates(row.shape[0], cand.shape[0], n_sm))
    global lattice_clr_launches
    lattice_clr_launches += 1
    return out


def _refine(pack, m_rel, row, pos, null, cand, lo, hi, m_best, best, G):
    """One refine stage: the offsets m_rel around m_best [Rr, P]; the
    strictly larger maxima replace best."""
    clr = clr_lattice(pack, row, pos, null, cand, lo, hi, m_best, m_rel,
                      grid_points=G)  # [Rr, P, A]
    i_f = torch.argmax(clr, dim=2, keepdim=True)
    best_f = torch.gather(clr, 2, i_f)[..., 0]
    use = best_f > best
    moved = (m_best + m_rel[i_f[..., 0]]).clamp(0, G - 1)
    return torch.where(use, moved, m_best), torch.where(use, best_f, best)


def _lalpha(m_best, G):
    """LOG_AD_MIN + m * step in float32, one rounding (fmaf)."""
    step = float(np.float32(lattice_step(G)))
    return (m_best.double() * step + LOG_AD_MIN).float()


def _inputs(row, null):
    """Rows and nulls as [Rr, W] (a [W] pair is one replicate)."""
    if row.dim() == 1:
        row, null = row[None], null[None]
    return row.contiguous(), null.contiguous()


def two_stage_lattice_max(lt: LatticeTables, row, pos, null, cand, lo, hi,
                          ultra=True):
    """Max CLR over the lattice alpha search and its lalpha, [Rr, P] each:
    the coarse grid, then the fine bracket around its winner, then (with
    ``ultra``) the ultra bracket.  row/null: [Rr, W] or [W]."""
    row, null = _inputs(row, null)
    G = lt.grid_points
    Rr, P = row.shape[0], cand.shape[0]
    zeros = torch.zeros((Rr, P), dtype=torch.int32, device=row.device)
    clr_c = clr_lattice(lt.pack_coarse, row, pos, null, cand, lo, hi, zeros,
                        lt.m_coarse_dev, grid_points=G)
    ic = torch.argmax(clr_c, dim=2, keepdim=True)
    best = torch.gather(clr_c, 2, ic)[..., 0]
    m_best = lt.m_coarse_dev[ic[..., 0]]
    m_best, best = _refine(lt.pack_fine, lt.m_fine_dev, row, pos, null, cand,
                           lo, hi, m_best, best, G)
    if ultra:
        m_best, best = _refine(lt.pack_ultra, lt.m_ultra_dev, row, pos, null,
                               cand, lo, hi, m_best, best, G)
    return best, _lalpha(m_best, G)


def seeded_lattice_max(lt: LatticeTables, row, pos, null, cand, lo, hi,
                       m_seed):
    """Fine then ultra lattice zoom seeded at per-candidate offsets
    m_seed [P] (clipped to [0, G-1]); (clr, lalpha) [Rr, P] each."""
    row, null = _inputs(row, null)
    G = lt.grid_points
    Rr, P = row.shape[0], cand.shape[0]
    m_best = m_seed.to(torch.int32).clamp(0, G - 1)[None].expand(
        Rr, P).contiguous()
    best = torch.full((Rr, P), -torch.inf, dtype=torch.float32,
                      device=row.device)
    for pack, m_rel in ((lt.pack_fine, lt.m_fine_dev),
                        (lt.pack_ultra, lt.m_ultra_dev)):
        m_best, best = _refine(pack, m_rel, row, pos, null, cand, lo, hi,
                               m_best, best, G)
    return best, _lalpha(m_best, G)
