"""The hist statistic's window operand and its contraction in one kernel,
on both of the statistic's routes.

fscl_tpu/ops/histclr.py:1116-1131, hist_clr_reps_ps's chunk body: the
window operand of ops/gather.py:window_operand (gather the prefix rows at
the run bounds, difference, lerp by fbar) contracted with the table pack,
sums in float32:

    out[c, p, a] = 2 * sum_k k[c*P + p, k] * t3[k, a]

``window_clr(ps, bounds, fbar, t3b, ...)`` is the mm_bf16=True route: the
operand rounded to bfloat16 against t3b = bf16_pack(t3), the pack rounded
to bfloat16 once per table.  A product of two bfloat16 values is exact in
float32, so the kernel (csrc/window_clr.cu) and the plain version differ
only in the order of their float32 sums.  At up to 32 alphas, where the
grid would not fill the card, the kernel splits the cells over the
blocks of a thread-block cluster and adds their sums inside the same
launch (window_clr_splits); an entry's bits depend on neither the split
nor the other rows.

``window_clr_f32(ps, bounds, fbar, t3p, ...)`` is the mm_bf16=False route,
whose CLRs the scan reports (its tie stage): the float32 operand against
t3p = f32_pack(t3).  Its kernel (csrc/window_clr_f32.cu) takes float32-
accurate products on the TF32 tensor cores (each operand split into two
TF32 terms, three MMAs a product) and splits the cells over blocks when
the grid would not fill the card (window_clr_f32_splits).

ps: [W+1, P*R] int16, int32 or float32; bounds: [c, 2, NC+1] int32 rows
of ps; fbar: [c, 2, NC] f32; the packs: [2*NC*R, A] with their columns
padded with zeros to 16-byte rows.  Returns [c, P, A] f32.

Each plain version is the two-step chain its kernel replaces:
window_operand_plain, then a float32 torch.matmul, a candidate chunk at a
time so the operand stays within OPERAND_BYTES.  The wrappers run it for
CPU tensors and the CUDA kernel for CUDA tensors, never falling back from
one to the other.  ``window_clr_launches`` and ``window_clr_f32_launches``
count the kernels' launches, ``window_clr_split_launches`` those of the
bf16 kernel split over cells, ``window_clr_f32_reduce_launches`` the
launches of the f32 kernel's split reduction, and
``window_clr_wide_launches`` and ``window_clr_f32_wide_launches`` those
of either kernel at more than WIDE_R rows (its wide variant, which walks
each cell's lanes in two halves; the exact tables of one large depth).
"""

from __future__ import annotations

import weakref

import torch

from .gather import _DTYPE_CODE, _device, window_operand_plain
from .prefix_sums import _check_inputs

window_clr_launches = 0  # CUDA kernel launches by window_clr
window_clr_split_launches = 0  # those split over cells (splits > 1)
window_clr_f32_launches = 0  # CUDA kernel launches by window_clr_f32
window_clr_f32_reduce_launches = 0  # its split reductions
window_clr_wide_launches = 0  # window_clr launches at R > WIDE_R
window_clr_f32_wide_launches = 0  # window_clr_f32 launches at R > WIDE_R
OPERAND_BYTES = 1 << 28  # the plain versions' operand per candidate chunk
WIDE_R = 128  # widest R a kernel walks in one step a cell (8 lanes x 4 units)
R_MAX = 256  # the kernels' widest prefix row per replicate (two steps a cell)
_packs: dict = {}  # (id(t3), dtype) -> (weakref to t3, t3._version, pack)


def _pack(t3, dtype, multiple):
    """[K, A'] copy of the [K, A] f32 pack t3 in dtype, A' = A rounded up
    to `multiple` with zero columns (16-byte rows).  Built once per pack
    tensor and dtype (cached while t3 lives unchanged)."""
    key = (id(t3), dtype)
    hit = _packs.get(key)
    if hit is not None and hit[0]() is t3 and hit[1] == t3._version:
        return hit[2]
    K, A = t3.shape
    pack = torch.zeros((K, -(-A // multiple) * multiple), dtype=dtype,
                       device=t3.device)
    pack[:, :A] = t3
    _packs[key] = (weakref.ref(t3, lambda _, k=key: _packs.pop(k, None)),
                   t3._version, pack)
    return pack


def bf16_pack(t3):
    """[K, A8] bfloat16 copy of the pack t3, A8 a multiple of 8 (see
    _pack)."""
    return _pack(t3, torch.bfloat16, 8)


def f32_pack(t3):
    """[K, A4] float32 copy of the pack t3, A4 a multiple of 4, values
    bitwise t3's (see _pack)."""
    return _pack(t3, torch.float32, 4)


def _two_step(ps, bounds, fbar, t3m, *, n_rep, n_cells, n_rows, mm_bf16):
    """window_operand_plain, then 2 * a float32 matmul with t3m [K, A],
    per candidate chunk; [c, P, A]."""
    P, A = n_rep, t3m.shape[1]
    c = bounds.shape[0]
    per = max(1, OPERAND_BYTES // max(2 * n_cells * n_rows * P * 4, 1))
    outs = [
        2.0 * torch.matmul(window_operand_plain(
            ps, bounds[c0:c0 + per], fbar[c0:c0 + per], n_rep=P,
            n_cells=n_cells, n_rows=n_rows, mm_bf16=mm_bf16), t3m)
        for c0 in range(0, c, per)
    ]
    if not outs:
        return torch.zeros((0, P, A), dtype=torch.float32, device=ps.device)
    return torch.cat(outs).reshape(c, P, A)


def window_clr_plain(ps, bounds, fbar, t3b, *, n_rep, n_cells, n_rows,
                     n_alpha):
    """Plain PyTorch version: the bfloat16-rounded window operand, then a
    float32 matmul with the pack, per candidate chunk."""
    return _two_step(ps, bounds, fbar,
                     t3b[:, :n_alpha].to(torch.float32).contiguous(),
                     n_rep=n_rep, n_cells=n_cells, n_rows=n_rows,
                     mm_bf16=True)


def window_clr_f32_plain(ps, bounds, fbar, t3p, *, n_rep, n_cells, n_rows,
                         n_alpha):
    """Plain PyTorch version: the float32 window operand, then a float32
    matmul with the pack, per candidate chunk."""
    return _two_step(ps, bounds, fbar, t3p[:, :n_alpha], n_rep=n_rep,
                     n_cells=n_cells, n_rows=n_rows, mm_bf16=False)


def _check_kernel_inputs(what, ps, bounds, fbar, pack, pack_dtype,
                         pack_multiple, *, n_rep, n_cells, n_rows, n_alpha):
    """Raise unless the CUDA kernel takes these inputs."""
    NC, R, P, A = n_cells, n_rows, n_rep, n_alpha
    c = bounds.shape[0]
    if (ps.dtype not in _DTYPE_CODE or ps.dim() != 2
            or ps.shape[1] != P * R or R % 8 or not 0 < R <= R_MAX
            or tuple(bounds.shape) != (c, 2, NC + 1)
            or tuple(fbar.shape) != (c, 2, NC) or pack.dim() != 2
            or pack.shape[0] != 2 * NC * R or pack.shape[1] < A
            or pack.shape[1] % pack_multiple):
        raise ValueError(
            f"{what}: ps {ps.dtype} {tuple(ps.shape)}, bounds "
            f"{tuple(bounds.shape)}, fbar {tuple(fbar.shape)}, pack "
            f"{tuple(pack.shape)} do not fit P={P}, NC={NC}, R={R} (a "
            f"multiple of 8 up to {R_MAX}), A={A}"
        )
    _check_inputs(what, ps.device, (
        ("ps", ps, ps.dtype), ("bounds", bounds, torch.int32),
        ("fbar", fbar, torch.float32), ("pack", pack, pack_dtype)))
    if ps.data_ptr() % 16 or pack.data_ptr() % 16:
        raise ValueError(f"{what}: ps and the pack must be 16-byte aligned")


def window_clr(ps, bounds, fbar, t3b, *, n_rep, n_cells, n_rows, n_alpha):
    """[c, P, A] f32: 2 * the bfloat16 contraction of the window operand
    with t3b (see module doc).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    kw = dict(n_rep=n_rep, n_cells=n_cells, n_rows=n_rows, n_alpha=n_alpha)
    if _device("window_clr", ps) == "cpu":
        return window_clr_plain(ps, bounds, fbar, t3b, **kw)
    _check_kernel_inputs("window_clr", ps, bounds, fbar, t3b, torch.bfloat16,
                         8, **kw)
    dev, c = ps.device, bounds.shape[0]
    out = torch.empty((c, n_rep, n_alpha), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    from .. import kernels

    lib = kernels.load()
    splits = window_clr_splits(c * n_rep, n_cells=n_cells, n_rows=n_rows,
                               n_alpha=n_alpha, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fscl_window_clr(
            ps.data_ptr(), bounds.data_ptr(), fbar.data_ptr(),
            t3b.data_ptr(), out.data_ptr(), c, n_cells, n_rep, n_rows,
            ps.shape[0], _DTYPE_CODE[ps.dtype], n_alpha, t3b.shape[1],
            splits, torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, rc, "window_clr")
    global window_clr_launches, window_clr_split_launches
    global window_clr_wide_launches
    window_clr_launches += 1
    window_clr_split_launches += splits > 1
    window_clr_wide_launches += n_rows > WIDE_R
    return out


def window_clr_splits(rows, *, n_cells, n_rows, n_alpha, device):
    """The split over cells window_clr's kernel takes for rows = c*P flat
    rows on the card `device` (1 = none; else the blocks of a tile's
    splits run as one cluster): a pure function of the shape and the
    card's SM count."""
    from .. import kernels

    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return kernels.load().fscl_window_clr_splits(rows, n_cells, n_rows,
                                                 n_alpha, n_sm)


def window_clr_f32_splits(rows, *, n_cells, n_rows, n_alpha, device):
    """The split over cells window_clr_f32's kernel takes for rows = c*P
    flat rows on the card `device` (1 = none): a pure function of the
    shape and the card's SM count."""
    from .. import kernels

    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return kernels.load().fscl_window_clr_f32_splits(rows, n_cells, n_rows,
                                                     n_alpha, n_sm)


def window_clr_f32(ps, bounds, fbar, t3p, *, n_rep, n_cells, n_rows,
                   n_alpha):
    """[c, P, A] f32: 2 * the float32 contraction of the window operand
    with t3p (see module doc).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    kw = dict(n_rep=n_rep, n_cells=n_cells, n_rows=n_rows, n_alpha=n_alpha)
    if _device("window_clr_f32", ps) == "cpu":
        return window_clr_f32_plain(ps, bounds, fbar, t3p, **kw)
    _check_kernel_inputs("window_clr_f32", ps, bounds, fbar, t3p,
                         torch.float32, 4, **kw)
    dev, c = ps.device, bounds.shape[0]
    out = torch.empty((c, n_rep, n_alpha), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    from .. import kernels

    lib = kernels.load()
    splits = window_clr_f32_splits(c * n_rep, n_cells=n_cells, n_rows=n_rows,
                                   n_alpha=n_alpha, device=dev)
    part = (torch.empty((splits, c * n_rep, n_alpha), dtype=torch.float32,
                        device=dev) if splits > 1 else None)
    with torch.cuda.device(dev):
        rc = lib.fscl_window_clr_f32(
            ps.data_ptr(), bounds.data_ptr(), fbar.data_ptr(),
            t3p.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), c, n_cells, n_rep,
            n_rows, ps.shape[0], _DTYPE_CODE[ps.dtype], n_alpha,
            t3p.shape[1], splits, torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, rc, "window_clr_f32")
    global window_clr_f32_launches, window_clr_f32_reduce_launches
    global window_clr_f32_wide_launches
    window_clr_f32_launches += 1
    window_clr_f32_reduce_launches += splits > 1
    window_clr_f32_wide_launches += n_rows > WIDE_R
    return out
