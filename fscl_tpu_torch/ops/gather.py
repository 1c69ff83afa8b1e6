"""Row gathers: a plain row gather, and the hist statistic's gather ->
difference -> lerp chain.

``row_gather(table, idx)`` is the TPU kernel
bench/micro_pallas_gather.py:40 pallas_gather (body :32-34):

    out[i, :] = table[idx[i], :]

for int16, int32 or float32 rows of any width, indices in any order.  An
index outside [0, table rows) is a fault: the plain version raises and
the kernel traps; neither clamps.  RDP's two large gathers go through it
(ops/histclr.py:rdp_clr_reps).

``window_operand(ps, bounds, fbar, ...)`` is the chain that
fscl_tpu/ops/histclr.py:1116-1126 leaves to XLA inside hist_clr_reps_ps
(no Pallas kernel there): the prefix rows at the run bounds, their signed
adjacent difference in the prefix dtype (int16 wraps mod 2^16), cast to
float32, split by the fbar lerp into w0 = sum_side h * (1 - fbar) and
w1 = sum_side h * fbar, and laid out as the contraction's operand

    k[c*P + p, (s*NC + j)*R + r] = w_s[c, j, p*R + r]     (s = 0, 1)

rounded to bfloat16 and back when mm_bf16.  ps: [W+1, P*R] int16, int32
or float32; bounds: [c, 2, NC+1] int32 rows of ps; fbar: [c, 2, NC] f32.
No path of the statistic writes it any more: both of its routes build
the same values inside one fused kernel (ops/window_clr.py), and this
kernel with a float32 matmul is their yardstick on the card.

Each wrapper runs the plain PyTorch version for CPU tensors and its CUDA
kernel (csrc/row_gather.cu) for CUDA tensors; it never falls back from one
to the other.  ``gather_launches`` and ``window_launches`` count the
kernels' launches.
"""

from __future__ import annotations

import torch

from .prefix_sums import _check_inputs

gather_launches = 0  # CUDA kernel launches by row_gather
window_launches = 0  # CUDA kernel launches by window_operand
_DTYPE_CODE = {torch.int16: 0, torch.int32: 1, torch.float32: 2}
_SLOTS_MAX = 2**31 - 1  # the kernels index their thread slots in 32 bits


def bf16_round(x):
    """Round float32 values to bfloat16 and back (round to nearest even)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _device(what, t):
    """'cpu' or 'cuda' for t's device; raises for any other."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def row_gather_plain(table, idx):
    """Plain PyTorch version: advanced indexing."""
    return table[idx.long()]


def row_gather(table, idx):
    """[n, width] rows table[idx] (see module doc).

    table: [rows, width] int16, int32 or float32; idx: [n] int32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if _device("row_gather", table) == "cpu":
        return row_gather_plain(table, idx)
    dev = table.device
    if table.dtype not in _DTYPE_CODE or table.dim() != 2 or idx.dim() != 1:
        raise ValueError(
            f"row_gather: table must be 2-D int16, int32 or float32 and idx "
            f"1-D, got {table.dtype} {tuple(table.shape)} and "
            f"{tuple(idx.shape)}"
        )
    _check_inputs("row_gather", dev, (
        ("table", table, table.dtype), ("idx", idx, torch.int32)))
    n, (rows, width) = idx.shape[0], table.shape
    if n * width > _SLOTS_MAX:
        raise ValueError(f"row_gather: {n} x {width} elements exceed 2^31")
    out = torch.empty((n, width), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    from .. import kernels

    lib = kernels.load()
    elem = table.element_size()
    with torch.cuda.device(dev):
        rc = lib.fscl_row_gather(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, rows,
            width * elem, elem, torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, rc, "row_gather")
    global gather_launches
    gather_launches += 1
    return out


def window_operand_plain(ps, bounds, fbar, *, n_rep, n_cells, n_rows,
                         mm_bf16=False):
    """Plain PyTorch version: the gather, the difference and its float
    copy, the lerp products and side sums, the cat and the permute, each
    a pass of its own."""
    NC, R, P = n_cells, n_rows, n_rep
    c = bounds.shape[0]
    sign = torch.tensor([-1, 1], dtype=ps.dtype, device=ps.device)
    psb = ps[bounds.to(torch.int64)]  # [c, 2, NC+1, P*R]
    h = ((psb[:, :, 1:, :] - psb[:, :, :-1, :])
         * sign[None, :, None, None]).to(torch.float32)
    w0 = (h * (1.0 - fbar[..., None])).sum(1)  # [c, NC, P*R]
    w1 = (h * fbar[..., None]).sum(1)
    k = torch.cat([w0, w1], 1).reshape(c, 2 * NC, P, R)
    k = k.permute(0, 2, 1, 3).reshape(c * P, 2 * NC * R)
    if mm_bf16:
        k = bf16_round(k)
    return k


def window_operand(ps, bounds, fbar, *, n_rep, n_cells, n_rows,
                   mm_bf16=False):
    """[c*P, 2*NC*R] f32 contraction operand of the window counts (see
    module doc).  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    kw = dict(n_rep=n_rep, n_cells=n_cells, n_rows=n_rows, mm_bf16=mm_bf16)
    if _device("window_operand", ps) == "cpu":
        return window_operand_plain(ps, bounds, fbar, **kw)
    dev = ps.device
    NC, R, P = n_cells, n_rows, n_rep
    c = bounds.shape[0]
    if (ps.dtype not in _DTYPE_CODE or ps.dim() != 2
            or ps.shape[1] != P * R
            or tuple(bounds.shape) != (c, 2, NC + 1)
            or tuple(fbar.shape) != (c, 2, NC)):
        raise ValueError(
            f"window_operand: ps {ps.dtype} {tuple(ps.shape)}, bounds "
            f"{tuple(bounds.shape)}, fbar {tuple(fbar.shape)} do not fit "
            f"P={P}, NC={NC}, R={R}"
        )
    _check_inputs("window_operand", dev, (
        ("ps", ps, ps.dtype), ("bounds", bounds, torch.int32),
        ("fbar", fbar, torch.float32)))
    if c * P * R > _SLOTS_MAX:
        raise ValueError(f"window_operand: {c} x {P * R} lanes exceed 2^31")
    out = torch.empty((c * P, 2 * NC * R), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    from .. import kernels

    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.fscl_window_operand(
            ps.data_ptr(), bounds.data_ptr(), fbar.data_ptr(),
            out.data_ptr(), c, NC, P, R, ps.shape[0], _DTYPE_CODE[ps.dtype],
            int(mm_bf16), torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, rc, "window_operand")
    global window_launches
    window_launches += 1
    return out
