"""The hist statistic's window operand and its bfloat16 contraction in one
kernel.

``window_clr(ps, bounds, fbar, t3b, ...)`` is fscl_tpu/ops/histclr.py:
1116-1131, hist_clr_reps_ps's chunk body with mm_bf16=True: the window
operand of ops/gather.py:window_operand (gather the prefix rows at the
run bounds, difference, lerp by fbar, round to bfloat16) contracted with
the bfloat16 table pack, products and sums in float32:

    out[c, p, a] = 2 * sum_k bf16(k[c*P + p, k]) * t3b[k, a]

ps: [W+1, P*R] int16, int32 or float32; bounds: [c, 2, NC+1] int32 rows
of ps; fbar: [c, 2, NC] f32; t3b: bf16_pack(t3), the [2*NC*R, A] pack
rounded to bfloat16 once per table, its columns padded with zeros to a
multiple of 8.  Returns [c, P, A] f32.

The plain version is the two-step chain the kernel replaces:
window_operand_plain(mm_bf16=True), then a float32 torch.matmul with the
bfloat16-rounded pack, taken a candidate chunk at a time so the operand
stays within OPERAND_BYTES.  The wrapper runs it for CPU tensors and the
CUDA kernel (csrc/window_clr.cu) for CUDA tensors, never falling back
from one to the other.  ``window_clr_launches`` counts the kernel's
launches.  A product of two bfloat16 values is exact in float32, so the
kernel and the plain version differ only in the order of their float32
sums.
"""

from __future__ import annotations

import weakref

import torch

from .gather import _DTYPE_CODE, _device, window_operand_plain
from .prefix_sums import _check_inputs

window_clr_launches = 0  # CUDA kernel launches by window_clr
OPERAND_BYTES = 1 << 28  # the plain version's operand per candidate chunk
R_MAX = 128  # the kernel's widest prefix row per replicate (8 lanes x 4 units)
_packs: dict = {}  # id(t3) -> (weakref to t3, t3._version, pack)


def bf16_pack(t3):
    """[K, A8] bfloat16 copy of the [K, A] f32 pack t3, A8 = A rounded up
    to a multiple of 8 with zero columns: the kernel's 16-byte rows.
    Built once per pack tensor (cached while t3 lives unchanged)."""
    key = id(t3)
    hit = _packs.get(key)
    if hit is not None and hit[0]() is t3 and hit[1] == t3._version:
        return hit[2]
    K, A = t3.shape
    pack = torch.zeros((K, -(-A // 8) * 8), dtype=torch.bfloat16,
                       device=t3.device)
    pack[:, :A] = t3
    _packs[key] = (weakref.ref(t3, lambda _, k=key: _packs.pop(k, None)),
                   t3._version, pack)
    return pack


def window_clr_plain(ps, bounds, fbar, t3b, *, n_rep, n_cells, n_rows,
                     n_alpha):
    """Plain PyTorch version: the bfloat16-rounded window operand, then a
    float32 matmul with the pack, per candidate chunk."""
    P, A = n_rep, n_alpha
    c = bounds.shape[0]
    t3m = t3b[:, :A].to(torch.float32).contiguous()
    per = max(1, OPERAND_BYTES // max(2 * n_cells * n_rows * P * 4, 1))
    outs = [
        2.0 * torch.matmul(window_operand_plain(
            ps, bounds[c0:c0 + per], fbar[c0:c0 + per], n_rep=P,
            n_cells=n_cells, n_rows=n_rows, mm_bf16=True), t3m)
        for c0 in range(0, c, per)
    ]
    if not outs:
        return torch.zeros((0, P, A), dtype=torch.float32, device=ps.device)
    return torch.cat(outs).reshape(c, P, A)


def window_clr(ps, bounds, fbar, t3b, *, n_rep, n_cells, n_rows, n_alpha):
    """[c, P, A] f32: 2 * the bfloat16 contraction of the window operand
    with t3b (see module doc).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    kw = dict(n_rep=n_rep, n_cells=n_cells, n_rows=n_rows, n_alpha=n_alpha)
    if _device("window_clr", ps) == "cpu":
        return window_clr_plain(ps, bounds, fbar, t3b, **kw)
    dev = ps.device
    NC, R, P, A = n_cells, n_rows, n_rep, n_alpha
    c = bounds.shape[0]
    if (ps.dtype not in _DTYPE_CODE or ps.dim() != 2
            or ps.shape[1] != P * R or R % 8 or not 0 < R <= R_MAX
            or tuple(bounds.shape) != (c, 2, NC + 1)
            or tuple(fbar.shape) != (c, 2, NC) or t3b.dim() != 2
            or t3b.shape[0] != 2 * NC * R or t3b.shape[1] < A
            or t3b.shape[1] % 8):
        raise ValueError(
            f"window_clr: ps {ps.dtype} {tuple(ps.shape)}, bounds "
            f"{tuple(bounds.shape)}, fbar {tuple(fbar.shape)}, t3b "
            f"{tuple(t3b.shape)} do not fit P={P}, NC={NC}, R={R} (a "
            f"multiple of 8 up to {R_MAX}), A={A}"
        )
    _check_inputs("window_clr", dev, (
        ("ps", ps, ps.dtype), ("bounds", bounds, torch.int32),
        ("fbar", fbar, torch.float32), ("t3b", t3b, torch.bfloat16)))
    if ps.data_ptr() % 16 or t3b.data_ptr() % 16:
        raise ValueError("window_clr: ps and t3b must be 16-byte aligned")
    out = torch.empty((c, P, A), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    from .. import kernels

    lib = kernels.load()
    with torch.cuda.device(dev):
        rc = lib.fscl_window_clr(
            ps.data_ptr(), bounds.data_ptr(), fbar.data_ptr(),
            t3b.data_ptr(), out.data_ptr(), c, NC, P, R, ps.shape[0],
            _DTYPE_CODE[ps.dtype], A, t3b.shape[1],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, rc, "window_clr")
    global window_clr_launches
    window_clr_launches += 1
    return out
