"""Segmented prefix sums of the permuted row-id stream: one-hot counts
and, in compressed mode, sums of weight channels.

Port of the TPU kernel fscl_tpu/ops/pallas_ps.py:onehot_prefix_sums in
its segmented one-hot mode, fused with the gather -> expand steps that
fscl_tpu/engine/permute.py:_stack_stat ran in front of it
(build_prefix_sums_seg, fscl_tpu/ops/histclr.py:826-870).  For segment
s, site k < w_seg_p, replicate p and compact row r:

    ps[s*w + k, p*R + r] = #{k' <= k : id(s, p, k') == r}
    id(s, p, k) = table[sig[p, j8], k % PERM_GROUP]
    j8 = seg_g0[s] + k // PERM_GROUP - 1   (negative -> n_sig - 1, the
                                            sentinel column)

An id equal to R (absent row, tail padding) matches no lane.  Output is
int16 when w_seg_p <= 32767 and int32 otherwise, the rule of
build_prefix_sums_seg; callers consume prefix differences only.

``weighted_prefix_sums`` is the same TPU kernel's f32 mode (c) (the
compressed mixed-depth weight channels, fscl_tpu/ops/pallas_ps.py:97-110),
fused with the gather of _stack_stat's fat branch
(fscl_tpu/engine/permute.py:822-830): the ids index a [R_used+1, R] f32
weight table instead of a one-hot, and

    ps[s*w + k, p*R + r] = sum_{k' <= k} weights[id(s, p, k'), r]

in float32, summed in float64 and rounded once.  The sentinel id R_used
reads the all-zero last row.

Each wrapper runs the plain PyTorch version for CPU tensors and its CUDA
kernel (csrc/prefix_sums.cu, csrc/weighted_prefix_sums.cu) for CUDA
tensors; it never falls back from one to the other.  ``launches`` and
``weighted_launches`` count the kernels' launches.
"""

from __future__ import annotations

import torch

launches = 0  # CUDA kernel launches by onehot_prefix_sums
weighted_launches = 0  # CUDA kernel launches by weighted_prefix_sums


def _out_dtype(w_seg_p, out_dtype):
    if out_dtype is not None:
        return out_dtype
    return torch.int16 if w_seg_p <= 32767 else torch.int32


def segment_row_ids(table, sig, seg_g0, *, w_seg_p):
    """[S, w_seg_p, P] row id of every (segment, site, replicate)."""
    pg = table.shape[1]
    n_sig = sig.shape[1]
    g_loc = w_seg_p // pg
    idx8 = (
        seg_g0.to(torch.int64)[:, None]
        + torch.arange(g_loc, device=sig.device)[None, :] - 1
    )
    idx8 = torch.where(idx8 < 0, n_sig - 1, idx8)
    sel = sig.T[idx8]  # [S, G_loc, P]
    ids = table[sel.to(torch.int64)]  # [S, G_loc, P, pg]
    return ids.permute(0, 1, 3, 2).reshape(
        seg_g0.shape[0], w_seg_p, sig.shape[0]
    )


def onehot_prefix_sums_plain(table, sig, seg_g0, *, w_seg_p, n_rows,
                             out_dtype=None):
    """Plain PyTorch version: index math, one-hot, cumsum per segment."""
    S, P = seg_g0.shape[0], sig.shape[0]
    ids = segment_row_ids(table, sig, seg_g0, w_seg_p=w_seg_p)
    oh = ids[..., None] == torch.arange(
        n_rows, dtype=ids.dtype, device=ids.device
    )
    ps = torch.cumsum(oh.to(torch.int32), dim=1, dtype=torch.int32)
    return ps.to(_out_dtype(w_seg_p, out_dtype)).reshape(
        S * w_seg_p, P * n_rows
    )


def _check_inputs(what, dev, tensors):
    for name, t, dt in tensors:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous {dt} tensor on {dev}, "
                f"got {t.dtype} on {t.device}"
            )


def onehot_prefix_sums(table, sig, seg_g0, *, w_seg_p, n_rows,
                       out_dtype=None):
    """[S*w_seg_p, P*n_rows] segmented prefix sums (see module doc).

    table: [G+1, PERM_GROUP] int16 row-id group table; sig: [P, n_sig]
    int32 group sigma of one replicate slice (sentinel-padded so every
    j8 is in range); seg_g0: [S] int32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.
    """
    dev = table.device
    if dev.type == "cpu":
        return onehot_prefix_sums_plain(
            table, sig, seg_g0, w_seg_p=w_seg_p, n_rows=n_rows,
            out_dtype=out_dtype,
        )
    if dev.type != "cuda":
        raise ValueError(f"onehot_prefix_sums: unsupported device {dev}")
    odt = _out_dtype(w_seg_p, out_dtype)
    S, P = seg_g0.shape[0], sig.shape[0]
    pg = table.shape[1]
    L = P * n_rows
    _check_inputs("onehot_prefix_sums", dev, (
        ("table", table, torch.int16), ("sig", sig, torch.int32),
        ("seg_g0", seg_g0, torch.int32)))
    if odt not in (torch.int16, torch.int32):
        raise ValueError(f"onehot_prefix_sums: output dtype {odt}")
    if w_seg_p % pg or L > 8192 or P > 64:
        raise ValueError(
            f"onehot_prefix_sums: w_seg_p={w_seg_p} must be a multiple of "
            f"{pg}, P*R={L} <= 8192 and P={P} <= 64"
        )
    from .. import kernels

    lib = kernels.load()
    tile = lib.fscl_ps_tile()
    n_tiles = -(-w_seg_p // tile)
    out = torch.empty((S * w_seg_p, L), dtype=odt, device=dev)
    scratch = torch.empty(S * n_tiles * L, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fscl_onehot_prefix_sums(
            table.data_ptr(), sig.data_ptr(), seg_g0.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), S, w_seg_p, P, n_rows,
            sig.shape[1], pg, out.element_size(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, rc, "onehot_prefix_sums")
    global launches
    launches += 1
    return out


def weighted_prefix_sums_plain(table, weights, sig, seg_g0, *, w_seg_p):
    """Plain PyTorch version: index math, weight rows, a float64 cumsum
    per segment, rounded to float32."""
    S, P = seg_g0.shape[0], sig.shape[0]
    R = weights.shape[1]
    ids = segment_row_ids(table, sig, seg_g0, w_seg_p=w_seg_p)
    wt = weights.to(torch.float64)[ids.to(torch.int64)]  # [S, w, P, R]
    ps = torch.cumsum(wt, dim=1)
    return ps.to(torch.float32).reshape(S * w_seg_p, P * R)


def weighted_prefix_sums(table, weights, sig, seg_g0, *, w_seg_p):
    """[S*w_seg_p, P*R] f32 segmented prefix sums of weight channels.

    table: [G+1, PERM_GROUP] int16 row-id group table (ids in
    [0, R_used], R_used = the zero sentinel row); weights: [R_used+1, R]
    f32; sig, seg_g0 as for onehot_prefix_sums.  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.
    """
    dev = table.device
    if dev.type == "cpu":
        return weighted_prefix_sums_plain(
            table, weights, sig, seg_g0, w_seg_p=w_seg_p
        )
    if dev.type != "cuda":
        raise ValueError(f"weighted_prefix_sums: unsupported device {dev}")
    _check_inputs("weighted_prefix_sums", dev, (
        ("table", table, torch.int16), ("weights", weights, torch.float32),
        ("sig", sig, torch.int32), ("seg_g0", seg_g0, torch.int32)))
    S, P = seg_g0.shape[0], sig.shape[0]
    pg = table.shape[1]
    n_ids, R = weights.shape
    if w_seg_p % pg or n_ids > 32768:
        raise ValueError(
            f"weighted_prefix_sums: w_seg_p={w_seg_p} must be a multiple of "
            f"{pg} and the weight table ({n_ids} rows) at most 32768 rows"
        )
    from .. import kernels

    lib = kernels.load()
    tile = lib.fscl_wps_tile()
    n_tiles = -(-w_seg_p // tile)
    L = P * R
    out = torch.empty((S * w_seg_p, L), dtype=torch.float32, device=dev)
    scratch = torch.empty(S * n_tiles * L, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fscl_weighted_prefix_sums(
            table.data_ptr(), weights.data_ptr(), sig.data_ptr(),
            seg_g0.data_ptr(), out.data_ptr(), scratch.data_ptr(), S,
            w_seg_p, P, R, n_ids, sig.shape[1], pg,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, rc, "weighted_prefix_sums")
    global weighted_launches
    weighted_launches += 1
    return out
