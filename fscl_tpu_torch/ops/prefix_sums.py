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

``rowid_prefix_sums`` and ``perm_prefix_sums`` are the same TPU kernel's
unsegmented modes, with a zero first row:

    ps[0, p*R + r] = 0,  ps[k+1, p*R + r] = #{k' <= k : id(p, k') == r}

  (a)  rowid: id(p, k) = row_rep[p, k], the replicate-stacked row ids of
       build_prefix_sums (fscl_tpu/ops/histclr.py:873);
  (b') perm:  id(p, k) = table[sig[p, g0 + j // PERM_GROUP],
       j % PERM_GROUP], j = off + k, for sites k < n of one chromosome
       that starts at genome site start = g0*PERM_GROUP + off; sites
       k >= n have no id.  This is _perm_ps's gather, shift and mask in
       front of build_prefix_sums_oh (fscl_tpu/engine/permute.py:648,
       fscl_tpu/ops/histclr.py:811), fused as the segmented mode is.

Output is int16 when W <= 32767 and int32 otherwise (W = row_rep's width,
or w_pad), the rule of the JAX package's prefix functions.

Each wrapper runs the plain PyTorch version for CPU tensors and its CUDA
kernel for CUDA tensors; it never falls back from one to the other.  The
three one-hot modes are one kernel body in csrc/prefix_sums.cu, a chained
scan with decoupled look-back (csrc/chained_scan.cuh) templated on where a
site's id comes from; the weighted mode is csrc/weighted_prefix_sums.cu.
``launches``, ``weighted_launches``, ``rowid_launches`` and
``perm_launches`` count the kernels' launches.
"""

from __future__ import annotations

import torch

launches = 0  # CUDA kernel launches by onehot_prefix_sums
weighted_launches = 0  # CUDA kernel launches by weighted_prefix_sums
rowid_launches = 0  # CUDA kernel launches by rowid_prefix_sums
perm_launches = 0  # CUDA kernel launches by perm_prefix_sums
# lanes (P*R) and replicates the row-id modes take: at R = 1 a 64-lane
# block stages 512 sites of 64 replicates' int16 ids (64 KB of shared
# memory)
ROWID_LANES_MAX = 8192
ROWID_REPS_MAX = 256
# lanes (P*R) and replicates of one onehot_prefix_sums launch
ONEHOT_LANES_MAX = 8192
ONEHOT_REPS_MAX = 64


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
    if w_seg_p % pg or L > ONEHOT_LANES_MAX or P > ONEHOT_REPS_MAX:
        raise ValueError(
            f"onehot_prefix_sums: w_seg_p={w_seg_p} must be a multiple of "
            f"{pg}, P*R={L} <= {ONEHOT_LANES_MAX} and P={P} <= "
            f"{ONEHOT_REPS_MAX}"
        )
    from .. import kernels

    lib = kernels.load()
    out = torch.empty((S * w_seg_p, L), dtype=odt, device=dev)
    scratch = torch.empty(lib.fscl_ps_scratch_bytes(S, w_seg_p, P, n_rows),
                          dtype=torch.uint8, device=dev)
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
    out = torch.empty((S * w_seg_p, P * R), dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.fscl_wps_scratch_bytes(S, w_seg_p, P, R),
                          dtype=torch.uint8, device=dev)
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


# ---- unsegmented row-id modes (a) and (b') --------------------------------

def _onehot_prefix(ids, n_rows, out_dtype):
    """[W, P] ids -> [W+1, P*n_rows] one-hot prefix counts, row 0 zero:
    an int32 cumsum cast to out_dtype."""
    W, P = ids.shape
    oh = ids[..., None] == torch.arange(n_rows, dtype=ids.dtype,
                                        device=ids.device)
    body = torch.cumsum(oh.to(torch.int32), dim=0, dtype=torch.int32)
    out = torch.zeros((W + 1, P * n_rows), dtype=out_dtype, device=ids.device)
    out[1:] = body.reshape(W, P * n_rows).to(out_dtype)
    return out


def rowid_prefix_sums_plain(row_rep, *, n_rows, out_dtype=None):
    """Plain PyTorch version of mode (a): one-hot compare, int32 cumsum."""
    W = row_rep.shape[1]
    return _onehot_prefix(row_rep.T, n_rows, _out_dtype(W, out_dtype))


def _launch_rowid(what, lib_fn, dev, W, P, n_rows, out_dtype, args):
    """Allocate, check limits, launch one row-id kernel (none at W = 0,
    where the C entry point only zeroes row 0); the output."""
    odt = _out_dtype(W, out_dtype)
    L = P * n_rows
    if odt not in (torch.int16, torch.int32):
        raise ValueError(f"{what}: output dtype {odt}")
    if L > ROWID_LANES_MAX or P > ROWID_REPS_MAX or n_rows > 32767:
        raise ValueError(
            f"{what}: P*R={L} must be <= {ROWID_LANES_MAX}, "
            f"P={P} <= {ROWID_REPS_MAX} and R={n_rows} <= 32767"
        )
    from .. import kernels

    lib = kernels.load()
    out = torch.empty((W + 1, L), dtype=odt, device=dev)
    # flags and ticket of the chained scan, in 8-byte words
    scratch = torch.empty(lib.fscl_ps_scratch_bytes(1, W, P, n_rows) // 8,
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, lib_fn)(
            *args(out, scratch), out.element_size(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, rc, what)
    return out


def rowid_prefix_sums(row_rep, *, n_rows, out_dtype=None):
    """[W+1, P*n_rows] prefix counts of replicate-stacked row ids, mode (a)
    (see module doc).

    row_rep: [P, W] int32 compact row ids (ids outside [0, n_rows) count
    nowhere).  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise.
    """
    dev = row_rep.device
    if dev.type == "cpu":
        return rowid_prefix_sums_plain(row_rep, n_rows=n_rows,
                                       out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"rowid_prefix_sums: unsupported device {dev}")
    _check_inputs("rowid_prefix_sums", dev,
                  (("row_rep", row_rep, torch.int32),))
    P, W = row_rep.shape
    out = _launch_rowid(
        "rowid_prefix_sums", "fscl_rowid_prefix_sums", dev, W, P, n_rows,
        out_dtype,
        lambda out, scratch: (row_rep.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), W, P, n_rows),
    )
    global rowid_launches
    if W:
        rowid_launches += 1
    return out


def _perm_geometry(table, sig, start, n, w_pad):
    """(g0, off) of a chromosome slab; raises unless its n sites lie in
    w_pad and in sig's columns."""
    pg = table.shape[1]
    g0, off = divmod(int(start), pg)
    if not 0 <= n <= w_pad:
        raise ValueError(f"perm_prefix_sums: n={n} outside [0, w_pad={w_pad}]")
    if n and g0 + (off + n - 1) // pg >= sig.shape[1]:
        raise ValueError(
            f"perm_prefix_sums: sigma has {sig.shape[1]} columns; sites up "
            f"to start + n = {start + n} need the sentinel padding"
        )
    return g0, off


def perm_row_ids(table, sig, *, start, n, w_pad):
    """[w_pad, P] row id of each site k of the permuted chromosome slab
    (see module doc); -1 at sites k >= n."""
    pg = table.shape[1]
    g0, off = _perm_geometry(table, sig, start, n, w_pad)
    j = off + torch.arange(w_pad, device=sig.device)
    col = torch.clamp(g0 + j // pg, max=sig.shape[1] - 1)
    sel = sig[:, col].to(torch.int64)  # [P, w_pad]
    ids = table[sel, (j % pg)[None, :]].to(torch.int32)
    ids = torch.where(j[None, :] - off < n, ids, -1)
    return ids.T


def perm_prefix_sums_plain(table, sig, *, start, n, w_pad, n_rows,
                           out_dtype=None):
    """Plain PyTorch version of mode (b'): the index math, one-hot
    compare, int32 cumsum."""
    ids = perm_row_ids(table, sig, start=start, n=n, w_pad=w_pad)
    return _onehot_prefix(ids, n_rows, _out_dtype(w_pad, out_dtype))


def perm_prefix_sums(table, sig, *, start, n, w_pad, n_rows,
                     out_dtype=None):
    """[w_pad+1, P*n_rows] prefix counts of one chromosome's permuted
    stream, mode (b') (see module doc).

    table: [G+1, PERM_GROUP] int16 row-id group table; sig: [P, n_sig]
    int32 group sigma, sentinel-padded past the last group the
    chromosome's n sites reach.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise.
    """
    dev = table.device
    if dev.type == "cpu":
        return perm_prefix_sums_plain(table, sig, start=start, n=n,
                                      w_pad=w_pad, n_rows=n_rows,
                                      out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"perm_prefix_sums: unsupported device {dev}")
    _check_inputs("perm_prefix_sums", dev, (
        ("table", table, torch.int16), ("sig", sig, torch.int32)))
    g0, off = _perm_geometry(table, sig, start, n, w_pad)
    P, n_sig = sig.shape
    pg = table.shape[1]
    out = _launch_rowid(
        "perm_prefix_sums", "fscl_perm_prefix_sums", dev, w_pad, P, n_rows,
        out_dtype,
        lambda out, scratch: (table.data_ptr(), sig.data_ptr(),
                              out.data_ptr(), scratch.data_ptr(), w_pad, P,
                              n_rows, n_sig, g0, off, n, pg),
    )
    global perm_launches
    if w_pad:
        perm_launches += 1
    return out
