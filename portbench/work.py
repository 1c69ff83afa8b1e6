"""The work of a kernel launch, counted from the shapes of the call, and
its least time on the card: the larger of its bytes over the HBM rate
and its operations over the published peak for their precision
(peaks.json).  A kernel's roofline share is the sum of its launches'
least times over its device time in the trace.

The counts are frozen copies of the ones the port's smoke run kept
(chip_smoke.py's ``bound``, ``_window_clr_case``, ``_lattice_case``):
  prefix        the 1b one-hot prefix sum: its inputs read once and its
                [S*w, P*R] output written once; 2 operations an output
                entry.
  window_clr    the bf16 window statistic: the distinct prefix rows the
                bounds read, the bounds, fbar, the bf16 pack [K, A] and
                the [c, P, A] output; the MMA's 2 c P K A at the bf16
                tensor-core rate, 6 c P K lerp operations at the FP32 rate.
  window_clr_f32  the same with a float32 pack and three TF32 MMAs (its
                3xTF32 products) at the TF32 rate.
  clr_lattice   every input and the output once; 12 + 7 A operations a
                (replicate, candidate, site) pair at the FP32 rate.
with K = 2 * n_cells * n_rows.  Each term is timed alone and the
largest taken, so the least time is a lower bound and a share cannot
pass 100% unless the count or the time is wrong.

``Capture`` wraps the program's Python wrappers of these kernels (the
names the program's modules call them by) in a traced run only, and
keeps per launch what the count needs.  Counts that depend on the data
(distinct bound rows, live pairs) are reduced on the card after the
window.
"""

from __future__ import annotations

import json
import pathlib

import torch

PEAKS = json.loads((pathlib.Path(__file__).parent / "peaks.json").read_text())

# device-trace name patterns of each family (every substring must match)
KERNELS = {
    "prefix": ("onehot_chained_scan", "SegmentSource"),
    "window_clr": ("window_clr_kernel",),
    "window_clr_f32": ("window_clr_f32",),
    "clr_lattice": ("lattice_clr_kernel",),
}
# and the f32 kernel's split reduction, part of the same launch
KERNELS_EXTRA = {"window_clr_f32": (("reduce_splits",),)}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def least_s(n_bytes, terms):
    """max(bytes / HBM rate, ops / rate for each (ops, rate) term)."""
    t = n_bytes / PEAKS["hbm_bytes_per_s"]
    for ops, rate in terms:
        t = max(t, ops / rate)
    return t


def prefix_least(table, sig, seg_g0, out):
    return least_s(nbytes(table, sig, seg_g0, out),
                   [(2 * out.numel(), PEAKS["fp32_flops"])])


def window_least(distinct_rows, *, row_bytes, fixed_bytes, c, P, n_cells,
                 n_rows, n_alpha, pack_bytes, mma_rate, mma_passes):
    """Least seconds of one window launch: ``distinct_rows`` prefix rows
    of ``row_bytes`` each, plus ``fixed_bytes`` (bounds, fbar, output)."""
    A, K = n_alpha, 2 * n_cells * n_rows
    b = distinct_rows * row_bytes + fixed_bytes + K * A * pack_bytes
    return least_s(b, [(mma_passes * 2 * c * P * K * A, mma_rate),
                       (6 * c * P * K, PEAKS["fp32_flops"])])


def lattice_least(pairs, args, out, n_offsets):
    return least_s(nbytes(*args, out),
                   [(pairs * (12 + 7 * n_offsets), PEAKS["fp32_flops"])])


def _distinct(t):
    """Distinct values of an integer tensor, on its device."""
    s = t.flatten().sort().values
    return (s[1:] != s[:-1]).sum() + 1


def _live_pairs(lo, hi):
    """Sites in the windows [lo, hi] of a lattice launch's candidates."""
    return (hi.to(torch.int64) - lo + 1).clamp_min(0).sum()


class Capture:
    """Wraps the wrappers of ``families`` while installed; ``least()``
    gives {family: (launches, summed least seconds)} once the window has
    closed.

    Inside the window a wrapper only records the call's shapes and keeps
    a reference to the tensors whose values the count needs (a window
    launch's bounds, where its least time differs between none and all of
    the rows they name; a lattice launch's lo and hi), each distinct
    tensor once; it launches nothing on the card.  The counts are reduced
    on the card by ``least()``, after the window, so the trace holds the
    program's own launches alone.  Held tensors are kept alive up to
    HOLD_BYTES; a launch past that is reduced when it is made and
    counted in ``inline``.  A held tensor that the program changed in
    place after the launch (its version moved) leaves its family out."""

    HOLD_BYTES = 2 << 30

    def __init__(self, families):
        self.families = set(families)
        self.records = {f: [] for f in self.families}
        self.held = {}
        self.held_bytes = 0
        self.inline = 0
        self._undo = []

    def _patch(self, module, name, wrap):
        orig = getattr(module, name)
        setattr(module, name, wrap(orig))
        self._undo.append((module, name, orig))

    def _record(self, family, count, reduce, *tensors):
        """Keep ``count(reduce(*tensors))`` for after the window."""
        key = tuple((id(t), t.data_ptr(), tuple(t.shape), t._version)
                    for t in tensors)
        if key not in self.held:
            size = nbytes(*tensors)
            if self.held_bytes + size > self.HOLD_BYTES:
                self.inline += 1
                self.records[family].append((count, reduce(*tensors)))
                return
            self.held[key] = (tensors, reduce)
            self.held_bytes += size
        self.records[family].append((count, key))

    def install(self):
        import fscl_tpu_torch.ops.histclr as histclr
        import fscl_tpu_torch.ops.lattice as lattice

        rec = self.records
        if "prefix" in self.families:
            def w_prefix(orig):
                def f(table, sig, seg_g0, **kw):
                    out = orig(table, sig, seg_g0, **kw)
                    rec["prefix"].append(
                        (prefix_least(table, sig, seg_g0, out), None))
                    return out
                return f
            self._patch(histclr, "onehot_prefix_sums", w_prefix)
        for fam, name, pack_bytes, rate, passes in (
                ("window_clr", "window_clr", 2, PEAKS["bf16_tensor_flops"],
                 1),
                ("window_clr_f32", "window_clr_f32", 4,
                 PEAKS["tf32_tensor_flops"], 3)):
            if fam not in self.families:
                continue

            def w_win(orig, fam=fam, pack_bytes=pack_bytes, rate=rate,
                      passes=passes):
                def f(ps, bounds, fbar, pack, **kw):
                    out = orig(ps, bounds, fbar, pack, **kw)
                    k = dict(row_bytes=ps.shape[1] * ps.element_size(),
                             fixed_bytes=nbytes(bounds, fbar, out),
                             c=bounds.shape[0], P=out.shape[1],
                             n_cells=kw["n_cells"], n_rows=kw["n_rows"],
                             n_alpha=kw["n_alpha"], pack_bytes=pack_bytes,
                             mma_rate=rate, mma_passes=passes)
                    # the distinct rows matter only where the bytes can
                    # decide the least time: between none and every row
                    # the bounds name
                    lo_t = window_least(0, **k)
                    if window_least(bounds.numel(), **k) == lo_t:
                        rec[fam].append((lo_t, None))
                    else:
                        self._record(fam,
                                     lambda d, k=k: window_least(d, **k),
                                     _distinct, bounds)
                    return out
                return f
            self._patch(histclr, name, w_win)
        if "clr_lattice" in self.families:
            def w_lat(orig):
                def f(*args, **kw):
                    out = orig(*args, **kw)
                    shapes = [_Shape(t) for t in args]
                    self._record(
                        "clr_lattice",
                        lambda live, s=shapes, o=_Shape(out),
                        Rr=out.shape[0], A=out.shape[2]:
                        lattice_least(live * Rr, s, o, A),
                        _live_pairs, args[5], args[6])
                    return out
                return f
            self._patch(lattice, "clr_lattice", w_lat)
        return self

    def remove(self):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo = []

    def least(self):
        """{family: (launches, least seconds)}: reduces the held tensors
        on their card (call after the window), then drops them.  A family
        with a held tensor changed in place is left out."""
        done, changed = {}, set()
        for key, (tensors, reduce) in self.held.items():
            if any(t._version != k[3] for t, k in zip(tensors, key)):
                changed.add(key)
            else:
                done[key] = int(reduce(*tensors))
        out = {}
        for fam, recs in self.records.items():
            if any(v in changed for _, v in recs if isinstance(v, tuple)):
                continue
            tot = 0.0
            for count, v in recs:
                if v is None:
                    tot += count
                elif isinstance(v, tuple):
                    tot += count(done[v])
                else:
                    tot += count(int(v))
            out[fam] = (len(recs), tot)
        self.held, self.held_bytes = {}, 0
        return out

    def stats(self):
        """What the capture held (bytes) and reduced inside the window."""
        return {"held_bytes": self.held_bytes, "inline": self.inline}


class _Shape:
    """numel and element size of a tensor, without holding its memory."""

    def __init__(self, t):
        self._n, self._e = t.numel(), t.element_size()

    def numel(self):
        return self._n

    def element_size(self):
        return self._e


def roofline_share(reading, family):
    """Percent: the family's summed least time over its device time in
    the trace; None where the window launched none of it."""
    launches, least = reading.least.get(family, (0, 0.0))
    dev = reading.trace.device_s(KERNELS[family])
    for pattern in KERNELS_EXTRA.get(family, ()):
        dev += reading.trace.device_s(pattern)
    if launches == 0 or dev <= 0:
        return None
    return 100.0 * least / dev
