"""Faults planted under the program's timed path, to show that the check
fails a broken program: the tests run each at test size on the CPU, and
control.py --fault reads them on the card at a cell's own size.  A run
of the benchmark plants none.

Each fault is ``fault(program)``; ``planted(name)`` gives it wrapped so
that it is undone when the run releases its program, and named
(``.name``), so that a kind whose ranks live in several processes
(traffic/permute_split.py) plants it in every rank's program.

  unchanged_pass   a permutation pass returns the result unchanged
  altered_nulls    each round's null maximum is raised by 0.5 where the
                   driver records it
  half_candidates  the second half of each window-statistic call's
                   candidates take the first half's values (both kernels)
  half_lattice     the second half of each lattice call's candidates read
                   -1e9
  altered_clr      every reported scan CLR is raised by 1e-3 (relative)
                   and 1e-3
  selection        the bf16 window statistic that the hist scan's dense
                   and refine stages select candidates by returns its
                   candidates' values in a shuffled order; the f32 tie
                   stage, which values what the selection picked, is
                   left whole
  split_rows       under a split, rank 0 evaluates rank 1's replicate
                   rows of each permutation chunk in place of its own
  no_gather        under a split, the permutation chunks' exchange is
                   left out: each rank's gathered statistic holds its own
                   rows and zeros in the other ranks'
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def unchanged_pass(prog):
    prog.permute = lambda result, **kw: {}


def altered_nulls(prog):
    from fscl_tpu_torch.engine import permute as TP

    orig = TP._apply_round_updates

    def f(result, active, threshold, rng, cfg, act, null_max, *a):
        return orig(result, active, threshold, rng, cfg, act,
                    null_max + 0.5, *a)

    TP._apply_round_updates = f
    prog._restore = lambda: setattr(TP, "_apply_round_updates", orig)


def half_candidates(prog):
    from fscl_tpu_torch.ops import histclr

    saved = {n: getattr(histclr, n) for n in ("window_clr", "window_clr_f32")}

    def broken(orig):
        def f(ps, bounds, fbar, pack, **kw):
            out = orig(ps, bounds, fbar, pack, **kw)
            h = (out.shape[0] + 1) // 2
            out[h:] = out[:out.shape[0] - h]
            return out
        return f

    for n, orig in saved.items():
        setattr(histclr, n, broken(orig))
    prog._restore = lambda: [setattr(histclr, n, o) for n, o in saved.items()]


def half_lattice(prog):
    from fscl_tpu_torch.ops import lattice

    orig = lattice.clr_lattice

    def f(*a, **k):
        out = orig(*a, **k)
        h = (out.shape[1] + 1) // 2
        out[:, h:] = -1e9
        return out

    lattice.clr_lattice = f
    prog._restore = lambda: setattr(lattice, "clr_lattice", orig)


def altered_clr(prog):
    scan = prog.scan

    def f(data):
        r = scan(data)
        r.clr += 1e-3 * abs(r.clr) + 1e-3
        return r

    prog.scan = f


def selection(prog):
    from fscl_tpu_torch.ops import histclr

    orig = histclr.window_clr
    gen = torch.Generator().manual_seed(0x5E1EC7)

    def f(ps, bounds, fbar, pack, **kw):
        out = orig(ps, bounds, fbar, pack, **kw)
        perm = torch.randperm(out.shape[0], generator=gen)
        return out[perm.to(out.device)]

    histclr.window_clr = f
    prog._restore = lambda: setattr(histclr, "window_clr", orig)


def _in_permute(prog, name, replace):
    """``fscl_tpu_torch.parallel.shard.<name>`` replaced by
    ``replace(original)`` while the program's permutation passes run (the
    scan's exchanges stay whole)."""
    from fscl_tpu_torch.parallel import shard

    orig = getattr(shard, name)
    new = replace(orig)
    permute = prog.permute

    def f(result, **kw):
        setattr(shard, name, new)
        try:
            return permute(result, **kw)
        finally:
            setattr(shard, name, orig)

    prog.permute = f


def split_rows(prog):
    def replace(split_range):
        def f(n, split):
            if split is not None and split.world > 1 and split.rank == 0:
                return split_range(n, dataclasses.replace(split, rank=1))
            return split_range(n, split)
        return f

    _in_permute(prog, "split_range", replace)


def no_gather(prog):
    from fscl_tpu_torch.parallel import shard

    def replace(gather_rows):
        def f(x, n, split):
            x = np.asarray(x)
            if split is None or split.world <= 1:
                return x
            r0, r1 = shard.split_range(n, split)
            out = np.zeros((n, *x.shape[1:]), x.dtype)
            out[r0:r1] = x
            return out
        return f

    _in_permute(prog, "gather_rows", replace)


FAULTS = {f.__name__: f for f in (unchanged_pass, altered_nulls,
                                  half_candidates, half_lattice,
                                  altered_clr, selection, split_rows,
                                  no_gather)}


def planted(name):
    """The fault ``name``, undone when the run's program is released."""
    fault = FAULTS[name]

    def apply(prog):
        fault(prog)
        release = prog.release

        def f():
            getattr(prog, "_restore", lambda: None)()
            release()

        prog.release = f
    apply.name = name
    return apply
