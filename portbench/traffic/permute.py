"""Traffic kind "permute": one ``scan_permute`` pass a step, on one card.

Set-up scans the genome once.  Each pass runs on a copy of that scan's
result, with every interval finished except the ``active`` ones, to
``n_permute`` rounds at ``chunk_replicates``, under a permutation seed
drawn from (--seed, pass index).  The step's work is the permute_n that
the pass's points gained (point-rounds).  Parameters of a traffic file
of this kind:

  sites             how the genome is made from --seed (genome.py)
  active            "all", or "top_per_chromosome": each chromosome's
                    highest-CLR interval, as bench/run_tail.py picks them
  n_permute         rounds a pass
  chunk_replicates  replicates a chunk (the CLI's default: 16)
  check             {"nulls": n, "points": m}: the (pass, point,
                    replicate) triples whose saved null value the check
                    recomputes, and the points a pass whose counts it
                    checks
"""

from __future__ import annotations

import copy

import numpy as np

from portbench import check
from portbench.genome import make_genome, seed_entropy
from portbench.harness import Step
from portbench.program import Program, one_card


def pass_seed(seed, index):
    """The permutation seed of pass ``index`` (-1: the warm-up) of a run
    seeded ``seed``: a 31-bit word, so the program's stream and host
    generator take it as they take the CLI's --seed."""
    ss = np.random.SeedSequence([seed_entropy(seed), 0x5EED, index + 1])
    return int(ss.generate_state(1, np.uint32)[0] >> 1)


def active_points(result, mode):
    if mode == "all":
        return np.arange(result.n_points)
    if mode == "top_per_chromosome":
        cid = result.chr_id
        return np.array([np.where(cid == c)[0][np.argmax(result.clr[cid == c])]
                         for c in np.unique(cid)])
    raise ValueError(f"unknown active set {mode!r}")


class Traffic:
    def __init__(self, params, cfg, seed, device, faults=None):
        self.p, self.cfg, self.seed = params, cfg, seed
        self.dev, self.sync = one_card(device)
        self.build_s = Program.build_kernels(self.dev)
        self.genome = make_genome(cfg, seed, params["sites"])
        self.prog = Program(self.genome, cfg, self.dev)
        if faults is not None:
            faults(self.prog)
        self.result0 = None
        self.active = None
        self.ref = None

    def setup(self, seconds):
        self.result0 = self.prog.scan(self.prog.data)
        self.active = active_points(self.result0, self.p["active"])
        self._pass(-1)

    def _pass(self, index):
        r = copy.deepcopy(self.result0)
        r.permute_finished[:] = True
        r.permute_finished[self.active] = False
        seed = pass_seed(self.seed, index)
        counters = self.prog.permute(
            r, n_permute=int(self.p["n_permute"]),
            chunk_replicates=int(self.p["chunk_replicates"]), seed=seed)
        return seed, r, counters

    def step(self, index):
        seed, r, counters = self._pass(index)
        return Step(seed, r, float(r.permute_n[self.active].sum()), counters)

    def release(self):
        self.prog.release()
        self.prog = None

    def check(self, steps, precision=None):
        if self.ref is None:
            self.ref = check.Reference(self.genome, self.cfg, self.dev)
        chk = self.p["check"]
        return check.check_passes(
            self.ref, steps, self.active, self.cfg["permute"],
            self.cfg["scan"], int(self.p["n_permute"]), chk["nulls"],
            chk["points"], self.seed, precision=precision)
