"""Traffic kind "scan": one ``scan_genome`` of the whole genome a step, on
one card.

Each step scans a fresh data object made in set-up from the seed's
arrays, so the program's per-data caches start cold, as they do for a
user with a new genome.  The step's work is one scan.  Parameters of a
traffic file of this kind:

  sites   how the genome is made from --seed (genome.py)
  check   {"intervals": n}: the intervals the check samples a run

Set-up warms up one scan on the cell's shapes, then makes the data
objects the window will take: enough for its seconds at the warm-up's
pace with half again to spare, at most MAX_STEPS.
"""

from __future__ import annotations

import math
import time

from portbench import check
from portbench.genome import make_genome
from portbench.harness import Step
from portbench.program import Program, one_card

MAX_STEPS = 256


class Traffic:
    def __init__(self, params, cfg, seed, device, faults=None):
        self.p, self.cfg, self.seed = params, cfg, seed
        self.dev, self.sync = one_card(device)
        self.build_s = Program.build_kernels(self.dev)
        self.genome = make_genome(cfg, seed, params["sites"])
        self.prog = Program(self.genome, cfg, self.dev)
        if faults is not None:
            faults(self.prog)
        self.pool = []
        self.ref = None

    def setup(self, seconds):
        prog = self.prog
        t0 = time.monotonic()
        prog.scan(prog.fresh_data())
        self.sync()
        dt = max(time.monotonic() - t0, 1e-3)
        n = min(int(math.ceil(seconds / dt * 1.5)) + 2, MAX_STEPS)
        self.pool = [prog.fresh_data() for _ in range(n)]

    def step(self, index):
        if index >= len(self.pool):
            raise RuntimeError("the window outran the fresh data objects "
                               "made in set-up")
        data = self.pool[index]
        self.pool[index] = None
        return Step(None, self.prog.scan(data), 1.0, {})

    def release(self):
        self.pool = []
        self.prog.release()
        self.prog = None

    def check(self, steps, precision=None):
        if self.ref is None:
            self.ref = check.Reference(self.genome, self.cfg, self.dev)
        return check.check_scans(self.ref, [s.result for s in steps],
                                 self.cfg["scan"],
                                 self.p["check"]["intervals"], self.seed,
                                 precision=precision)
