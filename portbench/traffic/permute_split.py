"""Traffic kind "permute_split": traffic/permute.py's passes, each split
over ``ranks`` torch.distributed ranks, one card a rank, as the CLI
runs under ``python -m torch.distributed.run``.

Rank 0 is the harness's process, on the first card; this kind starts
ranks 1 to ranks - 1 as child processes of its own (``python -m
portbench.traffic.permute_split``), rank r on card r, with the variables
torch.distributed.run sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT; the port one that rank 0's store took).  A child writes to
standard error only.  Every rank makes the same genome from (config,
--seed, sites), builds its own program on its card, starts the gloo
group with a finite timeout (TIMEOUT) and joins the split through the
program's own ``fscl_tpu_torch.parallel.init_split``; a rank that dies
then ends the others' next exchange with an error, never a hang.

Set-up, on every rank: the scan under the split, then the warm-up pass
(-1).  Each step rank 0 broadcasts (run, pass index) and every rank runs
that pass under the split, on a copy of its scan's result as permute.py
does; one ``gather_objects`` at the pass's end brings every rank's
gather seconds.  ``cards()`` has each rank read its own card;
``release()`` broadcasts stop, gathers each rank's digest of every
pass's results and the forbidden modules it loaded, and waits for the
children: a child that exited non-zero, or loaded JAX or the JAX
package, fails the run.

Every rank runs at OMP_NUM_THREADS torch threads, 1 where it is unset,
as torch.distributed.run sets it for more than one process a host (on
the CPU the statistic's float32 bits follow the thread count).  Each
rank writes the seconds of its set-up's pieces to standard error
(``permute_split: rank r set-up {...}``).

Parameters: ``ranks`` and those of permute.py.  Counters of a step: the
program's (rank 0's), rank 0's ``split_gather_s``,
``split_gather_bytes`` and ``split_gathers``, and
``split_gather_s_max``, the largest ``split_gather_s`` over the ranks.
The check: rank 0's passes as permute.py checks them, and
``rank_mismatch``, the (pass, rank) whose permute_n, exceedance counts,
finished flags, thresholds or saved nulls differ from rank 0's in any
bit.
"""

from __future__ import annotations

import atexit
import copy
import datetime
import hashlib
import itertools
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from portbench import check, devtrace
from portbench.genome import make_genome
from portbench.harness import Step, forbidden_modules
from portbench.program import Program

ROOT = pathlib.Path(__file__).resolve().parents[2]
TIMEOUT = datetime.timedelta(seconds=600)
STOP, RUN, CARDS, TRACE = 0, 1, 2, 3
_kinds = {}
_live = []  # children not yet waited for, ended at exit


def _permute_kind():
    """traffic/permute.py (its pass_seed and active_points), loaded once
    as the harness loads a kind."""
    if "permute" not in _kinds:
        from portbench.harness import load_kind

        _kinds["permute"] = load_kind("permute")
    return _kinds["permute"]


@atexit.register
def _end_children():
    while _live:
        p = _live.pop()
        if p.poll() is None:
            p.kill()
        p.wait()


def digest(result):
    """A hash of a pass's results: permute_n, permute_p,
    permute_finished, stat_threshold and every saved null."""
    h = hashlib.sha256()
    for a in (result.permute_n, result.permute_p, result.permute_finished,
              result.stat_threshold):
        h.update(np.ascontiguousarray(a).tobytes())
    nulls = result.null_clr
    h.update(np.fromiter((-1 if x is None else len(x) for x in nulls),
                         np.int64, count=len(nulls)).tobytes())
    h.update(np.fromiter(itertools.chain.from_iterable(
        x for x in nulls if x), np.float64).tobytes())
    return h.hexdigest()


class Rank:
    """What every rank does: its genome and program on its card, its
    place in the split, its passes."""

    def __init__(self, params, cfg, seed, device, rank):
        """The rank's card, its context made, and the kernel library
        loaded (built, at a checkout's first run, by rank 0)."""
        from fscl_tpu_torch.parallel.mesh import rank_device

        self.p, self.cfg, self.seed, self.rank = params, cfg, seed, rank
        self.t = time.monotonic()
        self.times = {}
        self.dev = rank_device(device, rank)
        if self.dev.type == "cuda":
            torch.cuda.set_device(self.dev)
            torch.zeros(1, device=self.dev)
        self.build_s = Program.build_kernels(self.dev)
        self.lap("card")
        self.genome = self.prog = self.split = None
        self.result0 = self.active = None
        self.results = []  # the window's passes (index >= 0)
        self.prof = None

    def lap(self, name):
        """Keep the seconds since the last lap under ``name``."""
        t = time.monotonic()
        self.times[name] = self.times.get(name, 0.0) + t - self.t
        self.t = t

    def make(self, fault=None):
        """The genome and the program on this rank's card, with the
        planted ``fault`` (faults.py) where one is given."""
        self.genome = make_genome(self.cfg, self.seed, self.p["sites"])
        self.prog = Program(self.genome, self.cfg, self.dev)
        if fault is not None:
            fault(self.prog)
        self.lap("make")

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def join(self, store, device):
        """Start the gloo group on ``store`` and join the split."""
        import torch.distributed as dist
        from fscl_tpu_torch.parallel import init_split

        dist.init_process_group(
            "gloo", store=store, rank=self.rank,
            world_size=int(self.p["ranks"]), timeout=TIMEOUT)
        self.split = init_split(device)
        self.lap("join")

    def setup(self):
        pk = _permute_kind()
        self.lap("wait")
        self.result0 = self.prog.scan(self.prog.data, split=self.split)
        self.active = pk.active_points(self.result0, self.p["active"])
        self.lap("scan")
        self.run(-1)
        self.lap("warm_up")
        print(f"permute_split: rank {self.rank} set-up "
              f"{json.dumps(self.times)}", file=sys.stderr, flush=True)

    def command(self):
        """Rank 0's next (op, pass index), on every rank."""
        import torch.distributed as dist

        t = torch.zeros(2, dtype=torch.int64)
        dist.broadcast(t, src=0, group=self.split.group)
        return int(t[0]), int(t[1])

    def order(self, op, index=0):
        import torch.distributed as dist

        dist.broadcast(torch.tensor([op, index], dtype=torch.int64), src=0,
                       group=self.split.group)

    def run(self, index):
        """Pass ``index`` under the split: (seed, result, counters)."""
        from fscl_tpu_torch.parallel import shard

        pk = _permute_kind()
        r = copy.deepcopy(self.result0)
        r.permute_finished[:] = True
        r.permute_finished[self.active] = False
        seed = pk.pass_seed(self.seed, index)
        g0 = dict(shard.stats)
        counters = self.prog.permute(
            r, n_permute=int(self.p["n_permute"]),
            chunk_replicates=int(self.p["chunk_replicates"]), seed=seed,
            split=self.split)
        counters.update({f"split_{k}": shard.stats[k] - g0[k]
                         for k in ("gather_s", "gather_bytes", "gathers")})
        got = shard.gather_objects(counters["split_gather_s"], self.split)
        counters["split_gather_s_max"] = max(got)
        if index >= 0:
            self.results.append(r)
        return seed, r, counters

    def trace(self):
        self.prof = devtrace.start(self.dev.type == "cuda")

    def card(self):
        """This rank's entry of ``cards()``."""
        from fscl_tpu_torch.parallel import shard

        cuda = self.dev.type == "cuda"
        e = {"rank": self.rank,
             "card": self.dev.index if cuda else self.dev.type,
             "name": (torch.cuda.get_device_name(self.dev) if cuda
                      else self.dev.type),
             "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                 self.dev) if cuda else 0)}
        if self.prof is not None and self.rank > 0:
            events = devtrace.stop(self.prof)
            e["busy_s"] = devtrace.Trace(events, 1.0).busy_s()
        self.prof = None
        return shard.gather_objects(e, self.split)

    def finish(self):
        """Every rank's (digests of its window's passes, forbidden
        modules), in rank order; the program's state goes."""
        from fscl_tpu_torch.parallel import shard

        mine = ([digest(r) for r in self.results], forbidden_modules())
        self.results = []
        self.prog.release()
        self.prog = None
        return shard.gather_objects(mine, self.split)

    def close(self):
        from fscl_tpu_torch.parallel import close_split

        close_split(self.split)


def _env(rank, world, port):
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


class Traffic:
    def __init__(self, params, cfg, seed, device, faults=None):
        import torch.distributed as dist

        self.p, self.cfg, self.seed = params, cfg, seed
        world = int(params["ranks"])
        threads = int(os.environ.get("OMP_NUM_THREADS") or 1)
        torch.set_num_threads(threads)
        self.procs = []
        self.mismatch = None
        self.ref = None
        # rank 0 builds the kernels (where the checkout has none) before
        # a child loads them
        self.me = Rank(params, cfg, seed, device, 0)
        self.build_s = self.me.build_s
        self.dev = self.me.dev
        self.store = dist.TCPStore("127.0.0.1", 0, world, True,
                                   timeout=TIMEOUT, wait_for_workers=False)
        env = _env(0, world, self.store.port)
        spec = json.dumps({"params": params, "cfg": cfg, "seed": seed,
                           "device": device,
                           "fault": getattr(faults, "name", None)})
        for r in range(1, world):
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.traffic.permute_split",
                 spec], cwd=ROOT,
                env={**os.environ, **_env(r, world, self.store.port),
                     "OMP_NUM_THREADS": str(threads)},
                stdin=subprocess.DEVNULL, stdout=2))
            _live.append(self.procs[-1])
        self.me.lap("spawn")
        self.me.make(faults)
        self.genome = self.me.genome
        self._await_children(world)
        self.me.lap("await")
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            self.me.join(self.store, device)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v

    def _await_children(self, world):
        """Wait until every child has reached the store; a child that
        exits before raises at once."""
        deadline = time.monotonic() + TIMEOUT.total_seconds()
        keys = [f"portbench.up.{r}" for r in range(1, world)]
        while not self.store.check(keys):
            for r, p in enumerate(self.procs, 1):
                if p.poll() is not None:
                    raise RuntimeError(
                        f"permute_split: rank {r} exited with {p.returncode}"
                        " before joining")
            if time.monotonic() > deadline:
                raise RuntimeError("permute_split: ranks did not join in "
                                   f"{TIMEOUT.total_seconds():.0f} s")
            time.sleep(0.05)

    def setup(self, seconds):
        self.me.setup()
        self.active = self.me.active

    def sync(self):
        self.me.sync()

    def step(self, index):
        self.me.order(RUN, index)
        seed, r, counters = self.me.run(index)
        return Step(seed, r, float(r.permute_n[self.active].sum()), counters)

    def trace_ranks(self):
        self.me.order(TRACE)

    def cards(self):
        self.me.order(CARDS)
        return sorted(self.me.card(), key=lambda e: e["rank"])

    def release(self):
        self.me.order(STOP)
        got = self.me.finish()
        self.me.close()
        mine = got[0][0]
        self.mismatch = sum(
            sum(a != b for a, b in zip(mine, theirs))
            + abs(len(mine) - len(theirs))
            for theirs, _ in got[1:])
        bad = [f"rank {r}: {', '.join(f)}" for r, (_, f) in enumerate(got)
               if f]
        codes = [p.wait(timeout=TIMEOUT.total_seconds()) for p in self.procs]
        for p in self.procs:
            _live.remove(p)
        self.procs = []
        self.store = None
        if any(codes):
            raise RuntimeError(f"permute_split: child exit codes {codes}")
        if bad:
            raise RuntimeError("permute_split: the ranks loaded JAX or the "
                               "JAX package: " + "; ".join(bad))

    def check(self, steps, precision=None):
        if self.ref is None:
            self.ref = check.Reference(self.genome, self.cfg, self.dev)
        chk = self.p["check"]
        numbers, worst = check.check_passes(
            self.ref, steps, self.active, self.cfg["permute"],
            self.cfg["scan"], int(self.p["n_permute"]), chk["nulls"],
            chk["points"], self.seed, precision=precision)
        numbers["rank_mismatch"] = self.mismatch
        return numbers, worst


def _child(spec):
    """A child rank: join, set up, serve rank 0's orders, finish."""
    import torch.distributed as dist

    from portbench.faults import planted

    if sys.platform == "linux":  # end with rank 0, however it ends
        import ctypes
        import signal

        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    s = json.loads(spec)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    store = dist.TCPStore(os.environ["MASTER_ADDR"],
                          int(os.environ["MASTER_PORT"]), world, False,
                          timeout=TIMEOUT)
    me = Rank(s["params"], s["cfg"], s["seed"], s["device"], rank)
    store.set(f"portbench.up.{rank}", "1")
    me.join(store, s["device"])
    try:
        me.make(planted(s["fault"]) if s["fault"] else None)
        me.setup()
        while True:
            op, index = me.command()
            if op == STOP:
                break
            if op == RUN:
                me.run(index)
            elif op == TRACE:
                me.trace()
            elif op == CARDS:
                me.card()
        me.finish()
    finally:
        me.close()
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1]))
