#!/usr/bin/env python3
"""Readings for a cell's limits: on each seed, one run of the cell at its
own size with a short window, and the check's numbers twice: for the
program, and for the control, the reference put in the program's place
at the cell's control precision (the workload file's "control": fp8 for
the bf16 permutation statistic, tf32 for the float32 scans).  With
--fault, the program runs with that fault of faults.py planted under its
timed path, and only its numbers are read.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--fault <name>] [--out <file.jsonl>]

One JSON line a seed (seed, correct, every number the check read for
the program, the control's); every seed runs in this one process, so
the CUDA start-up and the kernel build are paid once.  The limits in
workloads/<cell>.json lie between the largest program reading and the
smallest reading of the control or of a fault (PERF.md gives both).
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from portbench.faults import FAULTS, planted  # noqa: E402
from portbench.harness import run_cell  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    out = open(a.out, "a") if a.out else None
    try:
        for seed in a.seeds:
            args = argparse.Namespace(workload=a.workload, seed=seed,
                                      seconds=a.seconds, trace=0)
            code, res = run_cell(
                args, time.monotonic(), control=not a.fault,
                faults=planted(a.fault) if a.fault else None)
            if res is None:
                return code
            line = json.dumps({
                "workload": a.workload, "seed": seed, "fault": a.fault,
                "correct": res["correct"], "program": res["readings"],
                "control": res.get("control"), "worst": res["worst"],
                "metrics": res["metrics"], "device": res["device"]})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
