#!/usr/bin/env python3
"""Time the block-permutation draw of one checkout of the port on the card.

    python3 tools/stream_draw_timing.py [--root DIR] [--label NAME]

Imports ``fscl_tpu_torch`` from DIR (default: this checkout), so a copy of
another commit unpacked under a gitignored directory of the repo (``git
archive``) is timed the same way; run the copies in turns in one call to
compare them on one card.  At three shapes of the main path: the 20k
task's chunk (bench/data/bench_20k.sf, 32 replicates), genome1m's
deep-tail chunk (22 x 45.5 Mb simulated in memory, as chip_smoke.py's
genome_data, 2,048 replicates) and phase 4d's chromosome (4.19M sites,
16 replicates), it times block_permutation_groups (the sigma) and
block_permutation_runs (the runs) on cuda, host-clocked from the call to
a torch.cuda.synchronize(), the median of five after one warm-up call,
and prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]


def _gpos_sets(root):
    import numpy as np

    from fscl_tpu_torch.data import build_snp_data
    from fscl_tpu_torch.io import load_snp_input
    from fscl_tpu_torch.sim import simulate_dataset

    def sims(specs):
        chrs, pos, fr = [], [], []
        for c, kw in enumerate(specs):
            sim = simulate_dataset(sample_size=50, alpha=3e-5, n_sweeps=1,
                                   **kw)
            keep = sim["freq"] >= 2
            chrs += [str(c + 1)] * int(keep.sum())
            pos.append(sim["pos"][keep])
            fr.append(sim["freq"][keep])
        pos, fr = np.concatenate(pos), np.concatenate(fr)
        return build_snp_data(chrs, pos, fr, np.full(len(pos), 50),
                              np.zeros(len(pos), bool)).genome_pos()

    return {
        "20k": load_snp_input(
            str(root / "bench" / "data" / "bench_20k.sf")).genome_pos(),
        "genome1m": sims([dict(seed=200 + c, snp_density=1.0,
                               mb_length=45.5) for c in range(22)]),
        "4d": sims([dict(seed=300, snp_density=45.0, mb_length=120.0)]),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("stream_draw_timing: no CUDA card", file=sys.stderr)
        return 1
    from fscl_tpu_torch.ops import permute as P

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    gpos = _gpos_sets(root)
    shapes = [("20k chunk", "20k", 32, 0), ("genome1m chunk", "genome1m",
                                              2048, 2048),
              ("4d chromosome chunk", "4d", 16, 0)]
    rows = []
    for label, key, n, start in shapes:
        g = gpos[key]
        row = dict(shape=label, sites=len(g), replicates=n)
        for form, fn in (("sigma", P.block_permutation_groups),
                         ("runs", P.block_permutation_runs)):
            fn(1, g, 1e6, n, start=start, device="cuda")
            torch.cuda.synchronize()
            walls = []
            for i in range(5):
                t0 = time.monotonic()
                fn(1, g, 1e6, n, start=start + (i + 1) * n, device="cuda")
                torch.cuda.synchronize()
                walls.append(time.monotonic() - t0)
            row[f"{form}_ms"] = statistics.median(walls) * 1e3
            row[f"{form}_ms_all"] = [w * 1e3 for w in walls]
        rows.append(row)
        print(f"[draw] {args.label}: {label} ({len(g)} sites, {n} "
              f"replicates): sigma {row['sigma_ms']:.3f} ms, runs "
              f"{row['runs_ms']:.3f} ms", flush=True)
    print(json.dumps({"stream_draw": args.label, "root": str(root),
                      "device": smi, "shapes": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
