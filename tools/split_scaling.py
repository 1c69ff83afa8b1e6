#!/usr/bin/env python3
"""The split over ranks on a host of several cards: genome1m (chip_smoke
phase 5's sites, written to a SNP file) with 64 permutations through the
CLI under torch.distributed.run at each rank count given, rank r on card
r (--device cuda), one OpenMP thread a rank.  Each run's TSV and
nulldist must equal the first run's byte for byte; each rank's phase
walls (load, tables, scan, permute, output, gather), split_gather_s,
split_gather_bytes and kernel launches are printed (its [split] line)
and written to chiprun_out/smoke/split_scaling.json.

Run from the repo root on a host with as many cards as the largest
count: python3 tools/split_scaling.py [ranks ...]   (default: 1 2 4)
"""

from __future__ import annotations

import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def main(argv):
    ranks = [int(a) for a in argv] or [1, 2, 4]
    import torch

    if torch.cuda.device_count() < max(ranks):
        cs.fail(f"{torch.cuda.device_count()} CUDA device(s) for "
                f"{max(ranks)} ranks")
    _, name, smi = cs.phase_device()
    cs.OUT.mkdir(parents=True, exist_ok=True)
    cs.phase_build()
    cs.SPLIT_WORK.mkdir(parents=True, exist_ok=True)
    cs._write_sf(cs.SPLIT_WORK / "genome1m.sf", (cs.genome_data(),))
    runs = []
    for n in ranks:
        wall, reps = cs._split_cli(f"scaling_{n}", n, [
            "-f", "genome1m.sf", "-p", "64", "--device", "cuda", "-o",
            f"scaling_{n}.tsv"])
        first = cs.SPLIT_WORK / f"scaling_{ranks[0]}.tsv"
        for s in ("", "-nulldist"):
            if (cs.SPLIT_WORK / f"scaling_{n}.tsv{s}").read_bytes() != \
                    pathlib.Path(f"{first}{s}").read_bytes():
                cs.fail(f"{n} ranks: {s or 'TSV'} differs from "
                        f"{ranks[0]} rank(s)'")
        runs.append(dict(ranks=n, process_wall_s=wall, reports=reps))
        for r in reps:
            cs.log(f"[scaling] {n} ranks, rank {r['rank']} on {r['device']}:"
                   f" phases {json.dumps(r['phases'])}, split_gather_s "
                   f"{r['split_gather_s']:.4f}, split_gather_bytes "
                   f"{r['split_gather_bytes']}")
        cs.log(f"[scaling] {n} ranks: process wall {wall:.3f}s, results "
               f"byte for byte those of {ranks[0]} rank(s)")
    (cs.OUT / "split_scaling.json").write_text(json.dumps(
        dict(device=name, nvidia_smi=smi, runs=runs), indent=1) + "\n")
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
