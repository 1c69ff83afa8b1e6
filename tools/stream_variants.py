#!/usr/bin/env python3
"""Time the block-permutation stream's kernel (fscl_tpu_torch/csrc/
replicate_runs.cu) against its first version (tools/
replicate_runs_baseline.cu), with each stage of both cut off and with
the new design's levers taken out, on one Hopper card.

Variants, each in the sigma form and the runs form:

  base           the first version: one block a replicate, starts by
                 binary search over all G groups, a bitonic sort with a
                 barrier a stage, sigma by binary search a group
  base_s1, base_s2, base_s3   the same ending after the block starts,
                 after the shuffle, after the runs (FSCL_RR_STOP)
  new            the package's kernel as replicate_runs launches it, from
                 the package's own build (its plan, ops/permute.py:
                 plan_replicate_runs: the MSD radix sort in shared
                 memory, over global scratch past 8,192 blocks)
  new_nobracket  the same with the starts searched over all G groups
                 (brackets [0, G])
  new_T256, new_T512, new_T1024   other threads a block (shared memory)
  new_tiles1, new_tiles2x     one block a replicate, and twice the plan's
                 tiles (sigma form, where the plan tiles)

and from tools/replicate_runs_variants.cu (the package's source with
the alternatives beside it):

  new_s1, new_s2, new_s3      the package's work loop ending after the
                 block starts, the shuffle, the runs
  new_regs64     up to 64 registers a thread in shared memory (the
                 package caps them at 32 there, so that 2,048 threads an
                 SM fit)
  new_bitonic_E1, _E2, _E4, _E8   the bitonic sort in shared memory in
                 place of the radix sort, E words a thread in registers
                 (E = 1 puts every stride from 32 on behind a barrier, as
                 the first version's sort)
  new_cluster, new_cluster_s1, _s2, _s3   the radix sort over the
                 shared memory of a cluster of 8 blocks in place of global
                 scratch (8,192 < B <= 65,536), whole and cut

The split of the first version's time: starts (b) = s1; shuffle (c) =
s2 - s1; runs = s3 - s2; sigma (d) = whole - s3; the card's fill (a)
shows as new_tiles1 against new at 16 replicates.  Also an empty
kernel's launch-to-launch time, the floor of a launch in a graph.

Shapes (tools/stream_variants.py prefixes): "20k" (bench_20k.sf, 32
replicates), "genome1m chunk" (16 replicates: the CLI's first chunk),
"genome1m deep" (2,048), "4d" (phase 4d's 4.19M-site chromosome, 16),
"large" (genome1m's coordinates at 3e4 bp blocks: about 33,000 blocks,
256 replicates; the first version refuses it).

Timing: the kernel alone is a CUDA graph of 20 captured launches into
preallocated outputs, replayed, CUDA events around each replay: the
median of 5 readings over the launches (chip_smoke.graph_time_ms); the
wrapper (replicate_runs: checks, allocation, launch) back-to-back
between CUDA events.  At each shape base, new, new, base in turns, then
the rest.  Every whole variant is checked bit for bit against the plain
version.  The bound is chip_smoke.py's (_stream_bytes, _stream_ops).

Run from the repo root on the card:

    python3 tools/stream_variants.py [shape-prefix ...]

(no names: every shape).  Writes chiprun_out/variants/stream.json.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from fscl_tpu_torch.ops import permute as TO  # noqa: E402

OUT = REPO / "chiprun_out" / "variants"
VAR_SRC = REPO / "tools" / "replicate_runs_variants.cu"
BASE_SRC = REPO / "tools" / "replicate_runs_baseline.cu"
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int fscl_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
# library name -> (source, -D flags)
LIBS = {
    "variants": (VAR_SRC, ()),
    "base": (BASE_SRC, ()),
    "base_s1": (BASE_SRC, ("-DFSCL_RR_STOP=1",)),
    "base_s2": (BASE_SRC, ("-DFSCL_RR_STOP=2",)),
    "base_s3": (BASE_SRC, ("-DFSCL_RR_STOP=3",)),
}
BASE_BLOCKS_MAX = 16384  # the first version's cap on shuffled blocks
CLUSTER = 8  # blocks a cluster (replicate_runs_variants.cu's kCluster)
# (label, gpos key, replicates, start, seed, block width bp)
SEED = 0xFD821A6  # PermuteConfig's default
SHAPES = (("20k chunk", "20k", 32, 0, 1, 1e6),
          ("genome1m chunk", "genome1m", 16, 0, SEED, 1e6),
          ("genome1m deep tail", "genome1m", 2048, 2048, SEED, 1e6),
          ("4d chromosome chunk", "big", 16, 0, SEED, 1e6),
          ("large B", "genome1m", 256, 0, SEED, 3e4))


def build_libs(tmp):
    """nvcc every library at once; {name: (CDLL, ptxas lines)}."""
    from fscl_tpu_torch import kernels

    nvcc = kernels._nvcc()
    empty = pathlib.Path(tmp) / "empty.cu"
    empty.write_text(EMPTY_SRC)
    libs = dict(LIBS, empty=(empty, ()))
    cmds, paths = [], {}
    for name, (src, defs) in libs.items():
        paths[name] = pathlib.Path(tmp) / f"lib{name}.so"
        cmds.append([nvcc, *kernels.NVCC_FLAGS, *defs, "-shared",
                     "-o", str(paths[name]), str(src)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    out = {}
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    f32, u32 = ctypes.c_float, ctypes.c_uint
    for name, c, p in zip(libs, cmds, procs):
        log, _ = p.communicate()
        if p.returncode != 0:
            cs.fail(f"nvcc failed for {name}: {' '.join(c)}\n{log}")
        lib = ctypes.CDLL(str(paths[name]))
        if name == "empty":
            lib.fscl_empty.argtypes = [vp]
            lib.fscl_empty.restype = i
        elif name.startswith("base"):
            lib.fscl_replicate_runs.argtypes = [vp, i, i, i, f32, f32, u32,
                                                u32, u32, i, vp, vp, vp, vp,
                                                vp]
            lib.fscl_replicate_runs.restype = i
        else:
            lib.fscl_rr_variant.argtypes = [
                vp, vp, vp, i, i, i, f32, f32, u32, u32, u32, i, i, i, i, i,
                i, vp, i64, vp, vp, vp, vp, vp, i, i, i, i]
            lib.fscl_rr_variant.restype = i
            lib.fscl_rr_cluster_bytes.argtypes = [i]
            lib.fscl_rr_cluster_bytes.restype = i64
        out[name] = (lib, ptxas_report(log))
    return out


def ptxas_report(log):
    """[(kernel, registers, spill store bytes, spill load bytes)] of an
    nvcc -Xptxas -v log."""
    out, cur, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.append((cur, int(m.group(1)), *spill))
            cur, spill = None, (0, 0)
    return out


def gpos_sets(wanted):
    from fscl_tpu_torch.io import load_snp_input

    keys = {k for label, k, *_ in SHAPES
            if not wanted or any(label.startswith(w) for w in wanted)}
    out = {}
    if "20k" in keys:
        out["20k"] = load_snp_input(
            str(REPO / "bench" / "data" / "bench_20k.sf")).genome_pos()
    if "genome1m" in keys:
        out["genome1m"] = cs.genome_data().genome_pos()
    if "big" in keys:
        out["big"] = cs.big_chromosome_data()[0].genome_pos()
    return out


def with_tiles(plan, n, G, nb, tiles):
    """A shared-memory plan with its sigma row in `tiles` tiles."""
    tile_len = -(-G // tiles)
    tile_len += -tile_len % 4
    tiles = -(-G // tile_len)
    smem = TO.replicate_runs_bytes(plan.P, nb, (tile_len >> plan.shift) + 2)
    return dataclasses.replace(plan, tiles=tiles, tile_len=tile_len,
                               grid=n * tiles, smem_bytes=smem)


def bitonic_plan(plan, n, nb, E):
    """The package's plan with the bitonic sort at E words a thread (P
    at least 32 E, threads at least P / E), or None where it does not
    fit a block's shared memory or threads."""
    P = max(plan.P, 32 * E)
    smem = TO.replicate_runs_bytes(P, nb, (plan.tile_len >> plan.shift) + 2)
    if plan.on_global or P // E > 1024 or smem > TO.SMEM_MAX:
        return None
    return dataclasses.replace(plan, P=P, threads=max(P // E, plan.threads),
                               smem_bytes=smem)


def cluster_plan(lib, plan, n, G, nb, n_sm):
    """A replicate a cluster of CLUSTER blocks, tile q of each sigma row
    on block q, or None where the radix sort's arrays do not fit the
    cluster's shared memory or B <= 8,192 (shared memory serves)."""
    if not plan.on_global:
        return None
    tile_len = -(-G // CLUSTER)
    tile_len += -tile_len % 4
    smem = 16 * (plan.P // CLUSTER) + 4 * ((tile_len >> plan.shift) + 2)
    if smem > TO.SMEM_MAX:
        return None
    slot = lib.fscl_rr_cluster_bytes(nb)
    grid = max(1, min(n, TO.BLOCKS_PER_SM * n_sm // CLUSTER,
                      TO.SCRATCH_MAX // slot))
    return dataclasses.replace(plan, tiles=-(-G // tile_len),
                               tile_len=tile_len, grid=grid,
                               slot_bytes=slot, smem_bytes=smem)


def run_shape(label, gpos, n, start, seed, width, libs, n_sm):
    """Every variant at one shape, both forms: times, checks, record."""
    import numpy as np
    import torch

    from fscl_tpu_torch import kernels

    dev = torch.device("cuda")
    g0f, span = TO._g0_device(gpos, dev)
    nb = TO.n_blocks_for(span, width)
    w = TO.effective_block_width(span, width)
    G, B = g0f.shape[0], nb - 1
    lo, hi = TO._brackets(g0f, nb, w)
    lo0 = torch.zeros_like(lo)
    hi0 = torch.full_like(hi, G)
    redraws = cs._stream_redraws(seed, start, n, B)
    rounds = TO.shuffle_rounds(B)
    k0, k1 = TO.seed_key(seed)
    w32 = np.float32(w)
    inv = np.float32(1) / w32
    kw = dict(dtype=torch.int32, device=dev)
    pkg = kernels.load()
    var = libs["variants"][0]
    out = []
    for form in ("sigma", "runs"):
        sigma_on = form == "sigma"
        runs = tuple(torch.empty((n, nb), **kw) for _ in range(3))
        sig = torch.empty((n, G), **kw) if sigma_on else None
        src, dst, sz, want = TO.replicate_runs_plain(
            seed, start, g0f, nb, w, n, with_sigma=sigma_on)
        plan = TO.plan_replicate_runs(n, G, nb, sigma_on, n_sm)
        fns, plans = {}, {}

        # the sigma form writes the sigma alone (a cut variant one value a
        # replicate, into the sigma row)
        outs = None if sigma_on else runs

        def scratch_for(pl):
            return (torch.empty(pl.grid * pl.slot_bytes, dtype=torch.uint8,
                                device=dev) if pl.slot_bytes else None)

        def new_fn(pl, lo_=lo, hi_=hi):  # the package's build
            scratch = scratch_for(pl)

            def f():
                rc = TO.launch_replicate_runs(
                    pkg, pl, seed, start, g0f, lo_, hi_, nb, w, n,
                    outs, sig, scratch)
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")
            return f

        def var_fn(pl, stop=0, E=0, cluster=False, min_blocks=2):
            scratch = scratch_for(pl)

            def f():  # (holds scratch, so that it lives as long as f)
                ptr = [t.data_ptr() if t is not None else None
                       for t in (*(outs or (None,) * 3), sig, scratch)]
                rc = var.fscl_rr_variant(
                    g0f.data_ptr(), lo.data_ptr(), hi.data_ptr(), G, nb,
                    rounds, float(w32), float(inv), k0, k1,
                    start & 0xFFFFFFFF, n, pl.threads, pl.tiles,
                    pl.tile_len, pl.shift, pl.grid, ptr[4], pl.slot_bytes,
                    *ptr[:4], torch.cuda.current_stream().cuda_stream,
                    stop, E, int(cluster), min_blocks)
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")
            return f

        def base_fn(lib):  # the width rounded as the wrapper rounds it
            def f():
                rc = lib.fscl_replicate_runs(
                    g0f.data_ptr(), G, nb, rounds, float(w32), float(inv),
                    k0, k1, start & 0xFFFFFFFF, n,
                    *((t.data_ptr() for t in outs) if outs
                      else (None,) * 3),
                    sig.data_ptr() if sigma_on else None,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc}")
            return f

        if B <= BASE_BLOCKS_MAX:
            for v in ("base", "base_s1", "base_s2", "base_s3"):
                fns[v] = base_fn(libs[v][0])
        fns["new"], plans["new"] = new_fn(plan), plan
        for stop in (1, 2, 3):
            fns[f"new_s{stop}"] = var_fn(plan, stop=stop)
            plans[f"new_s{stop}"] = plan
        fns["new_nobracket"] = new_fn(plan, lo0, hi0)
        plans["new_nobracket"] = plan
        if not plan.on_global:
            fns["new_regs64"] = var_fn(plan, min_blocks=1)
            plans["new_regs64"] = plan
            for t in (256, 512, 1024):  # other threads a block
                if t != plan.threads:
                    pt = dataclasses.replace(plan, threads=t)
                    fns[f"new_T{t}"], plans[f"new_T{t}"] = new_fn(pt), pt
        if sigma_on and plan.tiles > 1:
            for name, t in (("new_tiles1", 1), ("new_tiles2x",
                                                2 * plan.tiles)):
                pt = with_tiles(plan, n, G, nb, t)
                fns[name], plans[name] = new_fn(pt), pt
        for E in (1, 2, 4, 8):  # the bitonic sort in shared memory
            pe = bitonic_plan(plan, n, nb, E)
            if pe is not None:
                fns[f"new_bitonic_E{E}"] = var_fn(pe, E=E)
                plans[f"new_bitonic_E{E}"] = pe
        pc = cluster_plan(var, plan, n, G, nb, n_sm)
        if pc is not None:  # the same sort over a cluster's shared memory
            for stop, v in enumerate(("", "_s1", "_s2", "_s3")):
                fns[f"new_cluster{v}"] = var_fn(pc, stop=stop, cluster=True)
                plans[f"new_cluster{v}"] = pc

        def result():
            return sig.clone() if sigma_on else torch.cat(runs, 1)

        ref = want if sigma_on else torch.cat((src, dst, sz), 1)
        checks = {}
        for v, f in fns.items():
            if "_s" in v:
                continue
            for t in (*runs, *([sig] if sigma_on else [])):
                t.fill_(-7)
            f()
            torch.cuda.synchronize()
            got = result()
            ok = torch.equal(got, ref)
            f()
            torch.cuda.synchronize()
            ok = ok and torch.equal(result(), ref)
            checks[v] = "bitwise, twice" if ok else "DIFFERS"
            if not ok:
                cs.fail(f"{label} ({form}): variant {v} differs from the "
                        "plain version")

        def wrapper():
            TO.replicate_runs(seed, start, g0f, nb, w, n,
                              with_runs=not sigma_on, with_sigma=sigma_on)

        times = {}
        order = (["base", "new", "new", "base"] if "base" in fns
                 else ["new", "new"])
        for v in order:
            times.setdefault(v, []).append(cs.graph_time_ms(fns[v]))
        for v in fns:
            if v not in times:
                times[v] = [cs.graph_time_ms(fns[v])]
        wrapper_ms = cs.cuda_time_ms(wrapper, 20)
        t0 = time.monotonic()
        for _ in range(5):
            wrapper()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) / 5 * 1e3
        b_ms, b_by = cs.bound_ms(
            cs._stream_bytes(G, nb, [ref]),
            cs._stream_ops(n, G, nb, redraws, sigma_on))
        best = {v: min(t) for v, t in times.items()}
        split = {}
        for pre in ("base", "new", "new_cluster"):
            if pre in best:
                s1, s2, s3, whole = (best[f"{pre}_s1"], best[f"{pre}_s2"],
                                     best[f"{pre}_s3"], best[pre])
                split[pre] = dict(starts=s1, shuffle=s2 - s1, runs=s3 - s2,
                                  sigma=whole - s3 if sigma_on else None)
        cs.log(f"[variants] {label} ({form}): R={n} G={G} nb={nb} "
               f"rounds={rounds} redraws={redraws}; plan "
               f"{dataclasses.asdict(plan)}; bound {b_ms:.5f} ms ({b_by}); "
               f"wrapper {wrapper_ms:.4f} ms (events), {wall_ms:.4f} ms "
               "(host wall to a sync)")
        for v, t in times.items():
            cs.log(f"  {v:16s} " + " / ".join(f"{x:.5f}" for x in t)
                   + f" ms, {100 * b_ms / min(t):.1f}% of bound"
                   + (f"; {checks[v]}" if v in checks else ""))
        for pre, sp in split.items():
            cs.log(f"  split {pre}: " + ", ".join(
                f"{k} {v:.5f}" for k, v in sp.items() if v is not None))
        out.append(dict(label=f"{label} ({form})", replicates=n, groups=G,
                        blocks=nb, rounds=rounds, redraws=redraws,
                        plan=dataclasses.asdict(plan),
                        plans={v: dataclasses.asdict(p)
                               for v, p in plans.items()},
                        bound_ms=b_ms, bound_by=b_by, ms=times,
                        wrapper_ms=wrapper_ms, wrapper_wall_ms=wall_ms,
                        split=split, checks=checks,
                        base="refused (B > 16,384)" if "base" not in fns
                        else "timed"))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    cs.log(smi.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    from fscl_tpu_torch import kernels

    kernels.load()  # the package's build, for the wrapper
    wanted = sys.argv[1:]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        libs = build_libs(tmp)
        cs.log(f"built {len(libs)} libraries in {time.monotonic() - t0:.1f}s")
        report = {n: r for n, (_, r) in libs.items()}
        for name in ("variants", "base"):
            for k, regs, st, ld in report[name]:
                cs.log(f"ptxas {name}: {k}: {regs} registers, spill "
                       f"stores {st} B, loads {ld} B")
        empty = libs["empty"][0]
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa
        empty_ms = cs.graph_time_ms(lambda: empty.fscl_empty(stream()))
        cs.log(f"[variants] empty kernel: {empty_ms * 1e3:.3f} us a launch "
               "(graph of launches, launch to launch)")
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        gpos = gpos_sets(wanted)
        results = []
        for label, key, n, start, seed, width in SHAPES:
            if wanted and not any(label.startswith(x) for x in wanted):
                continue
            results += run_shape(label, gpos[key], n, start, seed, width,
                                 libs, n_sm)
            torch.cuda.empty_cache()
    (OUT / "stream.json").write_text(json.dumps(dict(
        nvidia_smi=smi.strip(), empty_kernel_ms=empty_ms,
        ptxas={n: report[n] for n in ("variants", "base")},
        shapes=results),
        indent=1) + "\n")
    cs.log(smi.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
