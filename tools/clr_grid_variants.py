#!/usr/bin/env python3
"""Time the clr_grid kernel (fscl_tpu_torch/csrc/clr_grid.cu) against its
first, simple version (tools/clr_grid_baseline.cu) and with each of its
levers taken out, on one Hopper card.

Variants (csrc/clr_grid.cu's note: (a) site slices of 1,024 sites, 32
streams a slice, 32 warps a block; (c) the sites staged in shared
memory; (g) the alpha loop cut short on ascending alphas):

  baseline   tools/clr_grid_baseline.cu (PR 12): lanes are 32 candidates,
             8 warps split the group's windows, one block a group
  new        the package's kernel
  w8, w16    8 or 16 warps a block (4 or 2 streams a warp, in turn)
  no_a       (a) out: slices of 2^20 sites, one block a group (and tile);
             (c) out with it (a slice is what is staged)
  no_g       (g) out: every alpha of a pair tested
  no_c       (c) out: pos, row and null read from global memory
  t512, t2048   other slice widths

Shapes: chip_smoke.py phase 3i's (the 20k task's dense grid, coarse and
fine alphas; the 20k scan's reported points at their reported lalpha,
the C-parity oracle's call; genome1m's reported points, coarse alphas)
and __graft_entry__.py's flagship problem (coarse and fine alphas),
built as phase 3i builds them.

At each shape: baseline, new, new, baseline in turns, then every other
variant, each timed with CUDA events (chip_smoke.cuda_time_ms: the median
of 5 readings, each the mean over enough calls for ~50 ms, at least 1).
A call is launch_clr_grid (the scratch and the two launches; the slice
plan computed once beforehand) or the baseline's one
launch.  Checks: w8, w16, no_c and no_g give the new kernel's
bits (the sum order depends on the slice width alone); the baseline,
no_a and the other widths within 1e-5 S + 1e-4 of the plain version (on
64 candidates at the dense and genome1m shapes).
The bound is phase 3i's (the work these inputs need), PR 12's beside it.
ptxas registers and spills of every kernel are printed.

Run from the repo root on the card:

    python3 tools/clr_grid_variants.py [shape-prefix ...]

(no names: every shape).  Writes chiprun_out/variants/clr_grid.json.
"""

from __future__ import annotations

import ctypes
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

OUT = REPO / "chiprun_out" / "variants"
SRC = REPO / "fscl_tpu_torch" / "csrc" / "clr_grid.cu"
BASE_SRC = REPO / "tools" / "clr_grid_baseline.cu"
# variant -> (source, -D flags, same bits as "new")
LIBS = {
    "new": (SRC, (), True),
    "baseline": (BASE_SRC, (), False),
    "w8": (SRC, ("-DFSCL_CLR_GRID_WARPS=8",), True),
    "w16": (SRC, ("-DFSCL_CLR_GRID_WARPS=16",), True),
    "no_a": (SRC, ("-DFSCL_CLR_GRID_SLICE=1048576",
                   "-DFSCL_CLR_GRID_STAGED=0"), False),
    "no_g": (SRC, ("-DFSCL_CLR_GRID_ASCENDING=0",), True),
    "no_c": (SRC, ("-DFSCL_CLR_GRID_STAGED=0",), True),
    "t512": (SRC, ("-DFSCL_CLR_GRID_SLICE=512",), False),
    "t2048": (SRC, ("-DFSCL_CLR_GRID_SLICE=2048",), False),
}
TARGET_MS = 50.0  # calls a reading: enough for this long
BASE_CANDS = 32  # the baseline's candidates a warp


def build_libs(tmp):
    """nvcc every library of LIBS at once; {name: (CDLL, ptxas lines)}."""
    from fscl_tpu_torch import kernels

    nvcc = kernels._nvcc()
    cmds, paths = [], {}
    for name, (src, defs, _) in LIBS.items():
        paths[name] = pathlib.Path(tmp) / f"lib{name}.so"
        cmds.append([nvcc, *kernels.NVCC_FLAGS, *defs, "-shared",
                     "-o", str(paths[name]), str(src)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    libs = {}
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, c, p in zip(LIBS, cmds, procs):
        log, _ = p.communicate()
        if p.returncode != 0:
            cs.fail(f"nvcc failed for {name}: {' '.join(c)}\n{log}")
        lib = ctypes.CDLL(str(paths[name]))
        if name == "baseline":
            lib.fscl_clr_grid.argtypes = [vp] * 9 + [
                i, i, i, i, ctypes.c_float, i, vp]
        else:
            lib.fscl_clr_grid.argtypes = [vp] * 10 + [
                i, i, i, i, ctypes.c_float, i, vp]
            for f in (lib.fscl_clr_grid_slice_sites,
                      lib.fscl_clr_grid_group):
                f.argtypes, f.restype = [], i
        lib.fscl_clr_grid.restype = i
        libs[name] = (lib, ptxas_report(log))
    return libs


def ptxas_report(log):
    """[(kernel, registers, spill store bytes, spill load bytes)] of the
    clr_grid kernels in an nvcc -Xptxas -v log."""
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
        if m and cur and "clr_grid" in cur:
            out.append((kernel_name(cur), int(m.group(1)), *spill))
            cur, spill = None, (0, 0)
    return out


def kernel_name(mangled):
    """clr_grid_partials<TA>, clr_grid_reduce or clr_grid_kernel."""
    m = re.search(r"(clr_grid_(?:partials|reduce|kernel))(?:ILi(\d+)E)?",
                  mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)


def build_shapes(dev, wanted):
    """[(label, args, la, paired, G, check_cands or None)] at phase 3i's
    shapes and the flagship problem, their alphas as phase 3i gives them
    (the fine alphas around the new kernel's coarse winners)."""
    import numpy as np
    import torch

    from fscl_tpu_torch import kernels
    from fscl_tpu_torch.convert import clr_inputs_from_numpy
    from fscl_tpu_torch.engine import scan_genome
    from fscl_tpu_torch.engine.scan import ScanConfig, chromosome_candidates
    from fscl_tpu_torch.ops import clr as TC
    from fscl_tpu_torch.ops.windows import candidate_windows

    def want(label):  # a shape's label, or the tag of a group of shapes
        return not wanted or any(label.startswith(w) or w.startswith(label)
                                 for w in wanted)

    lib = kernels.load()
    coarse = torch.as_tensor(TC.coarse_alpha_grid(), device=dev)

    def fine(args, G):
        c = TC.launch_clr_grid(lib, *args, coarse, G, False)
        return TC.fine_alpha_grids(coarse[torch.argmax(c, dim=1)])

    def spread(n):
        return torch.as_tensor(np.linspace(0, n - 1, 64).astype(np.int64),
                               device=dev)

    shapes = []
    if want("20k"):
        data, tables, cfg = cs._task_20k()
        G = tables.grid_points
        result = scan_genome(data, tables, cfg, device=dev)
        site = clr_inputs_from_numpy(tables.table, data.row, data.pos,
                                     data.null_logl, device=dev)
        cand = chromosome_candidates(data.chr_limits[0], cfg)[0].reshape(-1)
        _, lo, hi = candidate_windows(np.asarray(data.pos), cand,
                                      cfg.eval_range)
        dense = (*site, *(torch.as_tensor(np.asarray(x, np.int32),
                                          device=dev)
                          for x in (cand, lo, hi)))
        chk = spread(len(cand))
        shapes.append(("20k dense coarse", dense, coarse, False, G, chk))
        shapes.append(("20k dense fine", dense, fine(dense, G), True, G,
                       chk))
        pts = cs._point_args(data, tables, result, cfg.eval_range, dev)
        la = torch.as_tensor(result.lalpha.astype(np.float32)[:, None],
                             device=dev)
        shapes.append(("20k reported points (oracle)", pts, la, True, G,
                       None))
    if want("genome1m"):
        data = cs.genome_data()
        tables = cs._load_model(data, compat=False)
        result = scan_genome(data, tables, ScanConfig(), device=dev)
        pts = cs._point_args(data, tables, result, ScanConfig().eval_range,
                             dev)
        shapes.append(("genome1m reported points, coarse", pts, coarse,
                       False, tables.grid_points, spread(result.n_points)))
    if want("flagship"):
        flag, G = cs._flagship_args(dev)
        shapes.append(("flagship coarse", flag, coarse, False, G, None))
        shapes.append(("flagship fine", flag, fine(flag, G), True, G, None))
    torch.cuda.synchronize()
    return [s for s in shapes
            if not wanted or any(s[0].startswith(w) for w in wanted)]


def run_shape(label, args, la, paired, G, chk, libs):
    """Every variant at one shape: checks, times, the record."""
    import torch

    from fscl_tpu_torch.ops import clr as TC
    from fscl_tpu_torch.ops.lattice import lattice_inv_step

    dev = args[0].device
    P, A = args[4].shape[0], la.shape[-1]

    def caller(name):
        lib = libs[name][0]
        if name == "baseline":
            def call():
                out = torch.empty((P, A), dtype=torch.float32, device=dev)
                rc = lib.fscl_clr_grid(
                    *(t.data_ptr() for t in args), la.data_ptr(),
                    out.data_ptr(), P, A, int(paired), G,
                    lattice_inv_step(G), BASE_CANDS,
                    torch.cuda.current_stream(dev).cuda_stream)
                if rc:
                    cs.fail(f"baseline kernel: CUDA error {rc}")
                return out
            return call
        plan = TC.clr_grid_plan(
            args[5].cpu().numpy(), args[6].cpu().numpy(),
            lib.fscl_clr_grid_group(), lib.fscl_clr_grid_slice_sites())
        return lambda: TC.launch_clr_grid(lib, *args, la, G, paired, plan)

    fns = {name: caller(name) for name in LIBS}
    ref = fns["new"]()
    if chk is None:
        chk = torch.arange(P, device=dev)
    sub, la_sub = cs._cg_sub(args, la, paired, chk)
    want = TC.clr_grid_plain(*sub, la_sub, grid_points=G,
                             paired_alpha=paired)
    lim = cs.CG_REL * cs._cg_scale(sub, la_sub, paired, G) + cs.CG_ABS
    checks = {}
    for name, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        if LIBS[name][2]:
            ok = torch.equal(got.view(torch.int32), ref.view(torch.int32))
            checks[name] = "bitwise" if ok else "DIFFERS"
        else:
            err = float(((got[chk] - want).abs().double() / lim).max())
            ok = err <= 1.0
            checks[name] = (f"{err:.3g} x tolerance vs plain on "
                            f"{chk.numel()} candidates")
        if not ok:
            cs.fail(f"{label}: variant {name}: {checks[name]}")
        cs.log(f"  checked {name}: {checks[name]}")
        del got
    del want, lim, ref

    single = {}
    for name in ("baseline", "new"):
        t = time.monotonic()
        fns[name]()
        torch.cuda.synchronize()
        single[name] = (time.monotonic() - t) * 1e3

    def timed(name):
        iters = max(1, int(TARGET_MS / max(single.get(name, single["new"]),
                                           1e-3)))
        t = cs.cuda_time_ms(fns[name], iters)
        cs.log(f"  timed {name}: {t:.4f} ms ({iters} calls a reading)")
        return t

    turns = [timed(n) for n in ("baseline", "new", "new", "baseline")]
    times = {"baseline": [turns[0], turns[3]], "new": [turns[1], turns[2]]}
    for name in fns:
        if name not in times:
            times[name] = [timed(name)]
    work = cs._cg_terms(args, la, paired)
    out = torch.empty((P, A), device=dev)
    b_ms, b_by = cs.bound([*args, la], [out], work["ops"])
    old_ms, _ = cs.bound([*args, la], [out], work["ops_old"])
    cs.log(f"[variants] {label}: P={P} A={A} "
           f"{'paired' if paired else 'shared'} G={G} W={args[1].shape[0]}, "
           f"{work['pairs']} pairs, {work['reached']} reached, "
           f"{work['inside']} of {work['terms']} terms inside, "
           f"{work['masked']} outside tested; bound {b_ms:.4f} ms ({b_by}), "
           f"PR 12's {old_ms:.4f}")
    for name, t in times.items():
        cs.log(f"  {name:9s} " + " / ".join(f"{x:.4f}" for x in t)
               + f" ms, {100 * b_ms / min(t):.1f}% of bound "
               f"({100 * old_ms / min(t):.1f}% of PR 12's); {checks[name]}")
    return dict(label=label, P=P, A=A, paired=paired, G=G,
                W=args[1].shape[0], pairs=work["pairs"],
                pairs_reached=work["reached"], terms=work["terms"],
                terms_inside=work["inside"],
                terms_masked_tested=work["masked"], bound_ms=b_ms,
                bound_by=b_by, old_bound_ms=old_ms, ms=times,
                checks=checks)


def main():
    import torch

    from fscl_tpu_torch import kernels

    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    cs.log(smi.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    kernels.load()  # the package's own build, for the scans
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        libs = build_libs(tmp)
        cs.log(f"built {len(libs)} variant libraries in "
               f"{time.monotonic() - t0:.1f}s")
        report = {n: r for n, (_, r) in libs.items()}
        for name, rows in report.items():
            for k, regs, st, ld in rows:
                cs.log(f"ptxas {name}: {k}: {regs} registers, spill "
                       f"stores {st} B, loads {ld} B")
        results = []
        for shape in build_shapes(dev, sys.argv[1:]):
            results.append(run_shape(*shape, libs))
            torch.cuda.empty_cache()
    (OUT / "clr_grid.json").write_text(json.dumps(dict(
        nvidia_smi=smi.strip(), ptxas=report, shapes=results), indent=1)
        + "\n")
    cs.log(smi.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
