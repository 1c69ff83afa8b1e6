#!/usr/bin/env python3
"""Time the lattice CLR kernel (fscl_tpu_torch/csrc/lattice_clr.cu)
against its first, simple version (tools/lattice_clr_baseline.cu) and
with its levers taken out, on one Hopper card.

Variants (the kernel's design levers: (a) whole pack rows read by lane
groups, (b) each (candidate, site) pair's values staged once in shared
memory, (c) C neighbouring candidates a block sharing each site):

  baseline   tools/lattice_clr_baseline.cu: a block of 128 threads per
             (replicate, candidate), each thread a site and its whole row
  a          (a) only: every lane computes its pair's values itself
             (built with FSCL_LATTICE_STAGED=0), one candidate a block
  ab         (a) + (b), one candidate a block
  abc4, abc8, abc16   (a) + (b) + (c) at C = 4, 8, 16
  auto       the package's kernel as clr_lattice launches it (C from
             ops/lattice.py block_candidates)
  row16_1, row16_4, row16_8, row16_16, row16_auto   coarse shapes only:
             the coarse pack padded to 16 offsets, not 12 (built with
             FSCL_LATTICE_COARSE_ROW=16)

Shapes: the 20k task's --no-hist scan (its dense coarse, fine and ultra
calls) and first permutation chunk (32 replicates: coarse and fine), its
grid-1024 tie stage (coarse, fine, ultra), and the dense coarse, fine and
ultra calls and first permutation chunk (16 replicates: coarse and fine)
of the 4.19M-site chromosome of chip_smoke.py phase 4d (CLI defaults:
windows of 163,841 sites, candidates 1 kb apart), each captured from the
call the path makes.

At each shape: baseline, auto, auto, baseline in turns, then every other
variant, each timed with CUDA events (chip_smoke.cuda_time_ms: the median
of 5 readings, each the mean over enough launches for ~50 ms, at least
1; 3 readings at the big chromosome), with SM clocks a pair (time x SMs
x 1.98 GHz over the pairs).  Checks: every variant of the package's row
width gives the package kernel's bits (the sum order depends on neither C
nor lever (b)); the baseline and the row-16 variants within 1e-5 S + 1e-4
of the plain version (on 64 candidates at the big chromosome, where the
plain version of the whole call would take minutes).  ptxas registers
and spills of every kernel are printed.

Run from the repo root on the card:

    python3 tools/lattice_variants.py [shape-prefix ...]

(no names: every shape).  Writes chiprun_out/variants/lattice.json.
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
SRC = REPO / "fscl_tpu_torch" / "csrc" / "lattice_clr.cu"
BASE_SRC = REPO / "tools" / "lattice_clr_baseline.cu"
# library name -> (source, -D flags); FSCL_LATTICE_VARIANTS adds C = 8
# and 16 to the package's C = 1 and 4
VARIANT_C = "-DFSCL_LATTICE_VARIANTS"
LIBS = {
    "pkg": (SRC, (VARIANT_C,)),
    "baseline": (BASE_SRC, ()),
    "unstaged": (SRC, (VARIANT_C, "-DFSCL_LATTICE_STAGED=0")),
    "row16": (SRC, (VARIANT_C, "-DFSCL_LATTICE_COARSE_ROW=16")),
}
# variant -> (library, candidates a block or None for block_candidates,
# the shapes it runs at: None every shape, else the offset count A)
VARIANTS = {
    "a": ("unstaged", 1, None),
    "ab": ("pkg", 1, None),
    "abc4": ("pkg", 4, None),
    "abc8": ("pkg", 8, None),
    "abc16": ("pkg", 16, None),
    "row16_1": ("row16", 1, 11),
    "row16_4": ("row16", 4, 11),
    "row16_8": ("row16", 8, 11),
    "row16_16": ("row16", 16, 11),
    "row16_auto": ("row16", None, 11),
}
TARGET_MS = 50.0  # launches a reading: enough for this long


def build_libs(tmp):
    """nvcc every library of LIBS at once; {name: (CDLL, ptxas lines)}."""
    from fscl_tpu_torch import kernels

    nvcc = kernels._nvcc()
    cmds, paths = [], {}
    for name, (src, defs) in LIBS.items():
        paths[name] = pathlib.Path(tmp) / f"lib{name}.so"
        cmds.append([nvcc, *kernels.NVCC_FLAGS, *defs, "-shared",
                     "-o", str(paths[name]), str(src)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    libs = {}
    for (name, _), c, p in zip(LIBS.items(), cmds, procs):
        log, _ = p.communicate()
        if p.returncode != 0:
            cs.fail(f"nvcc failed for {name}: {' '.join(c)}\n{log}")
        lib = ctypes.CDLL(str(paths[name]))
        vp, i = ctypes.c_void_p, ctypes.c_int
        tail = [ctypes.c_float, vp] if name == "baseline" else [
            ctypes.c_float, i, vp]
        lib.fscl_lattice_clr.argtypes = [vp] * 10 + [i] * (
            5 if name == "baseline" else 6) + tail
        lib.fscl_lattice_clr.restype = i
        libs[name] = (lib, ptxas_report(log))
    return libs


def ptxas_report(log):
    """[(kernel, registers, spill store bytes, spill load bytes)] of the
    lattice kernels in an nvcc -Xptxas -v log."""
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
        if m and cur and "lattice_clr_kernel" in cur:
            out.append((kernel_name(cur), int(m.group(1)), *spill))
            cur, spill = None, (0, 0)
    return out


def kernel_name(mangled):
    """lattice_clr_kernel<A, AP, C, staged> from its mangled name."""
    args = re.findall(r"L[ib](\d+)E", mangled.split("lattice_clr_kernel")[1]
                      .split("EEv")[0] + "E")
    return f"lattice_clr_kernel<{', '.join(args)}>"


def capture_shapes(dev, wanted):
    """[(label, args, kwargs)] of the lattice calls the paths make."""
    import torch

    from fscl_tpu_torch.engine import scan_genome, scan_permute
    from fscl_tpu_torch.engine.permute import PermuteConfig
    from fscl_tpu_torch.engine.scan import ScanConfig
    from fscl_tpu_torch.io import load_snp_input

    def want(label):
        return not wanted or any(label.startswith(w) for w in wanted)

    shapes = []
    stages = ("coarse", "fine", "ultra")
    if want("20k"):
        data, tables, _ = cs._task_20k()
        scan_cfg = ScanConfig(small_grid_sp=1000, large_grid_sp=100000,
                              use_hist=False)
        res, scan = cs._lattice_capture(
            lambda: scan_genome(data, tables, scan_cfg, device=dev))
        _, perm = cs._lattice_capture(lambda: scan_permute(
            data, tables, res, scan_cfg, PermuteConfig(
                n_permute=32, chunk_replicates=32, seed=1, use_hist=False),
            device=dev))
        chunk = [c for c in perm if c[0][1].shape[0] > 1][:2]
        shapes += [(f"20k dense {s}", *c) for s, c in zip(stages, scan)]
        shapes += [(f"20k chunk {s}", *c) for s, c in zip(stages, chunk)]
        data = load_snp_input(REPO / "bench" / "data" / "bench_20k.sf")
        t1024 = cs._load_model(data, compat=True, grid_points=1024)
        _, tie = cs._lattice_capture(lambda: scan_genome(
            data, t1024, ScanConfig(small_grid_sp=1000,
                                    large_grid_sp=100000), device=dev))
        shapes += [(f"20k tie1024 {s}", *c) for s, c in zip(stages, tie)]
    if want("big"):
        data, _ = cs.big_chromosome_data()
        tables = cs._load_model(data, compat=False)
        cfg = ScanConfig()
        res, scan = cs._lattice_capture(
            lambda: scan_genome(data, tables, cfg, device=dev))
        _, perm = cs._lattice_capture(lambda: scan_permute(
            data, tables, res, cfg, PermuteConfig(n_permute=16),
            device=dev))
        chunk = [c for c in perm if c[0][1].shape[0] > 1][:2]
        shapes += [(f"big dense {s}", *c) for s, c in zip(stages, scan)]
        shapes += [(f"big chunk {s}", *c) for s, c in zip(stages, chunk)]
        del scan, perm
    torch.cuda.synchronize()
    return [s for s in shapes if want(s[0])]


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
    kernels.load()  # the package's own build, for the captured calls
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
        shapes = capture_shapes(dev, sys.argv[1:])
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        results = []
        for label, args, kw in shapes:
            results.append(run_shape(label, args, kw, libs, n_sm))
            torch.cuda.empty_cache()
    (OUT / "lattice.json").write_text(json.dumps(dict(
        nvidia_smi=smi.strip(), ptxas=report, shapes=results), indent=1)
        + "\n")
    cs.log(smi.strip())
    return 0


def run_shape(label, args, kw, libs, n_sm):
    """Every variant at one captured shape: times, checks, the record."""
    import torch

    from fscl_tpu_torch.ops import lattice as TL

    pack, row, pos, null, cand, lo, hi, m_base, m_rel = args
    G = kw["grid_points"]
    Rr, P, A = row.shape[0], cand.shape[0], m_rel.shape[0]
    live = lo <= hi
    pairs = Rr * int((hi[live] - lo[live] + 1).sum())
    coarse = A == TL.N_COARSE
    big = label.startswith("big")
    dev = row.device
    base_pack = pack[:, :2 * A].contiguous()  # PR 9's rows: 2A floats
    pack16 = (torch.nn.functional.pad(base_pack, (0, 32 - 2 * A)) if coarse
              else pack)
    auto_c = TL.block_candidates(Rr, P, n_sm)
    rest = (row, pos, null, cand, lo, hi, m_base, m_rel)

    def launcher(lib, kp, c):
        return lambda: TL.launch_lattice(lib, kp, *rest, G, c)

    def baseline():
        out = torch.empty((Rr, P, A), dtype=torch.float32, device=dev)
        rc = libs["baseline"][0].fscl_lattice_clr(
            base_pack.data_ptr(), *(t.data_ptr() for t in rest),
            out.data_ptr(),
            Rr, P, row.shape[1], A, G, TL.lattice_inv_step(G),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            cs.fail(f"baseline kernel: CUDA error {rc}")
        return out

    fns = {"baseline": baseline,
           "auto": launcher(libs["pkg"][0], pack, auto_c)}
    for name, (lib, c, only_A) in VARIANTS.items():
        if only_A not in (None, A):
            continue
        kp = pack16 if lib == "row16" else pack
        fns[name] = launcher(libs[lib][0], kp, auto_c if c is None else c)

    ref = fns["auto"]()
    # the plain version on every candidate, or on 64 at the big chromosome
    sub = (torch.linspace(0, P - 1, 64, device=dev).round().long() if big
           else torch.arange(P, device=dev))
    chk = cs._lattice_sub(args, sub)
    want = TL.clr_lattice_plain(*chk, **kw)
    lim = cs.LAT_REL * TL.clr_lattice_plain(*chk, **kw, abs_sum=True) \
        + cs.LAT_ABS
    checks = {}
    for name, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        exact = not name.startswith(("baseline", "row16"))
        if exact:
            ok = torch.equal(got.view(torch.int32), ref.view(torch.int32))
            checks[name] = "bitwise" if ok else "DIFFERS"
        else:
            err = float(((got[:, sub] - want).abs() / lim).max())
            ok = err <= 1.0
            checks[name] = (f"{err:.3g} x tolerance vs plain on "
                            f"{len(sub)} candidates")
        if not ok:
            cs.fail(f"{label}: variant {name}: {checks[name]}")
        del got
    del want, lim, ref

    single = {}
    for name in ("baseline", "auto"):
        t = time.monotonic()
        fns[name]()
        torch.cuda.synchronize()
        single[name] = (time.monotonic() - t) * 1e3
    readings = 3 if big else 5

    def timed(name):
        iters = max(1, int(TARGET_MS / max(single.get(name, single["auto"]),
                                           1e-3)))
        return cs.cuda_time_ms(fns[name], iters, readings=readings)

    turns = [timed(n) for n in ("baseline", "auto", "auto", "baseline")]
    times = {"baseline": [turns[0], turns[3]], "auto": [turns[1], turns[2]]}
    for name in fns:
        if name not in times:
            times[name] = [timed(name)]
    clocks = {n: min(t) * 1e-3 * n_sm * cs.SM_CLOCK_HZ / pairs
              for n, t in times.items()}
    b_ms, b_by = cs.bound((pack, *rest),
                          [torch.empty((Rr, P, A), device=dev)],
                          pairs * (12 + 7 * A))
    cs.log(f"[variants] {label}: Rr={Rr} P={P} A={A} G={G}, {pairs} pairs, "
           f"auto C={auto_c}, bound {b_ms:.4f} ms ({b_by})")
    for name, t in times.items():
        cs.log(f"  {name:11s} " + " / ".join(f"{x:.4f}" for x in t)
               + f" ms, {clocks[name]:.3f} SM clocks a pair, "
               f"{100 * b_ms / min(t):.1f}% of bound; {checks[name]}")
    return dict(label=label, Rr=Rr, P=P, A=A, G=G, pairs=pairs,
                auto_cands=auto_c, bound_ms=b_ms, bound_by=b_by,
                ms=times, sm_clocks_per_pair=clocks,
                checks=checks)


if __name__ == "__main__":
    sys.exit(main())
