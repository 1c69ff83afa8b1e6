#!/usr/bin/env python3
"""Time variants of the chained-scan prefix-sum kernels on one Hopper
card: the one-hot body (csrc/prefix_sums.cu) in its segmented mode (b)
and its row-id modes (a) and (b'), and the weighted kernel
(csrc/weighted_prefix_sums.cu).

A variant is the committed source with named pieces of text replaced:
either a tuning constant changed (its output is checked against the
plain version, bitwise or within 2 float32 ulps) or one part of the
kernel taken out (an ablation: the output is wrong and not checked; the
time it saves is that part's share).  One variant is another source:
rps_three_pass puts the row-id entry points of the first, three-pass
version (tools/rowid_prefix_sums_baseline.cu) in place of the chained
scan's, so name it between base runs to time the two in turns.  For
each variant the script builds the two sources (and their headers) with
nvcc into a library of its own, puts it in place of the package's
library for the wrappers, and times each wrapper it changes at the main
path's shapes (mode (b): phase 3's; (a) and (b'): phases 3a and 3b's
timed ones): CUDA events over 20 launches, median of 5
(chip_smoke.cuda_time_ms), the kernel and the memsets alone under
torch.profiler, and the host's time to enqueue one call.  Every
replacement must match the source once, or the script fails.

Run from the repo root on the card:

    python3 tools/prefix_scan_variants.py [variant ...]

(no names: every variant, then base again; a name may repeat, and each
is built once).  Writes chiprun_out/variants/variants.json.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

OUT = REPO / "chiprun_out" / "variants"
CSRC = REPO / "fscl_tpu_torch" / "csrc"
PS, WPS, HDR = "prefix_sums.cu", "weighted_prefix_sums.cu", "chained_scan.cuh"


def _const(f, name, old, new):
    """Set the named constant of file f from old to new."""
    return (f, f"constexpr int {name} = {old};",
            f"constexpr int {name} = {new};")


def _window(k):
    """The packed-word look-back's window: predecessors read at once."""
    return (HDR, "template <int V, int kWindow = 4>",
            f"template <int V, int kWindow = {k}>")


# in place of staging the tile's ids: id 0 everywhere (a valid weight row)
_NO_STAGE = ("for (int e = threadIdx.x; e < n * n_rep; e += kThreads) "
             "ids[e] = 0;\n  __syncthreads();")

# the row-id entry points the three-pass baseline replaces
BASELINE = REPO / "tools" / "rowid_prefix_sums_baseline.cu"
ROWID_FNS = ("fscl_rowid_prefix_sums", "fscl_perm_prefix_sums")

# name -> (kernels it changes: "ps" (the one-hot body: modes (b), (a),
# (b')), "rps" (modes (a), (b') only), "wps" or None for all, is it an
# ablation, [(file, old text, new text), ...])
VARIANTS = {
    "base": (None, False, []),
    # modes (a) and (b'): the three-pass version; the zero row by memset
    "rps_three_pass": ("rps", False, []),
    "rps_row0_memset": ("rps", False, [
        (PS, "constexpr bool kRow0InKernel = true;",
         "constexpr bool kRow0InKernel = false;")]),
    # the one-hot kernel: tile, warps a tile, lanes a thread, look-back
    "ps_tile256": ("ps", False, [_const(PS, "kTile", 512, 256)]),
    "ps_tile1024": ("ps", False, [_const(PS, "kTile", 512, 1024)]),
    "ps_t1024_w16": ("ps", False, [
        _const(PS, "kTile", 512, 1024), _const(PS, "kWarps", 8, 16)]),
    "ps_t256_w4": ("ps", False, [
        _const(PS, "kTile", 512, 256), _const(PS, "kWarps", 8, 4)]),
    "ps_warps4": ("ps", False, [_const(PS, "kWarps", 8, 4)]),
    "ps_warps16": ("ps", False, [_const(PS, "kWarps", 8, 16)]),
    "ps_vec4": ("ps", False, [_const(PS, "kVec", 2, 4)]),
    "ps_window2": ("ps", False, [_window(2)]),
    "ps_window8": ("ps", False, [_window(8)]),
    "ps_w4_window2": ("ps", False, [_const(PS, "kWarps", 8, 4), _window(2)]),
    "ps_relaxed": ("ps", False, [
        (HDR, '"ld.acquire.gpu.u64 %0, [%1];"',
         '"ld.relaxed.gpu.u64 %0, [%1];"')]),
    # the one-hot kernel, one part taken out
    "ps_no_stage": ("ps", True, [
        (PS, "fscl::stage_tile_ids<kThreads>(ids, n, n_rep, "
             "src.at(s, p_lo, k0));", _NO_STAGE)]),
    "ps_no_walk1": ("ps", True, [
        (PS, "for (int v = 0; v < kVec; ++v) cnt[v] += row[pl[v]] == r[v];",
         "for (int v = 0; v < kVec; ++v) cnt[v] += 0 * row[pl[v]];")]),
    "ps_no_lookback": ("ps", True, [
        (PS, "fscl::lookback_counts<kVec>(sc.words + (size_t)s * n_tiles * "
             "L + l,\n                                (size_t)L, t, live, "
             "tot, run);",
         "for (int v = 0; v < kVec; ++v) run[v] = tot[v];")]),
    "ps_no_store": ("ps", True, [
        (PS, "store_vec(dst + (size_t)i * L, run);",
         "if (run[0] == 0xFFFFFFFFu) store_vec(dst + (size_t)i * L, run);")]),
    # the weighted kernel: tile, warps a tile (sites a warp walks)
    "wps_tile512": ("wps", False, [_const(WPS, "kTile", 1024, 512)]),
    "wps_tile2048": ("wps", False, [_const(WPS, "kTile", 1024, 2048)]),
    "wps_warps4": ("wps", False, [_const(WPS, "kWarps", 8, 4)]),
    "wps_warps16": ("wps", False, [_const(WPS, "kWarps", 8, 16)]),
    "wps_t2048_w16": ("wps", False, [
        _const(WPS, "kTile", 1024, 2048), _const(WPS, "kWarps", 8, 16)]),
    # the weighted kernel, one part taken out
    "wps_no_stage": ("wps", True, [
        (WPS, "fscl::stage_tile_ids<kThreads>(ids, n, n_rep, id_at);",
         _NO_STAGE)]),
    "wps_no_walk1": ("wps", True, [
        (WPS, "    sum += (double)__ldg(wr + (size_t)slice[i * n_rep] * R);",
         "    sum += 0.0 * slice[i * n_rep];")]),
    "wps_no_regather": ("wps", True, [
        (WPS, "    run += (double)__ldg(wr + (size_t)slice[i * n_rep] * R);",
         "    run += (double)slice[i * n_rep];")]),
    "wps_no_wait": ("wps", True, [
        (WPS, "  fscl::wait_tiles(flags, t);\n", "")]),
    "wps_no_store": ("wps", True, [
        (WPS, "    dst[(size_t)i * L] = (float)run;",
         "    if (run == -1.25) dst[(size_t)i * L] = (float)run;")]),
}


def build(name, edits, work):
    """The variant's library, loaded, its entry points typed."""
    from fscl_tpu_torch import kernels

    src = work
    src.mkdir(parents=True)
    for f in CSRC.glob("*.cuh"):
        shutil.copy(f, src)
    for f in (PS, WPS):
        shutil.copy(CSRC / f, src)
    for f, old, new in edits:
        text = (src / f).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {f} holds {old!r} "
                             f"{text.count(old)} times, not once")
        (src / f).write_text(text.replace(old, new))
    nvcc = kernels._nvcc()
    objs = [src / f"{f}.o" for f in (PS, WPS)]
    procs = [subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-c",
                               str(src / f), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for f, o in zip((PS, WPS), objs)]
    log = ""
    for p in procs:
        out, _ = p.communicate()
        log += out
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
    so = src / "lib.so"
    subprocess.run([nvcc, *kernels.ARCH, "-shared", "-o", str(so),
                    *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(so))
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.fscl_onehot_prefix_sums.argtypes = [vp] * 5 + [i] * 7 + [vp]
    lib.fscl_weighted_prefix_sums.argtypes = [vp] * 6 + [i] * 7 + [vp]
    for f in (lib.fscl_onehot_prefix_sums, lib.fscl_weighted_prefix_sums):
        f.restype = i
    for f in (lib.fscl_ps_scratch_bytes, lib.fscl_wps_scratch_bytes):
        f.argtypes, f.restype = [i] * 4, i64
    for f in (lib.fscl_ps_tile, lib.fscl_wps_tile):
        f.argtypes, f.restype = [], i
    lib.fscl_rowid_prefix_sums.argtypes = [vp] * 3 + [i] * 4 + [vp]
    lib.fscl_perm_prefix_sums.argtypes = [vp] * 4 + [i] * 9 + [vp]
    for f in ROWID_FNS:
        getattr(lib, f).restype = i
    lib.fscl_cuda_error_string.argtypes = [i]
    lib.fscl_cuda_error_string.restype = ctypes.c_char_p
    if name == "rps_three_pass":
        so = src / "three_pass.so"
        p = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o",
                            str(so), str(BASELINE)], capture_output=True,
                           text=True)
        log += p.stdout + p.stderr
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        old = ctypes.CDLL(str(so))
        old.fscl_rowid_prefix_sums.argtypes = (
            lib.fscl_rowid_prefix_sums.argtypes)
        old.fscl_perm_prefix_sums.argtypes = (
            lib.fscl_perm_prefix_sums.argtypes)
        for f in ROWID_FNS:
            getattr(old, f).restype = i
        lib = _ThreePass(lib, old)
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    return lib, regs


class _ThreePass:
    """A variant's library with the three-pass row-id entry points."""

    def __init__(self, lib, old):
        self._lib, self._old = lib, old

    def __getattr__(self, name):
        return getattr(self._old if name in ROWID_FNS else self._lib, name)


def device_ms(fn, key, n=20):
    """(kernel, memset, host) ms per call of fn: the mean device time of
    the kernels whose name holds key and of the memsets, under
    torch.profiler, and the host clock's time to enqueue a call (n calls
    without a synchronise, after one that drains the queue)."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern = mem = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if key in e.key:
            kern += e.self_device_time_total
        elif "memset" in e.key.lower():
            mem += e.self_device_time_total
    return kern / n / 1e3, mem / n / 1e3, host


def time_ps(dev, label, S, w, P, R, check):
    import numpy as np
    import torch

    from fscl_tpu_torch.ops import prefix_sums as ps

    rng = np.random.default_rng(0)
    table, sig, g0 = (torch.as_tensor(x, device=dev)
                      for x in cs._prefix_inputs(rng, S, w, P, R))
    kw = dict(w_seg_p=w, n_rows=R)

    def kern():
        return ps.onehot_prefix_sums(table, sig, g0, **kw)

    got = kern()
    ok = None
    if check:
        ok = bool(torch.equal(got, ps.onehot_prefix_sums_plain(
            table, sig, g0, **kw)))
    b_ms, _ = cs.bound((table, sig, g0), (got,), 2 * got.numel())
    del got
    torch.cuda.empty_cache()
    ms = cs.cuda_time_ms(kern, 20)
    k_ms, m_ms, h_ms = device_ms(kern, "onehot_chained_scan")
    return dict(label=label, ms=ms, kernel_ms=k_ms, memset_ms=m_ms,
                host_ms=h_ms, bound_ms=b_ms, equal=ok)


def time_wps(dev, label, S, w, P, R, n_ids, check):
    import numpy as np
    import torch

    from fscl_tpu_torch.ops import prefix_sums as ps

    rng = np.random.default_rng(1)
    table, wt, sig, g0 = (torch.as_tensor(x, device=dev) for x in
                          cs._weighted_inputs(rng, S, w, P, R, n_ids))

    def kern():
        return ps.weighted_prefix_sums(table, wt, sig, g0, w_seg_p=w)

    got = kern()
    ok = None
    if check:
        want = ps.weighted_prefix_sums_plain(table, wt, sig, g0, w_seg_p=w)
        scale = want.reshape(S, w, -1).abs().amax(1, keepdim=True)
        err = (got - want).abs().reshape(S, w, -1)
        eps = float(torch.finfo(torch.float32).eps)
        ok = bool((err <= 2 * eps * scale).all()
                  and torch.equal(got, kern()))
        del want, scale, err
    b_ms, _ = cs.bound((table, wt, sig, g0), (got,), got.numel())
    del got
    torch.cuda.empty_cache()
    ms = cs.cuda_time_ms(kern, 20)
    k_ms, m_ms, h_ms = device_ms(kern, "weighted_chained_scan")
    return dict(label=label, ms=ms, kernel_ms=k_ms, memset_ms=m_ms,
                host_ms=h_ms, bound_ms=b_ms, equal=ok)


def _time_rowid_mode(label, kern, plain, tensors_in, key, check):
    """One row-id mode's wrapper at one shape: times and, unless an
    ablation, bitwise equality with the plain version."""
    import torch

    got = kern()
    ok = bool(torch.equal(got, plain())) if check else None
    b_ms, _ = cs.bound(tensors_in, (got,), 2 * got.numel())
    del got
    torch.cuda.empty_cache()
    ms = cs.cuda_time_ms(kern, 20)
    k_ms, m_ms, h_ms = device_ms(kern, key)
    return dict(label=label, ms=ms, kernel_ms=k_ms, memset_ms=m_ms,
                host_ms=h_ms, bound_ms=b_ms, equal=ok)


def time_rowid(dev, label, P, W, R, key, check):
    import numpy as np
    import torch

    from fscl_tpu_torch.ops import prefix_sums as ps

    rng = np.random.default_rng(2)
    row_rep = torch.as_tensor(
        rng.integers(0, R + 3, size=(P, W)).astype(np.int32), device=dev)
    return _time_rowid_mode(
        "(a) " + label, lambda: ps.rowid_prefix_sums(row_rep, n_rows=R),
        lambda: ps.rowid_prefix_sums_plain(row_rep, n_rows=R), (row_rep,),
        key, check)


def time_perm(dev, label, W_genome, start, n, w_pad, P, R, key, check):
    import numpy as np
    import torch

    from fscl_tpu_torch.ops import prefix_sums as ps

    rng = np.random.default_rng(3)
    table, sig = (torch.as_tensor(x, device=dev) for x in
                  cs._perm_inputs(rng, W_genome, P, R, w_pad))
    kw = dict(start=start, n=n, w_pad=w_pad, n_rows=R)
    return _time_rowid_mode(
        "(b') " + label, lambda: ps.perm_prefix_sums(table, sig, **kw),
        lambda: ps.perm_prefix_sums_plain(table, sig, **kw), (table, sig),
        key, check)


def main():
    import torch

    from fscl_tpu_torch import kernels

    if not torch.cuda.is_available():
        raise SystemExit("prefix_scan_variants: no CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    names = sys.argv[1:] or [*VARIANTS, "base"]
    # the main path's shapes (chip_smoke.py phases 3 and 3c)
    ps_shapes = [("20k", 1, 20480, 32, 56), ("genome", 24, 36864, 16, 48)]
    wps_shapes = [("mixed100k", 4, 24576, 32, 32, 1590),
                  ("widest", 1, 36864, 16, 104, 8193)]
    # phases 3a and 3b's timed shapes (the 20k path's and one genome1m
    # chromosome's)
    rowid_shapes = [("20k", 32, 20000, 56), ("genome1m chr", 16, 35351, 48)]
    perm_shapes = [("20k", 20000, 0, 20000, 20480, 32, 56),
                   ("genome1m chr", 80000, 40013, 35351, 36864, 16, 48)]
    OUT.mkdir(parents=True, exist_ok=True)
    rows, built = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            which, ablation, edits = VARIANTS[name]
            if name not in built:
                built[name] = build(name, edits,
                                    pathlib.Path(tmp) / str(len(built)))
            lib, regs = built[name]
            kernels._lib = lib
            res = dict(variant=name, ablation=ablation, ptxas=regs, runs=[])
            if which in (None, "ps"):
                res["runs"] += [time_ps(dev, *s, check=not ablation)
                                for s in ps_shapes]
            if which in (None, "ps", "rps"):
                three = name == "rps_three_pass"
                res["runs"] += [
                    time_rowid(dev, *s, "rtile_" if three else "RowRepIds",
                               check=not ablation) for s in rowid_shapes]
                res["runs"] += [
                    time_perm(dev, *s, "rtile_" if three else "PermIds",
                              check=not ablation) for s in perm_shapes]
            if which in (None, "wps"):
                res["runs"] += [time_wps(dev, *s, check=not ablation)
                                for s in wps_shapes]
            for r in res["runs"]:
                print(f"{name:16s} {r['label']:10s} wrapper {r['ms']:.4f} ms"
                      f"  kernel {r['kernel_ms']:.4f}  memset "
                      f"{r['memset_ms']:.4f}  host {r['host_ms']:.4f}  "
                      f"bound {r['bound_ms']:.4f} "
                      f"({100 * r['bound_ms'] / r['kernel_ms']:.1f}% by the "
                      f"kernel)  equal {r['equal']}", flush=True)
                if r["equal"] is False:
                    raise SystemExit(f"{name} at {r['label']}: kernel "
                                     "differs from its plain version")
            rows.append(res)
            kernels._lib = None
            torch.cuda.empty_cache()
    (OUT / "variants.json").write_text(
        json.dumps(dict(nvidia_smi=smi, variants=rows), indent=1) + "\n")


if __name__ == "__main__":
    main()
