#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fscl_tpu_torch) on one Hopper card.

Phases, each printing its own lines; any failure raises and exits
non-zero:
  1. device  - a CUDA card of capability (9, 0); its name and power limit
  2. build   - nvcc builds the kernels from csrc/, one process per source
               (ptxas report printed)
  3. kernel  - the segmented one-hot prefix-sum kernel against its plain
               PyTorch version, bitwise, at the main path's shapes; both
               timed
  3c. wkernel - the weighted (compressed-mode) prefix-sum kernel against
               its plain version at the mixed100k shape and one more:
               within 2 float32 ulps of each segment's max |prefix|, two
               launches bitwise equal; both timed
  4. 20k     - the bench.py task (bench/data/bench_20k.sf, 50
               permutations) through the port's entry points; the
               kernel's launches are counted over this run; the first
               chunk's statistic is recomputed with the plain prefix
               function and must be equal
  5. genome  - ~778k sites over 22 chromosomes (bench/headline.py
               gen_genome1m), scan and 64 permutations
  5c. mixed100k - bench/data/headline_mixed100k.sf (94,889 sites, 31
               depths, 1,589 table rows, compressed tables), scan and 64
               permutations; the weighted kernel's launches are counted
               over this run; the first chunk's statistic is recomputed
               with the plain prefix function
  6. check   - a small single-depth input and a small mixed-depth input
               through the card and through the plain CPU versions must
               agree
Then one JSON line with every kernel's numbers, and last the JSON status
line.  Run from the repo root: python3 chip_smoke.py

``--profile`` instead runs phases 1-2 and then torch.profiler over the
scan and the permutations of the 20k task, of the genome (16
permutations) and of mixed100k (16 permutations): device time by kernel
and the device's busy share, with the tables written under OUT.
"""

from __future__ import annotations

import copy
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
OUT = REPO / "chiprun_out" / "smoke"
# mixed-depth card vs CPU check: CLR and threshold tolerance, and the
# near-tie band excluded from the count comparison
MIXED_TOL = 5e-3
MIXED_BAND = 1e-3


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    from fscl_tpu_torch.device import parse_device

    dev = parse_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"[device] {name} capability {torch.cuda.get_device_capability(0)}"
        f" count {torch.cuda.device_count()}")
    log(smi.stdout.strip())
    return dev, name, smi.stdout.strip()


def phase_build():
    from fscl_tpu_torch import kernels

    t0 = time.monotonic()
    kernels.load()
    log(f"[build] {kernels.library_path().name} in "
        f"{time.monotonic() - t0:.2f}s (nvcc {kernels.build_seconds:.2f}s)")
    for line in kernels.build_log.splitlines():
        if line.strip():
            log(f"[build] {line}")


def _prefix_inputs(rng, S, w, P, R):
    import numpy as np

    G = S * w // 32 + 64
    table = rng.integers(0, R + 1, size=(G + 1, 32)).astype(np.int16)
    table[-1] = R
    sig = np.stack([rng.permutation(G) for _ in range(P)]).astype(np.int32)
    sig[:, rng.random(G) < 0.01] = G  # sentinel columns inside the slab
    sig = np.concatenate([sig, np.full((P, w // 32 + 2), G, np.int32)], 1)
    seg_g0 = np.sort(rng.choice(G - w // 32, S, replace=False))
    seg_g0[0] = 0  # negative slab index -> sentinel column
    return table, sig, seg_g0.astype(np.int32)


def phase_kernel(dev, shapes):
    import numpy as np
    import torch

    from fscl_tpu_torch.ops import prefix_sums as ps

    rng = np.random.default_rng(0)
    out = []
    for label, S, w, P, R in shapes:
        table, sig, g0 = (torch.as_tensor(x, device=dev)
                          for x in _prefix_inputs(rng, S, w, P, R))
        kw = dict(w_seg_p=w, n_rows=R)
        got = ps.onehot_prefix_sums(table, sig, g0, **kw)
        want = ps.onehot_prefix_sums_plain(table, sig, g0, **kw)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            bad = (got.to(torch.int64) - want.to(torch.int64)).abs()
            fail(f"kernel != plain at {label}: {int((bad > 0).sum())} "
                 f"entries differ, max {int(bad.max())}")
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        del got, want
        ms = cuda_time_ms(lambda: ps.onehot_prefix_sums(table, sig, g0, **kw),
                          20)
        plain_ms = cuda_time_ms(
            lambda: ps.onehot_prefix_sums_plain(table, sig, g0, **kw), 5)
        mb = S * w * P * R * (2 if w <= 32767 else 4) / 1e6
        log(f"[kernel] {label}: S={S} w={w} P={P} R={R} bitwise equal; "
            f"kernel {ms:.4f} ms ({mb / ms:.1f} GB/s written), plain "
            f"{plain_ms:.4f} ms")
        out.append(dict(label=label, S=S, w=w, P=P, R=R, ms=ms,
                        plain_ms=plain_ms, max_abs_err=err, out_mb=mb))
        torch.cuda.empty_cache()
    return out


def _weighted_inputs(rng, S, w, P, R, n_ids):
    """Row-id table, sigma and segment starts as _prefix_inputs, with ids
    in [0, n_ids - 1] (n_ids - 1 = the sentinel), and an [n_ids, R] f32
    weight table shaped like the compressed tables': centred channels
    of mixed scale, a count channel of ones, the zero sentinel row."""
    import numpy as np

    table, sig, seg_g0 = _prefix_inputs(rng, S, w, P, n_ids - 1)
    wt = rng.normal(size=(n_ids, R)) * np.geomspace(3000.0, 0.1, R)
    wt[:, R - 1] = 1.0
    wt[-1] = 0.0
    return table, wt.astype(np.float32), sig, seg_g0


def phase_wkernel(dev, shapes):
    """Phase 3c: weighted kernel vs plain, determinism, times."""
    import numpy as np
    import torch

    from fscl_tpu_torch.ops import prefix_sums as ps

    rng = np.random.default_rng(1)
    eps = float(torch.finfo(torch.float32).eps)
    out = []
    for label, S, w, P, R, n_ids in shapes:
        table, wt, sig, g0 = (torch.as_tensor(x, device=dev) for x in
                              _weighted_inputs(rng, S, w, P, R, n_ids))

        def kern():
            return ps.weighted_prefix_sums(table, wt, sig, g0, w_seg_p=w)

        def plain():
            return ps.weighted_prefix_sums_plain(table, wt, sig, g0,
                                                 w_seg_p=w)

        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"weighted kernel at {label}: two launches differ")
        scale = want.reshape(S, w, -1).abs().amax(1, keepdim=True)
        err = (got - want).abs().reshape(S, w, -1)
        max_abs = float(err.max())
        rel = float((err / scale.clamp_min(1e-30)).max())
        if not bool((err <= 2 * eps * scale).all()):
            fail(f"weighted kernel != plain at {label}: max |err| "
                 f"{max_abs:.4g} = {rel / eps:.3f} ulps of the segment's "
                 "max |prefix| (limit 2)")
        del got, again, want, err
        torch.cuda.empty_cache()
        ms = cuda_time_ms(kern, 20)
        plain_ms = cuda_time_ms(plain, 3)
        torch.cuda.empty_cache()
        mb = S * w * P * R * 4 / 1e6
        log(f"[wkernel] {label}: S={S} w={w} P={P} R={R} ids={n_ids}; "
            f"max |err| {max_abs:.6g}, max err / segment max |prefix| "
            f"{rel:.4g} ({rel / eps:.3f} ulps); kernel {ms:.4f} ms "
            f"({mb / ms:.1f} GB/s written), plain {plain_ms:.4f} ms")
        out.append(dict(label=label, S=S, w=w, P=P, R=R, n_ids=n_ids, ms=ms,
                        plain_ms=plain_ms, max_abs_err=max_abs,
                        max_rel_err=rel, out_mb=mb))
    return out


def _plain_prefix(table, sig, seg_g0, *, w_seg_p, n_rows, weights=None):
    """build_prefix_sums_seg with the plain versions of both kernels."""
    from fscl_tpu_torch.ops import prefix_sums as ps

    if weights is None:
        return ps.onehot_prefix_sums_plain(table, sig, seg_g0,
                                           w_seg_p=w_seg_p, n_rows=n_rows)
    return ps.weighted_prefix_sums_plain(table, weights, sig, seg_g0,
                                         w_seg_p=w_seg_p)


def _first_chunk(data, tables, result, scan_cfg, perm_cfg, dev):
    """The first chunk's null maxima of every stack, with the kernels and
    with the plain prefix function: [(kernel, plain)] per stack."""
    import numpy as np
    import torch

    from fscl_tpu_torch.engine.permute import active_by_chr, setup_hist
    from fscl_tpu_torch.ops.permute import block_permutation_groups

    fresh = copy.deepcopy(result)
    hs = setup_hist(data, tables, fresh, scan_cfg, perm_cfg, dev)
    every = np.ones(fresh.n_points, bool)
    sigma, pairs = None, []
    for st in hs.stacks:
        st.rebuild(fresh, active_by_chr(fresh, st, every))
        rp = -(-perm_cfg.chunk_replicates // st.sub_rep) * st.sub_rep
        if sigma is None:
            sigma = hs.pad_sigma(block_permutation_groups(
                perm_cfg.seed, data.genome_pos(),
                perm_cfg.scan_width_mb * 1e6, rp, device=dev))
        a = st.stat(hs.table, sigma[:rp], perm_cfg)
        b = st.stat(hs.table, sigma[:rp], perm_cfg, prefix_fn=_plain_prefix)
        torch.cuda.synchronize()
        pairs.append((a, b))
    return hs, pairs


def _run_main_path(data, tables, scan_cfg, perm_cfg, dev, tsv):
    import torch

    from fscl_tpu_torch.engine import scan_genome, scan_permute
    from fscl_tpu_torch.io import scan_output, write_null_distribution

    torch.cuda.synchronize()
    t0 = time.monotonic()
    result = scan_genome(data, tables, scan_cfg, device=dev)
    torch.cuda.synchronize()
    t_scan = time.monotonic() - t0
    t0 = time.monotonic()
    scan_permute(data, tables, result, scan_cfg, perm_cfg, device=dev)
    torch.cuda.synchronize()
    t_perm = time.monotonic() - t0
    scan_output(tsv, data, result, n_permute=perm_cfg.n_permute)
    write_null_distribution(tsv, data, result)
    return result, t_scan, t_perm


def _check_result(result, label):
    import numpy as np

    K = result.n_points
    if K == 0 or result.clr.shape != (K,):
        fail(f"{label}: no scan points")
    if not np.isfinite(result.clr).all():
        fail(f"{label}: non-finite CLR")
    if not np.isfinite(result.stat_threshold).all():
        fail(f"{label}: non-finite permutation thresholds")
    if result.permute_n.sum() <= 0:
        fail(f"{label}: no permutation rounds counted")


def _load_model(data, compat):
    from fscl_tpu.models import background_fsp, build_tables

    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths, compat_mirror_unfolded=compat)
    tables = build_tables(fsp, data.sample_depths, grid_points=2048)
    data.attach_model(tables)
    return tables


def phase_20k(dev):
    import torch

    from fscl_tpu_torch.engine.permute import PermuteConfig
    from fscl_tpu_torch.engine.scan import ScanConfig
    from fscl_tpu_torch.io import load_snp_input
    from fscl_tpu_torch.ops import prefix_sums as ps

    data = load_snp_input(REPO / "bench" / "data" / "bench_20k.sf")
    tables = _load_model(data, compat=True)
    scan_cfg = ScanConfig(small_grid_sp=1000, large_grid_sp=100000)
    perm_cfg = PermuteConfig(n_permute=50, chunk_replicates=32, seed=1)

    # cold pass, then the timed pass with the launch count (bench.py order)
    _run_main_path(data, tables, scan_cfg, copy.deepcopy(perm_cfg), dev,
                   OUT / "bench_20k_cold.tsv")
    ps.launches = 0
    result, t_scan, t_perm = _run_main_path(
        data, tables, scan_cfg, perm_cfg, dev, OUT / "bench_20k.tsv")
    launches = ps.launches
    _check_result(result, "20k")
    if launches <= 0:
        fail("20k: the prefix-sum kernel was never launched")
    pr = int(result.permute_n.sum())
    log(f"[20k] {data.n_snps} sites, {result.n_points} points; scan "
        f"{t_scan:.3f}s, permute {t_perm:.3f}s, {pr} point-rounds, "
        f"{pr / t_perm:.1f} point-rounds/s, max CLR {result.clr.max():.2f}, "
        f"kernel launches {launches}")

    # first chunk again: kernel vs the plain prefix function on the card
    hs, pairs = _first_chunk(data, tables, result, scan_cfg, perm_cfg, dev)
    for a, b in pairs:
        if not torch.equal(a, b):
            fail("20k: first-chunk null_max differs between the kernel and "
                 f"the plain prefix (max {float((a - b).abs().max())})")
        log(f"[20k] first chunk: null_max [{a.shape[0]}, {a.shape[1]}] "
            "equal with the kernel and with the plain prefix sums")
    return dict(sites=data.n_snps, points=result.n_points, scan_s=t_scan,
                perm_s=t_perm, point_rounds=pr,
                point_rounds_per_s=pr / t_perm,
                max_clr=float(result.clr.max()), launches=launches,
                sub_rep=hs.stacks[0].sub_rep,
                w_seg_p=hs.stacks[0].w_seg_p, n_rows=hs.ht.n_rows)


def genome_data():
    """bench/headline.py gen_genome1m, in memory: 22 x 45.5 Mb, K >= 2."""
    import numpy as np

    from fscl_tpu.data import build_snp_data
    from fscl_tpu.sim import simulate_dataset

    chrs, pos, fr = [], [], []
    for c in range(22):
        sim = simulate_dataset(seed=200 + c, sample_size=50, snp_density=1.0,
                               mb_length=45.5, alpha=3e-5, n_sweeps=1)
        keep = sim["freq"] >= 2
        chrs += [str(c + 1)] * int(keep.sum())
        pos.append(sim["pos"][keep])
        fr.append(sim["freq"][keep])
    pos, fr = np.concatenate(pos), np.concatenate(fr)
    return build_snp_data(chrs, pos, fr, np.full(len(pos), 50),
                          np.zeros(len(pos), bool))


def phase_genome(dev, n_permute=64):
    from fscl_tpu_torch.engine.permute import (
        PermuteConfig, _ladder_pad, _sub_rep_for, setup_hist,
    )
    from fscl_tpu_torch.engine.scan import ScanConfig
    from fscl_tpu_torch.ops import prefix_sums as ps

    t0 = time.monotonic()
    data = genome_data()
    tables = _load_model(data, compat=False)
    t_setup = time.monotonic() - t0
    before = ps.launches
    result, t_scan, t_perm = _run_main_path(
        data, tables, ScanConfig(), PermuteConfig(n_permute=n_permute), dev,
        OUT / "genome1m.tsv")
    _check_result(result, "genome")
    hs = setup_hist(data, tables, result, ScanConfig(), PermuteConfig(), dev)
    stacks = [(st.w_seg_p, len(st.segs), _sub_rep_for(hs.ht, _ladder_pad(
        len(st.segs)), st.w_seg_p)) for st in hs.stacks]
    log(f"[genome] stacks (w_seg_p, chromosomes, sub_rep): {stacks}")
    pr = int(result.permute_n.sum())
    log(f"[genome] {data.n_snps} sites over {len(data.chr_limits)} "
        f"chromosomes, {result.n_points} points; data+tables {t_setup:.1f}s,"
        f" scan {t_scan:.3f}s, permute ({n_permute}) {t_perm:.3f}s, "
        f"{pr} point-rounds, {pr / t_perm:.1f} point-rounds/s, kernel "
        f"launches {ps.launches - before}")
    return dict(sites=data.n_snps, points=result.n_points, scan_s=t_scan,
                perm_s=t_perm, n_permute=n_permute, point_rounds=pr,
                point_rounds_per_s=pr / t_perm, stacks=stacks,
                n_rows=hs.ht.n_rows,
                launches=ps.launches - before)


def phase_mixed100k(dev, n_permute=64):
    """Phase 5c: the compressed mixed-depth path at its headline size."""
    import torch

    from fscl_tpu_torch.engine.permute import (
        PermuteConfig, _ladder_pad, _sub_rep_for,
    )
    from fscl_tpu_torch.engine.scan import ScanConfig, make_scan_hist_tables
    from fscl_tpu_torch.io import load_snp_input
    from fscl_tpu_torch.ops import prefix_sums as ps

    t0 = time.monotonic()
    data = load_snp_input(REPO / "bench" / "data" / "headline_mixed100k.sf")
    tables = _load_model(data, compat=True)
    t_setup = time.monotonic() - t0
    scan_cfg, perm_cfg = ScanConfig(), PermuteConfig(n_permute=n_permute)
    ps.launches = ps.weighted_launches = 0
    result, t_scan, t_perm = _run_main_path(
        data, tables, scan_cfg, perm_cfg, dev, OUT / "mixed100k.tsv")
    launches, onehot = ps.weighted_launches, ps.launches
    _check_result(result, "mixed100k")
    if launches <= 0:
        fail("mixed100k: the weighted prefix-sum kernel was never launched")
    if onehot:
        fail(f"mixed100k: the one-hot kernel ran {onehot} times on "
             "compressed tables")
    scan_nc = [make_scan_hist_tables(data, tables, scan_cfg.hist_alphas,
                                     decimate=d, device=dev).n_cells
               for d in (scan_cfg.hist_decimate, scan_cfg.tie_decimate)]
    hs, pairs = _first_chunk(data, tables, result, scan_cfg, perm_cfg, dev)
    ht = hs.ht
    if ht.weights is None:
        fail("mixed100k: the tables are not compressed")
    stacks = [(st.w_seg_p, len(st.segs), _sub_rep_for(ht, _ladder_pad(
        len(st.segs)), st.w_seg_p)) for st in hs.stacks]
    # first chunk: the engine's statistic (bf16 contraction) with the
    # kernel and with the plain prefix; tolerance 1e-2 of max |stat|, the
    # bf16 band of tests/test_torch_permute.py
    d_first = 0.0
    for a, b in pairs:
        d = float((a - b).abs().max())
        if d > 1e-2 * max(float(b.abs().max()), 1.0):
            fail(f"mixed100k: first-chunk null_max differs by {d:.4g} "
                 "between the kernel and the plain prefix")
        d_first = max(d_first, d)
        log(f"[mixed100k] first chunk: null_max [{a.shape[0]}, "
            f"{a.shape[1]}] kernel vs plain prefix max |diff| {d:.4g} "
            f"(max |stat| {float(b.abs().max()):.4g})")
    pr = int(result.permute_n.sum())
    log(f"[mixed100k] {data.n_snps} sites over {len(data.chr_limits)} "
        f"chromosomes, {len(data.sample_depths)} depths, "
        f"{len(ht.rows_used)} table rows -> {ht.n_rows} channels; NC scan "
        f"{scan_nc}, permutations {ht.n_cells}; stacks (w_seg_p, "
        f"chromosomes, sub_rep) {stacks}")
    log(f"[mixed100k] {result.n_points} points; data+tables {t_setup:.1f}s, "
        f"scan {t_scan:.3f}s, permute ({n_permute}) {t_perm:.3f}s, {pr} "
        f"point-rounds, {pr / t_perm:.1f} point-rounds/s, max CLR "
        f"{result.clr.max():.2f}, weighted kernel launches {launches}")
    torch.cuda.empty_cache()
    return dict(sites=data.n_snps, points=result.n_points, scan_s=t_scan,
                perm_s=t_perm, n_permute=n_permute, point_rounds=pr,
                point_rounds_per_s=pr / t_perm, stacks=stacks,
                n_rows=ht.n_rows, rows_used=len(ht.rows_used),
                n_cells_scan=scan_nc, n_cells_perm=ht.n_cells,
                max_clr=float(result.clr.max()), first_chunk_diff=d_first,
                launches=launches)


def _single_depth_check_data():
    """Two 3 Mb chromosomes at depth 30."""
    import numpy as np

    from fscl_tpu.data import build_snp_data
    from fscl_tpu.sim import simulate_dataset

    chrs, pos, fr = [], [], []
    for c in range(2):
        sim = simulate_dataset(seed=70 + c, sample_size=30, mb_length=3.0,
                               alpha=3e-5)
        chrs += [str(c + 1)] * len(sim["pos"])
        pos.append(sim["pos"])
        fr.append(sim["freq"])
    pos, fr = np.concatenate(pos), np.concatenate(fr)
    return build_snp_data(chrs, pos, fr, np.full(len(pos), 30),
                          np.zeros(len(pos), bool))


def _mixed_check_data():
    """Two 3 Mb chromosomes of depth-40 samples with missing calls: each
    site keeps 20-40 of them (hypergeometric subsample), 30% folded, so
    the data has more than ROWS_MAX distinct table rows."""
    import numpy as np

    from fscl_tpu.data import build_snp_data
    from fscl_tpu.sim import simulate_dataset

    rng = np.random.default_rng(71)
    chrs, pos, fr, dep, fo = [], [], [], [], []
    for c in range(2):
        sim = simulate_dataset(seed=80 + c, sample_size=40, mb_length=3.0,
                               alpha=3e-5)
        d = rng.integers(20, 41, len(sim["pos"]))
        f = rng.hypergeometric(sim["freq"], 40 - sim["freq"], d)
        folded = rng.random(len(d)) < 0.3
        f = np.where(folded, np.minimum(f, d - f), f)
        keep = (f >= 1) & (f <= d - 1)
        chrs += [str(c + 1)] * int(keep.sum())
        pos.append(sim["pos"][keep])
        fr.append(f[keep])
        dep.append(d[keep])
        fo.append(folded[keep])
    return build_snp_data(chrs, np.concatenate(pos), np.concatenate(fr),
                          np.concatenate(dep), np.concatenate(fo))


def phase_check(dev):
    """Small inputs on the card against the plain CPU versions."""
    import numpy as np

    from fscl_tpu.models import background_fsp, build_tables
    from fscl_tpu_torch.engine import scan_genome, scan_permute
    from fscl_tpu_torch.engine.permute import PermuteConfig
    from fscl_tpu_torch.engine.scan import ScanConfig, make_scan_hist_tables

    scan_cfg = ScanConfig(eval_range=1500, small_grid_sp=10000,
                          large_grid_sp=200000, exact_step_max=1.0,
                          selection_bf16=False)
    perm_cfg = PermuteConfig(n_permute=48, seed=3, hist_bf16=False,
                             scan_width_mb=0.1)
    out = {}
    # (data, CLR/threshold tolerance, near-tie band): single-depth with
    # the one-hot bounds; mixed-depth f32 weight sums add the rounding of
    # sqrt(W)-sized prefixes, hence the wider bounds (tests/
    # test_torch_mixed_depth.py states the same ones against fscl_tpu)
    for label, data, tol, band in (
            ("single-depth", _single_depth_check_data(), 1e-3, 1e-4),
            ("mixed-depth", _mixed_check_data(), MIXED_TOL, MIXED_BAND)):
        fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                             data.sample_depths)
        tables = build_tables(fsp, data.sample_depths, grid_points=1024)
        data.attach_model(tables)
        compressed = make_scan_hist_tables(
            data, tables, scan_cfg.hist_alphas, device="cpu"
        ).weights is not None
        if compressed != (label == "mixed-depth"):
            fail(f"check: {label} data compressed={compressed}")
        res = {}
        for d in (dev, "cpu"):
            r = scan_genome(data, tables, scan_cfg, device=d)
            scan_permute(data, tables, r, scan_cfg, perm_cfg, device=d)
            res[str(d)] = r
        g, c = res[str(dev)], res["cpu"]
        d_clr = float(np.abs(g.clr - c.clr).max())
        d_thr = float(np.abs(g.stat_threshold - c.stat_threshold).max())
        if d_clr > tol or d_thr > tol:
            fail(f"check {label}: card vs CPU clr {d_clr:.3g}, threshold "
                 f"{d_thr:.3g} (limit {tol})")
        tie = [i for i in range(g.n_points) for r in (g, c)
               if np.any(np.abs(np.asarray(r.null_clr[i])
                                - r.stat_threshold[i]) < band)]
        keep = np.setdiff1d(np.arange(g.n_points), tie)
        same = (np.array_equal(g.permute_p[keep], c.permute_p[keep])
                and np.array_equal(g.permute_n[keep], c.permute_n[keep]))
        if not same:
            fail(f"check {label}: permutation counts differ between card "
                 "and CPU")
        log(f"[check] {label}: {data.n_snps} sites, {g.n_points} points: "
            f"card vs CPU max |dCLR| {d_clr:.3g}, max |dthreshold| "
            f"{d_thr:.3g}; counts equal on {len(keep)} points "
            f"({len(set(tie))} near-tie points excluded)")
        out[label] = dict(points=g.n_points, d_clr=d_clr, d_thr=d_thr)
    return out


def phase_profile(dev):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fscl_tpu_torch.engine import scan_genome, scan_permute
    from fscl_tpu_torch.engine.permute import PermuteConfig
    from fscl_tpu_torch.engine.scan import ScanConfig
    from fscl_tpu_torch.io import load_snp_input

    d20 = load_snp_input(REPO / "bench" / "data" / "bench_20k.sf")
    t20 = _load_model(d20, compat=True)
    dg = genome_data()
    tg = _load_model(dg, compat=False)
    dm = load_snp_input(REPO / "bench" / "data" / "headline_mixed100k.sf")
    tm = _load_model(dm, compat=True)
    runs = [
        ("20k", d20, t20, ScanConfig(small_grid_sp=1000,
                                      large_grid_sp=100000),
         PermuteConfig(n_permute=50, chunk_replicates=32, seed=1)),
        ("genome", dg, tg, ScanConfig(), PermuteConfig(n_permute=16)),
        ("mixed100k", dm, tm, ScanConfig(), PermuteConfig(n_permute=16)),
    ]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, data, tables, scan_cfg, perm_cfg in runs:
        scan_genome(data, tables, scan_cfg, device=dev)  # warm caches
        for stage in ("scan", "permute"):
            if stage == "permute":
                result = scan_genome(data, tables, scan_cfg, device=dev)
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.monotonic()
                if stage == "scan":
                    scan_genome(data, tables, scan_cfg, device=dev)
                else:
                    scan_permute(data, tables, result, scan_cfg, perm_cfg,
                                 device=dev)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
            ka = prof.key_averages()
            # device-side kernel and memcpy events only: an aten op's own
            # device time is its kernels', and runtime stalls such as
            # "Command Buffer Full" are host time
            kern = [(e.self_device_time_total, e.count, e.key) for e in ka
                    if e.device_type == DeviceType.CUDA
                    and not e.key.startswith("Command Buffer")]
            busy = sum(t for t, _, _ in kern) / 1e6
            ours = sum(t for t, _, k in kern if "tile_" in k) / 1e6
            wours = sum(t for t, _, k in kern if "wtile_" in k) / 1e6
            table = ka.table(sort_by="self_device_time_total", row_limit=40)
            (OUT / f"profile_{label}_{stage}.txt").write_text(table)
            log(f"[profile] {label} {stage}: wall {wall:.3f}s (profiled), "
                f"device kernels {busy:.3f}s = {100 * busy / wall:.1f}% "
                f"busy; prefix-sum kernels {ours * 1e3:.3f} ms (weighted "
                f"{wours * 1e3:.3f} ms)")
            for t, n, key in sorted(kern, reverse=True)[:10]:
                log(f"[profile]   {t / 1e3:10.2f} ms  {n:7d}x  {key[:90]}")


def main():
    try:
        import torch  # noqa: F401
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    sys.path.insert(0, str(REPO))
    try:
        import fscl_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from {REPO}: {e}")
    dev, name, smi = phase_device()
    OUT.mkdir(parents=True, exist_ok=True)
    phase_build()
    if sys.argv[1:] == ["--profile"]:
        phase_profile(dev)
        return 0

    from types import SimpleNamespace

    from fscl_tpu_torch.engine.permute import _sub_rep_for

    # table rows at depth 50: 49 unfolded frequencies padded to 56 (20k);
    # 48 after the genome data's K >= 2 filter
    sub_20k = _sub_rep_for(SimpleNamespace(n_rows=56, weights=None), 1, 20480)
    sub_gen = _sub_rep_for(SimpleNamespace(n_rows=48, weights=None), 24,
                           36864)
    shapes = [("20k main path", 1, 20480, sub_20k, 56),
              ("20k P=16", 1, 20480, 16, 56),
              ("genome", 24, 36864, sub_gen, 48)]
    kern = phase_kernel(dev, shapes)
    # mixed100k: 4 chromosomes of ~23.7k sites (ladder rung 4, w_seg_p
    # 24576), 1,589 table rows compressed to 32 f32 channels
    sub_mix = _sub_rep_for(SimpleNamespace(n_rows=32, weights=True), 4,
                           24576)
    wshapes = [("mixed100k main path", 4, 24576, sub_mix, 32, 1590),
               ("widest R=104, 8193 rows", 1, 36864, 16, 104, 8193)]
    wkern = phase_wkernel(dev, wshapes)
    r20 = phase_20k(dev)
    if (r20["w_seg_p"], r20["sub_rep"], r20["n_rows"]) != (20480, sub_20k, 56):
        fail(f"20k main path ran at w={r20['w_seg_p']} P={r20['sub_rep']} "
             f"R={r20['n_rows']}, not the shape phase 3 checked")
    rg = phase_genome(dev)
    if rg["stacks"] != [(36864, 22, sub_gen)] or rg["n_rows"] != 48:
        fail(f"genome main path ran at {rg['stacks']} R={rg['n_rows']}, "
             "not the shape phase 3 checked")
    rm = phase_mixed100k(dev)
    if rm["stacks"] != [(24576, 4, sub_mix)] or rm["n_rows"] != 32 \
            or rm["rows_used"] != 1589:
        fail(f"mixed100k main path ran at {rm['stacks']} R={rm['n_rows']} "
             f"rows={rm['rows_used']}, not the shape phase 3c checked")
    chk = phase_check(dev)

    detail = dict(device=name, nvidia_smi=smi, kernel=kern, wkernel=wkern,
                  bench_20k=r20, genome=rg, mixed100k=rm, check=chk)
    (OUT / "smoke.json").write_text(json.dumps(detail, indent=1) + "\n")
    k20, kmix = kern[0], wkern[0]
    log(json.dumps({"kernels": [{
        "name": "onehot_prefix_sums",
        "route": "cuda",
        "source": "fscl_tpu_torch/csrc/prefix_sums.cu",
        "replaces": "fscl_tpu/ops/pallas_ps.py:148 (mode (b), segmented "
                    "one-hot)",
        "launches": r20["launches"],
        "max_abs_err": max(k["max_abs_err"] for k in kern),
        "ms": k20["ms"],
        "plain_ms": k20["plain_ms"],
    }, {
        "name": "weighted_prefix_sums",
        "route": "cuda",
        "source": "fscl_tpu_torch/csrc/weighted_prefix_sums.cu",
        "replaces": "fscl_tpu/ops/pallas_ps.py:148 (mode (c), f32 weight "
                    "channels)",
        "launches": rm["launches"],
        "max_abs_err": max(k["max_abs_err"] for k in wkern),
        "ms": kmix["ms"],
        "plain_ms": kmix["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
