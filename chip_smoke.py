#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fscl_tpu_torch) on one Hopper card.

Phases, each printing its own lines; any failure raises and exits
non-zero:
  1. device  - a CUDA card of capability (9, 0); its name and power limit
  2. build   - nvcc builds the kernels from csrc/, one process per source
               (ptxas report printed); the host's C compiler builds the
               SNP reader's parser (native/fastio.c), its time printed;
               no C compiler fails the run
  3. kernel  - the segmented one-hot prefix-sum kernel (one chained
               scan) against its plain PyTorch version, bitwise, at the
               main path's shapes and at five that stress the chained
               scan (w off the tile, one tile, 24 segments, odd L, L =
               8192 in int16 and int32); two launches, and a launch after
               the 20-launch timing loop, bitwise equal to the first;
               kernel, plain and the cumsum-only yardstick (torch.cumsum
               over the materialised int32 one-hot) timed at the main
               path's shapes
  3c. wkernel - the weighted (compressed-mode) prefix-sum kernel against
               its plain version at the mixed100k shape, the widest one
               and four stress shapes: within 2 float32 ulps of each
               segment's max |prefix|, repeat launches bitwise equal as
               in 3; kernel, plain and the cumsum-only yardstick (over
               the float64 weight stream) timed at the first two
  3a. rkernel - the row-id prefix-sum kernel (mode (a), hist_clr_reps;
               phase 3's chained scan with the row ids as its id source)
               against its plain version, bitwise, at the 20k path's
               shapes and one genome1m chromosome (timed, with the
               cumsum-only yardstick) and at eight stress shapes with ids
               that alias in int16 (r +- 65536, negative ids): W off the
               tile, one tile, under a tile, odd L, L = 8192 in int16 and
               int32, P = 256 at R = 1 (64 KB of staged ids) and W = 0
               (the zero row, no launch); repeat launches as in 3
  3b. pkernel - the permuted single-chromosome prefix-sum kernel (mode
               (b'), _hist_perm_batch; the same chained scan) against its
               plain version, bitwise, at the 20k path's shape and at an
               int32 shape with a chromosome start off a group boundary
               (timed, with the cumsum-only yardstick), and at 3a's
               stress shapes with n < w_pad, starts off a group boundary
               and n = 0; repeat launches as in 3
  3d. gkernel - the row gather (pallas_gather's function) against its
               plain version, bitwise, at the probe's own shape
               (bench/micro_pallas_gather.py: [20481, 128] int16 and
               float32, 65,536 sorted indices); kernel, plain and
               torch.index_select timed.  Its RDP shape (psite [20001,
               56] int32 at one slice's unsorted indices) runs in phase 7
  3e. okernel - the window operand (gather -> difference -> lerp; off the
               path, the yardstick of 3g) against its plain version,
               bitwise (zeros compared without their sign), mm_bf16 off
               and on, on the inputs the main path gives the window
               kernels (bounds and fbar from build_hist_points on the real
               data): the 20k scan (P=1) and stacked slice run in phase 4,
               genome in 5, mixed100k in 5c, an RDP slice in 7, and the
               first chunk of each task's float32 tie stage (captured from
               its scan); both timed
  3f. fkernel - the fused window contraction (window_clr: operand and
               bfloat16 tensor-core contraction in one kernel) against its
               plain version within 2e-4 S + 1e-5 per entry (S = 2 sum_k
               |k t|), at the 20k scan, 20k stacked, genome and mixed100k
               first-chunk inputs of 3e and their whole calls, and at the
               permutation tail's launch shapes (P = 32, R = 48, A = 32,
               NC = 208, 7 and 21 candidates, int32 and int16, synthetic
               rows; phase 5);
               its split count over cells, the launch at one split (the
               kernel unsplit) bitwise equal; kernel, unsplit kernel,
               plain, and two yardsticks timed: window_operand + float32
               matmul and window_operand + bfloat16 matmul (cuBLAS tensor
               cores)
  3g. f32kernel - the float32 window contraction (window_clr_f32: operand
               and 3xTF32 tensor-core contraction in one kernel, split
               over cells on sub-wave grids) against its plain version
               within 1e-5 S + 1e-5 per entry (S in float64), its largest
               error against a float64 contraction at most 4x that of
               window_operand + float32 matmul, two launches bitwise
               equal; at the scan tie stages' own inputs (20k: first chunk
               and whole call; genome and mixed100k: their largest
               chromosome's call), a stacked 20k slice at hist_bf16=False
               and phase 7's RDP slice; kernel, plain and two yardsticks
               timed: window_operand + float32 matmul (the route it
               replaces) and + TF32 matmul (cuBLAS, one TF32 pass)
  3w. wide  - the window kernels' wide variants (128 < R <= 256) at the
               yri_1kg tail's 216 rows against their plain versions as in
               3f and 3g: window_clr at an RDP slice's launch
               (RDP_REP_SUB replicates), at a 16-replicate launch split
               over a cluster and at the scan's P = 1, 128-alpha launch;
               window_clr_f32 at the scan's tie stage (P = 1, 128 alphas,
               826 cells); every launch counted as wide; and 3a at RDP's
               site prefix (one replicate over 14.4M sites, int32)
  4. 20k     - the bench.py task (bench/data/bench_20k.sf, 50
               permutations) through the port's entry points; the
               prefix kernel's launches are counted over this run, and
               over its scan and its permutations the window kernels'
               (the bfloat16 kernel in the scan's dense and refine stages
               and the permutations, the float32 kernel in the scan's tie
               stage, the window operand nowhere); the first chunk's
               statistic is recomputed with the plain prefix function
               (equal), then with the plain window route too (within
               3f's tolerance, exceedance counts on the run's thresholds
               equal off near-ties); the scan again with its tie stage
               through the float32 kernel and through the two-step route
               (window operand + float32 matmul): reported CLRs within
               1e-3, positions and lalpha equal off listed tie-pool
               near-ties
  5. genome  - ~778k sites over 22 chromosomes (bench/headline.py
               gen_genome1m), scan and 64 permutations; window launches
               counted over each; the first chunk recomputed and the scan
               routes compared as in 4
  5c. mixed100k - bench/data/headline_mixed100k.sf (94,889 sites, 31
               depths, 1,589 table rows, compressed tables), scan and 64
               permutations; the weighted kernel's launches are counted
               over this run and the window kernels' over each stage; the
               first chunk's statistic is recomputed with the plain
               prefix function, then with the plain window route too;
               the scan routes compared as in 4
  4b. 20k no-hist - the 20k task through the lattice path (use_hist=False,
               grid 2048, 50 permutations): the lattice kernel's launches
               counted over its scan and over its permutations (each > 0,
               the hist kernels' 0), two runs equal, the first
               permutation chunk recomputed (equal to the run's saved
               nulls) and recomputed with the plain version (maxima within
               1e-3, exceedances on the run's thresholds equal off 1e-4
               near-ties)
  3h. lkernel - the lattice kernel (clr_lattice, csrc/lattice_clr.cu)
               against its plain version within 1e-5 S + 1e-4 per entry
               (S = 2 sum |y - null|), dummy candidates 0, repeat launches
               bitwise, an entry's bits independent of the other
               candidates and replicates of its launch (every 7th
               candidate and the last replicate launched alone; at the
               permutation chunk, a replicate holding the observed
               attributes, the observed call and single candidates), at
               the inputs phase 4b's first run gave it: the scan's dense
               coarse, fine and ultra calls and the first permutation
               chunk's coarse and fine calls; kernel and plain timed, SM
               clocks a pair; and the same at phase 4c's tie-stage calls
               and phase 4d's dense calls and first permutation chunk's
               coarse and fine calls (there the plain version on 64
               candidates)
  4c. 20k grid 1024 - the 20k task's scan at grid 1024, whose tie table
               is coarser than exact_step_max: lattice kernel launches in
               its tie stage (> 0); its coarse, fine and ultra calls
               through phase 3h; the scan again with the plain lattice
               version: reported CLRs within 1e-5 S + 1e-3 (S at the
               reported position and lalpha), positions and lalpha equal
               off listed near-ties (the plain version scores both
               winners within that tolerance)
  4d. big chromosome - 4,193,904 sites of one chromosome simulated in
               memory (120 Mb at 45 sites a kb, depth 50), past the hist
               gate, CLI defaults (windows of 163,841 sites, candidates 1
               kb apart), scan and one chunk of 16 permutations: the gate
               returns None, lattice launches > 0 and hist launches 0 in
               each, reported CLRs within 1e-5 S + 1e-3 of the plain
               version at the reported position and lalpha, the
               permutation chunk recomputed (equal to the run's saved
               nulls) and recomputed with the plain version at 64 points
               as in 4b
  6. check   - a small single-depth input, a small mixed-depth input, the
               single-depth input through --no-hist and a dense-cluster
               input past the hist gate (lattice path, scan and
               permutations), through the card and through the plain CPU
               versions, must agree
  7. rdp     - four routes to the permutation statistic on one stream of
               the 20k task (hist_bf16=False): scan_permute with the RDP
               tail forced on and off (thresholds equal, counts equal off
               1e-4 near-ties, RDP dispatches only under "on"), then one
               chunk of the RDP run recomputed through hist_clr_reps
               (kernel 3a) and _hist_perm_batch (kernel 3b); the phase's
               launches of every kernel are counted (the row gather only
               under RDP on, the float32 window kernel and neither the
               bfloat16 one nor the window operand on these float32
               routes); then the same chunk on the bfloat16 route through
               rdp_clr_reps and hist_clr_reps (bfloat16 kernel only)
  3i. cgkernel - the clr_grid kernel (csrc/clr_grid.cu) against its
               plain version within 1e-5 S + 1e-4 per entry (S = 2 sum
               |y - null|), candidates with lo > hi exactly 0, repeat
               launches and the checked candidates (every 7th where all
               are checked) launched alone bitwise, at the 20k task's
               dense grid (20,400 candidates, whole-chromosome windows)
               with the 11 shared coarse alphas and with each candidate's
               14 fine alphas (the plain version on 64 candidates), at the
               20k scan's reported points with their reported lalpha (A =
               1, the C-parity oracle's call), at the genome1m scan's
               reported points with the coarse alphas (64 checked) and at
               __graft_entry__.py's flagship problem (rebuilt here: 2,048
               sites, 64 candidates, +-600 sites, grid 512; coarse and
               fine alphas); the call and its launches alone, plain and
               the bound (on the work these inputs need, and PR 12's
               count of every pair beside it) timed; the lattice kernel
               at its coarse offsets against this kernel at the lattice's
               alphas (rtol 2e-4, atol 2e-3)
  4e. exact  - two_stage_alpha_max (the reference's 11 + 14 alpha search)
               at the 20k and genome1m scans' reported positions, its
               clr_grid launches counted; the exact CLRs against the
               plain version within 3i's tolerance (every 20k point, 256
               genome1m points), all finite; the gap |reported - exact|
               (max, mean, 99th percentile) and the points where the scan
               reports more than the exact maximum printed, not gated
  8. ms      - the ms pipeline (-m): bench/data/headline_ms_sweep.ms with
               bench/headline.py cfg_ms_sweep's flags (5 Mb segments,
               --ms-folded, 100 permutations): per-block scan and
               permutation walls, point-rounds/s; its first two blocks on
               the card and with the plain CPU versions at hist_bf16=False
               (CLR, thresholds and replicate statistics within 1e-3,
               replicate exceedances equal off 1e-4 near-ties); a
               200-replicate neutral file made from a seed (n = 50, 2,500
               sites, 5 Mb, --ms-folded --max-only): total and median
               block walls and each stage's share (parse, attach_model,
               scan, output); every kernel's launches counted over each
               run
  9. resume  - checkpoint and resume: (a) the 20k task on the hist path
               (bfloat16, 64 permutations at chunks of 16), (b) the same
               at float32 with the RDP tail forced on, (c) the 20k task
               through --no-hist (32 permutations), each run
               uninterrupted and stopped at 16 rounds with a checkpoint,
               then resumed from the file: the break a chunk boundary of
               the uninterrupted run and before any pruning draw, the
               resumed leg launching the path's kernels (the one-hot
               prefix and bfloat16 window kernels; the row gather and
               float32 window kernel; the lattice kernel), permute_n,
               permute_p, permute_finished, stat_threshold and every
               saved null equal bit for bit (or, where the card's bits
               differ, the largest difference and first point printed and
               the counts equal off listed 1e-4 near-ties); (d) genome1m
               (phase 5's scan), 64 permutations with a checkpoint: each
               save's ms and record bytes, the log's size, the saves'
               share of the permutation wall, walls with and without a
               checkpoint in turns beside phase 5's; (e) -m with
               --checkpoint on two blocks of headline_ms_sweep.ms, -p 8
               then -p 16: one file a block, permute_n reaching 16
  10. split  - the split over ranks (fscl_tpu_torch/parallel/) through
               the CLI under torch.distributed.run, every rank on the one
               card (--device cuda:0), one OpenMP thread a rank: (a)
               genome1m (phase 5's sites written to a SNP file), scan and
               64 permutations under two ranks, its TSV and nulldist
               against phase 5's (bitwise, else positions equal,
               reported CLRs within 1e-3 and counts equal off listed
               1e-4 near-ties; which held is printed), 1b and window_clr
               launched on each rank; then one and two ranks with
               --max-only (no output tail projection), untraced for the
               phase walls, split_gather_s and split_gather_bytes, and
               traced (FSCL_TPU_TRACE_DIR) for each rank's device time
               and busy share; (b) the 20k task through --no-hist under
               two ranks against phase 4b's TSV, clr_lattice launched on
               each rank; (c) the 20k task under two ranks broken at 16
               rounds (-p 16 with --checkpoint, a chunk boundary before
               any pruning draw) and resumed to 64 under two ranks and
               under one: the checkpoints' replayed states, TSVs and
               nulldist files equal to the unbroken two-rank run's bit
               for bit; (d) the 20k task in a world of one through
               torch.distributed.run: TSV and nulldist byte for byte the
               plain CLI's.  Inputs, checkpoints and traces go under
               fscl_tpu_torch/build/split/, each launch's stderr to
               OUT/split_<leg>.log
  11. load   - the SNP reader's parsers on phase 10's genome1m.sf
               (777,727 lines) and on phase 4d's chromosome written to a
               file: the C parser (median of 3) and the Python loop
               (once), their chromosome lists and arrays equal, and
               load_snp_input's wall, its sites equal to the phase's
               data; every CLI run of phase 10 logged the C parser (a
               silent fall back to the Python loop fails); the CLI's load
               phase from phase 10's [split] lines; the numbers also as
               one {"host_native": ...} line
  12. stream - the block-permutation stream's kernel (replicate_runs,
               csrc/replicate_runs.cu: fscl_tpu's threefry draw of a
               chunk's runs and sigma) against its plain version, bit for
               bit, in its two forms (sigma, runs), at the 20k chunk
               (32 replicates), genome1m's first chunk (16 of 24,304
               groups, the CLI's default) and deep-tail chunk (2,048),
               phase 4d's chromosome (16 of 131,060) and genome1m at 30
               kb blocks (256 replicates, about 33,000 blocks): a second
               launch and a launch after the timing loop bitwise, the
               kernel alone (a CUDA graph of 20 launches into
               preallocated outputs), the wrapper and the plain version
               timed, the bound on the work these inputs need (bytes
               written and g0f read, or threefry hashes, a counting
               sort's two operations a key and the block ids of the
               starts, the redraws this chunk takes counted); the CLI on
               genome1m.sf at -p 16 -w 0.03 --max-only to its end, its
               first chunk's draw against the plain version's, its
               launches counted; genome1m's 64 permutations (phase
               5's scan) and its deep tail (bench/run_tail.py's 22
               immortal points, 1,024 rounds at chunks of 256 and 512,
               RDP off) each with FSCL_STAT_SPEC 0 and 1: results bit for
               bit equal, the kernel's launches counted over the spec-on
               genome1m run, speculative chunks taken and dropped,
               permutation walls, and from traced runs the busy share and,
               at each speculative chunk boundary, when the next chunk's
               first kernel started against when the drain returned (the
               deep tail must take speculative chunks and show one start
               before its drain returned)
Then one JSON line with every kernel's numbers (time, plain time, bound,
launches on a path of this run, the one-call PyTorch equivalent's time
where there is one; for the fused window kernels also their largest error
over their stated tolerance, and for the float32 one its split reductions
and its float64 error ratio), and last the JSON status line.  Kernel
times are the median of 5 CUDA-event readings, each a mean over its
launches.  Run from the repo root: python3 chip_smoke.py

``--profile`` instead runs phases 1-2 and then torch.profiler over the
scan and the permutations of the 20k task (hist and --no-hist), of the
genome (16 permutations), of mixed100k (16 permutations) and of phase
4d's chromosome (16 permutations), over phase 7's
permutations of the 20k task with RDP forced on and off, and over phase
12's deep tail with speculation on (its chunk boundaries: the next
chunk's first kernel start against the drain's return): device time by
kernel (the prefix-sum kernels, the two fused window kernels, the window
operand, the matmuls, the row gather) and the device's busy share, with
the tables written under OUT, and the one-hot body's launches by id
source; it fails if a three-pass row-id kernel (rtile_*) runs.
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
# peak rates of one H100 SXM at 700 W: HBM bytes/s (NVIDIA's H100
# datasheet); lane operations/s outside the tensor cores, one add,
# compare, select or fused multiply-add a lane a clock: 128 FP32 lanes x
# 132 SMs x 1.98 GHz boost (the Hopper architecture white paper; the
# datasheet's 67 TFLOP/s float32 counts an FMA as two operations, the
# kernels' compares, adds and selects are one each); the float32 FMA
# rate in flops (the datasheet); dense bfloat16 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ = 1.98e9
LANE_OPS_PER_S = 128 * 132 * SM_CLOCK_HZ
FP32_FLOPS_PER_S = 67e12
BF16_MMA_PER_S = 989e12
TF32_MMA_PER_S = 495e12  # dense TF32 tensor-core operations/s
# the fused window contractions against their plain versions: |diff| <=
# REL * S + ABS per entry, S = 2 sum_k |k t|: bfloat16 route (CLR_*),
# float32 route (F32_*, S in float64)
CLR_REL = 2e-4
CLR_ABS = 1e-5
F32_REL = 1e-5
F32_ABS = 1e-5
# the float32 kernel's largest error against a float64 contraction, over
# that of the window operand + float32 torch.matmul route: at most this
F64_RATIO = 4.0
# the scan's reported CLR, new float32 route vs the two-step route
SCAN_CLR_TOL = 1e-3
# (data, tables, scan_cfg, result) of the 20k and genome1m scans (phases 4
# and 5), for phases 3i and 4e
SCANS = {}
# phase 10's single-rank references: phase 5's genome1m and phase 4b's
# 20k --no-hist results after their permutations, and their TSVs
SPLIT_REF = {}
# phase 10's inputs, checkpoints and traces: in the checkout (gitignored,
# not brought back)
SPLIT_WORK = REPO / "fscl_tpu_torch" / "build" / "split"
# phase 11's second input: phase 4d's chromosome
LOAD_INPUTS = {}
# genome1m's CLI load phase with the Python loop, rank 0 of two ranks on
# one NVIDIA H100 80GB HBM3 at 700 W (phase 10; PERF.md, section 5)
LOAD_PYTHON_LOOP_S = 2.23


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters, readings=5):
    """Median over `readings` CUDA-event readings of the mean time of
    `iters` back-to-back calls, after two warm-up calls."""
    import statistics

    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(readings):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return statistics.median(out)


def bound_ms(nbytes, ops):
    """(bound_ms, bound_by): the larger of nbytes over the HBM rate and
    ops, lane operations, over the lane rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / LANE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(tensors_in, tensors_out, ops):
    """bound_ms of every input read once and every output written once."""
    return bound_ms(sum(t.numel() * t.element_size()
                        for t in (*tensors_in, *tensors_out)), ops)


def gathered_bytes(table, idx):
    """Bytes a row gather must read: the distinct rows of table at idx,
    and idx itself."""
    import torch

    rows = torch.unique(idx).numel()
    return (rows * table.shape[1] * table.element_size()
            + idx.numel() * idx.element_size())


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
    """Build the kernels and the SNP parser: the parser's build seconds."""
    from fscl_tpu_torch import kernels
    from fscl_tpu_torch.native import fastio

    t0 = time.monotonic()
    kernels.load()
    log(f"[build] {kernels.library_path().name} in "
        f"{time.monotonic() - t0:.2f}s (nvcc {kernels.build_seconds:.2f}s)")
    for line in kernels.build_log.splitlines():
        if line.strip():
            log(f"[build] {line}")
    t0 = time.monotonic()
    lib = fastio.load()
    if lib is None:
        fail("no C compiler (cc, gcc) on PATH to build the SNP parser "
             "(fscl_tpu_torch/native/fastio.c)")
    parser_s = time.monotonic() - t0
    log(f"[build] {lib.path.name} (the SNP parser, {fastio._compiler()} "
        f"{' '.join(fastio.CC_FLAGS)}) in {parser_s:.2f}s")
    return parser_s


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


def _repeat_checks(tag, label, kern, first, iters=20):
    """Fail unless a second launch, and a launch after a timing loop of
    iters, give first's bits; the loop's time (cuda_time_ms)."""
    import torch

    again = kern()
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        fail(f"{tag} kernel at {label}: two launches differ")
    del again
    ms = cuda_time_ms(kern, iters)
    after = kern()
    torch.cuda.synchronize()
    if not torch.equal(first, after):
        fail(f"{tag} kernel at {label}: the launch after the timing loop "
             "differs from the first")
    return ms


def phase_kernel(dev, shapes, stress):
    """Phase 3: the one-hot kernel vs plain, bitwise, at the main path's
    shapes (timed, with the cumsum-only yardstick) and at shapes that
    stress the chained scan (checked only); everywhere two launches and a
    launch after a 20-launch loop bitwise equal to the first."""
    import numpy as np
    import torch

    from fscl_tpu_torch.ops import prefix_sums as ps

    rng = np.random.default_rng(0)
    out = []
    for label, S, w, P, R in shapes + stress:
        timed = (label, S, w, P, R) in shapes
        table, sig, g0 = (torch.as_tensor(x, device=dev)
                          for x in _prefix_inputs(rng, S, w, P, R))
        kw = dict(w_seg_p=w, n_rows=R)

        def kern():
            return ps.onehot_prefix_sums(table, sig, g0, **kw)

        def plain():
            return ps.onehot_prefix_sums_plain(table, sig, g0, **kw)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            bad = (got.to(torch.int64) - want.to(torch.int64)).abs()
            fail(f"kernel != plain at {label}: {int((bad > 0).sum())} "
                 f"entries differ, max {int(bad.max())}")
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        b_ms, b_by = bound((table, sig, g0), (got,), 2 * got.numel())
        del want
        torch.cuda.empty_cache()
        mb = got.numel() * got.element_size() / 1e6
        rec = dict(label=label, S=S, w=w, P=P, R=R, max_abs_err=err,
                   out_mb=mb, bound_ms=b_ms, bound_by=b_by)
        ms = _repeat_checks("one-hot", label, kern, got)
        del got
        if not timed:
            log(f"[kernel] {label} (stress): S={S} w={w} P={P} R={R} "
                "bitwise equal; repeat launches equal")
            out.append(rec)
            continue
        plain_ms = cuda_time_ms(plain, 5)
        # the scan alone, over the materialised [S, w, P*R] int32 one-hot
        oh = (ps.segment_row_ids(table, sig, g0, w_seg_p=w)[..., None]
              == torch.arange(R, device=dev, dtype=torch.int16))
        oh = oh.to(torch.int32).reshape(S, w, P * R)
        cum_ms = cuda_time_ms(
            lambda: torch.cumsum(oh, 1, dtype=torch.int32), 20)
        del oh
        torch.cuda.empty_cache()
        log(f"[kernel] {label}: S={S} w={w} P={P} R={R} bitwise equal, "
            f"repeat launches equal; kernel {ms:.4f} ms ({mb / ms:.1f} GB/s "
            f"written, {100 * b_ms / ms:.1f}% of bound), plain "
            f"{plain_ms:.4f} ms, cumsum only {cum_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        out.append(dict(rec, ms=ms, plain_ms=plain_ms, cumsum_only_ms=cum_ms))
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


def phase_wkernel(dev, shapes, stress):
    """Phase 3c: weighted kernel vs plain within 2 float32 ulps of each
    segment's max |prefix|, at the main path's shapes (timed, with the
    cumsum-only yardstick) and at shapes that stress the chained scan
    (checked only); two launches and a launch after a 20-launch loop
    bitwise equal to the first."""
    import numpy as np
    import torch

    from fscl_tpu_torch.ops import prefix_sums as ps

    rng = np.random.default_rng(1)
    eps = float(torch.finfo(torch.float32).eps)
    out = []
    for label, S, w, P, R, n_ids in shapes + stress:
        timed = (label, S, w, P, R, n_ids) in shapes
        table, wt, sig, g0 = (torch.as_tensor(x, device=dev) for x in
                              _weighted_inputs(rng, S, w, P, R, n_ids))

        def kern():
            return ps.weighted_prefix_sums(table, wt, sig, g0, w_seg_p=w)

        def plain():
            return ps.weighted_prefix_sums_plain(table, wt, sig, g0,
                                                 w_seg_p=w)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        scale = want.reshape(S, w, -1).abs().amax(1, keepdim=True)
        err = (got - want).abs().reshape(S, w, -1)
        max_abs = float(err.max())
        rel = float((err / scale.clamp_min(1e-30)).max())
        if not bool((err <= 2 * eps * scale).all()):
            fail(f"weighted kernel != plain at {label}: max |err| "
                 f"{max_abs:.4g} = {rel / eps:.3f} ulps of the segment's "
                 "max |prefix| (limit 2)")
        b_ms, b_by = bound((table, wt, sig, g0), (got,), got.numel())
        del want, err, scale
        torch.cuda.empty_cache()
        mb = S * w * P * R * 4 / 1e6
        rec = dict(label=label, S=S, w=w, P=P, R=R, n_ids=n_ids,
                   max_abs_err=max_abs, max_rel_err=rel, out_mb=mb,
                   bound_ms=b_ms, bound_by=b_by)
        ms = _repeat_checks("weighted", label, kern, got)
        del got
        if not timed:
            log(f"[wkernel] {label} (stress): S={S} w={w} P={P} R={R} "
                f"ids={n_ids}; {rel / eps:.3f} ulps of the segment's max "
                "|prefix|; repeat launches equal")
            out.append(rec)
            continue
        plain_ms = cuda_time_ms(plain, 3)
        # the scan alone, over the materialised [S, w, P*R] float64 stream
        ids = ps.segment_row_ids(table, sig, g0, w_seg_p=w).to(torch.int64)
        x = wt.to(torch.float64)[ids].reshape(S, w, P * R)
        del ids
        cum_ms = cuda_time_ms(lambda: torch.cumsum(x, 1), 20)
        del x
        torch.cuda.empty_cache()
        log(f"[wkernel] {label}: S={S} w={w} P={P} R={R} ids={n_ids}; "
            f"max |err| {max_abs:.6g}, max err / segment max |prefix| "
            f"{rel:.4g} ({rel / eps:.3f} ulps), repeat launches equal; "
            f"kernel {ms:.4f} ms ({mb / ms:.1f} GB/s written, "
            f"{100 * b_ms / ms:.1f}% of bound), plain {plain_ms:.4f} ms, "
            f"cumsum only {cum_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        out.append(dict(rec, ms=ms, plain_ms=plain_ms, cumsum_only_ms=cum_ms))
    return out


def _differing(got, want):
    """(entries that differ, max |difference|): integers exactly, floats
    by bit pattern after +0.0 (which maps -0 to +0: a two-term sum that
    starts from +0 may give either zero)."""
    import torch

    if got.dtype.is_floating_point:
        bad = ((got + 0.0).view(torch.int32)
               != (want + 0.0).view(torch.int32))
        diff = (got - want).abs()
    else:
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        bad = diff > 0
    return int(bad.sum()), float(diff.max()) if diff.numel() else 0.0


def _time_pair(tag, label, shape, kern, plain, tensors_in, nbytes=None,
               ops=None, library=None):
    """Check kern() == plain() bitwise, time both (and library(), one
    PyTorch call computing the same function, where given); the phase's
    record.  The bound counts nbytes and ops where given, else every input
    read once and the output written once at 2 operations an entry."""
    import torch

    got, want = kern(), plain()
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{tag} kernel != plain at {label}: {got.dtype} "
             f"{tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    n_bad, err = _differing(got, want)
    if n_bad:
        fail(f"{tag} kernel != plain at {label}: {n_bad} entries differ, "
             f"max {err:.6g}")
    out_bytes = got.numel() * got.element_size()
    if nbytes is None:
        b_ms, b_by = bound(tensors_in, (got,), 2 * got.numel())
    else:
        b_ms, b_by = bound_ms(nbytes + out_bytes, ops)
    mb = out_bytes / 1e6
    dtype = str(got.dtype).replace("torch.", "")
    del got, want
    torch.cuda.empty_cache()
    ms = cuda_time_ms(kern, 20)
    plain_ms = cuda_time_ms(plain, 5)
    lib_ms = cuda_time_ms(library, 20) if library is not None else None
    torch.cuda.empty_cache()
    lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
    log(f"[{tag}] {label}: {shape} {dtype} bitwise equal; kernel "
        f"{ms:.4f} ms ({mb / ms:.1f} GB/s written), plain {plain_ms:.4f} ms"
        f"{lib}, bound {b_ms:.4f} ms ({b_by})")
    return dict(label=label, shape=shape, dtype=dtype, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
                out_mb=mb, bound_ms=b_ms, bound_by=b_by)


def _onehot_cumsum_ms(ids, R):
    """The cumsum-only yardstick of an unsegmented one-hot mode:
    torch.cumsum over the materialised [W, P*R] int32 one-hot of [W, P]
    ids."""
    import torch

    oh = (ids[..., None] == torch.arange(R, device=ids.device,
                                         dtype=ids.dtype))
    oh = oh.to(torch.int32).reshape(ids.shape[0], -1)
    ms = cuda_time_ms(lambda: torch.cumsum(oh, 0, dtype=torch.int32), 20)
    del oh
    torch.cuda.empty_cache()
    return ms


def _rowid_case(tag, label, shape, kern, plain, tensors_in, launched,
                ids=None, R=None):
    """A row-id mode (3a, 3b) at one shape: kern() == plain() bitwise,
    one launch counted by launched() (none at W = 0, where only the zero
    row is written), two launches and a launch after a 20-launch loop
    bitwise equal to the first.  Timed (kernel, plain, and the cumsum-only
    yardstick over ids' one-hot) where ids are given; the record."""
    import torch

    before = launched()
    got = kern()
    n_launch = launched() - before
    want = plain()
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{tag} kernel != plain at {label}: {got.dtype} "
             f"{tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    n_bad, err = _differing(got, want)
    if n_bad:
        fail(f"{tag} kernel != plain at {label}: {n_bad} entries differ, "
             f"max {err:.6g}")
    if n_launch != (got.shape[0] > 1):
        fail(f"{tag} kernel at {label}: {n_launch} launches counted for "
             f"{got.shape[0] - 1} sites")
    b_ms, b_by = bound(tensors_in, (got,), 2 * got.numel())
    mb = got.numel() * got.element_size() / 1e6
    rec = dict(label=label, shape=shape,
               dtype=str(got.dtype).replace("torch.", ""), max_abs_err=err,
               out_mb=mb, bound_ms=b_ms, bound_by=b_by)
    del want
    torch.cuda.empty_cache()
    ms = _repeat_checks(tag, label, kern, got)
    del got
    if ids is None:
        log(f"[{tag}] {label} (stress): {shape} {rec['dtype']} bitwise "
            "equal; repeat launches equal")
        return rec
    plain_ms = cuda_time_ms(plain, 5)
    cum_ms = _onehot_cumsum_ms(ids, R)
    log(f"[{tag}] {label}: {shape} {rec['dtype']} bitwise equal, repeat "
        f"launches equal; kernel {ms:.4f} ms ({mb / ms:.1f} GB/s written, "
        f"{100 * b_ms / ms:.1f}% of bound), plain {plain_ms:.4f} ms, "
        f"cumsum only {cum_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(rec, ms=ms, plain_ms=plain_ms, library_ms=None,
                cumsum_only_ms=cum_ms)


def _aliased_row_ids(rng, P, W, R):
    """[P, W] int32 row ids in [0, R + 2], a fifth of them moved to ids
    that count nowhere: r +- 65536 (r when cast to int16), -1, and the
    int32 extremes."""
    import numpy as np

    ids = rng.integers(0, R + 3, size=(P, W)).astype(np.int64)
    moved = np.stack([ids + 65536, ids - 65536, np.full_like(ids, -1),
                      np.full_like(ids, -2**31), np.full_like(ids, 2**31 - 1)])
    pick = rng.random((P, W)) < 0.2
    which = rng.integers(0, len(moved), (1, P, W))
    return np.where(pick, np.take_along_axis(moved, which, 0)[0],
                    ids).astype(np.int32)


def phase_rkernel(dev, shapes, stress):
    """Phase 3a: the row-id kernel (mode (a)) vs plain, bitwise, at the
    main path's shapes (timed) and at shapes that stress the chained scan
    (ids that alias in int16 among their inputs)."""
    import numpy as np
    import torch

    from fscl_tpu_torch.ops import prefix_sums as ps

    rng = np.random.default_rng(2)
    out = []
    for label, P, W, R in shapes + stress:
        timed = (label, P, W, R) in shapes
        ids = (rng.integers(0, R + 3, size=(P, W)).astype(np.int32)
               if timed else _aliased_row_ids(rng, P, W, R))
        row_rep = torch.as_tensor(ids, device=dev)
        out.append(_rowid_case(
            "rkernel", label, f"P={P} W={W} R={R}",
            lambda: ps.rowid_prefix_sums(row_rep, n_rows=R),
            lambda: ps.rowid_prefix_sums_plain(row_rep, n_rows=R),
            (row_rep,), lambda: ps.rowid_launches,
            ids=row_rep.T if timed else None, R=R))
    return out


def _perm_inputs(rng, W_genome, P, R, w_pad):
    """Thin row-id table of a random genome and a sentinel-padded sigma
    (random group permutations)."""
    import numpy as np
    import torch

    from fscl_tpu_torch.ops.histclr import make_row_index_group_table

    row_cg = rng.integers(0, R + 3, size=W_genome).astype(np.int32)
    G = -(-W_genome // 32)
    sig = np.stack([rng.permutation(G) for _ in range(P)]).astype(np.int32)
    sig = np.concatenate([sig, np.full((P, w_pad // 32 + 2), G, np.int32)], 1)
    table = make_row_index_group_table(torch.as_tensor(row_cg), sentinel=R)
    return table.numpy(), sig


def phase_pkernel(dev, shapes, stress):
    """Phase 3b: the single-chromosome permuted kernel (mode (b')) vs
    plain, bitwise, at the main path's shapes (timed) and at shapes that
    stress the chained scan and the chromosome's geometry."""
    import numpy as np
    import torch

    from fscl_tpu_torch.ops import prefix_sums as ps

    rng = np.random.default_rng(3)
    out = []
    for label, W_genome, start, n, w_pad, P, R in shapes + stress:
        timed = (label, W_genome, start, n, w_pad, P, R) in shapes
        table, sig = (torch.as_tensor(x, device=dev) for x in
                      _perm_inputs(rng, W_genome, P, R, w_pad))
        kw = dict(start=start, n=n, w_pad=w_pad, n_rows=R)
        ids = (ps.perm_row_ids(table, sig, start=start, n=n, w_pad=w_pad)
               if timed else None)
        out.append(_rowid_case(
            "pkernel", label,
            f"start={start} (off {start % 32}) n={n} w_pad={w_pad} P={P} "
            f"R={R}",
            lambda: ps.perm_prefix_sums(table, sig, **kw),
            lambda: ps.perm_prefix_sums_plain(table, sig, **kw),
            (table, sig), lambda: ps.perm_launches, ids=ids, R=R))
    return out


def _gather_case(label, table, idx):
    """Row gather vs plain, bitwise; kernel, plain and index_select
    timed; the bound counts the distinct rows read."""
    import torch

    from fscl_tpu_torch.ops import gather as G

    return _time_pair(
        "gkernel", label,
        f"table {list(table.shape)} {len(idx)} indices",
        lambda: G.row_gather(table, idx),
        lambda: G.row_gather_plain(table, idx), (table, idx),
        nbytes=gathered_bytes(table, idx), ops=0,
        library=lambda: torch.index_select(table, 0, idx))


def phase_gkernel(dev):
    """Phase 3d: the row gather at the probe's shape
    (bench/micro_pallas_gather.py: W=20480, 128 columns, 64k sorted
    indices, its inputs' distribution)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(4)
    out = []
    for dt in (np.int16, np.float32):
        table = torch.as_tensor(
            rng.integers(0, 20000, size=(20481, 128)).astype(dt), device=dev)
        idx = torch.as_tensor(np.sort(rng.integers(0, 20481, size=65536))
                              .astype(np.int32), device=dev)
        out.append(_gather_case(f"probe {np.dtype(dt).name}", table, idx))
    return out


def _window_case(label, ps, bounds, fbar, *, n_rep, n_cells, n_rows,
                 bf16_modes=(False, True)):
    """Window operand vs plain, bitwise, for each mm_bf16 mode; the bound
    counts the distinct bound rows read, bounds, fbar and the operand
    written, and 6 float operations an operand entry."""
    import torch

    from fscl_tpu_torch.ops import gather as G

    kw = dict(n_rep=n_rep, n_cells=n_cells, n_rows=n_rows)
    nbytes = (torch.unique(bounds).numel() * ps.shape[1] * ps.element_size()
              + bounds.numel() * 4 + fbar.numel() * 4)
    ops = 6 * bounds.shape[0] * n_rep * 2 * n_cells * n_rows
    shape = (f"ps {list(ps.shape)} c={bounds.shape[0]} NC={n_cells} "
             f"P={n_rep} R={n_rows} {str(ps.dtype).replace('torch.', '')}")
    out = []
    for bf in bf16_modes:
        out.append(_time_pair(
            "okernel", f"{label}, mm_bf16={bf}", shape,
            lambda: G.window_operand(ps, bounds, fbar, mm_bf16=bf, **kw),
            lambda: G.window_operand_plain(ps, bounds, fbar, mm_bf16=bf,
                                           **kw),
            (), nbytes=nbytes, ops=ops))
    return out


def _operand_chunks(ps, bounds, fbar, *, n_rep, n_cells, n_rows, mm_bf16):
    """The window operand [c_chunk*P, K] f32 from its kernel, a candidate
    chunk (_chunk_rows) at a time, as the two-step route took it."""
    from fscl_tpu_torch.ops import gather as G
    from fscl_tpu_torch.ops.histclr import _chunk_rows

    per = _chunk_rows(n_cells, n_rep, n_rows)
    for c0 in range(0, bounds.shape[0], per):
        yield G.window_operand(ps, bounds[c0:c0 + per], fbar[c0:c0 + per],
                               n_rep=n_rep, n_cells=n_cells, n_rows=n_rows,
                               mm_bf16=mm_bf16)


def _chunked(fn, ps, bounds, fbar, *, n_rep, n_cells, n_rows, n_alpha,
             mm_bf16):
    """[c, P, A]: fn(k) over the operand chunks, concatenated."""
    import torch

    outs = [fn(k) for k in _operand_chunks(
        ps, bounds, fbar, n_rep=n_rep, n_cells=n_cells, n_rows=n_rows,
        mm_bf16=mm_bf16)]
    if not outs:
        return torch.zeros((0, n_rep, n_alpha), device=ps.device)
    return torch.cat(outs).reshape(bounds.shape[0], n_rep, n_alpha)


def _abs_clr(ps, bounds, fbar, t3, *, n_rep, n_cells, n_rows, n_alpha,
             mm_bf16=True):
    """S = 2 sum_k |k t| per entry [c, P, A] of the route mm_bf16 selects
    (its operand from the window-operand kernel; its pack bf16_pack, or
    t3): the scale of that route's tolerance.  It has the signature of
    the statistic's clr_fn."""
    import torch

    from fscl_tpu_torch.ops.window_clr import bf16_pack

    t = (bf16_pack(t3)[:, :n_alpha].float() if mm_bf16 else t3).abs()
    return _chunked(lambda k: 2.0 * torch.matmul(k.abs(), t), ps, bounds,
                    fbar, n_rep=n_rep, n_cells=n_cells, n_rows=n_rows,
                    n_alpha=n_alpha, mm_bf16=mm_bf16)


def _two_step_clr(ps, bounds, fbar, t3, *, n_rep, n_cells, n_rows, n_alpha,
                  mm_bf16=False):
    """The statistic's float32 route as it stood before its fused kernel:
    the window-operand kernel, then 2 * a float32 torch.matmul, a
    candidate chunk at a time; the bfloat16 route as the path runs it.
    It has the signature of the statistic's clr_fn."""
    import torch

    from fscl_tpu_torch.ops.histclr import _clr_from_windows

    kw = dict(n_rep=n_rep, n_cells=n_cells, n_rows=n_rows, n_alpha=n_alpha)
    if mm_bf16:
        return _clr_from_windows(ps, bounds, fbar, t3, mm_bf16=True, **kw)
    return _chunked(lambda k: 2.0 * torch.matmul(k, t3), ps, bounds, fbar,
                    mm_bf16=False, **kw)


def _f64_clr(ps, bounds, fbar, t3, *, n_rep, n_cells, n_rows, n_alpha):
    """(2 k t, S = 2 sum_k |k t|), both [c, P, A] float64, from the
    float32 operand (its kernel) and t3, a candidate chunk at a time."""
    import torch

    t = t3.double()
    refs, sums = [], []
    for k in _operand_chunks(ps, bounds, fbar, n_rep=n_rep, n_cells=n_cells,
                             n_rows=n_rows, mm_bf16=False):
        k = k.double()
        refs.append(2.0 * (k @ t))
        sums.append(2.0 * (k.abs() @ t.abs()))
    shape = (bounds.shape[0], n_rep, n_alpha)
    if not refs:
        return (torch.zeros(shape, dtype=torch.float64, device=ps.device),) * 2
    return torch.cat(refs).reshape(shape), torch.cat(sums).reshape(shape)


def _window_clr_at(ps, bounds, fbar, pack, *, n_rep, n_cells, n_rows,
                   n_alpha, splits):
    """window_clr's kernel through its C entry at the given split count
    over cells."""
    import torch

    from fscl_tpu_torch import kernels
    from fscl_tpu_torch.ops.gather import _DTYPE_CODE

    c = bounds.shape[0]
    out = torch.empty((c, n_rep, n_alpha), dtype=torch.float32,
                      device=ps.device)
    lib = kernels.load()
    rc = lib.fscl_window_clr(
        ps.data_ptr(), bounds.data_ptr(), fbar.data_ptr(), pack.data_ptr(),
        out.data_ptr(), c, n_cells, n_rep, n_rows, ps.shape[0],
        _DTYPE_CODE[ps.dtype], n_alpha, pack.shape[1], splits,
        torch.cuda.current_stream(ps.device).cuda_stream)
    kernels.check(lib, rc, "window_clr")
    return out


def _window_clr_case(label, ps, bounds, fbar, *, n_rep, n_cells, n_rows,
                     t3, n_alpha, iters=20):
    """Phase 3f: the fused window contraction vs its plain version within
    CLR_REL * S + CLR_ABS per entry, and its split count over cells, the
    launch at one split bitwise equal; kernel, the kernel at one split
    (unsplit), plain and two yardsticks timed: window_operand + float32
    matmul (the two-step route it replaces) and window_operand + bfloat16
    matmul (cuBLAS's tensor cores, bfloat16 output), both a candidate
    chunk (_chunk_rows) at a time as the float32 route takes them.  The
    bound is the larger of
    the bytes (the distinct bound rows read, bounds, fbar, the bfloat16
    pack and the output) over the HBM rate and the operations (the MMA's
    2 c P K A at the bfloat16 tensor-core rate plus 6 float operations
    per operand entry at the float32 rate)."""
    import torch

    from fscl_tpu_torch.ops import gather as G
    from fscl_tpu_torch.ops import window_clr as W
    from fscl_tpu_torch.ops.histclr import _chunk_rows

    kw = dict(n_rep=n_rep, n_cells=n_cells, n_rows=n_rows)
    pack = W.bf16_pack(t3)
    t3m = pack[:, :n_alpha].float().contiguous()
    t3b = pack[:, :n_alpha].contiguous()
    per = _chunk_rows(n_cells, n_rep, n_rows)
    chunks = [(bounds[c0:c0 + per], fbar[c0:c0 + per])
              for c0 in range(0, bounds.shape[0], per)]

    def kern():
        return W.window_clr(ps, bounds, fbar, pack, n_alpha=n_alpha, **kw)

    def unsplit():
        return _window_clr_at(ps, bounds, fbar, pack, n_alpha=n_alpha,
                              splits=1, **kw)

    def plain():
        return W.window_clr_plain(ps, bounds, fbar, pack, n_alpha=n_alpha,
                                  **kw)

    def two_step_f32():
        return [2.0 * torch.matmul(G.window_operand(
            ps, b, f, mm_bf16=True, **kw), t3m) for b, f in chunks]

    def two_step_bf16():
        return [torch.matmul(G.window_operand(
            ps, b, f, mm_bf16=True, **kw).to(torch.bfloat16), t3b)
            for b, f in chunks]

    splits = W.window_clr_splits(bounds.shape[0] * n_rep, n_cells=n_cells,
                                 n_rows=n_rows, n_alpha=n_alpha,
                                 device=ps.device)
    got, want = kern(), plain()
    lim = CLR_REL * _abs_clr(ps, bounds, fbar, t3, n_alpha=n_alpha,
                             **kw) + CLR_ABS
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"fkernel at {label}: {tuple(got.shape)} vs plain "
             f"{tuple(want.shape)}")
    if not torch.equal(unsplit().view(torch.int32), got.view(torch.int32)):
        fail(f"fkernel at {label}: the launch at {splits} splits differs "
             "from the launch at one, bit for bit")
    err = (got - want).abs()
    max_err, ratio = float(err.max()), float((err / lim).max())
    if not bool((err <= lim).all()):
        fail(f"fkernel != plain at {label}: max |err| {max_err:.6g}, "
             f"{ratio:.3g} x the tolerance {CLR_REL} S + {CLR_ABS}")
    c, P, A = got.shape
    K = 2 * n_cells * n_rows
    nbytes = (torch.unique(bounds).numel() * ps.shape[1] * ps.element_size()
              + bounds.numel() * 4 + fbar.numel() * 4 + K * A * 2
              + got.numel() * 4)
    mma, lerp = 2 * c * P * K * A, 6 * c * P * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (mma / BF16_MMA_PER_S + lerp / LANE_OPS_PER_S) * 1e3
    b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                  else (t_ops, "operations"))
    del got, want, err, lim
    torch.cuda.empty_cache()
    ms = cuda_time_ms(kern, iters)
    unsplit_ms = cuda_time_ms(unsplit, iters) if splits > 1 else ms
    plain_ms = cuda_time_ms(plain, max(1, iters // 4))
    f32_ms = cuda_time_ms(two_step_f32, iters)
    bf16_ms = cuda_time_ms(two_step_bf16, iters)
    torch.cuda.empty_cache()
    shape = (f"ps {list(ps.shape)} c={c} NC={n_cells} P={P} R={n_rows} "
             f"A={A} {str(ps.dtype).replace('torch.', '')}, "
             f"{(c * P + 63) // 64} blocks of 64 rows x {splits} splits")
    log(f"[fkernel] {label}: {shape}; max |err| {max_err:.4g} "
        f"({ratio:.3g} x tolerance); kernel {ms:.4f} ms (unsplit "
        f"{unsplit_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, window_operand + f32 matmul {f32_ms:.4f} ms, "
        f"+ bf16 matmul {bf16_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{nbytes / 1e6:.2f} MB, {mma / 1e9:.3f} GFLOP MMA)")
    return dict(label=label, shape=shape, splits=splits, ms=ms,
                unsplit_ms=unsplit_ms, plain_ms=plain_ms,
                two_step_f32_ms=f32_ms, two_step_bf16_ms=bf16_ms,
                library_ms=None, max_abs_err=max_err,
                max_err_over_tol=ratio, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, mma_ops=mma, lerp_ops=lerp)


def _tail_window_inputs(dev, c, dtype, *, seed, rows=61440, P=32, R=48,
                        A=32, NC=208):
    """Phase 3f's inputs at the permutation tail's launch shape: one-hot
    prefix rows of a 61,440-row slab (a chromosome of the Perlegen
    genome's median length) for a 32-replicate slice at depth 48, in
    `dtype` (int16 wrapped past 32,767 as the stacked slab's may be, or
    int32); c candidates, each side walking NC cells from its split point
    over about a quarter of the slab, some empty (fbar 0.5); a
    [2*NC*R, A] float32 pack."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, R, (rows, P), generator=g, device=dev)
    ps = torch.zeros((rows, P, R), dtype=torch.int32, device=dev)
    ps.scatter_(2, ids[:, :, None], 1)
    ps = ps.cumsum(0, dtype=torch.int32).reshape(rows, P * R)
    if dtype == torch.int16:
        ps = (ps + 32000).to(torch.int16)  # wrapped mod 2^16
    step = rows // (4 * NC)
    sp = torch.randint(rows // 3, 2 * rows // 3, (c, 1), generator=g,
                       device=dev)
    walk = torch.randint(0, 2 * step + 1, (c, 2, NC), generator=g,
                         device=dev).cumsum(2)
    edges = torch.stack([(sp - walk[:, 0]).clamp_min(0),
                         (sp + walk[:, 1]).clamp_max(rows - 1)], 1)
    bounds = torch.cat([sp[:, None].expand(c, 2, 1), edges],
                       2).to(torch.int32).contiguous()
    fbar = torch.rand((c, 2, NC), generator=g, device=dev)
    fbar[:, :, -2:] = torch.tensor([0.0, 1.0], device=dev)
    fbar = torch.where(bounds[:, :, 1:] == bounds[:, :, :-1], 0.5,
                       fbar).contiguous()
    t3 = 3.0 * torch.randn((2 * NC * R, A), generator=g, device=dev)
    return dict(ps=ps, bounds=bounds, fbar=fbar, n_rep=P, n_cells=NC,
                n_rows=R, t3=t3, n_alpha=A)


def _tail_window_cases(dev):
    """Phase 3f at the permutation tail's launch shapes: a stack of one and
    of three chromosomes' 7 positions, in int32 (most of the tail's
    launches) and int16."""
    import torch

    return [_window_clr_case(
        f"tail launch, {c} candidates, {str(dt).replace('torch.', '')}",
        **_tail_window_inputs(dev, c, dt, seed=c))
        for c, dt in ((7, torch.int32), (21, torch.int32),
                      (7, torch.int16))]


# rows of one replicate in the yri_1kg genome's site prefix: its 14.4M
# sites after the K >= 2 filter (portbench/configs/yri_1kg.json)
YRI_SITES = 14_400_000
YRI_ROWS = 216  # its exact one-hot tables: 214 rows of depth 216, padded


def phase_wide(dev):
    """Phase 3w: the kernels at the yri_1kg tail's 216 table rows.  3f
    (window_clr, its wide variant) at an RDP slice's launch (RDP_REP_SUB
    replicates, the candidates of one _chunk_rows chunk, 208 cells, 32
    alphas), at a first chunk's 16-replicate launch of one position's
    candidates (split over a cluster) and at the scan's P = 1, 128-alpha
    launch; 3g (window_clr_f32, its wide variant) at the scan's tie stage
    (P = 1, 128 alphas, 826 cells at decimation 2).  Every launch of
    each case counted as wide, the counters zeroed before it.  3a (the
    row-id kernel) at RDP's site prefix: one replicate over the whole
    genome, int32, bitwise its plain version, repeat launches equal,
    timed."""
    import numpy as np
    import torch

    from fscl_tpu_torch.engine import permute as TP
    from fscl_tpu_torch.ops import histclr as H
    from fscl_tpu_torch.ops import prefix_sums as ps
    from fscl_tpu_torch.ops import window_clr as W

    R, NC = YRI_ROWS, 208
    c_rdp = min(H._chunk_rows(NC, TP.RDP_REP_SUB, R), 22 * 7)
    bf16 = [("yri RDP slice", c_rdp, TP.RDP_REP_SUB, 32, NC, 12288, True),
            ("yri first chunk, one position", 7, 16, 32, NC, 61440, True),
            ("yri scan", 300, 1, 128, NC, 61440, False)]
    fkern = []
    for label, c, P, A, nc, rows, must_split in bf16:
        inp = _tail_window_inputs(dev, c, torch.int32, seed=c + P, rows=rows,
                                  P=P, R=R, A=A, NC=nc)
        splits = W.window_clr_splits(c * P, n_cells=nc, n_rows=R, n_alpha=A,
                                     device=dev)
        if must_split and splits <= 1:
            fail(f"wide: {label} ({c * P} rows, A={A}) is not split over "
                 "a cluster")
        _zero_window_counts()
        fkern.append(_window_clr_case(f"{label}, R={R}, int32", **inp))
        n = _window_counts()
        if not (n["window_clr"] > 0
                and n["window_clr_wide"] == n["window_clr"]
                and n["window_clr_split"] == n["window_clr"] * (splits > 1)):
            fail(f"wide: {label}: launches counted {n}")
        del inp
        torch.cuda.empty_cache()
    inp = _tail_window_inputs(dev, 64, torch.int32, seed=826, rows=61440,
                              P=1, R=R, A=128, NC=826)
    _zero_window_counts()
    f32kern = [_window_clr_f32_case(f"yri scan tie stage, R={R}, int32",
                                    **inp, iters=5)]
    n = _window_counts()
    if not (n["window_clr_f32"] > 0
            and n["window_clr_f32_wide"] == n["window_clr_f32"]):
        fail(f"wide: yri tie stage: launches counted {n}")
    del inp
    torch.cuda.empty_cache()
    log(f"[wide] window kernels at R={R}: every launch wide")

    rng = np.random.default_rng(216)
    row = torch.as_tensor(rng.integers(0, R + 1, YRI_SITES, dtype=np.int32),
                          device=dev)
    label = f"yri site prefix, P=1 W={YRI_SITES} R={R}"

    def kern():
        return H.build_site_prefix(row, n_rows=R)

    before = ps.rowid_launches
    got = kern()
    n_launch = ps.rowid_launches - before
    # the plain version's one-hot and cumsum hold 40 GB beside the
    # kernel's 12.4 GB: compared with torch.equal, nothing more is made
    same = torch.equal(got, ps.rowid_prefix_sums_plain(
        row[None], n_rows=R, out_dtype=torch.int32))
    torch.cuda.empty_cache()
    if got.dtype != torch.int32 or not same or n_launch != 1:
        fail(f"rkernel at {label}: {got.dtype}, bitwise equal to plain "
             f"{same}, {n_launch} launches")
    ms = _repeat_checks("rkernel", label, kern, got)
    b_ms, b_by = bound((row,), (got,), 2 * got.numel())
    mb = got.numel() * 4 / 1e6
    del got
    torch.cuda.empty_cache()
    log(f"[rkernel] {label}: int32 bitwise equal, repeat launches equal; "
        f"kernel {ms:.4f} ms ({mb / ms:.1f} GB/s written, "
        f"{100 * b_ms / ms:.1f}% of bound), bound {b_ms:.4f} ms ({b_by})")
    rec = dict(label=label, shape=f"P=1 W={YRI_SITES} R={R}", dtype="int32",
               max_abs_err=0.0, out_mb=mb, bound_ms=b_ms, bound_by=b_by,
               ms=ms)
    del row
    torch.cuda.empty_cache()
    return dict(fkernel=fkern, f32kernel=f32kern, rkernel=[rec])


def _window_clr_f32_case(label, ps, bounds, fbar, *, n_rep, n_cells, n_rows,
                         t3, n_alpha, iters=20):
    """Phase 3g: the float32 window contraction (window_clr_f32) vs its
    plain version within F32_REL * S + F32_ABS per entry (S in float64);
    its largest error against a float64 contraction at most F64_RATIO x
    that of the two-step route (window_operand + float32 torch.matmul, the
    route it replaces); two launches bitwise equal.  Timed: kernel, plain,
    the two-step route, and window_operand + TF32 torch.matmul (cuBLAS,
    one TF32 pass: for speed only).  The bound is the larger of the bytes
    (the distinct bound rows read, bounds, fbar, the float32 pack and the
    output) over the HBM rate and the operations (3 MMAs of 2 c P K A at
    the TF32 tensor-core rate, 3xTF32, plus 6 float operations per operand
    entry at the float32 rate); the FFMA bound is 2 c P K A at the float32
    rate."""
    import torch

    from fscl_tpu_torch.ops import window_clr as W

    kw = dict(n_rep=n_rep, n_cells=n_cells, n_rows=n_rows, n_alpha=n_alpha)
    pack = W.f32_pack(t3)
    c, P, A = bounds.shape[0], n_rep, n_alpha
    M, K = c * P, 2 * n_cells * n_rows
    splits = W.window_clr_f32_splits(M, n_cells=n_cells, n_rows=n_rows,
                                     n_alpha=A, device=ps.device)

    def kern():
        return W.window_clr_f32(ps, bounds, fbar, pack, **kw)

    def plain():
        return W.window_clr_f32_plain(ps, bounds, fbar, pack, **kw)

    def two_step_f32():
        return _two_step_clr(ps, bounds, fbar, t3, mm_bf16=False, **kw)

    def two_step_tf32():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return two_step_f32()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    torch.backends.cuda.matmul.allow_tf32 = False
    got, again, want, mm = kern(), kern(), plain(), two_step_f32()
    ref, s = _f64_clr(ps, bounds, fbar, t3, **kw)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"f32kernel at {label}: {tuple(got.shape)} vs plain "
             f"{tuple(want.shape)}")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        fail(f"f32kernel at {label}: two launches differ")
    lim = F32_REL * s + F32_ABS
    err = (got.double() - want.double()).abs()
    max_err, ratio = float(err.max()), float((err / lim).max())
    if not bool((err <= lim).all()):
        fail(f"f32kernel != plain at {label}: max |err| {max_err:.6g}, "
             f"{ratio:.3g} x the tolerance {F32_REL} S + {F32_ABS}")
    e64 = float((got.double() - ref).abs().max())
    e64_mm = float((mm.double() - ref).abs().max())
    if e64 > F64_RATIO * e64_mm:
        fail(f"f32kernel at {label}: max |kernel - float64| {e64:.4g} is "
             f"over {F64_RATIO} x that of the float32 matmul route "
             f"({e64_mm:.4g})")
    nbytes = (torch.unique(bounds).numel() * ps.shape[1] * ps.element_size()
              + bounds.numel() * 4 + fbar.numel() * 4 + K * A * 4
              + got.numel() * 4)
    mma, lerp = 2 * M * K * A, 6 * M * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * mma / TF32_MMA_PER_S + lerp / LANE_OPS_PER_S) * 1e3
    b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                  else (t_ops, "operations"))
    ffma_ms = mma / FP32_FLOPS_PER_S * 1e3
    pack_read = -(-M // 64) * K * pack.shape[1] * 4  # every block of rows
    del got, again, want, mm, ref, s, err, lim
    torch.cuda.empty_cache()
    ms = cuda_time_ms(kern, iters)
    plain_ms = cuda_time_ms(plain, max(1, iters // 4))
    f32_ms = cuda_time_ms(two_step_f32, iters)
    tf32_ms = cuda_time_ms(two_step_tf32, iters)
    torch.cuda.empty_cache()
    shape = (f"ps {list(ps.shape)} c={c} NC={n_cells} P={P} R={n_rows} "
             f"A={A} {str(ps.dtype).replace('torch.', '')}, "
             f"{-(-M // 64)} blocks of 64 rows x {splits} splits")
    log(f"[f32kernel] {label}: {shape}; max |err| {max_err:.4g} "
        f"({ratio:.3g} x tolerance); vs float64 {e64:.4g}, f32 matmul route "
        f"{e64_mm:.4g} (ratio {e64 / max(e64_mm, 1e-300):.3g}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, window_operand + f32 matmul "
        f"{f32_ms:.4f} ms, + tf32 matmul {tf32_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, {mma / 1e9:.3f} "
        f"GFLOP x 3 MMA), FFMA bound {ffma_ms:.4f} ms, pack read "
        f"{pack_read / 1e6:.1f} MB")
    return dict(label=label, shape=shape, c=c, P=P, NC=n_cells, R=n_rows,
                A=A, splits=splits, ms=ms, plain_ms=plain_ms,
                two_step_f32_ms=f32_ms, two_step_tf32_ms=tf32_ms,
                library_ms=None, max_abs_err=max_err,
                max_err_over_tol=ratio, err_f64=e64, err_f64_matmul=e64_mm,
                bound_ms=b_ms, bound_by=b_by, ffma_bound_ms=ffma_ms,
                bytes=nbytes, pack_bytes_read=pack_read, mma_ops=mma,
                lerp_ops=lerp)


def _first_slice_window(ps, bounds, fbar, ht, P, whole=False):
    """The window kernels' inputs at the first launch of a statistic call:
    the first candidate chunk of the float32 route (window_operand), or
    with whole the call's every candidate (window_clr's launch)."""
    from fscl_tpu_torch.ops.histclr import _chunk_rows

    c = bounds.shape[0] if whole else _chunk_rows(ht.n_cells, P, ht.n_rows)
    return dict(ps=ps, bounds=bounds[:c].contiguous(),
                fbar=fbar[:c].contiguous(), n_rep=P, n_cells=ht.n_cells,
                n_rows=ht.n_rows)


def _scan_window_inputs(data, tables, scan_cfg, dev):
    """The dense scan stage's window-operand inputs on the first
    chromosome: its single-replicate prefix, and bounds and fbar of its
    fine-grid candidates on the selection tables, and those tables."""
    from types import SimpleNamespace

    from fscl_tpu_torch.engine.scan import (
        _chrom_scan_ps, _dataset_mod16, chromosome_candidates,
        get_hist_device_arrays, make_scan_hist_tables,
    )
    from fscl_tpu_torch.ops.histclr import build_hist_points

    ht = make_scan_hist_tables(data, tables, scan_cfg.hist_alphas,
                               decimate=scan_cfg.hist_decimate,
                               device=dev)
    cl = data.chr_limits[0]
    st = SimpleNamespace(cl=cl, pos_np=data.pos[
        cl.start_index:cl.start_index + cl.n_snps])
    cand, valid, _, _ = chromosome_candidates(cl, scan_cfg)
    hp = build_hist_points(
        ht, st.pos_np, cand[valid], scan_cfg.eval_range, cand_pad=1,
        device_arrays=get_hist_device_arrays(data, ht, st.pos_np,
                                             cl.start_index))
    ps = _chrom_scan_ps(data, ht, st, _dataset_mod16(data, ht))
    return (_first_slice_window(ps, hp.bounds, hp.fbar, ht, 1),
            _first_slice_window(ps, hp.bounds, hp.fbar, ht, 1, whole=True),
            ht)


def _scan_tie(data, tables, scan_cfg, dev, clr_fn, keep_inputs):
    """scan_genome with its float32 tie stage through clr_fn: (result,
    calls, pools).  calls: per tie-stage call (one per chromosome, in
    order) its CLR [C, A] and lalpha grid on the host, and with
    keep_inputs the call's inputs (ps, bounds, fbar, t3 and the sizes);
    pools: (chromosome, candidate positions, owners) per call."""
    import numpy as np
    import torch

    from fscl_tpu_torch.engine import scan as S
    from fscl_tpu_torch.ops.histclr import hist_clr_reps_ps

    calls, pools = [], []
    orig_max, orig_report = S._fused_max, S._report_pool_max

    def fused_max(t3, bounds, fbar, ps, lalpha, *, n_cells, n_rows, n_alpha,
                  mm_bf16=False):
        kw = dict(n_cells=n_cells, n_rows=n_rows, n_alpha=n_alpha)
        if mm_bf16:
            return orig_max(t3, bounds, fbar, ps, lalpha, mm_bf16=True, **kw)
        clr = hist_clr_reps_ps(t3, bounds, fbar, ps, n_rep=1, clr_fn=clr_fn,
                               **kw)[0]
        call = dict(clr=clr.cpu().numpy(), lalpha=lalpha.double().cpu().numpy())
        if keep_inputs:
            call["inputs"] = dict(ps=ps, bounds=bounds, fbar=fbar, t3=t3,
                                  n_rep=1, **kw)
        calls.append(call)
        best, a = torch.max(clr, dim=1)
        return torch.stack([best, lalpha[a]])

    def report(st, cand, clr, la):
        pools.append((st.c, np.array(cand), np.array(st.owner_x)))
        return orig_report(st, cand, clr, la)

    S._fused_max, S._report_pool_max = fused_max, report
    try:
        result = S.scan_genome(data, tables, scan_cfg, device=dev)
        torch.cuda.synchronize()
    finally:
        S._fused_max, S._report_pool_max = orig_max, orig_report
    return result, calls[len(calls) - len(pools):], pools


def _check_scan_routes(label, data, tables, scan_cfg, dev):
    """The scan with its tie stage through the fused float32 kernel and
    through the two-step route (window operand + float32 matmul): every
    interval's reported CLR within SCAN_CLR_TOL; sweep position and lalpha
    equal except at tie-pool near-ties, listed: an interval whose two
    winners' CLRs, both read from the new route's tie-stage CLRs, lie
    within the largest difference observed between the routes' tie-stage
    CLRs.  Returns (summary, the new route's tie-stage calls with their
    inputs)."""
    import numpy as np

    from fscl_tpu_torch.ops.histclr import _clr_from_windows

    new, calls, pools = _scan_tie(data, tables, scan_cfg, dev,
                                  _clr_from_windows, True)
    old, calls_o, pools_o = _scan_tie(data, tables, scan_cfg, dev,
                                      _two_step_clr, False)
    if not pools or len(pools) != len(pools_o) or any(
            a[0] != b[0] or not np.array_equal(a[1], b[1])
            or not np.array_equal(a[2], b[2]) for a, b in zip(pools, pools_o)):
        fail(f"{label}: the two routes' scans evaluated different tie pools")
    d_clr = float(np.abs(new.clr - old.clr).max())
    if d_clr > SCAN_CLR_TOL:
        fail(f"{label}: scan CLR of the fused float32 kernel and of the "
             f"two-step route differ by {d_clr:.4g} (limit {SCAN_CLR_TOL})")
    d_tie = max(float(np.abs(a["clr"] - b["clr"]).max())
                for a, b in zip(calls, calls_o))
    idx = np.zeros(new.n_points, np.int64)  # interval index per chromosome
    for c in np.unique(new.chr_id):
        idx[new.chr_id == c] = np.arange(int((new.chr_id == c).sum()))
    by_chr = {c: i for i, (c, _, _) in enumerate(pools)}
    near = []
    for i in np.nonzero((new.sweep_pos != old.sweep_pos)
                        | (new.lalpha != old.lalpha))[0]:
        j = by_chr[int(new.chr_id[i])]
        _, cand, owner = pools[j]
        clr, la = calls[j]["clr"], calls[j]["lalpha"]

        def at(res):
            k = np.nonzero((owner == idx[i]) & (cand == res.sweep_pos[i]))[0]
            a = int(np.argmin(np.abs(la - res.lalpha[i])))
            return float(clr[k, a].max())

        gap = at(new) - at(old)
        if not 0.0 <= gap <= d_tie:
            fail(f"{label}: interval {i} reports (pos, lalpha) "
                 f"({new.sweep_pos[i]}, {new.lalpha[i]:.4f}) against the "
                 f"two-step route's ({old.sweep_pos[i]}, "
                 f"{old.lalpha[i]:.4f}), {gap:.4g} apart in CLR: not a "
                 f"near-tie (largest tie-stage difference {d_tie:.4g})")
        near.append(dict(interval=int(i), chr=int(new.chr_id[i]),
                         pos=(int(new.sweep_pos[i]), int(old.sweep_pos[i])),
                         lalpha=(float(new.lalpha[i]), float(old.lalpha[i])),
                         clr_gap=gap))
    n_cand = sum(len(p[1]) for p in pools)
    log(f"[{label}] scan routes: {new.n_points} intervals, tie stage "
        f"{len(pools)} calls, {n_cand} candidates; reported CLR max |diff| "
        f"{d_clr:.4g} (limit {SCAN_CLR_TOL}); tie-stage CLR max |diff| "
        f"{d_tie:.4g}; position or lalpha differ at {len(near)} near-ties "
        f"{near}")
    return (dict(intervals=new.n_points, tie_calls=len(pools),
                 tie_candidates=n_cand, max_clr_diff=d_clr,
                 max_tie_clr_diff=d_tie, near_ties=near),
            [c["inputs"] for c in calls])


def _tie_first_chunk(call):
    """A tie-stage call's first candidate chunk of the two-step route."""
    from fscl_tpu_torch.ops.histclr import _chunk_rows

    c = _chunk_rows(call["n_cells"], 1, call["n_rows"])
    return dict(call, bounds=call["bounds"][:c].contiguous(),
                fbar=call["fbar"][:c].contiguous())


def _operand_args(call):
    """A statistic call's inputs as _window_case takes them."""
    return {k: call[k] for k in ("ps", "bounds", "fbar", "n_rep", "n_cells",
                                 "n_rows")}


def _plain_prefix(table, sig, seg_g0, *, w_seg_p, n_rows, weights=None):
    """build_prefix_sums_seg with the plain versions of both kernels."""
    from fscl_tpu_torch.ops import prefix_sums as ps

    if weights is None:
        return ps.onehot_prefix_sums_plain(table, sig, seg_g0,
                                           w_seg_p=w_seg_p, n_rows=n_rows)
    return ps.weighted_prefix_sums_plain(table, weights, sig, seg_g0,
                                         w_seg_p=w_seg_p)


def _first_chunk(data, tables, result, scan_cfg, perm_cfg, dev):
    """The first chunk's null maxima of every stack with the kernels, with
    the plain prefix function, and with the plain prefix function and
    the plain window route: [(kernels, plain prefix, both plain, scale,
    point ids)] per stack, scale the null maxima of S = 2 sum_k |k t|
    on the bfloat16 route (None on the float32 route); and the window
    inputs at the first stack's first slice (its prefix from the kernel,
    as the path builds it): its first candidate chunk, and all of its
    candidates."""
    import numpy as np
    import torch

    from fscl_tpu_torch.engine.permute import active_by_chr, setup_hist
    from fscl_tpu_torch.ops.histclr import (
        _clr_from_windows_plain, build_prefix_sums_seg,
    )
    from fscl_tpu_torch.ops.permute import block_permutation_groups

    fresh = copy.deepcopy(result)
    hs = setup_hist(data, tables, fresh, scan_cfg, perm_cfg, dev)
    every = np.ones(fresh.n_points, bool)
    sigma, firsts, win = None, [], None
    for st in hs.stacks:
        st.rebuild(fresh, active_by_chr(fresh, st, every))
        rp = -(-perm_cfg.chunk_replicates // st.sub_rep) * st.sub_rep
        if sigma is None:
            sigma = hs.pad_sigma(block_permutation_groups(
                perm_cfg.seed, data.genome_pos(),
                perm_cfg.scan_width_mb * 1e6, rp, device=dev))
        a = st.stat(hs.table, sigma[:rp], perm_cfg)
        b = st.stat(hs.table, sigma[:rp], perm_cfg, prefix_fn=_plain_prefix)
        c = st.stat(hs.table, sigma[:rp], perm_cfg, prefix_fn=_plain_prefix,
                    clr_fn=_clr_from_windows_plain)
        scale = st.stat(hs.table, sigma[:rp], perm_cfg,
                        prefix_fn=_plain_prefix, clr_fn=_abs_clr)
        torch.cuda.synchronize()
        firsts.append((a, b, c, scale, st.pts))
        if win is None:
            sig = sigma[:st.sub_rep]
            ps = build_prefix_sums_seg(
                hs.table, sig, st.seg_g0, w_seg_p=st.w_seg_p,
                n_rows=hs.ht.n_rows, weights=hs.ht.weights)
            win = (_first_slice_window(ps, st.bounds, st.fbar, hs.ht,
                                       sig.shape[0]),
                   _first_slice_window(ps, st.bounds, st.fbar, hs.ht,
                                       sig.shape[0], whole=True))
    return hs, firsts, win


def _check_plain_window(firsts, result, label, bf16):
    """The plain window route gives the statistic the kernels give, within
    its route's tolerance (CLR_* for the bfloat16 kernel, F32_* for the
    float32 one) of S, the largest 2 sum_k |k t| of the entries a null
    maximum takes, and its exceedances on the run's thresholds equal
    except for replicates within that tolerance of their threshold.
    Counted: the (replicate, point) entries whose exceedance differs, and
    those within the tolerance, and within the largest observed
    difference, of their threshold."""
    import torch

    rel, ab = (CLR_REL, CLR_ABS) if bf16 else (F32_REL, F32_ABS)
    worst, n, flips, near_tol, near_obs = 0.0, 0, 0, 0, 0
    for _, b, c, scale, pts in firsts:
        d = (b - c).abs()
        dmax = float(d.max()) if d.numel() else 0.0
        worst = max(worst, dmax)
        lim = rel * scale + ab
        if not bool((d <= lim).all()):
            fail(f"{label}: first-chunk null_max of the fused window kernel "
                 f"and of the plain route differ by {dmax:.4g}, "
                 f"{float((d / lim).max()):.3g} x the tolerance")
        thr = torch.as_tensor(result.stat_threshold[pts], dtype=torch.float32,
                              device=c.device)[None, :]
        flip = (b >= thr) != (c >= thr)
        off = (c - thr).abs()
        if bool((flip & (off > lim)).any()):
            fail(f"{label}: first-chunk exceedances differ between the fused "
                 "window kernel and the plain route off the near-ties")
        n += flip.numel()
        flips += int(flip.sum())
        near_tol += int((off <= lim).sum())
        near_obs += int((off <= dmax).sum())
    log(f"[{label}] first chunk: null_max of the fused window kernel "
        f"({'bfloat16' if bf16 else 'float32'}) vs the plain route max "
        f"|diff| {worst:.4g} (within {rel} S + {ab}); exceedances differ on "
        f"{flips} of {n} (replicate, point) entries; {near_tol} lie within "
        f"the tolerance of their threshold, {near_obs} within the largest "
        f"observed difference")
    return dict(max_abs_diff=worst, entries=n, flips=flips,
                near_tol=near_tol, near_observed=near_obs)


def _run_main_path(data, tables, scan_cfg, perm_cfg, dev, tsv, label):
    """Scan, permutations and output; (result, scan s, permutation s,
    launches).  The launches of the window kernels are counted over the
    scan and over the permutations: the bfloat16 kernel must run in the
    scan (its dense and refine stages) and in the permutations at
    hist_bf16=True, the float32 kernel in the scan (its tie stage) and in
    the permutations at hist_bf16=False, the window operand nowhere, and
    neither wide variant (the smoke's main paths have at most 128 rows)."""
    import torch

    from fscl_tpu_torch.engine import scan_genome, scan_permute
    from fscl_tpu_torch.io import scan_output, write_null_distribution

    torch.cuda.synchronize()
    _zero_window_counts()
    t0 = time.monotonic()
    result = scan_genome(data, tables, scan_cfg, device=dev)
    torch.cuda.synchronize()
    t_scan = time.monotonic() - t0
    w_scan = _window_counts()
    _zero_window_counts()
    t0 = time.monotonic()
    scan_permute(data, tables, result, scan_cfg, perm_cfg, device=dev)
    torch.cuda.synchronize()
    t_perm = time.monotonic() - t0
    w_perm = _window_counts()
    launches = {k: (w_scan[k], w_perm[k]) for k in w_scan}
    bf = perm_cfg.hist_bf16
    ok = (w_scan["window_clr"] > 0 and w_scan["window_clr_f32"] > 0
          and (w_perm["window_clr"] > 0) == bf
          and (w_perm["window_clr_f32"] > 0) != bf
          and w_scan["window_operand"] == w_perm["window_operand"] == 0
          and not any(w[k] for w in (w_scan, w_perm)
                      for k in ("window_clr_wide", "window_clr_f32_wide")))
    if not ok:
        fail(f"{label}: window kernel launches (scan, permutations) "
             f"{launches}, hist_bf16={bf}")
    log(f"[{label}] window kernel launches (scan, permutations): {launches}")
    scan_output(tsv, data, result, n_permute=perm_cfg.n_permute)
    write_null_distribution(tsv, data, result)
    return result, t_scan, t_perm, launches


def _zero_window_counts():
    from fscl_tpu_torch.ops import gather as G
    from fscl_tpu_torch.ops import window_clr as W

    G.window_launches = W.window_clr_launches = 0
    W.window_clr_split_launches = W.window_clr_wide_launches = 0
    W.window_clr_f32_launches = W.window_clr_f32_reduce_launches = 0
    W.window_clr_f32_wide_launches = 0


def _window_counts():
    """Launches of the window kernels since _zero_window_counts."""
    from fscl_tpu_torch.ops import gather as G
    from fscl_tpu_torch.ops import window_clr as W

    return dict(window_clr=W.window_clr_launches,
                window_clr_split=W.window_clr_split_launches,
                window_clr_wide=W.window_clr_wide_launches,
                window_clr_f32=W.window_clr_f32_launches,
                window_clr_f32_wide=W.window_clr_f32_wide_launches,
                window_clr_f32_reduce=W.window_clr_f32_reduce_launches,
                window_operand=G.window_launches)


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


def _load_model(data, compat, grid_points=2048):
    from fscl_tpu_torch.models import background_fsp, build_tables

    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths, compat_mirror_unfolded=compat)
    tables = build_tables(fsp, data.sample_depths, grid_points=grid_points)
    data.attach_model(tables)
    return tables


def _task_20k():
    """bench.py's task: bench/data/bench_20k.sf, its tables and scan
    configuration."""
    from fscl_tpu_torch.engine.scan import ScanConfig
    from fscl_tpu_torch.io import load_snp_input

    data = load_snp_input(REPO / "bench" / "data" / "bench_20k.sf")
    tables = _load_model(data, compat=True)
    return data, tables, ScanConfig(small_grid_sp=1000, large_grid_sp=100000)


def phase_20k(dev):
    import torch

    from fscl_tpu_torch.engine.permute import PermuteConfig
    from fscl_tpu_torch.ops import prefix_sums as ps

    data, tables, scan_cfg = _task_20k()
    perm_cfg = PermuteConfig(n_permute=50, chunk_replicates=32, seed=1)

    # cold pass, then the timed pass with the launch count (bench.py order)
    _run_main_path(data, tables, scan_cfg, copy.deepcopy(perm_cfg), dev,
                   OUT / "bench_20k_cold.tsv", "20k cold")
    ps.launches = 0
    result, t_scan, t_perm, wl = _run_main_path(
        data, tables, scan_cfg, perm_cfg, dev, OUT / "bench_20k.tsv", "20k")
    launches = ps.launches
    _check_result(result, "20k")
    SCANS["20k"] = (data, tables, scan_cfg, result)
    if launches <= 0:
        fail("20k: the prefix-sum kernel was never launched")
    pr = int(result.permute_n.sum())
    log(f"[20k] {data.n_snps} sites, {result.n_points} points; scan "
        f"{t_scan:.3f}s, permute {t_perm:.3f}s, {pr} point-rounds, "
        f"{pr / t_perm:.1f} point-rounds/s, max CLR {result.clr.max():.2f}, "
        f"kernel launches {launches}")

    # first chunk again: the kernels vs the plain prefix function, then
    # vs the plain prefix and the plain window route, on the card
    hs, firsts, win = _first_chunk(data, tables, result, scan_cfg,
                                   perm_cfg, dev)
    for a, b, *_ in firsts:
        if not torch.equal(a, b):
            fail("20k: first-chunk null_max differs between the kernel and "
                 f"the plain prefix (max {float((a - b).abs().max())})")
        log(f"[20k] first chunk: null_max [{a.shape[0]}, {a.shape[1]}] "
            "equal with the kernel and with the plain prefix sums")
    plain_window = _check_plain_window(firsts, result, "20k",
                                       perm_cfg.hist_bf16)
    # the scan's reported CLRs through the float32 kernel and through the
    # two-step route; the tie stage's own inputs (one call: one chromosome)
    routes, ties = _check_scan_routes("20k", data, tables, scan_cfg, dev)
    tie = ties[0]
    # phases 3e, 3f and 3g at the 20k path's shapes: the scan (its dense
    # stage; its float32 tie stage), a stacked slice (its bfloat16
    # permutations; at hist_bf16=False the float32 kernel's)
    win_scan, call_scan, ht_scan = _scan_window_inputs(data, tables,
                                                       scan_cfg, dev)
    okern = (_window_case("20k scan", **win_scan)
             + _window_case("20k scan tie stage",
                            **_operand_args(_tie_first_chunk(tie)),
                            bf16_modes=(False,))
             + _window_case("20k stacked slice", **win[0]))
    ts, tp = (dict(t3=h.t3, n_alpha=h.n_alpha) for h in (ht_scan, hs.ht))
    fkern = [_window_clr_case("20k scan", **win_scan, **ts),
             _window_clr_case("20k stacked slice", **win[0], **tp),
             _window_clr_case("20k scan (whole call)", **call_scan, **ts,
                              iters=5),
             _window_clr_case("20k stacked slice (whole call)", **win[1],
                              **tp, iters=5)]
    f32kern = [
        _window_clr_f32_case("20k tie stage, first chunk",
                             **_tie_first_chunk(tie)),
        _window_clr_f32_case("20k tie stage (whole call)", **tie, iters=10),
        _window_clr_f32_case("20k stacked slice, hist_bf16=False (whole "
                             "call)", **win[1], **tp, iters=5),
    ]
    return dict(sites=data.n_snps, points=result.n_points, scan_s=t_scan,
                perm_s=t_perm, point_rounds=pr,
                point_rounds_per_s=pr / t_perm,
                max_clr=float(result.clr.max()), launches=launches,
                window_launches=wl, sub_rep=hs.stacks[0].sub_rep,
                w_seg_p=hs.stacks[0].w_seg_p, n_rows=hs.ht.n_rows,
                plain_window=plain_window, scan_routes=routes,
                okernel=okern, fkernel=fkern, f32kernel=f32kern)


# ---- the lattice path: kernel 3h, phases 4b and 4c -------------------------

# the lattice kernel against its plain version: |diff| <= LAT_REL * S +
# LAT_ABS per entry, S = 2 sum |y - null| (clr_lattice_plain, abs_sum)
LAT_REL = 1e-5
LAT_ABS = 1e-4
# the lattice statistic recomputed with the plain version: maxima within
# this, exceedance counts on the run's thresholds equal off near-ties
LAT_STAT_TOL = 1e-3


def _lattice_capture(run):
    """(run(), [(args, kwargs)] of every clr_lattice call it made)."""
    from fscl_tpu_torch.ops import lattice as TL

    calls, orig = [], TL.clr_lattice

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    TL.clr_lattice = rec
    try:
        return run(), calls
    finally:
        TL.clr_lattice = orig


def _lattice_sub(args, cands=None, reps=None):
    """clr_lattice's inputs cut to candidates ``cands`` and replicates
    ``reps`` (index tensors; None keeps all)."""
    pack, row, pos, null, cand, lo, hi, m_base, m_rel = args
    if reps is not None:
        row, null, m_base = row[reps], null[reps], m_base[reps]
    if cands is not None:
        cand, lo, hi, m_base = cand[cands], lo[cands], hi[cands], \
            m_base[:, cands]
    return (pack, row, pos, null, cand, lo, hi, m_base.contiguous(), m_rel)


def _lattice_alone(label, args, kw, first, identity):
    """Contract checks, bitwise: an entry does not depend on the other
    candidates of its block (every 7th candidate launched alone, other
    tiles and another C), on Rr (the last replicate alone), nor, for a
    replicate holding the observed attributes (identity = the observed
    [1, W] row and null), on the replicates beside it: that replicate at
    Rr, the observed call at Rr = 1 and three candidates alone at P = 1
    give the same bits."""
    import torch

    from fscl_tpu_torch.ops import lattice as TL

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    Rr, P, _ = first.shape
    dev = first.device
    sub = torch.arange(3, P, 7, device=dev)
    if len(sub) and not same(TL.clr_lattice(*_lattice_sub(args, sub), **kw),
                             first[:, sub]):
        fail(f"lkernel at {label}: every 7th candidate alone differs from "
             "its value in the whole launch")
    last = torch.tensor([Rr - 1], device=dev)
    if Rr > 1 and not same(TL.clr_lattice(*_lattice_sub(args, reps=last),
                                          **kw), first[-1:]):
        fail(f"lkernel at {label}: the last replicate alone differs")
    if identity is None:
        return 0
    row_obs, null_obs = identity
    pack, row, pos, null = args[:4]
    row, null = row.clone(), null.clone()
    row[0], null[0] = row_obs[0], null_obs[0]
    mixed = TL.clr_lattice(pack, row, pos, null, *args[4:], **kw)
    obs = TL.clr_lattice(*_lattice_sub((pack, row_obs, pos, null_obs,
                                        *args[4:]), reps=torch.tensor(
                                            [0], device=dev)), **kw)
    if not same(mixed[:1], obs):
        fail(f"lkernel at {label}: the identity replicate at Rr={Rr} "
             "differs from the observed call at Rr=1")
    for p in sorted({0, P // 2, P - 1}):
        one = TL.clr_lattice(*_lattice_sub(
            (pack, row_obs, pos, null_obs, *args[4:]),
            torch.tensor([p], device=dev),
            torch.tensor([0], device=dev)), **kw)
        if not same(one[0, 0], obs[0, p]):
            fail(f"lkernel at {label}: candidate {p} alone differs from "
                 "its value in the observed call")
    return 3


def _lattice_case(label, args, kw, *, identity=None, check_cands=None,
                  iters=20):
    """Phase 3h: clr_lattice against its plain version within LAT_REL * S
    + LAT_ABS per entry (on the candidates check_cands only, where given:
    the plain version at the full shape would take minutes), dummy
    candidates exactly 0, two launches and a launch after the timing loop
    bitwise equal to the first, _lattice_alone's checks; kernel and plain
    (on the checked candidates) timed.  The bound: every input the kernel
    reads (the kernel pack whole, an upper count of the rows the pairs
    read) and the output once over the HBM rate, or 12 + 7A lane
    operations a (candidate, site) pair over the lane rate, the larger.
    SM clocks a pair: the kernel time x 132 SMs x 1.98 GHz over the
    pairs.  Beside them, in smoke.json only: pairs x 8A, a modeled upper
    estimate of the bytes the pack-row reads move through L2, not a
    measured rate."""
    import torch

    from fscl_tpu_torch.ops import lattice as TL

    pack, row, pos, null, cand, lo, hi, m_base, m_rel = args
    G = kw["grid_points"]

    def kern():
        return TL.clr_lattice(*args, **kw)

    chk = args if check_cands is None else _lattice_sub(args, check_cands)

    def plain():
        return TL.clr_lattice_plain(*chk, **kw)

    got = kern()
    want = plain()
    lim = (LAT_REL * TL.clr_lattice_plain(*chk, **kw, abs_sum=True)
           + LAT_ABS)
    torch.cuda.synchronize()
    part = got if check_cands is None else got[:, check_cands]
    if part.shape != want.shape:
        fail(f"lkernel at {label}: {tuple(part.shape)} vs plain "
             f"{tuple(want.shape)}")
    err = (part - want).abs()
    max_err, ratio = float(err.max()), float((err / lim).max())
    if not bool((err <= lim).all()):
        fail(f"lkernel != plain at {label}: max |err| {max_err:.6g}, "
             f"{ratio:.3g} x the tolerance {LAT_REL} S + {LAT_ABS}, "
             f"{int((err > lim).sum())} entries over it")
    dummy = lo > hi
    if bool(got[:, dummy].any()):
        fail(f"lkernel at {label}: a dummy candidate is not 0")
    first = got.clone()
    del got, want, err, lim, part
    n_alone = _lattice_alone(label, args, kw, first, identity)
    Rr, P, A = first.shape
    live = lo <= hi
    pairs = Rr * int((hi[live] - lo[live] + 1).sum())
    ops = pairs * (12 + 7 * A)
    b_ms, b_by = bound(args, [first], ops)
    nbytes = sum(t.numel() * t.element_size() for t in (*args, first))
    l2_model = pairs * 8 * A
    n_sm = torch.cuda.get_device_properties(first.device).multi_processor_count
    C = TL.block_candidates(Rr, P, n_sm)
    torch.cuda.empty_cache()
    ms = _repeat_checks("lkernel", label, kern, first, iters)
    plain_ms = cuda_time_ms(plain, 1, readings=3)
    torch.cuda.empty_cache()
    clocks = ms * 1e-3 * n_sm * SM_CLOCK_HZ / pairs
    n_chk = P if check_cands is None else len(check_cands)
    shape = (f"Rr={Rr} P={P} ({int(dummy.sum())} dummy) A={A} G={G}, "
             f"{pairs} (candidate, site) pairs, C={C}")
    log(f"[lkernel] {label}: {shape}; max |err| {max_err:.4g} ({ratio:.3g}"
        f" x tolerance, {n_chk} candidates checked), repeat launches "
        f"bitwise, every 7th candidate and the last replicate alone "
        f"bitwise{', identity replicate bitwise' if n_alone else ''}; "
        f"kernel {ms:.4f} ms ({clocks:.3f} SM clocks a pair), plain "
        f"{plain_ms:.4f} ms ({n_chk} candidates), bound {b_ms:.4f} ms "
        f"({b_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G lane ops; "
        f"{100 * b_ms / ms:.1f}%); modeled upper estimate of the pack-row "
        f"bytes through L2 "
        f"(pairs x 8A, not measured) {l2_model / 1e9:.3f} GB")
    return dict(label=label, shape=shape, ms=ms, plain_ms=plain_ms,
                plain_candidates=n_chk, library_ms=None,
                max_abs_err=max_err, max_err_over_tol=ratio, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes, ops=ops, pairs=pairs,
                sm_clocks_per_pair=clocks, block_candidates=C,
                l2_bytes_model_upper=l2_model)


def _lattice_first_chunk(data, tables, result, scan_cfg, perm_cfg, dev,
                         points=None):
    """[R, K] statistic maxima of the first permutation chunk, computed as
    the lattice driver computes them (every point active; at the points
    only, where given, the others 0)."""
    import numpy as np
    import torch

    from fscl_tpu_torch.engine import permute as TP
    from fscl_tpu_torch.engine.scan import get_lattice_tables
    from fscl_tpu_torch.ops.permute import (
        block_permutation_groups, expand_group_sigma,
    )

    lt = get_lattice_tables(tables, dev)
    R = min(perm_cfg.chunk_replicates, perm_cfg.n_permute)
    sig = expand_group_sigma(block_permutation_groups(
        perm_cfg.seed, data.genome_pos(), perm_cfg.scan_width_mb * 1e6, R,
        start=0, device=dev).to(torch.int64), data.n_snps)
    row_gen = torch.as_tensor(np.asarray(data.row, np.int32), device=dev)
    null_gen = torch.as_tensor(np.asarray(data.null_logl, np.float32),
                               device=dev)
    Jf = TP.stat_positions(perm_cfg)
    out = torch.zeros((R, result.n_points), device=dev)
    for c, cl in enumerate(data.chr_limits):
        pts = np.where(result.chr_id == c)[0]
        if points is not None:
            pts = np.intersect1d(pts, points)
        if len(pts) == 0:
            continue
        ctx = TP._ChrPermContext(data, cl, scan_cfg, pts, Jf, dev)
        idx = sig[:, ctx.start:ctx.start + ctx.n]
        row, null = row_gen[idx], null_gen[idx]
        for g0 in range(0, len(pts), TP.POINT_BUCKET):
            grp = pts[g0:g0 + TP.POINT_BUCKET]
            out[:, grp] = TP._stat_max(lt, row, null, ctx.pos,
                                       *ctx.build_batch(result, grp),
                                       n_pts=len(grp), Jf=Jf)
    return out


def _check_first_chunk(label, data, tables, result, scan_cfg, perm_cfg,
                       dev, plain_points=None):
    """Phases 4b and 4d: the first permutation chunk recomputed as the
    lattice driver computes it: the kernel's maxima equal the run's saved
    nulls bitwise; the plain version's (at plain_points, every point where
    None) within LAT_STAT_TOL of them, with the same exceedances of the
    run's thresholds off 1e-4 near-ties.  The largest difference."""
    import numpy as np
    import torch

    kern_max = _lattice_first_chunk(data, tables, result, scan_cfg,
                                    perm_cfg, dev)
    plain_max = _plain_lattice(lambda: _lattice_first_chunk(
        data, tables, result, scan_cfg, perm_cfg, dev, points=plain_points))
    torch.cuda.synchronize()
    R = kern_max.shape[0]
    saved = np.array([r[:R] for r in result.null_clr])
    if not np.array_equal(kern_max.cpu().numpy().T, saved):
        fail(f"{label}: the first chunk's recomputed maxima differ from "
             "the run's saved null values")
    cols = (torch.arange(result.n_points, device=dev) if plain_points is None
            else torch.as_tensor(plain_points, device=dev))
    k, p = kern_max[:, cols], plain_max[:, cols]
    d = float((k - p).abs().max())
    thr = torch.as_tensor(result.stat_threshold, device=dev,
                          dtype=torch.float32)[cols]
    near = (((k - thr).abs() < 1e-4) | ((p - thr).abs() < 1e-4)).any(0)
    same = bool(((k >= thr) == (p >= thr))[:, ~near].all())
    if d > LAT_STAT_TOL or not same:
        fail(f"{label}: first chunk kernel vs plain max |d| {d:.3g} "
             f"(limit {LAT_STAT_TOL}), exceedances equal: {same}")
    log(f"[{label}] first chunk: maxima [{R}, {result.n_points}] equal "
        f"to the run's saved nulls; plain version at {len(cols)} points "
        f"within {d:.3g}; exceedances equal on {int((~near).sum())} points "
        f"({int(near.sum())} near-tie points excluded)")
    return d


def _other_kernel_counts():
    """Launches of the hist path's kernels since they were last zeroed."""
    from fscl_tpu_torch.ops import prefix_sums as ps

    return dict(_window_counts(), prefix=ps.launches)


def _zero_other_kernel_counts():
    from fscl_tpu_torch.ops import prefix_sums as ps

    _zero_window_counts()
    ps.launches = 0


def phase_20k_nohist(dev):
    """Phase 4b: the 20k task through --no-hist (the lattice path) at grid
    2048, scan and 50 permutations; the lattice kernel's launches counted
    over each (> 0; the hist kernels' 0); the first permutation chunk
    recomputed with the plain version; kernel 3h at the scan's dense
    coarse, fine and ultra calls and the permutations' first chunk
    (bucket 0, coarse and fine), captured from a first run."""
    import numpy as np
    import torch

    from fscl_tpu_torch.engine import scan_genome, scan_permute
    from fscl_tpu_torch.engine.permute import PermuteConfig
    from fscl_tpu_torch.engine.scan import ScanConfig
    from fscl_tpu_torch.io import scan_output, write_null_distribution
    from fscl_tpu_torch.ops import lattice as TL

    data, tables, _ = _task_20k()
    scan_cfg = ScanConfig(small_grid_sp=1000, large_grid_sp=100000,
                          use_hist=False)
    perm_cfg = PermuteConfig(n_permute=50, chunk_replicates=32, seed=1,
                             use_hist=False)
    # cold pass, capturing the kernel's inputs
    t0 = time.monotonic()
    res0, scan_calls = _lattice_capture(
        lambda: scan_genome(data, tables, scan_cfg, device=dev))
    _, perm_calls = _lattice_capture(
        lambda: scan_permute(data, tables, res0, scan_cfg,
                             copy.deepcopy(perm_cfg), device=dev))
    torch.cuda.synchronize()
    t_cold = time.monotonic() - t0
    # the main path, counted
    torch.cuda.synchronize()
    _zero_other_kernel_counts()
    TL.lattice_clr_launches = 0
    t0 = time.monotonic()
    result = scan_genome(data, tables, scan_cfg, device=dev)
    torch.cuda.synchronize()
    t_scan = time.monotonic() - t0
    n_scan = TL.lattice_clr_launches
    TL.lattice_clr_launches = 0
    t0 = time.monotonic()
    scan_permute(data, tables, result, scan_cfg, perm_cfg, device=dev)
    torch.cuda.synchronize()
    t_perm = time.monotonic() - t0
    n_perm = TL.lattice_clr_launches
    other = _other_kernel_counts()
    if n_scan <= 0 or n_perm <= 0:
        fail(f"20k no-hist: lattice kernel launches scan {n_scan}, "
             f"permutations {n_perm}")
    if any(other.values()):
        fail(f"20k no-hist: hist kernels launched on the lattice path: "
             f"{other}")
    _check_result(result, "20k no-hist")
    tsv = OUT / "bench_20k_nohist.tsv"
    scan_output(tsv, data, result, n_permute=perm_cfg.n_permute)
    write_null_distribution(tsv, data, result)
    SPLIT_REF["20k_nohist"] = (data, copy.deepcopy(result), tsv)
    pr = int(result.permute_n.sum())
    log(f"[20k no-hist] {data.n_snps} sites, {result.n_points} points; "
        f"cold run {t_cold:.3f}s; scan {t_scan:.3f}s, permute "
        f"{t_perm:.3f}s, {pr} point-rounds, {pr / t_perm:.1f} "
        f"point-rounds/s, max CLR {result.clr.max():.2f}; lattice kernel "
        f"launches scan {n_scan}, permutations {n_perm}")
    if not (np.array_equal(result.clr, res0.clr)
            and np.array_equal(result.stat_threshold, res0.stat_threshold)
            and np.array_equal(result.permute_n, res0.permute_n)):
        fail("20k no-hist: two runs differ")

    d = _check_first_chunk("20k no-hist", data, tables, result, scan_cfg,
                           perm_cfg, dev)

    chunk = [c for c in perm_calls if c[0][1].shape[0] > 1][:2]
    observed = scan_calls[0][0][1], scan_calls[0][0][3]  # row, null [1, W]
    lkern = [_lattice_case(f"20k no-hist scan, dense {stage}", a, k)
             for stage, (a, k) in zip(("coarse", "fine", "ultra"),
                                      scan_calls)]
    lkern += [_lattice_case(f"20k no-hist permutation chunk, {stage}", a, k,
                            identity=observed)
              for stage, (a, k) in zip(("coarse", "fine"), chunk)]
    del scan_calls, perm_calls
    return dict(sites=data.n_snps, points=result.n_points, cold_s=t_cold,
                scan_s=t_scan, perm_s=t_perm, point_rounds=pr,
                point_rounds_per_s=pr / t_perm,
                max_clr=float(result.clr.max()),
                launches=dict(scan=n_scan, permute=n_perm),
                first_chunk_plain_max_diff=d, lkernel=lkern)


def _plain_lattice(run):
    """run() with every clr_lattice call taking the plain version."""
    from fscl_tpu_torch.ops import lattice as TL

    orig = TL.clr_lattice
    TL.clr_lattice = TL.clr_lattice_plain
    try:
        return run()
    finally:
        TL.clr_lattice = orig


def _lattice_at(data, tables, res, eval_range, idx, pos, la, dev):
    """(CLR, S) of the plain version at scan points idx placed at (pos,
    lalpha): one offset-0 pack row a site, m_base the lalpha's lattice
    offset."""
    import numpy as np
    import torch

    from fscl_tpu_torch import LOG_AD_MIN
    from fscl_tpu_torch.ops import lattice as TL
    from fscl_tpu_torch.ops.windows import candidate_windows

    G = tables.grid_points
    pack = torch.as_tensor(TL.build_lattice_pack(tables.table,
                                                 np.zeros(1, np.int32)),
                           device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    clr, S = np.zeros(len(idx)), np.zeros(len(idx))
    for c, cl in enumerate(data.chr_limits):
        k = np.nonzero(res.chr_id[idx] == c)[0]
        if len(k) == 0:
            continue
        sl = slice(cl.start_index, cl.start_index + cl.n_snps)
        pos_c = np.asarray(data.pos[sl], dtype=np.int32)
        cand = np.asarray(pos[k], dtype=np.int32)
        _, lo, hi = candidate_windows(pos_c, cand, eval_range)
        m = np.round((np.asarray(la[k]) - LOG_AD_MIN) / TL.lattice_step(G))
        t = [torch.as_tensor(np.asarray(x, np.int32), device=dev)
             for x in (pos_c, cand, lo, hi)]
        args = (pack,
                torch.as_tensor(np.asarray(data.row[sl], np.int32),
                                device=dev)[None],
                t[0],
                torch.as_tensor(np.asarray(data.null_logl[sl], np.float32),
                                device=dev)[None],
                t[1], t[2], t[3],
                torch.as_tensor(m.astype(np.int32), device=dev)[None], zero)
        clr[k] = TL.clr_lattice_plain(*args, grid_points=G)[0, :, 0].cpu()
        S[k] = TL.clr_lattice_plain(*args, grid_points=G,
                                    abs_sum=True)[0, :, 0].cpu()
    return clr, S


def phase_20k_grid1024(dev):
    """Phase 4c: the 20k task's scan at grid 1024, whose tie table's step
    exceeds exact_step_max: the tie stage runs the lattice kernel (its
    launches > 0), the dense and refine stages the hist kernels.  Its
    tie-stage calls, captured from the cold run, go through phase 3h; the
    scan runs again with the plain lattice version and its reported CLRs,
    positions and lalpha are held to the kernel run's."""
    import numpy as np
    import torch

    from fscl_tpu_torch.engine import scan_genome
    from fscl_tpu_torch.engine.scan import ScanConfig, make_scan_hist_tables
    from fscl_tpu_torch.io import load_snp_input, scan_output
    from fscl_tpu_torch.ops import lattice as TL

    data = load_snp_input(REPO / "bench" / "data" / "bench_20k.sf")
    tables = _load_model(data, compat=True, grid_points=1024)
    scan_cfg = ScanConfig(small_grid_sp=1000, large_grid_sp=100000)
    ht = make_scan_hist_tables(data, tables, scan_cfg.hist_alphas,
                               decimate=scan_cfg.tie_decimate, device=dev)
    if ht is None or ht.step <= scan_cfg.exact_step_max:
        fail("20k grid 1024: the tie table does not exceed exact_step_max")
    res0, tie_calls = _lattice_capture(  # cold
        lambda: scan_genome(data, tables, scan_cfg, device=dev))
    torch.cuda.synchronize()
    _zero_other_kernel_counts()
    TL.lattice_clr_launches = 0
    t0 = time.monotonic()
    result = scan_genome(data, tables, scan_cfg, device=dev)
    torch.cuda.synchronize()
    t_scan = time.monotonic() - t0
    n_lat = TL.lattice_clr_launches
    other = _other_kernel_counts()
    if n_lat <= 0 or other["window_clr"] <= 0:
        fail(f"20k grid 1024: lattice kernel launches {n_lat}, hist kernel "
             f"launches {other}")
    if result.n_points == 0 or not np.isfinite(result.clr).all():
        fail("20k grid 1024: no or non-finite scan points")
    if not (np.array_equal(result.clr, res0.clr)
            and np.array_equal(result.sweep_pos, res0.sweep_pos)):
        fail("20k grid 1024: two runs differ")
    scan_output(OUT / "bench_20k_grid1024.tsv", data, result)
    log(f"[20k grid 1024] tie step {ht.step:.4f} > {scan_cfg.exact_step_max}"
        f"; scan {t_scan:.3f}s, {result.n_points} points, max CLR "
        f"{result.clr.max():.2f}; lattice kernel launches {n_lat} (tie "
        f"stage), bf16 window kernel {other['window_clr']}")

    # the scan again, its tie stage on the plain lattice version (the
    # hist stages before it are bitwise repeatable, so the tie pool is
    # the same)
    plain = _plain_lattice(
        lambda: scan_genome(data, tables, scan_cfg, device=dev))
    if not (np.array_equal(plain.chr_id, result.chr_id)
            and np.array_equal(plain.interval_start, result.interval_start)):
        fail("20k grid 1024: the plain run's intervals differ")
    er = scan_cfg.eval_range
    every = np.arange(result.n_points)
    _, S_k = _lattice_at(data, tables, result, er, every, result.sweep_pos,
                         result.lalpha, dev)
    _, S_p = _lattice_at(data, tables, result, er, every, plain.sweep_pos,
                         plain.lalpha, dev)
    tol = LAT_REL * np.maximum(S_k, S_p) + 1e-3
    d = np.abs(result.clr - plain.clr)
    if not (d <= tol).all():
        fail(f"20k grid 1024: tie-stage CLR kernel vs plain max |d| "
             f"{d.max():.6g}, {int((d > tol).sum())} points over 1e-5 S + "
             "1e-3")
    # a differing winner must be a near-tie: the plain version scores
    # the kernel run's (position, lalpha) within the tolerance of its own
    differ = np.nonzero((result.sweep_pos != plain.sweep_pos)
                        | (result.lalpha != plain.lalpha))[0]
    if len(differ):
        c_k, _ = _lattice_at(data, tables, result, er, differ,
                             result.sweep_pos[differ], result.lalpha[differ],
                             dev)
        c_p, _ = _lattice_at(data, tables, result, er, differ,
                             plain.sweep_pos[differ], plain.lalpha[differ],
                             dev)
        gap = np.abs(c_k - c_p)
        if not (gap <= tol[differ]).all():
            fail(f"20k grid 1024: kernel and plain winners differ at "
                 f"points {list(differ[gap > tol[differ]])} by more than "
                 "the tolerance")
    log(f"[20k grid 1024] plain tie stage: reported CLR within {d.max():.4g}"
        f" ({(d / tol).max():.3g} x 1e-5 S + 1e-3); positions and lalpha "
        f"equal off near-tie points {list(differ)}")

    if len(tie_calls) != 3 * len(data.chr_limits):
        fail(f"20k grid 1024: {len(tie_calls)} tie-stage lattice calls, "
             "not 3 a chromosome (coarse, fine, ultra)")
    lkern = [_lattice_case(f"20k grid 1024 tie stage, {stage}", a, k)
             for stage, (a, k) in zip(("coarse", "fine", "ultra"),
                                      tie_calls)]
    del tie_calls
    return dict(scan_s=t_scan, points=result.n_points, tie_step=ht.step,
                launches=n_lat, window_launches=other,
                plain_max_clr_diff=float(d.max()),
                near_ties=[int(i) for i in differ], lkernel=lkern)


def big_chromosome_data():
    """One chromosome past the hist gate (SITES_MAX = 4,000,000 sites):
    120 Mb at 45 sites a kb, depth 50, one sweep, K >= 2 (about 4.19M
    sites), simulated in memory."""
    import numpy as np

    from fscl_tpu_torch.data import build_snp_data
    from fscl_tpu_torch.sim import simulate_dataset

    sim = simulate_dataset(seed=300, sample_size=50, snp_density=45.0,
                           mb_length=120.0, alpha=3e-5, n_sweeps=1)
    keep = sim["freq"] >= 2
    n = int(keep.sum())
    data = build_snp_data(["1"] * n, sim["pos"][keep], sim["freq"][keep],
                          np.full(n, 50), np.zeros(n, bool))
    return data, sim["sweep_pos"]


def phase_big_chromosome(dev, n_permute=16):
    """Phase 4d: a chromosome of over 4M sites through the CLI defaults
    (windows of 2 x 81,920 + 1 sites, candidates 1 kb apart): the hist
    gate returns None, the scan and one chunk of n_permute permutations
    run the lattice kernel (launches > 0, the hist kernels' 0, each
    counted over its own run); the reported CLRs recomputed with the
    plain version at the reported (position, lalpha), within 1e-5 S +
    1e-3; the permutation chunk recomputed as in 4b (the plain version at
    64 points spread over the chromosome); kernel 3h at the scan's dense
    coarse, fine and ultra calls and at the chunk's first coarse and fine
    calls (Rr = n_permute, per-candidate windows that cross; the observed
    attributes as an identity replicate), held against the plain version
    on 64 candidates of each."""
    import numpy as np
    import torch

    from fscl_tpu_torch.engine import scan_genome, scan_permute
    from fscl_tpu_torch.engine.permute import PermuteConfig
    from fscl_tpu_torch.engine.scan import ScanConfig, make_scan_hist_tables
    from fscl_tpu_torch.ops import lattice as TL
    from fscl_tpu_torch.ops.histclr import SITES_MAX

    t0 = time.monotonic()
    data, sweep_pos = big_chromosome_data()
    LOAD_INPUTS["big_chromosome"] = data
    tables = _load_model(data, compat=False)
    t_setup = time.monotonic() - t0
    if data.n_snps <= SITES_MAX:
        fail(f"big chromosome: {data.n_snps} sites, not past the gate")
    scan_cfg = ScanConfig()
    if make_scan_hist_tables(data, tables, scan_cfg.hist_alphas,
                             decimate=scan_cfg.hist_decimate,
                             device=dev) is not None:
        fail("big chromosome: the hist gate took the chromosome")
    torch.cuda.synchronize()
    _zero_other_kernel_counts()
    TL.lattice_clr_launches = 0
    t0 = time.monotonic()
    result, calls = _lattice_capture(
        lambda: scan_genome(data, tables, scan_cfg, device=dev))
    torch.cuda.synchronize()
    t_scan = time.monotonic() - t0
    n_scan = TL.lattice_clr_launches
    other_scan = _other_kernel_counts()
    perm_cfg = PermuteConfig(n_permute=n_permute)
    _zero_other_kernel_counts()
    TL.lattice_clr_launches = 0
    t0 = time.monotonic()
    _, perm_calls = _lattice_capture(
        lambda: scan_permute(data, tables, result, scan_cfg,
                             copy.deepcopy(perm_cfg), device=dev))
    torch.cuda.synchronize()
    t_perm = time.monotonic() - t0
    n_perm = TL.lattice_clr_launches
    other_perm = _other_kernel_counts()
    if n_scan <= 0 or n_perm <= 0:
        fail(f"big chromosome: lattice kernel launches scan {n_scan}, "
             f"permutations {n_perm}")
    if any(other_scan.values()) or any(other_perm.values()):
        fail(f"big chromosome: hist kernels launched: scan {other_scan}, "
             f"permutations {other_perm}")
    _check_result(result, "big chromosome")
    er = scan_cfg.eval_range
    every = np.arange(result.n_points)
    clr_p, S = _lattice_at(data, tables, result, er, every,
                           result.sweep_pos, result.lalpha, dev)
    tol = LAT_REL * S + 1e-3
    d = np.abs(result.clr - clr_p)
    if not (d <= tol).all():
        fail(f"big chromosome: reported CLR vs plain at the reported "
             f"position and lalpha max |d| {d.max():.6g}, "
             f"{int((d > tol).sum())} points over 1e-5 S + 1e-3")
    top = int(np.argmax(result.clr))
    pr = int(result.permute_n.sum())
    log(f"[big chromosome] {data.n_snps} sites, {result.n_points} points, "
        f"windows {2 * er + 1} sites; data+tables {t_setup:.1f}s, scan "
        f"{t_scan:.3f}s, permute ({n_permute}) {t_perm:.3f}s, {pr} "
        f"point-rounds; lattice kernel launches scan {n_scan}, "
        f"permutations {n_perm}, hist kernels 0; reported CLRs within "
        f"{d.max():.4g} of the plain version ({(d / tol).max():.3g} x 1e-5 "
        f"S + 1e-3); max CLR {result.clr[top]:.2f} at "
        f"{int(result.sweep_pos[top])} (sweep planted at "
        f"{[int(x) for x in sweep_pos]})")
    K = result.n_points
    d_chunk = _check_first_chunk(
        "big chromosome", data, tables, result, scan_cfg, perm_cfg, dev,
        plain_points=np.unique(np.linspace(0, K - 1, 64).round().astype(int)))

    observed = calls[0][0][1], calls[0][0][3]  # row, null [1, W]
    cases = [(f"big chromosome scan, dense {stage}", c, None)
             for stage, c in zip(("coarse", "fine", "ultra"), calls)]
    chunk = [c for c in perm_calls if c[0][1].shape[0] > 1][:2]
    if len(chunk) != 2:
        fail(f"big chromosome: {len(chunk)} permutation chunk calls "
             "captured, not a coarse and a fine one")
    cases += [(f"big chromosome permutation chunk, {stage}", c, observed)
              for stage, c in zip(("coarse", "fine"), chunk)]
    del calls, perm_calls, chunk
    lkern = []
    for label, (a, k), identity in cases:
        P = a[4].shape[0]
        sub = torch.linspace(0, P - 1, 64, device=dev).round().long()
        lkern.append(_lattice_case(label, a, k, identity=identity,
                                   check_cands=sub, iters=2))
    del cases, observed
    torch.cuda.empty_cache()
    return dict(sites=data.n_snps, points=result.n_points,
                window_sites=2 * er + 1, setup_s=t_setup, scan_s=t_scan,
                perm_s=t_perm, n_permute=n_permute, point_rounds=pr,
                launches=dict(scan=n_scan, permute=n_perm),
                plain_max_clr_diff=float(d.max()),
                first_chunk_plain_max_diff=d_chunk, lkernel=lkern)


def genome_data():
    """bench/headline.py gen_genome1m, in memory: 22 x 45.5 Mb, K >= 2."""
    import numpy as np

    from fscl_tpu_torch.data import build_snp_data
    from fscl_tpu_torch.sim import simulate_dataset

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
    from fscl_tpu_torch.engine import permute as TP
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
    perm_cfg = PermuteConfig(n_permute=n_permute)
    result, t_scan, t_perm, wl = _run_main_path(
        data, tables, ScanConfig(), perm_cfg, dev, OUT / "genome1m.tsv",
        "genome")
    rdp_auto = dict(TP.last_stats)  # FSCL_RDP as set (auto by default)
    launches = ps.launches - before
    _check_result(result, "genome")
    SPLIT_REF["genome1m"] = (data, copy.deepcopy(result),
                             OUT / "genome1m.tsv")
    SCANS["genome1m"] = (data, tables, ScanConfig(), result)
    hs = setup_hist(data, tables, result, ScanConfig(), PermuteConfig(), dev)
    stacks = [(st.w_seg_p, len(st.segs), _sub_rep_for(hs.ht, _ladder_pad(
        len(st.segs)), st.w_seg_p)) for st in hs.stacks]
    hs, firsts, win = _first_chunk(data, tables, result, ScanConfig(),
                                   perm_cfg, dev)
    plain_window = _check_plain_window(firsts, result, "genome",
                                       perm_cfg.hist_bf16)
    routes, ties = _check_scan_routes("genome", data, tables, ScanConfig(),
                                      dev)
    tie = max(ties, key=lambda t: t["bounds"].shape[0])  # largest call
    del ties
    okern = (_window_case("genome stacked slice", **win[0])
             + _window_case("genome tie stage",
                            **_operand_args(_tie_first_chunk(tie)),
                            bf16_modes=(False,)))
    tp = dict(t3=hs.ht.t3, n_alpha=hs.ht.n_alpha)
    fkern = [_window_clr_case("genome stacked slice", **win[0], **tp),
             _window_clr_case("genome stacked slice (whole call)", **win[1],
                              **tp, iters=2),
             *_tail_window_cases(dev)]
    f32kern = [_window_clr_f32_case("genome tie stage, largest chromosome "
                                    "(whole call)", **tie, iters=5)]
    log(f"[genome] stacks (w_seg_p, chromosomes, sub_rep): {stacks}")
    pr = int(result.permute_n.sum())
    log(f"[genome] {data.n_snps} sites over {len(data.chr_limits)} "
        f"chromosomes, {result.n_points} points; data+tables {t_setup:.1f}s,"
        f" scan {t_scan:.3f}s, permute ({n_permute}) {t_perm:.3f}s, "
        f"{pr} point-rounds, {pr / t_perm:.1f} point-rounds/s, kernel "
        f"launches {launches}")
    log(f"[genome] RDP tail ({TP.RDP_FORCE}): {rdp_auto['rdp_dispatches']} "
        f"RDP chunks, {rdp_auto['stack_dispatches']} stacked dispatches, "
        f"{int(result.permute_finished.sum())} of {result.n_points} points "
        "finished")
    return dict(sites=data.n_snps, points=result.n_points, scan_s=t_scan,
                perm_s=t_perm, n_permute=n_permute, point_rounds=pr,
                point_rounds_per_s=pr / t_perm, stacks=stacks,
                n_rows=hs.ht.n_rows, launches=launches,
                window_launches=wl, plain_window=plain_window,
                scan_routes=routes, okernel=okern, fkernel=fkern,
                f32kernel=f32kern, rdp_mode=TP.RDP_FORCE,
                **rdp_auto)


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
    result, t_scan, t_perm, wl = _run_main_path(
        data, tables, scan_cfg, perm_cfg, dev, OUT / "mixed100k.tsv",
        "mixed100k")
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
    hs, firsts, win = _first_chunk(data, tables, result, scan_cfg,
                                   perm_cfg, dev)
    ht = hs.ht
    if ht.weights is None:
        fail("mixed100k: the tables are not compressed")
    stacks = [(st.w_seg_p, len(st.segs), _sub_rep_for(ht, _ladder_pad(
        len(st.segs)), st.w_seg_p)) for st in hs.stacks]
    # first chunk: the engine's statistic (bf16 contraction) with the
    # kernel and with the plain prefix; tolerance 1e-2 of max |stat|, the
    # bf16 band of tests/test_torch_permute.py
    d_first = 0.0
    for a, b, *_ in firsts:
        d = float((a - b).abs().max())
        if d > 1e-2 * max(float(b.abs().max()), 1.0):
            fail(f"mixed100k: first-chunk null_max differs by {d:.4g} "
                 "between the kernel and the plain prefix")
        d_first = max(d_first, d)
        log(f"[mixed100k] first chunk: null_max [{a.shape[0]}, "
            f"{a.shape[1]}] kernel vs plain prefix max |diff| {d:.4g} "
            f"(max |stat| {float(b.abs().max()):.4g})")
    plain_window = _check_plain_window(firsts, result, "mixed100k",
                                       perm_cfg.hist_bf16)
    routes, ties = _check_scan_routes("mixed100k", data, tables, scan_cfg,
                                      dev)
    tie = max(ties, key=lambda t: t["bounds"].shape[0])  # largest call
    del ties
    okern = (_window_case("mixed100k stacked slice", **win[0])
             + _window_case("mixed100k tie stage",
                            **_operand_args(_tie_first_chunk(tie)),
                            bf16_modes=(False,)))
    tp = dict(t3=ht.t3, n_alpha=ht.n_alpha)
    fkern = [_window_clr_case("mixed100k stacked slice", **win[0], **tp),
             _window_clr_case("mixed100k stacked slice (whole call)",
                              **win[1], **tp, iters=5)]
    f32kern = [_window_clr_f32_case("mixed100k tie stage, largest "
                                    "chromosome (whole call)", **tie,
                                    iters=10)]
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
                launches=launches, window_launches=wl,
                plain_window=plain_window, scan_routes=routes, okernel=okern,
                fkernel=fkern, f32kernel=f32kern)


def _single_depth_check_data():
    """Two 3 Mb chromosomes at depth 30."""
    import numpy as np

    from fscl_tpu_torch.data import build_snp_data
    from fscl_tpu_torch.sim import simulate_dataset

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


def _dense_cluster_check_data():
    """2,000 sites over a 500 Mb chromosome at depth 24 with a 24-site
    cluster inside one minimum-quantum block: past the hist gate (the
    block table cannot hold it), so scan and permutations take the
    lattice path (tests/test_torch_lattice.py's dense-cluster input)."""
    import numpy as np

    from fscl_tpu_torch.data import build_snp_data

    rng = np.random.default_rng(5)
    pos = np.sort(rng.choice(500_000_000, 2000, replace=False)).astype(
        np.int64)
    pos = np.sort(np.concatenate([pos, 250_000_000 + np.arange(24) * 2]))
    freq = rng.integers(1, 24, size=len(pos))
    return build_snp_data(["1"] * len(pos), pos, freq,
                          np.full(len(pos), 24), np.zeros(len(pos), bool))


def _mixed_check_data():
    """Two 3 Mb chromosomes of depth-40 samples with missing calls: each
    site keeps 20-40 of them (hypergeometric subsample), 30% folded, so
    the data has more than ROWS_MAX distinct table rows."""
    import numpy as np

    from fscl_tpu_torch.data import build_snp_data
    from fscl_tpu_torch.sim import simulate_dataset

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


# ---- clr_grid: kernel 3i, phase 4e, and the ms pipeline (phase 8) ---------

# the clr_grid kernel against its plain version: |diff| <= CG_REL * S +
# CG_ABS per entry, S = 2 sum |y - null| over its terms (_cg_scale)
CG_REL = 1e-5
CG_ABS = 1e-4
# lane operations, counted from PR 12's csrc/clr_grid.cu (now
# tools/clr_grid_baseline.cu): a (candidate, site) pair in its window (the
# distance and its two clamps, the conversion, logf taken as one, the two
# window compares, the row's base), a term (pair, alpha) inside the mask
# (the add and the compare, u's subtract and multiply, the truncation and
# its two clamps, the conversion back, frac's subtract and two clamps, the
# index add, 1 - frac, v1 * frac, the fused multiply-add, y - null and the
# sum's add) and one outside it (the add and the compare).  The bound
# counts them on the work these inputs need (_cg_terms): the pairs where
# at least one of the candidate's alphas is inside the mask, their terms
# inside it, and outside it one term a pair and tile where the tile's
# alphas ascend (the mask is then a prefix: the kernel stops at the
# first term outside it), every one where they do not; PR 12's count
# (every pair of every window, every term outside the mask) is printed
# beside it as the old bound
CG_OPS_PAIR = 8
CG_OPS_TERM = 17
CG_OPS_MASKED = 2
# the lattice kernel against the clr_grid kernel at the lattice's coarse
# alphas (tests/test_lattice.py:58's tolerance: the two round their
# coordinates apart)
LAT_GRID_RTOL = 2e-4
LAT_GRID_ATOL = 2e-3


def _cg_terms(args, la, paired):
    """The work of a clr_grid call on these inputs, counted on their
    device: dict of pairs (the (candidate, site) pairs in their windows),
    reached (those where at least one alpha is inside the mask), inside
    (their terms inside the mask), terms (every pair's A terms), masked
    (the terms outside the mask that the reached pairs must test: per
    tile of TILE_ALPHAS alphas, one where the tile's
    alphas ascend and some are outside, else all of those); ops (CG_OPS_*
    on reached, inside, masked) and ops_old (PR 12's count: every pair,
    every term outside the mask)."""
    import torch

    from fscl_tpu_torch import LOG_AD_MAX
    from fscl_tpu_torch.ops.clr import TILE_ALPHAS

    _, _, pos, _, cand, lo, hi = args
    A = la.shape[-1]
    n = dict(pairs=0, reached=0, inside=0, terms=0, masked=0)
    live = torch.nonzero(lo <= hi).flatten()
    if live.numel() > 0 and A > 0:
        tiles = [slice(t, min(t + TILE_ALPHAS, A))
                 for t in range(0, A, TILE_ALPHAS)]
        width = hi[live] - lo[live] + 1
        n["pairs"], L = int(width.sum()), int(width.max())
        k = torch.arange(L, device=lo.device)
        per = max(1, (1 << 24) // (L * A))
        for k0 in range(0, live.numel(), per):
            idx = live[k0:k0 + per]
            w = lo[idx, None] + k
            ok = w <= hi[idx, None]
            w = torch.where(ok, w, lo[idx, None]).long()
            logd = torch.log((pos[w] - cand[idx, None]).abs().clamp_min(1)
                             .to(torch.float32))
            lal = la[idx] if paired else la[None].expand(len(idx), A)
            hit = (logd[..., None] + lal[:, None, :]) <= LOG_AD_MAX
            reached = hit.any(-1) & ok  # [C, L]
            n["inside"] += int((hit & ok[..., None]).sum())
            n["reached"] += int(reached.sum())
            for t in tiles:
                out = (~hit[..., t] & reached[..., None]).sum(-1)  # [C, L]
                up = (lal[:, t][:, 1:] >= lal[:, t][:, :-1]).all(-1)
                n["masked"] += int(torch.where(up[:, None], out.clamp_max(1),
                                               out).sum())
        n["terms"] = n["pairs"] * A
    n["ops"] = (CG_OPS_PAIR * n["reached"] + CG_OPS_TERM * n["inside"]
                + CG_OPS_MASKED * n["masked"])
    n["ops_old"] = (CG_OPS_PAIR * n["pairs"] + CG_OPS_TERM * n["inside"]
                    + CG_OPS_MASKED * (n["terms"] - n["inside"]))
    return n


def _cg_scale(args, la, paired, G):
    """S [P, A] float64, 2 sum |y - null| over each entry's terms (the
    coordinates in float32 as the kernel takes them, y in float64, as
    tests/test_torch_clr.py::_ref): the scale of the float32 sums'
    rounding that CG_REL is stated against."""
    import torch

    from fscl_tpu_torch import LOG_AD_MAX, LOG_AD_MIN
    from fscl_tpu_torch.ops.lattice import lattice_inv_step

    table, row, pos, null, cand, lo, hi = args
    P, A = cand.shape[0], la.shape[-1]
    lal = la if paired else la[None].expand(P, A)
    inv = lattice_inv_step(G)
    S = torch.zeros((P, A), dtype=torch.float64, device=table.device)
    for p, (a, b) in enumerate(zip(lo.tolist(), hi.tolist())):
        if a > b:
            continue
        w = torch.arange(a, b + 1, device=table.device)
        logd = torch.log((pos[w] - cand[p]).abs().clamp_min(1)
                         .to(torch.float32))
        x = logd[:, None] + lal[p][None]
        u = (x - LOG_AD_MIN) * inv
        i = u.to(torch.int32).clamp(0, G - 2)
        frac = (u - i.to(torch.float32)).clamp(0.0, 1.0).double()
        k = row[w].to(torch.int64)[:, None] * G + i
        y = table[k].double() * (1 - frac) + table[k + 1].double() * frac
        S[p] = 2 * torch.where(x <= LOG_AD_MAX, y - null[w][:, None].double(),
                               0.0).abs().sum(0)
    return S


def _cg_sub(args, la, paired, cands):
    """clr_grid's inputs cut to candidates ``cands`` (an index tensor)."""
    return ((*args[:4], *(t[cands].contiguous() for t in args[4:])),
            la[cands].contiguous() if paired else la)


def _cg_case(label, args, la, paired, G, *, check_cands=None, iters=20):
    """Phase 3i at one shape: clr_grid against its plain version within
    CG_REL * S + CG_ABS per entry (on check_cands only, where given: the
    plain version at the dense shapes takes seconds a call), candidates
    with lo > hi exactly 0, every entry finite, two calls and a call after
    the timing loop bitwise equal to the first, the checked candidates
    (every 7th where all are checked) launched alone bitwise equal to
    their entries; timed: the call (ms: launch_clr_grid, the kernel's two
    launches and their scratch, the slice plan computed beforehand), the
    wrapper (wrapper_ms: with its checks and their sync) and plain (on
    the checked candidates).  The bound: every input read
    once and the output written once over the HBM rate, or the lane
    operations that these inputs' work needs (_cg_terms) over the lane
    rate, the larger; PR 12's count beside it.  The wrapper's first call
    must count its two launches in clr_grid_launches.  Returns (record,
    the kernel's output)."""
    import torch

    from fscl_tpu_torch import kernels
    from fscl_tpu_torch.ops import clr as TC

    dev = args[0].device
    kw = dict(grid_points=G, paired_alpha=paired)
    lib = kernels.load()

    def wrapper():
        return TC.clr_grid(*args, la, device=dev, **kw)

    plan = TC.clr_grid_plan(args[5].cpu().numpy(), args[6].cpu().numpy(),
                            lib.fscl_clr_grid_group(),
                            lib.fscl_clr_grid_slice_sites())

    def kern():
        return TC.launch_clr_grid(lib, *args, la, G, paired, plan)

    P = args[4].shape[0]
    if check_cands is None:
        check_cands = torch.arange(P, device=dev)
        alone_cands = torch.arange(0, P, 7, device=dev)
    else:
        alone_cands = check_cands
    sub, la_sub = _cg_sub(args, la, paired, check_cands)

    def plain():
        return TC.clr_grid_plain(*sub, la_sub, **kw)

    TC.clr_grid_launches = 0
    got = wrapper()
    if TC.clr_grid_launches != 2:
        fail(f"cgkernel at {label}: one call counted "
             f"{TC.clr_grid_launches} launches, not 2")
    want = plain()
    lim = CG_REL * _cg_scale(sub, la_sub, paired, G) + CG_ABS
    torch.cuda.synchronize()
    part = got[check_cands]
    if part.shape != want.shape:
        fail(f"cgkernel at {label}: {tuple(part.shape)} vs plain "
             f"{tuple(want.shape)}")
    err = (part - want).abs().double()
    max_err, ratio = float(err.max()), float((err / lim).max())
    if not bool((err <= lim).all()):
        fail(f"cgkernel != plain at {label}: max |err| {max_err:.6g}, "
             f"{ratio:.3g} x the tolerance {CG_REL} S + {CG_ABS}, "
             f"{int((err > lim).sum())} entries over it")
    if not bool(torch.isfinite(got).all()):
        fail(f"cgkernel at {label}: a non-finite entry")
    pad = args[5] > args[6]
    if bool(got[pad].any()):
        fail(f"cgkernel at {label}: a candidate with lo > hi is not 0")
    cut, la_cut = _cg_sub(args, la, paired, alone_cands)
    alone = TC.launch_clr_grid(lib, *cut, la_cut, G, paired)
    torch.cuda.synchronize()
    if not torch.equal(alone.view(torch.int32),
                       got[alone_cands].view(torch.int32)):
        fail(f"cgkernel at {label}: {alone_cands.numel()} candidates "
             "launched alone differ from their entries")
    first = got.clone()
    del got, want, err, lim, part, alone
    work = _cg_terms(args, la, paired)
    ops, ops_old = work["ops"], work["ops_old"]
    A = first.shape[1]
    b_ms, b_by = bound([*args, la], [first], ops)
    old_ms, old_by = bound([*args, la], [first], ops_old)
    nbytes = sum(t.numel() * t.element_size() for t in (*args, la, first))
    ms = _repeat_checks("cgkernel", label, kern, first, iters)
    wrapper_ms = _repeat_checks("cgkernel wrapper", label, wrapper, first,
                                iters)
    plain_ms = cuda_time_ms(plain, 1, readings=3)
    torch.cuda.empty_cache()
    n_chk = check_cands.numel()
    shape = (f"P={P} ({int(pad.sum())} with lo > hi) A={A} "
             f"{'paired' if paired else 'shared'} G={G} W="
             f"{args[1].shape[0]}, {work['pairs']} (candidate, site) "
             f"pairs, {work['reached']} with an alpha inside the mask, "
             f"{work['inside']} of {work['terms']} terms inside the mask, "
             f"{work['masked']} outside it tested")
    log(f"[cgkernel] {label}: {shape}; max |err| {max_err:.4g} ({ratio:.3g}"
        f" x tolerance, {n_chk} candidates checked), repeat calls and "
        f"{alone_cands.numel()} candidates alone bitwise; kernel {ms:.4f} "
        f"ms (wrapper {wrapper_ms:.4f}), plain {plain_ms:.4f} ms ({n_chk} "
        f"candidates), bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, "
        f"{ops / 1e9:.3f} G lane ops; {100 * b_ms / ms:.1f}%), PR 12's "
        f"bound {old_ms:.4f} ms ({old_by}: {ops_old / 1e9:.3f} G; "
        f"{100 * old_ms / ms:.1f}%)")
    return (dict(label=label, shape=shape, ms=ms, wrapper_ms=wrapper_ms,
                 plain_ms=plain_ms, plain_candidates=n_chk, library_ms=None,
                 max_abs_err=max_err, max_err_over_tol=ratio, bound_ms=b_ms,
                 bound_by=b_by, old_bound_ms=old_ms, old_bound_by=old_by,
                 bytes=nbytes, ops=ops, ops_old=ops_old,
                 pairs=work["pairs"], pairs_reached=work["reached"],
                 terms=work["terms"], terms_inside=work["inside"],
                 terms_masked_tested=work["masked"], slice_plan=plan), first)


def _point_args(data, tables, result, eval_range, dev):
    """clr_grid's inputs at a scan's reported points: the genome's sites
    (positions per chromosome; no window crosses one) and each point's
    window of +-eval_range sites around its reported position."""
    import numpy as np
    import torch

    from fscl_tpu_torch.convert import clr_inputs_from_numpy
    from fscl_tpu_torch.ops.windows import candidate_windows

    K = result.n_points
    lo, hi = np.zeros(K, np.int64), np.zeros(K, np.int64)
    for c, cl in enumerate(data.chr_limits):
        k = np.nonzero(result.chr_id == c)[0]
        if len(k) == 0:
            continue
        sl = slice(cl.start_index, cl.start_index + cl.n_snps)
        _, lo[k], hi[k] = candidate_windows(np.asarray(data.pos[sl]),
                                            result.sweep_pos[k], eval_range)
        lo[k] += cl.start_index
        hi[k] += cl.start_index
    site = clr_inputs_from_numpy(tables.table, data.row, data.pos,
                                 data.null_logl, device=dev)
    return (*site, *(torch.as_tensor(np.asarray(x, np.int32), device=dev)
                     for x in (result.sweep_pos, lo, hi)))


def _flagship_args(dev):
    """__graft_entry__.py:18-40's flagship problem, rebuilt with the
    port's own models.build_tables and ops/windows.py candidate_windows
    from numpy seed 0: 2,048 sites over 2 Mb, n = 24 (30% folded), 64
    candidates evenly spaced, windows of +-600 sites, grid 512; (clr_grid's
    inputs, G)."""
    import numpy as np
    import torch

    from fscl_tpu_torch.convert import clr_inputs_from_numpy
    from fscl_tpu_torch.models import build_tables
    from fscl_tpu_torch.ops.windows import candidate_windows

    n_sites, n, n_cand, span, G = 2048, 24, 64, 2_000_000, 512
    rng = np.random.default_rng(0)
    pos = np.sort(rng.choice(span, n_sites, replace=False)).astype(np.int32)
    w = 1 / np.arange(1, n)
    w /= w.sum()
    freqs = rng.choice(np.arange(1, n), p=w, size=n_sites)
    folded = rng.random(n_sites) < 0.3
    freqs = np.where(folded, np.minimum(freqs, n - freqs), freqs)
    depth_p = np.zeros(n_sites, int)
    hist = np.bincount(freqs, minlength=n + 1).astype(float)
    hist[0] = hist[n] = 0
    tables = build_tables([hist / hist.sum()], [n], grid_points=G)
    row = tables.site_rows(depth_p, folded, freqs).astype(np.int32)
    null = tables.null_logl(depth_p, folded, freqs).astype(np.float32)
    cand = np.linspace(0, span, n_cand, dtype=np.int32)
    _, lo, hi = candidate_windows(pos, cand, eval_range=600)
    site = clr_inputs_from_numpy(tables.table, row, pos, null, device=dev)
    return (*site, *(torch.as_tensor(np.asarray(x, np.int32), device=dev)
                     for x in (cand, lo, hi))), G


def phase_cgkernel(dev):
    """Phase 3i: the clr_grid kernel (csrc/clr_grid.cu) through _cg_case at
    the 20k task's dense grid (20,400 candidates, every window the whole
    chromosome) with the 11 shared coarse alphas and with each candidate's
    14 fine alphas around its coarse winner (the plain version on 64
    candidates), at the 20k scan's reported points with their reported
    lalpha (A = 1 paired, the C-parity oracle's call) and at the genome1m
    scan's reported points with the coarse alphas (two_stage_alpha_max's
    first call), at the flagship problem with the coarse alphas and its
    fine ones; and the lattice kernel at its coarse offsets against the
    clr_grid kernel at the lattice's alphas on the 20k dense grid."""
    import numpy as np
    import torch

    from fscl_tpu_torch import LOG_AD_MIN
    from fscl_tpu_torch.convert import clr_inputs_from_numpy
    from fscl_tpu_torch.engine.scan import (
        chromosome_candidates, get_lattice_tables,
    )
    from fscl_tpu_torch.ops import clr as TC
    from fscl_tpu_torch.ops import lattice as TL
    from fscl_tpu_torch.ops.windows import candidate_windows

    data, tables, cfg, result = SCANS["20k"]
    G = tables.grid_points
    site = clr_inputs_from_numpy(tables.table, data.row, data.pos,
                                 data.null_logl, device=dev)
    cand = chromosome_candidates(data.chr_limits[0], cfg)[0].reshape(-1)
    _, lo, hi = candidate_windows(np.asarray(data.pos), cand, cfg.eval_range)
    dense = (*site, *(torch.as_tensor(np.asarray(x, np.int32), device=dev)
                      for x in (cand, lo, hi)))
    P = len(cand)
    chk = torch.as_tensor(np.linspace(0, P - 1, 64).astype(np.int64),
                          device=dev)
    coarse = torch.as_tensor(TC.coarse_alpha_grid(), device=dev)
    out = []
    rec, c_out = _cg_case("20k dense coarse", dense, coarse, False, G,
                          check_cands=chk)
    out.append(rec)
    fine = TC.fine_alpha_grids(coarse[torch.argmax(c_out, dim=1)])
    out.append(_cg_case("20k dense fine", dense, fine, True, G,
                        check_cands=chk)[0])
    # the lattice kernel at its coarse offsets against this kernel at the
    # lattice's alphas
    m = TL.coarse_lattice_offsets(G)
    la_lat = torch.as_tensor(
        (LOG_AD_MIN + m * TL.lattice_step(G)).astype(np.float32), device=dev)
    lt = get_lattice_tables(tables, dev)
    lat = TL.clr_lattice(lt.pack_coarse, dense[1][None], dense[2],
                         dense[3][None], *dense[4:],
                         torch.zeros((1, P), dtype=torch.int32, device=dev),
                         lt.m_coarse_dev, grid_points=G)[0]
    grid = TC.clr_grid(*dense, la_lat, grid_points=G, device=dev)
    gap = (lat - grid).abs()
    lim = LAT_GRID_ATOL + LAT_GRID_RTOL * grid.abs()
    lat_ratio = float((gap / lim).max())
    if not bool((gap <= lim).all()):
        fail(f"cgkernel: the lattice kernel differs from clr_grid at the "
             f"lattice's alphas by up to {float(gap.max()):.4g} "
             f"({lat_ratio:.3g} x rtol {LAT_GRID_RTOL}, atol "
             f"{LAT_GRID_ATOL})")
    log(f"[cgkernel] lattice kernel vs clr_grid kernel at the lattice's 11 "
        f"coarse alphas, 20k dense grid: max |diff| {float(gap.max()):.4g} "
        f"({lat_ratio:.3g} x the tolerance)")
    del c_out, fine, lat, grid, gap, lim
    pts = _point_args(data, tables, result, cfg.eval_range, dev)
    la_rep = torch.as_tensor(result.lalpha.astype(np.float32)[:, None],
                             device=dev)
    out.append(_cg_case("20k reported points, reported lalpha (oracle)",
                        pts, la_rep, True, G)[0])
    gdata, gtables, gcfg, gres = SCANS["genome1m"]
    gpts = _point_args(gdata, gtables, gres, gcfg.eval_range, dev)
    K = gres.n_points
    gchk = torch.as_tensor(np.linspace(0, K - 1, 64).astype(np.int64),
                           device=dev)
    out.append(_cg_case("genome1m reported points, coarse alphas", gpts,
                        coarse, False, gtables.grid_points,
                        check_cands=gchk, iters=5)[0])
    flag, fG = _flagship_args(dev)
    rec, f_out = _cg_case("flagship problem, coarse alphas", flag, coarse,
                          False, fG)
    out.append(rec)
    out.append(_cg_case("flagship problem, fine alphas", flag,
                        TC.fine_alpha_grids(
                            coarse[torch.argmax(f_out, dim=1)]),
                        True, fG)[0])
    torch.cuda.empty_cache()
    return dict(cgkernel=out, lattice_vs_clr_grid_over_tol=lat_ratio)


def phase_exact(dev):
    """Phase 4e: two_stage_alpha_max (11 coarse and 14 fine alphas, the
    reference's search) at the 20k and genome1m scans' reported positions,
    its kernel launches counted; the exact CLRs against the plain version
    within CG_REL * S + CG_ABS (S at the exact lalpha; the plain search on
    every 20k point and on 256 genome1m points), all finite.  The gap
    |reported - exact| (max, mean, 99th percentile), the points where
    the scan reports more than the exact maximum, and the gap to clr_grid
    at the reported position and lalpha (the C-parity oracle's call: the
    scan's own table error) are printed: findings, not gates.  The
    launches counted (clr_grid_partials and clr_grid_reduce, two a call)
    are those of two_stage_alpha_max and the oracle's call."""
    import numpy as np
    import torch

    from fscl_tpu_torch.ops import clr as TC

    out = {}
    launches = 0
    for label in ("20k", "genome1m"):
        data, tables, cfg, result = SCANS[label]
        G = tables.grid_points
        args = _point_args(data, tables, result, cfg.eval_range, dev)
        torch.cuda.synchronize()
        TC.clr_grid_launches = 0
        t0 = time.monotonic()
        clr, la = TC.two_stage_alpha_max(*args, grid_points=G, device=dev)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        # the CLR at the reported position and lalpha (the oracle's call)
        at = TC.clr_grid(*args, torch.as_tensor(
            result.lalpha.astype(np.float32)[:, None], device=dev),
            grid_points=G, paired_alpha=True, device=dev)[:, 0]
        n = TC.clr_grid_launches
        if n <= 0:
            fail(f"exact {label}: clr_grid was never launched")
        launches += n
        K = result.n_points
        if not bool(torch.isfinite(clr).all()) or clr.shape != (K,):
            fail(f"exact {label}: {tuple(clr.shape)} exact CLRs, or a "
                 "non-finite one")
        chk = (torch.arange(K, device=dev) if K <= 256 else torch.as_tensor(
            np.linspace(0, K - 1, 256).astype(np.int64), device=dev))
        sub, _ = _cg_sub(args, la, False, chk)
        # the same search with each stage's clr_grid the plain version
        orig = TC._clr_grid
        TC._clr_grid = lambda a, plan, g, paired: TC.clr_grid_plain(
            *a, grid_points=g, paired_alpha=paired)
        try:
            p_clr, _ = TC.two_stage_alpha_max(*sub, grid_points=G,
                                              device=dev)
        finally:
            TC._clr_grid = orig
        S = _cg_scale(sub, la[chk][:, None], True, G)[:, 0]
        err = (clr[chk] - p_clr).abs().double()
        lim = CG_REL * S + CG_ABS
        if not bool((err <= lim).all()):
            fail(f"exact {label}: card vs plain exact CLR up to "
                 f"{float(err.max()):.4g} ({float((err / lim).max()):.3g} x "
                 f"{CG_REL} S + {CG_ABS})")
        at_gap = np.abs(result.clr - at.double().cpu().numpy())
        exact = clr.double().cpu().numpy()
        gap = result.clr - exact
        agap = np.abs(gap)
        above = int((gap > 0).sum())
        rec = dict(points=K, launches=n, wall_s=wall,
                   card_vs_plain_max=float(err.max()),
                   plain_points=int(chk.numel()),
                   gap_max=float(agap.max()), gap_mean=float(agap.mean()),
                   gap_p99=float(np.percentile(agap, 99)),
                   reported_above=above,
                   at_reported_gap_max=float(at_gap.max()),
                   at_reported_gap_mean=float(at_gap.mean()),
                   at_reported_gap_p99=float(np.percentile(at_gap, 99)),
                   lalpha_equal=int((np.abs(result.lalpha - la.double().cpu()
                                            .numpy()) < 1e-6).sum()))
        log(f"[exact] {label}: {K} reported points, two_stage_alpha_max "
            f"{wall:.3f}s ({n} clr_grid launches); card vs plain exact CLR "
            f"max |diff| {rec['card_vs_plain_max']:.4g} on {chk.numel()} "
            f"points; |reported - exact| max {rec['gap_max']:.4g}, mean "
            f"{rec['gap_mean']:.4g}, p99 {rec['gap_p99']:.4g}; reported > "
            f"exact at {above} of {K} points; reported lalpha equal to the "
            f"exact one at {rec['lalpha_equal']}; |reported - CLR at the "
            f"reported position and lalpha| max "
            f"{rec['at_reported_gap_max']:.4g}, mean "
            f"{rec['at_reported_gap_mean']:.4g}, p99 "
            f"{rec['at_reported_gap_p99']:.4g}")
        out[label] = rec
    out["launches"] = launches
    return out


# phase 8: bench/headline.py cfg_ms_sweep's flags; the null-calibration
# file's replicates (users run thousands; 200 keep the call in its limit)
MS_SWEEP = REPO / "bench" / "data" / "headline_ms_sweep.ms"
MS_SWEEP_FLAGS = ["--ms-segment-length", "5000000", "--ms-folded", "-p",
                  "100"]
MS_NULL_FLAGS = ["--ms-segment-length", "5000000", "--ms-folded",
                 "--max-only"]
MS_NULL_BLOCKS = 200


def _all_counts():
    """Launches of every kernel since _zero_all_counts."""
    from fscl_tpu_torch.ops import clr as TC
    from fscl_tpu_torch.ops import gather as G
    from fscl_tpu_torch.ops import lattice as TL
    from fscl_tpu_torch.ops import prefix_sums as ps

    return dict(_window_counts(), prefix=ps.launches,
                weighted=ps.weighted_launches, rowid=ps.rowid_launches,
                perm=ps.perm_launches, row_gather=G.gather_launches,
                lattice=TL.lattice_clr_launches,
                clr_grid=TC.clr_grid_launches)


def _zero_all_counts():
    from fscl_tpu_torch.ops import clr as TC
    from fscl_tpu_torch.ops import gather as G
    from fscl_tpu_torch.ops import lattice as TL
    from fscl_tpu_torch.ops import prefix_sums as ps

    _zero_window_counts()
    ps.launches = ps.weighted_launches = ps.rowid_launches = 0
    ps.perm_launches = G.gather_launches = 0
    TL.lattice_clr_launches = TC.clr_grid_launches = 0


def _ms_run(path, tsv, flags, device, f32=False):
    """The ms pipeline through the CLI's parser on ``device`` (with
    ``f32``, its permutation statistic at hist_bf16=False, as phase 6
    compares card and CPU); (host-clocked seconds a block by stage, wall
    s, the blocks' permuted ScanResults).  The stages are timed around
    the pipeline's own calls: "parse" the read of a block and its
    SNPData (iter_ms_blocks), "attach" from there to scan_genome
    (attach_model), "scan", "permute" (scan_permute), "output" from
    there to the next block's read (scan_output and the null rows)."""
    import dataclasses

    import torch

    from fscl_tpu_torch.cli import build_parser, validate_args
    from fscl_tpu_torch.io import ms_input as TI

    args = validate_args(build_parser().parse_args(
        ["-m", str(path), "-o", str(tsv), "-v", "1", "--device",
         str(device), *flags]))
    results, walls, mark = [], {}, [None]
    orig = TI.iter_ms_blocks, TI.scan_genome, TI.scan_permute

    def clock(key):
        t = time.monotonic()
        if mark[0] is not None:
            walls.setdefault(key, []).append(t - mark[0])
        mark[0] = t

    def blocks(*a, **k):
        it = orig[0](*a, **k)
        while True:
            clock("output")
            try:
                data = next(it)
            except StopIteration:
                return
            clock("parse")
            yield data

    def scan(*a, **k):
        clock("attach")
        out = orig[1](*a, **k)
        clock("scan")
        return out

    def permute(data, tables, result, scan_cfg, perm_cfg, **k):
        if f32:
            perm_cfg = dataclasses.replace(perm_cfg, hist_bf16=False)
        out = orig[2](data, tables, result, scan_cfg, perm_cfg, **k)
        clock("permute")
        results.append(result)
        return out

    TI.iter_ms_blocks, TI.scan_genome, TI.scan_permute = blocks, scan, permute
    try:
        if str(device) != "cpu":
            torch.cuda.synchronize()
        t0 = time.monotonic()
        TI.ms_pipeline(args, device)
        if str(device) != "cpu":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        TI.iter_ms_blocks, TI.scan_genome, TI.scan_permute = orig
    return walls, wall, results


def _ms_rows(tsv):
    import numpy as np

    rows = [line.rstrip("\n").split("\t") for line in open(tsv)]
    if not rows or not np.isfinite([float(r[2]) for r in rows]).all():
        fail(f"ms: {tsv.name} has no rows or a non-finite CLR")
    return rows


def _null_ms_file(path, n_blocks, *, n=50, segsites=2500, seed=12):
    """An ms file of n_blocks neutral replicates made from a seed: each
    block segsites sites at sorted uniform positions, derived counts from
    the neutral 1/i spectrum, each site's derived alleles on random
    haplotypes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    i = np.arange(1, n)
    p = (1.0 / i) / (1.0 / i).sum()
    with open(path, "w") as f:
        f.write(f"ms {n} {n_blocks} -s {segsites}\n{seed} 0 0\n")
        for _ in range(n_blocks):
            pos = np.sort(rng.random(segsites))
            d = rng.choice(i, size=segsites, p=p)
            hap = rng.random((n, segsites)).argsort(axis=0) < d[None, :]
            text = np.where(hap, ord("1"), ord("0")).astype(np.uint8)
            f.write("\n//\nsegsites: %d\npositions: %s\n" % (
                segsites, " ".join(f"{x:.8f}" for x in pos)))
            f.write("\n".join(r.tobytes().decode() for r in text) + "\n")


def phase_ms(dev):
    """Phase 8: the ms pipeline (-m) on the card.  (a) bench/data/
    headline_ms_sweep.ms (10 blocks, 50 haplotypes, 2,500 sites each)
    with cfg_ms_sweep's flags (5 Mb segments, --ms-folded, 100
    permutations): per-block scan and permutation walls, point-rounds/s;
    its first two blocks on the card and with the plain CPU versions, the
    permutation statistic in float32 as phase 6 runs it (the bfloat16
    kernel is held to its plain version within a tolerance, not
    bitwise): CLR, thresholds and each replicate's statistic within 1e-3,
    each replicate's exceedance equal unless it lies within 1e-4 of its
    threshold; the points whose counts agree are reported (one differing
    exceedance shifts the pruning generator a block's points share).  (b) a 200-replicate neutral
    file made from a seed (n = 50, 2,500 sites, 5 Mb, --ms-folded
    --max-only, no permutations): total and median block walls and each
    stage's share of a block (parse, attach_model, scan, output).  Every
    kernel's launches counted over (a) and over (b): the one-hot prefix
    kernel and the two window kernels must run in (a), the window kernels
    in (b)."""
    import numpy as np

    out = {}
    _zero_all_counts()
    walls, wall, _ = _ms_run(MS_SWEEP, OUT / "ms_sweep.tsv", MS_SWEEP_FLAGS,
                             dev)
    ca = _all_counts()
    rows = _ms_rows(OUT / "ms_sweep.tsv")
    n_blocks = len({r[0] for r in rows})
    pr = sum(int(r[5]) for r in rows)
    t_perm = sum(walls["permute"])
    if n_blocks != 10 or pr <= 0:
        fail(f"ms sweep: {n_blocks} blocks, {pr} point-rounds")
    if min(ca["prefix"], ca["window_clr"], ca["window_clr_f32"]) <= 0:
        fail(f"ms sweep: kernel launches {ca}")
    log(f"[ms] sweep file: {n_blocks} blocks, {len(rows)} points, wall "
        f"{wall:.3f}s; per block scan "
        f"{' '.join(f'{t:.3f}' for t in walls['scan'])} s, permutations "
        f"{' '.join(f'{t:.3f}' for t in walls['permute'])} s; {pr} "
        f"point-rounds, {pr / t_perm:.1f} point-rounds/s; kernel launches "
        f"{ca}")
    out["sweep"] = dict(wall_s=wall, walls=walls, points=len(rows),
                        point_rounds=pr, point_rounds_per_s=pr / t_perm,
                        launches=ca)
    # card vs CPU on the first two blocks
    two = OUT / "ms_sweep2.ms"
    two.write_text("\n//".join(MS_SWEEP.read_text().split("\n//")[:3])
                   + "\n")
    res = {}
    for d, name in ((dev, "card"), ("cpu", "cpu")):
        res[str(d)] = _ms_run(two, OUT / f"ms_sweep2.{name}.tsv",
                              MS_SWEEP_FLAGS, d, f32=True)[2]
    two.unlink()
    g_all, c_all = res[str(dev)], res["cpu"]
    if len(g_all) != len(c_all) or len(g_all) != 2:
        fail(f"ms sweep, two blocks: {len(g_all)} card and {len(c_all)} "
             "CPU blocks")
    d_clr = d_thr = d_null = 0.0
    compared = flips = same = points = 0
    for g, c in zip(g_all, c_all):
        if not np.array_equal(g.sweep_pos, c.sweep_pos):
            fail("ms sweep, two blocks: card and CPU positions differ")
        d_clr = max(d_clr, float(np.abs(g.clr - c.clr).max()))
        d_thr = max(d_thr, float(np.abs(g.stat_threshold
                                        - c.stat_threshold).max()))
        # replicate k's sigma is a function of (seed, k) alone, so the
        # saved nulls of a point line up replicate by replicate as far as
        # both devices ran it; the pruning's host generator, shared by a
        # block's points, draws differently for every later point once
        # one exceedance differs, so the counts themselves are reported
        for i in range(g.n_points):
            ng, nc = (np.asarray(r.null_clr[i]) for r in (g, c))
            m = min(len(ng), len(nc))
            ng, nc = ng[:m], nc[:m]
            tg, tc = g.stat_threshold[i], c.stat_threshold[i]
            if m:
                d_null = max(d_null, float(np.abs(ng - nc).max()))
            flip = (ng >= tg) != (nc >= tc)
            off = np.minimum(np.abs(ng - tg), np.abs(nc - tc))
            if np.any(flip & (off >= 1e-4)):
                fail(f"ms sweep, two blocks: point {i}'s replicate "
                     "exceedances differ between card and CPU off the "
                     "near-ties")
            compared += m
            flips += int(flip.sum())
        same += int(np.sum((g.permute_p == c.permute_p)
                           & (g.permute_n == c.permute_n)))
        points += g.n_points
    if max(d_clr, d_thr, d_null) > 1e-3:
        fail(f"ms sweep, two blocks: card vs CPU clr {d_clr:.3g}, "
             f"threshold {d_thr:.3g}, replicate statistic {d_null:.3g} "
             "(limit 1e-3)")
    log(f"[ms] sweep file, first two blocks: card vs CPU max |dCLR| "
        f"{d_clr:.3g}, max |dthreshold| {d_thr:.3g}, max |d replicate "
        f"statistic| {d_null:.3g} over {compared} (point, replicate) "
        f"pairs; exceedances differ at {flips} of them, each within 1e-4 "
        f"of its threshold; counts p/n equal at {same} of {points} points")
    out["sweep_two_blocks"] = dict(d_clr=d_clr, d_thr=d_thr, d_null=d_null,
                                   compared=compared, flips=flips,
                                   same_counts=same, points=points)
    # (b) null calibration over replicates
    path = OUT / "ms_null.ms"
    _null_ms_file(path, MS_NULL_BLOCKS)
    _zero_all_counts()
    walls, wall, _ = _ms_run(path, OUT / "ms_null.tsv", MS_NULL_FLAGS, dev)
    path.unlink()
    cb = _all_counts()
    rows = _ms_rows(OUT / "ms_null.tsv")
    if len(rows) != MS_NULL_BLOCKS:
        fail(f"ms null: {len(rows)} rows for {MS_NULL_BLOCKS} blocks")
    if min(cb["window_clr"], cb["window_clr_f32"]) <= 0:
        fail(f"ms null: kernel launches {cb}")
    stages = ("parse", "attach", "scan", "output")
    block = np.sum([walls[s] for s in stages], axis=0)
    med = {s: float(np.median(walls[s])) for s in stages}
    share = {s: float(np.sum(walls[s]) / block.sum()) for s in stages}
    log(f"[ms] null file: {MS_NULL_BLOCKS} blocks, wall {wall:.3f}s, "
        f"blocks {block.sum():.3f}s, median block {np.median(block):.4f}s "
        f"(parse {med['parse']:.4f}, attach_model {med['attach']:.4f}, scan "
        f"{med['scan']:.4f}, output {med['output']:.4f}); shares of the "
        f"blocks' time: " + ", ".join(f"{s} {100 * share[s]:.1f}%"
                                      for s in stages)
        + f"; kernel launches {cb}")
    out["null"] = dict(blocks=MS_NULL_BLOCKS, wall_s=wall,
                       blocks_s=float(block.sum()),
                       median_block_s=float(np.median(block)),
                       median_stage_s=med, stage_share=share, launches=cb)
    return out


def phase_check(dev):
    """Small inputs on the card against the plain CPU versions."""
    import numpy as np

    from fscl_tpu_torch.models import background_fsp, build_tables
    from fscl_tpu_torch.engine import scan_genome, scan_permute
    from fscl_tpu_torch.engine.permute import PermuteConfig
    from fscl_tpu_torch.engine.scan import ScanConfig, make_scan_hist_tables
    from fscl_tpu_torch.ops import lattice as TL

    out = {}
    # (label, data, CLR/threshold tolerance, near-tie band, grid, scan and
    # permutation settings, whether it takes the lattice path): single-
    # depth with the one-hot bounds; mixed-depth f32 weight sums add the
    # rounding of sqrt(W)-sized prefixes, hence the wider bounds (tests/
    # test_torch_mixed_depth.py states the same ones against fscl_tpu);
    # the single-depth input again through --no-hist, and a dense-cluster
    # input past the hist gate (tests/test_torch_lattice.py's settings),
    # both on the lattice path
    small = (dict(eval_range=1500, small_grid_sp=10000,
                  large_grid_sp=200000, exact_step_max=1.0,
                  selection_bf16=False),
             dict(n_permute=48, seed=3, hist_bf16=False, scan_width_mb=0.1))
    cluster = (dict(eval_range=500, small_grid_sp=50_000_000,
                    large_grid_sp=250_000_000),
               dict(n_permute=16, chunk_replicates=16, seed=2))
    for label, data, tol, band, grid, (skw, pkw), lattice in (
            ("single-depth", _single_depth_check_data(), 1e-3, 1e-4, 1024,
             small, False),
            ("mixed-depth", _mixed_check_data(), MIXED_TOL, MIXED_BAND,
             1024, small, False),
            ("single-depth --no-hist", _single_depth_check_data(), 1e-3,
             1e-4, 1024, (dict(small[0], use_hist=False),
                          dict(small[1], use_hist=False)), True),
            ("dense cluster past the hist gate", _dense_cluster_check_data(),
             1e-3, 1e-4, 256, cluster, True)):
        scan_cfg = ScanConfig(**skw)
        perm_cfg = PermuteConfig(**pkw)
        fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                             data.sample_depths)
        tables = build_tables(fsp, data.sample_depths, grid_points=grid)
        data.attach_model(tables)
        ht = make_scan_hist_tables(data, tables, scan_cfg.hist_alphas,
                                   device="cpu")
        if (ht is None) != label.startswith("dense cluster"):
            fail(f"check: {label} data hist gate closed={ht is None}")
        compressed = ht is not None and ht.weights is not None
        if compressed != (label == "mixed-depth"):
            fail(f"check: {label} data compressed={compressed}")
        res = {}
        TL.lattice_clr_launches = 0
        for d in (dev, "cpu"):
            r = scan_genome(data, tables, scan_cfg, device=d)
            scan_permute(data, tables, r, scan_cfg, perm_cfg, device=d)
            res[str(d)] = r
        if (TL.lattice_clr_launches > 0) != lattice:
            fail(f"check {label}: {TL.lattice_clr_launches} lattice kernel "
                 "launches")
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


RDP_CHUNK = 32  # replicates of the RDP run's first chunk (chunk_replicates)


def phase_rdp(dev):
    """Phase 7: the four routes to the permutation statistic on the card,
    on one stream of the 20k task; every kernel's launches counted."""
    import numpy as np
    import torch

    from fscl_tpu_torch.engine import permute as TP
    from fscl_tpu_torch.engine.scan import scan_genome
    from fscl_tpu_torch.ops import gather as G
    from fscl_tpu_torch.ops import histclr as H
    from fscl_tpu_torch.ops import prefix_sums as ps
    from fscl_tpu_torch.ops.permute import (
        PERM_GROUP, block_permutation_runs, expand_group_sigma,
        sigma_from_runs,
    )

    data, tables, scan_cfg = _task_20k()
    perm_cfg = TP.PermuteConfig(n_permute=64, chunk_replicates=RDP_CHUNK,
                                seed=1, hist_bf16=False)
    result = scan_genome(data, tables, scan_cfg, device=dev)
    torch.cuda.synchronize()
    ps.launches = ps.weighted_launches = 0
    ps.rowid_launches = ps.perm_launches = 0

    # (i) scan_permute with the RDP tail forced on and off; the row
    # gather and the window kernel counted in each
    runs, walls, stats, glaunch = {}, {}, {}, {}
    saved = TP.RDP_FORCE
    for force in ("on", "off"):
        r = copy.deepcopy(result)
        TP.RDP_FORCE = force
        G.gather_launches = 0
        _zero_window_counts()
        try:
            t0 = time.monotonic()
            TP.scan_permute(data, tables, r, scan_cfg,
                            copy.deepcopy(perm_cfg), device=dev)
            torch.cuda.synchronize()
            walls[force] = time.monotonic() - t0
        finally:
            TP.RDP_FORCE = saved
        runs[force], stats[force] = r, dict(TP.last_stats)
        glaunch[force] = dict(gather=G.gather_launches, **_window_counts())
    on, off = runs["on"], runs["off"]
    if glaunch["on"]["gather"] <= 0 or glaunch["off"]["gather"] or any(
            g["window_clr_f32"] <= 0 or g["window_clr"] or g["window_operand"]
            for g in glaunch.values()):
        fail(f"rdp: row gather / window kernel launches {glaunch} (the "
             "gather must run under RDP on only, the float32 kernel in "
             "both, the bfloat16 kernel and the window operand in neither)")
    if stats["on"]["rdp_dispatches"] <= 0 or stats["on"]["stack_dispatches"]:
        fail(f"rdp: RDP forced on dispatched {stats['on']}")
    if stats["off"]["rdp_dispatches"] or stats["off"]["stack_dispatches"] <= 0:
        fail(f"rdp: RDP forced off dispatched {stats['off']}")
    if not np.array_equal(on.stat_threshold, off.stat_threshold):
        fail("rdp: thresholds differ between the RDP and stacked runs")
    near = sorted({
        i for i in range(result.n_points) for r in (on, off)
        if np.any(np.abs(np.asarray(r.null_clr[i]) - r.stat_threshold[i])
                  < 1e-4)
    })
    keep = np.setdiff1d(np.arange(result.n_points), near)
    if not (np.array_equal(on.permute_n[keep], off.permute_n[keep])
            and np.array_equal(on.permute_p[keep], off.permute_p[keep])):
        fail("rdp: permutation counts differ between the RDP and stacked "
             "runs off the near-tie points")
    d_null = max((float(np.abs(np.subtract(on.null_clr[i][:n],
                                           off.null_clr[i][:n])).max())
                  for i in keep
                  for n in [min(len(on.null_clr[i]), len(off.null_clr[i]))]
                  if n), default=0.0)
    pr_on, pr_off = int(on.permute_n.sum()), int(off.permute_n.sum())
    log(f"[rdp] (i) 20k, 64 permutations, hist_bf16=False: RDP "
        f"{walls['on']:.3f}s ({stats['on']['rdp_dispatches']} RDP chunks, "
        f"{pr_on / walls['on']:.1f} point-rounds/s), stacked "
        f"{walls['off']:.3f}s ({stats['off']['stack_dispatches']} stacked "
        f"dispatches, {pr_off / walls['off']:.1f} point-rounds/s); "
        f"thresholds equal; counts equal on {len(keep)} of "
        f"{result.n_points} points (near-tie points excluded: {near}); max "
        f"|null statistic difference| {d_null:.3g}")

    # (ii) the RDP run's first chunk through hist_clr_reps (kernel 3a)
    # and _hist_perm_batch (kernel 3b)
    fresh = copy.deepcopy(result)
    hs = TP.setup_hist(data, tables, fresh, scan_cfg, perm_cfg, dev)
    ht = hs.ht
    Jf = TP.stat_positions(perm_cfg)
    width = perm_cfg.scan_width_mb * 1e6

    def runs_source(n, start):
        return block_permutation_runs(perm_cfg.seed, data.genome_pos(),
                                      width, n, start=start, device=dev)

    tail = TP._RdpTail(hs, fresh, scan_cfg.eval_range, Jf, runs_source,
                       False)
    pts, stat_rdp = tail.chunk(np.ones(fresh.n_points, bool), RDP_CHUNK, 0)
    _, _, bounds, fbar = tail.ctx
    src, dst, sz = runs_source(RDP_CHUNK, 0)
    sigma8 = sigma_from_runs(src, dst, hs.n_groups)
    kw = dict(n_cells=ht.n_cells, n_rows=ht.n_rows, n_alpha=ht.n_alpha)
    clr_rdp = H.rdp_clr_reps(ht.t3, bounds, fbar, tail.psite, src, dst, sz,
                             n_rep=RDP_CHUNK, pg=PERM_GROUP,
                             n_groups=hs.n_groups, **kw)
    row_rep = hs.row_cg[expand_group_sigma(sigma8, data.n_snps).long()]
    clr_h = H.hist_clr_reps(ht.t3, bounds, fbar, row_rep, **kw)
    stat_h = clr_h.reshape(RDP_CHUNK, len(pts), -1).amax(2)
    cl = data.chr_limits[0]
    w_pad = hs.stacks[0].w_seg_p
    stat_b = TP._hist_perm_batch(
        ht.t3, bounds - cl.start_index, fbar, hs.row_cg,
        hs.pad_sigma(sigma8), start=cl.start_index, n=cl.n_snps,
        w_pad=w_pad, n_pts=len(pts), Jf=Jf, **kw)
    torch.cuda.synchronize()
    if len(data.chr_limits) != 1 or len(pts) != result.n_points:
        fail("rdp: the 20k task is one chromosome with every point active")
    for what, got, want in (
            ("hist_clr_reps CLR", clr_h, clr_rdp),
            ("hist_clr_reps statistic", stat_h, stat_rdp),
            ("_hist_perm_batch statistic", stat_b, stat_rdp)):
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-3):
            d = float((got - want).abs().max())
            fail(f"rdp: {what} differs from the RDP route by {d:.4g} "
                 "(limit 1e-5 relative + 1e-3)")
    d_h = float((clr_h - clr_rdp).abs().max())
    d_b = float((stat_b - stat_rdp).abs().max())
    launches = dict(onehot=ps.launches, weighted=ps.weighted_launches,
                    rowid=ps.rowid_launches, perm=ps.perm_launches,
                    gather_rdp_on=glaunch["on"]["gather"],
                    window_f32_rdp_on=glaunch["on"]["window_clr_f32"],
                    window_f32_rdp_off=glaunch["off"]["window_clr_f32"],
                    window_f32_reduce_rdp_on=glaunch["on"][
                        "window_clr_f32_reduce"],
                    window_f32_reduce_rdp_off=glaunch["off"][
                        "window_clr_f32_reduce"])
    log(f"[rdp] (ii) first RDP chunk ({RDP_CHUNK} replicates, "
        f"{len(pts)} points, {bounds.shape[0]} candidates): hist_clr_reps "
        f"CLR max |diff| {d_h:.3g}, _hist_perm_batch statistic max |diff| "
        f"{d_b:.3g} against the RDP route; the phase's kernel launches "
        f"{launches}")
    if min(launches["onehot"], launches["rowid"], launches["perm"]) <= 0 \
            or launches["weighted"]:
        fail(f"rdp: a kernel of the path did not launch: {launches}")

    # (iii) the same chunk on the bfloat16 route: rdp_clr_reps (its
    # identity bounds) and hist_clr_reps reach the fused kernel only
    _zero_window_counts()
    clr_rdp16 = H.rdp_clr_reps(ht.t3, bounds, fbar, tail.psite, src, dst, sz,
                               n_rep=RDP_CHUNK, pg=PERM_GROUP,
                               n_groups=hs.n_groups, mm_bf16=True, **kw)
    clr_h16 = H.hist_clr_reps(ht.t3, bounds, fbar, row_rep, mm_bf16=True,
                              **kw)
    torch.cuda.synchronize()
    bf16_launches = _window_counts()
    if bf16_launches["window_clr"] <= 0 or bf16_launches["window_operand"] \
            or bf16_launches["window_clr_f32"]:
        fail(f"rdp: bfloat16 routes launched {bf16_launches}")
    if not torch.allclose(clr_h16, clr_rdp16, rtol=1e-5, atol=1e-3):
        fail("rdp: bfloat16 hist_clr_reps differs from the RDP route by "
             f"{float((clr_h16 - clr_rdp16).abs().max()):.4g}")
    d_16 = float((clr_h16 - clr_rdp16).abs().max())
    log(f"[rdp] (iii) the same chunk with bfloat16 operands: hist_clr_reps "
        f"vs rdp_clr_reps max |diff| {d_16:.3g}; launches {bf16_launches}")

    # phases 3d and 3e at the RDP tail's shapes: a slice of RDP_REP_SUB
    # replicates (what one rdp_clr_reps call takes in a chunk of at least
    # that many, as the deep tail's are), its first candidate chunk
    P, R, NC = TP.RDP_REP_SUB, ht.n_rows, ht.n_cells
    s, d, z = (x.to(device=dev, dtype=torch.int32)
               for x in runs_source(P, 0))
    tabs = H._rdp_tables(tail.psite, s, d, z, pg=PERM_GROUP,
                         n_groups=hs.n_groups)
    bc = bounds[:H._chunk_rows(NC, P, R)]
    d_idx, s_idx = H._rdp_rows(bc, tabs, pg=PERM_GROUP,
                               n_sites1=tail.psite.shape[0])
    gkern = [_gather_case("20k RDP psite rows", tail.psite, s_idx),
             _gather_case("20k RDP run constants", tabs[0], d_idx)]
    M = bc.numel()
    a = G.row_gather(tabs[0], d_idx) + G.row_gather(tail.psite, s_idx)
    ident = torch.arange(M, dtype=torch.int32, device=dev).view(-1, 2,
                                                                NC + 1)
    rdp_slice = dict(ps=a.view(M, P * R), bounds=ident,
                     fbar=fbar[:bc.shape[0]].contiguous(), n_rep=P,
                     n_cells=NC, n_rows=R)
    okern = _window_case("20k RDP slice (identity bounds)", **rdp_slice)
    f32kern = [_window_clr_f32_case("20k RDP slice (identity bounds)",
                                    **rdp_slice, t3=ht.t3,
                                    n_alpha=ht.n_alpha)]
    return dict(walls=walls, stats=stats, near_ties=near, kept=len(keep),
                d_null=d_null, d_hist_clr_reps=d_h, d_hist_perm_batch=d_b,
                d_bf16=d_16, bf16_launches=bf16_launches,
                launches=launches, n_points=result.n_points,
                rowid_shape=(RDP_CHUNK, data.n_snps, ht.n_rows),
                perm_shape=(cl.n_snps, w_pad, RDP_CHUNK, ht.n_rows),
                psite_shape=tuple(tail.psite.shape), gkernel=gkern,
                okernel=okern, f32kernel=f32kern)


# ---- phase 9: checkpoint and resume ------------------------------------------

RESUME_BREAK = 16  # the round each interrupted run stops at
RESUME_NEAR = 1e-4  # near-tie band where resumed bits differ (as phase 7)


def _unpermuted(result):
    """A copy of a scan result with no permutation state."""
    r = copy.deepcopy(result)
    r.permute_n[:] = 0
    r.permute_p[:] = 0
    r.permute_finished[:] = False
    r.null_clr = [None] * r.n_points
    r.stat_threshold = None
    return r


def _permute_run(scanned, cfg, dev, ck=None, starts=None):
    """scan_permute on a fresh copy of a scan result, with the port's own
    sigma and runs streams wrapped to record each chunk's start; with
    ``ck`` the run checkpoints there (and resumes if the file exists).
    (result, host-clocked wall s, last_stats, kernel launches)."""
    import dataclasses

    import torch

    from fscl_tpu_torch.engine import permute as TP
    from fscl_tpu_torch.ops.permute import (
        block_permutation_groups, block_permutation_runs,
    )

    data, tables, scan_cfg, result = scanned
    gp, width = data.genome_pos(), cfg.scan_width_mb * 1e6
    starts = [] if starts is None else starts

    def sigma_source(n, start):
        starts.append(start)
        return block_permutation_groups(cfg.seed, gp, width, n, start=start,
                                        device=dev)

    def runs_source(n, start):
        starts.append(start)
        return block_permutation_runs(cfg.seed, gp, width, n, start=start,
                                      device=dev)

    r = _unpermuted(result)
    torch.cuda.synchronize()
    _zero_all_counts()
    t0 = time.monotonic()
    TP.scan_permute(data, tables, r, scan_cfg,
                    dataclasses.replace(cfg, checkpoint_path=ck), device=dev,
                    sigma_source=sigma_source, runs_source=runs_source)
    torch.cuda.synchronize()
    return r, time.monotonic() - t0, dict(TP.last_stats), _all_counts()


def _resume_case(label, scanned, cfg, dev, smi, must_launch,
                 n_break=RESUME_BREAK):
    """The run to cfg.n_permute uninterrupted, then stopped at n_break
    with a checkpoint and resumed from the file: the break must be a chunk
    boundary of the uninterrupted run and come before any pruning draw
    (permute_p < PRUNE_THRESHOLD everywhere), and the resumed leg must
    launch the kernels in ``must_launch``.  The two results equal bit for
    bit; where the card gives other bits, the largest difference and its
    first point are printed and the counts held equal off points with a
    saved replicate within RESUME_NEAR of its threshold (listed)."""
    import dataclasses

    import numpy as np

    from fscl_tpu_torch.engine import permute as TP

    ck = str(OUT / f"resume_{label.split()[0]}.npz")
    for p in (ck, ck + ".log"):
        pathlib.Path(p).unlink(missing_ok=True)
    s_full, s_part, s_res = [], [], []
    full, t_full, st_full, _ = _permute_run(scanned, cfg, dev,
                                            starts=s_full)
    part, t_part, _, _ = _permute_run(
        scanned, dataclasses.replace(cfg, n_permute=n_break), dev, ck,
        starts=s_part)
    resumed, t_res, st_res, c_res = _permute_run(scanned, cfg, dev, ck,
                                                 starts=s_res)
    for p in (ck, ck + ".log"):
        pathlib.Path(p).unlink(missing_ok=True)
    bounds = sorted(set(s_full)) + [cfg.n_permute]
    log(f"[resume] ({label}) chunk starts: uninterrupted {s_full}, stopped "
        f"{s_part}, resumed {s_res}; at the break max permute_p "
        f"{int(part.permute_p.max())}")
    if n_break not in s_full:
        fail(f"resume ({label}): the break at {n_break} is not a chunk "
             f"boundary of the uninterrupted run ({bounds})")
    if part.permute_p.max() >= TP.PRUNE_THRESHOLD:
        fail(f"resume ({label}): a pruning draw came before the break")
    missing = [k for k in must_launch if c_res[k] <= 0]
    if missing:
        fail(f"resume ({label}): the resumed leg launched no {missing}: "
             f"{c_res}")
    fields = ("permute_n", "permute_p", "permute_finished", "stat_threshold")
    same = all(np.array_equal(getattr(full, f), getattr(resumed, f))
               for f in fields)
    diff_nulls = [i for i in range(full.n_points)
                  if full.null_clr[i] != resumed.null_clr[i]]
    out = dict(label=label, n_permute=cfg.n_permute, n_break=n_break,
               starts=dict(full=s_full, stopped=s_part, resumed=s_res),
               walls_s=dict(full=t_full, stopped=t_part, resumed=t_res),
               stats=dict(full=st_full, resumed=st_res),
               resumed_launches=c_res, bitwise=same and not diff_nulls)
    if out["bitwise"]:
        log(f"[resume] ({label}) {full.n_points} points, "
            f"{int(full.permute_finished.sum())} finished: permute_n, "
            "permute_p, permute_finished, stat_threshold and every null_clr "
            f"equal bit for bit; walls uninterrupted {t_full:.3f}s, stopped "
            f"{t_part:.3f}s, resumed {t_res:.3f}s ({smi}); resumed leg's "
            f"launches {c_res}")
        return out
    d_thr = float(np.abs(full.stat_threshold - resumed.stat_threshold).max())
    d_null = max((float(np.abs(np.subtract(a[:n], b[:n])).max())
                  for a, b in zip(full.null_clr, resumed.null_clr)
                  for n in [min(len(a), len(b))] if n), default=0.0)
    first = min([i for f in fields for i in np.flatnonzero(
        getattr(full, f) != getattr(resumed, f))] + diff_nulls)
    near = sorted({i for i in range(full.n_points) for r in (full, resumed)
                   if np.any(np.abs(np.asarray(r.null_clr[i])
                                    - r.stat_threshold[i]) < RESUME_NEAR)})
    keep = np.setdiff1d(np.arange(full.n_points), near)
    log(f"[resume] ({label}) NOT bit for bit: max |threshold difference| "
        f"{d_thr:.3g}, max |null difference| {d_null:.3g}, first differing "
        f"point {first}; near-tie points excluded from the counts: {near}")
    for f in fields[:3]:
        if not np.array_equal(getattr(full, f)[keep],
                              getattr(resumed, f)[keep]):
            fail(f"resume ({label}): {f} differs off the near-tie points")
    out.update(d_thr=d_thr, d_null=d_null, first_diff=int(first),
               near_ties=near)
    return out


def _save_timer(saves):
    """Wrap Checkpointer.save (and os.fsync, which only the save calls
    here) to record (ms, fsync ms, record bytes, rounds) of each call;
    returns the restore function."""
    import os

    from fscl_tpu_torch.engine import checkpoint as TC

    orig, orig_fsync = TC.Checkpointer.save, os.fsync
    fsync_ms = []

    def fsync(fd):
        t0 = time.perf_counter()
        orig_fsync(fd)
        fsync_ms.append((time.perf_counter() - t0) * 1e3)

    def save(self, result, rounds_done):
        before = os.path.getsize(self.log_path)
        fsync_ms.clear()
        t0 = time.perf_counter()
        orig(self, result, rounds_done)
        saves.append(((time.perf_counter() - t0) * 1e3, sum(fsync_ms),
                      os.path.getsize(self.log_path) - before, rounds_done))

    TC.Checkpointer.save, os.fsync = save, fsync

    def restore():
        TC.Checkpointer.save, os.fsync = orig, orig_fsync

    return restore


def phase_resume(dev, smi, genome_perm_s):
    """Phase 9: checkpoint and resume on the card.  (a) the 20k task on
    the hist path (bfloat16, 64 permutations at chunks of 16), (b) the
    same at float32 with the RDP tail forced on (phase 7's set-up), (c)
    the 20k task through --no-hist (the lattice path, 32 permutations):
    each run uninterrupted and stopped at 16 rounds, then resumed from
    its checkpoint (_resume_case), the resumed leg launching the path's
    kernels; (d) genome1m (phase 5's data and scan), 64 permutations
    with a checkpoint: each save's milliseconds and record bytes, the
    log's final size, the saves' share of the permutation wall, the wall
    against phase 5's without a checkpoint and against runs without one
    here, in turns; (e) -m with --checkpoint on the first two blocks of
    headline_ms_sweep.ms at -p 8, then -p 16: one file a block, and the
    TSV's permute_n at most 16, reached."""
    import dataclasses
    import os

    import numpy as np

    from fscl_tpu_torch.engine import permute as TP
    from fscl_tpu_torch.engine.scan import ScanConfig, scan_genome

    out = {}
    data, tables, scan_cfg, result = SCANS["20k"]
    cfg = TP.PermuteConfig(n_permute=64, chunk_replicates=16, seed=1)
    out["hist"] = _resume_case("hist 20k bf16", (data, tables, scan_cfg,
                                                 result), cfg, dev, smi,
                               ("prefix", "window_clr"))
    saved = TP.RDP_FORCE
    TP.RDP_FORCE = "on"
    try:
        out["rdp"] = _resume_case(
            "rdp 20k f32, RDP on", (data, tables, scan_cfg, result),
            dataclasses.replace(cfg, hist_bf16=False), dev, smi,
            ("row_gather", "window_clr_f32"))
    finally:
        TP.RDP_FORCE = saved
    if out["rdp"]["stats"]["resumed"]["stack_dispatches"]:
        fail("resume (rdp): the resumed leg took the stacked path")
    lat_cfg = ScanConfig(small_grid_sp=1000, large_grid_sp=100000,
                         use_hist=False)
    lat = scan_genome(data, tables, lat_cfg, device=dev)
    out["lattice"] = _resume_case(
        "lattice 20k --no-hist", (data, tables, lat_cfg, lat),
        dataclasses.replace(cfg, n_permute=32, use_hist=False), dev, smi,
        ("lattice",))

    # (d) genome1m: what a save costs on the main path
    g_scanned = SCANS["genome1m"]
    g_cfg = TP.PermuteConfig(n_permute=64)
    walls, saves_all = {"with": [], "without": []}, []
    for turn in ("without", "with", "with", "without"):
        ck = None
        if turn == "with":
            ck = str(OUT / f"resume_genome{len(walls['with'])}.npz")
        saves = []
        restore = _save_timer(saves)
        try:
            r, wall, _, counts = _permute_run(g_scanned, g_cfg, dev, ck)
        finally:
            restore()
        walls[turn].append(wall)
        if ck:
            log_bytes = os.path.getsize(ck + ".log")
            base_bytes = os.path.getsize(ck)
            for p in (ck, ck + ".log"):
                os.unlink(p)
            saves_all.append(dict(
                wall_s=wall, saves_ms=[s[0] for s in saves],
                fsync_ms=[s[1] for s in saves],
                record_bytes=[s[2] for s in saves],
                rounds=[s[3] for s in saves], log_bytes=log_bytes,
                base_bytes=base_bytes,
                save_share=sum(s[0] for s in saves) / 1e3 / wall))
            if not saves or saves[-1][3] != int(r.permute_n.max()):
                fail(f"resume (genome1m): saves {saves} end before the run")
            _check_result(r, "resume genome1m")
    for k, s in enumerate(saves_all):
        log(f"[resume] (genome1m, 64 permutations, checkpoint run {k}) "
            f"{len(s['saves_ms'])} saves at rounds {s['rounds']}: ms "
            f"{' '.join(f'{t:.3f}' for t in s['saves_ms'])} (of which "
            f"fsync {' '.join(f'{t:.3f}' for t in s['fsync_ms'])}); record "
            "bytes "
            f"{' '.join(str(b) for b in s['record_bytes'])}; log "
            f"{s['log_bytes']} bytes, base {s['base_bytes']} bytes; saves "
            f"{100 * s['save_share']:.2f}% of the {s['wall_s']:.3f}s "
            f"permutation wall; {smi}")
    log(f"[resume] (genome1m) permutation walls in turns: without "
        f"{walls['without'][0]:.3f}s, with {walls['with'][0]:.3f}s, with "
        f"{walls['with'][1]:.3f}s, without {walls['without'][1]:.3f}s; "
        f"phase 5's without a checkpoint {genome_perm_s:.3f}s; {smi}")
    out["genome1m"] = dict(walls_s=walls, phase5_perm_s=genome_perm_s,
                           checkpoint_runs=saves_all, nvidia_smi=smi)

    # (e) -m with --checkpoint, two blocks, -p 8 then -p 16
    two = OUT / "resume_ms2.ms"
    two.write_text("\n//".join(MS_SWEEP.read_text().split("\n//")[:3])
                   + "\n")
    ck = OUT / "resume_ms.npz"
    flags = [*MS_SWEEP_FLAGS[:-2], "--checkpoint", str(ck)]
    tsv = OUT / "resume_ms.tsv"
    t_ms = []
    for p in ("8", "16"):
        t_ms.append(_ms_run(two, tsv, [*flags, "-p", p], dev)[1])
        files = sorted(f.name for f in OUT.glob("resume_ms.npz.block*")
                       if not f.name.endswith(".log"))
        if files != ["resume_ms.npz.block0", "resume_ms.npz.block1"]:
            fail(f"resume (ms): checkpoint files {files} after -p {p}")
    rows = _ms_rows(tsv)
    pn = [int(r[5]) for r in rows]
    for f in OUT.glob("resume_ms*"):
        f.unlink()
    if max(pn) != 16:
        fail(f"resume (ms): permute_n reaches {max(pn)}, not 16")
    log(f"[resume] (ms) two blocks, -p 8 then -p 16 with --checkpoint: "
        f"files .block0 and .block1; {len(rows)} points, permute_n "
        f"{min(pn)}..{max(pn)}; walls {t_ms[0]:.3f}s and {t_ms[1]:.3f}s; "
        f"{smi}")
    out["ms"] = dict(walls_s=t_ms, points=len(rows), permute_n_max=max(pn))
    return out



# ---- phase 10: the split over ranks (fscl_tpu_torch/parallel/) ----------

SPLIT_20K = ["-f", str(REPO / "bench" / "data" / "bench_20k.sf"),
             "--compat-mirror-unfolded", "-g", "1000", "-G", "100000",
             "--seed", "1"]


def _write_sf(path, ref):
    """The sites of ``ref``'s data as a SNP file (chr, pos, freq, depth,
    folded)."""
    import numpy as np

    data = ref[0]
    with open(path, "w") as f:
        for cl in data.chr_limits:
            sl = slice(cl.start_index, cl.start_index + cl.n_snps)
            np.savetxt(f, np.column_stack([
                data.pos[sl], data.obs_freq[sl],
                np.asarray(data.sample_depths)[data.depth_p[sl]],
                data.folded[sl].astype(int)]),
                fmt=cl.name + "\t%d\t%d\t%d\t%d")


def _split_cli(label, n, args, trace=False, timeout=300):
    """``python -m torch.distributed.run --standalone --nproc-per-node n
    -m fscl_tpu_torch args -v 4`` in SPLIT_WORK, at one OpenMP thread a
    rank (torch.distributed.run's default for n > 1), traced by
    utils/timing.py where ``trace``: (process wall s, the ranks' [split]
    reports in rank order).  Its stderr goes to OUT/split_<label>.log."""
    import os

    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("FSCL_TPU_TRACE_DIR", None)
    if trace:
        tdir = SPLIT_WORK / f"trace_{label}"
        tdir.mkdir(parents=True, exist_ok=True)
        env["FSCL_TPU_TRACE_DIR"] = str(tdir)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), "-m", "fscl_tpu_torch", *args,
           "-v", "4"]
    t0 = time.monotonic()
    p = subprocess.run(cmd, cwd=SPLIT_WORK, env=env, capture_output=True,
                       text=True, timeout=timeout)
    wall = time.monotonic() - t0
    (OUT / f"split_{label}.log").write_text(p.stdout + p.stderr)
    if p.returncode != 0:
        fail(f"split {label}: exit {p.returncode}: {p.stderr[-2000:]}")
    reps = sorted((json.loads(line[len("[split] "):])
                   for line in p.stderr.splitlines()
                   if line.startswith("[split] ")), key=lambda r: r["rank"])
    if [r["rank"] for r in reps] != list(range(n)):
        fail(f"split {label}: [split] reports of ranks "
             f"{[r['rank'] for r in reps]}, not of {n}")
    return wall, reps


def _trace_busy(label, reps):
    """{rank: {phase: device s}}: the kernel, memcpy and memset time of
    each rank's scan and permute traces (utils/timing.py, one trace a
    phase and process)."""
    tdir = SPLIT_WORK / f"trace_{label}"
    out = {}
    for r in reps:
        out[r["rank"]] = {}
        for ph in ("scan", "permute"):
            tot = 0.0
            for path in tdir.glob(f"{ph}.{r['pid']}.*.pt.trace.json"):
                events = json.loads(path.read_text()).get("traceEvents", [])
                tot += sum(e.get("dur", 0) for e in events
                           if e.get("cat") in ("kernel", "gpu_memcpy",
                                               "gpu_memset")) / 1e6
            out[r["rank"]][ph] = tot
    return out


def _tsv_rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def _near_ties(result, band=RESUME_NEAR):
    """Points with a saved null within ``band`` of the point's threshold
    (the statistic's bits there decide an exceedance)."""
    import numpy as np

    return sorted(i for i in range(result.n_points)
                  if np.any(np.abs(np.asarray(result.null_clr[i] or [])
                                   - result.stat_threshold[i]) < band))


def _against_single(label, tsv, ref):
    """The split run's TSV and nulldist against the single-rank run's
    (``ref``: data, result, TSV): bitwise where they are, else positions
    equal, reported CLRs (the nulldist's, 3 decimals) within 1e-3 plus
    the print's rounding, and permute_n, permute_p equal off the single
    run's listed near-ties.  Which held."""
    import numpy as np

    _, result, ref_tsv = ref
    same = all(pathlib.Path(f"{tsv}{s}").read_bytes()
               == pathlib.Path(f"{ref_tsv}{s}").read_bytes()
               for s in ("", "-nulldist"))
    if same:
        log(f"[split] {label}: TSV and nulldist bitwise equal to the "
            "single-rank run's")
        return "bitwise"
    a, b = _tsv_rows(tsv), _tsv_rows(ref_tsv)
    na = _tsv_rows(f"{tsv}-nulldist")[1:]
    if len(a) != len(b) or len(na) != result.n_points:
        fail(f"split {label}: {len(a)} rows against {len(b)}")
    pos = np.array([int(r[1]) for r in a])
    if not np.array_equal(pos, result.sweep_pos):
        fail(f"split {label}: positions differ from the single-rank run")
    clr = np.array([float(r[2]) for r in na])
    d = np.abs(clr - result.clr).max()
    if d > 1e-3 + 5e-4:
        fail(f"split {label}: reported CLR off by {d:.3g}")
    near = _near_ties(result)
    keep = np.setdiff1d(np.arange(result.n_points), near)
    pn = np.array([[int(r[4]), int(r[5])] for r in a])
    want = np.stack([result.permute_p, result.permute_n], 1)
    bad = np.nonzero((pn[keep] != want[keep]).any(1))[0]
    if len(bad):
        fail(f"split {label}: permute_p/permute_n differ off near-ties at "
             f"points {keep[bad][:10].tolist()}")
    log(f"[split] {label}: not bitwise; positions equal, CLR within "
        f"{d:.3g}, counts equal off {len(near)} near-tie points {near[:20]}")
    return "within tolerance"


def _replayed(ck):
    """The permutation state a checkpoint's base and log replay to (the
    port's Checkpointer, read-only), and the rounds of its records."""
    from types import SimpleNamespace

    import numpy as np

    from fscl_tpu_torch.engine.checkpoint import Checkpointer, _read_records

    with np.load(ck) as z:
        sweep_pos, clr, seed = z["sweep_pos"], z["clr"], int(z["seed"])
    K = len(sweep_pos)
    r = SimpleNamespace(sweep_pos=sweep_pos, clr=clr, n_points=K,
                        permute_n=np.zeros(K, np.int64),
                        permute_p=np.zeros(K, np.int64),
                        permute_finished=np.zeros(K, bool),
                        null_clr=[None] * K, stat_threshold=None)
    Checkpointer(str(ck), r, seed, write=False, resume=True)
    rounds = [int(z["rounds_done"]) for z in _read_records(f"{ck}.log")]
    return r, rounds


def _same_state(a, b):
    import numpy as np

    return (all(np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("permute_n", "permute_p", "permute_finished",
                          "stat_threshold"))
            and all((x or []) == (y or [])
                    for x, y in zip(a.null_clr, b.null_clr)))


def phase_split(dev, smi):
    """Phase 10: the split over ranks through the CLI under
    torch.distributed.run, every rank on the one card (--device cuda:0).
    (a) genome1m (phase 5's sites, written to a SNP file), scan and 64
    permutations under two ranks against phase 5's single-rank run, its
    walls against one rank's, then both traced for the busy shares; (b)
    the 20k task through --no-hist under two ranks against phase 4b's
    run; (c) the 20k task under two ranks broken at 16 rounds and
    resumed under two and under one, against the unbroken two-rank run,
    bit for bit; (d) the 20k task in a world of one through
    torch.distributed.run against the plain CLI, byte for byte."""
    import shutil

    from fscl_tpu_torch.cli import main as cli_main

    shutil.rmtree(SPLIT_WORK, ignore_errors=True)
    SPLIT_WORK.mkdir(parents=True)
    out = {}
    card = ["--device", str(dev)]  # cuda:0: every rank on the one card

    # (a) genome1m under two ranks, against phase 5; then one and two
    # ranks with --max-only (no tail projection of 10,010 points in the
    # output), untraced for the walls and traced for the busy shares
    ref = SPLIT_REF["genome1m"]
    _write_sf(SPLIT_WORK / "genome1m.sf", ref)
    gargs = ["-f", "genome1m.sf", "-p", "64", *card]
    w2, rep2 = _split_cli("genome_2", 2, [*gargs, "-o", "genome_2.tsv"])
    for r in rep2:
        la = r["launches"]
        if la["onehot_prefix_sums"] <= 0 or la["window_clr"] <= 0:
            fail(f"split genome: rank {r['rank']} launched 1b "
                 f"{la['onehot_prefix_sums']} and window_clr "
                 f"{la['window_clr']} times")
    held_a = _against_single("genome1m, 2 ranks",
                             SPLIT_WORK / "genome_2.tsv", ref)
    mo = [*gargs, "--max-only"]
    w1, rep1 = _split_cli("genome_1", 1, [*mo, "-o", "genome_1.tsv"])
    wt1, rept1 = _split_cli("genome_1_traced", 1, [*mo, "-o", "g1t.tsv"],
                            trace=True)
    wt2, rept2 = _split_cli("genome_2_traced", 2, [*mo, "-o", "g2t.tsv"],
                            trace=True)
    dev1, dev2 = (_trace_busy("genome_1_traced", rept1),
                  _trace_busy("genome_2_traced", rept2))

    def walls(reps):
        return [{k: r["phases"].get(k, 0.0) for k in (
            "load", "tables", "scan", "permute", "output", "gather")}
            for r in reps]

    def shares(reps, devs):
        out = {f"rank{r['rank']}": {
            ph: devs[r["rank"]][ph] / max(r["phases"].get(ph, 0), 1e-9)
            for ph in ("scan", "permute")} for r in reps}
        # the card: every rank's device time (the card time-slices the
        # two processes' contexts: without MPS their kernels do not
        # overlap) over the longest wall
        out["card"] = {ph: sum(devs[r["rank"]][ph] for r in reps)
                       / max(max(r["phases"].get(ph, 0) for r in reps), 1e-9)
                       for ph in ("scan", "permute")}
        return out

    g = dict(
        held=held_a, process_wall_s={"1": w1, "2": w2},
        phase_walls={"1": walls(rep1), "2": walls(rep2)},
        split_gather_s=[r["split_gather_s"] for r in rep2],
        split_gather_bytes=[r["split_gather_bytes"] for r in rep2],
        split_gathers=[r["split_gathers"] for r in rep2],
        launches={"1": [r["launches"] for r in rep1],
                  "2": [r["launches"] for r in rep2]},
        traced_process_wall_s={"1": wt1, "2": wt2},
        traced_walls={"1": walls(rept1), "2": walls(rept2)},
        device_s={"1": dev1, "2": dev2},
        busy_share={"1": shares(rept1, dev1), "2": shares(rept2, dev2)})
    out["genome"] = g
    per_rank = [(r["launches"]["onehot_prefix_sums"],
                 r["launches"]["window_clr"]) for r in rep2]
    log(f"[split] (a) genome1m, {smi}: process walls 1 rank {w1:.3f}s "
        f"(--max-only), 2 ranks {w2:.3f}s; phase walls 1 rank "
        f"{walls(rep1)}, 2 ranks {walls(rep2)}; split_gather_s "
        f"{g['split_gather_s']}, split_gather_bytes "
        f"{g['split_gather_bytes']} in {g['split_gathers']} gathers; "
        f"launches a rank (1b, window_clr): {per_rank}")
    log(f"[split] (a) traced (--max-only): process walls 1 rank {wt1:.3f}s,"
        f" 2 ranks {wt2:.3f}s; phase walls 1 rank {walls(rept1)}, 2 ranks "
        f"{walls(rept2)}; device s 1 rank {dev1}, 2 ranks {dev2}; busy "
        f"shares {json.dumps(g['busy_share'])}")

    # (d) a world of one through torch.distributed.run against the plain
    # CLI in this process: the 20k task, 50 permutations
    args_d = [*SPLIT_20K, "-p", "50", "--chunk-replicates", "32", *card]
    _split_cli("20k_world1", 1, [*args_d, "-o", "w1.tsv"])
    cli_main([*args_d, "-o", str(SPLIT_WORK / "plain.tsv"), "-v", "1"])
    for s_ in ("", "-nulldist"):
        if (SPLIT_WORK / f"w1.tsv{s_}").read_bytes() != (
                SPLIT_WORK / f"plain.tsv{s_}").read_bytes():
            fail(f"split (d): a world of one's {s_ or 'TSV'} differs from "
                 "the plain CLI's")
    log("[split] (d) the 20k task in a world of one through "
        "torch.distributed.run: TSV and nulldist byte for byte the plain "
        "CLI's")

    # (b) 20k --no-hist under two ranks against phase 4b
    wb, repb = _split_cli("20k_nohist_2", 2, [
        *SPLIT_20K, "--no-hist", "-p", "50", "--chunk-replicates", "32",
        *card, "-o", "nohist_2.tsv"])
    for r in repb:
        if r["launches"]["clr_lattice"] <= 0:
            fail(f"split 20k no-hist: rank {r['rank']} launched clr_lattice "
                 f"{r['launches']['clr_lattice']} times")
    held_b = _against_single("20k no-hist, 2 ranks",
                             SPLIT_WORK / "nohist_2.tsv",
                             SPLIT_REF["20k_nohist"])
    out["nohist"] = dict(held=held_b, process_wall_s=wb,
                         phase_walls=walls(repb),
                         launches=[r["launches"] for r in repb],
                         split_gather_s=[r["split_gather_s"] for r in repb],
                         split_gather_bytes=[r["split_gather_bytes"]
                                             for r in repb])
    log(f"[split] (b) 20k no-hist, 2 ranks: process wall {wb:.3f}s, phase "
        f"walls {walls(repb)}, clr_lattice launches a rank "
        f"{[r['launches']['clr_lattice'] for r in repb]}")

    # (c) a break under two ranks, resumed under two and under one
    rargs = [*SPLIT_20K, "--chunk-replicates", "16", *card]
    _split_cli("20k_unbroken_2", 2, [*rargs, "-p", "64", "--checkpoint",
                                      "full.npz", "-o", "full.tsv"])
    _split_cli("20k_break_2", 2, [*rargs, "-p", str(RESUME_BREAK),
                                   "--checkpoint", "brk.npz", "-o",
                                   "brk.tsv"])
    at_break, _ = _replayed(SPLIT_WORK / "brk.npz")
    for f in ("brk.npz", "brk.npz.log"):
        shutil.copy(SPLIT_WORK / f, SPLIT_WORK / f.replace("brk", "one"))
    _split_cli("20k_resume_2", 2, [*rargs, "-p", "64", "--checkpoint",
                                    "brk.npz", "-o", "res2.tsv"])
    cli_main([*rargs, "-p", "64", "--checkpoint",
              str(SPLIT_WORK / "one.npz"), "-o",
              str(SPLIT_WORK / "res1.tsv"), "-v", "1"])
    full, rounds = _replayed(SPLIT_WORK / "full.npz")
    if RESUME_BREAK not in rounds or at_break.permute_p.max() >= 20:
        fail(f"split (c): the break at {RESUME_BREAK} is no chunk boundary "
             f"of the unbroken run ({rounds}) or follows a pruning draw")
    for leg in ("brk", "one"):
        got, _ = _replayed(SPLIT_WORK / f"{leg}.npz")
        tsv = "res2.tsv" if leg == "brk" else "res1.tsv"
        if not _same_state(got, full) or any(
                (SPLIT_WORK / f"{tsv}{s}").read_bytes()
                != (SPLIT_WORK / f"full.tsv{s}").read_bytes()
                for s in ("", "-nulldist")):
            fail(f"split (c): the break under 2 ranks resumed under "
                 f"{2 if leg == 'brk' else 1} differs from the unbroken run")
    log(f"[split] (c) 20k broken at {RESUME_BREAK} under 2 ranks, resumed "
        f"under 2 and under 1: bit for bit the unbroken two-rank run "
        f"(records at {rounds})")
    out["resume"] = dict(records=rounds, bitwise=True)
    return out


# ---- phase 11: the SNP reader's C parser (fscl_tpu_torch/native/) ---------

def _parse_case(label, path, ref, smi):
    """The C parser (median of 3) and the Python loop (once) on the SNP
    file at ``path``, their outputs equal, and load_snp_input's wall, its
    sites those of ``ref`` (the data the file was written from)."""
    import numpy as np

    from fscl_tpu_torch.io import load_snp_input, snp_reader
    from fscl_tpu_torch.native import fastio

    with open(path, "rb") as f:
        lines = sum(1 for _ in f)
    c_s = []
    for _ in range(3):
        t0 = time.monotonic()
        got = fastio.parse_snp_file(path)
        c_s.append(time.monotonic() - t0)
    t0 = time.monotonic()
    want = snp_reader._parse_python(path)
    py_s = time.monotonic() - t0
    if got[0] != want[0] or not all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(got[1:], want[1:])):
        fail(f"load {label}: the C parser and the Python loop differ")
    t0 = time.monotonic()
    data = load_snp_input(path)
    load_s = time.monotonic() - t0
    if not (np.array_equal(data.pos, ref.pos)
            and np.array_equal(data.obs_freq, ref.obs_freq)
            and np.array_equal(data.folded, ref.folded)
            and np.array_equal(np.asarray(data.sample_depths)[data.depth_p],
                               np.asarray(ref.sample_depths)[ref.depth_p])
            and [c.name for c in data.chr_limits]
            == [c.name for c in ref.chr_limits]):
        fail(f"load {label}: load_snp_input's sites differ from the data "
             "the file was written from")
    c_med = sorted(c_s)[1]
    log(f"[load] {label} ({lines} lines, {len(got[0])} rows), {smi}: C "
        f"parser {c_med:.3f}s (median of {[round(t, 3) for t in c_s]}), "
        f"Python loop {py_s:.3f}s ({py_s / c_med:.1f}x), load_snp_input "
        f"{load_s:.3f}s")
    return dict(lines=lines, rows=len(got[0]), c_parser_s=c_s,
                c_parser_median_s=c_med, python_loop_s=py_s,
                load_snp_input_s=load_s)


def phase_load(smi, split, build_s):
    """Phase 11: the SNP reader's parsers on phase 10's genome1m.sf and on
    phase 4d's chromosome written to a file; phase 10's CLI runs logged
    the C parser; their load phases against the Python loop's;
    ``build_s``, the parser's build in phase 2, printed beside them."""
    t0 = time.monotonic()
    out = {"genome1m": _parse_case("genome1m.sf", SPLIT_WORK / "genome1m.sf",
                                   SPLIT_REF["genome1m"][0], smi)}
    big = SPLIT_WORK / "big_chromosome.sf"
    _write_sf(big, (LOAD_INPUTS["big_chromosome"],))
    out["big_chromosome"] = _parse_case("phase 4d's chromosome", big,
                                        LOAD_INPUTS["big_chromosome"], smi)
    big.unlink()

    logs = sorted(OUT.glob("split_*.log"))
    missing = [p.name for p in logs
               if "Parsing SNP input with the C parser" not in p.read_text()]
    if not logs or missing:
        fail(f"load: phase 10's CLI runs {missing or logs} did not log the "
             "C parser")
    g = split["genome"]
    cli = {k: [w["load"] for w in g["phase_walls"][k]] for k in ("1", "2")}
    traced = {k: [w["load"] for w in g["traced_walls"][k]]
              for k in ("1", "2")}
    out.update(cli_logs_c_parser=[p.name for p in logs], cli_load_s=cli,
               cli_load_traced_s=traced,
               cli_load_python_loop_s=LOAD_PYTHON_LOOP_S,
               parser_build_s=build_s, phase_s=time.monotonic() - t0)
    log(f"[load] the CLI's load phase (phase 10's [split] lines; {smi}): "
        f"genome1m 1 rank {cli['1']} s (--max-only), 2 ranks {cli['2']} s; "
        f"traced 1 rank {traced['1']}, 2 ranks {traced['2']}; earlier "
        f"with the Python loop {LOAD_PYTHON_LOOP_S} s; {len(logs)} CLI runs "
        f"logged the C parser; its build {build_s:.2f}s (phase 2)")
    log(json.dumps({"host_native": dict(out, nvidia_smi=smi)}))
    return out


# phase 12: the stream's chunks (label, scan, replicates, start, seed,
# block width bp): the 20k task's chunk (chunk_replicates 32, seed 1),
# genome1m's first chunk (16 replicates, the CLI's default) and deep-tail
# chunk (2,048 at the CLI's seed), phase 4d's (16), and genome1m at 30 kb
# blocks (256 replicates of about 33,000 blocks)
STREAM_SHAPES = (("20k chunk", "20k", 32, 0, 1, 1e6),
                 ("genome1m chunk", "genome1m", 16, 0, 0xFD821A6, 1e6),
                 ("genome1m deep tail", "genome1m", 2048, 2048, 0xFD821A6,
                  1e6),
                 ("4d chromosome chunk", "big_chromosome", 16, 0, 0xFD821A6,
                  1e6),
                 ("large B", "genome1m", 256, 0, 0xFD821A6, 3e4))
# launches a CUDA graph of the kernel alone holds (graph_time_ms)
GRAPH_LAUNCHES = 20
# phase 12's CLI leg: genome1m at 30 kb blocks (about 33,000 shuffled
# blocks, past the first kernel's 16,384), 16 permutations
STREAM_CLI = ["-p", "16", "-w", "0.03", "--max-only"]
# lane operations of one threefry2x32 hash: 20 rounds of add, rotate and
# xor, 5 key injections of three adds
STREAM_OPS_HASH = 75
# the deep tail of bench/run_tail.py cut to 1,024 rounds: at chunks of 4
# replicates the tiers 64 and 128 give chunks of 256, 512 and 256
STREAM_TAIL = dict(n_permute=1024, chunk_replicates=4, seed=1)


def _stream_redraws(seed, start, n, B):
    """Redraws of an identity block order among replicates start ..
    start + n - 1 (plain version's arithmetic, on the host)."""
    import torch

    from fscl_tpu_torch.ops import permute as TO

    k0, k1 = TO.seed_key(seed)
    idx = (start + torch.arange(n, dtype=torch.int64)) & 0xFFFFFFFF
    kp = TO._split(torch.stack(TO.threefry2x32(k0, k1, 0, idx), 1))[1]
    rounds, ident = TO.shuffle_rounds(B), torch.arange(B)
    rows, redraws = torch.arange(n), 0
    while len(rows) and B > 1:
        rows = rows[(TO._permutation(kp[rows], B, rounds) == ident).all(1)]
        redraws += len(rows)
        kp[rows] = TO._fold_in(kp[rows], 1)
    return redraws


def _stream_evals(G, nb):
    """Block-id evaluations one replicate's nb + 1 block starts need: each
    start lies after the one before, about G / (nb + 1) groups on, so a
    search from it takes about log2 of that gap; or every group once,
    where that is fewer."""
    import math

    gap = max(1, math.ceil(math.log2(G / (nb + 1) + 1)))
    return min(G, (nb + 1) * gap)


def _stream_ops(n, G, nb, redraws, sigma):
    """Lane operations a chunk's draw needs: the threefry hashes (a
    replicate's key, phase key, phase bits and permutation key; a draw's
    split and B sort keys a round; a redraw's fold_in), a counting sort's
    two operations a key a round (the keys are uniform hashes), the block
    ids of each replicate's starts (_stream_evals; add, multiply, convert,
    clamp) and, for the sigma, one operation an entry."""
    from fscl_tpu_torch.ops.permute import shuffle_rounds

    B = nb - 1
    rounds = shuffle_rounds(B)
    draws = n + redraws
    hashes = 4 * n + draws * rounds * (2 + B) + redraws
    return (hashes * STREAM_OPS_HASH + 2 * draws * rounds * B
            + 4 * n * _stream_evals(G, nb) + (n * G if sigma else 0))


def _stream_bytes(G, nb, outputs):
    """Bytes a chunk's draw must move: its outputs written once and the
    g0f entries (float32) that one replicate's starts read."""
    return 4 * _stream_evals(G, nb) + sum(x.numel() * x.element_size()
                                          for x in outputs)


def graph_time_ms(fn, launches=GRAPH_LAUNCHES):
    """A kernel alone: ms a launch of a CUDA graph of `launches` calls of
    fn (no host work between launches), the median of 5 CUDA-event
    readings of a replay, after one call outside the graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    torch.cuda.synchronize()
    ms = cuda_time_ms(g.replay, 1)
    del g
    return ms / launches


def _stream_case(label, gpos, n, start, seed, width, dev):
    """Phase 12's kernel check at one chunk: both forms bitwise against
    the plain version, twice and after the timing loop; the kernel alone
    (a CUDA graph of launches into preallocated outputs, the wrapper's
    plan), the wrapper (back-to-back calls) and the plain version timed;
    the bound."""
    import dataclasses

    import torch

    from fscl_tpu_torch import kernels
    from fscl_tpu_torch.ops import permute as TO

    g0f, span = TO._g0_device(gpos, dev)
    nb = TO.n_blocks_for(span, width)
    w = TO.effective_block_width(span, width)
    G = g0f.shape[0]
    redraws = _stream_redraws(seed, start, n, nb - 1)
    lib = kernels.load()
    out = []
    for form in ("sigma", "runs"):
        sigma = form == "sigma"

        def wrapper():
            runs, sig = TO.replicate_runs(seed, start, g0f, nb, w, n,
                                          with_runs=not sigma,
                                          with_sigma=sigma)
            return (sig,) if sigma else runs

        def plain():
            src, dst, sz, sig = TO.replicate_runs_plain(
                seed, start, g0f, nb, w, n, with_sigma=sigma)
            return (sig,) if sigma else (src, dst, sz)

        def same(a, b):
            return all(torch.equal(x, y) for x, y in zip(a, b))

        got, want = wrapper(), plain()
        torch.cuda.synchronize()
        if not same(got, want):
            bad = sum(int((x != y).any(1).sum()) for x, y in zip(got, want))
            fail(f"stream kernel at {label} ({form}): {bad} rows differ "
                 "from the plain version")
        if not same(wrapper(), got):
            fail(f"stream kernel at {label} ({form}): two launches differ")
        # the kernel alone: the wrapper's plan into preallocated outputs
        plan = TO.plan_replicate_runs(n, G, nb, sigma, TO._sm_count(dev))
        lo, hi = TO._brackets(g0f, nb, w)
        bufs = tuple(torch.full_like(x, -1) for x in got)
        scratch = (torch.empty(plan.grid * plan.slot_bytes,
                               dtype=torch.uint8, device=dev)
                   if plan.slot_bytes else None)

        def kern():
            rc = TO.launch_replicate_runs(
                lib, plan, seed, start, g0f, lo, hi, nb, w, n,
                None if sigma else bufs, bufs[0] if sigma else None,
                scratch)
            kernels.check(lib, rc, "replicate_runs")

        ms = graph_time_ms(kern)
        torch.cuda.synchronize()
        if not same(bufs, got) or not same(wrapper(), got):
            fail(f"stream kernel at {label} ({form}): a launch after the "
                 "timing loop differs from the first")
        wrapper_ms = cuda_time_ms(wrapper, 20)
        plain_ms = cuda_time_ms(plain, 1, readings=3)
        bd, by = bound_ms(_stream_bytes(G, nb, got),
                          _stream_ops(n, G, nb, redraws, sigma))
        out.append(dict(label=f"{label} ({form})", replicates=n, groups=G,
                        blocks=nb, rounds=TO.shuffle_rounds(nb - 1),
                        redraws=redraws, plan=dataclasses.asdict(plan),
                        ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                        bound_ms=bd, bound_by=by, max_abs_err=0.0,
                        library_ms=None))
        where = "global scratch" if plan.on_global else "shared memory"
        log(f"[stream] {label} ({form}): {n} replicates, G={G}, "
            f"{nb} blocks, {redraws} redraws, plan T={plan.threads} "
            f"tiles={plan.tiles}, radix sort in {where}: bitwise; kernel "
            f"{ms:.4f} ms (graph of {GRAPH_LAUNCHES}), wrapper "
            f"{wrapper_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bd:.5f} ms ({by}, {100 * bd / ms:.1f}%)")
    return out


def _stream_cli(dev):
    """Phase 12's CLI leg: genome1m.sf (phase 10's file) through the CLI
    at STREAM_CLI, in process, to its end; the first chunk's sigma (or
    runs) drawn by the kernel against the plain version's."""
    import torch

    from fscl_tpu_torch import cli
    from fscl_tpu_torch.engine import permute as TP
    from fscl_tpu_torch.ops import permute as TO

    first = {}
    saved = TP.block_permutation_groups, TP.block_permutation_runs

    def capture(fn, form):
        def call(seed, gpos, width_bp, n, start=0, device="cuda"):
            res = fn(seed, gpos, width_bp, n, start=start, device=device)
            if not first:
                first.update(form=form, seed=seed, gpos=gpos,
                             width=width_bp, n=n, start=start,
                             got=[x.clone() for x in (
                                 (res,) if form == "sigma" else res)])
            return res
        return call

    TP.block_permutation_groups = capture(saved[0], "sigma")
    TP.block_permutation_runs = capture(saved[1], "runs")
    tsv = SPLIT_WORK / "stream_cli.tsv"
    before = TO.replicate_runs_launches
    try:
        t0 = time.monotonic()
        cli.main(["-f", str(SPLIT_WORK / "genome1m.sf"), "-o", str(tsv),
                  *STREAM_CLI, "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        TP.block_permutation_groups, TP.block_permutation_runs = saved
    launches = TO.replicate_runs_launches - before
    if not first or launches <= 0:
        fail(f"stream CLI leg: no draw through replicate_runs ({launches} "
             "launches)")
    g0f, span = TO._g0_device(first["gpos"], dev)
    nb = TO.n_blocks_for(span, first["width"])
    src, dst, sz, sig = TO.replicate_runs_plain(
        first["seed"], first["start"], g0f, nb,
        TO.effective_block_width(span, first["width"]), first["n"],
        with_sigma=first["form"] == "sigma")
    want = (sig,) if first["form"] == "sigma" else (src, dst, sz)
    if not all(torch.equal(a, b) for a, b in zip(first["got"], want)):
        fail("stream CLI leg: the first chunk's draw differs from the plain "
             "version")
    rows = sum(1 for _ in open(tsv))
    log(f"[stream] CLI {' '.join(STREAM_CLI)} on genome1m.sf: {nb - 1} "
        f"shuffled blocks, ran to its end in {wall:.2f}s ({rows} TSV "
        f"lines); replicate_runs launches {launches}; the first chunk's "
        f"{first['form']} ({first['n']} replicates) equals the plain "
        "version's")
    return dict(blocks=nb, wall_s=wall, launches=launches,
                first_form=first["form"], first_replicates=first["n"])


def _spec_overlap(events):
    """At each speculative dispatch (span permute.speculate) followed by a
    drain (permute.drain): the next chunk's kernels (correlated with
    launches inside the dispatch's range) against the drain's end, in us:
    the first kernel's start minus the drain's end (negative: it started
    before the drain returned) and the kernel time left after the drain
    returned."""
    ann = sorted((e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") in ("permute.speculate",
                                        "permute.drain")),
                 key=lambda e: e["ts"])
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "aunch" in e.get("name", "")
                and "correlation" in e.get("args", {})]
    kernels = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "kernel" and "correlation" in
               e.get("args", {})}
    out = []
    for i, a in enumerate(ann):
        if a["name"] != "permute.speculate":
            continue
        d = next((b for b in ann[i + 1:] if b["name"] == "permute.drain"),
                 None)
        if d is None:
            continue
        a1, d1 = a["ts"] + a["dur"], d["ts"] + d["dur"]
        ks = [kernels[c] for c in (x["args"]["correlation"] for x in launches
                                   if a["ts"] <= x["ts"] <= a1)
              if c in kernels]
        if ks:
            out.append(dict(
                kernels=len(ks),
                start_minus_drain_end_us=min(k["ts"] for k in ks) - d1,
                kernel_us_after_drain=sum(
                    max(0.0, k["ts"] + k["dur"] - max(k["ts"], d1))
                    for k in ks)))
    return out


def _deep_tail(result):
    """bench/run_tail.py's tail: one point a chromosome (its largest CLR)
    left active, the rest finished."""
    import numpy as np

    r = _unpermuted(result)
    keep = [np.where(r.chr_id == c)[0][np.argmax(r.clr[r.chr_id == c])]
            for c in np.unique(r.chr_id)]
    r.permute_finished[:] = True
    r.permute_finished[keep] = False
    return r


def _stream_perm(label, scanned, cfg, dev, spec, trace, fresh=_unpermuted):
    """scan_permute of fresh(scan result) at FSCL_STAT_SPEC=spec;
    (result, wall s, last_stats, kernel launches, busy share, speculative
    boundaries) with the last two from torch.profiler where ``trace``."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fscl_tpu_torch.engine import permute as TP
    from fscl_tpu_torch.ops import permute as TO
    from fscl_tpu_torch.utils import timing

    data, tables, scan_cfg, result = scanned
    r = fresh(result)
    saved = TP.STAT_SPEC
    TP.STAT_SPEC = spec
    torch.cuda.synchronize()
    TO.replicate_runs_launches = 0
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if trace else contextlib.nullcontext())
    try:
        with ctx as prof, (timing.annotating() if trace
                           else contextlib.nullcontext()):
            t0 = time.monotonic()
            TP.scan_permute(data, tables, r, scan_cfg, copy.deepcopy(cfg),
                            device=dev)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        TP.STAT_SPEC = saved
    launches = TO.replicate_runs_launches
    busy = bounds = None
    if trace:
        path = OUT / f"stream_{label.replace(' ', '_')}_spec{int(spec)}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
        dev_s = sum(e.get("dur", 0) for e in events if e.get("cat") in (
            "kernel", "gpu_memcpy", "gpu_memset")) / 1e6
        busy = dev_s / wall
        bounds = _spec_overlap(events)
    return r, wall, dict(TP.last_stats), launches, busy, bounds


def _stream_pair(label, scanned, cfg, dev, fresh=_unpermuted):
    """One run at FSCL_STAT_SPEC 0 and 1, untraced (walls, bitwise) and
    traced (busy share, chunk boundaries)."""
    import numpy as np

    res = {}
    for spec in (False, True):
        r, wall, st, launches, _, _ = _stream_perm(label, scanned, cfg, dev,
                                                   spec, False, fresh)
        _, t_wall, _, _, busy, bounds = _stream_perm(label, scanned, cfg,
                                                     dev, spec, True, fresh)
        res[spec] = dict(result=r, wall_s=wall, traced_wall_s=t_wall,
                         stats=st, launches=launches, busy=busy,
                         boundaries=bounds)
    a, b = res[False]["result"], res[True]["result"]
    same = all(np.array_equal(getattr(a, f), getattr(b, f)) for f in (
        "permute_n", "permute_p", "permute_finished")) \
        and np.array_equal(a.stat_threshold, b.stat_threshold,
                           equal_nan=True) \
        and all(x == y for x, y in zip(a.null_clr, b.null_clr))
    if not same:
        fail(f"stream {label}: FSCL_STAT_SPEC 0 and 1 differ")
    out = {}
    for spec in (False, True):
        x = res[spec]
        st = x["stats"]
        out[f"spec{int(spec)}"] = dict(
            wall_s=x["wall_s"], traced_wall_s=x["traced_wall_s"],
            busy=x["busy"], launches=x["launches"],
            spec_chunks=st["hist_spec_chunks"],
            spec_misses=st["hist_spec_misses"],
            stack_dispatches=st["stack_dispatches"],
            rdp_dispatches=st["rdp_dispatches"], boundaries=x["boundaries"])
        starts = [b["start_minus_drain_end_us"] for b in x["boundaries"]]
        log(f"[stream] {label} FSCL_STAT_SPEC={int(spec)}: permutation wall "
            f"{x['wall_s']:.3f}s (traced {x['traced_wall_s']:.3f}s, busy "
            f"{100 * x['busy']:.1f}%); speculative chunks taken "
            f"{st['hist_spec_chunks']}, dropped {st['hist_spec_misses']}; "
            f"replicate_runs launches {x['launches']}; next-chunk start "
            f"minus drain end (us) at {len(starts)} boundaries: "
            f"{[round(v, 1) for v in starts]}")
    log(f"[stream] {label}: FSCL_STAT_SPEC 0 and 1 bit for bit equal "
        f"({int(b.permute_n.sum())} point-rounds)")
    return out


def phase_stream(dev, smi):
    """Phase 12 (see the module doc)."""
    from fscl_tpu_torch.engine import permute as TP
    from fscl_tpu_torch.engine.permute import PermuteConfig

    gpos = {"20k": SCANS["20k"][0].genome_pos(),
            "genome1m": SCANS["genome1m"][0].genome_pos(),
            "big_chromosome": LOAD_INPUTS["big_chromosome"].genome_pos()}
    kern = []
    for label, key, n, start, seed, width in STREAM_SHAPES:
        kern += _stream_case(label, gpos[key], n, start, seed, width, dev)
    cli_leg = _stream_cli(dev)
    g = SCANS["genome1m"]
    genome = _stream_pair("genome1m", g, PermuteConfig(n_permute=64), dev)
    if genome["spec1"]["launches"] <= 0:
        fail("stream: genome1m's permutations launched no replicate_runs")
    saved = TP.RDP_FORCE
    TP.RDP_FORCE = "off"
    try:
        deep = _stream_pair("genome1m deep tail", g,
                            PermuteConfig(**STREAM_TAIL), dev,
                            fresh=_deep_tail)
    finally:
        TP.RDP_FORCE = saved
    on = deep["spec1"]
    if on["spec_chunks"] <= 0:
        fail(f"stream: the deep tail took no speculative chunk: {on}")
    starts = [b["start_minus_drain_end_us"] for b in on["boundaries"]]
    if starts and min(starts) >= 0:
        fail("stream: no speculative chunk's first kernel started before "
             f"its drain returned: {on['boundaries']}")
    if not starts:
        log("[stream] chunk boundaries: not measured (no launch in the "
            "trace correlated with a kernel)")
    log(f"[stream] ({smi})")
    return dict(kernel=kern, genome1m=genome, deep_tail=deep, cli=cli_leg,
                launches=genome["spec1"]["launches"])


def phase_profile(dev):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fscl_tpu_torch.engine import permute as TP
    from fscl_tpu_torch.engine import scan_genome, scan_permute
    from fscl_tpu_torch.engine.permute import PermuteConfig
    from fscl_tpu_torch.engine.scan import ScanConfig
    from fscl_tpu_torch.io import load_snp_input

    d20, t20, s20 = _task_20k()
    s20_nohist = ScanConfig(small_grid_sp=1000, large_grid_sp=100000,
                            use_hist=False)
    rdp_cfg = PermuteConfig(n_permute=64, chunk_replicates=RDP_CHUNK,
                            seed=1, hist_bf16=False)
    dg = genome_data()
    tg = _load_model(dg, compat=False)
    dm = load_snp_input(REPO / "bench" / "data" / "headline_mixed100k.sf")
    tm = _load_model(dm, compat=True)
    db, _ = big_chromosome_data()
    tb = _load_model(db, compat=False)
    # (label, data, tables, scan config, permutation config, FSCL_RDP,
    # stages)
    runs = [
        ("20k", d20, t20, s20,
         PermuteConfig(n_permute=50, chunk_replicates=32, seed=1),
         TP.RDP_FORCE, ("scan", "permute")),
        ("20k_nohist", d20, t20, s20_nohist,
         PermuteConfig(n_permute=50, chunk_replicates=32, seed=1,
                       use_hist=False),
         TP.RDP_FORCE, ("scan", "permute")),
        ("genome", dg, tg, ScanConfig(), PermuteConfig(n_permute=16),
         TP.RDP_FORCE, ("scan", "permute")),
        ("mixed100k", dm, tm, ScanConfig(), PermuteConfig(n_permute=16),
         TP.RDP_FORCE, ("scan", "permute")),
        ("big_chromosome", db, tb, ScanConfig(),
         PermuteConfig(n_permute=16), TP.RDP_FORCE, ("scan", "permute")),
        ("20k_rdp_on", d20, t20, s20, rdp_cfg, "on", ("permute",)),
        ("20k_rdp_off", d20, t20, s20, rdp_cfg, "off", ("permute",)),
    ]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    saved = TP.RDP_FORCE
    for label, data, tables, scan_cfg, perm_cfg, rdp, stages in runs:
        scan_genome(data, tables, scan_cfg, device=dev)  # warm caches
        for stage in stages:
            if stage == "permute":
                result = scan_genome(data, tables, scan_cfg, device=dev)
            torch.cuda.synchronize()
            TP.RDP_FORCE = rdp
            try:
                with profile(activities=acts) as prof:
                    t0 = time.monotonic()
                    if stage == "scan":
                        scan_genome(data, tables, scan_cfg, device=dev)
                    else:
                        scan_permute(data, tables, result, scan_cfg,
                                     copy.deepcopy(perm_cfg), device=dev)
                    torch.cuda.synchronize()
                    wall = time.monotonic() - t0
            finally:
                TP.RDP_FORCE = saved
            ka = prof.key_averages()
            # device-side kernel and memcpy events only: an aten op's own
            # device time is its kernels', and runtime stalls such as
            # "Command Buffer Full" are host time
            kern = [(e.self_device_time_total, e.count, e.key) for e in ka
                    if e.device_type == DeviceType.CUDA
                    and not e.key.startswith("Command Buffer")]
            busy = sum(t for t, _, _ in kern) / 1e6
            if any("rtile_" in k for _, _, k in kern):
                fail(f"profile {label} {stage}: a three-pass row-id kernel "
                     "(rtile_*) ran")
            ours = sum(t for t, _, k in kern if "chained_scan" in k) / 1e6
            # launches of the one-hot body by id source: (b), (a), (b')
            modes = {m: sum(n for _, n, k in kern
                            if "onehot_chained_scan" in k and m in k)
                     for m in ("SegmentSource", "RowRepIds", "PermIds")}
            wours = sum(t for t, _, k in kern
                        if "weighted_chained_scan" in k) / 1e6
            gath = sum(t for t, _, k in kern if "gather_rows" in k) / 1e6
            win = sum(t for t, _, k in kern
                      if "window_operand_kernel" in k) / 1e6
            fused = sum(t for t, _, k in kern
                        if "window_clr_kernel" in k) / 1e6
            f32 = sum(t for t, _, k in kern
                      if "window_clr_f32_kernel" in k
                      or "reduce_splits" in k) / 1e6
            gemm = sum(t for t, _, k in kern if "gemm" in k.lower()) / 1e6
            lat = sum(t for t, _, k in kern
                      if "lattice_clr_kernel" in k) / 1e6
            table = ka.table(sort_by="self_device_time_total", row_limit=40)
            (OUT / f"profile_{label}_{stage}.txt").write_text(table)
            log(f"[profile] {label} {stage}: wall {wall:.3f}s (profiled), "
                f"device kernels {busy:.3f}s = {100 * busy / wall:.1f}% "
                f"busy; prefix-sum kernels {ours * 1e3:.3f} ms (weighted "
                f"{wours * 1e3:.3f} ms; one-hot launches by id source "
                f"{modes}); fused window kernel "
                f"{fused * 1e3:.3f} ms ({100 * fused / busy:.1f}%); float32 "
                f"window kernel (and its split reduction) {f32 * 1e3:.3f} ms "
                f"({100 * f32 / busy:.1f}%); window "
                f"operand {win * 1e3:.3f} ms ({100 * win / busy:.1f}%); "
                f"matmul (gemm) {gemm * 1e3:.3f} ms "
                f"({100 * gemm / busy:.1f}%); row gather {gath * 1e3:.3f} "
                f"ms ({100 * gath / busy:.1f}%); lattice kernel "
                f"{lat * 1e3:.3f} ms ({100 * lat / max(busy, 1e-12):.1f}%)")
            for t, n, key in sorted(kern, reverse=True)[:10]:
                log(f"[profile]   {t / 1e3:10.2f} ms  {n:7d}x  {key[:90]}")
    # phase 12's deep tail with speculation on: the chunk boundaries
    TP.RDP_FORCE = "off"
    try:
        _, wall, st, _, busy, bounds = _stream_perm(
            "profile deep tail", (dg, tg, ScanConfig(),
                                  scan_genome(dg, tg, ScanConfig(),
                                              device=dev)),
            PermuteConfig(**STREAM_TAIL), dev, True, True, _deep_tail)
    finally:
        TP.RDP_FORCE = saved
    log(f"[profile] genome1m deep tail, FSCL_STAT_SPEC=1: wall {wall:.3f}s "
        f"(profiled), {100 * busy:.1f}% busy, speculative chunks "
        f"{st['hist_spec_chunks']} taken, {st['hist_spec_misses']} dropped; "
        "at each boundary the next chunk's first kernel start minus the "
        f"drain's end (us) and its kernel time after the drain: {bounds}")


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
    parser_build_s = phase_build()
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
    # shapes that stress the chained scans: w off the tile (a partial last
    # tile), one tile, 24 segments of many tiles, L off the lane block and
    # odd (lane-by-lane stores), and the largest L
    from fscl_tpu_torch import kernels

    tile = kernels.load().fscl_ps_tile()
    stress = [("w off the tile", 3, 5 * tile + 96, 8, 45),
              ("one tile", 2, tile, 32, 56),
              ("S=24 many tiles, odd L", 24, 12 * tile + 224, 5, 37),
              ("L=8192 P=64", 2, 8 * tile + 32, 64, 128),
              ("L=8192 P=64 int32", 1, 33024, 64, 128)]
    kern = phase_kernel(dev, shapes, stress)
    gkern = phase_gkernel(dev)
    # mixed100k: 4 chromosomes of ~23.7k sites (ladder rung 4, w_seg_p
    # 24576), 1,589 table rows compressed to 32 f32 channels
    sub_mix = _sub_rep_for(SimpleNamespace(n_rows=32, weights=True), 4,
                           24576)
    wshapes = [("mixed100k main path", 4, 24576, sub_mix, 32, 1590),
               ("widest R=104, 8193 rows", 1, 36864, 16, 104, 8193)]
    tile = kernels.load().fscl_wps_tile()
    wstress = [("w off the tile, odd R", 3, 5 * tile + 96, 8, 33, 700),
               ("one tile", 2, tile, 32, 32, 1590),
               ("S=24 many tiles, odd L", 24, 12 * tile + 224, 5, 37, 300),
               ("L=6656 P=64", 1, 8 * tile + 32, 64, 104, 8193)]
    wkern = phase_wkernel(dev, wshapes, wstress)
    # 3a/3b: first the shapes phase 7 gives the kernels (the 20k task:
    # 20,000 sites, one chromosome padded to 20,480, R=56, a 32-replicate
    # chunk), then the 20k padded width and one genome1m-sized chromosome
    # in int32 (its longest, 35,351 sites, starting off a group boundary)
    rshapes = [("20k path", RDP_CHUNK, 20000, 56),
               ("20k padded", RDP_CHUNK, 20480, 56),
               ("genome1m chromosome", 16, 35351, 48)]
    # shapes that stress the shared chained scan (tile as phase 3's): W
    # off the tile, one tile, under a tile, odd L, the largest L in int16
    # and int32, R = 1 at 256 replicates (64 KB of staged ids: the shared
    # memory opt-in), and no site at all (the zero row, no launch)
    tile = kernels.load().fscl_ps_tile()
    rstress = [("W off the tile", 8, 5 * tile + 96, 45),
               ("one tile", 32, tile, 56),
               ("under a tile", 32, 300, 56),
               ("odd L", 5, 12 * tile + 224, 37),
               ("L=8192 P=64", 64, 8 * tile + 32, 128),
               ("L=8192 P=64 int32", 64, 33024, 128),
               ("P=256 R=1", 256, 20000, 1),
               ("W=0", 16, 0, 8)]
    rkern = phase_rkernel(dev, rshapes, rstress)
    pshapes = [("20k path", 20000, 0, 20000, 20480, RDP_CHUNK, 56),
               ("genome1m chromosome", 80000, 40013, 35351, 36864, 16, 48)]
    # the same, plus the chromosome's geometry: n < w_pad with a start off
    # a group boundary, and n = 0 (every site without an id)
    pstress = [("W off the tile, n < w_pad", 9000, 4133, 2600, 5 * tile + 96,
                8, 45),
               ("one tile", 2000, 0, tile, tile, 32, 56),
               ("under a tile, off 0", 2000, 64, 300, 320, 32, 56),
               ("odd L", 10000, 1000, 6300, 12 * tile + 224, 5, 37),
               ("L=8192 P=64", 6000, 37, 4100, 8 * tile + 32, 64, 128),
               ("L=8192 P=64 int32", 40000, 3, 33000, 33024, 64, 128),
               ("P=256 R=1", 30000, 555, 20000, 20480, 256, 1),
               ("n=0", 3000, 100, 0, 1024, 16, 8)]
    pkern = phase_pkernel(dev, pshapes, pstress)
    wide = phase_wide(dev)
    r20 = phase_20k(dev)
    if (r20["w_seg_p"], r20["sub_rep"], r20["n_rows"]) != (20480, sub_20k, 56):
        fail(f"20k main path ran at w={r20['w_seg_p']} P={r20['sub_rep']} "
             f"R={r20['n_rows']}, not the shape phase 3 checked")
    rl = phase_20k_nohist(dev)
    r1024 = phase_20k_grid1024(dev)
    rb = phase_big_chromosome(dev)
    rg = phase_genome(dev)
    if rg["stacks"] != [(36864, 22, sub_gen)] or rg["n_rows"] != 48:
        fail(f"genome main path ran at {rg['stacks']} R={rg['n_rows']}, "
             "not the shape phase 3 checked")
    rm = phase_mixed100k(dev)
    if rm["stacks"] != [(24576, 4, sub_mix)] or rm["n_rows"] != 32 \
            or rm["rows_used"] != 1589:
        fail(f"mixed100k main path ran at {rm['stacks']} R={rm['n_rows']} "
             f"rows={rm['rows_used']}, not the shape phase 3c checked")
    cg = phase_cgkernel(dev)
    rx = phase_exact(dev)
    chk = phase_check(dev)
    rr = phase_rdp(dev)
    if (rr["rowid_shape"] != (RDP_CHUNK, 20000, 56)
            or rr["perm_shape"] != (20000, 20480, RDP_CHUNK, 56)):
        fail(f"rdp path ran the kernels at {rr['rowid_shape']} and "
             f"{rr['perm_shape']}, not the shapes phases 3a and 3b checked")
    rms = phase_ms(dev)
    rres = phase_resume(dev, smi, rg["perm_s"])
    rsplit = phase_split(dev, smi)
    rload = phase_load(smi, rsplit, parser_build_s)
    rstream = phase_stream(dev, smi)

    gkern = rr["gkernel"] + gkern  # the RDP path's shape first
    okern = (r20["okernel"] + rg["okernel"] + rm["okernel"]
             + rr["okernel"])
    fkern = (r20["fkernel"] + rg["fkernel"] + rm["fkernel"]
             + wide["fkernel"])
    f32kern = (r20["f32kernel"] + rg["f32kernel"] + rm["f32kernel"]
               + rr["f32kernel"] + wide["f32kernel"])
    rkern = rkern + wide["rkernel"]
    detail = dict(device=name, nvidia_smi=smi, kernel=kern, wkernel=wkern,
                  rkernel=rkern, pkernel=pkern, gkernel=gkern,
                  okernel=okern, fkernel=fkern, f32kernel=f32kern,
                  lkernel=rl["lkernel"] + r1024["lkernel"] + rb["lkernel"],
                  bench_20k=r20, bench_20k_nohist=rl,
                  bench_20k_grid1024=r1024, big_chromosome=rb, genome=rg,
                  mixed100k=rm, wide=wide, cgkernel=cg["cgkernel"],
                  exact=rx,
                  check=chk, rdp=rr, ms=rms, resume=rres, split=rsplit,
                  load=rload, stream=rstream)
    (OUT / "smoke.json").write_text(json.dumps(detail, indent=1) + "\n")

    def entry(name, source, replaces, launches, runs, main=None, note=None,
              **extra):
        """The kernel's line: the main path's shape (the run labelled
        main, else the first) for the times and bound, the largest error
        over every shape checked."""
        m = runs[[k["label"] for k in runs].index(main) if main else 0]
        out = {
            "name": name, "route": "cuda",
            "source": f"fscl_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(k["max_abs_err"] for k in runs),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m.get("library_ms"),
        }
        if note:
            out["library_note"] = note
        if "max_err_over_tol" in m:  # the error against its stated bound
            out["max_err_over_tol"] = max(k["max_err_over_tol"] for k in runs)
        out.update(extra)
        return out

    pallas_ps = "fscl_tpu/ops/pallas_ps.py:148 "
    fused = ("no single PyTorch call computes this fused gather + one-hot "
             "(or weight) + prefix function")
    log(smi)
    log(json.dumps({"kernels": [
        entry("onehot_prefix_sums", "prefix_sums.cu",
              pallas_ps + "(mode (b), segmented one-hot)", r20["launches"],
              kern, note=fused, cumsum_only_ms=kern[0]["cumsum_only_ms"]),
        entry("weighted_prefix_sums", "weighted_prefix_sums.cu",
              pallas_ps + "(mode (c), f32 weight channels)", rm["launches"],
              wkern, note=fused, cumsum_only_ms=wkern[0]["cumsum_only_ms"]),
        entry("rowid_prefix_sums", "prefix_sums.cu",
              pallas_ps + "(mode (a), row ids vs lane % R)",
              rr["launches"]["rowid"], rkern, note=fused,
              cumsum_only_ms=rkern[0]["cumsum_only_ms"]),
        entry("perm_prefix_sums", "prefix_sums.cu",
              pallas_ps + "(mode (b), unsegmented one-hot)",
              rr["launches"]["perm"], pkern, note=fused,
              cumsum_only_ms=pkern[0]["cumsum_only_ms"]),
        entry("row_gather", "row_gather.cu",
              "bench/micro_pallas_gather.py:40 pallas_gather",
              rr["launches"]["gather_rdp_on"], gkern),
        # off the path (0 launches, checked in every run): the yardstick
        # of window_clr_f32, timed at the 20k tie stage's first chunk
        entry("window_operand", "row_gather.cu",
              "fscl_tpu/ops/histclr.py:1116-1126 (XLA-fused, no Pallas "
              "kernel)", sum(r20["window_launches"]["window_operand"]),
              okern, main="20k scan tie stage, mm_bf16=False",
              note="no single PyTorch call computes the gather -> "
                   "difference -> lerp chain; off the main path, the "
                   "yardstick of window_clr_f32"),
        # main shape: the 20k permutations' launch, one stacked slice's
        # whole call (the bfloat16 statistic takes every candidate at once)
        entry("window_clr", "window_clr.cu",
              "fscl_tpu/ops/histclr.py:1116-1131 (mm_bf16=True; XLA-fused, "
              "no Pallas kernel)", sum(r20["window_launches"]["window_clr"]),
              fkern, main="20k stacked slice (whole call)",
              note="no single PyTorch call computes the windows-to-CLR "
                   "function; its two-step yardsticks are in smoke.json "
                   "(two_step_f32_ms, two_step_bf16_ms)"),
        # main shape: the 20k scan's tie stage, its one call
        entry("window_clr_f32", "window_clr_f32.cu",
              "fscl_tpu/ops/histclr.py:1116-1131 (mm_bf16=False; "
              "XLA-fused, no Pallas kernel)",
              sum(r20["window_launches"]["window_clr_f32"]), f32kern,
              main="20k tie stage (whole call)",
              note="no single PyTorch call computes the windows-to-CLR "
                   "function; its two-step yardsticks are in smoke.json "
                   "(two_step_f32_ms, two_step_tf32_ms)",
              reduce_launches=sum(
                  r20["window_launches"]["window_clr_f32_reduce"]),
              max_err_f64_ratio=max(
                  k["err_f64"] / max(k["err_f64_matmul"], 1e-300)
                  for k in f32kern)),
        # main shape: the 20k --no-hist scan's dense coarse call; launches
        # over that run's scan and permutations
        entry("clr_lattice", "lattice_clr.cu",
              "fscl_tpu/ops/lattice.py:94-155 clr_lattice (XLA-fused, no "
              "Pallas kernel)",
              rl["launches"]["scan"] + rl["launches"]["permute"],
              rl["lkernel"] + r1024["lkernel"] + rb["lkernel"],
              note="no single PyTorch call computes the per-site lattice "
                   "CLR",
              grid1024_tie_launches=r1024["launches"],
              big_chromosome_launches=(rb["launches"]["scan"]
                                       + rb["launches"]["permute"])),
        # main shape: the 20k dense grid's coarse call; launches (of both
        # its kernels) over phase 4e's calls
        entry("clr_grid", "clr_grid.cu",
              "fscl_tpu/ops/clr.py:88 clr_grid (XLA-fused, no Pallas "
              "kernel)", rx["launches"], cg["cgkernel"],
              note="no single PyTorch call computes the CLR of every "
                   "(candidate, alpha) pair; launches counts both kernels "
                   "of a call, clr_grid_partials and clr_grid_reduce",
              lattice_vs_clr_grid_over_tol=cg[
                  "lattice_vs_clr_grid_over_tol"],
              old_bound_ms=cg["cgkernel"][0]["old_bound_ms"],
              flagship=[{k: r[k] for k in (
                  "label", "ms", "wrapper_ms", "plain_ms", "bound_ms",
                  "old_bound_ms", "max_abs_err")}
                  for r in cg["cgkernel"] if r["label"].startswith(
                      "flagship")]),
        # main shape: genome1m's first chunk (16 replicates, the CLI's
        # default) in the sigma form, the kernel alone; launches over
        # phase 12's genome1m permutations with speculation on
        entry("replicate_runs", "replicate_runs.cu",
              "fscl_tpu/ops/permute.py:57-150 _one_replicate_runs under "
              "_replicates and _replicates_runs (XLA-fused, no Pallas "
              "kernel)", rstream["launches"], rstream["kernel"],
              main="genome1m chunk (sigma)",
              note="no single PyTorch call computes fscl_tpu's threefry "
                   "block shuffle",
              wrapper_ms=next(k["wrapper_ms"] for k in rstream["kernel"]
                              if k["label"] == "genome1m chunk (sigma)"),
              cli_blocks=rstream["cli"]["blocks"],
              cli_launches=rstream["cli"]["launches"],
              deep_tail_spec_chunks=rstream["deep_tail"]["spec1"][
                  "spec_chunks"]),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
