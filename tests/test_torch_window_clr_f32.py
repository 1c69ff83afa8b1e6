"""The float32 route of the hist statistic in one kernel
(fscl_tpu_torch/ops/window_clr.py: window_clr_f32) against the JAX
package.

  * window_clr_f32_plain (through the wrapper, on the CPU) against
    fscl_tpu.ops.histclr.hist_clr_reps_ps with mm_bf16=False on seeded
    numpy inputs: int16 prefixes wrapped past +-32767, int32 and float32
    prefixes; P in {1, 3, 16}; A in {8, 40, 128}; all-zero padding
    candidates appended.  Each entry within 2 K 2^-24 S (S = 2 sum_k |k
    t|: the operands are the same bits, so only the order of the float32
    sums differs), and on count prefixes also within rtol=1e-5, atol=1e-3,
    as tests/test_torch_gather.py states for this route (its float32
    prefixes are held to 5e-3; these, of scale 300, reach 5.1e-3); the
    padding candidates give exactly 0;
  * f32_pack pads to 16-byte rows, keeps t3's values bitwise and is built
    once per table;
  * the wrapper refuses other devices, and the kernel's input check
    refuses shapes, dtypes and alignments the kernel does not take;
  * the slice as a whole: the port's scan_genome (every stage on this
    route, selection_bf16=False) against the JAX scan, with
    tests/test_torch_slice.py's tolerances, window_clr_f32 reached;
  * on the card (marker ``gpu``): the kernel against its plain version
    within 1e-5 S + 1e-5 per entry (S = 2 sum_k |k t| in float64) at the
    path's shapes, one forced into a split over cells and one not; its
    largest error against a float64 contraction at most 4x that of the
    float32 torch.matmul route; two launches bitwise equal.

This file imports nothing of tests/: on the card machine such imports do
not collect.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fscl_tpu.engine.scan as JS
import fscl_tpu.ops.histclr as JH
import fscl_tpu_torch.ops.histclr as TH
from fscl_tpu.data import build_snp_data
from fscl_tpu.models import background_fsp, build_tables
from fscl_tpu.sim import simulate_dataset
from fscl_tpu_torch.engine.scan import ScanConfig, scan_genome
from fscl_tpu_torch.ops import gather as G
from fscl_tpu_torch.ops import window_clr as W

F32_REL = 1e-5  # kernel vs plain: |diff| <= F32_REL * S + F32_ABS
F32_ABS = 1e-5
F64_RATIO = 4.0  # kernel's error vs float64 over the f32 matmul route's


def _window_inputs(seed, dtype, *, rows=300, c=7, NC=9, P=3, R=8, pad=0):
    """Prefix rows, bounds and fbar like the path's: side 0 walks left
    from the split point, side 1 right, with empty windows (repeated
    bounds) and fbar 0.5 on them; pad all-zero padding candidates (bounds
    0, fbar 0) appended.  int16 prefixes carry an offset that wraps them
    past +-32767, as the stacked slab's one-group-early start does."""
    rng = np.random.default_rng(seed)
    L = P * R
    if dtype == np.float32:
        steps = rng.normal(size=(rows, L)) * np.geomspace(300.0, 0.1, L)
        ps = np.cumsum(steps, 0).astype(np.float32)
    else:
        ps = np.cumsum(rng.integers(0, 3, size=(rows, L)), 0)
        if dtype == np.int16:
            ps = ps + (32767 - rows)
        ps = ps.astype(dtype)  # int16: wraps mod 2^16
    sp = rng.integers(rows // 3, 2 * rows // 3, size=c)
    left = sp[:, None] - np.cumsum(rng.integers(0, 6, size=(c, NC)), 1)
    right = sp[:, None] + np.cumsum(rng.integers(0, 6, size=(c, NC)), 1)
    bounds = np.stack([
        np.concatenate([sp[:, None], np.maximum(left, 0)], 1),
        np.concatenate([sp[:, None], np.minimum(right, rows - 1)], 1),
    ], 1).astype(np.int32)
    fbar = rng.random(size=(c, 2, NC)).astype(np.float32)
    fbar[:, :, -2:] = [0.0, 1.0]
    fbar = np.where(bounds[:, :, 1:] == bounds[:, :, :-1], np.float32(0.5),
                    fbar)
    bounds = np.concatenate([bounds, np.zeros((pad, 2, NC + 1), np.int32)])
    fbar = np.concatenate([fbar, np.zeros((pad, 2, NC), np.float32)])
    return ps, bounds, fbar


def _pack(seed, K, A):
    """A [K, A] f32 pack of log-likelihood-difference scale."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(K, A)) * 3.0).astype(np.float32)


def _kw(P, NC, R, A):
    return dict(n_rep=P, n_cells=NC, n_rows=R, n_alpha=A)


# ---- CPU: the plain version against the JAX package ------------------------

@pytest.mark.parametrize("A", [8, 40, 128])
@pytest.mark.parametrize("P", [1, 3, 16])
@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float32])
def test_window_clr_f32_plain_matches_jax(dtype, P, A):
    NC, R, pad = 9, 8, 2
    ps, bounds, fbar = _window_inputs(P + A, dtype, P=P, R=R, NC=NC, pad=pad)
    if dtype == np.int16:  # the wrap is exercised
        assert ps.min() < -30000 and ps.max() > 30000
    t3 = _pack(A, 2 * NC * R, A)
    kw = _kw(P, NC, R, A)
    want = np.asarray(JH.hist_clr_reps_ps(
        jnp.asarray(t3), jnp.asarray(bounds), jnp.asarray(fbar),
        jnp.asarray(ps), mm_bf16=False, **kw))  # [P, C, A]
    args = [torch.as_tensor(x) for x in (ps, bounds, fbar)]
    before = W.window_clr_f32_launches
    got = W.window_clr_f32(*args, W.f32_pack(torch.as_tensor(t3)), **kw)
    assert W.window_clr_f32_launches == before  # plain version on the CPU
    assert got.shape == (bounds.shape[0], P, A) and got.dtype == torch.float32
    got = got.permute(1, 0, 2).numpy()
    # the operands are the same bits (tests/test_torch_gather.py) and each
    # product is rounded once, so only the order of the float32 sums
    # differs: two orders of K products stay within 2 K 2^-24 S
    k = G.window_operand_plain(*args, n_rep=P, n_cells=NC, n_rows=R)
    s = (2.0 * k.abs().double() @ torch.as_tensor(t3).abs().double())
    s = s.numpy().reshape(bounds.shape[0], P, A).transpose(1, 0, 2)
    assert np.all(np.abs(got - want) <= 2 * k.shape[1] * 2.0**-24 * s)
    if dtype != np.float32:  # counts: the stated tolerance too
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    assert not got[:, -pad:].any()  # padding candidates: exactly 0


def test_f32_pack_pads_keeps_bits_and_is_built_once():
    t3 = torch.as_tensor(_pack(7, 48, 13))
    pack = W.f32_pack(t3)
    assert pack.dtype == torch.float32 and pack.shape == (48, 16)
    assert pack.is_contiguous() and pack.data_ptr() != t3.data_ptr()
    assert torch.equal(pack[:, :13].view(torch.int32), t3.view(torch.int32))
    assert not pack[:, 13:].any()
    assert W.f32_pack(t3) is pack
    assert W.bf16_pack(t3) is not pack  # one cache entry per pack dtype
    assert W.f32_pack(t3) is pack
    t3.mul_(2.0)  # a changed pack is copied again
    again = W.f32_pack(t3)
    assert again is not pack
    assert torch.equal(again[:, :13], t3)


def test_window_clr_f32_refuses_other_devices():
    t = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        W.window_clr_f32(t, None, None, None, n_rep=1, n_cells=1, n_rows=8,
                         n_alpha=4)


def _bad_inputs(case):
    """Kernel inputs (CPU tensors) with one defect; P=2, NC=5, R=16, A=6."""
    P, NC, R, A = 2, 5, 16, 6
    ps, bounds, fbar = (torch.as_tensor(x) for x in _window_inputs(
        3, np.int32, P=P, R=R, NC=NC))
    pack = W.f32_pack(torch.as_tensor(_pack(3, 2 * NC * R, A)))
    kw = _kw(P, NC, R, A)
    if case in ("R not a multiple of 8", "R over R_MAX"):
        R = 12 if case == "R not a multiple of 8" else W.R_MAX + 8
        ps = torch.zeros((10, P * R), dtype=torch.int32)
        pack = torch.zeros((2 * NC * R, 8), dtype=torch.float32)
        kw.update(n_rows=R)
    elif case == "pack rows":
        pack = pack[:-1]
    elif case == "pack width":
        pack = torch.zeros((2 * NC * R, 6), dtype=torch.float32)
    elif case == "pack dtype":
        pack = W.bf16_pack(torch.as_tensor(_pack(3, 2 * NC * R, A)))
    elif case == "fbar shape":
        fbar = fbar[:, :, :-1]
    elif case == "bounds dtype":
        bounds = bounds.to(torch.int64)
    elif case == "ps dtype":
        ps = ps.to(torch.int64)
    elif case == "ps misaligned":
        ps = torch.zeros(ps.numel() + 1, dtype=torch.int32)[1:].view(
            ps.shape)
    return ps, bounds, fbar, pack, kw


@pytest.mark.parametrize("case", [
    "R not a multiple of 8", "R over R_MAX", "pack rows", "pack width",
    "pack dtype", "fbar shape", "bounds dtype", "ps dtype", "ps misaligned",
])
def test_window_clr_f32_kernel_check_refuses(case):
    ps, bounds, fbar, pack, kw = _bad_inputs(case)
    with pytest.raises(ValueError):
        W._check_kernel_inputs("window_clr_f32", ps, bounds, fbar, pack,
                               torch.float32, 4, **kw)


def test_window_clr_f32_kernel_check_accepts():
    ps, bounds, fbar, pack, kw = _bad_inputs("none")
    W._check_kernel_inputs("window_clr_f32", ps, bounds, fbar, pack,
                           torch.float32, 4, **kw)


# ---- CPU: the slice as a whole ---------------------------------------------

SCAN = dict(eval_range=1500, small_grid_sp=10000, large_grid_sp=200000,
            exact_step_max=1.0, selection_bf16=False)


@pytest.fixture(scope="module")
def dataset():
    chrs, pos, fr = [], [], []
    for c in range(2):
        sim = simulate_dataset(seed=90 + c, sample_size=30, mb_length=3.0,
                               alpha=3e-5)
        chrs += [f"c{c + 1}"] * len(sim["pos"])
        pos.append(sim["pos"])
        fr.append(sim["freq"])
    pos, fr = np.concatenate(pos), np.concatenate(fr)
    data = build_snp_data(chrs, pos, fr, np.full(len(pos), 30),
                          np.zeros(len(pos), bool))
    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths)
    tables = build_tables(fsp, data.sample_depths, grid_points=1024)
    data.attach_model(tables)
    return data, tables


def test_scan_genome_through_window_clr_f32_matches(dataset, monkeypatch):
    """CLR within 1e-3, lalpha equal, sweep_pos equal wherever the JAX
    tie-stage winner beats its runner-up by more than 1e-3."""
    data, tables = dataset
    gaps, calls = {}, []
    orig = JS._report_pool_max

    def spy(st, cand, clr, la):
        for k in range(st.n_int):
            v = np.sort(np.asarray(clr)[st.owner_x == k])[::-1]
            gaps[(st.c, k)] = v[0] - v[1] if len(v) > 1 else np.inf
        return orig(st, cand, clr, la)

    real = TH.window_clr_f32

    def count(*a, **k):
        calls.append(a[1].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(JS, "_report_pool_max", spy)
    monkeypatch.setattr(TH, "window_clr_f32", count)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    want = JS.scan_genome(data, tables, JS.ScanConfig(**SCAN))
    got = scan_genome(data, tables, ScanConfig(**SCAN), device="cpu")
    assert len(calls) > 0 and gaps  # the route ran, the tie stage too
    assert got.n_points == want.n_points > 0
    np.testing.assert_array_equal(got.chr_id, want.chr_id)
    np.testing.assert_allclose(got.clr, want.clr, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.lalpha, want.lalpha)
    idx = np.zeros(len(want.chr_id), np.int64)
    for c in np.unique(want.chr_id):
        idx[want.chr_id == c] = np.arange((want.chr_id == c).sum())
    clear = np.array([gaps[(int(c), k)] > 1e-3
                      for c, k in zip(want.chr_id, idx)])
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.sweep_pos[clear], want.sweep_pos[clear])


# ---- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _card_case(dev, dtype, P, R, A, *, c=300, NC=61, seed=11, pad=0):
    ps, bounds, fbar = _window_inputs(seed, dtype, rows=5000, c=c, NC=NC,
                                      P=P, R=R, pad=pad)
    t3 = torch.as_tensor(_pack(seed, 2 * NC * R, A), device=dev)
    args = [torch.as_tensor(x, device=dev) for x in (ps, bounds, fbar)]
    return args, t3, _kw(P, NC, R, A)


def _f64(args, t3, kw):
    """(2 k t, S = 2 sum_k |k t|) in float64, [c, P, A]: k from the plain
    window operand."""
    k = G.window_operand_plain(*args, n_rep=kw["n_rep"],
                               n_cells=kw["n_cells"],
                               n_rows=kw["n_rows"]).double()
    t = t3.double()
    shape = (args[1].shape[0], kw["n_rep"], kw["n_alpha"])
    return ((2.0 * k @ t).reshape(shape),
            (2.0 * k.abs() @ t.abs()).reshape(shape))


CARD_SHAPES = [  # dtype, P, R, A, c, NC, pad
    (np.int16, 1, 56, 128, 300, 61, 0),  # the scan (P = 1, 128 alphas)
    (np.int16, 32, 56, 32, 300, 61, 0),  # a stacked 20k slice
    (np.int32, 16, 48, 32, 300, 61, 0),  # genome
    (np.float32, 32, 32, 32, 300, 61, 0),  # compressed mixed depth
    (np.int16, 1, 56, 40, 37, 61, 5),  # c off the 64-row tile, padding
    (np.int16, 1, 56, 128, 1600, 718, 0),  # 20k tie stage: P = 1, NC = 718
    (np.float32, 3, 104, 200, 50, 61, 3),  # R = 104, A over two tiles
    (np.int32, 1, 128, 128, 40, 33, 0),  # R = R_MAX
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, P, R, A, c, NC, pad", CARD_SHAPES)
def test_window_clr_f32_kernel_matches_plain_on_card(dtype, P, R, A, c, NC,
                                                      pad):
    dev = _card()
    args, t3, kw = _card_case(dev, dtype, P, R, A, c=c, NC=NC, pad=pad)
    pack = W.f32_pack(t3)
    before = W.window_clr_f32_launches
    got = W.window_clr_f32(*args, pack, **kw)
    want = W.window_clr_f32_plain(*args, pack, **kw)
    torch.cuda.synchronize()
    assert W.window_clr_f32_launches == before + 1
    _, s = _f64(args, t3, kw)
    err = (got.double() - want.double()).abs()
    assert bool((err <= F32_REL * s + F32_ABS).all()), float(err.max())
    if pad:  # all-zero padding candidates give exactly 0
        assert not got[-pad:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("c, split", [(200, True), (20000, False)])
def test_window_clr_f32_split_over_cells_on_card(c, split):
    """A sub-wave grid splits its cells (and reduces the partial sums in
    a second launch); a grid of more than two waves does not; both agree
    with the plain version."""
    dev = _card()
    P, R, A, NC = 1, 56, 128, 181
    args, t3, kw = _card_case(dev, np.int16, P, R, A, c=c, NC=NC, seed=13)
    splits = W.window_clr_f32_splits(c * P, n_cells=NC, n_rows=R, n_alpha=A,
                                     device=dev)
    assert (splits > 1) == split and splits <= NC
    before = W.window_clr_f32_reduce_launches
    got = W.window_clr_f32(*args, W.f32_pack(t3), **kw)
    want = W.window_clr_f32_plain(*args, W.f32_pack(t3), **kw)
    torch.cuda.synchronize()
    assert W.window_clr_f32_reduce_launches == before + split
    _, s = _f64(args, t3, kw)
    err = (got.double() - want.double()).abs()
    assert bool((err <= F32_REL * s + F32_ABS).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, P, R, A, c, NC, pad", CARD_SHAPES[:6])
def test_window_clr_f32_float64_error_on_card(dtype, P, R, A, c, NC, pad):
    """The kernel's largest error against a float64 contraction is at most
    F64_RATIO x that of the window operand + float32 torch.matmul route."""
    dev = _card()
    args, t3, kw = _card_case(dev, dtype, P, R, A, c=c, NC=NC, pad=pad)
    ref, _ = _f64(args, t3, kw)
    got = W.window_clr_f32(*args, W.f32_pack(t3), **kw)
    k = G.window_operand(*args, n_rep=P, n_cells=NC, n_rows=R)
    torch.backends.cuda.matmul.allow_tf32 = False
    mm = (2.0 * torch.matmul(k, t3)).reshape(got.shape)
    e_kernel = float((got.double() - ref).abs().max())
    e_mm = float((mm.double() - ref).abs().max())
    assert e_kernel <= F64_RATIO * e_mm, (e_kernel, e_mm)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [200, 20000])
def test_window_clr_f32_deterministic_on_card(c):
    dev = _card()
    args, t3, kw = _card_case(dev, np.int32, 1, 48, 128, c=c, NC=189,
                              seed=14)
    pack = W.f32_pack(t3)
    a = W.window_clr_f32(*args, pack, **kw)
    b = W.window_clr_f32(*args, pack, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
