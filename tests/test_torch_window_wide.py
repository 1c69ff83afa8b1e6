"""The hist statistic's kernels at 128 < R <= 256 rows (exact one-hot
tables of one large depth): the 1b one-hot prefix sums
(ops/prefix_sums.py) and both window statistics (ops/window_clr.py),
whose kernels walk each cell in two K steps there (window_clr_kernel_wide,
window_clr_f32_kernel_wide).

  * CPU, R in {136, 216, 256}: the plain one-hot prefix sums against a
    count written out in numpy, bitwise (integers); the plain window
    statistics against a numpy one: the operand in float32 with the same
    separately rounded operations (bitwise the plain version's, so the
    bf16 route rounds the same values), contracted in float64; each
    entry within 2 K 2^-24 S, S = 2 sum_k |k t| (the plain version's
    float32 matmul against the exact sum of the same K products);
  * on the card (marker ``gpu``): both wide kernels against their plain
    versions at R in {136, 216, 256} and A in {32, 128}, within 2e-4 S +
    1e-5 (bf16; its tests at R <= 128 hold it so) and 1e-5 S + 1e-5
    (f32), each launch counted as wide; the bf16 kernel split over a
    cluster at A = 32 (a permutation tail's launch), its entries bitwise
    those of candidates launched alone, and its operand read back bitwise
    through a one-hot pack; the 1b kernel and RDP's site prefix (the
    row-id kernel) bitwise against their plain versions at R = 216.

This file imports neither JAX nor anything of tests/, so its card tests
run on the card machine.
"""

import numpy as np
import pytest
import torch

from fscl_tpu_torch.ops import gather as G
from fscl_tpu_torch.ops import prefix_sums as tps
from fscl_tpu_torch.ops import window_clr as W

U = 2.0 ** -24  # float32 unit roundoff
WIDE = [136, 216, 256]
PG = 32


def _window_inputs(seed, dtype, *, rows, c, NC, P, R):
    """Prefix rows, bounds and fbar like the path's: side 0 walks left
    from the split point, side 1 right, with empty windows and fbar 0.5
    on them; int16 prefixes wrap past +-32767."""
    rng = np.random.default_rng(seed)
    L = P * R
    if dtype == np.float32:
        steps = rng.normal(size=(rows, L)) * np.geomspace(300.0, 0.1, L)
        ps = np.cumsum(steps, 0).astype(np.float32)
    else:
        ps = np.cumsum(rng.integers(0, 3, size=(rows, L)), 0)
        if dtype == np.int16:
            ps = ps + (32767 - rows)
        ps = ps.astype(dtype)
    sp = rng.integers(rows // 3, 2 * rows // 3, size=c)
    left = sp[:, None] - np.cumsum(rng.integers(0, 6, size=(c, NC)), 1)
    right = sp[:, None] + np.cumsum(rng.integers(0, 6, size=(c, NC)), 1)
    bounds = np.stack([
        np.concatenate([sp[:, None], np.maximum(left, 0)], 1),
        np.concatenate([sp[:, None], np.minimum(right, rows - 1)], 1),
    ], 1).astype(np.int32)
    fbar = rng.random(size=(c, 2, NC)).astype(np.float32)
    fbar = np.where(bounds[:, :, 1:] == bounds[:, :, :-1], np.float32(0.5),
                    fbar)
    return ps, bounds, fbar


def _pack(seed, K, A):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(K, A)) * 3.0).astype(np.float32)


def _operand_np(ps, bounds, fbar, *, P, NC, R):
    """[c*P, 2*NC*R] float32 window operand, written out in numpy: the
    signed difference in the prefix dtype, then w0 = h0 (1 - f0) + h1
    (1 - f1) and w1 = h0 f0 + h1 f1, each operation rounded alone."""
    c = bounds.shape[0]
    rows = ps[bounds]  # [c, 2, NC+1, P*R]
    d = rows[:, :, 1:] - rows[:, :, :-1]  # wraps in int16
    d[:, 0] = -d[:, 0]
    h = d.astype(np.float32)  # [c, 2, NC, L]
    f = fbar[..., None].astype(np.float32)
    one = np.float32(1.0)
    w0 = h[:, 0] * (one - f[:, 0]) + h[:, 1] * (one - f[:, 1])
    w1 = h[:, 0] * f[:, 0] + h[:, 1] * f[:, 1]
    k = np.stack([w0, w1], 1).reshape(c, 2, NC, P, R)  # [c, s, j, p, r]
    return k.transpose(0, 3, 1, 2, 4).reshape(c * P, 2 * NC * R)


def _bf16(x):
    return torch.as_tensor(x).to(torch.bfloat16).to(torch.float32)


def _kw(P, NC, R, A):
    return dict(n_rep=P, n_cells=NC, n_rows=R, n_alpha=A)


# ---- CPU: the plain versions ----------------------------------------------

@pytest.mark.parametrize("R", WIDE)
@pytest.mark.parametrize("mm_bf16", [True, False])
def test_plain_window_statistics_at_wide_rows(R, mm_bf16):
    P, NC, A, c = 2, 13, 32, 5
    ps, bounds, fbar = _window_inputs(R, np.int16, rows=600, c=c, NC=NC, P=P,
                                      R=R)
    t3 = torch.as_tensor(_pack(R + 1, 2 * NC * R, A))
    args = [torch.as_tensor(x) for x in (ps, bounds, fbar)]
    if mm_bf16:
        got = W.window_clr_plain(*args, W.bf16_pack(t3), **_kw(P, NC, R, A))
        k = _bf16(_operand_np(ps, bounds, fbar, P=P, NC=NC, R=R))
        t = _bf16(t3)
    else:
        got = W.window_clr_f32_plain(*args, W.f32_pack(t3),
                                     **_kw(P, NC, R, A))
        k = torch.as_tensor(_operand_np(ps, bounds, fbar, P=P, NC=NC, R=R))
        t = t3
    want = 2.0 * (k.double() @ t.double())
    s = 2.0 * (k.double().abs() @ t.double().abs())
    err = (got.reshape(c * P, A).double() - want).abs()
    assert bool((err <= 2 * k.shape[1] * U * s).all()), float(err.max())


def _segment_ids_np(table, sig, seg_g0, w):
    """[S, w, P] row id of every (segment, site, replicate), from the
    module doc's formula."""
    n_sig = sig.shape[1]
    k = np.arange(w)
    j8 = seg_g0[:, None] + k[None, :] // PG - 1  # [S, w]
    j8 = np.where(j8 < 0, n_sig - 1, j8)
    grp = sig[:, j8]  # [P, S, w]
    return table[grp, k[None, None, :] % PG].transpose(1, 2, 0)


@pytest.mark.parametrize("R", WIDE)
def test_plain_onehot_prefix_sums_at_wide_rows(R):
    rng = np.random.default_rng(R)
    S, w, P, n_groups = 2, 256, 3, 24
    table = rng.integers(0, R + 1, size=(n_groups + 1, PG)).astype(np.int16)
    table[-1] = R
    sig = rng.integers(0, n_groups + 1, size=(P, n_groups)).astype(np.int32)
    sig = np.concatenate([sig, np.full((P, w // PG + 2), n_groups,
                                       np.int32)], 1)
    seg_g0 = np.array([0, 9], np.int32)
    got = tps.onehot_prefix_sums(torch.as_tensor(table),
                                 torch.as_tensor(sig),
                                 torch.as_tensor(seg_g0), w_seg_p=w,
                                 n_rows=R)
    ids = _segment_ids_np(table, sig, seg_g0, w)  # [S, w, P]
    want = np.cumsum(ids[..., None] == np.arange(R), 1).astype(np.int16)
    assert torch.equal(got, torch.as_tensor(want.reshape(S * w, P * R)))


def test_kernels_take_rows_up_to_r_max():
    """The wrappers' input check, which the card path runs, takes R up to
    R_MAX = 256 in multiples of 8 and no more."""
    P, NC, A = 1, 3, 8
    for R, ok in ((256, True), (216, True), (264, False), (212, False)):
        ps = torch.zeros((10, P * R), dtype=torch.int16)
        bounds = torch.zeros((1, 2, NC + 1), dtype=torch.int32)
        fbar = torch.zeros((1, 2, NC), dtype=torch.float32)
        pack = torch.zeros((2 * NC * R, 8), dtype=torch.bfloat16)
        try:
            W._check_kernel_inputs("window_clr", ps, bounds, fbar, pack,
                                   torch.bfloat16, 8, **_kw(P, NC, R, A))
            took = True
        except ValueError:
            took = False
        assert took == ok, R


# ---- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _card_case(dev, dtype, P, R, A, *, c, NC, seed):
    ps, bounds, fbar = _window_inputs(seed, dtype, rows=5000, c=c, NC=NC,
                                      P=P, R=R)
    t3 = torch.as_tensor(_pack(seed, 2 * NC * R, A), device=dev)
    args = [torch.as_tensor(x, device=dev) for x in (ps, bounds, fbar)]
    return args, t3, _kw(P, NC, R, A)


def _abs_sum(k, t):
    return 2.0 * (k.abs().double() @ t.abs().double())


# (dtype, P, R, A, c, NC): the scan's P = 1 at 128 alphas, permutation
# slices at 32 (c small: split over a cluster; c large: two waves)
CARD = [
    (np.int32, 1, 216, 128, 300, 61),
    (np.int16, 4, 216, 32, 7, 203),
    (np.int16, 16, 136, 32, 300, 61),
    (np.int32, 2, 256, 128, 50, 33),
    (np.float32, 3, 256, 32, 21, 101),
    (np.int16, 1, 136, 128, 70, 61),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, P, R, A, c, NC", CARD)
def test_wide_window_clr_kernel_matches_plain_on_card(dtype, P, R, A, c, NC):
    dev = _card()
    args, t3, kw = _card_case(dev, dtype, P, R, A, c=c, NC=NC, seed=R + c)
    pack = W.bf16_pack(t3)
    before = W.window_clr_launches, W.window_clr_wide_launches
    got = W.window_clr(*args, pack, **kw)
    want = W.window_clr_plain(*args, pack, **kw)
    torch.cuda.synchronize()
    assert (W.window_clr_launches, W.window_clr_wide_launches) == (
        before[0] + 1, before[1] + 1)
    k = G.window_operand_plain(*args, n_rep=P, n_cells=NC, n_rows=R,
                               mm_bf16=True)
    s = _abs_sum(k, _bf16(t3).to(dev)).reshape(got.shape)
    err = (got.double() - want.double()).abs()
    assert bool((err <= 2e-4 * s + 1e-5).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, P, R, A, c, NC", CARD)
def test_wide_window_clr_f32_kernel_matches_plain_on_card(dtype, P, R, A, c,
                                                          NC):
    dev = _card()
    args, t3, kw = _card_case(dev, dtype, P, R, A, c=c, NC=NC, seed=R + c)
    pack = W.f32_pack(t3)
    before = W.window_clr_f32_launches, W.window_clr_f32_wide_launches
    got = W.window_clr_f32(*args, pack, **kw)
    want = W.window_clr_f32_plain(*args, pack, **kw)
    torch.cuda.synchronize()
    assert (W.window_clr_f32_launches, W.window_clr_f32_wide_launches) == (
        before[0] + 1, before[1] + 1)
    k = G.window_operand_plain(*args, n_rep=P, n_cells=NC, n_rows=R,
                               mm_bf16=False)
    s = _abs_sum(k, t3).reshape(got.shape)
    err = (got.double() - want.double()).abs()
    assert bool((err <= 1e-5 * s + 1e-5).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("R", WIDE)
def test_wide_window_clr_splits_and_keeps_entry_bits_on_card(R):
    """A permutation tail's launch (7 positions, a slice of 4 replicates,
    32 alphas, about 200 cells) splits over a cluster; every entry's bits
    are those of its candidate launched alone (split its own way)."""
    dev = _card()
    P, A, c, NC = 4, 32, 7, 203
    args, t3, kw = _card_case(dev, np.int16, P, R, A, c=c, NC=NC, seed=R)
    pack = W.bf16_pack(t3)
    assert W.window_clr_splits(c * P, n_cells=NC, n_rows=R, n_alpha=A,
                               device=dev) > 1
    before = W.window_clr_split_launches
    full = W.window_clr(*args, pack, **kw)
    assert W.window_clr_split_launches == before + 1
    ps, bounds, fbar = args
    for ci in range(c):
        one = W.window_clr(ps, bounds[ci:ci + 1], fbar[ci:ci + 1], pack,
                           **kw)
        assert torch.equal(one.view(torch.int32),
                           full[ci:ci + 1].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("R, A", [(216, 32), (136, 128), (256, 32)])
def test_wide_window_clr_operand_is_window_operand_bitwise_on_card(R, A):
    """A pack whose column a is one-hot at row k_a gives 2 k[m, k_a]
    exactly: the wide kernel's operand, both steps of a cell, read back."""
    dev = _card()
    P, NC, c = 2, 41, 30
    args, _, _ = _card_case(dev, np.int32, P, R, 8, c=c, NC=NC, seed=7)
    K = 2 * NC * R
    half = 8 * ((R // 8 + 1) // 2)
    rng = np.random.default_rng(R)
    # both ends of each step's lanes, on both sides, and random ones
    k_a = np.unique(np.concatenate([
        [0, half - 1, half, R - 1, NC * R, NC * R + half, K - 1,
         17 * R + half - 1], rng.integers(0, K, A - 8)]))[:A]
    eye = torch.zeros((K, len(k_a)), dtype=torch.float32, device=dev)
    eye[torch.as_tensor(k_a, device=dev),
        torch.arange(len(k_a), device=dev)] = 1.0
    got = W.window_clr(*args, W.bf16_pack(eye), n_rep=P, n_cells=NC,
                       n_rows=R, n_alpha=len(k_a))
    k = G.window_operand_plain(*args, n_rep=P, n_cells=NC, n_rows=R,
                               mm_bf16=True)
    torch.cuda.synchronize()
    want = 2.0 * k[:, torch.as_tensor(k_a, device=dev)]
    assert torch.equal(got.reshape(-1, len(k_a)), want)


@pytest.mark.gpu
def test_onehot_prefix_sums_kernel_at_216_rows_on_card():
    """The 1b kernel at the tail's lanes, 32 replicates of 216 rows (6,912
    lanes), bitwise its plain version."""
    dev = _card()
    rng = np.random.default_rng(216)
    R, S, w, P, n_groups = 216, 2, 4096, 32, 300
    table = rng.integers(0, R + 1, size=(n_groups + 1, PG)).astype(np.int16)
    table[-1] = R
    sig = rng.integers(0, n_groups + 1, size=(P, n_groups)).astype(np.int32)
    sig = np.concatenate([sig, np.full((P, w // PG + 2), n_groups,
                                       np.int32)], 1)
    seg_g0 = np.array([0, 150], np.int32)
    t = [torch.as_tensor(x, device=dev) for x in (table, sig, seg_g0)]
    got = tps.onehot_prefix_sums(*t, w_seg_p=w, n_rows=R)
    want = tps.onehot_prefix_sums_plain(*t, w_seg_p=w, n_rows=R)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_site_prefix_at_216_rows_on_card():
    """RDP's site prefix (the row-id kernel, one replicate) at 216 rows,
    with sentinel ids, bitwise the plain cumsum."""
    from fscl_tpu_torch.ops.histclr import build_site_prefix

    dev = _card()
    rng = np.random.default_rng(5)
    row = torch.as_tensor(rng.integers(0, 217, 100_003).astype(np.int32))
    got = build_site_prefix(row.to(dev), n_rows=216)
    want = build_site_prefix(row, n_rows=216)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
