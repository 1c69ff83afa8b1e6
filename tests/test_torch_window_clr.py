"""The fused window contraction (fscl_tpu_torch/ops/window_clr.py): the
bfloat16 route of the hist statistic against the JAX package.

  * window_clr_plain against fscl_tpu.ops.histclr.hist_clr_reps_ps with
    mm_bf16=True on seeded numpy inputs (int16 prefixes wrapped past
    +-32767, int32 and float32 prefixes; P in {1, 4}; A in {8, 32}; NC
    odd).  The bfloat16 operands are equal bit for bit (read back through
    a one-hot pack, whose products are exact), and a product of two
    bfloat16 values is exact in float32, so only the order of the float32
    sums differs: each entry is held to 2 K 2^-24 S, S = 2 sum_k |k t|
    (two summation orders of the same K exact products each stay within
    (K - 1) 2^-24 S of the exact sum);
  * the plain version is the two-step chain it replaces, bitwise, in one
    candidate chunk or several;
  * routing on the CPU: one call per hist_clr_reps_ps call, window_clr
    at mm_bf16=True and window_clr_f32 at False, never window_operand;
  * on the card (marker ``gpu``): the kernel against its plain version at
    the main path's shapes, within 2e-4 S + 1e-5 per entry, and a one-hot
    pack that reads the kernel's operand back bitwise against
    window_operand(mm_bf16=True), at a launch split over cells;
  * on the card, the split over cells: at the permutation tail's launch
    shapes the kernel splits and agrees with plain; an entry's bits are
    the same launched alone, at every split count the C entry takes and
    in repeat launches; a grid of two waves, and tiles of 128 columns, do
    not split.

This file imports nothing of tests/: on the card machine such imports do
not collect.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fscl_tpu.ops.histclr as JH
import fscl_tpu_torch.ops.histclr as TH
from fscl_tpu_torch.ops import gather as G
from fscl_tpu_torch.ops import window_clr as W

U = 2.0 ** -24  # float32 unit roundoff


def _window_inputs(seed, dtype, *, rows=300, c=7, NC=9, P=3, R=8):
    """Prefix rows, bounds and fbar like the path's: side 0 walks left
    from the split point, side 1 right, with empty windows (repeated
    bounds) and fbar 0.5 on them.  int16 prefixes carry an offset that
    wraps them past +-32767, as the stacked slab's one-group-early start
    does; only their differences are meaningful."""
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
    return ps, bounds, fbar


def _pack(seed, K, A):
    """A [K, A] f32 pack of log-likelihood-difference scale."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(K, A)) * 3.0).astype(np.float32)


def _bf16(x):
    return torch.as_tensor(x).to(torch.bfloat16).to(torch.float32)


def _abs_sum(k, t3):
    """S = 2 sum_k |k t| per output entry, in float64: [c*P, A]."""
    return 2.0 * (k.abs().double() @ _bf16(t3).abs().double())


def _kw(P, NC, R, A):
    return dict(n_rep=P, n_cells=NC, n_rows=R, n_alpha=A)


# ---- CPU: the plain version against the JAX package ------------------------

@pytest.mark.parametrize("A", [8, 32])
@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float32])
def test_window_clr_plain_matches_jax(dtype, P, A):
    NC, R = 9, 8
    ps, bounds, fbar = _window_inputs(P + A, dtype, P=P, R=R, NC=NC)
    if dtype == np.int16:  # the wrap is exercised
        assert ps.min() < -30000 and ps.max() > 30000
    K = 2 * NC * R
    t3 = _pack(A, K, A)
    kw = _kw(P, NC, R, A)
    want = np.asarray(JH.hist_clr_reps_ps(
        jnp.asarray(t3), jnp.asarray(bounds), jnp.asarray(fbar),
        jnp.asarray(ps), mm_bf16=True, **kw))  # [P, C, A]
    args = [torch.as_tensor(x) for x in (ps, bounds, fbar)]
    before = W.window_clr_launches
    got = W.window_clr(*args, W.bf16_pack(torch.as_tensor(t3)), **kw)
    assert W.window_clr_launches == before  # plain version on the CPU
    assert got.shape == (bounds.shape[0], P, A) and got.dtype == torch.float32
    got = got.permute(1, 0, 2).numpy()
    k = G.window_operand_plain(*args, n_rep=P, n_cells=NC, n_rows=R,
                               mm_bf16=True)
    s = _abs_sum(k, t3).numpy().reshape(bounds.shape[0], P, A)
    tol = 2 * K * U * s.transpose(1, 0, 2)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()

    # the bfloat16 operands are the JAX package's, bit for bit: a one-hot
    # pack reads 2 k back exactly from both
    eye = np.eye(K, dtype=np.float32)
    op_j = np.asarray(JH.hist_clr_reps_ps(
        jnp.asarray(eye), jnp.asarray(bounds), jnp.asarray(fbar),
        jnp.asarray(ps), mm_bf16=True, **_kw(P, NC, R, K)))
    op_t = (2.0 * k).numpy().reshape(bounds.shape[0], P, K)
    np.testing.assert_array_equal(op_j.transpose(1, 0, 2) + 0.0, op_t + 0.0)


@pytest.mark.parametrize("per_chunk", [None, 2])
def test_window_clr_plain_is_the_two_step_chain(monkeypatch, per_chunk):
    P, NC, R, A = 3, 9, 16, 40
    ps, bounds, fbar = _window_inputs(5, np.int32, P=P, R=R, NC=NC)
    t3 = torch.as_tensor(_pack(6, 2 * NC * R, A))
    args = [torch.as_tensor(x) for x in (ps, bounds, fbar)]
    if per_chunk:  # several candidate chunks and a ragged last one
        monkeypatch.setattr(W, "OPERAND_BYTES",
                            per_chunk * 2 * NC * R * P * 4)
    got = W.window_clr_plain(*args, W.bf16_pack(t3), **_kw(P, NC, R, A))
    k = G.window_operand_plain(*args, n_rep=P, n_cells=NC, n_rows=R,
                               mm_bf16=True)
    want = 2.0 * torch.matmul(k, G.bf16_round(t3))
    np.testing.assert_array_equal(got.reshape(-1, A).numpy(), want.numpy())


def test_bf16_pack_pads_rounds_and_is_built_once():
    t3 = torch.as_tensor(_pack(7, 48, 13))
    pack = W.bf16_pack(t3)
    assert pack.dtype == torch.bfloat16 and pack.shape == (48, 16)
    assert torch.equal(pack[:, :13].float(), G.bf16_round(t3))
    assert not pack[:, 13:].any()
    assert W.bf16_pack(t3) is pack
    t3.mul_(2.0)  # a changed pack is rounded again
    again = W.bf16_pack(t3)
    assert again is not pack
    assert torch.equal(again[:, :13].float(), G.bf16_round(t3))


def test_window_clr_refuses_other_devices():
    t = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        W.window_clr(t, None, None, None, n_rep=1, n_cells=1, n_rows=8,
                     n_alpha=4)


# ---- CPU: routing ----------------------------------------------------------

def _spy(monkeypatch, name, calls):
    real = getattr(TH, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(TH, name, spy)


@pytest.mark.parametrize("mm_bf16", [False, True])
def test_routes_by_mm_bf16(monkeypatch, mm_bf16):
    """One fused call per hist_clr_reps_ps call, whatever the candidate
    count: mm_bf16=True reaches window_clr, False window_clr_f32; neither
    writes the operand through window_operand."""
    P, NC, R, A = 2, 9, 8, 8
    ps, bounds, fbar = _window_inputs(8, np.int16, P=P, R=R, NC=NC, c=7)
    t3 = torch.as_tensor(_pack(9, 2 * NC * R, A))
    args = [torch.as_tensor(x) for x in (ps, bounds, fbar)]
    calls = []
    for name in ("window_clr", "window_clr_f32", "window_clr_plain",
                 "window_clr_f32_plain"):
        _spy(monkeypatch, name, calls)
    monkeypatch.setattr(G, "window_operand",
                        lambda *a, **k: calls.append("window_operand"))
    monkeypatch.setattr(TH, "CHUNK_BYTES", 3 * 2 * (NC + 1) * P * R * 4)
    assert TH._chunk_rows(NC, P, R) == 3  # rdp_clr_reps' chunk, not this
    kw = dict(n_rep=P, n_cells=NC, n_rows=R, n_alpha=A, mm_bf16=mm_bf16)
    out = TH.hist_clr_reps_ps(t3, args[1], args[2], args[0], **kw)
    assert out.shape == (P, 7, A)
    assert calls == (["window_clr"] if mm_bf16 else ["window_clr_f32"])
    calls.clear()
    plain = TH.hist_clr_reps_ps(t3, args[1], args[2], args[0],
                                clr_fn=TH._clr_from_windows_plain, **kw)
    assert calls == (["window_clr_plain"] if mm_bf16
                     else ["window_clr_f32_plain"])
    assert torch.equal(out, plain)


# ---- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _card_case(dev, dtype, P, R, A, *, c=300, NC=61, seed=11, pad=0):
    """Inputs on the card at the path's widths, pad all-zero padding
    candidates (bounds 0, fbar 0) appended."""
    ps, bounds, fbar = _window_inputs(seed, dtype, rows=5000, c=c, NC=NC,
                                      P=P, R=R)
    if pad:
        bounds = np.concatenate([bounds, np.zeros((pad, 2, NC + 1),
                                                  np.int32)])
        fbar = np.concatenate([fbar, np.zeros((pad, 2, NC), np.float32)])
    t3 = torch.as_tensor(_pack(seed, 2 * NC * R, A), device=dev)
    args = [torch.as_tensor(x, device=dev) for x in (ps, bounds, fbar)]
    return args, t3, _kw(P, NC, R, A)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, P, R, A, c, pad", [
    (np.int16, 1, 56, 128, 300, 0),  # the scan (P = 1, 128 alphas)
    (np.int16, 32, 56, 32, 300, 0),  # a stacked 20k slice
    (np.int32, 16, 48, 32, 300, 0),  # genome
    (np.float32, 32, 32, 32, 300, 0),  # compressed mixed depth
    (np.int16, 1, 56, 40, 37, 5),  # c off the 64-row tile, A = 40, padding
    (np.float32, 3, 104, 200, 50, 3),  # R > 64, A over two column tiles
])
def test_window_clr_kernel_matches_plain_on_card(dtype, P, R, A, c, pad):
    dev = _card()
    args, t3, kw = _card_case(dev, dtype, P, R, A, c=c, pad=pad)
    pack = W.bf16_pack(t3)
    before = W.window_clr_launches
    got = W.window_clr(*args, pack, **kw)
    want = W.window_clr_plain(*args, pack, **kw)
    torch.cuda.synchronize()
    assert W.window_clr_launches == before + 1
    k = G.window_operand_plain(*args, n_rep=P, n_cells=kw["n_cells"],
                               n_rows=R, mm_bf16=True)
    s = _abs_sum(k, t3).reshape(got.shape)
    err = (got.double() - want.double()).abs()
    assert bool((err <= 2e-4 * s + 1e-5).all()), float(err.max())
    if pad:  # all-zero padding candidates give exactly 0
        assert not got[-pad:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float32])
def test_window_clr_kernel_operand_is_window_operand_bitwise(dtype):
    """A pack whose column a is one-hot at row k_a gives 2 k[m, k_a]
    exactly: the kernel's operand, read back."""
    dev = _card()
    P, R, NC = 4, 56, 61
    args, _, _ = _card_case(dev, dtype, P, R, 8, c=70, NC=NC)
    assert W.window_clr_splits(70 * P, n_cells=NC, n_rows=R, n_alpha=32,
                               device=dev) > 1
    K = 2 * NC * R
    # first and last k of both operand halves, a lane past R16's boundary
    # and random ones; int16 prefixes are wrapped on every lane
    rng = np.random.default_rng(12)
    k_a = np.unique(np.concatenate([
        [0, R - 1, NC * R, NC * R + 55, K - 1, 17 * R + 40],
        rng.integers(0, K, 26)]))
    A = len(k_a)
    eye = torch.zeros((K, A), dtype=torch.float32, device=dev)
    eye[torch.as_tensor(k_a, device=dev), torch.arange(A, device=dev)] = 1.0
    got = W.window_clr(*args, W.bf16_pack(eye), n_rep=P, n_cells=NC,
                       n_rows=R, n_alpha=A)
    k = G.window_operand(*args, n_rep=P, n_cells=NC, n_rows=R, mm_bf16=True)
    torch.cuda.synchronize()
    want = 2.0 * k[:, torch.as_tensor(k_a, device=dev)]
    assert torch.equal(got.reshape(-1, A), want)


# the permutation tail's launches: a stack of 1-3 chromosomes' 7 positions
# each, a 32-replicate slice of depth-48 prefix rows, 32 alphas, about 200
# cells (NC odd: the last run of cells is short)
TAIL = dict(P=32, R=48, A=32, NC=203)


def _tail_case(dev, c, seed):
    args, t3, kw = _card_case(dev, np.int16, TAIL["P"], TAIL["R"],
                              TAIL["A"], c=c, NC=TAIL["NC"], seed=seed)
    return args, W.bf16_pack(t3), t3, kw


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [7, 21])
def test_window_clr_kernel_splits_at_the_tail_shapes_on_card(c):
    dev = _card()
    args, pack, t3, kw = _tail_case(dev, c, seed=15 + c)
    splits = W.window_clr_splits(c * TAIL["P"], n_cells=TAIL["NC"],
                                 n_rows=TAIL["R"], n_alpha=TAIL["A"],
                                 device=dev)
    assert 1 < splits <= 8
    before = W.window_clr_launches, W.window_clr_split_launches
    got = W.window_clr(*args, pack, **kw)
    want = W.window_clr_plain(*args, pack, **kw)
    torch.cuda.synchronize()
    assert (W.window_clr_launches, W.window_clr_split_launches) == (
        before[0] + 1, before[1] + 1)
    k = G.window_operand_plain(*args, n_rep=TAIL["P"], n_cells=TAIL["NC"],
                               n_rows=TAIL["R"], mm_bf16=True)
    s = _abs_sum(k, t3).reshape(got.shape)
    err = (got.double() - want.double()).abs()
    assert bool((err <= 2e-4 * s + 1e-5).all()), float(err.max())


@pytest.mark.gpu
def test_window_clr_entry_bits_do_not_depend_on_the_launch_on_card():
    """The full launch, the same at split counts the C entry takes at this
    shape (1 to 8, the portable cluster sizes), and candidates launched
    alone (one block, split their own way): bit for bit."""
    dev = _card()
    args, pack, _, kw = _tail_case(dev, 21, seed=40)
    from chip_smoke import _window_clr_at  # the C entry, split as asked

    full = W.window_clr(*args, pack, **kw)
    for splits in range(1, 9):
        got = _window_clr_at(*args, pack, splits=splits, **kw)
        torch.testing.assert_close(_bits(got), _bits(full), rtol=0, atol=0)
    ps, bounds, fbar = args
    for ci in (0, 9, 20):
        one = W.window_clr(ps, bounds[ci:ci + 1], fbar[ci:ci + 1], pack,
                           **kw)
        torch.testing.assert_close(_bits(one), _bits(full[ci:ci + 1]),
                                   rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [21, 300])
def test_window_clr_repeat_launches_are_bitwise_equal_on_card(c):
    dev = _card()
    args, pack, _, kw = _tail_case(dev, c, seed=41)
    a = W.window_clr(*args, pack, **kw)
    b = W.window_clr(*args, pack, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.gpu
@pytest.mark.parametrize("c, A", [(1200, 32), (21, 128)])
def test_window_clr_does_not_split_on_card(c, A):
    """1,200 candidates x 32 replicates: 600 blocks, over two waves of
    132 SMs at two blocks each; 21 candidates at 128 alphas: tiles of 128
    columns, which keep one chain over the cells.  Neither splits; their
    entries are still those of candidates launched alone."""
    dev = _card()
    args, t3, kw = _card_case(dev, np.int16, TAIL["P"], TAIL["R"], A, c=c,
                              NC=TAIL["NC"], seed=42)
    pack = W.bf16_pack(t3)
    assert W.window_clr_splits(c * TAIL["P"], n_cells=TAIL["NC"],
                               n_rows=TAIL["R"], n_alpha=A,
                               device=dev) == 1
    before = W.window_clr_launches, W.window_clr_split_launches
    full = W.window_clr(*args, pack, **kw)
    assert (W.window_clr_launches, W.window_clr_split_launches) == (
        before[0] + 1, before[1])
    ps, bounds, fbar = args
    for ci in (0, c // 2, c - 1):
        one = W.window_clr(ps, bounds[ci:ci + 1], fbar[ci:ci + 1], pack,
                           **kw)
        assert torch.equal(_bits(one), _bits(full[ci:ci + 1]))
