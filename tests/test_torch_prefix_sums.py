"""Segmented prefix sums: the port against the JAX package.

The port fuses _stack_stat's gather -> expand -> build_prefix_sums_seg
into one function (fscl_tpu_torch/ops/prefix_sums.py).  The same numpy
table, sigma and seg_g0 go through the JAX steps (the Pallas kernel in
interpret mode, and the XLA fallback build_prefix_sums_seg) and through
the port's plain version.  Stated tolerances:
  * one-hot counts: bitwise equality (integers);
  * weight channels (compressed mode (c), f32): within 32 float32 ulps
    (3.8e-6) of each segment's max |prefix|, per replicate and channel.
    The port sums in float64 and rounds once; the Pallas kernel sums each
    512-site tile as float32 tril-matmul dot products of up to 512 terms
    and carries a two-limb compensated float32 pair, and the XLA fallback
    is a pairwise float32 scan.  Measured on these inputs: 10.5 ulps
    (Pallas) and 3.4 ulps (XLA);
  * on the card: the CUDA kernels against their plain versions, one-hot
    bitwise, weights within 2 float32 ulps of each segment's max |prefix|
    (both sum in float64; the order differs), and repeated launches
    bitwise equal to the first, at the main path's shapes and at shapes
    that stress the kernels' chained scan.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fscl_tpu.ops.histclr import (
    build_prefix_sums_seg,
    make_row_weight_group_table,
)
from fscl_tpu.engine.permute import _perm_ps
from fscl_tpu.ops.pallas_ps import onehot_prefix_sums as pallas_ps
from fscl_tpu_torch.ops import prefix_sums as tps

PG = 32


def _inputs(seed, S, w, P, R, n_groups=96):
    """Row-id table (ids in [0, R], R = absent), a sentinel-padded sigma
    and segment starts that include group 0 (negative slab index)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, R + 1, size=(n_groups + 1, PG)).astype(np.int16)
    table[-1] = R  # sentinel row
    margin = w // PG + 2
    sig = rng.integers(0, n_groups + 1, size=(P, n_groups)).astype(np.int32)
    sig = np.concatenate(
        [sig, np.full((P, margin), n_groups, np.int32)], axis=1
    )
    seg_g0 = np.sort(rng.choice(n_groups, size=S, replace=False))
    seg_g0[0] = 0
    return table, sig, seg_g0.astype(np.int32)


def _jax_onehot(table, sig, seg_g0, w, R):
    """_stack_stat's thin gather + expand (fscl_tpu/engine/permute.py:
    803-827) on shared inputs: [S*w, P*R] int8."""
    S, P, n_sig = len(seg_g0), sig.shape[0], sig.shape[1]
    idx8 = jnp.asarray(seg_g0)[:, None] + jnp.arange(w // PG)[None, :] - 1
    idx8 = jnp.where(idx8 < 0, n_sig - 1, idx8)
    sel = jnp.asarray(sig).T[idx8]
    gi = jnp.asarray(table)[sel].transpose(0, 1, 3, 2).reshape(S, w, P)
    oh = (gi[..., None] == jnp.arange(R, dtype=gi.dtype)).astype(jnp.int8)
    return oh.reshape(S * w, P * R)


def _port(table, sig, seg_g0, w, R, out_dtype=None):
    return tps.onehot_prefix_sums(
        torch.as_tensor(table), torch.as_tensor(sig),
        torch.as_tensor(seg_g0), w_seg_p=w, n_rows=R, out_dtype=out_dtype,
    ).numpy()


@pytest.mark.parametrize("out", ["int16", "int32"])
def test_matches_pallas_kernel_interpret(out):
    S, w, P, R = 3, 1024, 16, 8  # Pallas layout: w % 512, P*R % 128
    table, sig, seg_g0 = _inputs(1, S, w, P, R)
    oh = _jax_onehot(table, sig, seg_g0, w, R)
    want = np.asarray(pallas_ps(
        oh, out_dtype=getattr(jnp, out), reset_every=w, interpret=True,
    ))
    got = _port(table, sig, seg_g0, w, R, out_dtype=getattr(torch, out))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w, dtype", [(4096, np.int16), (33792, np.int32)])
def test_matches_build_prefix_sums_seg(w, dtype):
    """Default output type follows build_prefix_sums_seg: int16 up to
    32767 sites per segment, int32 above."""
    S, P, R = 2, 3, 5
    table, sig, seg_g0 = _inputs(2, S, w, P, R, n_groups=2 * w // PG)
    want = np.asarray(build_prefix_sums_seg(
        _jax_onehot(table, sig, seg_g0, w, R), seg_len=w,
    ))
    got = _port(table, sig, seg_g0, w, R)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


def test_sentinels_count_nowhere():
    """Id R (absent row / pad) and the sentinel column add no counts."""
    S, w, P, R = 2, 256, 4, 6
    table, sig, seg_g0 = _inputs(3, S, w, P, R)
    table[:] = R
    got = _port(table, sig, seg_g0, w, R)
    assert not got.any()


def test_cpu_wrapper_runs_plain_version():
    S, w, P, R = 2, 512, 4, 8
    table, sig, seg_g0 = _inputs(4, S, w, P, R)
    before = tps.launches
    got = _port(table, sig, seg_g0, w, R)
    plain = tps.onehot_prefix_sums_plain(
        torch.as_tensor(table), torch.as_tensor(sig),
        torch.as_tensor(seg_g0), w_seg_p=w, n_rows=R,
    ).numpy()
    np.testing.assert_array_equal(got, plain)
    assert tps.launches == before  # no kernel launch for CPU tensors


# Shapes that stress the chained scan of the CUDA kernels (one-hot:
# 512-site tiles, 64 lanes a block; weighted: 1024-site tiles, 32 lanes a
# block): w off the tile (a partial last tile), one tile, 24 segments of
# many tiles, L = P*R off the lane block and odd (lane-by-lane stores),
# the largest L.  n_launch launches in a row must all give the first
# one's bits.
@pytest.mark.gpu
@pytest.mark.parametrize("S, w, P, R, dtype, n_launch", [
    (1, 20480, 16, 56, torch.int16, 1),
    (4, 36864, 16, 56, torch.int32, 1),
    (3, 2656, 8, 45, torch.int16, 1),  # w off the tile
    (2, 256, 32, 56, torch.int16, 1),  # one tile
    (24, 6368, 5, 37, torch.int16, 1),  # 24 segments, odd L = 185
    (2, 4128, 64, 128, torch.int16, 1),  # L = 8192, P = 64
    (1, 33024, 64, 128, torch.int32, 1),  # L = 8192, int32
    (1, 20480, 32, 56, torch.int16, 20),  # repeated launches
])
def test_kernel_matches_plain_on_card(S, w, P, R, dtype, n_launch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernel runs only on the card")
    table, sig, seg_g0 = _inputs(5, S, w, P, R, n_groups=S * w // PG)
    args = [torch.as_tensor(x, device="cuda") for x in (table, sig, seg_g0)]
    before = tps.launches
    got = tps.onehot_prefix_sums(*args, w_seg_p=w, n_rows=R)
    want = tps.onehot_prefix_sums_plain(*args, w_seg_p=w, n_rows=R)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    for _ in range(n_launch - 1):
        again = tps.onehot_prefix_sums(*args, w_seg_p=w, n_rows=R)
        assert torch.equal(got, again)
    assert tps.launches == before + n_launch


# ---- compressed mode (c): sums of weight channels -------------------------

def _weights(seed, n_ids, R):
    """[n_ids, R] f32 weight table like the compressed tables': centred
    channels of mixed scale, a count channel of ones, zero padding
    channels, and the all-zero sentinel row last."""
    rng = np.random.default_rng(seed)
    wt = rng.normal(size=(n_ids, R)) * np.geomspace(300.0, 0.1, R)
    wt[:, R - 3] = 1.0
    wt[:, R - 2:] = 0.0
    wt[-1] = 0.0
    return wt.astype(np.float32)


def _weighted_inputs(seed, S, w, P, R, n_ids, n_groups=96):
    table, sig, seg_g0 = _inputs(seed, S, w, P, n_ids - 1, n_groups)
    return table, _weights(seed + 100, n_ids, R), sig, seg_g0


def _jax_weight_stream(table, weights, sig, seg_g0, w):
    """_stack_stat's fat branch (fscl_tpu/engine/permute.py:822-827) on
    the fat table of make_row_weight_group_table: [S*w, P*R] f32."""
    S, P, n_sig = len(seg_g0), sig.shape[0], sig.shape[1]
    R = weights.shape[1]
    ids = jnp.asarray(table[:-1].reshape(-1).astype(np.int32))
    fat = make_row_weight_group_table(ids, jnp.asarray(weights))
    idx8 = jnp.asarray(seg_g0)[:, None] + jnp.arange(w // PG)[None, :] - 1
    idx8 = jnp.where(idx8 < 0, n_sig - 1, idx8)
    oh = fat[jnp.asarray(sig).T[idx8]]  # [S, G_loc, P, PG*R]
    oh = oh.reshape(S, w // PG, P, PG, R).transpose(0, 1, 3, 2, 4)
    return oh.reshape(S * w, P * R)


def _seg_scale(ps, S):
    """Per (segment, lane) max |prefix|, broadcast back to ps's shape."""
    a = np.abs(ps.reshape(S, -1, ps.shape[1])).max(axis=1, keepdims=True)
    return np.broadcast_to(a, (S, ps.shape[0] // S, ps.shape[1])).reshape(
        ps.shape)


def _port_w(table, weights, sig, seg_g0, w):
    return tps.weighted_prefix_sums(
        torch.as_tensor(table), torch.as_tensor(weights),
        torch.as_tensor(sig), torch.as_tensor(seg_g0), w_seg_p=w,
    ).numpy()


@pytest.mark.parametrize("S, w, P, R, n_ids", [
    (3, 1024, 4, 32, 300),   # Pallas layout: w % 512, P*R % 128
    (2, 2048, 2, 64, 1590),  # mixed-depth headline row count
])
def test_weighted_matches_pallas_mode_c_interpret(S, w, P, R, n_ids):
    table, wt, sig, seg_g0 = _weighted_inputs(6, S, w, P, R, n_ids)
    stream = _jax_weight_stream(table, wt, sig, seg_g0, w)
    want = np.asarray(pallas_ps(stream, out_dtype=jnp.float32,
                                reset_every=w, interpret=True))
    got = _port_w(table, wt, sig, seg_g0, w)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (S * w, P * R)
    tol = 32 * np.finfo(np.float32).eps
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= tol * _seg_scale(want, S)).all(), (
        err / np.maximum(_seg_scale(want, S), 1e-30)).max()
    # the XLA fallback (pairwise float32 scan) agrees to the same bound
    xla = np.asarray(build_prefix_sums_seg(stream, seg_len=w))
    assert (np.abs(got.astype(np.float64) - xla)
            <= tol * _seg_scale(xla, S)).all()


def test_weighted_plain_is_float64_sum_rounded_once():
    S, w, P, R, n_ids = 2, 512, 3, 16, 50
    table, wt, sig, seg_g0 = _weighted_inputs(7, S, w, P, R, n_ids)
    ids = tps.segment_row_ids(torch.as_tensor(table), torch.as_tensor(sig),
                              torch.as_tensor(seg_g0), w_seg_p=w).numpy()
    want = np.cumsum(wt.astype(np.float64)[ids], axis=1).astype(np.float32)
    got = _port_w(table, wt, sig, seg_g0, w)
    np.testing.assert_array_equal(got, want.reshape(S * w, P * R))


def test_weighted_sentinel_reads_zero_row():
    """The sentinel id (last weight row) and the sentinel column add 0."""
    S, w, P, R, n_ids = 2, 256, 4, 8, 20
    table, wt, sig, seg_g0 = _weighted_inputs(8, S, w, P, R, n_ids)
    table[:] = n_ids - 1
    before = tps.weighted_launches
    got = _port_w(table, wt, sig, seg_g0, w)
    assert not got.any()
    assert tps.weighted_launches == before  # plain version on the CPU


@pytest.mark.gpu
@pytest.mark.parametrize("S, w, P, R, n_ids, n_launch", [
    (4, 24576, 32, 32, 1590, 2),  # mixed-depth headline permutation shape
    (1, 36864, 16, 104, 8193, 2),  # widest channel count, largest table
    (3, 2656, 8, 33, 700, 2),  # w off the tile, odd R
    (2, 256, 32, 32, 1590, 2),  # one tile
    (24, 6368, 5, 37, 300, 2),  # 24 segments, odd L = 185
    (1, 4128, 64, 104, 8193, 2),  # P = 64, L = 6656
    (4, 24576, 32, 32, 1590, 20),  # repeated launches
])
def test_weighted_kernel_matches_plain_on_card(S, w, P, R, n_ids, n_launch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernel runs only on the card")
    table, wt, sig, seg_g0 = _weighted_inputs(
        9, S, w, P, R, n_ids, n_groups=S * w // PG)
    args = [torch.as_tensor(x, device="cuda")
            for x in (table, wt, sig, seg_g0)]
    before = tps.weighted_launches
    got = tps.weighted_prefix_sums(*args, w_seg_p=w)
    for _ in range(n_launch - 1):
        again = tps.weighted_prefix_sums(*args, w_seg_p=w)
        # no atomics, no timing-dependent order: same bits every run
        assert torch.equal(got, again)
    want = tps.weighted_prefix_sums_plain(*args, w_seg_p=w)
    torch.cuda.synchronize()
    assert tps.weighted_launches == before + n_launch
    assert got.dtype == want.dtype == torch.float32
    scale = want.reshape(S, w, -1).abs().amax(1, keepdim=True)
    ulp = torch.finfo(torch.float32).eps * scale
    err = (got - want).abs().reshape(S, w, -1)
    assert bool((err <= 2 * ulp).all()), float((err / ulp).max())


# ---- unsegmented row-id modes (a) and (b') ---------------------------------
#
# Stated tolerance: bitwise (integer counts, cast to int16 or int32 as
# the JAX package casts them).  The Pallas kernel runs in interpret mode
# on the Pallas layout (W a multiple of 512, lanes a multiple of 128) and
# has no zero first row; the JAX prefix functions (build_prefix_sums,
# _perm_ps) run their XLA versions on the CPU.

def _row_rep(seed, P, W, R):
    """[P, W] int32 row ids in [0, R + 2]: ids R.. count nowhere."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, R + 3, size=(P, W)).astype(np.int32)


def _aliased_row_rep(seed, P, W, R):
    """_row_rep with a fifth of the ids moved to ids that count nowhere
    but alias a row when cast to int16 (r + 65536, r - 65536), or are
    negative (-1, the int32 minimum)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, R + 3, size=(P, W)).astype(np.int64)
    pick = rng.random((P, W)) < 0.2
    moved = np.stack([ids + 65536, ids - 65536, np.full_like(ids, -1),
                      np.full_like(ids, -2**31)])
    ids = np.where(pick, moved[rng.integers(0, 4, (P, W)),
                               np.arange(P)[:, None], np.arange(W)], ids)
    return ids.astype(np.int32)


@pytest.mark.parametrize("out", ["int16", "int32"])
def test_rowid_plain_matches_pallas_mode_a_interpret(out):
    P, W, R = 16, 1024, 8  # lanes 128
    row_rep = _row_rep(10, P, W, R)
    rows_exp = jnp.repeat(jnp.asarray(row_rep).T, R, axis=1)  # [W, P*R]
    want = np.asarray(pallas_ps(rows_exp, n_rows=R, out_dtype=getattr(
        jnp, out), interpret=True))
    got = tps.rowid_prefix_sums(torch.as_tensor(row_rep), n_rows=R,
                                out_dtype=getattr(torch, out)).numpy()
    assert got.dtype == want.dtype and got.shape == (W + 1, P * R)
    assert not got[0].any()
    np.testing.assert_array_equal(got[1:], want)


@pytest.mark.parametrize("P, W, R, dtype", [
    (3, 1000, 7, np.int16),  # no Pallas layout: any W, any lane count
    (2, 33000, 5, np.int32),  # W > 32767 switches to int32
])
def test_rowid_plain_matches_build_prefix_sums(P, W, R, dtype):
    from fscl_tpu.ops.histclr import build_prefix_sums

    row_rep = _row_rep(11, P, W, R)
    want = np.asarray(build_prefix_sums(jnp.asarray(row_rep), n_rows=R))
    before = tps.rowid_launches
    got = tps.rowid_prefix_sums(torch.as_tensor(row_rep), n_rows=R).numpy()
    assert tps.rowid_launches == before  # plain version on the CPU
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("P, W, R, dtype", [
    (4, 1000, 7, np.int16),
    (2, 33000, 5, np.int32),
    (16, 700, 1, np.int16),  # R = 1: every alias is one of row 0
])
def test_rowid_plain_matches_build_prefix_sums_on_aliasing_ids(P, W, R,
                                                               dtype):
    """Ids r +- 65536, R and negative ids count nowhere in either package
    (the kernel must not count them as the int16 they cast to)."""
    from fscl_tpu.ops.histclr import build_prefix_sums

    row_rep = _aliased_row_rep(17, P, W, R)
    assert (row_rep >= 65536).any() and (row_rep < -1).any()
    assert (row_rep == -1).any() and (row_rep == R).any()
    want = np.asarray(build_prefix_sums(jnp.asarray(row_rep), n_rows=R))
    got = tps.rowid_prefix_sums(torch.as_tensor(row_rep), n_rows=R).numpy()
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


def _perm_inputs(seed, W_genome, P, R, w_pad):
    """Genome row ids, JAX's fat one-hot table, the port's thin id table
    and a sentinel-padded sigma (G = the sentinel row)."""
    from fscl_tpu.ops.histclr import make_row_onehot_group_table
    from fscl_tpu_torch.ops.histclr import make_row_index_group_table

    rng = np.random.default_rng(seed)
    row_cg = rng.integers(0, R + 3, size=W_genome).astype(np.int32)
    G = -(-W_genome // PG)
    sig = np.stack([rng.permutation(G) for _ in range(P)]).astype(np.int32)
    sig = np.concatenate([sig, np.full((P, w_pad // PG + 2), G, np.int32)],
                         1)
    fat = make_row_onehot_group_table(jnp.asarray(row_cg), n_rows=R)
    thin = make_row_index_group_table(torch.as_tensor(row_cg),
                                      sentinel=R).numpy()
    return fat, thin, sig


def _jax_perm_stream(fat, sig, start, n, w_pad, R):
    """_perm_ps's gather, shift and mask (fscl_tpu/engine/permute.py:
    664-679): the [w_pad, P*R] int8 one-hot that build_prefix_sums_oh
    takes."""
    P = sig.shape[0]
    g0, off = divmod(start, PG)
    idx8 = jnp.asarray(sig)[:, g0:g0 + w_pad // PG + 1].T
    oh = fat[idx8].reshape(-1, P, PG, R).transpose(0, 2, 1, 3)
    oh = oh.reshape(-1, P, R)[off:off + w_pad]
    mask = (jnp.arange(w_pad) < n)[:, None, None]
    return jnp.where(mask, oh, jnp.int8(0)).reshape(w_pad, P * R)


def _port_perm(thin, sig, start, n, w_pad, R, out_dtype=None):
    return tps.perm_prefix_sums(
        torch.as_tensor(thin), torch.as_tensor(sig), start=start, n=n,
        w_pad=w_pad, n_rows=R, out_dtype=out_dtype).numpy()


@pytest.mark.parametrize("start, n, out", [
    (0, 1024, "int16"),  # aligned, every site real
    (77, 900, "int32"),  # off = 13, sites past n masked
])
def test_perm_plain_matches_pallas_mode_b_interpret(start, n, out):
    P, R, w_pad = 16, 8, 1024
    fat, thin, sig = _perm_inputs(12, 3000, P, R, w_pad)
    stream = _jax_perm_stream(fat, sig, start, n, w_pad, R)
    want = np.asarray(pallas_ps(stream, out_dtype=getattr(jnp, out),
                                interpret=True))
    got = _port_perm(thin, sig, start, n, w_pad, R,
                     out_dtype=getattr(torch, out))
    assert got.dtype == want.dtype and got.shape == (w_pad + 1, P * R)
    assert not got[0].any()
    np.testing.assert_array_equal(got[1:], want)


@pytest.mark.parametrize("W_genome, start, n, w_pad, dtype", [
    (9000, 4133, 3700, 4096, np.int16),  # off = 5, n < w_pad
    (40000, 1000, 34001, 36864, np.int32),  # w_pad > 32767: int32
])
def test_perm_plain_matches_perm_ps(W_genome, start, n, w_pad, dtype):
    P, R = 3, 6
    fat, thin, sig = _perm_inputs(13, W_genome, P, R, w_pad)
    want = np.asarray(_perm_ps(fat, jnp.asarray(sig), start=start, n=n,
                               w_pad=w_pad))
    before = tps.perm_launches
    got = _port_perm(thin, sig, start, n, w_pad, R)
    assert tps.perm_launches == before  # plain version on the CPU
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start, w_pad", [(0, 512), (4133, 2656)])
def test_perm_plain_matches_perm_ps_at_n0(start, w_pad):
    """No site of the chromosome has an id: every row is zero."""
    P, R = 4, 6
    fat, thin, sig = _perm_inputs(18, 9000, P, R, w_pad)
    want = np.asarray(_perm_ps(fat, jnp.asarray(sig), start=start, n=0,
                               w_pad=w_pad))
    got = _port_perm(thin, sig, start, 0, w_pad, R)
    assert got.shape == (w_pad + 1, P * R) and not got.any()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_perm_refuses_unpadded_sigma():
    P, R, w_pad = 2, 4, 512
    _, thin, sig = _perm_inputs(14, 600, P, R, w_pad)
    G = -(-600 // PG)
    with pytest.raises(ValueError, match="sentinel padding"):
        _port_perm(thin, sig[:, :G], 590, 100, w_pad, R)


# The row-id modes run phase 1b's chained scan (512-site tiles, 64 lanes
# a block): the same stress shapes, plus W under a tile, R = 1 at 256
# replicates (64 KB of staged ids: the shared-memory opt-in) and no site
# (the zero row, no launch); 1a on ids that alias in int16, 1b' with
# n < w_pad, starts off a group boundary and n = 0.  n_launch launches in
# a row must all give the first one's bits.
@pytest.mark.gpu
@pytest.mark.parametrize("P, W, R, dtype, n_launch", [
    (32, 20480, 56, torch.int16, 1),  # the 20k shape
    (16, 35351, 48, torch.int32, 1),  # one genome1m chromosome
    (8, 2656, 45, torch.int16, 1),  # W off the tile
    (32, 512, 56, torch.int16, 1),  # one tile
    (32, 300, 56, torch.int16, 1),  # under a tile
    (5, 6368, 37, torch.int16, 1),  # odd L = 185
    (64, 4128, 128, torch.int16, 1),  # L = 8192, P = 64
    (64, 33024, 128, torch.int32, 1),  # L = 8192, int32
    (256, 20000, 1, torch.int16, 1),  # P = 256, R = 1
    (16, 0, 8, torch.int16, 1),  # no site
    (32, 20000, 56, torch.int16, 20),  # repeated launches
])
def test_rowid_kernel_matches_plain_on_card(P, W, R, dtype, n_launch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernel runs only on the card")
    row_rep = torch.as_tensor(_aliased_row_rep(15, P, W, R), device="cuda")
    before = tps.rowid_launches
    got = tps.rowid_prefix_sums(row_rep, n_rows=R)
    want = tps.rowid_prefix_sums_plain(row_rep, n_rows=R)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    for _ in range(n_launch - 1):
        assert torch.equal(got, tps.rowid_prefix_sums(row_rep, n_rows=R))
    assert tps.rowid_launches == before + (n_launch if W else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("W_genome, start, n, w_pad, P, R, n_launch", [
    (20000, 0, 20000, 20480, 32, 56, 1),  # the 20k shape
    (80000, 40013, 35351, 36864, 16, 48, 1),  # off = 13, int32
    (9000, 4133, 2600, 2656, 8, 45, 1),  # w_pad off the tile, n < w_pad
    (2000, 0, 512, 512, 32, 56, 1),  # one tile
    (2000, 64, 300, 320, 32, 56, 1),  # under a tile
    (10000, 1000, 6300, 6368, 5, 37, 1),  # odd L = 185, off = 8
    (6000, 37, 4100, 4128, 64, 128, 1),  # L = 8192, P = 64
    (40000, 3, 33000, 33024, 64, 128, 1),  # L = 8192, int32
    (30000, 555, 20000, 20480, 256, 1, 1),  # P = 256, R = 1
    (3000, 100, 0, 1024, 16, 8, 1),  # n = 0
    (20000, 0, 20000, 20480, 32, 56, 20),  # repeated launches
])
def test_perm_kernel_matches_plain_on_card(W_genome, start, n, w_pad, P, R,
                                           n_launch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernel runs only on the card")
    _, thin, sig = _perm_inputs(16, W_genome, P, R, w_pad)
    t, s = (torch.as_tensor(x, device="cuda") for x in (thin, sig))
    kw = dict(start=start, n=n, w_pad=w_pad, n_rows=R)
    before = tps.perm_launches
    got = tps.perm_prefix_sums(t, s, **kw)
    want = tps.perm_prefix_sums_plain(t, s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for _ in range(n_launch - 1):
        assert torch.equal(got, tps.perm_prefix_sums(t, s, **kw))
    assert tps.perm_launches == before + n_launch
