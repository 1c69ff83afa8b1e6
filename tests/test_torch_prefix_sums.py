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
    (both sum in float64; the order differs), and two launches bitwise
    equal to each other.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fscl_tpu.ops.histclr import (
    build_prefix_sums_seg,
    make_row_weight_group_table,
)
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


@pytest.mark.gpu
@pytest.mark.parametrize("S, w, P, R, dtype", [
    (1, 20480, 16, 56, torch.int16),
    (4, 36864, 16, 56, torch.int32),
])
def test_kernel_matches_plain_on_card(S, w, P, R, dtype):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernel runs only on the card")
    table, sig, seg_g0 = _inputs(5, S, w, P, R, n_groups=S * w // PG)
    args = [torch.as_tensor(x, device="cuda") for x in (table, sig, seg_g0)]
    before = tps.launches
    got = tps.onehot_prefix_sums(*args, w_seg_p=w, n_rows=R)
    want = tps.onehot_prefix_sums_plain(*args, w_seg_p=w, n_rows=R)
    torch.cuda.synchronize()
    assert tps.launches == before + 1
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


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
@pytest.mark.parametrize("S, w, P, R, n_ids", [
    (4, 24576, 32, 32, 1590),  # mixed-depth headline permutation shape
    (1, 36864, 16, 104, 8193),  # widest channel count, largest table
])
def test_weighted_kernel_matches_plain_on_card(S, w, P, R, n_ids):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernel runs only on the card")
    table, wt, sig, seg_g0 = _weighted_inputs(
        9, S, w, P, R, n_ids, n_groups=S * w // PG)
    args = [torch.as_tensor(x, device="cuda")
            for x in (table, wt, sig, seg_g0)]
    before = tps.weighted_launches
    got = tps.weighted_prefix_sums(*args, w_seg_p=w)
    again = tps.weighted_prefix_sums(*args, w_seg_p=w)
    want = tps.weighted_prefix_sums_plain(*args, w_seg_p=w)
    torch.cuda.synchronize()
    assert tps.weighted_launches == before + 2
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, again)  # no atomics: same bits every run
    scale = want.reshape(S, w, -1).abs().amax(1, keepdim=True)
    ulp = torch.finfo(torch.float32).eps * scale
    err = (got - want).abs().reshape(S, w, -1)
    assert bool((err <= 2 * ulp).all()), float((err / ulp).max())
