"""Hist tables, run geometry and statistic: the port against fscl_tpu.

Same numpy inputs (a simulated chromosome, its sweep tables) go through
fscl_tpu/ops/histclr.py and fscl_tpu_torch/ops/histclr.py.  Stated
tolerances:
  * t3 within 1e-6 relative; row maps equal;
  * bounds bitwise;
  * fbar: 1e-6 absolute plus the 2-ulp difference of the two float32
    logs, scaled by 1/step.  XLA's CPU log differs from the correctly
    rounded float32 log by one ulp on about 1% of inputs (torch's does
    not), and fbar = log(d)/step - cell amplifies that ulp by 1/step;
  * hist_clr_reps_ps in float32: 1e-5 relative plus 1e-3 CLR units
    absolute (sums taken in another order); with bfloat16 operands:
    1e-2 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fscl_tpu.ops.histclr as J
import fscl_tpu_torch.ops.histclr as T
from fscl_tpu.data import build_snp_data
from fscl_tpu.models import background_fsp, build_tables
from fscl_tpu.sim import simulate_dataset
from fscl_tpu_torch.convert import hist_points_from_numpy, hist_tables_from_numpy


@pytest.fixture(scope="module")
def setup():
    sim = simulate_dataset(seed=3, sample_size=24, mb_length=3.0, alpha=3e-5)
    n = len(sim["pos"])
    data = build_snp_data(["1"] * n, sim["pos"], sim["freq"],
                          np.full(n, 24), np.zeros(n, bool))
    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths)
    tables = build_tables(fsp, data.sample_depths, grid_points=256)
    data.attach_model(tables)
    rows_used = np.unique(data.row)
    null_row = np.zeros(tables.table.shape[0])
    null_row[data.row] = data.null_logl
    extent = int(data.pos[-1] - data.pos[0]) + 1
    cand = np.linspace(data.pos[0] - 5000, data.pos[-1] + 5000,
                       200).astype(np.int64)
    return data, tables, rows_used, null_row, extent, cand


def _tables(setup, dec, n_alpha=32):
    data, tables, rows_used, null_row, extent, _ = setup
    args = (tables.table, 256, null_row, rows_used, extent)
    return (J.build_hist_tables(*args, n_alpha=n_alpha, decimate=dec),
            T.build_hist_tables(*args, n_alpha=n_alpha, decimate=dec,
                                device="cpu"))


def _fbar_atol(step):
    return 1e-6 + 2 * np.spacing(np.float32(16.0)) / step


@pytest.mark.parametrize("dec", [1, 2, 8])
def test_tables_match(setup, dec):
    hj, ht = _tables(setup, dec)
    t3j = np.asarray(hj.t3)
    np.testing.assert_allclose(ht.t3.numpy(), t3j, rtol=1e-6,
                               atol=1e-6 * np.abs(t3j).max())
    np.testing.assert_array_equal(ht.row_map, hj.row_map)
    np.testing.assert_array_equal(ht.lalpha, hj.lalpha)
    assert (ht.n_cells, ht.n_rows, ht.n_alpha, ht.grid_points) == (
        hj.n_cells, hj.n_rows, hj.n_alpha, hj.grid_points)
    assert ht.step == hj.step


@pytest.mark.parametrize("dec, er", [(1, 400), (8, 2000)])
def test_bounds_and_fbar_match(setup, dec, er):
    data, *_, cand = setup
    hj, ht = _tables(setup, dec)
    pj = J.build_hist_points(hj, data.pos, cand, er)
    pt = T.build_hist_points(ht, data.pos, cand, er)
    np.testing.assert_array_equal(pt.bounds.numpy(), np.asarray(pj.bounds))
    np.testing.assert_allclose(pt.fbar.numpy(), np.asarray(pj.fbar),
                               rtol=0, atol=_fbar_atol(ht.step))
    assert (pt.n_cand, pt.n_real) == (pj.n_cand, pj.n_real)


@pytest.mark.parametrize("mm_bf16", [False, True])
def test_hist_clr_reps_ps_matches(setup, mm_bf16):
    """Shared tables and geometry (carried over by convert.py), P=3
    replicate streams with int16 prefix sums."""
    data, *_, cand = setup
    hj, _ = _tables(setup, 2, n_alpha=64)
    pj = J.build_hist_points(hj, data.pos, cand, 1500)
    ht = hist_tables_from_numpy(
        t3=np.asarray(hj.t3), row_map=hj.row_map, rows_used=hj.rows_used,
        lalpha=hj.lalpha, offsets=hj.offsets, n_cells=hj.n_cells,
        n_rows=hj.n_rows, n_alpha=hj.n_alpha, step=hj.step,
        grid_points=hj.grid_points, device="cpu",
    )
    pt = hist_points_from_numpy(np.asarray(pj.bounds), np.asarray(pj.fbar),
                                device="cpu")
    rng = np.random.default_rng(0)
    rc = hj.row_map[data.row]
    reps = np.stack([rng.permutation(rc) for _ in range(3)])  # [P, W]
    R = hj.n_rows
    oh = (reps[:, :, None] == np.arange(R)).astype(np.int32)
    ps = np.cumsum(oh.transpose(1, 0, 2).reshape(len(rc), 3 * R), axis=0)
    ps = np.concatenate([np.zeros((1, 3 * R), np.int32), ps]).astype(np.int16)
    kw = dict(n_rep=3, n_cells=hj.n_cells, n_rows=R, n_alpha=hj.n_alpha,
              mm_bf16=mm_bf16)
    want = np.asarray(J.hist_clr_reps_ps(hj.t3, pj.bounds, pj.fbar,
                                         jnp.asarray(ps), **kw))
    got = T.hist_clr_reps_ps(ht.t3, pt.bounds, pt.fbar, torch.as_tensor(ps),
                             **kw).numpy()
    assert got.shape == want.shape
    if mm_bf16:
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_row_index_group_table_matches(setup):
    data = setup[0]
    hj, _ = _tables(setup, 8)
    rc = hj.row_map[data.row].astype(np.int32)
    want = np.asarray(J.make_row_index_group_table(jnp.asarray(rc),
                                                   n_rows=hj.n_rows))
    got = T.make_row_index_group_table(torch.as_tensor(rc),
                                       sentinel=hj.n_rows)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


def test_geometry_gates_match(setup):
    data = setup[0]
    assert T.hist_geometry_ok(data.pos) == J.hist_geometry_ok(data.pos)
    assert T.dataset_qbits([data.pos]) == J.dataset_qbits([data.pos])
    for n in (T.ROWS_MAX, T.ROWS_MAX + 1, T.COMPRESS_ROWS_MAX,
              T.COMPRESS_ROWS_MAX + 1):
        assert T.hist_supported(n, 10) == J.hist_supported(n, 10)
    assert T.hist_supported(T.COMPRESS_ROWS_MAX, 10)
    assert not T.hist_supported(T.COMPRESS_ROWS_MAX + 1, 10)
