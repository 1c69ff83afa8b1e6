"""Row gathers (fscl_tpu_torch/ops/gather.py): the port against the JAX
package.

  * row_gather against pallas_gather's kernel body
    (bench/micro_pallas_gather.py:32-49, rebuilt here at a small shape and
    run in interpret mode: importing that script turns on its persistent
    compile cache) and against jnp.take on unsorted, repeated indices:
    bitwise (a copy);
  * window_operand_plain against the hist_clr_reps_ps chain as it stood
    before the window operand had a kernel (written out below) and
    against a numpy version in the CUDA kernel's operation order:
    bitwise, zeros compared without their sign (a two-term side sum may
    start from +0);
  * hist_clr_reps_ps (every candidate in one call) and rdp_clr_reps (the
    candidates split over several chunks), port against fscl_tpu: the
    tolerances of tests/test_torch_histclr.py and tests/test_torch_rdp.py
    (float32: 1e-5 relative plus 1e-3 CLR units; bfloat16 operands: 1e-2
    relative; compressed f32 prefixes: 5e-3,
    tests/test_torch_mixed_depth.py);
  * on the card (marker ``gpu``): both CUDA kernels bitwise against their
    plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import fscl_tpu.ops.histclr as JH
import fscl_tpu_torch.ops.histclr as TH
from fscl_tpu.models import build_tables
from fscl_tpu.ops.permute import block_permutation_runs as jax_runs
from fscl_tpu_torch.convert import hist_points_from_numpy, hist_tables_from_numpy
from fscl_tpu_torch.ops import gather as G
from fscl_tpu_torch.ops.permute import PERM_GROUP


# ---- row_gather ------------------------------------------------------------

def _pallas_gather(ps, idx, tile):
    """pallas_gather (bench/micro_pallas_gather.py:32-49) at any shape:
    the whole table in one block, `tile` indices per grid step."""
    n, (w1, cols) = idx.shape[0], ps.shape

    def kernel(idx_ref, ps_ref, out_ref):
        out_ref[:] = jnp.take(ps_ref[:], idx_ref[:], axis=0)

    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n, cols), ps.dtype),
        grid=(n // tile,),
        in_specs=[
            pl.BlockSpec((tile,), lambda i: (i,)),
            pl.BlockSpec((w1, cols), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((tile, cols), lambda i: (i, 0)),
        interpret=True,
    )(idx, ps)


def _probe_inputs(seed, rows, cols, n, dtype, sort=True):
    """The probe's inputs (micro_pallas_gather.py:68-77) at any size."""
    rng = np.random.default_rng(seed)
    ps = rng.integers(0, 20000, size=(rows, cols)).astype(dtype)
    idx = rng.integers(0, rows, size=n).astype(np.int32)
    return ps, (np.sort(idx) if sort else idx)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_row_gather_matches_pallas_gather_interpret(dtype):
    ps, idx = _probe_inputs(0, 2049, 128, 4096, dtype)
    want = np.asarray(_pallas_gather(jnp.asarray(ps), jnp.asarray(idx),
                                     tile=1024))
    before = G.gather_launches
    got = G.row_gather(torch.as_tensor(ps), torch.as_tensor(idx)).numpy()
    assert G.gather_launches == before  # plain version on the CPU
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype, cols", [
    (np.int32, 56),  # RDP's psite rows at the 20k path's R
    (np.int16, 3),  # row bytes not a multiple of 16
    (np.float32, 48),
])
def test_row_gather_matches_take_unsorted(dtype, cols):
    ps, idx = _probe_inputs(1, 501, cols, 3000, dtype, sort=False)
    idx[::7] = idx[3]  # repeated rows
    idx[:5] = [500, 0, 500, 0, 17]  # both ends of the table
    want = np.asarray(jnp.take(jnp.asarray(ps), jnp.asarray(idx), axis=0))
    got = G.row_gather(torch.as_tensor(ps), torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_row_gather_never_clamps():
    ps, idx = _probe_inputs(2, 64, 8, 10, np.int32)
    idx[4] = 64
    with pytest.raises(IndexError):
        G.row_gather(torch.as_tensor(ps), torch.as_tensor(idx))


def test_wrappers_refuse_other_devices():
    t = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        G.row_gather(t, torch.zeros(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        G.window_operand(t, None, None, n_rep=1, n_cells=1, n_rows=8)


# ---- window_operand --------------------------------------------------------

def _chain_before(ps, bounds, fbar, *, n_rep, n_cells, n_rows, mm_bf16):
    """hist_clr_reps_ps's chunk body and _clr_from_windows's operand as
    they stood before window_operand (fscl_tpu_torch/ops/histclr.py)."""
    sign = torch.tensor([-1, 1], dtype=ps.dtype, device=ps.device)
    bc = bounds.to(torch.int64)
    psb = ps[bc]  # [c, 2, NC+1, P*R]
    h = ((psb[:, :, 1:, :] - psb[:, :, :-1, :])
         * sign[None, :, None, None]).to(torch.float32)
    NC, R, P = n_cells, n_rows, n_rep
    c = h.shape[0]
    fc = fbar
    w0 = (h * (1.0 - fc[..., None])).sum(1)  # [c, NC, P*R]
    w1 = (h * fc[..., None]).sum(1)
    k = torch.cat([w0, w1], 1).reshape(c, 2 * NC, P, R)
    k = k.permute(0, 2, 1, 3).reshape(c * P, 2 * NC * R)
    if mm_bf16:
        k = k.to(torch.bfloat16).to(torch.float32)
    return k


def _bf16_rne(x):
    """float32 -> bfloat16 -> float32 by bits, round to nearest even."""
    u = x.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _kernel_order(ps, bounds, fbar, *, n_rep, n_cells, n_rows, mm_bf16):
    """numpy, in csrc/row_gather.cu's order: the difference and the sign
    product in the prefix dtype (numpy's int16 wraps as torch's does),
    then separately rounded float32 operations w0 = h0*(1-f0) + h1*(1-f1),
    w1 = h0*f0 + h1*f1."""
    NC, R, P = n_cells, n_rows, n_rep
    c = bounds.shape[0]
    psb = ps[bounds]
    d = psb[:, :, 1:, :] - psb[:, :, :-1, :]
    h = (d * np.array([-1, 1], ps.dtype)[None, :, None, None]).astype(
        np.float32)
    f = fbar[..., None]
    one = np.float32(1.0)
    w0 = h[:, 0] * (one - f[:, 0]) + h[:, 1] * (one - f[:, 1])
    w1 = h[:, 0] * f[:, 0] + h[:, 1] * f[:, 1]
    k = np.concatenate([w0, w1], 1).reshape(c, 2 * NC, P, R)
    k = k.transpose(0, 2, 1, 3).reshape(c * P, 2 * NC * R)
    return _bf16_rne(k) if mm_bf16 else k


def _window_inputs(seed, dtype, *, rows=300, c=7, NC=9, P=3, R=5):
    """Prefix rows, bounds and fbar like the path's: side 0 walks left
    from the split point, side 1 right, with empty windows (repeated
    bounds) and fbar 0.5 on them.  int16 prefixes carry a constant offset
    that wraps them past +-32767, as the stacked slab's one-group-early
    start does; only their differences are meaningful."""
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
    return ps, bounds, fbar, dict(n_rep=P, n_cells=NC, n_rows=R)


def _same_bits(a, b):
    """Equal bit patterns after +0.0 (which maps -0 to +0)."""
    a = np.asarray(a, np.float32) + np.float32(0.0)
    b = np.asarray(b, np.float32) + np.float32(0.0)
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float32])
def test_window_operand_plain_is_the_chain(dtype, mm_bf16):
    ps, bounds, fbar, kw = _window_inputs(3, dtype)
    if dtype == np.int16:  # the wrap is exercised
        assert ps.min() < -30000 and ps.max() > 30000
    args = [torch.as_tensor(x) for x in (ps, bounds, fbar)]
    before = G.window_launches
    got = G.window_operand(*args, mm_bf16=mm_bf16, **kw)
    assert G.window_launches == before  # plain version on the CPU
    assert got.dtype == torch.float32
    assert got.shape == (bounds.shape[0] * kw["n_rep"],
                         2 * kw["n_cells"] * kw["n_rows"])
    _same_bits(got, _chain_before(*args, mm_bf16=mm_bf16, **kw))
    _same_bits(got, _kernel_order(ps, bounds, fbar, mm_bf16=mm_bf16, **kw))


# ---- the statistic against fscl_tpu ----------------------------------------

def _sites(seed, n_sites=400, n=12, span=2_000_000):
    """400 sites over 2 Mb at depth 12, 40% folded, and their sweep tables
    (tests/test_ops.py:_mk_data's inputs, built here so the file imports
    nothing of tests/)."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(span, size=n_sites, replace=False))
    w = 1 / np.arange(1, n)
    freqs = rng.choice(np.arange(1, n), p=w / w.sum(), size=n_sites)
    folded = rng.random(n_sites) < 0.4
    freqs = np.where(folded, np.minimum(freqs, n - freqs), freqs)
    fsp = np.zeros(n + 1)
    fsp[1:n] = np.bincount(freqs, minlength=n + 1)[1:n] + 1.0
    tables = build_tables([fsp / fsp.sum()], [n], grid_points=256)
    depth_p = np.zeros(n_sites, int)
    row = tables.site_rows(depth_p, folded, freqs)
    null = tables.null_logl(depth_p, folded, freqs)
    return tables, pos.astype(np.int64), row, null


@pytest.fixture(scope="module")
def shared():
    """JAX tables and geometry (the inputs of tests/test_torch_rdp.py)
    and the port's copies of them."""
    tables, pos, row, null = _sites(seed=11)
    null_row = np.zeros(tables.table.shape[0])
    null_row[row] = null
    hj = JH.build_hist_tables(
        tables.table, tables.grid_points, null_row, np.unique(row),
        extent_bp=int(pos[-1] - pos[0]) + 1, n_alpha=16)
    cand = np.linspace(int(pos[5]), int(pos[-5]), 9).astype(np.int64)
    pj = JH.build_hist_points(hj, pos, cand, eval_range=150, cand_pad=3)
    ht = hist_tables_from_numpy(
        t3=np.asarray(hj.t3), row_map=hj.row_map, rows_used=hj.rows_used,
        lalpha=hj.lalpha, offsets=hj.offsets, n_cells=hj.n_cells,
        n_rows=hj.n_rows, n_alpha=hj.n_alpha, step=hj.step,
        grid_points=hj.grid_points, device="cpu",
    )
    pt = hist_points_from_numpy(np.asarray(pj.bounds), np.asarray(pj.fbar),
                                device="cpu")
    return dict(hj=hj, pj=pj, ht=ht, pt=pt, pos=pos,
                row_c=hj.row_map[row].astype(np.int32))


def _kw(ht):
    return dict(n_cells=ht.n_cells, n_rows=ht.n_rows, n_alpha=ht.n_alpha)


def _two_per_chunk(monkeypatch, ht, P):
    """Shrink CHUNK_BYTES so rdp_clr_reps takes 2 candidates a chunk:
    several chunks and a ragged last one (hist_clr_reps_ps takes every
    candidate in one call whatever it is)."""
    monkeypatch.setattr(TH, "CHUNK_BYTES",
                        2 * 2 * (ht.n_cells + 1) * P * ht.n_rows * 4)
    assert TH._chunk_rows(ht.n_cells, P, ht.n_rows) == 2


def _rep_prefix(row_c, R, P, seed):
    """[W+1, P*R] int32 one-hot prefix of P shuffled row streams."""
    rng = np.random.default_rng(seed)
    reps = np.stack([rng.permutation(row_c) for _ in range(P)])
    oh = (reps[:, :, None] == np.arange(R)).astype(np.int32)
    ps = np.cumsum(oh.transpose(1, 0, 2).reshape(len(row_c), P * R), 0)
    return np.concatenate([np.zeros((1, P * R), np.int32), ps]).astype(
        np.int32)


@pytest.mark.parametrize("kind", ["int16-wrapped", "int32", "float32"])
def test_hist_clr_reps_ps_chunks_match_jax(shared, monkeypatch, kind):
    s = shared
    hj, pj, ht, pt = s["hj"], s["pj"], s["ht"], s["pt"]
    P, R = 3, ht.n_rows
    ps = _rep_prefix(s["row_c"], R, P, seed=4)
    tol = dict(rtol=1e-5, atol=1e-3)
    if kind == "int16-wrapped":
        ps = (ps + 32760).astype(np.int16)  # every lane wraps past 32767
    elif kind == "float32":  # f32 prefixes as compressed mode feeds them
        rng = np.random.default_rng(5)
        ps = np.cumsum(np.concatenate([np.zeros((1, P * R)), rng.normal(
            size=(len(s["row_c"]), P * R))]), 0).astype(np.float32)
        tol = dict(rtol=0, atol=5e-3)
    kw = dict(n_rep=P, **_kw(ht))
    want = np.asarray(JH.hist_clr_reps_ps(hj.t3, pj.bounds, pj.fbar,
                                          jnp.asarray(ps), c_sub=4, **kw))
    _two_per_chunk(monkeypatch, ht, P)
    got = TH.hist_clr_reps_ps(ht.t3, pt.bounds, pt.fbar, torch.as_tensor(ps),
                              **kw).numpy()
    assert got.shape == want.shape == (P, pt.bounds.shape[0], ht.n_alpha)
    np.testing.assert_allclose(got, want, **tol)
    if kind == "int16-wrapped":  # the same window counts as unwrapped
        plain = TH.hist_clr_reps_ps(
            ht.t3, pt.bounds, pt.fbar,
            torch.as_tensor(_rep_prefix(s["row_c"], R, P, seed=4)), **kw)
        np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("mm_bf16", [False, True])
def test_rdp_clr_reps_chunks_match_jax(shared, monkeypatch, mm_bf16):
    s = shared
    hj, pj, ht, pt = s["hj"], s["pj"], s["ht"], s["pt"]
    P = 4
    key = jax.random.key(3)
    runs = [np.asarray(x) for x in jax_runs(key, s["pos"], 250_000, P,
                                            start=5)]
    G_ = -(-len(s["pos"]) // PERM_GROUP)
    psite_j = JH.build_site_prefix(jnp.asarray(s["row_c"]), n_rows=hj.n_rows)
    want = np.asarray(JH.rdp_clr_reps(
        hj.t3, pj.bounds, pj.fbar, psite_j, *map(jnp.asarray, runs),
        n_rep=P, pg=PERM_GROUP, n_groups=G_, c_sub=4, mm_bf16=mm_bf16,
        **_kw(hj)))
    _two_per_chunk(monkeypatch, ht, P)
    psite = TH.build_site_prefix(torch.as_tensor(s["row_c"]),
                                 n_rows=ht.n_rows)
    before = G.gather_launches
    got = TH.rdp_clr_reps(
        ht.t3, pt.bounds, pt.fbar, psite,
        *(torch.as_tensor(np.array(x)) for x in runs), n_rep=P,
        pg=PERM_GROUP, n_groups=G_, mm_bf16=mm_bf16, **_kw(ht)).numpy()
    assert G.gather_launches == before  # plain versions on the CPU
    assert got.shape == want.shape
    if mm_bf16:
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_rdp_rows_stay_inside_their_tables(shared):
    """_rdp_rows clamps every bound (padding rows of zeros, the last site)
    into the tables the gathers read."""
    s = shared
    ht, pt = s["ht"], s["pt"]
    P, W1 = 4, len(s["pos"]) + 1
    runs = [torch.as_tensor(np.array(x)) for x in jax_runs(
        jax.random.key(3), s["pos"], 250_000, P, start=5)]
    psite = TH.build_site_prefix(torch.as_tensor(s["row_c"]),
                                 n_rows=ht.n_rows)
    tabs = TH._rdp_tables(psite, *runs, pg=PERM_GROUP,
                          n_groups=-(-len(s["pos"]) // PERM_GROUP))
    bc = torch.cat([pt.bounds, torch.zeros_like(pt.bounds[:1]),
                    torch.full_like(pt.bounds[:1], W1 - 1)])
    d_idx, s_idx = TH._rdp_rows(bc, tabs, pg=PERM_GROUP, n_sites1=W1)
    assert d_idx.dtype == s_idx.dtype == torch.int32
    assert d_idx.shape == s_idx.shape == (bc.numel() * P,)
    assert 0 <= int(d_idx.min()) and int(d_idx.max()) < tabs[0].shape[0]
    assert 0 <= int(s_idx.min()) and int(s_idx.max()) < W1
    assert tabs[0].dtype == torch.int32


# ---- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, rows, cols, n, sort", [
    (np.int16, 20481, 128, 65536, True),  # the probe's own shape
    (np.float32, 20481, 128, 65536, True),
    (np.int32, 20001, 56, 32 * 2 * 61 * 150, False),  # RDP's psite rows
    (np.int16, 1000, 3, 5000, False),  # the scalar path
])
def test_row_gather_kernel_matches_plain_on_card(dtype, rows, cols, n, sort):
    dev = _card()
    ps, idx = (torch.as_tensor(x, device=dev) for x in
               _probe_inputs(6, rows, cols, n, dtype, sort=sort))
    before = G.gather_launches
    got = G.row_gather(ps, idx)
    want = G.row_gather_plain(ps, idx)
    torch.cuda.synchronize()
    assert G.gather_launches == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("dtype, P, R", [
    (np.int16, 1, 56),  # the scan
    (np.int16, 32, 56),  # a stacked 20k slice
    (np.int32, 16, 48),  # genome
    (np.float32, 32, 32),  # compressed mixed depth
])
def test_window_operand_kernel_matches_plain_on_card(dtype, P, R, mm_bf16):
    dev = _card()
    ps, bounds, fbar, kw = _window_inputs(7, dtype, rows=5000, c=300, NC=60,
                                          P=P, R=R)
    args = [torch.as_tensor(x, device=dev) for x in (ps, bounds, fbar)]
    before = G.window_launches
    got = G.window_operand(*args, mm_bf16=mm_bf16, **kw)
    want = G.window_operand_plain(*args, mm_bf16=mm_bf16, **kw)
    torch.cuda.synchronize()
    assert G.window_launches == before + 1
    _same_bits(got.cpu().numpy(), want.cpu().numpy())
