"""The lattice path of the port (fscl_tpu_torch/ops/lattice.py, the
lattice branches of engine/scan.py and engine/permute.py) against the JAX
package (fscl_tpu/ops/lattice.py and its callers).

Stated tolerances, S = 2 sum |y - null| over the contributing sites in
float64 (the float32 sums of the two packages run in different orders,
and XLA's CPU log differs from torch's by an ulp at ~1% of sites):
  * build_lattice_pack, the offsets and the converted tables: bitwise;
  * clr_lattice_plain against fscl_tpu's clr_lattice, with dummy
    candidates (exactly 0), m_base != 0, sites past the grid end, and a
    replicate axis against a per-replicate loop: |diff| <= 1e-5 S + 1e-4
    per entry;
  * two_stage_lattice_max (with and without the ultra stage) and
    seeded_lattice_max: CLR within 1e-5 S + 1e-4, lalpha equal except at
    listed near-ties (entries whose two lalphas score within that
    tolerance of each other);
  * scan_genome on the lattice path (use_hist=False), on a hist scan whose
    tie step exceeds exact_step_max (grid 512: the exact re-evaluation),
    and past the hist gate: reported CLR within 1e-5 S + 1e-3, positions
    and lalpha equal off listed near-ties (intervals whose two reported
    CLRs differ by at most that tolerance);
  * scan_permute on the lattice path with the JAX package's sigma
    injected: thresholds within 1e-3, permute_n / permute_p /
    permute_finished equal off listed near-tie points (a replicate within
    1e-4 of its threshold but not equal to it: a replicate whose windows
    hold the observed attributes, common where blocks are as long as the
    chromosome, gives the threshold bit for bit in either package and
    counts alike);
  * the kernel's pack (kernel_pack, LatticeTables' pack_*): its first
    2A columns are build_lattice_pack's bitwise, the padding zeros; the
    plain version reads a padded pack's first 2A columns only (NaN in the
    padding changes no bit); the candidates a block (block_candidates)
    against a direct count; the kernel's mask limit (a numpy mirror)
    against the sum mask;
  * on the card (marker ``gpu``): the kernel against its plain version
    within 1e-5 S + 1e-4 at three shapes, dummy candidates exactly 0, two
    launches bitwise equal; candidate tiles whose windows differ in width
    and cross, dummy candidates inside a tile and W off the site tile,
    each candidate's bits equal alone and in its tile; an identity
    replicate at Rr = 32, the observed call at Rr = 1 and a candidate
    alone bitwise equal; NaN in the kernel pack's padding changes no bit.

This file imports nothing of tests/: on the card machine such imports do
not collect.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fscl_tpu.engine.permute as JP
import fscl_tpu.engine.scan as JS
import fscl_tpu.ops.histclr as JH
import fscl_tpu.ops.lattice as JL
import fscl_tpu_torch.engine.permute as TP
import fscl_tpu_torch.engine.scan as TS
import fscl_tpu_torch.ops.histclr as TH
import fscl_tpu_torch.ops.lattice as TL
from fscl_tpu.data import build_snp_data
from fscl_tpu.models import background_fsp, build_tables
from fscl_tpu.ops.permute import block_permutation_groups as jax_sigma
from fscl_tpu.sim import simulate_dataset
from fscl_tpu_torch.convert import lattice_tables_from_numpy

REL, ABS = 1e-5, 1e-4  # kernel-level: |diff| <= REL * S + ABS
SCAN_ABS = 1e-3  # reported scan CLR: |diff| <= REL * S + SCAN_ABS
SCAN = dict(eval_range=300, small_grid_sp=10000, large_grid_sp=100000,
            selection_bf16=False)


EDGE = 1e-3  # mask-edge band in lattice units (a log ulp moves u ~2e-5)


def _ref(pack, row, pos, null, cand, lo, hi, m_base, m_rel, G,
         edges=False):
    """float64 numpy reference: (clr, S) [Rr, P, A], the per-site
    coordinates computed in float32 as both packages do; with ``edges``
    also the entries with a site within EDGE of the mask's edge
    u + m_rel = G-1, where a one-ulp difference of the two packages'
    float32 log can take one site's whole contribution in or out."""
    Rr, P, A = row.shape[0], len(cand), len(m_rel)
    inv = np.float32((G - 1) / 24.0)
    clr, S = np.zeros((Rr, P, A)), np.zeros((Rr, P, A))
    edge = np.zeros((Rr, P, A), bool)
    for p in range(P):
        if lo[p] > hi[p]:
            continue
        w = np.arange(lo[p], hi[p] + 1)
        logd = np.log(np.maximum(np.abs(pos[w] - cand[p]), 1)
                      .astype(np.float32))
        for r in range(Rr):
            u = (logd.astype(np.float64) * inv + m_base[r, p]).astype(
                np.float32)  # one rounding, as XLA's fused multiply-add
            i0 = np.clip(u.astype(np.int32), 0, G - 1)
            frac = np.clip(u - i0.astype(np.float32), 0, 1)
            v = pack[row[r, w] * G + i0].astype(np.float64)
            y = v[:, 0::2] + (v[:, 1::2] - v[:, 0::2]) * frac[:, None]
            x = u[:, None] + m_rel.astype(np.float32)[None]
            c = np.where(x <= G - 1, y - null[r, w, None], 0.0)
            clr[r, p], S[r, p] = 2 * c.sum(0), 2 * np.abs(c).sum(0)
            edge[r, p] = (np.abs(x - (G - 1)) < EDGE).any(0)
    return (clr, S, edge) if edges else (clr, S)


def _kernel_inputs(seed, *, G=512, R=20, W=3000, Rr=3, P=40, A_rel="fine"):
    """Seeded table, sites and candidates: 3 dummy candidates (lo = 1,
    hi = 0), candidates past the chromosome's end (their far sites fall
    past the grid end), random m_base in [0, G-1]."""
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=(R, G)) - 3).astype(np.float32)
    pos = np.sort(rng.choice(3_000_000, W, replace=False)).astype(np.int32)
    row = rng.integers(0, R, size=(Rr, W)).astype(np.int32)
    null = (rng.normal(size=(Rr, W)) - 3).astype(np.float32)
    cand = rng.integers(0, 3_500_000, P).astype(np.int32)
    lo = rng.integers(0, W // 2, P).astype(np.int32)
    hi = (lo + rng.integers(0, 900, P)).astype(np.int32)
    lo[:3], hi[:3] = 1, 0
    m_rel = {"coarse": JL.coarse_lattice_offsets,
             "fine": JL.fine_lattice_offsets}[A_rel](G)
    m_base = rng.integers(0, G, size=(Rr, P)).astype(np.int32)
    if A_rel == "coarse":
        m_base[:] = 0
    pack = JL.build_lattice_pack(table, m_rel)
    return dict(pack=pack, row=row, pos=pos, null=null, cand=cand, lo=lo,
                hi=hi, m_base=m_base, m_rel=m_rel, G=G, table=table)


def _torch(x, dev="cpu"):
    return torch.as_tensor(np.ascontiguousarray(x), device=dev)


def _port_clr(k, dev="cpu", plain=False, pack=None):
    """The port's CLRs of k's inputs, from its kernel pack (or pack)."""
    fn = TL.clr_lattice_plain if plain else TL.clr_lattice
    if pack is None:
        pack = TL.kernel_pack(_torch(k["pack"], dev))
    return fn(pack, *(_torch(k[n], dev) for n in (
        "row", "pos", "null", "cand", "lo", "hi", "m_base", "m_rel")),
        grid_points=k["G"])


def _nan_padded(k, dev="cpu"):
    """k's kernel pack with NaN in its padding columns."""
    pack = TL.kernel_pack(_torch(k["pack"], dev)).clone()
    pack[:, k["pack"].shape[1]:] = float("nan")
    return pack


def _jax_clr(k, r):
    return np.asarray(JL.clr_lattice(
        jnp.asarray(k["pack"]), jnp.asarray(k["row"][r]),
        jnp.asarray(k["pos"]), jnp.asarray(k["null"][r]),
        jnp.asarray(k["cand"]), jnp.asarray(k["lo"]), jnp.asarray(k["hi"]),
        jnp.asarray(k["m_base"][r]), jnp.asarray(k["m_rel"]),
        grid_points=k["G"], chunk=8, n_alpha=len(k["m_rel"])))


# ---- tables ----------------------------------------------------------------

@pytest.mark.parametrize("G", [256, 512, 1024, 2048])
def test_lattice_offsets_equal(G):
    for name in ("coarse_lattice_offsets", "fine_lattice_offsets",
                 "ultra_lattice_offsets"):
        a, b = getattr(TL, name)(G), getattr(JL, name)(G)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert TL.lattice_step(G) == JL.lattice_step(G)


@pytest.mark.parametrize("stage", ["coarse", "fine", "ultra"])
def test_build_lattice_pack_bitwise(stage):
    G = 512
    table = np.random.default_rng(4).normal(size=(7, G)).astype(np.float32)
    m = getattr(JL, f"{stage}_lattice_offsets")(G)
    a, b = TL.build_lattice_pack(table, m), JL.build_lattice_pack(table, m)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_converted_tables_equal_the_ports_own():
    G = 256
    table = np.random.default_rng(5).normal(size=(9, G)).astype(np.float32)
    jlt = JL.LatticeTables(table, G)
    got = lattice_tables_from_numpy(
        grid_points=G, device="cpu",
        **{n: np.asarray(getattr(jlt, n)) for n in (
            "pack_coarse", "pack_fine", "pack_ultra", "m_coarse",
            "m_fine", "m_ultra")})
    own = TL.LatticeTables.from_table(table, G, device="cpu")
    for n in ("pack_coarse", "pack_fine", "pack_ultra", "m_coarse_dev",
              "m_fine_dev", "m_ultra_dev"):
        assert torch.equal(getattr(got, n), getattr(own, n)), n
    assert got.step == own.step == JL.lattice_step(G)


@pytest.mark.parametrize("stage", ["coarse", "fine", "ultra"])
def test_kernel_pack_extends_build_lattice_pack(stage):
    G = 256
    table = np.random.default_rng(6).normal(size=(5, G)).astype(np.float32)
    m = getattr(JL, f"{stage}_lattice_offsets")(G)
    want = JL.build_lattice_pack(table, m)
    A = len(m)
    got = TL.kernel_pack(torch.as_tensor(TL.build_lattice_pack(table, m)))
    assert got.shape == (5 * G, 2 * TL.KERNEL_ROW[A])
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_array_equal(got[:, :2 * A].numpy(), want)
    assert not got[:, 2 * A:].any()
    lt = TL.LatticeTables.from_table(table, G, device="cpu")
    assert torch.equal(getattr(lt, f"pack_{stage}"), got)


def _mask_limit(m, gmax):
    """numpy float32 mirror of csrc/lattice_clr.cu mask_limit: the
    largest float t with fl(t + m) <= gmax, by binary search over the
    floats in value order."""
    f32 = np.float32

    def key(x):
        b = int(np.array(x, np.float32).view(np.int32))
        return b if b >= 0 else -2**31 - b

    def value(k):
        return np.array(k if k >= 0 else -2**31 - k,
                        np.int32).view(np.float32)[()]

    edge = f32(gmax) - f32(m)
    lo, hi = key(edge - f32(2)), key(edge + f32(2))
    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        if f32(value(mid) + f32(m)) <= f32(gmax):
            lo = mid
        else:
            hi = mid
    return value(lo)


@pytest.mark.parametrize("G", [512, 1024, 2048])
def test_mask_limit_is_the_sum_mask(G):
    """u <= mask_limit(m) exactly where fl(u + m) <= G-1, at the limit's
    neighbouring floats and at random u, for every offset of the three
    lists (the kernel tests the mask so)."""
    rng = np.random.default_rng(G)
    gmax = np.float32(G - 1)
    offsets = np.unique(np.concatenate([
        getattr(TL, f"{s}_lattice_offsets")(G)
        for s in ("coarse", "fine", "ultra")]))
    for m in offsets.astype(np.float32):
        t = _mask_limit(m, gmax)
        near = [t]
        for step in (np.inf, -np.inf):
            x = t
            for _ in range(3):
                x = np.nextafter(x, np.float32(step))
                near.append(x)
        u = np.concatenate([np.array(near, np.float32),
                            rng.uniform(-60, G + 60, 2000).astype(np.float32),
                            np.float32([0.0, -0.0, np.inf])])
        assert ((u <= t) == ((u + m).astype(np.float32) <= gmax)).all(), m


@pytest.mark.parametrize("Rr, P, n_sm", [(1, 20400, 132), (32, 448, 132),
                                         (1, 1556, 132), (16, 448, 132),
                                         (1, 120000, 132), (3, 5, 2)])
def test_block_candidates_against_count(Rr, P, n_sm):
    got = TL.block_candidates(Rr, P, n_sm)
    blocks = Rr * int(np.ceil(P / TL.BLOCK_CANDS))
    assert got == (TL.BLOCK_CANDS
                   if blocks >= TL.MIN_BLOCKS_PER_SM * n_sm else 1)
    assert got in (1, 4)  # the package build's instantiations


# ---- clr_lattice -----------------------------------------------------------

@pytest.mark.parametrize("seed, stage", [(0, "fine"), (1, "coarse"),
                                         (2, "fine")])
def test_clr_lattice_plain_matches_jax(seed, stage):
    k = _kernel_inputs(seed, A_rel=stage)
    got = _port_clr(k).numpy()
    want = np.stack([_jax_clr(k, r) for r in range(k["row"].shape[0])])
    _, S, edge = _ref(k["pack"], k["row"], k["pos"], k["null"],
                      k["cand"], k["lo"], k["hi"], k["m_base"], k["m_rel"],
                      k["G"], edges=True)
    assert got.shape == want.shape == S.shape
    assert not got[:, :3].any()  # dummy candidates: exactly 0
    tol = REL * S + ABS
    # off the mask's edge the two packages agree; on it (listed) one site
    # may count on one side only
    print("mask-edge entries (replicate, candidate, offset):",
          list(zip(*np.nonzero(edge))))
    assert edge.mean() < 0.01
    assert (np.abs(got - want) <= tol)[~edge].all()
    # far candidates and large bases put sites past the grid end
    G, inv = k["G"], np.float32((k["G"] - 1) / 24.0)
    far = np.log(np.float32(3_500_000)) * inv + k["m_base"].max()
    assert far + k["m_rel"].max() > G - 1


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_clr_lattice_plain_ignores_padding(stage):
    """The plain version reads a kernel pack's first 2A columns: the
    unpadded pack, the zero-padded one and a NaN-padded one give the same
    bits."""
    k = _kernel_inputs(7, A_rel=stage)
    bits = [_port_clr(k, pack=p).view(torch.int32).numpy()
            for p in (_torch(k["pack"]), None, _nan_padded(k))]
    assert TL.KERNEL_ROW[len(k["m_rel"])] * 2 == _nan_padded(k).shape[1]
    np.testing.assert_array_equal(bits[0], bits[1])
    np.testing.assert_array_equal(bits[0], bits[2])


def test_clr_lattice_replicate_axis_matches_loop():
    k = _kernel_inputs(3, Rr=4)
    got = _port_clr(k).numpy()
    _, S = _ref(k["pack"], k["row"], k["pos"], k["null"], k["cand"],
                k["lo"], k["hi"], k["m_base"], k["m_rel"], k["G"])
    for r in range(4):
        one = dict(k, row=k["row"][r:r + 1], null=k["null"][r:r + 1],
                   m_base=k["m_base"][r:r + 1])
        assert (np.abs(_port_clr(one).numpy()[0] - got[r])
                <= REL * S[r] + ABS).all()


def test_clr_lattice_refuses_other_devices():
    k = _kernel_inputs(0, W=50, P=4)
    with pytest.raises(ValueError, match="unsupported device"):
        _port_clr(k, dev="meta")


# ---- the alpha search ------------------------------------------------------

@pytest.fixture(scope="module")
def search_inputs():
    """A real sweep-model table and one chromosome of simulated sites."""
    data, tables = _dataset(1, 2.0, 24, 90, 512)
    W = data.n_snps
    rng = np.random.default_rng(9)
    Rr = 3
    row = np.stack([data.row] + [rng.permutation(data.row)
                                 for _ in range(Rr - 1)]).astype(np.int32)
    null = np.stack([data.null_logl] + [
        rng.permutation(data.null_logl) for _ in range(Rr - 1)
    ]).astype(np.float32)
    pos = np.asarray(data.pos, dtype=np.int32)
    cand = np.linspace(pos[0] - 5000, pos[-1] + 5000, 60).astype(np.int32)
    from fscl_tpu.ops.windows import candidate_windows

    _, lo, hi = candidate_windows(pos, cand, 300)
    lo, hi = lo.astype(np.int32), hi.astype(np.int32)
    lo[:2], hi[:2] = 1, 0
    jlt = JL.LatticeTables(tables.table, tables.grid_points)
    tlt = TL.LatticeTables.from_table(tables.table, tables.grid_points,
                                      device="cpu")
    assert W > 1000
    return dict(row=row, null=null, pos=pos, cand=cand, lo=lo, hi=hi,
                jlt=jlt, tlt=tlt, table=tables.table, G=tables.grid_points)


def _winner_scale(si, la):
    """(clr, S) [Rr, P] at each entry's lalpha, float64 reference."""
    G = si["G"]
    m = np.round((la - JL.LOG_AD_MIN) / JL.lattice_step(G)).astype(np.int32)
    pack = JL.build_lattice_pack(si["table"], np.zeros(1, np.int32))
    clr, S = _ref(pack, si["row"], si["pos"], si["null"], si["cand"],
                  si["lo"], si["hi"], m, np.zeros(1, np.int32), G)
    return clr[..., 0], S[..., 0]


def _check_search(si, got_clr, got_la, want_clr, want_la, what):
    c_port, S = _winner_scale(si, got_la)
    c_jax, S_j = _winner_scale(si, want_la)
    tol = REL * np.maximum(S, S_j) + ABS
    assert (np.abs(got_clr - want_clr) <= tol).all(), what
    differ = got_la != want_la
    # a differing lalpha must be a near-tie: both score alike
    assert (np.abs(c_port - c_jax)[differ] <= tol[differ]).all(), what
    print(f"{what}: lalpha near-ties (replicate, candidate):",
          list(zip(*np.nonzero(differ))))
    assert differ.mean() <= 0.05, what
    assert (got_clr[:, :2] == 0).all()  # dummy candidates


@pytest.mark.parametrize("ultra", [True, False])
def test_two_stage_lattice_max_matches_jax(search_inputs, ultra):
    si = search_inputs
    args = [_torch(si[n]) for n in ("row", "pos", "null", "cand", "lo",
                                    "hi")]
    clr, la = TL.two_stage_lattice_max(si["tlt"], *args, ultra=ultra)
    jlt = si["jlt"]
    want = []
    for r in range(si["row"].shape[0]):
        a = [jnp.asarray(si[n][r] if n in ("row", "null") else si[n])
             for n in ("row", "pos", "null", "cand", "lo", "hi")]
        if ultra:
            out = JL.two_stage_lattice_max(jlt, *a)
        else:  # the permutation statistic's two stages
            out = JL._two_stage_impl(
                jlt.pack_coarse, jlt.pack_fine, jlt.m_coarse_dev,
                jlt.m_fine_dev, *a, grid_points=jlt.grid_points, chunk=8)
        want.append([np.asarray(x) for x in out])
    wc = np.stack([w[0] for w in want])
    wl = np.stack([w[1] for w in want])
    assert clr.dtype == la.dtype == torch.float32
    _check_search(si, clr.numpy(), la.numpy(), wc, wl,
                  f"two-stage ultra={ultra}")


def test_seeded_lattice_max_matches_jax(search_inputs):
    si = search_inputs
    rng = np.random.default_rng(21)
    m_seed = rng.integers(-20, si["G"] + 20, len(si["cand"])).astype(
        np.int32)
    args = [_torch(si[n]) for n in ("row", "pos", "null", "cand", "lo",
                                    "hi")]
    clr, la = TL.seeded_lattice_max(si["tlt"], *args, _torch(m_seed))
    want = [[np.asarray(x) for x in JL.seeded_lattice_max(
        si["jlt"], *[jnp.asarray(si[n][r] if n in ("row", "null")
                                 else si[n])
                     for n in ("row", "pos", "null", "cand", "lo", "hi")],
        jnp.asarray(m_seed))] for r in range(si["row"].shape[0])]
    # dummy candidates: every offset scores 0 > -inf, so they report 0
    _check_search(si, clr.numpy(), la.numpy(),
                  np.stack([w[0] for w in want]),
                  np.stack([w[1] for w in want]), "seeded")


# ---- the scan --------------------------------------------------------------

def _dataset(n_chr, mb, depth, seed0, grid):
    chrs, pos, fr = [], [], []
    for c in range(n_chr):
        sim = simulate_dataset(seed=seed0 + c, sample_size=depth,
                               mb_length=mb, alpha=3e-5)
        chrs += [str(c + 1)] * len(sim["pos"])
        pos.append(sim["pos"])
        fr.append(sim["freq"])
    pos, fr = np.concatenate(pos), np.concatenate(fr)
    data = build_snp_data(chrs, pos, fr, np.full(len(pos), depth),
                          np.zeros(len(pos), bool))
    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths)
    tables = build_tables(fsp, data.sample_depths, grid_points=grid)
    data.attach_model(tables)
    return data, tables


@pytest.fixture(scope="module")
def model():
    """Two 2 Mb chromosomes at depth 24, grid 512 (tie step 0.094)."""
    return _dataset(2, 2.0, 24, 40, 512)


def _scan_scale(data, tables, res, eval_range):
    """S at each reported (position, lalpha), float64 reference."""
    from fscl_tpu.ops.windows import candidate_windows

    G = tables.grid_points
    pack = JL.build_lattice_pack(tables.table, np.zeros(1, np.int32))
    out = np.zeros(res.n_points)
    for c, cl in enumerate(data.chr_limits):
        k = np.nonzero(res.chr_id == c)[0]
        if len(k) == 0:
            continue
        sl = slice(cl.start_index, cl.start_index + cl.n_snps)
        pos = np.asarray(data.pos[sl], dtype=np.int32)
        cand = res.sweep_pos[k].astype(np.int32)
        _, lo, hi = candidate_windows(pos, cand, eval_range)
        m = np.round((res.lalpha[k] - JL.LOG_AD_MIN) / JL.lattice_step(G))
        _, S = _ref(pack, np.asarray(data.row[sl], np.int32)[None], pos,
                    np.asarray(data.null_logl[sl], np.float32)[None], cand,
                    lo, hi, m.astype(np.int32)[None], np.zeros(1, np.int32),
                    G)
        out[k] = S[0, :, 0]
    return out


def _check_scan(data, tables, got, want, eval_range, what):
    assert got.n_points == want.n_points > 0, what
    np.testing.assert_array_equal(got.chr_id, want.chr_id)
    np.testing.assert_array_equal(got.interval_start, want.interval_start)
    S = np.maximum(_scan_scale(data, tables, got, eval_range),
                   _scan_scale(data, tables, want, eval_range))
    tol = REL * S + SCAN_ABS
    assert np.isfinite(got.clr).all(), what
    assert (np.abs(got.clr - want.clr) <= tol).all(), (
        what, np.abs(got.clr - want.clr).max())
    differ = (got.sweep_pos != want.sweep_pos) | (got.lalpha != want.lalpha)
    print(f"{what}: near-tie intervals (position or lalpha differ):",
          list(np.nonzero(differ)[0]))
    assert differ.mean() <= 0.1, what


def _jax_scan(data, tables, cfg):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "device_count", lambda: 1)
        return JS.scan_genome(data, tables, cfg)


def test_scan_genome_lattice_path_matches_jax(model):
    data, tables = model
    want = _jax_scan(data, tables, JS.ScanConfig(**SCAN, use_hist=False))
    before = TL.lattice_clr_launches
    got = TS.scan_genome(data, tables, TS.ScanConfig(**SCAN, use_hist=False),
                         device="cpu")
    assert TL.lattice_clr_launches == before  # the CPU runs the plain version
    _check_scan(data, tables, got, want, SCAN["eval_range"], "no-hist scan")


def test_scan_genome_exact_tie_stage_matches_jax(model, monkeypatch):
    """Grid 512: the finest hist table's step (0.094) exceeds
    exact_step_max, so the tie pool is re-evaluated per site."""
    data, tables = model
    ht = TS.make_scan_hist_tables(data, tables, 128, decimate=2,
                                  device="cpu")
    assert ht is not None and ht.step > TS.ScanConfig().exact_step_max
    want = _jax_scan(data, tables, JS.ScanConfig(**SCAN))
    calls = []
    orig = TS._ChromosomeBlock.eval_device

    def spy(self, cand_flat, cfg):
        calls.append(len(cand_flat))
        return orig(self, cand_flat, cfg)

    monkeypatch.setattr(TS._ChromosomeBlock, "eval_device", spy)
    got = TS.scan_genome(data, tables, TS.ScanConfig(**SCAN), device="cpu")
    assert len(calls) == len(data.chr_limits)  # the tie stage only
    _check_scan(data, tables, got, want, SCAN["eval_range"],
                "hist scan, exact tie stage")


# ---- past the hist gate ------------------------------------------------------

def _fresh(result):
    r = copy.deepcopy(result)
    r.permute_n[:] = 0
    r.permute_p[:] = 0
    r.permute_finished[:] = False
    r.null_clr = [None] * r.n_points
    return r


def _permute_both(data, tables, result, scan_kw, pc):
    """scan_permute of both packages on one sigma stream (the JAX
    package's); (port result, JAX result, port last_stats)."""
    r_jax = _fresh(result)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "device_count", lambda: 1)
        JP.scan_permute(data, tables, r_jax, JS.ScanConfig(**scan_kw),
                        JP.PermuteConfig(**pc))
    key, gp = jax.random.key(pc["seed"]), data.genome_pos()
    width = pc.get("scan_width_mb", 1.0) * 1e6

    def sigma_source(n, start):
        return np.asarray(jax_sigma(key, gp, width, n, start=start))

    r_port = _fresh(result)
    TP.scan_permute(data, tables, r_port, TS.ScanConfig(**scan_kw),
                    TP.PermuteConfig(**pc), device="cpu",
                    sigma_source=sigma_source)
    return r_port, r_jax, dict(TP.last_stats)


def _check_permute(r_port, r_jax, what, min_keep=0.7):
    np.testing.assert_allclose(r_port.stat_threshold, r_jax.stat_threshold,
                               rtol=0, atol=1e-3)
    K = r_jax.n_points
    near = sorted({
        i for i in range(K) for r in (r_jax, r_port)
        if np.any((np.abs(np.asarray(r.null_clr[i]) - r.stat_threshold[i])
                   < 1e-4) & (np.asarray(r.null_clr[i])
                              != r.stat_threshold[i]))
    })
    keep = np.setdiff1d(np.arange(K), near)
    print(f"{what}: near-tie points excluded:", near)
    assert len(keep) >= min_keep * K, what
    for f in ("permute_p", "permute_n", "permute_finished"):
        np.testing.assert_array_equal(getattr(r_port, f)[keep],
                                      getattr(r_jax, f)[keep])
    assert (r_port.permute_n > 0).all()


def test_scan_permute_lattice_path_matches_jax(model):
    data, tables = model
    result = _jax_scan(data, tables, JS.ScanConfig(**SCAN, use_hist=False))
    pc = dict(n_permute=48, seed=5, chunk_replicates=16, scan_width_mb=0.1,
              use_hist=False)
    r_port, r_jax, st = _permute_both(data, tables, result,
                                      dict(SCAN, use_hist=False), pc)
    assert st["lattice_dispatches"] > 0 and st["stack_dispatches"] == 0
    _check_permute(r_port, r_jax, "no-hist permutations")
    assert r_jax.permute_finished.any()  # pruning engaged


@pytest.fixture(scope="module")
def gate_sim():
    return simulate_dataset(seed=77, sample_size=24, snp_density=1.0,
                            mb_length=3.0, alpha=3e-5, n_sweeps=1)


def _gate_model(pos, freq, n, grid=256):
    data = build_snp_data(["1"] * len(pos), np.asarray(pos), np.asarray(freq),
                          np.full(len(pos), n), np.zeros(len(pos), bool))
    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths)
    tables = build_tables(fsp, data.sample_depths, grid_points=grid)
    data.attach_model(tables)
    return data, tables


def test_sites_cap_falls_back_to_lattice(gate_sim, monkeypatch):
    """A chromosome over SITES_MAX (shrunk in both packages for this test,
    tests/test_hist_gate.py:64): the hist gate closes, scan and
    permutations take the lattice path and match the JAX package."""
    sim = gate_sim
    monkeypatch.setattr(JH, "SITES_MAX", len(sim["pos"]) - 1)
    monkeypatch.setattr(TH, "SITES_MAX", len(sim["pos"]) - 1)
    data, tables = _gate_model(sim["pos"], sim["freq"], sim["n"])
    cfg = dict(eval_range=1500, small_grid_sp=25_000, large_grid_sp=500_000)
    assert TS.make_scan_hist_tables(data, tables, device="cpu") is None
    want = _jax_scan(data, tables, JS.ScanConfig(**cfg))
    got = TS.scan_genome(data, tables, TS.ScanConfig(**cfg), device="cpu")
    _check_scan(data, tables, got, want, cfg["eval_range"], "sites cap")
    pc = dict(n_permute=48, chunk_replicates=16, seed=9)
    r_port, r_jax, st = _permute_both(data, tables, want, cfg, pc)
    assert st["lattice_dispatches"] > 0 and st["stack_dispatches"] == 0
    _check_permute(r_port, r_jax, "sites cap permutations", min_keep=0.5)


def test_dense_cluster_falls_back_to_lattice(gate_sim):
    """A >16-site cluster inside one minimum-quantum block of a ~500 Mb
    chromosome defeats the block table (tests/test_hist_gate.py:110): the
    lattice path runs end to end and matches the JAX package."""
    rng = np.random.default_rng(5)
    pos = np.sort(rng.choice(500_000_000, 2000, replace=False)).astype(
        np.int64)
    pos = np.sort(np.concatenate([pos, 250_000_000 + np.arange(24) * 2]))
    freq = rng.integers(1, gate_sim["n"], size=len(pos))
    assert TH.dataset_qbits([pos]) is None and not TH.hist_geometry_ok(pos)
    data, tables = _gate_model(pos, freq, gate_sim["n"])
    cfg = dict(eval_range=500, small_grid_sp=50_000_000,
               large_grid_sp=250_000_000)
    assert TS.make_scan_hist_tables(data, tables, device="cpu") is None
    want = _jax_scan(data, tables, JS.ScanConfig(**cfg))
    got = TS.scan_genome(data, tables, TS.ScanConfig(**cfg), device="cpu")
    _check_scan(data, tables, got, want, cfg["eval_range"], "dense cluster")
    pc = dict(n_permute=16, chunk_replicates=16, seed=2)
    r_port, r_jax, st = _permute_both(data, tables, want, cfg, pc)
    assert st["lattice_dispatches"] > 0
    _check_permute(r_port, r_jax, "dense cluster permutations", min_keep=0.5)


# ---- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernels run only on the card")
    return torch.device("cuda")


CARD_SHAPES = [  # stage, W, Rr, P
    ("coarse", 20000, 1, 300),  # a scan stage: A = 11, whole-chromosome
    ("fine", 20000, 16, 200),  # a permutation chunk: A = 16, replicates
    ("fine", 3000, 1, 2000),  # short windows, many candidates
]


@pytest.mark.gpu
@pytest.mark.parametrize("stage, W, Rr, P", CARD_SHAPES)
def test_clr_lattice_kernel_matches_plain_on_card(stage, W, Rr, P):
    dev = _card()
    k = _kernel_inputs(31, W=W, Rr=Rr, P=P, A_rel=stage)
    k["hi"] = np.minimum(k["hi"] + (W // 2 if stage == "coarse" else 0),
                         W - 1).astype(np.int32)
    k["hi"][:3] = 0
    before = TL.lattice_clr_launches
    got = _port_clr(k, dev).cpu().numpy()
    want = _port_clr(k, dev, plain=True).cpu().numpy()
    assert TL.lattice_clr_launches == before + 1
    _, S = _ref(k["pack"], k["row"], k["pos"], k["null"], k["cand"],
                k["lo"], k["hi"], k["m_base"], k["m_rel"], k["G"])
    assert (np.abs(got - want) <= REL * S + ABS).all()
    assert not got[:, :3].any()


@pytest.mark.gpu
def test_clr_lattice_kernel_deterministic_on_card():
    dev = _card()
    k = _kernel_inputs(32, W=20000, Rr=4, P=300)
    a = _port_clr(k, dev)
    b = _port_clr(k, dev)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _tile_inputs(stage, seed=33):
    """Windows of many widths that cross each other, dummy candidates
    inside candidate tiles, W off every site tile."""
    k = _kernel_inputs(seed, W=3000 + 37, Rr=2, P=70, A_rel=stage)
    rng = np.random.default_rng(seed)
    W = k["pos"].shape[0]
    lo = rng.integers(0, W, 70)
    hi = np.minimum(lo + rng.choice([0, 1, 5, 200, 1200, W], 70), W - 1)
    lo[[0, 5, 17, 18, 40]], hi[[0, 5, 17, 18, 40]] = 1, 0
    k["lo"], k["hi"] = lo.astype(np.int32), hi.astype(np.int32)
    return k


def _sub(k, cands=None, reps=None):
    """Inputs cut to candidates and replicates (numpy index lists)."""
    k = dict(k)
    if reps is not None:
        k["row"], k["null"] = k["row"][reps], k["null"][reps]
        k["m_base"] = k["m_base"][reps]
    if cands is not None:
        for n in ("cand", "lo", "hi"):
            k[n] = k[n][cands]
        k["m_base"] = k["m_base"][:, cands]
    return k


def _bits(x):
    return x.cpu().view(torch.int32).numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_clr_lattice_kernel_tiles_on_card(stage):
    dev = _card()
    k = _tile_inputs(stage)
    got = _port_clr(k, dev)
    want = _port_clr(k, dev, plain=True).cpu().numpy()
    _, S = _ref(k["pack"], k["row"], k["pos"], k["null"], k["cand"],
                k["lo"], k["hi"], k["m_base"], k["m_rel"], k["G"])
    assert (np.abs(got.cpu().numpy() - want) <= REL * S + ABS).all()
    assert not got[:, [0, 5, 17, 18, 40]].any()
    # alone (P = 1, one candidate a block) and in other tiles: same bits
    for p in (1, 6, 16, 19, 41, 69):
        one = _port_clr(_sub(k, [p]), dev)
        np.testing.assert_array_equal(_bits(one[:, 0]), _bits(got[:, p]))
    odd = list(range(1, 70, 3))
    np.testing.assert_array_equal(_bits(_port_clr(_sub(k, odd), dev)),
                                  _bits(got[:, odd]))


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_clr_lattice_kernel_identity_replicate_on_card(stage):
    dev = _card()
    k = _kernel_inputs(34, W=20000, Rr=32, P=448, A_rel=stage)
    k["lo"] = np.zeros(448, np.int32)  # whole-chromosome windows
    k["hi"] = np.full(448, 19999, np.int32)
    k["lo"][:3], k["hi"][:3] = 1, 0
    k["m_base"][5] = k["m_base"][0]
    obs = dict(row=k["row"][5:6].copy(), null=k["null"][5:6].copy())
    many = _port_clr(k, dev)  # replicate 5 holds the observed attributes
    scan = _port_clr(dict(_sub(k, reps=[0]), **obs), dev)
    np.testing.assert_array_equal(_bits(many[5]), _bits(scan[0]))
    for p in (3, 200, 447):
        one = _port_clr(dict(_sub(k, [p], [0]), **obs), dev)
        np.testing.assert_array_equal(_bits(one[0, 0]), _bits(scan[0, p]))


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_clr_lattice_kernel_ignores_padding_on_card(stage):
    dev = _card()
    k = _tile_inputs(stage, seed=35)
    a = _port_clr(k, dev)
    b = _port_clr(k, dev, pack=_nan_padded(k, dev))
    np.testing.assert_array_equal(_bits(a), _bits(b))
    assert torch.isfinite(a).all()
