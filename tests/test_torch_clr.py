"""The CLR at arbitrary sweep strengths (fscl_tpu_torch/ops/clr.py)
against the JAX package (fscl_tpu/ops/clr.py).

Stated tolerances, S = 2 sum |y - null| over the contributing terms in
float64 (the float32 sums of the two packages run in different orders,
and XLA's CPU log differs from torch's by an ulp at ~1% of sites):
  * coarse_alpha_grid and fine_alpha_grids: bitwise against the jitted
    JAX function, as two_stage_alpha_max runs it (XLA's CPU build makes
    fstep a product with 1/15 and left + k*fstep one fused multiply-add;
    run op by op, JAX rounds each step alone);
  * clr_grid_plain against fscl_tpu's clr_grid (ragged chunks, chunk=3,
    on the JAX side), shared and paired alphas, grids 256 and 1024:
    |diff| <= 1e-5 S + 1e-4 per entry, off listed entries with a site
    whose x = log d + lalpha lies within 1e-3 of LOG_AD_MAX (a one-ulp
    difference of the two logs can take that site's whole term in or
    out); a candidate with lo > hi exactly 0 in both;
  * the exact-0 case of tests/test_ops.py (one site out of every alpha's
    reach): exactly 0;
  * two_stage_alpha_max: CLR within 1e-5 S + 1e-4, lalpha equal off
    listed near-ties (candidates whose best two of the 25 alphas, or of
    the 11 coarse ones, score within twice that tolerance of each other
    but not bitwise equal: at an exact tie, of alphas that mask every
    site or clamp every site to the grid's first cell, both packages take
    the first);
  * the port's clr_lattice_plain against clr_grid_plain at the lattice's
    own alphas: rtol 2e-4, atol 2e-3 (tests/test_lattice.py's tolerance
    for the JAX pair: the two interpolate at coordinates rounded apart);
  * two_stage_alpha_max on __graft_entry__'s flagship problem: as above;
  * windows that cross from one chromosome into the next (positions not
    sorted inside them): as clr_grid_plain above;
  * the slice plan (clr_grid_plan): every live window's slices once,
    exactly; over ascending alphas the mask is a prefix, exactly; the
    work that chip_smoke.py's clr_grid bound counts: a count term by
    term, exactly;
  * on the card (marker ``gpu``): the kernel against its plain version
    within 1e-5 S + 1e-4 at A = 1, 11, 14, 17 and 33, shared and paired,
    on a long chromosome, a sub-wave grid, two chromosomes side by side
    and the flagship problem, with lo > hi candidates exactly 0; two
    launches bitwise equal; candidates launched alone bitwise equal to
    their entries.

This file imports nothing of tests/: on the card machine such imports do
not collect.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fscl_tpu.ops.clr as JC
import fscl_tpu_torch.ops.clr as TC
import fscl_tpu_torch.ops.lattice as TL
from fscl_tpu_torch.convert import clr_inputs_from_numpy
from fscl_tpu import LOG_AD_MAX
from fscl_tpu.models import build_tables
from fscl_tpu.ops.windows import candidate_windows

REL, ABS = 1e-5, 1e-4  # |diff| <= REL * S + ABS
EDGE = 1e-3  # mask-edge band in log units (a log ulp is ~1e-6 there)


def _mk_data(seed=0, n_sites=400, n=12, span=2_000_000, grid_points=256):
    """tests/test_ops.py's dataset: sites, their table rows and nulls."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(span, size=n_sites, replace=False)).astype(
        np.int64)
    w = 1 / np.arange(1, n)
    w /= w.sum()
    freqs = rng.choice(np.arange(1, n), p=w, size=n_sites)
    folded = rng.random(n_sites) < 0.4
    freqs = np.where(folded, np.minimum(freqs, n - freqs), freqs)
    depth_p = np.zeros(n_sites, int)
    fsp = np.zeros(n + 1)
    hist = np.bincount(freqs, minlength=n + 1).astype(float)
    fsp[1:n] = hist[1:n] + 1.0
    fsp /= fsp.sum()
    tables = build_tables([fsp], [n], grid_points=grid_points)
    row = tables.site_rows(depth_p, folded, freqs).astype(np.int32)
    null = tables.null_logl(depth_p, folded, freqs).astype(np.float32)
    return tables, pos.astype(np.int32), row, null


def _inputs(seed, G, P=60, er=80):
    """Candidates at random points, on sites and past the chromosome's
    ends, windows of +-er sites, the last two padded (lo = 1, hi = 0)."""
    tables, pos, row, null = _mk_data(seed=seed, grid_points=G)
    rng = np.random.default_rng(seed + 100)
    cand = np.concatenate([rng.integers(-50_000, 2_100_000, P - 6),
                           pos[[0, 5, 200, 399]]]).astype(np.int32)
    _, lo, hi = candidate_windows(pos, cand, er)
    lo, hi = lo.astype(np.int32), hi.astype(np.int32)
    lo[-2:], hi[-2:] = 1, 0
    return tables, pos, row, null, cand, lo, hi


def _alphas(seed, P, paired):
    rng = np.random.default_rng(seed + 200)
    if paired:
        return rng.uniform(-21, 5, size=(P, 9)).astype(np.float32)
    return np.concatenate([JC.coarse_alpha_grid(),
                           rng.uniform(-21, 5, 4)]).astype(np.float32)


def _ref(tables, pos, row, null, cand, lo, hi, la):
    """float64 numpy (S, edge) [P, A]: S = 2 sum |y - null| over the
    contributing terms, the coordinates in float32 as both packages take
    them; edge marks entries with a site within EDGE of the mask's edge."""
    G = tables.grid_points
    tbl = tables.table.reshape(-1).astype(np.float64)
    inv = np.float32((G - 1) / 24.0)
    P = len(cand)
    la = np.broadcast_to(la, (P, la.shape[-1]))
    S = np.zeros(la.shape)
    edge = np.zeros(la.shape, bool)
    for p in range(P):
        if lo[p] > hi[p]:
            continue
        w = np.arange(lo[p], hi[p] + 1)
        logd = np.log(np.maximum(np.abs(pos[w].astype(np.int64) - cand[p]),
                                 1).astype(np.float32))
        x = (logd[:, None] + la[p][None]).astype(np.float32)
        u = ((x + np.float32(20)) * inv).astype(np.float32)
        i = np.clip(u.astype(np.int32), 0, G - 2)
        frac = np.clip(u - i.astype(np.float32), 0, 1).astype(np.float64)
        b = row[w][:, None] * G + i
        y = tbl[b] * (1 - frac) + tbl[b + 1] * frac
        c = np.where(x <= LOG_AD_MAX, y - null[w][:, None], 0.0)
        S[p] = 2 * np.abs(c).sum(0)
        edge[p] = (np.abs(x - LOG_AD_MAX) < EDGE).any(0)
    return S, edge


def _jax_clr(tables, pos, row, null, cand, lo, hi, la, paired):
    return np.asarray(JC.clr_grid(
        jnp.asarray(tables.table.reshape(-1)), jnp.asarray(row),
        jnp.asarray(pos), jnp.asarray(null), jnp.asarray(cand),
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(la),
        grid_points=tables.grid_points, chunk=3, paired_alpha=paired))


def _port_args(tables, pos, row, null, cand, lo, hi, dev="cpu"):
    return [*clr_inputs_from_numpy(tables.table, row, pos, null, device=dev),
            *(torch.as_tensor(x, device=dev) for x in (cand, lo, hi))]


def test_alpha_grids_bitwise():
    np.testing.assert_array_equal(TC.coarse_alpha_grid(),
                                  JC.coarse_alpha_grid())
    rng = np.random.default_rng(5)
    best = np.concatenate([JC.coarse_alpha_grid(),
                           rng.uniform(-20, 4, 3000)]).astype(np.float32)
    want = np.asarray(jax.jit(JC.fine_alpha_grids)(jnp.asarray(best)))
    got = TC.fine_alpha_grids(torch.as_tensor(best)).numpy()
    assert got.dtype == np.float32 and got.shape == (len(best), TC.N_FINE)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("G", [256, 1024])
@pytest.mark.parametrize("paired", [False, True])
def test_clr_grid_plain_matches_jax(G, paired):
    k = _inputs(7 + G, G)
    la = _alphas(G, len(k[4]), paired)
    want = _jax_clr(*k, la, paired)
    tables, pos, row, null, cand, lo, hi = k
    got = TC.clr_grid(tables.table.reshape(-1), row, pos, null, cand, lo,
                      hi, la, grid_points=G, paired_alpha=paired,
                      device="cpu").numpy()
    plain = TC.clr_grid_plain(*_port_args(*k), torch.as_tensor(la),
                              grid_points=G, paired_alpha=paired).numpy()
    np.testing.assert_array_equal(got, plain)
    S, edge = _ref(*k, la)
    assert got.shape == want.shape and got.dtype == np.float32
    print("mask-edge entries (candidate, alpha):",
          list(zip(*np.nonzero(edge))))
    assert edge.mean() < 0.05
    assert (np.abs(got - want) <= REL * S + ABS)[~edge].all()
    assert not got[-2:].any() and not want[-2:].any()


def test_clr_grid_exact_zero():
    """tests/test_ops.py's case: one window of three sites, none within
    e^(4 - 3.9) bp of the candidate, gives exactly 0 (and a padded
    candidate beside it, too)."""
    tables, pos, row, null = _mk_data(n_sites=50)
    cand = np.array([pos[25], pos[25]], np.int32)
    lo, hi = np.array([30, 1], np.int32), np.array([32, 0], np.int32)
    la = np.array([3.9], np.float32)
    want = _jax_clr(tables, pos, row, null, cand, lo, hi, la, False)
    got = TC.clr_grid(tables.table.reshape(-1), row, pos, null, cand, lo,
                      hi, la, grid_points=tables.grid_points,
                      device="cpu").numpy()
    assert want[0, 0] == 0.0
    np.testing.assert_array_equal(got, np.zeros((2, 1), np.float32))


def _check_two_stage(tables, pos, row, null, cand, lo, hi, chunk):
    """The port's two_stage_alpha_max on the CPU against fscl_tpu's (JAX
    chunk ``chunk``): CLR within REL * S + ABS off mask-edge entries,
    lalpha equal off near-ties."""
    G = tables.grid_points
    tf = jnp.asarray(tables.table.reshape(-1))
    jargs = [jnp.asarray(x) for x in (row, pos, null, cand, lo, hi)]
    w_clr, w_la = (np.asarray(v) for v in JC.two_stage_alpha_max(
        tf, *jargs, grid_points=G, chunk=chunk))
    g_clr, g_la = (v.numpy() for v in TC.two_stage_alpha_max(
        tables.table.reshape(-1), row, pos, null, cand, lo, hi,
        grid_points=G, device="cpu"))
    assert g_clr.dtype == g_la.dtype == np.float32
    # the JAX package's 25 values per candidate, for S and the near-ties
    coarse = JC.coarse_alpha_grid()
    c = _jax_clr(tables, pos, row, null, cand, lo, hi, coarse, False)
    fine = np.asarray(jax.jit(JC.fine_alpha_grids)(
        jnp.asarray(coarse[c.argmax(1)])))
    f = _jax_clr(tables, pos, row, null, cand, lo, hi, fine, True)
    la_all = np.concatenate([np.broadcast_to(coarse, c.shape), fine], 1)
    j = np.argmax(np.concatenate([c, f], 1), 1)
    S, edge = _ref(tables, pos, row, null, cand, lo, hi,
                   la_all[np.arange(len(j)), j][:, None])
    tol = REL * S[:, 0] + ABS
    ok = np.abs(g_clr - w_clr) <= tol
    assert ok[~edge[:, 0]].all()

    def close(v):  # best two within 2 tol, not bitwise equal: an exact
        s = np.sort(v, 1)  # tie picks the first in both packages
        g = s[:, -1] - s[:, -2]
        return (g > 0) & (g <= 2 * tol)

    near = close(c) | close(np.concatenate([c, f], 1))
    live = lo <= hi
    print("near-tie candidates:", list(np.nonzero(near & live)[0]))
    assert (near & live).mean() < 0.1
    np.testing.assert_array_equal(g_la[~near], w_la[~near])


@pytest.mark.parametrize("G", [256, 1024])
def test_two_stage_alpha_max_matches_jax(G):
    _check_two_stage(*_inputs(11 + G, G, P=80), chunk=3)


def test_two_stage_alpha_max_flagship_problem():
    """__graft_entry__'s flagship forward step (2,048 sites, n = 24, 64
    candidates 31 kb apart, windows of +-600 sites, grid 512) through both
    packages, at its own JAX chunk of 8."""
    import __graft_entry__ as g

    _check_two_stage(*g._example_problem(), chunk=8)


def test_clr_lattice_plain_matches_clr_grid_plain():
    """As tests/test_lattice.py holds the JAX pair: the lattice CLR at its
    coarse offsets against the CLR at the lattice's alphas."""
    tables, pos, row, null = _mk_data(seed=2)
    G = tables.grid_points
    cand = np.array([111_111, 777_777, 1_500_000, pos[40]], np.int32)
    _, lo, hi = candidate_windows(pos, cand, 90)
    m = TL.coarse_lattice_offsets(G)
    la = (-20.0 + m * TL.lattice_step(G)).astype(np.float32)
    t = [torch.as_tensor(np.ascontiguousarray(x)) for x in (
        row, pos, null, cand, lo.astype(np.int32), hi.astype(np.int32))]
    pack = torch.as_tensor(TL.build_lattice_pack(tables.table, m))
    got = TL.clr_lattice_plain(
        pack, t[0][None], t[1], t[2][None], *t[3:],
        torch.zeros((1, 4), dtype=torch.int32), torch.as_tensor(m),
        grid_points=G)[0].numpy()
    want = TC.clr_grid_plain(torch.as_tensor(tables.table.reshape(-1)),
                             *t, torch.as_tensor(la),
                             grid_points=G).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


def test_clr_grid_refuses_bad_shapes():
    tables, pos, row, null, cand, lo, hi = _inputs(3, 256, P=10)
    with pytest.raises(ValueError, match="clr_grid"):
        TC.clr_grid(tables.table.reshape(-1), row, pos, null, cand, lo,
                    hi, np.zeros((10, 3), np.float32), grid_points=256,
                    device="cpu")  # [P, A] alphas without paired_alpha
    with pytest.raises(ValueError, match="clr_grid"):
        TC.clr_grid(tables.table.reshape(-1)[:-1], row, pos, null, cand, lo,
                    hi, np.zeros(3, np.float32), grid_points=256,
                    device="cpu")


@pytest.mark.parametrize("fault", ["lo < 0", "hi >= W", "row >= R",
                                   "row < 0"])
def test_clr_grid_refuses_reads_outside_the_inputs(fault):
    """A live window outside [0, W) or a row outside [0, R) raises on the
    CPU as on the card, where the kernel would read past the arrays; a
    padded candidate (lo > hi) may hold any lo and hi."""
    tables, pos, row, null, cand, lo, hi = _inputs(4, 256, P=10)
    W, R = len(pos), tables.table.shape[0]
    lo, hi, row = lo.copy(), hi.copy(), row.copy()
    lo[-1], hi[-1] = W + 7, -3  # padded: accepted
    args = lambda: (tables.table.reshape(-1), row, pos, null, cand, lo, hi,
                    np.zeros(3, np.float32))
    TC.clr_grid(*args(), grid_points=256, device="cpu")
    if fault == "lo < 0":
        lo[0] = -1
    elif fault == "hi >= W":
        hi[0] = W
    else:
        row[5] = R if fault == "row >= R" else -1
    with pytest.raises(ValueError, match="clr_grid"):
        TC.clr_grid(*args(), grid_points=256, device="cpu")


def _two_chromosomes(seed, P=70, er=40, split=200):
    """_mk_data's 400 sites as two chromosomes (positions restart at the
    split), candidates on both, each window inside its chromosome: groups
    of 32 consecutive candidates straddle the two."""
    tables, pos, row, null = _mk_data(seed=seed)
    pos = pos.copy()
    pos[split:] -= pos[split] - 1_000
    rng = np.random.default_rng(seed + 300)
    c1 = np.sort(rng.integers(0, int(pos[split - 1]), P // 2))
    c2 = np.sort(rng.integers(0, int(pos[-1]), P - P // 2))
    _, lo1, hi1 = candidate_windows(pos[:split], c1, er)
    _, lo2, hi2 = candidate_windows(pos[split:], c2, er)
    cand = np.concatenate([c1, c2]).astype(np.int32)
    lo = np.concatenate([lo1, lo2 + split]).astype(np.int32)
    hi = np.concatenate([hi1, hi2 + split]).astype(np.int32)
    lo[3], hi[3] = 1, 0
    return tables, pos, row, null, cand, lo, hi


@pytest.mark.parametrize("paired", [False, True])
def test_clr_grid_windows_across_chromosomes_match_jax(paired):
    """Windows that run from one chromosome into the next (the positions
    restart inside them): the port's clr_grid on the CPU against
    fscl_tpu's, as test_clr_grid_plain_matches_jax holds them."""
    k = list(_two_chromosomes(11 + paired))
    lo, hi = k[5].copy(), k[6].copy()
    cross = [0, 1, 2, 4, 5, 6]  # candidate 3 stays padded
    lo[cross] = [150, 190, 199, 0, 120, 180]
    hi[cross] = [250, 210, 200, 399, 399, 260]
    k[5], k[6] = lo, hi
    la = _alphas(3, len(k[4]), paired)
    want = _jax_clr(*k, la, paired)
    tables, pos, row, null, cand, lo, hi = k
    got = TC.clr_grid(tables.table.reshape(-1), row, pos, null, cand, lo,
                      hi, la, grid_points=tables.grid_points,
                      paired_alpha=paired, device="cpu").numpy()
    S, edge = _ref(*k, la)
    assert got.shape == want.shape and edge.mean() < 0.05
    assert (np.abs(got - want) <= REL * S + ABS)[~edge].all()
    assert not got[3].any() and not want[3].any()


def _work_by_term(pos, cand, lo, hi, la, ta):
    """chip_smoke._cg_terms' counts, one term at a time in numpy: pairs,
    reached (some alpha inside the mask), inside, terms, masked (a
    reached pair's terms outside the mask that the kernel tests: per tile
    of ta alphas, the first where the tile ascends, else all)."""
    n = dict(pairs=0, reached=0, inside=0, terms=0, masked=0)
    P, A = len(cand), la.shape[-1]
    la = np.broadcast_to(la, (P, A))
    for p in range(P):
        for w in range(lo[p], hi[p] + 1):
            d = max(abs(int(pos[w]) - int(cand[p])), 1)
            logd = torch.log(torch.tensor(float(d))).numpy()
            x = logd + la[p]  # float32, as the kernel adds
            n["pairs"] += 1
            n["terms"] += A
            n["inside"] += int((x <= LOG_AD_MAX).sum())
            if not (x <= LOG_AD_MAX).any():
                continue
            n["reached"] += 1
            for t in range(0, A, ta):
                tile = la[p, t:t + ta]
                up = bool((tile[1:] >= tile[:-1]).all())
                for v in x[t:t + ta]:
                    if not v <= LOG_AD_MAX:
                        n["masked"] += 1
                        if up:
                            break
    return n


@pytest.mark.parametrize("A, paired", [(1, True), (11, False), (14, True),
                                       (17, True), (33, False)])
@pytest.mark.parametrize("order", ["ascending", "random"])
def test_cg_terms_counts_the_needed_work(A, paired, order):
    """chip_smoke.py's clr_grid bound counts the work the inputs need:
    its pairs, reached pairs, terms inside the mask and masked terms
    tested equal a count term by term, over one chromosome with padded
    candidates, at ascending alphas (the kernel stops a pair at its
    first masked one) and at random ones (it tests them all)."""
    import chip_smoke as cs

    tables, pos, row, null, cand, lo, hi = _inputs(A + 3, 256, P=40)
    rng = np.random.default_rng(A + 31 * paired)
    la = rng.uniform(-21, 5, size=(len(cand), A) if paired else (A,))
    if order == "ascending":
        la = np.sort(la, axis=-1)
    la = la.astype(np.float32)
    args = _port_args(tables, pos, row, null, cand, lo, hi)
    got = cs._cg_terms(args, torch.as_tensor(la), paired)
    want = _work_by_term(pos, cand, lo, hi, la, TC.TILE_ALPHAS)
    assert {k: got[k] for k in want} == want
    assert want["masked"] > 0 or A == 1
    assert got["ops"] == (cs.CG_OPS_PAIR * want["reached"]
                          + cs.CG_OPS_TERM * want["inside"]
                          + cs.CG_OPS_MASKED * want["masked"])
    assert got["ops"] <= got["ops_old"]


@pytest.mark.parametrize("group, T", [(32, 1024), (32, 32), (8, 64),
                                      (8, 1024)])
def test_clr_grid_plan_covers_every_window_once(group, T):
    """The slice plan: the kernel's blocks (group g, j < group slices)
    take slice first_g + j; each live candidate's slices k = s - lo // T
    come out exactly once each, for k in [0, hi // T - lo // T], all
    below the scratch's slice count, and both counts are the least that
    do; padded candidates get none."""
    rng = np.random.default_rng(group + T)
    P, W = 150, 5000
    lo = rng.integers(0, W, P)
    hi = np.minimum(lo + rng.integers(-20, 900, P), W - 1)
    lo[rng.choice(P, 9, replace=False)] = 7  # padded or short
    per, span = TC.clr_grid_plan(lo.astype(np.int32), hi.astype(np.int32),
                                 group, T)
    live = lo <= hi
    seen = {}
    need_span = 0
    for g0 in range(0, P, group):
        mem = [p for p in range(g0, min(g0 + group, P)) if live[p]]
        if not mem:
            continue
        first = min(lo[p] // T for p in mem)
        last = max(hi[p] // T for p in mem)
        need_span = max(need_span, last - first + 1)
        for j in range(span):
            s = first + j
            if s > last:
                break
            for p in mem:
                if lo[p] // T <= s <= hi[p] // T:
                    k = s - lo[p] // T
                    assert 0 <= k < per
                    seen[(p, k)] = seen.get((p, k), 0) + 1
    want = {(p, k) for p in range(P) if live[p]
            for k in range(hi[p] // T - lo[p] // T + 1)}
    assert set(seen) == want and set(seen.values()) == {1}
    assert span == need_span
    assert per == max(hi[p] // T - lo[p] // T + 1
                      for p in range(P) if live[p])


@pytest.mark.parametrize("grids", ["coarse", "fine", "random"])
def test_ascending_alphas_mask_a_prefix(grids):
    """Lever (g): over ascending alphas (the coarse grid, fine grids
    around every coarse winner, random sorted ones) the mask x = logf(d)
    + lalpha <= LOG_AD_MAX holds up to some alpha and fails from there on,
    at every distance from 1 bp to 2^31, so stopping a pair at its first
    alpha outside the mask skips only masked terms."""
    rng = np.random.default_rng(17)
    d = np.unique(np.concatenate([
        np.arange(1, 5000), rng.integers(1, 2**31 - 1, 200_000),
        np.round(np.exp(np.linspace(0, 21.4, 20_000)))]).astype(np.int64))
    logd = torch.log(torch.as_tensor(d.astype(np.float32)))
    coarse = TC.coarse_alpha_grid()
    if grids == "coarse":
        las = [coarse]
    elif grids == "fine":
        las = TC.fine_alpha_grids(torch.as_tensor(coarse)).numpy()
    else:
        las = np.sort(rng.uniform(-21, 5, (20, 16)), 1)
    for la in las:
        x = logd[:, None] + torch.as_tensor(la.astype(np.float32))[None]
        m = (x <= LOG_AD_MAX).numpy()
        assert not (m[:, 1:] & ~m[:, :-1]).any()  # no False then True


# ---- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _card_inputs(seed, A, paired, n_sites=20000, P=700, er=5000):
    """A long chromosome at grid 2048, candidates 1 kb apart over it and
    at random, windows of +-er sites, 5 padded candidates; A alphas over
    [-21, 5], shared or paired."""
    tables, pos, row, null = _mk_data(seed=seed, n_sites=n_sites, n=30,
                                      span=20_000_000, grid_points=2048)
    rng = np.random.default_rng(seed)
    cand = np.concatenate([np.arange(P // 2) * 1000 + 5_000_000,
                           rng.integers(0, 20_000_000, P - P // 2)])
    cand = cand.astype(np.int32)
    _, lo, hi = candidate_windows(pos, cand, er)
    lo, hi = lo.astype(np.int32), hi.astype(np.int32)
    pad = rng.choice(P, 5, replace=False)
    lo[pad], hi[pad] = 1, 0
    shape = (P, A) if paired else (A,)
    la = rng.uniform(-21, 5, size=shape).astype(np.float32)
    return (tables, pos, row, null, cand, lo, hi), la, pad


def _shape_inputs(shape, A, paired):
    """(inputs, alphas, padded) at one of the card tests' shapes: the long
    chromosome of _card_inputs; a sub-wave grid (64 candidates, +-1000
    sites: a few dozen blocks); two chromosomes side by side, groups of
    32 straddling them; __graft_entry__'s flagship problem (64
    candidates 31 kb apart, +-600 of 2,048 sites, grid 512)."""
    if shape == "chromosome":
        return _card_inputs(40 + A, A, paired)
    rng = np.random.default_rng(A)
    if shape == "subwave":
        k, la, pad = _card_inputs(50 + A, A, paired, P=64, er=1000)
        return k, la, pad
    if shape == "two_chromosomes":
        k = _two_chromosomes(A, P=120, er=90)
        pad = np.array([3])
    else:
        import __graft_entry__ as g

        k = g._example_problem()
        pad = np.array([], np.int64)
    P = len(k[4])
    la = rng.uniform(-21, 5, size=(P, A) if paired else (A,))
    return k, la.astype(np.float32), pad


@pytest.mark.gpu
@pytest.mark.parametrize("A, paired", [(1, True), (11, False), (14, True),
                                       (17, False), (33, True)])
@pytest.mark.parametrize("shape", ["chromosome", "subwave",
                                   "two_chromosomes", "flagship"])
def test_clr_grid_kernel_matches_plain_on_card(A, paired, shape):
    dev = _card()
    k, la, pad = _shape_inputs(shape, A, paired)
    args = _port_args(*k, dev=dev)
    la_t = torch.as_tensor(la, device=dev)
    G = k[0].grid_points
    before = TC.clr_grid_launches
    got = TC.clr_grid(*args, la_t, grid_points=G, paired_alpha=paired,
                      device=dev)
    assert TC.clr_grid_launches == before + 2  # slice sums, their sum
    want = TC.clr_grid_plain(*args, la_t, grid_points=G,
                             paired_alpha=paired)
    S = torch.as_tensor(_ref(*k, la)[0], device=dev)
    torch.cuda.synchronize()
    assert got.shape == (len(k[4]), A)
    assert bool(((got - want).abs().double() <= REL * S + ABS).all())
    assert not bool(got[torch.as_tensor(pad, device=dev)].any())


@pytest.mark.gpu
@pytest.mark.parametrize("A", [11, 17])
def test_clr_grid_kernel_bitwise_repeat_and_c1_on_card(A):
    """Repeat calls bitwise equal; every 7th candidate launched alone, and
    one candidate alone, give their entries' bits (the sum order depends
    on the window alone, not on the candidates sharing a launch)."""
    dev = _card()
    k, la, _ = _card_inputs(60 + A, A, False)
    args = _port_args(*k, dev=dev) + [torch.as_tensor(la, device=dev)]
    G = k[0].grid_points
    a = TC.clr_grid(*args, grid_points=G, device=dev)
    b = TC.clr_grid(*args, grid_points=G, device=dev)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for sub in (torch.arange(0, len(k[4]), 7, device=dev),
                torch.tensor([len(k[4]) // 2], device=dev)):
        cut = args[:4] + [t[sub].contiguous() for t in args[4:7]] + args[7:]
        alone = TC.clr_grid(*cut, grid_points=G, device=dev)
        torch.cuda.synchronize()
        assert torch.equal(alone.view(torch.int32),
                           a[sub].view(torch.int32))
