"""The block-permutation stream past the old 16,384-block cap, and the
host side of its kernel (fscl_tpu_torch/ops/permute.py: the block-start
brackets and the launch plan of csrc/replicate_runs.cu), on the CPU.

Stated tolerances:
  * the port's plain stream equals fscl_tpu's bit for bit at about
    20,000 shuffled blocks (two sort rounds), in both forms (sigma and
    runs);
  * every replicate's block starts lie inside the per-genome brackets
    (block_start_brackets), at phase 0, the largest float32 phase below
    the width, the width itself and the phases of drawn replicates, on
    genomes with empty blocks, a partial tail group, one group, and
    coordinates past 2^24;
  * the launch plan satisfies the kernel's own checks
    (fscl_replicate_runs) at the main path's shapes and at B = 1, 2, 31,
    32, 33, 16,384 and 16,385.

This file imports nothing of tests/.
"""

import numpy as np
import pytest
import torch

import jax

import fscl_tpu.ops.permute as JO
import fscl_tpu_torch.ops.permute as TO


def _gpos(kind):
    rng = np.random.default_rng(23)
    if kind == "many":  # 100,000 sites over ~3 Mb: 3,125 groups
        return np.cumsum(rng.integers(1, 60, 100_000)).astype(np.int64)
    if kind == "gaps":  # empty blocks, a partial tail group (W % 32 != 0)
        parts = [np.sort(rng.choice(np.arange(a, a + 800_000), 900,
                                    replace=False))
                 for a in (0, 3_000_000, 3_900_000, 9_000_000)]
        return np.concatenate(parts)[:3_583].astype(np.int64)
    if kind == "one group":
        return np.sort(rng.choice(5_000_000, 20, replace=False))
    # genome-scale coordinates: float32 rounds the group positions
    return np.sort(rng.choice(900_000_000, 20_000, replace=False)) + 7


@pytest.mark.parametrize("seed, start", [(3, 5), (2**31 - 1, 2**32 - 2)])
def test_plain_stream_past_the_old_cap_matches_fscl_tpu(seed, start):
    g = _gpos("many")
    width, n = 150.0, 3
    span = int(g[-1] - g[0])
    B = TO.n_blocks_for(span, width) - 1
    assert 16_384 < B < 25_000 and TO.shuffle_rounds(B) == 2
    key = jax.random.key(seed)
    sig_j = np.asarray(JO.block_permutation_groups(key, g, width, n,
                                                   start=start))
    runs_j = [np.asarray(x) for x in JO.block_permutation_runs(
        key, g, width, n, start=start)]
    sig_t = TO.block_permutation_groups(seed, g, width, n, start=start,
                                        device="cpu").numpy()
    runs_t = [x.numpy() for x in TO.block_permutation_runs(
        seed, g, width, n, start=start, device="cpu")]
    np.testing.assert_array_equal(sig_t, sig_j)
    for a, b in zip(runs_t, runs_j):
        np.testing.assert_array_equal(a, b)
    assert runs_t[0].shape == (n, B + 1)


def _starts_at(g0f, nb, width, phase):
    """Block starts [nb + 1] at one float32 phase, in the plain version's
    arithmetic."""
    inv_w = torch.tensor(np.float32(1) / np.float32(width))
    block = ((g0f + torch.tensor(np.float32(phase))) * inv_w).to(
        torch.int64).clamp(0, nb - 2)
    block[-1] = nb - 1
    return torch.searchsorted(block, torch.arange(nb + 1), side="left")


def _drawn_phases(seed, n, width):
    """The phases of replicates 0..n-1 (replicate_runs_plain's draw)."""
    k0, k1 = TO.seed_key(seed)
    key = torch.stack(TO.threefry2x32(k0, k1, 0, torch.arange(n)), 1)
    k_phase = TO._split(key)[0]
    fb = (TO._bits32(k_phase, 1)[:, 0] >> 9) | 0x3F800000
    return (fb.to(torch.int32).view(torch.float32) - 1.0) * torch.tensor(
        np.float32(width))


@pytest.mark.parametrize("kind, width, nb", [
    ("genome", 1e6, None), ("genome", 3e4, None), ("gaps", 3e5, None),
    ("gaps", 1e3, 600), ("many", 150.0, None), ("many", 1500.0, 5),
    ("one group", 1e5, None)])
def test_block_start_brackets_contain_every_phase(kind, width, nb):
    g = _gpos(kind)
    g0, span = TO._group_first_positions(g)
    g0f = torch.as_tensor(g0.astype(np.float32))
    nb = nb or TO.n_blocks_for(span, width)
    w = TO.effective_block_width(span, width)
    lo, hi = TO.block_start_brackets(g0f, nb, w)
    assert lo.dtype == hi.dtype == torch.int32
    assert lo.shape == hi.shape == (nb + 1,)
    assert int(lo[0]) == 0 and int(lo[nb]) == int(hi[nb]) == len(g0)
    w32 = np.float32(w)
    phases = [np.float32(0), np.nextafter(w32, np.float32(0)), w32,
              *_drawn_phases(11, 64, w).tolist()]
    rng = np.random.default_rng(2)
    phases += list((rng.random(32, dtype=np.float32) * w32).astype(
        np.float32))
    empty = 0
    for ph in phases:
        st = _starts_at(g0f, nb, w, ph)
        assert bool((lo <= st).all() and (st <= hi).all()), ph
        empty += int((st[1:] == st[:-1]).sum())
    if kind == "gaps":
        assert empty > 0  # blocks without a group
    # the pinned tail group is its own block at every phase
    assert int(_starts_at(g0f, nb, w, w32)[nb - 1]) == len(g0) - 1


SHAPES = [  # (n, G, nb): the main path's chunks, then step 3's others
    (32, 625, 22), (2048, 24_304, 1003), (16, 24_304, 1003),
    (16, 131_060, 122), (256, 24_304, 33_369), (16, 24_304, 33_369)]
B_EDGES = [1, 2, 31, 32, 33, 16_384, 16_385]


def _check_plan(plan, n, G, nb, sigma):
    """The checks fscl_replicate_runs makes before it launches."""
    B = nb - 1
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    P = 32
    while P < B:
        P <<= 1
    assert plan.P == P  # the kernel's own radix-sort buckets
    assert plan.tiles >= 1 and plan.tile_len >= 1
    assert plan.tiles * plan.tile_len >= G
    assert (plan.tiles - 1) * plan.tile_len < G  # no empty tile
    assert 0 <= plan.shift <= 30
    assert 1 <= plan.grid <= n * plan.tiles
    nbytes = TO.replicate_runs_bytes(plan.P, nb,
                                     (plan.tile_len >> plan.shift) + 2)
    if plan.on_global:
        assert plan.tiles == 1 and plan.threads == TO.GLOBAL_THREADS
        assert plan.slot_bytes >= nbytes and plan.smem_bytes == 0
        assert plan.grid * plan.slot_bytes <= max(TO.SCRATCH_MAX,
                                                  plan.slot_bytes)
    else:
        assert plan.slot_bytes == 0
        assert plan.smem_bytes == nbytes <= TO.SMEM_MAX
        assert plan.grid == n * plan.tiles
    if not sigma:
        assert plan.tiles == 1


@pytest.mark.parametrize("sigma", [True, False])
@pytest.mark.parametrize("n, G, nb", SHAPES)
def test_launch_plan_is_valid_at_the_main_shapes(n, G, nb, sigma):
    _check_plan(TO.plan_replicate_runs(n, G, nb, sigma), n, G, nb, sigma)


@pytest.mark.parametrize("sigma", [True, False])
@pytest.mark.parametrize("B", B_EDGES)
def test_launch_plan_is_valid(B, sigma):
    for n in (1, 16, 2048):
        for G in (1, 100, 24_304):
            _check_plan(TO.plan_replicate_runs(n, G, B + 1, sigma), n, G,
                        B + 1, sigma)


def test_launch_plan_fills_the_card_at_small_chunks():
    """The CLI's 16-replicate chunks split each sigma row into tiles (at
    least BLOCKS_PER_SM blocks an SM, or tiles of TILE_MIN groups); the
    deep tail's 2,048 replicates need none; past shared memory the sort
    goes to global scratch in one tile."""
    p = TO.plan_replicate_runs(16, 24_304, 1003, True)
    assert p.tiles == -(-24_304 // TO.TILE_MIN) and not p.on_global
    p = TO.plan_replicate_runs(16, 131_060, 122, True)
    assert p.tiles * 16 >= TO.BLOCKS_PER_SM * 132 and p.shift == 10
    p = TO.plan_replicate_runs(2048, 24_304, 1003, True)
    assert p.tiles == 1 and p.grid == 2048 and not p.on_global
    p = TO.plan_replicate_runs(32, 625, 22, True)
    assert p.P == 32 and p.tiles == 1 and not p.on_global
    assert TO.plan_replicate_runs(32, 625, 34, True).P == 64
    p = TO.plan_replicate_runs(256, 24_304, 33_369, True)
    assert p.on_global and p.grid == 256 and p.tiles == 1
    assert not TO.plan_replicate_runs(8, 3125, 8193, True).on_global
    assert TO.plan_replicate_runs(8, 3125, 8194, True).on_global
