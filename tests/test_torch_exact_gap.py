"""The 20k task's reported CLRs against the exact CLR, in both packages.

fscl_tpu/engine/scan.py (ScanConfig.tie_decimate) states that the
decimate-2 tie stage reports CLRs about 0.05 from the exact value at the
reported position and lalpha.  chip_smoke.py phase 4e measures the
port's gap on the card.  This test runs the JAX package's scan on the
CPU and the port's on the card on the same data (bench/data/
bench_20k.sf, tables at grid 2048 with the compat mirror, -g 1000 -G
100000, the selection stages in float32 on both sides so that both tie
pools hold the same candidates), and for each package:

  * at = its clr_grid at its reported positions and lalpha (A = 1
    paired, the C-parity oracle's call, tests/test_parity.py);
  * exact = its two_stage_alpha_max at its reported positions;

and prints |reported - at| and |reported - exact| (max, mean, 99th
percentile) for both as one JSON line.  Stated tolerances, at the
points whose JAX tie-stage winner beats its runner-up by more than 1e-3
(tests/test_torch_slice.py's rule; at least half of them):
  * positions and lalpha equal, reported CLRs within 1e-3 (the tie
    stage's float32 sums run in different orders on the two devices);
  * each point's |reported - at| equal in both packages within 2e-3
    (the reported CLRs' 1e-3 and the two clr_grid's float32 sums over
    the whole 20,000-site chromosome), so the gap is the JAX package's
    own and not the port's.

Marked gpu: the port's scan at this size runs on the card (the plain
versions would take minutes on the CPU).  The JAX side runs on the
card machine's CPU.  This file imports nothing of tests/.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fscl_tpu.engine.scan as JS
import fscl_tpu.ops.clr as JC
from fscl_tpu.io import load_snp_input as j_load
from fscl_tpu.models import background_fsp as j_fsp
from fscl_tpu.models import build_tables as j_tables
from fscl_tpu.ops.windows import candidate_windows
from fscl_tpu_torch.engine.scan import ScanConfig, scan_genome
from fscl_tpu_torch.io import load_snp_input
from fscl_tpu_torch.models import background_fsp, build_tables
from fscl_tpu_torch.ops import clr as TC

REPO = pathlib.Path(__file__).resolve().parents[1]
SF = REPO / "bench" / "data" / "bench_20k.sf"
G = 2048
SCAN = dict(small_grid_sp=1000, large_grid_sp=100000, selection_bf16=False)
CLR_TOL = 1e-3
GAP_TOL = 2e-3


def _stats(x):
    x = np.abs(x)
    return dict(max=float(x.max()), mean=float(x.mean()),
                p99=float(np.percentile(x, 99)))


def _windows(data, result, eval_range):
    assert len(data.chr_limits) == 1  # one chromosome: site = array index
    _, lo, hi = candidate_windows(np.asarray(data.pos), result.sweep_pos,
                                  eval_range)
    return (result.sweep_pos.astype(np.int32), lo.astype(np.int32),
            hi.astype(np.int32))


def _jax_side(monkeypatch):
    """The JAX package's scan on the CPU: (result, at, exact, exact
    lalpha, the tie-stage winner's lead over its runner-up a point)."""
    gaps = {}
    orig = JS._report_pool_max

    def spy(st, cand, clr, la):
        for k in range(st.n_int):
            v = np.sort(np.asarray(clr)[st.owner_x == k])[::-1]
            gaps[k] = v[0] - v[1] if len(v) > 1 else np.inf
        return orig(st, cand, clr, la)

    monkeypatch.setattr(JS, "_report_pool_max", spy)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    data = j_load(SF)
    fsp = j_fsp(data.obs_freq, data.depth_p, data.folded,
                data.sample_depths, compat_mirror_unfolded=True)
    tables = j_tables(fsp, data.sample_depths, grid_points=G)
    data.attach_model(tables)
    cfg = JS.ScanConfig(**SCAN)
    res = JS.scan_genome(data, tables, cfg)
    cand, lo, hi = _windows(data, res, cfg.eval_range)
    site = [jnp.asarray(x) for x in (
        tables.table.reshape(-1), data.row.astype(np.int32),
        np.asarray(data.pos).astype(np.int32),
        data.null_logl.astype(np.float32), cand, lo, hi)]
    at = np.asarray(JC.clr_grid(
        *site, jnp.asarray(res.lalpha.astype(np.float32)[:, None]),
        grid_points=G, paired_alpha=True, chunk=8))[:, 0]
    exact, la = JC.two_stage_alpha_max(*site, grid_points=G)
    lead = np.array([gaps[k] for k in range(res.n_points)])
    return res, at, np.asarray(exact), np.asarray(la), lead


def _port_side(dev):
    data = load_snp_input(SF)
    fsp = background_fsp(data.obs_freq, data.depth_p, data.folded,
                         data.sample_depths, compat_mirror_unfolded=True)
    tables = build_tables(fsp, data.sample_depths, grid_points=G)
    data.attach_model(tables)
    cfg = ScanConfig(**SCAN)
    res = scan_genome(data, tables, cfg, device=dev)
    cand, lo, hi = _windows(data, res, cfg.eval_range)
    site = (tables.table.reshape(-1), data.row, data.pos, data.null_logl,
            cand, lo, hi)
    at = TC.clr_grid(*site, res.lalpha.astype(np.float32)[:, None],
                     grid_points=G, paired_alpha=True, device=dev)[:, 0]
    exact, la = TC.two_stage_alpha_max(*site, grid_points=G, device=dev)
    return res, at.double().cpu().numpy(), exact.double().cpu().numpy(), \
        la.cpu().numpy()


@pytest.mark.gpu
def test_20k_reported_clr_gap_is_the_jax_packages(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's 20k scan runs on the card")
    dev = torch.device("cuda")
    j_res, j_at, j_exact, j_la, lead = _jax_side(monkeypatch)
    t_res, t_at, t_exact, t_la = _port_side(dev)
    clear = lead > CLR_TOL
    report = dict(
        points=int(j_res.n_points), clear=int(clear.sum()),
        card=torch.cuda.get_device_name(0),
        same_pos=int((j_res.sweep_pos == t_res.sweep_pos).sum()),
        jax=dict(at=_stats(j_res.clr - j_at),
                 exact=_stats(j_res.clr - j_exact),
                 above_exact=int((j_res.clr > j_exact).sum()),
                 lalpha_exact=int((np.abs(j_res.lalpha - j_la) < 1e-6).sum())),
        port=dict(at=_stats(t_res.clr - t_at),
                  exact=_stats(t_res.clr - t_exact),
                  above_exact=int((t_res.clr > t_exact).sum()),
                  lalpha_exact=int((np.abs(t_res.lalpha - t_la) < 1e-6).sum())),
    )
    print("exact-gap " + json.dumps(report))
    assert t_res.n_points == j_res.n_points > 0
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(t_res.sweep_pos[clear],
                                  j_res.sweep_pos[clear])
    np.testing.assert_array_equal(t_res.lalpha[clear], j_res.lalpha[clear])
    np.testing.assert_allclose(t_res.clr[clear], j_res.clr[clear], rtol=0,
                               atol=CLR_TOL)
    np.testing.assert_allclose(np.abs(t_res.clr - t_at)[clear],
                               np.abs(j_res.clr - j_at)[clear], rtol=0,
                               atol=GAP_TOL)
