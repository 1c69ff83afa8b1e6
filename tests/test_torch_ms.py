"""ms input and spectrum files of the port (fscl_tpu_torch/io/ms_parser.py,
io/ms_input.py, io/spectra_io.py and the CLI's -m, -b and --output-bs)
against the JAX package.

Stated tolerances:
  * MsParser, ms_background, iter_ms_blocks (folded and unfolded, with
    --ms-sample-first/-size), msblock_sfs, msblock_fsbranch_lengths and
    sfs_summaries: equal (the same numpy code on the same input);
  * spectrum files: a file written by each package reads back in the
    other to the same arrays, and --output-bs writes byte-equal files;
  * both CLIs with -m (the port with --device cpu) on
    bench/data/headline_ms_neutral.ms (--ms-segment-length 1000000
    --compat-mirror-unfolded -p 20, the JAX package's sigma injected into
    the port: each package draws its own permutations) and on the first
    two blocks of bench/data/headline_ms_sweep.ms (--ms-folded
    --max-only), and with -b from the JAX package's --output-bs: rows and
    positions equal, CLR within 1e-3; exceedance counts equal off listed
    near-tie points (a saved replicate within 1e-4 of its threshold but
    not at it in either package, as in tests/test_torch_permute.py; the
    neutral file's one 1 Mb chromosome is about one permutation block
    wide, so many replicates repeat the observed windows up to rounding
    and 7 of its 10 points are listed), and the appended -nulldist rows
    the same: positions and counts equal, CLR within 1e-3, the saved null
    CLRs (printed to two decimals) within 0.0101.
The CLI runs use the flags the benchmark configurations use (about 30 s
for the JAX package's runs on a CPU); nothing is cut.

This file imports nothing of tests/: on the card machine such imports do
not collect.
"""

import io
import pathlib
import textwrap

import numpy as np
import pytest

import jax

import fscl_tpu.engine as JE
import fscl_tpu.io.ms_input as JI
import fscl_tpu.io.ms_parser as JMP
import fscl_tpu.io.spectra_io as JS
import fscl_tpu_torch.io.ms_input as TI
import fscl_tpu_torch.io.ms_parser as TMP
import fscl_tpu_torch.io.spectra_io as TS
from fscl_tpu.ops.permute import block_permutation_groups as jax_sigma
from fscl_tpu_torch import NotPortedError

REPO = pathlib.Path(__file__).resolve().parents[1]
NEUTRAL = REPO / "bench" / "data" / "headline_ms_neutral.ms"
SWEEP = REPO / "bench" / "data" / "headline_ms_sweep.ms"
CLR_TOL = 1e-3
NEAR = 1e-4  # a saved replicate this close to (not at) its threshold

MS_TREES = textwrap.dedent(
    """\
    ms 4 2 -s 5 -T
    27269 12761 30133

    //
    [3]((1:0.2,2:0.2):0.5,(3:0.3,4:0.3):0.4);
    [7](1:0.1,(2:0.4,(3:0.2,4:0.2):0.1):0.3);
    segsites: 5
    positions: 0.1000 0.2500 0.4000 0.6000 0.9000
    01010
    01100
    00100
    11011

    //
    segsites: 3
    prob: 0.75
    positions: 0.2 0.5 0.8
    010
    011
    110
    100
    """
)


def _blocks(mod, text):
    p = mod.MsParser(io.StringIO(text))
    out = []
    while (b := p.next_block()) is not None:
        out.append(b)
    return out


@pytest.mark.parametrize("path", [NEUTRAL, SWEEP], ids=["neutral", "sweep"])
def test_ms_parser_matches_jax(path):
    text = path.read_text()
    want, got = _blocks(JMP, text), _blocks(TMP, text)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.prob == w.prob and len(g.segments) == len(w.segments)
        np.testing.assert_array_equal(g.positions, w.positions)
        np.testing.assert_array_equal(g.haplotypes, w.haplotypes)
        assert g.haplotypes.dtype == w.haplotypes.dtype


def test_sfs_summaries_match_jax():
    for g, w in zip(_blocks(TMP, MS_TREES), _blocks(JMP, MS_TREES)):
        for s, n in ((0, 4), (1, 2)):
            np.testing.assert_array_equal(TMP.msblock_sfs(g, s, n),
                                          JMP.msblock_sfs(w, s, n))
            np.testing.assert_array_equal(
                TMP.msblock_fsbranch_lengths(g, s, n),
                JMP.msblock_fsbranch_lengths(w, s, n))
    for g, w in zip(_blocks(TMP, SWEEP.read_text())[:3],
                    _blocks(JMP, SWEEP.read_text())[:3]):
        sfs_g, sfs_w = TMP.msblock_sfs(g, 0, 50), JMP.msblock_sfs(w, 0, 50)
        np.testing.assert_array_equal(sfs_g, sfs_w)
        assert vars(TMP.sfs_summaries(sfs_g, 50)) == vars(
            JMP.sfs_summaries(sfs_w, 50))


def _same_data(a, b):
    for f in ("pos", "obs_freq", "depth_p", "folded", "chr_id",
              "sample_depths"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)
    assert [vars(c) for c in a.chr_limits] == [vars(c) for c in b.chr_limits]


@pytest.mark.parametrize("folded, first, size", [
    (False, 0, 0), (True, 0, 0), (False, 5, 30), (True, 10, 20)])
def test_ms_background_and_blocks_match_jax(folded, first, size):
    seg = 5_000_000
    _same_data(TI.ms_background(str(SWEEP), seg, folded, first, size),
               JI.ms_background(str(SWEEP), seg, folded, first, size))
    got = list(TI.iter_ms_blocks(str(SWEEP), seg, folded, first, size))
    want = list(JI.iter_ms_blocks(str(SWEEP), seg, folded, first, size))
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        _same_data(g, w)


def test_spectra_files_cross_read(tmp_path):
    rng = np.random.default_rng(3)
    depths = [12, 30]
    fsp = [rng.dirichlet(np.ones(d + 1)) for d in depths]
    TS.write_spectra(tmp_path / "t.bs", depths, fsp)
    JS.write_spectra(tmp_path / "j.bs", depths, fsp)
    assert (tmp_path / "t.bs").read_bytes() == (tmp_path / "j.bs").read_bytes()
    for a, b in ((TS, JS), (JS, TS)):
        name = "t.bs" if a is TS else "j.bs"
        got, want = b.load_spectra(tmp_path / name), a.load_spectra(
            tmp_path / name)
        assert sorted(got) == sorted(want) == depths
        for d in depths:
            np.testing.assert_array_equal(got[d], want[d])
    (tmp_path / "bad.bs").write_text("4\t0.1\t0.2\n")
    for m in (TS, JS):
        with pytest.raises(ValueError, match="5 classes"):
            m.load_spectra(tmp_path / "bad.bs")


# ---- both CLIs -------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep2(tmp_path_factory):
    """The first two blocks of headline_ms_sweep.ms."""
    parts = SWEEP.read_text().split("\n//")
    path = tmp_path_factory.mktemp("ms") / "sweep2.ms"
    path.write_text("\n//".join(parts[:3]) + "\n")
    return path


def _capture(monkeypatch, mod, store, inject=False):
    """Wrap ``mod.scan_permute`` to keep each block's result; with
    ``inject``, hand the port the JAX package's sigma of the same seed."""
    orig = mod.scan_permute

    def wrap(data, tables, result, scan_cfg, cfg, *a, **kw):
        if inject:
            key, gp = jax.random.key(cfg.seed), data.genome_pos()
            width = cfg.scan_width_mb * 1e6

            def sigma_source(n, start):
                return np.asarray(jax_sigma(key, gp, width, n, start=start))

            kw["sigma_source"] = sigma_source
        out = orig(data, tables, result, scan_cfg, cfg, *a, **kw)
        store.append(result)
        return out

    monkeypatch.setattr(mod, "scan_permute", wrap)


def _run_both(monkeypatch, tmp_path, args, permuted=False):
    """Both CLIs on ``args``; (port rows, JAX rows, near-tie row indices)."""
    from fscl_tpu.cli import main as jax_main
    from fscl_tpu_torch.cli import main

    monkeypatch.setattr(jax, "device_count", lambda: 1)
    res_t, res_j = [], []
    _capture(monkeypatch, TI, res_t, inject=True)
    _capture(monkeypatch, JE, res_j)
    out_t, out_j = tmp_path / "port.tsv", tmp_path / "jax.tsv"
    assert main([*args, "-o", str(out_t), "--device", "cpu", "-v", "1"]) == 0
    assert jax_main([*args, "-o", str(out_j), "-v", "1"]) == 0
    near = []
    if permuted:
        assert len(res_t) == len(res_j) > 0
        k = 0
        for rt, rj in zip(res_t, res_j):
            for i in range(rj.n_points):
                d = [np.abs(np.asarray(r.null_clr[i]) - r.stat_threshold[i])
                     for r in (rt, rj)]
                if any(np.any((x > 0) & (x < NEAR)) for x in d):
                    near.append(k + i)
            k += rj.n_points
    print("near-tie rows:", near)
    return _rows(out_t), _rows(out_j), near, out_t, out_j


def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def _check_rows(got, want, near, n_count_cols=0, min_keep=3):
    """Rows of a scan TSV or -nulldist file: labels and positions equal,
    CLR (column 2) within CLR_TOL, the count columns (4, 5) equal off
    near-tie rows, of which at least min_keep remain."""
    assert len(got) == len(want) > 0
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([float(r[2]) for r in got],
                               [float(r[2]) for r in want], rtol=0,
                               atol=CLR_TOL)
    keep = [i for i in range(len(want)) if i not in near]
    assert len(keep) >= min(min_keep, len(want))
    for i in keep:
        assert got[i][4:4 + n_count_cols] == want[i][4:4 + n_count_cols], i


def test_cli_ms_neutral_matches_jax(monkeypatch, tmp_path):
    got, want, near, out_t, out_j = _run_both(
        monkeypatch, tmp_path,
        ["-m", str(NEUTRAL), "--ms-segment-length", "1000000",
         "--compat-mirror-unfolded", "-p", "20"], permuted=True)
    _check_rows(got, want, near, n_count_cols=2)
    nd_t = _rows(f"{out_t}-nulldist")
    nd_j = _rows(f"{out_j}-nulldist")
    assert nd_t[0] == nd_j[0]  # the header
    _check_rows(nd_t[1:], nd_j[1:], near, n_count_cols=2)
    for i, (a, b) in enumerate(zip(nd_t[1:], nd_j[1:])):
        if i not in near:
            assert len(a) == len(b)
            np.testing.assert_allclose(np.float64(a[6:]), np.float64(b[6:]),
                                       rtol=0, atol=0.0101)


def test_cli_ms_sweep_max_only_matches_jax(monkeypatch, tmp_path, sweep2):
    got, want, near, _, _ = _run_both(
        monkeypatch, tmp_path,
        ["-m", str(sweep2), "--ms-segment-length", "5000000", "--ms-folded",
         "--max-only", "--output-bs", str(tmp_path / "bs")])
    assert len(want) == 2  # one maximum per block, appended
    _check_rows(got, want, near)
    assert [r[4:] for r in got] == [r[4:] for r in want]


def test_cli_output_bs_and_background_spectrum(monkeypatch, tmp_path,
                                               sweep2):
    """--output-bs --no-scan writes byte-equal files from both CLIs; -b
    with the JAX package's file then scans alike in both."""
    from fscl_tpu.cli import main as jax_main
    from fscl_tpu_torch.cli import main

    monkeypatch.setattr(jax, "device_count", lambda: 1)
    ms = ["-m", str(sweep2), "--ms-segment-length", "5000000", "--ms-folded"]
    bs_t, bs_j = tmp_path / "port.bs", tmp_path / "jax.bs"
    assert main([*ms, "-o", str(tmp_path / "x"), "--output-bs", str(bs_t),
                 "--no-scan", "--device", "cpu", "-v", "1"]) == 0
    assert jax_main([*ms, "-o", str(tmp_path / "y"), "--output-bs",
                     str(bs_j), "--no-scan", "-v", "1"]) == 0
    assert bs_t.read_bytes() == bs_j.read_bytes() and bs_j.stat().st_size
    # a spectrum unlike the data's own: -b must change the scan
    bs = JS.load_spectra(bs_j)
    flat = {d: np.full(d + 1, 1.0 / (d + 1)) for d in bs}
    JS.write_spectra(tmp_path / "flat.bs", list(flat), list(flat.values()))
    sub = tmp_path / "b"
    sub.mkdir()
    got, want, near, _, _ = _run_both(
        monkeypatch, sub, [*ms, "--max-only", "-b",
                           str(tmp_path / "flat.bs")])
    _check_rows(got, want, near)
    plain = tmp_path / "plain.tsv"
    assert main([*ms, "--max-only", "-o", str(plain), "--device", "cpu",
                 "-v", "1"]) == 0
    assert [r[2] for r in _rows(plain)] != [r[2] for r in got]


def test_cli_checkpoint_with_ms_still_raises(tmp_path):
    from fscl_tpu_torch.cli import main

    with pytest.raises(NotPortedError, match="--checkpoint"):
        main(["-m", str(NEUTRAL), "--ms-segment-length", "1000000",
              "-p", "4", "--checkpoint", str(tmp_path / "c.npz"),
              "-o", str(tmp_path / "x.tsv"), "--device", "cpu", "-v", "0"])
