"""The port's C parser (fscl_tpu_torch/native/fastio.c through fastio.py)
against fscl_tpu's, and the SNP reader that uses it.

Stated tolerances: none, every comparison is exact.
  * tests/test_native.py's cases (comments, blank lines, the "chromosome"
    header and bad lines; a 50,000-line round trip; parse_ms_haplotypes
    with its ragged-row ValueError), held against
    fscl_tpu.io.snp_reader._parse_python;
  * fscl_tpu's own C parser (fscl_tpu/native/fastio.c), compiled from its
    source into a temporary directory with the host's C compiler and
    Python's headers and loaded as ``_fastio`` (nothing is built inside
    fscl_tpu/), against the port's bit for bit on a corpus of malformed
    lines, one at a time and all in one file, and on the empty file;
  * the port's C parser and its Python loop differ on exactly the lines
    listed in DIFFERS, and the Python loop equals fscl_tpu's on each;
  * load_snp_input end to end against fscl_tpu.io.load_snp_input, every
    SNPData field equal, at minimum_obs_depth 5 and 25, with
    include_invariant on and off, on mixed depths with folded rows;
  * with no compiler on PATH the reader logs the Python loop and uses it;
    a compiler that fails raises with its output; builds that run at once
    end with one library.

This file imports nothing of tests/: on the card machine such imports do
not collect.
"""

import dataclasses
import importlib.util
import pathlib
import shutil
import subprocess
import sysconfig
import threading

import numpy as np
import pytest

from fscl_tpu.io import load_snp_input as jax_load_snp_input
from fscl_tpu.io.snp_reader import _parse_python as jax_parse_python
from fscl_tpu_torch.io import load_snp_input
from fscl_tpu_torch.io import snp_reader
from fscl_tpu_torch.native import fastio
from fscl_tpu_torch.utils import logging as tlog

JAX_FASTIO_C = (fastio.SOURCE.parents[2] / "fscl_tpu" / "native"
                / "fastio.c")


@pytest.fixture(scope="module")
def port():
    if fastio.load() is None:
        pytest.skip("no C compiler on PATH (cc, gcc)")
    return fastio


@pytest.fixture(scope="module")
def jax_c(tmp_path_factory):
    """fscl_tpu's C parser built from its source, and its wrapper's
    parse_snp_file and parse_ms_haplotypes (fscl_tpu/native/fastio.py)."""
    cc = shutil.which("cc") or shutil.which("gcc")
    inc = sysconfig.get_paths()["include"]
    if cc is None or not (pathlib.Path(inc) / "Python.h").exists():
        pytest.skip("no C compiler or no Python.h to build fscl_tpu's parser")
    so = tmp_path_factory.mktemp("jax_fastio") / "_fastio.so"
    subprocess.run([cc, "-O2", "-fPIC", "-shared", f"-I{inc}", "-o",
                    str(so), str(JAX_FASTIO_C)], check=True,
                   capture_output=True)
    spec = importlib.util.spec_from_file_location("_fastio", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class C:
        @staticmethod
        def parse_snp_file(path):
            chrs, *cols = mod.parse_snp_file_raw(str(path))
            return (chrs, *(np.frombuffer(b, dtype=np.int64) for b in cols))

        @staticmethod
        def parse_ms_haplotypes(lines):
            buf, n_hap, n_poly = mod.parse_ms_haplotypes(lines)
            return np.frombuffer(buf, dtype=np.uint8).reshape(n_hap, n_poly)

    return C


@pytest.fixture
def status_log(monkeypatch):
    monkeypatch.setattr(tlog, "_level", tlog.MSG_STATUS)
    monkeypatch.setattr(tlog, "_prefix", "")


def _same(a, b):
    """Two parses, bit for bit: chromosome lists and int64 columns."""
    return list(a[0]) == list(b[0]) and all(
        x.dtype == np.int64 and y.dtype == np.int64 and np.array_equal(x, y)
        for x, y in zip(a[1:], b[1:]))


def _python(parse, path):
    """The Python loop's parse, or the exception type it raised."""
    try:
        return parse(path)
    except (OverflowError, ValueError) as e:
        return type(e)


# a malformed or odd line each, written after one well-formed row
CORPUS = {
    "trailing_garbage": b"c1 11 2 20 4x\n",
    "underscore": b"c1 1_3 2 20 0\n",
    "overflow": b"c1 99999999999999999999 2 20 0\n",
    "negative_overflow": b"c1 -99999999999999999999 2 20 0\n",
    "fullwidth_digits": "c1 １２ 2 20 0\n".encode(),
    "short_row": b"c1 10 2\n",
    "header": b"chromosome\n",
    "name_only": b"c1\n",
    "crlf": b"c1\t10\t2\t20\t0\r\n",
    "blank_crlf": b"\r\n",
    "spaces_only": b"  \t \n",
    "no_newline": b"c1 10 2 20 0",
    "long_name": b"c" + b"x" * 70000 + b" 10 2 20 0\n",
    "long_tail": b"c1 10 2 20 0" + b" junk" * 14000 + b"\n",
    "leading_tabs": b"\t\t c1 10 2 20 0\n",
    "indented_comment": b"  \t# c1 10 2 20 0\n",
    "negative": b"c1 -5 -2 20 -1\n",
    "six_fields": b"c1 10 2 20 0 extra\n",
    "plus_signs": b"c1 +10 +2 20 0\n",
    "leading_zeros": b"c1 007 2 20 0\n",
    "hex": b"c1 0x10 2 20 0\n",
    "decimal_point": b"c1 10.5 2 20 0\n",
    "vertical_tab": b"c1\x0b10 2 20 0\n",
    "int64_max": b"c1 9223372036854775807 2 20 0\n",
    "utf8_name": "chrÅ 10 2 20 0\n".encode(),
}
# where the C parser and the Python loop read a line differently:
# strtoll stops at "x", int() reads "1_3" as 13 and full-width digits as
# 12, strtoll saturates where the loop's int64 array overflows
DIFFERS = {"trailing_garbage", "underscore", "overflow", "negative_overflow",
           "fullwidth_digits"}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_malformed_line_bitwise_fscl_tpu_c(name, port, jax_c, tmp_path):
    f = tmp_path / "x.sf"
    f.write_bytes(b"c0 5 1 20 0\n" + CORPUS[name])
    got = port.parse_snp_file(f)
    assert _same(got, jax_c.parse_snp_file(f))
    py, jax_py = (_python(parse, f) for parse in (snp_reader._parse_python,
                                                   jax_parse_python))
    if isinstance(py, type):  # the loop raised
        assert py is jax_py
    else:
        assert _same(py, jax_py)
    assert (isinstance(py, type) or not _same(got, py)) == (name in DIFFERS)


def test_malformed_corpus_one_file(port, jax_c, tmp_path):
    f = tmp_path / "x.sf"
    f.write_bytes(b"".join(v if v.endswith(b"\n") else v + b"\n"
                           for v in CORPUS.values()))
    got = port.parse_snp_file(f)
    assert _same(got, jax_c.parse_snp_file(f))
    i64 = np.iinfo(np.int64)
    assert i64.max in got[1] and i64.min in got[1]  # saturated
    assert "c" + "x" * 70000 in got[0]


def test_empty_file(port, jax_c, tmp_path):
    f = tmp_path / "x.sf"
    f.write_bytes(b"")
    got = port.parse_snp_file(f)
    assert got[0] == [] and all(len(c) == 0 for c in got[1:])
    assert _same(got, jax_c.parse_snp_file(f))
    assert _same(got, snp_reader._parse_python(f))


def test_parse_snp_file_matches_python(port, jax_c, tmp_path):
    f = tmp_path / "x.sf"
    f.write_text(
        "# comment line\n"
        "chr1\t100\t3\t20\t0\n"
        "chr1 250 5 20 1\n"
        "\n"
        "chromosome\n"
        "chr2\t17\t2\t18\t0\n"
        "bad line\n"
        "chr2\t99\t1\t18\t1\n"
    )
    got = port.parse_snp_file(f)
    assert got[0] == ["chr1", "chr1", "chr2", "chr2"]
    assert _same(got, jax_parse_python(f))
    assert _same(got, jax_c.parse_snp_file(f))


def test_parse_snp_file_large_roundtrip(port, jax_c, tmp_path):
    rng = np.random.default_rng(0)
    n = 50000
    pos = np.sort(rng.choice(10**8, n, replace=False))
    freq = rng.integers(1, 30, n)
    f = tmp_path / "big.sf"
    with open(f, "w") as fh:
        for p, q in zip(pos, freq):
            fh.write(f"1\t{p}\t{q}\t30\t0\n")
    got = port.parse_snp_file(f)
    assert len(got[0]) == n
    np.testing.assert_array_equal(got[1], pos)
    np.testing.assert_array_equal(got[2], freq)
    assert (got[3] == 30).all() and (got[4] == 0).all()
    assert _same(got, jax_parse_python(f))
    assert _same(got, jax_c.parse_snp_file(f))


def test_many_interleaved_chromosomes(port, jax_c, tmp_path):
    """Scaffolds past the name table's first sizes, revisited out of
    order: codes by first appearance, the lookup through rehashes."""
    rng = np.random.default_rng(3)
    names = [f"scaffold_{i}" for i in range(3000)]
    rows = rng.integers(0, len(names), 20000)
    f = tmp_path / "x.sf"
    f.write_text("".join(f"{names[r]} {i} {i % 7} 20 {i % 2}\n"
                         for i, r in enumerate(rows)))
    got = port.parse_snp_file(f)
    assert got[0] == [names[r] for r in rows]
    assert _same(got, jax_c.parse_snp_file(f))
    assert _same(got, jax_parse_python(f))


def test_names_are_strict_utf8(port, jax_c, tmp_path):
    f = tmp_path / "x.sf"
    f.write_bytes(b"chr1 1 1 20 0\nchr\xff 2 1 20 0\n")
    with pytest.raises(UnicodeDecodeError):
        jax_c.parse_snp_file(f)
    with pytest.raises(UnicodeDecodeError):
        port.parse_snp_file(f)


def test_missing_file(port, jax_c, tmp_path):
    for parse in (port.parse_snp_file, jax_c.parse_snp_file):
        with pytest.raises(FileNotFoundError):
            parse(tmp_path / "absent.sf")


def test_parse_ms_haplotypes(port, jax_c):
    lines = [b"0101", b"1100", b"0011"]
    m = port.parse_ms_haplotypes(lines)
    np.testing.assert_array_equal(
        m, [[0, 1, 0, 1], [1, 1, 0, 0], [0, 0, 1, 1]]
    )
    assert m.dtype == np.uint8
    np.testing.assert_array_equal(m, jax_c.parse_ms_haplotypes(lines))
    assert port.parse_ms_haplotypes([]).shape == (0, 0)
    for bad in ([b"01", b"011"], [b"01", "01"]):
        with pytest.raises(ValueError):
            jax_c.parse_ms_haplotypes(bad)
        with pytest.raises(ValueError):
            port.parse_ms_haplotypes(bad)
    with pytest.raises(TypeError):
        port.parse_ms_haplotypes((b"01",))


def _snp_file(path, seed=11, n=3000):
    """Three chromosomes, mixed depths, folded rows, invariant and fixed
    sites, shallow rows, comments and the header token."""
    rng = np.random.default_rng(seed)
    depth = rng.choice([4, 20, 26, 31], n)
    freq = rng.integers(0, depth + 1)
    fold = (rng.random(n) < 0.4).astype(int)
    chrom = rng.choice(["chr2", "chr1", "chrX"], n)
    pos = rng.choice(10**7, n, replace=False)
    lines = ["# made from a seed", "chromosome"]
    lines += [f"{c}\t{p}\t{q}\t{d}\t{f}"
              for c, p, q, d, f in zip(chrom, pos, freq, depth, fold)]
    path.write_text("\n".join(lines) + "\n")


def _assert_same_data(got, want):
    """Every SNPData field equal, dtypes too (chr_limits field by field)."""
    a, b = vars(got), vars(want)
    assert a.keys() == b.keys()
    for k in a:
        if k == "chr_limits":
            assert [dataclasses.astuple(c) for c in a[k]] == \
                [dataclasses.astuple(c) for c in b[k]]
        elif isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("depth", [5, 25])
@pytest.mark.parametrize("invariant", [False, True])
def test_load_snp_input_matches_fscl_tpu(depth, invariant, port, tmp_path,
                                         status_log, capsys):
    f = tmp_path / "x.sf"
    _snp_file(f)
    kw = dict(include_invariant=invariant, minimum_obs_depth=depth)
    got = load_snp_input(f, **kw)
    assert "with the C parser" in capsys.readouterr().err
    _assert_same_data(got, jax_load_snp_input(f, **kw))
    assert got.folded.any()


def test_fallback_without_compiler(port, monkeypatch, tmp_path, status_log,
                                   capsys):
    f = tmp_path / "x.sf"
    _snp_file(f)
    want = load_snp_input(f)
    monkeypatch.setattr(fastio, "_compiler", lambda: None)
    monkeypatch.setattr(fastio, "_lib", None)
    capsys.readouterr()
    got = load_snp_input(f)
    err = capsys.readouterr().err
    assert "with the Python loop (no C compiler on PATH)" in err
    assert "C parser" not in err
    _assert_same_data(got, want)
    with pytest.raises(RuntimeError, match="no C compiler"):
        fastio.parse_snp_file(f)


def test_failed_build_raises(port, monkeypatch, tmp_path):
    broken = tmp_path / "fastio.c"
    broken.write_text(fastio.SOURCE.read_text().replace(
        "int64_t n_rows;", "int64_t n_rows", 1))
    monkeypatch.setattr(fastio, "SOURCE", broken)
    monkeypatch.setattr(fastio, "BUILD", tmp_path / "build")
    monkeypatch.setattr(fastio, "_lib", None)
    with pytest.raises(RuntimeError, match="error") as e:
        fastio.build()
    assert str(broken) in str(e.value)
    f = tmp_path / "x.sf"
    _snp_file(f)
    with pytest.raises(RuntimeError, match="failed"):
        load_snp_input(f)
    assert list((tmp_path / "build").iterdir()) == []


def test_library_named_by_source_flags_and_compiler(port, monkeypatch,
                                                    tmp_path):
    cc = fastio._compiler()
    base = fastio.library_path(cc)
    assert base.parent == fastio.BUILD
    assert base.name.startswith("libfscl_fastio-")
    assert fastio.library_path("/elsewhere/cc") != base
    monkeypatch.setattr(fastio, "CC_FLAGS", ("-O3", "-fPIC", "-shared"))
    assert fastio.library_path(cc) != base
    monkeypatch.undo()
    copy = tmp_path / "fastio.c"
    copy.write_text(fastio.SOURCE.read_text() + "\n")
    monkeypatch.setattr(fastio, "SOURCE", copy)
    assert fastio.library_path(cc) != base


def test_concurrent_builds_end_with_one_library(port, monkeypatch,
                                                tmp_path):
    """More concurrent builds than cores: each renames its own temporary
    file into place, and every one gets a whole library."""
    monkeypatch.setattr(fastio, "BUILD", tmp_path / "build")
    paths, errors = [], []

    def one():
        try:
            paths.append(fastio.build())
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(paths) == 12 and len(set(paths)) == 1
    assert [p.name for p in (tmp_path / "build").iterdir()] == [paths[0].name]
    lib = fastio.ctypes.CDLL(str(paths[0]))
    assert lib.fscl_parse_snp_file
