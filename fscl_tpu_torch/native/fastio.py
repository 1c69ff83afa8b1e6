"""numpy-facing wrapper over ``fastio.c`` (the counterpart of
fscl_tpu/native/fastio.py), loaded with ctypes.

``build()`` compiles the source with the host's C compiler (``cc``, else
``gcc``, on PATH) at ``-O2 -fPIC -shared`` into ``fscl_tpu_torch/build/``,
named by a hash of the source, the flags and the compiler's path, written
to a temporary file of the process and thread and renamed into place, so
ranks and test workers may build at once.  A compiler that fails raises
with its output.  With no compiler on PATH, ``load()`` returns None and
the SNP reader runs its Python loop.  Nothing here runs when the module
is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "fastio.c"
BUILD = SOURCE.parents[1] / "build"
CC_FLAGS = ("-O2", "-fPIC", "-shared")

_lib = None


class _Rows(ctypes.Structure):
    """fastio.c's fscl_snp_rows."""

    _i64p = ctypes.POINTER(ctypes.c_int64)
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("pos", _i64p), ("freq", _i64p), ("size", _i64p),
        ("folded", _i64p),
        ("chr", ctypes.POINTER(ctypes.c_int32)),
        ("n_chr", ctypes.c_int64),
        ("name_off", _i64p),
        ("names", ctypes.POINTER(ctypes.c_char)),
    ]


def _compiler():
    """The host's C compiler on PATH, or None."""
    return shutil.which("cc") or shutil.which("gcc")


def library_path(cc) -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((*CC_FLAGS, cc)).encode())
    return BUILD / f"libfscl_fastio-{h.hexdigest()[:16]}.so"


def build():
    """The library's path, compiled if this hash has no build yet; None
    when no C compiler is on PATH."""
    cc = _compiler()
    if cc is None:
        return None
    so = library_path(cc)
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    p = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if p.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cc} failed ({p.returncode}) on {SOURCE}:\n"
                           f"{p.stdout}{p.stderr}")
    os.replace(tmp, so)
    return so


def load():
    """The loaded parser library, built on first call; None when no C
    compiler is on PATH."""
    global _lib
    if _lib is None:
        so = build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.fscl_parse_snp_file.argtypes = [ctypes.c_char_p,
                                            ctypes.POINTER(_Rows)]
        lib.fscl_parse_snp_file.restype = ctypes.c_int
        lib.fscl_free.argtypes = [ctypes.POINTER(_Rows)]
        lib.fscl_free.restype = None
        lib.fscl_parse_ms_haplotypes.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.fscl_parse_ms_haplotypes.restype = ctypes.c_int64
        lib.path = so
        _lib = lib
    return _lib


def _loaded():
    lib = load()
    if lib is None:
        raise RuntimeError("no C compiler on PATH (cc, gcc) to build "
                           f"{SOURCE.name}")
    return lib


def _copy(ptr, n):
    return np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n else \
        np.zeros(0, np.dtype(ptr._type_))


def parse_snp_file(path):
    """-> (list[str] chr, int64 pos, int64 freq, int64 size, int64 folded),
    as fscl_tpu.native.fastio.parse_snp_file returns them (names decoded
    as strict UTF-8)."""
    lib = _loaded()
    rows = _Rows()
    err = lib.fscl_parse_snp_file(os.fsencode(path), ctypes.byref(rows))
    if err:
        raise OSError(err, os.strerror(err), str(path))
    try:
        n, k = rows.n_rows, rows.n_chr
        cols = [_copy(getattr(rows, f), n)
                for f in ("pos", "freq", "size", "folded")]
        code = _copy(rows.chr, n)
        off = _copy(rows.name_off, k + 1) if k else [0]
        blob = ctypes.string_at(rows.names, off[-1]) if k else b""
    finally:
        lib.fscl_free(ctypes.byref(rows))
    names = np.array([blob[a:b].decode("utf-8")
                      for a, b in zip(off[:-1], off[1:])], dtype=object)
    return (names[code].tolist(), *cols)


def parse_ms_haplotypes(lines):
    """list[bytes] of 0/1 rows -> uint8 matrix [n_hap, n_poly]."""
    if not isinstance(lines, list):
        raise TypeError("expected list of bytes")
    if not all(isinstance(r, bytes) for r in lines):
        raise ValueError("ragged or non-bytes haplotype rows")
    lib = _loaded()
    n_hap = len(lines)
    n_poly = len(lines[0]) if lines else 0
    out = np.empty((n_hap, n_poly), np.uint8)
    lens = np.fromiter(map(len, lines), np.int64, n_hap)
    rows = (ctypes.c_char_p * n_hap)(*lines)
    if lib.fscl_parse_ms_haplotypes(rows, lens.ctypes.data, n_hap, n_poly,
                                    out.ctypes.data):
        raise ValueError("ragged or non-bytes haplotype rows")
    return out
