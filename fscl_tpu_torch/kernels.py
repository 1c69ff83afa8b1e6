"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface.  At first use ``nvcc`` compiles them
for Hopper, one process per source, all started together, and links the
objects into one shared library under ``fscl_tpu_torch/build/``, named
by a hash of the sources and flags so a stale build is never loaded;
``ctypes`` loads it.  A failed build raises with nvcc's output.  Nothing
here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PKG = pathlib.Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_log = ""  # nvcc's output (ptxas register and shared-memory report)
build_seconds = 0.0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc():
    cand = [
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libfscl_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands concurrently; (log, first failure or None)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log, bad = "", None
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        log += out
        if p.returncode != 0 and bad is None:
            bad = (p.returncode, c)
    return log, bad


def build() -> pathlib.Path:
    """Compile the library if this source hash has no build yet."""
    global build_log, build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD / f"{tag}.{s.stem}.o" for s in srcs]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.monotonic()
    build_log, bad = _run_all([
        [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
        for s, o in zip(srcs, objs)
    ])
    if bad is None:
        log, bad = _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)]])
        build_log += log
    build_seconds = time.monotonic() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    if bad is not None:
        raise RuntimeError(
            f"nvcc failed ({bad[0]}): {' '.join(bad[1])}\n{build_log}"
        )
    os.replace(tmp, so)
    return so


def load():
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.fscl_onehot_prefix_sums.argtypes = [
        vp, vp, vp, vp, vp, i, i, i, i, i, i, i, vp,
    ]
    lib.fscl_onehot_prefix_sums.restype = i
    lib.fscl_weighted_prefix_sums.argtypes = [
        vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, vp,
    ]
    lib.fscl_weighted_prefix_sums.restype = i
    lib.fscl_rowid_prefix_sums.argtypes = [vp, vp, vp, i, i, i, i, vp]
    lib.fscl_rowid_prefix_sums.restype = i
    lib.fscl_perm_prefix_sums.argtypes = [
        vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, vp,
    ]
    lib.fscl_perm_prefix_sums.restype = i
    lib.fscl_row_gather.argtypes = [vp, vp, vp, i64, i64, i, i, vp]
    lib.fscl_row_gather.restype = i
    lib.fscl_window_operand.argtypes = [
        vp, vp, vp, vp, i, i, i, i, i64, i, i, vp,
    ]
    lib.fscl_window_operand.restype = i
    lib.fscl_window_clr.argtypes = [
        vp, vp, vp, vp, vp, i, i, i, i, i64, i, i, i, vp,
    ]
    lib.fscl_window_clr.restype = i
    lib.fscl_window_clr_f32.argtypes = [
        vp, vp, vp, vp, vp, vp, i, i, i, i, i64, i, i, i, i, vp,
    ]
    lib.fscl_window_clr_f32.restype = i
    lib.fscl_window_clr_f32_splits.argtypes = [i64, i, i, i, i]
    lib.fscl_window_clr_f32_splits.restype = i
    lib.fscl_lattice_clr.argtypes = [vp] * 10 + [i, i, i, i, i, i,
                                           ctypes.c_float, i, vp]
    lib.fscl_lattice_clr.restype = i
    lib.fscl_clr_grid.argtypes = [vp] * 10 + [i, i, i, i, ctypes.c_float,
                                               i, vp]
    lib.fscl_clr_grid.restype = i
    for tile in (lib.fscl_ps_tile, lib.fscl_wps_tile,
                 lib.fscl_clr_grid_slice_sites, lib.fscl_clr_grid_group):
        tile.argtypes = []
        tile.restype = i
    for size in (lib.fscl_ps_scratch_bytes, lib.fscl_wps_scratch_bytes):
        size.argtypes = [i, i, i, i]
        size.restype = i64
    lib.fscl_cuda_error_string.argtypes = [i]
    lib.fscl_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def launch_counts() -> dict:
    """Every wrapper's count of its kernel's launches in this process,
    by kernel (each wrapper adds one where it launches, and nowhere
    else)."""
    from .ops import clr, gather, lattice, prefix_sums, window_clr

    return dict(
        onehot_prefix_sums=prefix_sums.launches,
        weighted_prefix_sums=prefix_sums.weighted_launches,
        rowid_prefix_sums=prefix_sums.rowid_launches,
        perm_prefix_sums=prefix_sums.perm_launches,
        row_gather=gather.gather_launches,
        window_operand=gather.window_launches,
        window_clr=window_clr.window_clr_launches,
        window_clr_f32=window_clr.window_clr_f32_launches,
        window_clr_f32_reduce=window_clr.window_clr_f32_reduce_launches,
        clr_lattice=lattice.lattice_clr_launches,
        clr_grid=clr.clr_grid_launches,
    )


def check(lib, code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.fscl_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
