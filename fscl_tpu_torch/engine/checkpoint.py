"""Permutation checkpoint / resume (a copy of fscl_tpu/engine/checkpoint.py
with one change: the sigma-stream marker).

The reference has no resume — only SIGINT dump-and-continue
(scan-chromosome.c:554-569) and the manual two-stage restart through
--output-bs / -b (SURVEY.md section 5).  Here the permutation engine's state
(per-point permute_n / permute_p / finished flags, null-CLR reservoirs, rounds
completed) checkpoints after every chunk; a resumed run reloads it, draws
the same sigma rows (row r is a pure function of (seed, start + r),
ops/permute.py), skips the completed rounds, and continues — so a killed
100k-permutation run loses at most one chunk of work.

Two formats:

* ``save_checkpoint`` / ``load_checkpoint`` — one full .npz snapshot.  Simple
  and self-contained, but at genome scale (10k points x up to 10k-float
  reservoirs) every save rewrites ~400 MB, dwarfing a chunk's compute.
* ``Checkpointer`` — the incremental format the drivers use: a small base
  .npz (scan identity + seed) plus an APPEND-ONLY delta log.  Each chunk
  appends every point's counters and threshold (25 bytes a point) and
  only the null values added since the previous record, so checkpoint
  cost follows the point count and the chunk's new work, not the
  accumulated reservoirs.  Records are length-prefixed and CRC-checked:
  a crash mid-append truncates to the last complete record on resume.

The sigma-stream marker: the base file and the full snapshot carry one
more entry, ``sigma_stream`` (ops/permute.py:SIGMA_STREAM), and a file
without it, or with another stream's name, is refused.  fscl_tpu writes no
such entry: its permutations come from threefry, so resuming its file here
would continue another package's run on this package's stream, a result
equal to no uninterrupted run of either.  Every other entry and the delta
records are byte-compatible with fscl_tpu's, which checks only positions
and CLRs and so accepts this package's files.

Under a split over ranks (parallel/) every rank holds the same state, so
one file serves every world: rank 0 writes it (``write=True``), the
other ranks only replay it on a resume (``write=False``), and the
driver says whether to resume (``resume``: rank 0's view of the file,
broadcast), so that no rank reads a base file rank 0 has just created.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

from ..ops.permute import SIGMA_STREAM

_MAGIC = b"FSCK"  # delta-record magic
_HDR = struct.Struct("<4sQI")  # magic, payload length, crc32


def save_checkpoint(path, result, rounds_done, seed):
    """Full-snapshot save (one .npz). For small runs and tools; the drivers
    use Checkpointer's incremental log instead."""
    res_lengths = np.asarray([len(r or []) for r in result.null_clr])
    flat = (
        np.concatenate([np.asarray(r or [], dtype=np.float32) for r in result.null_clr])
        if res_lengths.sum()
        else np.zeros(0, dtype=np.float32)
    )
    tmp = f"{path}.tmp"
    np.savez_compressed(
        tmp,
        rounds_done=rounds_done,
        seed=seed,
        permute_n=result.permute_n,
        permute_p=result.permute_p,
        permute_finished=result.permute_finished,
        stat_threshold=_thresholds_of(result),
        clr=result.clr,
        sweep_pos=result.sweep_pos,
        null_lengths=res_lengths,
        null_flat=flat,
        sigma_stream=SIGMA_STREAM,
    )
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)


def _thresholds_of(result):
    """The result's stat_threshold vector (NaN-filled when never set).

    The observed PERMUTATION-statistic values must survive a resume: the
    tail projection (engine/pvalues.py) compares nulls against this
    threshold, and a resumed run recomputes it only for still-ACTIVE
    points — without persistence, already-finished points would silently
    fall back to the dense-scan CLR and reintroduce the decimation-offset
    tail miscalibration the threshold exists to avoid (ADVICE r3)."""
    thr = getattr(result, "stat_threshold", None)
    if thr is None:
        thr = np.full(result.n_points, np.nan)
    return np.asarray(thr, dtype=np.float64)


def _restore_thresholds(z, result):
    if "stat_threshold" in z.files:  # absent in pre-round-4 checkpoints
        result.stat_threshold = np.asarray(z["stat_threshold"], np.float64)


def _check_stream(z, path):
    """Refuse a file written on another permutation stream."""
    stream = str(z["sigma_stream"]) if "sigma_stream" in z.files else None
    if stream != SIGMA_STREAM:
        raise ValueError(
            f"checkpoint {path} was written by another package (sigma "
            f"stream {stream or 'not named: fscl_tpu, threefry'}), whose "
            f"permutation stream differs from this one ({SIGMA_STREAM}); "
            "a resume would equal no uninterrupted run"
        )


def _check_identity(z, result):
    if not np.array_equal(z["sweep_pos"], result.sweep_pos) or not np.allclose(
        z["clr"], result.clr, atol=1e-3
    ):
        raise ValueError(
            "checkpoint does not match this scan (positions/CLRs differ)"
        )


def load_checkpoint(path, result):
    """Restore a full snapshot into ``result``; returns (rounds_done, seed).

    Validates that the checkpoint was written on this package's sigma
    stream and belongs to the same scan (matching observed CLRs and
    positions).
    """
    with np.load(path) as z:
        _check_stream(z, path)
        _check_identity(z, result)
        result.permute_n[:] = z["permute_n"]
        result.permute_p[:] = z["permute_p"]
        result.permute_finished[:] = z["permute_finished"]
        _restore_thresholds(z, result)
        lengths = z["null_lengths"]
        flat = z["null_flat"]
        off = 0
        for i, L in enumerate(lengths):
            result.null_clr[i] = flat[off : off + int(L)].tolist()
            off += int(L)
        return int(z["rounds_done"]), int(z["seed"])


def _append_record(fh, arrays: dict):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    fh.write(_HDR.pack(_MAGIC, len(payload), zlib.crc32(payload)))
    fh.write(payload)
    fh.flush()
    os.fsync(fh.fileno())


def _read_records(log_path):
    """Yield complete delta records; silently stops at a torn tail."""
    with open(log_path, "rb") as fh:
        while True:
            hdr = fh.read(_HDR.size)
            if len(hdr) < _HDR.size:
                return
            magic, length, crc = _HDR.unpack(hdr)
            if magic != _MAGIC:
                return
            payload = fh.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return
            yield np.load(io.BytesIO(payload))


class Checkpointer:
    """Incremental checkpoint: base .npz + append-only delta log.

    Usage (the permutation drivers):

        ck = Checkpointer(path, result, seed)   # resumes if files exist
        rounds_done = ck.rounds_done            # 0 on a fresh run
        ...after each chunk...
        ck.save(result, rounds_done)

    ``path`` holds the base (identity + seed + sigma stream);
    ``path + ".log"`` holds the deltas.  A legacy full-snapshot .npz at
    ``path`` (containing null_flat) is also resumable — the run continues
    in incremental form on top of it.
    """

    def __init__(self, path, result, seed, write=True, resume=None):
        self.path = path
        self.log_path = path + ".log"
        self.rounds_done = 0
        self._fh = None
        self._lens = np.zeros(result.n_points, dtype=np.int64)
        self._write = write

        if resume is None:
            resume = os.path.exists(path)
        if resume:
            with np.load(path) as z:
                _check_stream(z, path)
                if "null_flat" in z.files:  # legacy full snapshot
                    self.rounds_done, _ = load_checkpoint(path, result)
                else:
                    _check_identity(z, result)
            if os.path.exists(self.log_path):
                self._replay(result)
            self._lens[:] = [len(r or []) for r in result.null_clr]
            if write:
                self._fh = open(self.log_path, "ab")
        elif write:
            tmp = f"{path}.tmp"
            np.savez(
                tmp, sweep_pos=result.sweep_pos, clr=result.clr, seed=seed,
                sigma_stream=SIGMA_STREAM,
            )
            os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp,
                       path)
            self._fh = open(self.log_path, "wb")

    def _replay(self, result):
        for z in _read_records(self.log_path):
            result.permute_n[:] = z["permute_n"]
            result.permute_p[:] = z["permute_p"]
            result.permute_finished[:] = z["permute_finished"]
            _restore_thresholds(z, result)
            idx = z["new_idx"]
            lens = z["new_lens"]
            vals = z["new_vals"]
            off = 0
            for i, L in zip(idx, lens):
                res = result.null_clr[int(i)]
                if res is None:
                    res = result.null_clr[int(i)] = []
                res.extend(vals[off : off + int(L)].tolist())
                off += int(L)
            self.rounds_done = int(z["rounds_done"])

    def save(self, result, rounds_done):
        """Append one delta: counters + null values added since last save
        (a rank that does not write only advances rounds_done)."""
        if not self._write:
            self.rounds_done = rounds_done
            return
        idx, lens, chunks = [], [], []
        for i, res in enumerate(result.null_clr):
            n_now = len(res or [])
            prev = int(self._lens[i])
            if n_now > prev:
                idx.append(i)
                lens.append(n_now - prev)
                chunks.append(np.asarray(res[prev:], dtype=np.float32))
                self._lens[i] = n_now
        _append_record(
            self._fh,
            dict(
                rounds_done=np.int64(rounds_done),
                permute_n=result.permute_n,
                permute_p=result.permute_p,
                permute_finished=result.permute_finished,
                stat_threshold=_thresholds_of(result),
                new_idx=np.asarray(idx, dtype=np.int32),
                new_lens=np.asarray(lens, dtype=np.int32),
                new_vals=(
                    np.concatenate(chunks)
                    if chunks else np.zeros(0, dtype=np.float32)
                ),
            ),
        )
        self.rounds_done = rounds_done

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
