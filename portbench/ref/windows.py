"""Frozen copy of the candidate-window geometry
(fscl_tpu_torch/ops/windows.py; scan-chromosome.c:39-94).  Each
candidate gets the index of its nearest SNP and an inclusive window of
+-eval_range SNPs, clamped at chromosome edges while keeping a
2*eval_range width when possible."""

from __future__ import annotations

import numpy as np


def nearest_snp_index(pos, cand_pos):
    """Nearest-SNP index per candidate (ties -> the right SNP)."""
    pos = np.asarray(pos)
    cand = np.asarray(cand_pos)
    n = pos.shape[0]
    j = np.searchsorted(pos, cand, side="left")  # pos[j-1] < cand <= pos[j]
    j = np.clip(j, 1, n - 1)
    i = j - 1
    left_closer = (cand - pos[i]) < (pos[j] - cand)
    out = np.where(left_closer, i, j)
    out = np.where(cand <= pos[0], 0, out)
    out = np.where(cand >= pos[-1], n - 1, out)
    return out.astype(np.int64)


def candidate_windows(pos, cand_pos, eval_range):
    """(lo, hi) inclusive site windows per candidate, edge-clamped."""
    pos = np.asarray(pos)
    n = pos.shape[0]
    ns = nearest_snp_index(pos, cand_pos)
    er = int(eval_range)
    lo = ns - er
    hi = ns + er
    left = lo < 0
    lo = np.where(left, 0, lo)
    hi = np.where(left, np.minimum(2 * er, n - 1), hi)
    right = ~left & (ns + er > n - 1)
    hi = np.where(right, n - 1, hi)
    lo = np.where(right, np.maximum(n - 1 - 2 * er, 0), lo)
    return lo.astype(np.int64), hi.astype(np.int64)
