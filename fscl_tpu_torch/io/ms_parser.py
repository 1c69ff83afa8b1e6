"""Parser for Hudson's `ms` coalescent-simulator output (a copy of
fscl_tpu/io/ms_parser.py, pure Python and numpy).

Replaces the reference's flex/bison reentrant parser (ms-parser.y +
ms-scanner.lex) with a streaming Python state machine — the grammar is line
oriented: `//` starts a block, optional marginal gene trees `[size](tree);`,
`segsites: n`, optional `prob: p`, `positions: ...`, then one 0/1 haplotype
row per sample (ms-parser.y:96-247).  Haplotypes are returned as a uint8
matrix so downstream allele counts are numpy column sums instead of per-char
loops.

Also provided, mirroring msparser.h:46-52:
  * ``msparser_execute``: fork `ms` and parse its pipe (ms-parser.y:283-340)
  * ``msblock_sfs``: per-block site-frequency spectrum (ms-parser.y:390-405)
  * ``msblock_fsbranch_lengths``: branch-length SFS from the gene trees
    (ms-parser.y:356-388)
  * ``sfs_summaries``: theta_W, theta_pi, theta_H, Tajima's D, Fu&Li's D,
    Fay&Wu's H (ms-parser.y:407-460)

Tree leaf labels: ms labels samples 1..n; we convert to 0-based so the
(s_index, n) sample window means the same thing for haplotype rows and tree
leaves (the reference compares 1-based leaf ids against 0-based row ranges,
ms-parser.y:361; we do not replicate that off-by-one).
"""

from __future__ import annotations

import dataclasses
import subprocess

import numpy as np


@dataclasses.dataclass
class GTree:
    length: float  # branch length from parent to this node
    sample_index: int  # 0-based leaf id; -1 for internal nodes
    left: "GTree | None" = None
    right: "GTree | None" = None


@dataclasses.dataclass
class Segment:
    gtree: GTree
    segment_size: int


@dataclasses.dataclass
class MsBlock:
    segments: list
    prob: float
    positions: np.ndarray  # [n_poly] float64 fractional positions
    haplotypes: np.ndarray  # [n_haplotypes, n_poly] uint8 (0/1)

    @property
    def n_poly(self) -> int:
        return int(self.positions.shape[0])

    @property
    def n_haplotypes(self) -> int:
        return int(self.haplotypes.shape[0])


def _parse_newick(s, pos=0):
    """Parse the ms tree subset: leaf 'int:len', internal '(t,t):len'."""

    def parse(i):
        if s[i] == "(":
            left, i = parse(i + 1)
            assert s[i] == ",", f"expected ',' at {i} in {s!r}"
            right, i = parse(i + 1)
            assert s[i] == ")", f"expected ')' at {i} in {s!r}"
            i += 1
            length = 0.0
            if i < len(s) and s[i] == ":":
                j = i + 1
                while j < len(s) and (s[j].isdigit() or s[j] in ".eE+-"):
                    j += 1
                length = float(s[i + 1 : j])
                i = j
            return GTree(length, -1, left, right), i
        j = i
        while j < len(s) and s[j].isdigit():
            j += 1
        leaf = int(s[i:j]) - 1  # ms labels are 1-based
        length = 0.0
        if j < len(s) and s[j] == ":":
            k = j + 1
            while k < len(s) and (s[k].isdigit() or s[k] in ".eE+-"):
                k += 1
            length = float(s[j + 1 : k])
            j = k
        return GTree(length, leaf), j

    tree, i = parse(pos)
    return tree


def _parse_tree_line(line):
    """'[size](tree);' or '(tree);' -> Segment (size 1 without brackets,
    ms-parser.y:170-174)."""
    line = line.strip().rstrip(";")
    size = 1
    if line.startswith("["):
        close = line.index("]")
        size = int(line[1:close])
        line = line[close + 1 :]
    return Segment(gtree=_parse_newick(line), segment_size=size)


class MsParser:
    """Streaming block reader over a file object."""

    def __init__(self, fileobj):
        self.f = fileobj
        self._pushback = None

    def _readline(self):
        if self._pushback is not None:
            line, self._pushback = self._pushback, None
            return line
        return self.f.readline()

    def next_block(self) -> MsBlock | None:
        # scan to '//'
        while True:
            line = self._readline()
            if not line:
                return None
            if line.startswith("//"):
                break

        segments = []
        prob = 0.0
        n_seg = 0
        positions = np.zeros(0)
        haps = []

        # trees (optional), then segsites
        while True:
            line = self._readline()
            if not line:
                break
            s = line.strip()
            if not s:
                continue
            if s.startswith("[") or s.startswith("("):
                segments.append(_parse_tree_line(s))
                continue
            if s.startswith("segsites:"):
                n_seg = int(s.split(":", 1)[1])
                break
            # unexpected; push back and stop
            self._pushback = line
            break

        if n_seg > 0:
            # prob (optional) then positions
            line = self._readline()
            s = line.strip() if line else ""
            if s.startswith("prob:"):
                prob = float(s.split(":", 1)[1])
                line = self._readline()
                s = line.strip() if line else ""
            vals = []
            if s.startswith("positions:"):
                vals = [float(v) for v in s.split(":", 1)[1].split()]
                # positions may wrap onto continuation lines
                while len(vals) < n_seg:
                    line = self._readline()
                    if not line:
                        break
                    cont = line.strip()
                    if not cont:
                        break
                    vals.extend(float(v) for v in cont.split())
            positions = np.asarray(vals, dtype=np.float64)

            # haplotype rows until blank / next block / EOF
            while True:
                line = self._readline()
                if not line:
                    break
                s = line.strip()
                if not s:
                    break
                if s.startswith("//"):
                    self._pushback = line
                    break
                if set(s) <= {"0", "1"}:
                    haps.append(np.frombuffer(s.encode(), dtype=np.uint8) - ord("0"))
                else:
                    self._pushback = line
                    break

        hap_mat = (
            np.vstack(haps) if haps else np.zeros((0, n_seg), dtype=np.uint8)
        )
        return MsBlock(
            segments=segments, prob=prob, positions=positions, haplotypes=hap_mat
        )


def msparser_execute(ms_cmd):
    """Run an `ms` command line; returns (MsParser, Popen) over its stdout
    (pipe + exec equivalent of ms-parser.y:283-340)."""
    proc = subprocess.Popen(
        ms_cmd.split(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return MsParser(proc.stdout), proc


def msblock_sfs(block: MsBlock, s_index: int, n: int) -> np.ndarray:
    """Integer SFS over haplotype rows [s_index, s_index + n)."""
    sub = block.haplotypes[s_index : s_index + n, :]
    counts = sub.sum(axis=0).astype(np.int64)
    return np.bincount(counts, minlength=n + 1)


def msblock_fsbranch_lengths(block: MsBlock, s_index: int, n: int) -> np.ndarray:
    """Branch-length SFS from marginal gene trees (ms-parser.y:356-388).

    Each branch contributes length * segment_size to the class equal to the
    number of descendant leaves; leaves outside [s_index, s_index+n) send
    their own branch to class 0 but still count toward ancestors' classes
    (matching bfs_descend's semantics).
    """
    bfs = np.zeros(n + 1, dtype=np.float64)

    def descend(node, seg):
        if node.left is None:
            in_range = s_index <= node.sample_index < s_index + n
            bfs[1 if in_range else 0] += node.length * seg
            return 1
        s = descend(node.left, seg) + descend(node.right, seg)
        bfs[min(s, n)] += node.length * seg
        return s

    for seg in block.segments:
        descend(seg.gtree, seg.segment_size)
    return bfs


@dataclasses.dataclass
class SfsSummary:
    n: int  # segregating sites
    Tw: float  # Watterson's theta
    Tpi: float  # pairwise theta
    Th: float  # Fay & Wu's theta_H
    Dt: float  # Tajima's D
    Dfl: float  # Fu & Li's D
    H: float  # Fay & Wu's H


def sfs_summaries(sfs, n) -> SfsSummary:
    """Summary statistics from an SFS (formulas as in ms-parser.y:407-460)."""
    sfs = np.asarray(sfs, dtype=np.float64)
    i = np.arange(1, n)
    s = float(sfs[1:n].sum())
    a1 = float((1.0 / i).sum())
    a2 = float((1.0 / (i * i)).sum())
    out = SfsSummary(n=int(s), Tw=0.0, Tpi=0.0, Th=0.0, Dt=0.0, Dfl=0.0, H=0.0)
    if s == 0:
        return out

    b1 = (n + 1) / (3.0 * (n - 1))
    b2 = (2.0 * (n * n + n + 3)) / (9.0 * n * (n - 1))
    c1 = b1 - 1.0 / a1
    c2 = b2 - (n + 2.0) / (a1 * n) + a2 / (a1 * a1)
    e1 = c1 / a1
    e2 = c2 / (a1 * a1 + a2)

    vd = 1.0 + (a1 / (a2 + a1 * a1)) * (
        (2.0 * n * a1 - 4.0 * (n - 1) - (n + 1) * (n - 2)) / ((n - 1) * (n - 2))
    )
    ud = a1 - 1.0 - vd
    v = ud * s + vd * s * s

    out.Tw = s / a1
    out.Tpi = float((i * (n - i) * sfs[1:n]).sum()) / (n * (n - 1) / 2.0)
    out.Th = float((i * i * sfs[1:n]).sum()) * (2.0 / (n * (n - 1)))
    out.Dt = (out.Tpi - out.Tw) / np.sqrt(e1 * s + e2 * s * (s - 1))
    out.H = out.Tpi - out.Th
    out.Dfl = (s - sfs[1] * a1) / np.sqrt(v)
    return out
