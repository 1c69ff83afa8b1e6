"""SNP frequency file reader (numpy copy of fscl_tpu/io/snp_reader.py).

Format (snp-input.c:55-56): whitespace-separated rows
    chr_name  pos  obs_freq  sample_size  folded
with '#' comments and blank lines skipped, unparseable rows warned about
(except a literal "chromosome" header token), rows filtered when
sample_size < minimum_obs_depth or (unless include_invariant) the site is
invariant, and folded frequencies folded to the minor allele
(snp-input.c:64-66, 89-90).

The lines are parsed by the C parser (native/fastio.c, built with the
host's C compiler at first use) as fscl_tpu's reader does with its
built extension, and by the Python loop where no C compiler is on PATH;
the reader logs which one ran.  The two read well-formed files alike but
some malformed lines differently, as fscl_tpu's two parsers do: the C
parser takes "4x" as 4, skips "1_3" and saturates an overflow, and skips
unparseable rows without a word.
"""

from __future__ import annotations

import numpy as np

from ..data import SNPData, build_snp_data
from ..native import fastio
from ..utils.logging import MSG_ERROR, MSG_STATUS, cr_logmsg, logmsg


def _parse_python(path):
    chrs, poss, freqs, sizes, folds = [], [], [], [], []
    with open(path, "r") as f:
        for line_no, line in enumerate(f, 1):
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            parts = s.split()
            if len(parts) < 5:
                if s != "chromosome":
                    logmsg(
                        MSG_ERROR,
                        'Can\'t parse SNP input at line %d: "%s"',
                        line_no,
                        s,
                    )
                continue
            try:
                p, of, ss, fl = (
                    int(parts[1]),
                    int(parts[2]),
                    int(parts[3]),
                    int(parts[4]),
                )
            except ValueError:
                logmsg(
                    MSG_ERROR, 'Can\'t parse SNP input at line %d: "%s"',
                    line_no, s,
                )
                continue
            chrs.append(parts[0])
            poss.append(p)
            freqs.append(of)
            sizes.append(ss)
            folds.append(fl)
    return (
        chrs,
        np.asarray(poss, dtype=np.int64),
        np.asarray(freqs, dtype=np.int64),
        np.asarray(sizes, dtype=np.int64),
        np.asarray(folds, dtype=np.int64),
    )


def _parse(path):
    lib = fastio.load()
    if lib is None:
        logmsg(MSG_STATUS, "Parsing SNP input with the Python loop (no C "
               "compiler on PATH)")
        return _parse_python(path)
    logmsg(MSG_STATUS, "Parsing SNP input with the C parser (%s)",
           lib.path.name)
    return fastio.parse_snp_file(path)


def load_snp_input(path, include_invariant=False, minimum_obs_depth=5) -> SNPData:
    chrs, pos, freq, size, fold = _parse(path)

    keep = size >= minimum_obs_depth
    if not include_invariant:
        keep &= (freq >= 1) & (freq <= size - 1)
    idx = np.where(keep)[0]
    chrs = [chrs[i] for i in idx]
    pos, freq, size, fold = pos[idx], freq[idx], size[idx], fold[idx]

    # fold to minor allele (snp-input.c:89-90)
    folded = fold != 0
    freq = np.where(folded & (freq > size - freq), size - freq, freq)

    cr_logmsg(
        MSG_STATUS,
        "Loading SNPs and allele frequencies.... %11d SNPs - complete.",
        len(pos),
    )
    if len(pos) == 0:
        raise ValueError(f'No usable snps found in file "{path}"')
    return build_snp_data(chrs, pos, freq, size, folded)
