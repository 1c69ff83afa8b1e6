"""The system under test, fscl_tpu_torch, behind the calls the traffic
kinds make: its data container, its sweep-model tables, ``scan_genome`` and
``scan_permute`` at the configuration's settings on one card (or, with
a ``split``, on this rank's card of a split over ranks), and the
permutation driver's counters (``last_stats``).

The benchmark hands the program the generated sites and nothing else; it
sets none of the program's switches.  The configuration file's "scan"
and "permute" groups state the settings the statistic is defined by (the
CLI's defaults: windows, grids, alpha grids, positions, blocks, hist or
lattice path), so the reference and the program read the same ones; the
program's other settings are its defaults.
"""

from __future__ import annotations

import numpy as np
import torch

COUNTERS = ("stack_dispatches", "rdp_dispatches", "lattice_dispatches",
            "hist_spec_chunks", "hist_spec_misses")


def one_card(device):
    """(torch.device, sync) of a one-card kind: the first card, its CUDA
    context made, where ``device`` is "cuda"; the tests' "cpu" as it is."""
    if device != "cuda":
        return torch.device(device), lambda: None
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    torch.zeros(1, device=dev)
    return dev, lambda: torch.cuda.synchronize(dev)


class Program:
    def __init__(self, genome, cfg, device):
        import fscl_tpu_torch  # noqa: F401  (fails where the port is absent)
        from fscl_tpu_torch.data import ChrLimits, SNPData
        from fscl_tpu_torch.engine import PermuteConfig, ScanConfig
        from fscl_tpu_torch.models import background_fsp, build_tables

        self.device = device
        g = genome
        limits = []
        for c in range(len(g.chrom)):
            sl = g.chrom_slice(c)
            limits.append(ChrLimits(
                name=g.chrom[c], start_index=int(g.start[c]),
                n_snps=int(g.count[c]), start_pos=int(g.pos[sl][0]),
                bp_length=int(g.pos[sl][-1])))
        self._fields = dict(
            pos=g.pos,
            obs_freq=g.freq.astype(np.int32),
            depth_p=np.zeros(g.n_sites, np.int32),
            folded=np.full(g.n_sites, bool(cfg["folded"])),
            chr_id=np.repeat(np.arange(len(g.chrom), dtype=np.int32),
                             g.count),
            sample_depths=np.array([g.depth], np.int64),
            chr_limits=limits,
        )
        self.data = SNPData(**self._fields)
        fsp = background_fsp(self.data.obs_freq, self.data.depth_p,
                             self.data.folded, self.data.sample_depths)
        self.tables = build_tables(fsp, self.data.sample_depths,
                                   grid_points=int(cfg["grid_points"]))
        self.data.attach_model(self.tables)
        self.scan_cfg = ScanConfig(**cfg["scan"])
        self._perm_kw = dict(cfg["permute"])
        self._PermuteConfig = PermuteConfig

    def fresh_data(self):
        """A new data object over the same sites, its model attached, with
        none of the program's per-data caches."""
        from fscl_tpu_torch.data import SNPData

        d = SNPData(**self._fields)
        d.attach_model(self.tables)
        return d

    def scan(self, data, split=None):
        """scan_genome on ``data``; ``split``: this rank's
        fscl_tpu_torch.parallel.Split (None, the drivers' default: one
        card)."""
        from fscl_tpu_torch.engine import scan_genome

        return scan_genome(data, self.tables, self.scan_cfg,
                           device=self.device, split=split)

    def permute(self, result, *, n_permute, chunk_replicates, seed,
                split=None):
        """One scan_permute pass on ``result`` (mutated); the pass's
        counters.  ``split`` as in ``scan``."""
        from fscl_tpu_torch.engine import permute as TP

        pc = self._PermuteConfig(n_permute=n_permute,
                                 chunk_replicates=chunk_replicates,
                                 seed=seed, **self._perm_kw)
        TP.scan_permute(self.data, self.tables, result, self.scan_cfg, pc,
                        device=self.device, split=split)
        return {k: int(TP.last_stats.get(k, 0)) for k in COUNTERS}

    def release(self):
        self.data = None
        self.tables = None

    @staticmethod
    def build_kernels(device):
        """Load (at a checkout's first run: build) the kernel library for
        a card; the seconds nvcc took, 0 where the build was there or the
        device is the CPU."""
        if device.type != "cuda":
            return 0.0
        from fscl_tpu_torch import kernels

        kernels.load()
        return float(kernels.build_seconds)
